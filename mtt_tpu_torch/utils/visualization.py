"""Visualisations: task colour maps and 3D box wireframes (port of
mtt_tpu/utils/visualization.py), in numpy, written with
``evaluation/save_preds.write_png``.

The card's machine has no cv2, so its two calls here have numpy stand-ins:
``cv2.applyColorMap(..., COLORMAP_PLASMA)`` is a lookup in ``PLASMA``, the
table cv2 5.0 applies (its 256 entries, RGB), and ``cv2.line`` of thickness
2 is ``draw_line``, cv2's polygon, outline and end discs in floats where
cv2 steps in 16-bit fixed point: every pixel either draws lies within a
pixel of one the other draws, counting what each draws past the image's
border (a line that runs along the border may fall on its last column in
one and just outside it in the other).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from mtt_tpu_torch.evaluation.save_preds import write_png

# 19-class Cityscapes train palette (visualization_utils.py:14-39)
CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], np.uint8)

# cv2's COLORMAP_PLASMA as RGB, entry i for the level i (cv2.applyColorMap on
# np.arange(256), channels reversed), 3 bytes an entry in hex
PLASMA = np.frombuffer(bytes.fromhex(
    "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
    "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
    "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
    "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
    "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
    "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
    "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
    "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
    "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
    "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
    "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
    "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
    "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
    "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
    "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
    "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
    "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
    "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
    "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
    "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
    "f1f426f1f525f0f724f0f921"), np.uint8).reshape(256, 3)


def voc_colormap(n: int = 256) -> np.ndarray:
    """XOR-bit label colormap (InvPT/inference.py:70-108)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def render_task(task: str, pred: np.ndarray, database: str = "PASCALContext"):
    """Post-processed prediction -> RGB uint8 visualisation."""
    if task == "semseg" and database == "Cityscapes3D":
        return CITYSCAPES_PALETTE[pred.astype(np.int32) % 19]
    if task in ("semseg", "human_parts"):
        return voc_colormap()[pred.astype(np.int32) % 256]
    if task in ("edge", "sal"):
        return np.repeat(pred.astype(np.uint8)[..., None], 3, -1)
    if task == "normals":
        return pred.astype(np.uint8)
    if task == "depth":
        d = pred.astype(np.float32)
        valid = (d > 0) & (d < 255)
        lo = d[valid].min() if valid.any() else 0.0
        hi = d[valid].max() if valid.any() else 1.0
        n = np.clip((d - lo) / max(hi - lo, 1e-6) * 255, 0, 255).astype(np.uint8)
        return PLASMA[n]
    raise ValueError(task)


def _clip_segment(a: np.ndarray, b: np.ndarray, lo: np.ndarray,
                  hi: np.ndarray):
    """The part of segment a-b inside the box [lo, hi] (Liang-Barsky), or
    None."""
    d = b - a
    t0, t1 = 0.0, 1.0
    for k in range(2):
        for p, q in ((-d[k], a[k] - lo[k]), (d[k], hi[k] - a[k])):
            if p == 0:
                if q < 0:
                    return None
            elif p < 0:
                t0 = max(t0, q / p)
            else:
                t1 = min(t1, q / p)
    if t0 > t1:
        return None
    return a + t0 * d, a + t1 * d


def _segment_pixels(a, b, h: int, w: int) -> np.ndarray:
    """(x, y) of the pixels a one-pixel line a-b steps through inside an
    h x w image: one rounded point a unit step along its longer axis."""
    seg = _clip_segment(np.asarray(a, np.float64), np.asarray(b, np.float64),
                        np.array([-1.0, -1.0]), np.array([w, h], np.float64))
    if seg is None:
        return np.zeros((0, 2), np.int64)
    a, b = seg
    n = int(np.ceil(np.abs(b - a).max())) + 1
    return np.rint(a + np.linspace(0.0, 1.0, n)[:, None] * (b - a)
                   ).astype(np.int64)


def _polygon_pixels(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """(x, y) of the pixels of a convex polygon's scanline fill in an
    h x w image: in each row between the rounded lowest and highest
    vertices, the columns from round(x_left) to round(x_right) of the row's
    crossing with the polygon."""
    y0 = max(int(np.floor(poly[:, 1].min() + 0.5)), 0)
    y1 = min(int(np.floor(poly[:, 1].max() + 0.5)), h - 1)
    if y1 < y0:
        return np.zeros((0, 2), np.int64)
    ys = np.arange(y0, y1 + 1, dtype=np.float64)
    p, q = poly, np.roll(poly, -1, 0)
    dy = q[:, 1] - p[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ys[:, None] - p[None, :, 1]) / dy[None]
    on = (dy[None] != 0) & (t >= 0) & (t <= 1)
    xs = p[None, :, 0] + t * (q[None, :, 0] - p[None, :, 0])
    xl = np.where(on, xs, np.inf).min(1)
    xr = np.where(on, xs, -np.inf).max(1)
    row = np.isfinite(xl)
    x0 = np.clip(np.floor(xl[row] + 0.5), 0, w)
    x1 = np.clip(np.floor(xr[row] + 0.5), -1, w - 1)
    n = np.maximum(x1 - x0 + 1, 0).astype(np.int64)
    starts = np.repeat(x0.astype(np.int64), n)
    steps = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    return np.stack([starts + steps,
                     np.repeat(ys[row].astype(np.int64), n)], -1)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` for thickness > 1, in
    place on img (H, W, 3), as cv2 builds it: the segment between the pixel
    centres p0 and p1 (x, y) widened by thickness / 2 on each side, a convex
    polygon whose outline is drawn and whose rows are filled, and a disc of
    radius (thickness + 1) // 2 round each end. cv2 steps the outline and
    the fill in 16-bit fixed point, where this rounds floats: a pixel at
    the edge may differ."""
    h, w = img.shape[:2]
    a, b = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = b - a
    length = float(np.hypot(*d))
    parts = []
    if length > 0:
        off = np.array([d[1], -d[0]]) * (thickness / 2.0 / length)
        poly = np.stack([a + off, a - off, b - off, b + off])
        parts.append(_polygon_pixels(poly, h, w))
        parts += [_segment_pixels(poly[i], poly[(i + 1) % 4], h, w)
                  for i in range(4)]
    r = (thickness + 1) // 2
    disc = np.array([(x, y) for y in range(-r, r + 1)
                     for x in range(-r, r + 1) if x * x + y * y <= r * r])
    for c in (a, b):
        parts.append(np.rint(c).astype(np.int64) + disc)
    pix = np.concatenate(parts)
    pix = pix[(pix[:, 0] >= 0) & (pix[:, 0] < w) & (pix[:, 1] >= 0)
              & (pix[:, 1] < h)]
    img[pix[:, 1], pix[:, 0]] = color


_BOX_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),     # one face
              (4, 5), (5, 7), (7, 6), (6, 4),     # opposite face
              (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_boxes3d(img: np.ndarray, boxes3d: np.ndarray, K: np.ndarray,
                 valid: Optional[np.ndarray] = None,
                 color=(0, 255, 90)) -> np.ndarray:
    """Wireframes of S-frame boxes (N, 9) on a copy of an RGB uint8 image
    (bbox2fig, det_tools.py:355-478): the 8 corners projected with K, 12
    edges of thickness 2; a box with a corner at depth 0.1 or less is left
    out."""
    from mtt_tpu_torch.detection.box3d import corners_3d

    out = img.copy()
    corners = corners_3d(torch.as_tensor(np.asarray(boxes3d, np.float32))
                         ).numpy()                              # (N, 8, 3)
    K = np.asarray(K, np.float32)
    for n in range(corners.shape[0]):
        if valid is not None and not bool(valid[n]):
            continue
        c = corners[n]
        if (c[:, 2] <= 0.1).any():
            continue
        uv = (K @ c.T).T
        uv = (uv[:, :2] / uv[:, 2:3]).astype(np.int32)
        for a, b in _BOX_EDGES:
            draw_line(out, uv[a], uv[b], color, 2)
    return out


def save_visualizations(save_dir: str, task: str, preds: np.ndarray,
                        metas: List[Dict], database: str = "PASCALContext",
                        workers: int = 8):
    """``render_task`` of each sample's prediction as
    ``save_dir/vis_<task>/<img_name>.png``; pad samples left out."""
    out_dir = os.path.join(save_dir, f"vis_{task}")
    os.makedirs(out_dir, exist_ok=True)

    def _one(i):
        if metas[i].get("pad"):
            return
        write_png(os.path.join(out_dir, metas[i]["img_name"] + ".png"),
                  render_task(task, np.asarray(preds[i]), database))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(_one, range(len(metas))))
