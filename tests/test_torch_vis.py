"""The port's visualisations, PNG reader and Cityscapes-3D sample transforms
against the JAX package and cv2, on the CPU (the card's machine has no cv2,
so the port carries numpy stand-ins).

Tolerances, stated at each test: colour maps, decoded PNG pixels and the
transforms equal to the bit; the wireframes within a pixel of cv2's (every
pixel one draws lies within one pixel, in x and y, of a pixel the other
draws, both drawing on a canvas 4 pixels wider on each side than the
region compared, so that a line along the border counts where it falls).
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from torch_threads import torch_threads  # noqa: F401


def _preds(rng, h=24, w=40):
    return {"semseg": rng.integers(0, 40, (h, w)).astype(np.float32),
            "human_parts": rng.integers(0, 7, (h, w)).astype(np.float32),
            "edge": rng.uniform(0, 255, (h, w)).astype(np.float32),
            "sal": rng.integers(0, 2, (h, w)).astype(np.float32) * 255,
            "normals": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            "depth": rng.uniform(0, 80, (h, w)).astype(np.float32)}


@pytest.mark.parametrize("database", ["PASCALContext", "Cityscapes3D"])
def test_render_task_matches_jax(database):
    """``render_task`` of every task gives JAX's bytes (its depth through
    cv2's plasma map), depth also with invalid pixels and constant."""
    from mtt_tpu.utils import visualization as J
    from mtt_tpu_torch.utils import visualization as P
    assert np.array_equal(P.CITYSCAPES_PALETTE, J.CITYSCAPES_PALETTE)
    assert np.array_equal(P.voc_colormap(), J.voc_colormap())
    preds = _preds(np.random.default_rng(0))
    preds["depth_with_holes"] = np.where(preds["depth"] > 60, 0.0,
                                         preds["depth"])
    preds["depth_constant"] = np.full((5, 6), 7.0, np.float32)
    for name, pred in preds.items():
        task = name.split("_with")[0].split("_constant")[0]
        got = P.render_task(task, pred, database)
        want = J.render_task(task, pred, database)
        assert got.dtype == np.uint8 and got.tobytes() == \
            np.ascontiguousarray(want).tobytes(), name
    with pytest.raises(ValueError):
        P.render_task("3ddet", preds["depth"])


def _cs_boxes(rng, n, K, h, w):
    """Seeded S-frame boxes whose projections fill an h x w image and cross
    its border."""
    b = np.zeros((n, 9), np.float32)
    b[:, 2] = rng.uniform(2, 40, n)
    b[:, 0] = (rng.uniform(-0.1, 1.1, n) * w - K[0, 2]) * b[:, 2] / K[0, 0]
    b[:, 1] = (rng.uniform(-0.1, 1.1, n) * h - K[1, 2]) * b[:, 2] / K[1, 1]
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_draw_boxes3d_within_a_pixel_of_cv2():
    """``draw_boxes3d`` (numpy lines) against JAX's (cv2.line): the boxes'
    wireframes within a pixel of each other, the rest of the image
    untouched; boxes behind the 0.1 m plane and invalid slots drawn by
    neither."""
    from mtt_tpu.utils import visualization as J
    from mtt_tpu_torch.utils import visualization as P
    rng = np.random.default_rng(1)
    h, w, m = 96, 192, 4
    K = np.array([[150.0, 0, w / 2 + m], [0, 150.0, h / 2 + m], [0, 0, 1]],
                 np.float32)
    boxes = _cs_boxes(rng, 40, K, h, w)
    boxes[0, 2] = 0.5                     # corners behind the camera
    valid = rng.uniform(size=40) > 0.2
    img = rng.integers(0, 60, (h + 2 * m, w + 2 * m, 3)).astype(np.uint8)
    got = P.draw_boxes3d(img, boxes, K, valid=valid)
    want = J.draw_boxes3d(img, boxes, K, valid=valid)
    colour = np.array([0, 255, 90], np.uint8)
    drawn_g, drawn_w = (got == colour).all(-1), (want == colour).all(-1)
    assert np.array_equal(got[~drawn_g], img[~drawn_g])
    inner = np.zeros_like(drawn_g)
    inner[m:-m, m:-m] = True
    near = np.ones((3, 3), bool)
    assert not (drawn_g & inner & ~binary_dilation(drawn_w, near)).any()
    assert not (drawn_w & inner & ~binary_dilation(drawn_g, near)).any()
    assert (drawn_w & inner).sum() > 2000
    assert (drawn_g ^ drawn_w).sum() < 0.25 * drawn_w.sum()
    # nothing to draw: the image comes back unchanged, as a copy
    none = P.draw_boxes3d(img, boxes, K, valid=np.zeros(40, bool))
    assert np.array_equal(none, img) and none is not img


def _png_by_rows(img: np.ndarray, filters) -> bytes:
    """A PNG whose scanline y is written with filter filters[y % 5]: the
    encoder side of PNG spec section 9."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = filters[y % len(filters)]
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - a
        elif kind == 2:
            f = x - prev
        elif kind == 3:
            f = x - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            f = x - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prev, c))
        raw += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prev = x

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    colour = {1: 0, 3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_read_png_matches_cv2(tmp_path):
    """``read_png`` equals ``cv2.imread`` (IMREAD_UNCHANGED, channels to
    RGB order) on grey, RGB and RGBA PNGs, wide, tall and one pixel wide,
    written by cv2, by a test encoder that uses each of the five scanline
    filters, and by ``write_png``; a 16-bit PNG gives cv2's uint16 samples
    (``data/image_io.py`` reads every bit depth), and a JPEG is refused
    (``read_png`` reads PNG only; ``read_image`` takes both)."""
    from mtt_tpu_torch.evaluation.save_preds import read_png, write_png
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = (127 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(
        np.uint8)
    imgs = {"grey": rng.integers(0, 256, (37, 53)).astype(np.uint8),
            "grey_smooth": smooth,
            "rgb": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
            "rgb_smooth": np.stack([smooth, smooth[::-1], 255 - smooth], -1),
            "rgba": rng.integers(0, 256, (37, 53, 4)).astype(np.uint8),
            "rgb_tall": rng.integers(0, 256, (53, 37, 3)).astype(np.uint8),
            "rgb_column": rng.integers(0, 256, (9, 1, 3)).astype(np.uint8)}

    def cv2_rgb(path):
        a = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if a.ndim == 3:
            a = cv2.cvtColor(a, cv2.COLOR_BGR2RGB if a.shape[2] == 3
                             else cv2.COLOR_BGRA2RGBA)
        return a

    for name, img in imgs.items():
        bgr = img if img.ndim == 2 else cv2.cvtColor(
            img, cv2.COLOR_RGB2BGR if img.shape[2] == 3
            else cv2.COLOR_RGBA2BGRA)
        path = tmp_path / f"cv2_{name}.png"
        assert cv2.imwrite(str(path), bgr)
        got = read_png(str(path))
        assert np.array_equal(got, cv2_rgb(path)) and \
            np.array_equal(got, img), name
        path = tmp_path / f"rows_{name}.png"
        path.write_bytes(_png_by_rows(img, (0, 1, 2, 3, 4)))
        assert np.array_equal(read_png(str(path)), cv2_rgb(path)), name
        assert np.array_equal(read_png(str(path)), img), name
        if img.ndim == 2 or img.shape[2] == 3:
            path = tmp_path / f"ours_{name}.png"
            write_png(str(path), img)
            assert np.array_equal(read_png(str(path)), cv2_rgb(path))
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), (imgs["grey"].astype(np.uint16) * 257))
    got = read_png(str(deep))
    assert got.dtype == np.uint16 and np.array_equal(
        got, cv2.imread(str(deep), cv2.IMREAD_UNCHANGED))
    jpg = tmp_path / "x.jpg"
    cv2.imwrite(str(jpg), imgs["rgb"])
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(jpg))


def _p(Config, size, labels):
    return Config.wrap({"dd_label_map_size": list(labels),
                        "TRAIN": {"SCALE": size}})


@pytest.mark.parametrize("src", [(70, 150), (64, 128)])
def test_cs3d_transforms_match_jax(src):
    """The Cityscapes-3D train and val transforms give JAX's (cv2's)
    arrays bit for bit: the image linearly resized to TRAIN.SCALE (or kept)
    and normalised, semseg and depth to ``dd_label_map_size`` by nearest
    neighbour; ``encode_segmap`` equal."""
    from mtt_tpu.data import cityscapes3d as J
    from mtt_tpu_torch.config.config import Config
    from mtt_tpu_torch.data import cityscapes3d as P
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    p = _p(Config, (64, 128), (32, 64))
    ds = SyntheticMT(("semseg", "depth", "3ddet"),
                     {"semseg": 19, "depth": 1, "3ddet": 18}, src, seed=3)
    for tf_p, tf_j in ((P.CS3DValTransforms, J.CS3DValTransforms),
                       (P.CS3DTrainTransforms, J.CS3DTrainTransforms)):
        got = tf_p(p)(ds[0])
        want = tf_j(p)(ds[0])
        assert set(got) == set(want)
        for k in ("image", "semseg", "depth"):
            assert got[k].dtype == want[k].dtype and \
                np.array_equal(got[k], want[k]), k
        assert got["image"].shape == (64, 128, 3)
        assert got["semseg"].shape == (32, 64, 1)
    raw = np.random.default_rng(4).integers(-1, 40, (20, 30)).astype(np.int32)
    assert np.array_equal(P.encode_segmap(raw), J.encode_segmap(raw))


def test_load_det_json_matches_jax(tmp_path):
    """``load_det_json`` of a gtBbox3d file (labels outside the evaluated
    six and boxes behind the camera left out, more boxes than slots) gives
    JAX's arrays, camera matrix and camera dict."""
    from mtt_tpu.data import cityscapes3d as J
    from mtt_tpu_torch.data import cityscapes3d as P
    rng = np.random.default_rng(5)
    objs = []
    for i in range(12):
        q = rng.normal(size=4)
        objs.append({
            "label": ("car", "person", "truck", "bicycle")[i % 4],
            "2d": {"modal": list(rng.uniform(0, 500, 4)),
                   "amodal": list(rng.uniform(0, 500, 4))},
            "3d": {"center": [rng.uniform(-5, 60), rng.uniform(-20, 20),
                              rng.uniform(-1, 2)],
                   "dimensions": list(rng.uniform(1, 5, 3)),
                   "rotation": list(q / np.linalg.norm(q))}})
    sensor = {"fx": 2262.52, "fy": 2265.3, "u0": 1096.98, "v0": 513.137,
              "sensor_T_ISO_8855": [[1, 0, 0, 1.7], [0, 1, 0, 0.1],
                                    [0, 0, 1, -1.2]]}
    path = tmp_path / "x_gtBbox3d.json"
    path.write_text(json.dumps({"objects": objs, "sensor": sensor}))
    got, want = P.load_det_json(str(path), 6), J.load_det_json(str(path), 6)
    for k in want[0]:
        assert np.array_equal(got[0][k], want[0][k]), k
    assert 3 < got[0]["det_valid"].sum() <= 6
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
