"""Prediction saving for external evaluation (port of
mtt_tpu/evaluation/save_preds.py): crops the centre-padded predictions back
to each sample's own size and writes edge probability maps (read by the
external SEISM odsF pipeline), semseg / parts / saliency label maps and
normals as PNGs, depth as .npy, and the 3D detections as official-format
Cityscapes JSONs.

The card's machine has no cv2 and no PIL, so PNGs go through the small
codec here, zlib and struct: ``write_png`` writes 8-bit grey for (H, W)
maps and 8-bit RGB for (H, W, 3) ones; a file holds the pixels
``cv2.imwrite`` writes for the same array (cv2 writes normals from BGR, so
the file's RGB is the array's), and decodes to the same array.
``read_png`` reads 8-bit grey, RGB and RGBA files, not interlaced, with
any of the five scanline filters (what ``cv2.imread`` gives, in RGB order).
Other formats raise: their decoders come with the dataset readers
(ROADMAP.md item 1.8).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 (H, W) grey or (H, W, 3) RGB image: one IDAT
    of unfiltered scanlines."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"PNG of shape {img.shape}: (H, W) or (H, W, 3)")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


_CHANNELS = {0: 1, 2: 3, 6: 4}      # PNG colour type -> samples a pixel


def _unfilter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The bytes before their filters of scanlines that use filters 0-2
    only (PNG spec, section 9): one row at a time, each row whole."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 1:
            # x + out[i - bpp]: a running sum mod 256 along each sample lane
            line = np.add.accumulate(line.reshape(-1, bpp), axis=0,
                                     dtype=np.uint8).reshape(-1)
        elif kind == 2:
            line = line + prev
        prev = out[y] = line
    return out


def _unfilter_wavefront(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The bytes before their filters of scanlines with any of filters 0-4.
    Average (3) and Paeth (4) take each pixel from its left, upper and
    upper-left neighbours once those are unfiltered, so no row is whole
    before the one above is: the pixels of one anti-diagonal (x + y = s)
    are independent of each other and go together, h + w - 1 steps for an
    h x w image. In a zero-padded (h + 1, w + 1) image flattened to pixels,
    an anti-diagonal is a slice of step w, and so are its three
    neighbours."""
    h, w = rows.shape[0], (rows.shape[1] - 1) // bpp
    w1 = w + 1
    cur = np.zeros((h + 1, w1, bpp), np.int16)
    cur[1:, 1:] = rows[:, 1:].reshape(h, w, bpp)
    cur = cur.reshape(-1, bpp)
    out = np.zeros_like(cur)
    kinds = rows[:, 0].astype(np.int16)[:, None]
    for s in range(h + w - 1):
        y0 = max(0, s - w + 1)
        n = min(h - 1, s) - y0 + 1
        k = (y0 + 1) * w1 + s - y0 + 1          # pixel (y0, s - y0)
        span = (n - 1) * w + 1
        a = out[k - 1:k - 1 + span:w]           # left
        b = out[k - w1:k - w1 + span:w]         # up
        c = out[k - w1 - 1:k - w1 - 1 + span:w]  # upper left
        f = kinds[y0:y0 + n]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[k:k + span:w] = (cur[k:k + span:w] + pred) & 0xFF
    return out.reshape(h + 1, w1 * bpp)[1:, bpp:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit grey (H, W), RGB (H, W, 3) or RGBA (H, W, 4)
    PNG that is not interlaced."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise NotImplementedError(
            f"{path} is not a PNG: the port reads PNG images only; JPEG and "
            f"the other formats come with the dataset readers (ROADMAP.md "
            f"item 1.8)")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: a {kind!r} chunk ends past the file")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; the port reads 8-bit grey, RGB and RGBA "
            f"without interlace (other forms come with the dataset readers, "
            f"ROADMAP.md item 1.8)")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} image bytes for {w}x{h}")
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG scanline filter {kinds.max()}: not "
                         f"0-4")
    out = (_unfilter_rows(rows, bpp) if kinds.max(initial=0) <= 2
           else _unfilter_wavefront(rows, bpp))
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def crop_padding(pred: np.ndarray, orig_size, padded_size) -> np.ndarray:
    """Undo the centre padding of ``pad_image``."""
    oh, ow = int(orig_size[0]), int(orig_size[1])
    ph, pw = padded_size
    dh, dw = max(ph - oh, 0), max(pw - ow, 0)
    return pred[dh // 2:dh // 2 + oh, dw // 2:dw // 2 + ow]


def save_task_predictions(save_dir: str, task: str, preds: np.ndarray,
                          metas: List[Dict], workers: int = 8):
    """preds: a post-processed batch (B, H, W[, C]); metas: per-sample dicts
    with img_name and img_size. Batch-padding samples (``meta["pad"]``) are
    not written."""
    out_dir = os.path.join(save_dir, task)
    os.makedirs(out_dir, exist_ok=True)
    padded = preds.shape[1:3]

    def _save(i):
        meta = metas[i]
        if meta.get("pad"):           # loader batch-padding sample
            return
        p = crop_padding(np.asarray(preds[i]), meta["img_size"], padded)
        name = meta["img_name"]
        if task in ("edge", "semseg", "human_parts", "sal", "normals"):
            write_png(os.path.join(out_dir, name + ".png"),
                      p.astype(np.uint8))
        elif task == "depth":
            np.save(os.path.join(out_dir, name + ".npy"), p.astype(np.float32))
        else:
            raise ValueError(task)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(_save, range(len(metas))))


def save_det_predictions(save_dir: str, decoded: Dict, metas: List[Dict]):
    """Per-image official-format 3D detection JSONs under
    ``save_dir/3ddet`` from a decoded batch (``inference.decode_3ddet``'s
    dict, tensors or arrays), pad samples left out."""
    from mtt_tpu_torch.detection.export import (bbox_to_json_objects,
                                                save_image_predictions)
    out_dir = os.path.join(save_dir, "3ddet")
    host = {k: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
            for k, v in decoded.items()}
    for i, meta in enumerate(metas):
        if meta.get("pad"):
            continue
        objs = bbox_to_json_objects(
            host["boxes3d"][i], host["bboxes2d"][i], host["scores"][i],
            host["labels"][i], host["valid"][i], meta["camera"])
        save_image_predictions(out_dir, meta["img_name"], objs)
