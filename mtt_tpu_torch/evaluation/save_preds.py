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
``read_png`` is ``data/image_io.read_png``, re-exported here.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from mtt_tpu_torch.data.image_io import PNG_SIGNATURE
from mtt_tpu_torch.data.image_io import read_png  # noqa: F401


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
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


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
