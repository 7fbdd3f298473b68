"""Write the JPEG fixtures of the port's decoder and the digests of their
pixels: ``tests/data/jpeg/*.jpg`` and ``tests/data/jpeg/pixels.json``.

Needs PIL and cv2 (it encodes with both and records what both decode), so
it runs on a development host, not on the card's machine. The files are
seeded, smooth scenes with a little noise, at PASCAL VOC's sizes:

- ``baseline_420.jpg``: 500 x 375, 4:2:0, baseline (PIL, quality 85);
- ``restart_444.jpg``: 375 x 500 (portrait), 4:4:4, restart markers every
  4 MCUs (cv2, quality 75);
- ``grey.jpg``: 500 x 375, one component (PIL, quality 80);
- ``progressive_422.jpg``: 500 x 333, 4:2:2, progressive, optimised
  Huffman tables (PIL, quality 80);
- ``exif6.jpg``: 400 x 300 stored, EXIF orientation 6 (PIL, quality 70):
  PIL gives 300 x 400 rows x columns, cv2 turns it to 400 x 300.

``pixels.json`` holds, for each file, the shape and SHA-256 of
``np.array(Image.open(p))`` (``"pil"``) and of ``cv2.cvtColor(cv2.imread(p),
cv2.COLOR_BGR2RGB)`` (``"cv2"``), the arrays ``data/image_io.read_image``
gives in its ``"pil"`` and ``"cv2_color"`` modes. Run from the repository
root: ``python tools/make_jpeg_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "data", "jpeg")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded (h, w, 3) uint8 image: smooth colour fields, a few flat
    shapes with hard edges, and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([120 + 80 * np.sin(xx / rng.uniform(30, 90) + c)
                    * np.cos(yy / rng.uniform(30, 90) - c)
                    for c in range(3)], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * min(h, w)
        colour = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            m = (abs(yy - cy) < r) & (abs(xx - cx) < 1.5 * r)
        img[m] = colour
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    exif = Image.Exif()
    exif[0x0112] = 6
    ok, rst = cv2.imencode(
        ".jpg", scene(500, 375, 1)[..., ::-1],
        [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    assert ok
    files = {
        "baseline_420.jpg": pil_jpeg(scene(375, 500, 0), quality=85,
                                     subsampling=2),
        "restart_444.jpg": rst.tobytes(),
        "grey.jpg": pil_jpeg(scene(375, 500, 2)[..., 1], quality=80),
        "progressive_422.jpg": pil_jpeg(scene(333, 500, 3), quality=80,
                                        subsampling=1, progressive=True,
                                        optimize=True),
        "exif6.jpg": pil_jpeg(scene(300, 400, 4), quality=70,
                              exif=exif.tobytes()),
    }
    table = {}
    for name, data in files.items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        pil = np.array(Image.open(path))
        ocv = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        table[name] = {"bytes": len(data), "pil": digest(pil),
                       "cv2": digest(ocv)}
    with open(os.path.join(OUT, "pixels.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(files)} files, {sum(len(d) for d in files.values())} "
          f"bytes, in {os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
