"""Write the image fixtures of the forms beyond baseline JPEG and plain PNG
and the digests of what PIL and cv2 decode from them:
``tests/data/images/*`` and ``tests/data/images/pixels.json``.

Needs PIL and cv2 (it encodes with both and records what both decode), so
it runs on a development host, not on the card's machine; the forms that
neither writes come from ``tests/image_writers.py`` and the Adam7 writer of
``tests/test_torch_image_io.py``. The files are seeded scenes, 53 x 37
(odd, so that every MCU, pass, tile and strip has a ragged edge), and one
at PASCAL VOC's 500 x 375 for timing the decoder:

- JPEG: ``jpeg_411_500x375.jpg`` (cv2's 4:1:1, quality 85),
  ``jpeg_y4x2.jpg`` (Y 4x2, Cb and Cr 2x1: 12 blocks an MCU, so one scan
  a component; the h2v2 filter), ``cmyk.jpg`` (PIL's Adobe
  CMYK), ``ycck.jpg`` (the same scans with the Adobe transform set to 2);
- PNG: ``adam7_rgb.png``, ``adam7_palette_trns.png`` (4-bit palette with
  tRNS), ``exif6.png`` (eXIf orientation 6: cv2 turns it to 37 x 53);
- BMP: ``palette8.bmp``, ``bgra_v5_topdown.bmp`` (32-bit bit fields, V5
  header), ``bw1.bmp`` (1-bit black and white);
- PNM: ``rgb16.ppm`` (P6, maxval 65535), ``grey_plain.pgm`` (P2, maxval
  100, comments), ``bits.pbm`` (P4);
- TIFF: ``rgb_lzw_pred.tif`` (LZW with the predictor, strips of 8 rows),
  ``rgba_deflate_tiles_planar_mm.tif`` (big-endian, Deflate, 16 x 16
  tiles, a plane a sample), ``palette4_packbits.tif``,
  ``grey16_deflate_mm.tif`` (big-endian 16-bit grey: PIL's ``>u2``),
  ``orient3_lzw.tif`` (Orientation 3).

``pixels.json`` holds, for each file, its bytes and, for each of
``data/image_io.read_image``'s modes, the shape, dtype and SHA-256 of the
array the call it stands for gives (``pil``: ``np.array(Image.open(p))``,
``pil_rgb``: ``.convert("RGB")``, ``cv2_color``: ``cv2.imread`` in RGB
order, ``cv2_unchanged``: ``IMREAD_UNCHANGED``), or null where that call
refuses the file. Run from the repository root:
``python tools/make_image_fixtures.py``.
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

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "data", "images")
sys.path.insert(0, os.path.join(ROOT, "tests"))

from image_writers import bmp, encode_jpeg, pnm, scene, tiff  # noqa: E402
from test_torch_image_io import _png  # noqa: E402

MODES = ("pil", "pil_rgb", "cv2_color", "cv2_unchanged")
H, W = 37, 53


def digest(a):
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def reference(path):
    """{mode: the array of the call the mode stands for, None if refused}."""
    out = {}
    for mode, read in (("pil", lambda: np.array(Image.open(path))),
                       ("pil_rgb", lambda: np.array(
                           Image.open(path).convert("RGB")))):
        try:
            out[mode] = read()
        except (OSError, ValueError, SyntaxError):
            out[mode] = None
    a = cv2.imread(path)
    out["cv2_color"] = None if a is None else cv2.cvtColor(
        a, cv2.COLOR_BGR2RGB)
    out["cv2_unchanged"] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return out


def files() -> dict:
    rng = np.random.default_rng(24)
    img = scene(H, W, 1)
    grey = scene(H, W, 2)[..., 1]
    out = {}
    ok, enc = cv2.imencode(".jpg", scene(375, 500, 3)[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    assert ok
    out["jpeg_411_500x375.jpg"] = enc.tobytes()
    out["jpeg_y4x2.jpg"] = encode_jpeg([img[..., c] for c in range(3)],
                                       [(4, 2), (2, 1), (2, 1)],
                                       interleaved=False)
    b = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(b, "JPEG", quality=90)
    cmyk = b.getvalue()
    out["cmyk.jpg"] = cmyk
    ycck = bytearray(cmyk)
    ycck[cmyk.index(b"\xff\xee") + 15] = 2
    out["ycck.jpg"] = bytes(ycck)

    out["adam7_rgb.png"] = _png(img.astype(np.int64), 8, 2,
                                filters=(0, 1, 2, 3, 4), interlace=1)
    pal = rng.integers(0, 256, (16, 3))
    out["adam7_palette_trns.png"] = _png(
        rng.integers(0, 16, (H, W, 1)), 4, 3, palette=pal,
        trns=bytes(rng.integers(0, 256, 5).tolist()), filters=(1, 4),
        interlace=1)
    exif = Image.Exif()
    exif[0x0112] = 6
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG", exif=exif.tobytes())
    out["exif6.png"] = b.getvalue()

    out["palette8.bmp"] = bmp(rng.integers(0, 200, (H, W)), 8,
                              rng.integers(0, 256, (200, 3)))
    out["bgra_v5_topdown.bmp"] = bmp(
        np.concatenate([img[..., ::-1], grey[..., None]], -1), 32,
        header=124, top_down=True,
        bitfields=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["bw1.bmp"] = bmp(grey > 128, 1, [[0, 0, 0], [255, 255, 255]])

    out["rgb16.ppm"] = pnm(6, img.astype(np.int64) * 257 + 3, 65535)
    out["grey_plain.pgm"] = pnm(2, grey.astype(np.int64) * 100 // 255, 100,
                                comments=True)
    out["bits.pbm"] = pnm(4, grey > 100)

    out["rgb_lzw_pred.tif"] = tiff(img, 8, 2, comp=5, predictor=2, rps=8)
    rgba = np.concatenate([img, grey[..., None]], -1)
    out["rgba_deflate_tiles_planar_mm.tif"] = tiff(
        rgba, 8, 2, big=True, comp=8, planar=2, tile=(16, 16), extra=(2,))
    out["palette4_packbits.tif"] = tiff(
        rng.integers(0, 16, (H, W, 1)).astype(np.uint8), 4, 3, comp=32773,
        cmap=rng.integers(0, 256, (16, 3)) * 257)
    out["grey16_deflate_mm.tif"] = tiff(
        (grey.astype(np.uint16) * 257 + 5)[..., None], 16, 1, big=True,
        comp=8, predictor=2)
    out["orient3_lzw.tif"] = tiff(img, 8, 2, comp=5, orientation=3)
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    table = {}
    for name, data in files().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = reference(path)
        table[name] = {"bytes": len(data),
                       "modes": {m: digest(ref[m]) for m in MODES}}
    with open(os.path.join(OUT, "pixels.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(t["bytes"] for t in table.values())
    print(f"{len(table)} files, {total} bytes, in {os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
