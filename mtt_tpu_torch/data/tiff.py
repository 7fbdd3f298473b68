"""TIFF decoding on the host for ``image_io.read_image``: the first image of
a classic TIFF file to the array that each of the JAX package's four
readers gives (``image_io.MODES``), without PIL or cv2.

Read: both byte orders; strips and tiles; ``PlanarConfiguration`` 1 and 2;
compression none, LZW, Deflate (8 and 32946) and PackBits, LZW and Deflate
with the horizontal predictor at 8 and 16 bits; photometric min-is-white
and min-is-black (1, 2, 4, 8 bits; 16 bits min-is-black; 8-bit grey with
an alpha sample), RGB (8 or 16 bits, with an unassociated, associated or
unspecified extra sample) and palette (1, 2, 4, 8 bits); the Orientation
tag's values 1-4.

The readers differ, and each mode follows its own:

- ``pil`` and ``pil_rgb`` follow PIL's ``TiffImagePlugin``: its modes and
  raw modes of ``OPEN_INFO`` (min-is-white inverted, 16-bit colour by its
  high bytes, associated alpha divided out, a palette's entries by their
  high bytes), then ``exif_transpose`` of the Orientation tag.
- ``cv2_color`` and ``cv2_unchanged`` follow cv2's ``TiffDecoder``: 8-bit
  output goes through libtiff's ``TIFFReadRGBAStrip`` / ``Tile``
  (``tif_getimage.c``: grey through its 8-bit map, 16-bit samples to 8
  bits by ``(v + 128) / 257`` (colour) or their high bytes (grey),
  unassociated alpha multiplied in, a palette of 16-bit entries by their
  high bytes, the orientation applied); 16-bit ``cv2_unchanged`` output
  is the samples as stored, unturned.

Refused with ``NotImplementedError`` naming ROADMAP.md item 1.13: other
compressions (JPEG-in-TIFF, CCITT, ZSTD, ...), BigTIFF, fill order 2,
signed or floating-point samples, CMYK, YCbCr and Lab, 12-bit and 32-bit
samples, orientations 5-8 (cv2 5.0 refuses them), old-style LZW.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict

import numpy as np

from mtt_tpu_torch.data.image_formats import (ITEM, _check_size,
                                              pil_bool, unpack_bits)

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8}
_TYPE_CODE = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits"}
_PHOTOMETRIC = {0: "min-is-white", 1: "min-is-black", 2: "RGB",
                3: "palette"}
# the most bytes one compressed byte can decode to: LZW (a 9-bit code at the
# least, 4096 bytes at the most), Deflate (258 bytes a 2-bit code),
# PackBits (128 bytes a 2-byte run)
_MAX_RATIO = {1: 1, 5: 3641, 8: 1032, 32946: 1032, 32773: 64}


def _refuse(name: str, what: str):
    raise NotImplementedError(f"{name}: a TIFF with {what}: the port reads "
                              f"the forms of data/tiff.py's docstring "
                              f"({ITEM})")


def _ifd(data: bytes, name: str) -> Dict[int, tuple]:
    """The integer tags of the first IFD: {tag: tuple of values}."""
    e = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: a TIFF of {len(data)} bytes")
    at = struct.unpack_from(e + "I", data, 4)[0]
    if at + 2 > len(data):
        raise ValueError(f"{name}: a TIFF IFD past the end of the file")
    n = struct.unpack_from(e + "H", data, at)[0]
    if at + 2 + 12 * n > len(data):
        raise ValueError(f"{name}: a TIFF IFD past the end of the file")
    tags = {}
    for i in range(n):
        tag, kind, count = struct.unpack_from(e + "HHI", data, at + 2 + 12 * i)
        if kind not in _TYPE_CODE:
            continue                  # ASCII, rationals, floats: unused here
        size = _TYPE_SIZE[kind] * count
        pos = at + 2 + 12 * i + 8
        if size > 4:
            pos = struct.unpack_from(e + "I", data, pos)[0]
            if pos + size > len(data):
                raise ValueError(f"{name}: TIFF tag {tag}'s values past the "
                                 f"end of the file")
        tags[tag] = struct.unpack_from(f"{e}{count}{_TYPE_CODE[kind]}", data,
                                       pos)
    return tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None or not v else v[0]


def _decompress(data: bytes, comp: int, off: int, count: int, size: int,
                name: str) -> np.ndarray:
    """``size`` decoded bytes of the chunk at ``off`` (``count`` bytes)."""
    if off + count > len(data) or count < 0:
        raise ValueError(f"{name}: a TIFF strip or tile past the end of the "
                         f"file")
    raw = data[off:off + count]
    if comp == 1:
        if count < size:
            raise ValueError(f"{name}: a TIFF strip of {count} bytes for "
                             f"{size} (truncated)")
        return np.frombuffer(raw, np.uint8, size)
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt TIFF Deflate data: {e}") \
                from None
        if len(out) < size:
            raise ValueError(f"{name}: TIFF Deflate data ends before its "
                             f"strip is full")
        return np.frombuffer(out, np.uint8)
    from mtt_tpu_torch.data.image_io import lib
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(size, np.uint8)
    if comp == 5:
        if count >= 2 and raw[0] == 0 and raw[1] & 1:
            _refuse(name, "old-style LZW")
        err = ctypes.create_string_buffer(256)
        got = lib().mtt_tiff_lzw_decode(src, src.size, out, size, err, 256)
        if got < 0:
            raise ValueError(f"{name}: corrupt TIFF: "
                             f"{err.value.decode(errors='replace')}")
    else:
        if lib().mtt_tiff_packbits_decode(src, src.size, out, size) < 0:
            raise ValueError(f"{name}: TIFF PackBits data ends before its "
                             f"strip is full")
    return out


def _undo_predictor(chunk: np.ndarray, rows: int, cols: int, nsamp: int,
                    bps: int, e: str) -> np.ndarray:
    """Horizontal differencing undone: each sample plus the same sample of
    the pixel before, mod 2^bps (libtiff's horAcc8 / horAcc16)."""
    dt = np.uint8 if bps == 8 else np.dtype(e + "u2")
    v = chunk.view(dt).reshape(rows, cols, nsamp)
    v = np.cumsum(v, axis=1, dtype=np.uint64) & ((1 << bps) - 1)
    return v.astype(dt).reshape(-1).view(np.uint8)


def samples(data: bytes, name: str) -> Dict:
    """The first image's samples and tags: ``s`` (h, w, spp) uint8 (bps up
    to 8, each sample its value) or uint16 (bps 16, native), ``photo``,
    ``bps``, ``extra`` (the ExtraSamples tuple), ``cmap`` ((n, 3) uint16 or
    None), ``orientation`` and ``big`` (big-endian file)."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        _refuse(name, "BigTIFF")
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError(f"{name} is not a TIFF")
    e = "<" if data[:2] == b"II" else ">"
    tags = _ifd(data, name)
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    _check_size(w, h, name, "TIFF")
    spp = _one(tags, 277, 1)
    bps_all = tags.get(258, (1,))
    if len(set(bps_all)) != 1:
        _refuse(name, f"bits per sample {bps_all}")
    bps = bps_all[0]
    comp = _one(tags, 259, 1)
    photo = _one(tags, 262)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    extra = tuple(tags.get(338, ()))
    orientation = _one(tags, 274, 1)
    if comp not in _COMPRESSIONS:
        _refuse(name, f"compression {comp}"
                + (" (JPEG)" if comp in (6, 7) else ""))
    if photo not in _PHOTOMETRIC:
        _refuse(name, f"photometric interpretation {photo}")
    if set(tags.get(339, (1,))) != {1}:
        _refuse(name, f"sample format {tags[339]}")
    if _one(tags, 266, 1) != 1:
        _refuse(name, "fill order 2")
    if bps not in (1, 2, 4, 8, 16) or (bps == 16 and photo in (0, 3)):
        _refuse(name, f"{bps}-bit {_PHOTOMETRIC[photo]} samples")
    if orientation not in (1, 2, 3, 4):
        _refuse(name, f"orientation {orientation} (cv2 5.0 refuses 5-8)")
    colour = 3 if photo == 2 else 1
    # RGB with a fourth sample and no ExtraSamples tag (cv2 writes them):
    # PIL's "RGBA", libtiff's associated alpha, both the samples as stored
    if spp != colour + len(extra) and not (photo == 2 and spp == 4
                                           and not extra) or (
            len(extra) > 1 or spp > 4) or (
            photo == 2 and bps < 8) or (spp > 1 and bps < 8) or (
            photo == 3 and spp != 1):
        _refuse(name, f"{spp} samples of {bps} bits, extra samples "
                      f"{extra}, photometric {photo}")
    if planar not in (1, 2):
        raise ValueError(f"{name}: TIFF planar configuration {planar}")
    if planar == 2 and photo == 1 and spp == 2:
        _refuse(name, "grey and alpha in planes (PIL refuses it, libtiff's "
                      "RGBA reader mixes the planes)")
    if predictor not in (1, 2) or (predictor == 2 and bps not in (8, 16)
                                   and comp in (5, 8, 32946)):
        _refuse(name, f"predictor {predictor} at {bps} bits")
    planes = spp if planar == 2 else 1
    nsamp = 1 if planar == 2 else spp
    tiled = 322 in tags
    if tiled:
        cw, ch = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324, ()), tags.get(325, ())
        if cw <= 0 or ch <= 0:
            raise ValueError(f"{name}: TIFF tiles of {cw}x{ch}")
    else:
        cw, ch = w, min(_one(tags, 278, h) or h, h)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) != across * down * planes or len(counts) != len(offsets):
        raise ValueError(f"{name}: {len(offsets)} TIFF strip or tile "
                         f"offsets and {len(counts)} byte counts for "
                         f"{across * down * planes}")
    row_bytes = (cw * nsamp * bps + 7) // 8
    dt = np.dtype(e + "u2") if bps == 16 else np.uint8
    cmap = None
    if photo == 3:      # 2^bps entries: no index can fall past the palette
        c = tags.get(320, ())
        if len(c) != 3 << bps:
            raise ValueError(f"{name}: a TIFF colour map of {len(c)} "
                             f"entries for {bps}-bit samples")
        cmap = np.array(c, np.uint16).reshape(3, -1).T
    # before anything is allocated: each chunk's bytes lie in the file and
    # can expand to its rows at the most its compression reaches
    for k in range(len(offsets)):
        y0 = (k % (across * down)) // across * ch
        rows = ch if tiled else min(ch, h - y0)
        if offsets[k] + counts[k] > len(data):
            raise ValueError(f"{name}: a TIFF strip or tile past the end of "
                             f"the file")
        if rows * row_bytes > counts[k] * _MAX_RATIO[comp] + 4096:
            raise ValueError(f"{name}: a TIFF strip or tile of {counts[k]} "
                             f"bytes cannot hold {rows * row_bytes} "
                             f"(truncated)")
    out = np.empty((h, w, spp), np.uint16 if bps == 16 else np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, h - y0)
                chunk = _decompress(data, comp, offsets[k], counts[k],
                                    rows * row_bytes, name)
                k += 1
                if predictor == 2 and comp != 1 and comp != 32773:
                    chunk = _undo_predictor(chunk, rows, cw, nsamp, bps, e)
                chunk = chunk.reshape(rows, row_bytes)
                if bps == 16:
                    px = chunk.view(dt).astype(np.uint16)
                else:
                    px = unpack_bits(np.ascontiguousarray(chunk),
                                     cw * nsamp, bps)
                px = px.reshape(rows, cw, nsamp)
                hh, ww = min(rows, h - y0), min(cw, w - x0)
                out[y0:y0 + hh, x0:x0 + ww, p:p + nsamp] = px[:hh, :ww]
    return {"s": out, "photo": photo, "bps": bps, "extra": extra,
            "cmap": cmap, "orientation": orientation, "big": e == ">",
            "planar": planar, "tile_w": cw if tiled else 0, "comp": comp}


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's ``RGBa`` raw mode: colour * 255 / alpha (integer division,
    clipped), 0 where alpha is 0."""
    a = rgba[..., 3:].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    rgb = np.where(a == 0, 0, np.minimum(c * 255 // np.maximum(a, 1), 255))
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _pil(t: Dict, mode: str, name: str) -> np.ndarray:
    s, photo, bps, extra = t["s"], t["photo"], t["bps"], t["extra"]
    if t["planar"] == 2 and s.shape[2] > 1 and (
            extra == (0,) or (t["comp"] == 1 and (
                bps == 16 or extra == (1,)))):
        # PIL unpacks each plane by one band of the raw mode: it has none
        # for X (nor for a, uncompressed), and reads uncompressed 16-bit
        # planes as 8-bit samples
        _refuse(name, f"{bps}-bit samples {extra} of photometric {photo} "
                      f"in planes, in PIL's modes")
    if t["planar"] == 2 and s.shape[2] == 4 and not extra and \
            t["comp"] != 1:
        extra = (1,)        # libtiff's planes: the 4th an associated alpha
    if photo in (0, 1) and s.shape[2] == 1:
        g = s[..., 0]
        if bps == 1:
            b = pil_bool((g == 0) if photo == 0 else (g == 1))
            return b if mode == "pil" else np.repeat(
                b.view(np.uint8)[..., None], 3, -1)
        if bps == 16:
            if mode == "pil":
                return g.astype(">u2") if t["big"] else g
            g = np.minimum(g, 255).astype(np.uint8)
        else:
            g = g * np.uint8(255 // ((1 << bps) - 1))
            if photo == 0:
                g = 255 - g
        return g if mode == "pil" else np.repeat(g[..., None], 3, -1)
    if photo == 1:                                  # grey + alpha: "LA"
        if extra != (2,):
            raise ValueError(f"grey + extra sample {extra}: PIL refuses it")
        return s if mode == "pil" else np.repeat(s[..., :1], 3, -1)
    if photo == 3:
        idx = s[..., 0]
        if mode == "pil":
            return idx
        return (t["cmap"] // 256).astype(np.uint8)[idx]
    v = (s >> 8).astype(np.uint8) if bps == 16 else s
    if v.shape[2] == 4:
        if extra == (0,):
            v = v[..., :3]
        elif extra == (1,):
            v = _unpremultiply(v)
    if mode == "pil_rgb":
        v = v[..., :3]
    return np.ascontiguousarray(v)


def _rgba8(t: Dict) -> np.ndarray:
    """(h, w, 4) uint8 RGBA as libtiff's TIFFRGBAImage gives it, top row
    first."""
    s, photo, bps, extra = t["s"], t["photo"], t["bps"], t["extra"]
    h, w = s.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if photo in (0, 1):
        g = s[..., 0]
        if bps == 16:
            g = (g >> 8).astype(np.uint8)            # the high byte
        else:
            top = (1 << bps) - 1
            lut = np.arange(top + 1) * 255 // top
            if photo == 0:
                lut = lut[::-1]
            g = lut.astype(np.uint8)[g]
        out[..., :3] = g[..., None]
        if s.shape[2] == 2:
            out[..., 3] = s[..., 1]
        return out
    if photo == 3:
        cmap = t["cmap"]
        pal = (cmap >> 8 if (cmap >= 256).any() else cmap).astype(np.uint8)
        out[..., :3] = pal[s[..., 0]]
        return out
    if bps == 16:
        v = ((s.astype(np.uint32) + 128) // 257).astype(np.uint8)
    else:
        v = s
    out[..., :3] = v[..., :3]
    if v.shape[2] == 4:
        out[..., 3] = v[..., 3]
        if extra == (2,):             # unassociated: multiplied in
            a = v[..., 3:].astype(np.uint32)
            out[..., :3] = ((v[..., :3] * a + 127) // 255).astype(np.uint8)
    return out


def _grey(rgba: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_BGRA2Gray_8u_C4C1R`` of libtiff's RGBA: 0.299 R +
    0.587 G + 0.114 B in 14-bit fixed point, rounded."""
    c = rgba.astype(np.int32)
    return ((c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868 + 8192)
            >> 14).astype(np.uint8)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    if orientation in (3, 4):
        img = img[::-1]
    if orientation in (2, 3):
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def read_tiff(data: bytes, name: str, mode: str) -> np.ndarray:
    """The array of reader ``mode`` for a TIFF file (its first image)."""
    t = samples(data, name)
    if mode.startswith("pil"):
        return _orient(_pil(t, mode, name), t["orientation"])
    s, bps = t["s"], t["bps"]
    if bps == 2 or (bps == 4 and t["photo"] != 3):
        raise ValueError(f"{name}: a {bps}-bit {_PHOTOMETRIC[t['photo']]} "
                         f"TIFF: cv2 refuses it")
    if mode == "cv2_unchanged" and bps == 16:
        if t["planar"] == 2 and s.shape[2] > 1:
            _refuse(name, "16-bit samples in planes, in cv2_unchanged: cv2 "
                          "reads the first plane as interleaved samples")
        order = [2, 1, 0, 3][:s.shape[2]]
        return _orient(s[..., order] if s.shape[2] > 1 else s[..., 0],
                       t["orientation"])
    tw = t["tile_w"]
    if tw and s.shape[1] % tw and t["photo"] == 1 and (
            bps == 16 or s.shape[2] == 2):
        _refuse(name, "16-bit grey or grey + alpha in tiles that overhang "
                      "the image, in cv2's 8-bit modes: libtiff's "
                      "TIFFReadRGBATile reads the rightmost tiles' rows at "
                      "another pitch than their own")
    rgba = _rgba8(t)
    if tw and t["orientation"] in (2, 3):
        # TIFFReadRGBATile mirrors each tile's columns within the tile, and
        # cv2 puts the tile back where it was: mirrored tile by tile
        for x0 in range(0, rgba.shape[1], tw):
            rgba[:, x0:x0 + tw] = rgba[:, x0:x0 + tw][:, ::-1]
        rgba = _orient(rgba, 4 if t["orientation"] == 3 else 1)
    else:
        rgba = _orient(rgba, t["orientation"])
    if mode == "cv2_color":
        return np.ascontiguousarray(rgba[..., :3])
    # cv2's channels: one at 1 bit, three for a palette of more, else the
    # samples (grey + alpha read as grey)
    n = 1 if bps == 1 else 3 if t["photo"] == 3 else s.shape[2]
    if n in (1, 2):
        return _grey(rgba)
    return np.ascontiguousarray(rgba[..., [2, 1, 0, 3][:n]])
