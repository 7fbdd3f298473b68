"""BMP and PNM decoding on the host, for ``image_io.read_image``: each
file to the array that each of the JAX package's four readers gives
(``image_io.MODES``), without PIL or cv2; TIFF is ``data/tiff.py``.

The rules each reader follows are fixed here as constants and formulas, as
PIL 12.1 and cv2 5.0 apply them; the CPU tests hold every form to both.

- BMP: ``BITMAPINFOHEADER`` (40 bytes), its 52- and 56-byte extensions and
  the V4 and V5 headers; 1-, 4- and 8-bit palettes, 24-bit, 32-bit
  ``BI_RGB`` and 32-bit ``BI_BITFIELDS`` with one byte a channel; rows
  bottom-up or top-down. RLE4, RLE8, 16-bit, 24-bit bit fields, embedded
  JPEG or PNG and the OS/2 headers raise ``NotImplementedError``.
- PNM: P1-P6, plain (ASCII) and raw, maxval 1 to 65535.

A truncated or corrupt file raises ``ValueError``, as do a palette index
past the palette and a frame above 2^30 pixels (cv2's limit, checked
before anything is allocated). Forms left out raise ``NotImplementedError``
naming ROADMAP.md item 1.13.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

ITEM = "ROADMAP.md item 1.13"
# cv2's CV_IO_MAX_IMAGE_PIXELS: larger frames are refused, not allocated
MAX_PIXELS = 1 << 30

def _check_size(w: int, h: int, name: str, what: str) -> None:
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: a {what} of {w}x{h} pixels")
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: a {w}x{h} {what}, above the decoder's "
                         f"limit of 2^30 pixels (cv2's)")


def pil_bool(mask: np.ndarray) -> np.ndarray:
    """A bool array as PIL's mode "1" gives it: each True stored as the byte
    255 (numpy reads any nonzero byte as True)."""
    return np.where(mask, np.uint8(255), np.uint8(0)).view(np.bool_)


def unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, stride) bytes of ``bits``-bit samples, most significant first, to
    (h, w) uint8 samples."""
    if bits == 8:
        return rows[:, :w]
    px = np.unpackbits(rows, axis=1)[:, :w * bits]
    if bits == 1:
        return px
    px = px.reshape(rows.shape[0], w, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (px * weights).sum(-1, dtype=np.uint8)


# --- BMP ---------------------------------------------------------------------

_BMP_HEADERS = (40, 52, 56, 108, 124)
# PIL's BmpImagePlugin: the 32-bit masks (R, G, B, A) it takes, and the
# raw mode (the channel of each byte) of each
_PIL_MASKS = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
_BYTE_MASKS = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)


def _u32(data: bytes, at: int) -> int:
    return struct.unpack_from("<I", data, at)[0]


def _bmp(data: bytes, name: str) -> Dict:
    """The header, palette and rows of a BMP file: a dict of ``bits``,
    ``hsize`` (the info header's size), ``masks`` (R, G, B, A, read as PIL
    reads them), ``palette`` ((n, 4) B, G, R, X bytes or None), ``rows``
    ((h, stride) uint8, top row first) and ``w``."""
    if len(data) < 18:
        raise ValueError(f"{name}: a BMP of {len(data)} bytes")
    offset, hsize = _u32(data, 10), _u32(data, 14)
    if hsize not in _BMP_HEADERS:
        raise NotImplementedError(
            f"{name}: a BMP info header of {hsize} bytes: the port reads "
            f"the Windows headers of 40, 52, 56, 108 and 124 bytes ({ITEM})")
    if len(data) < 14 + hsize:
        raise ValueError(f"{name}: a BMP header past the end of the file")
    w, h, _, bits, comp = struct.unpack_from("<iiHHI", data, 18)
    clrused = _u32(data, 46)
    if comp in (1, 2):
        raise NotImplementedError(
            f"{name}: an RLE{8 if comp == 1 else 4} BMP: neither PIL nor cv2 "
            f"writes one, so no test can hold a decoder to them ({ITEM})")
    if comp not in (0, 3) or bits not in (1, 4, 8, 24, 32) or (
            comp == 3 and bits != 32):
        raise NotImplementedError(
            f"{name}: a {bits}-bit BMP of compression {comp}: the port reads "
            f"1-, 4-, 8-, 24- and 32-bit BI_RGB and 32-bit BI_BITFIELDS "
            f"({ITEM})")
    top_down = h < 0
    h = abs(h)
    _check_size(w, h, name, "BMP")
    masks = None
    if comp == 3:        # after a 40-byte header, else in it (alpha from 56)
        n = 4 if hsize >= 56 else 3
        if len(data) < 54 + 4 * n:
            raise ValueError(f"{name}: BMP bit fields past the end")
        masks = struct.unpack_from(f"<{n}I", data, 54) + (0,) * (4 - n)
    palette = None
    if bits <= 8:
        colors = clrused or 1 << bits
        if colors > 256:
            raise ValueError(f"{name}: a BMP palette of {colors} colours")
        at = 14 + hsize
        if at + 4 * colors > len(data):
            raise ValueError(f"{name}: a BMP palette past the end")
        palette = np.frombuffer(data, np.uint8, 4 * colors, at).reshape(-1, 4)
    stride = ((w * bits + 31) >> 5) * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: BMP rows past the end of the file "
                         f"(truncated)")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    return {"bits": bits, "hsize": hsize, "masks": masks, "palette": palette,
            "rows": rows if top_down else rows[::-1], "w": w}


def read_bmp(data: bytes, name: str, mode: str) -> np.ndarray:
    """The array of reader ``mode`` for a BMP file."""
    b = _bmp(data, name)
    bits, rows, w, pal = b["bits"], b["rows"], b["w"], b["palette"]
    if bits <= 8:
        idx = unpack_bits(rows, w, bits)
        if idx.max(initial=0) >= len(pal):
            raise ValueError(f"{name}: a BMP palette index past the "
                             f"palette's {len(pal)} entries")
        bgr = pal[:, :3]
        if mode.startswith("pil"):
            # PIL: a palette of exactly (0, 255) (two colours) or 0, 1, ...
            # (more) is read as 1-bit or grey, by that raw mode, whatever
            # the file's depth
            ramp = np.array([0, 255]) if len(pal) == 2 else \
                np.arange(len(pal))
            if (bgr == ramp[:, None]).all():
                if len(pal) == 2:
                    g = unpack_bits(rows, w, 1) * np.uint8(255)
                    return g.view(np.bool_) if mode == "pil" else np.repeat(
                        g[..., None], 3, -1)
                if rows.shape[1] < w:   # PIL maps rows that overlap
                    raise NotImplementedError(
                        f"{name}: PIL reads this {bits}-bit BMP of a "
                        f"0, 1, ... palette as 8-bit samples, each row "
                        f"past its own ({ITEM})")
                g = rows[:, :w]
                return g if mode == "pil" else np.repeat(g[..., None], 3, -1)
            return idx if mode == "pil" else bgr[idx][..., ::-1]
        full = np.zeros((1 << bits, 3), np.uint8)
        full[:len(pal)] = bgr
        if mode == "cv2_unchanged" and (full == full[:, :1]).all():
            return bgr[idx, 0]        # cv2: a grey palette reads as grey
        px = bgr[idx]
        return np.ascontiguousarray(px if mode == "cv2_unchanged"
                                    else px[..., ::-1])
    px = rows[:, :w * bits // 8].reshape(rows.shape[0], w, bits // 8)
    if bits == 24:
        return np.ascontiguousarray(px if mode == "cv2_unchanged"
                                    else px[..., ::-1])
    masks = b["masks"]
    if masks is None:                  # BI_RGB: the fourth byte unused
        return np.ascontiguousarray(px[..., :3] if mode == "cv2_unchanged"
                                    else px[..., 2::-1])
    if mode.startswith("pil"):
        order = _PIL_MASKS.get(masks)
        if order is None:
            raise ValueError(f"{name}: BMP bit fields "
                             f"{[hex(m) for m in masks]}: PIL refuses them")
        # the byte each of R, G, B (and A) sits in; X bytes are dropped
        out = px[..., [order.index(c) for c in "RGBA" if c in order]]
        return np.ascontiguousarray(out if mode == "pil" else out[..., :3])
    if b["hsize"] < 56:                # cv2 reads no masks: B, G, R, A bytes
        bgra = px
    else:
        r, g, bl, a = masks
        if len({r, g, bl}) != 3 or not {r, g, bl} <= set(_BYTE_MASKS) or (
                a and a not in _BYTE_MASKS or a in (r, g, bl)):
            raise NotImplementedError(
                f"{name}: BMP bit fields {[hex(m) for m in masks]}: the "
                f"port reads masks of one byte a channel ({ITEM})")
        pick = [_BYTE_MASKS.index(m) for m in (bl, g, r)]
        bgra = np.empty(px.shape, np.uint8)
        bgra[..., :3] = px[..., pick]
        bgra[..., 3] = px[..., _BYTE_MASKS.index(a)] if a else 255
    return np.ascontiguousarray(bgra if mode == "cv2_unchanged"
                                else bgra[..., 2::-1])


# --- PNM ---------------------------------------------------------------------

_PNM_SPACE = b" \t\n\v\f\r"


def _pnm_header(data: bytes, name: str) -> Tuple[int, int, int, int, int]:
    """(kind 1-6, width, height, maxval, offset of the samples): the header's
    tokens, separated by white space, ``#`` comments to the end of the
    line; one white space byte after the last."""
    kind = data[1] - ord("0")
    tokens, pos = [], 2
    need = 2 if kind in (1, 4) else 3
    while len(tokens) < need:
        while pos < len(data) and (data[pos] in _PNM_SPACE or
                                   data[pos] == ord("#")):
            if data[pos] == ord("#"):
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and data[pos] not in _PNM_SPACE and \
                data[pos] != ord("#"):
            pos += 1
        tok = data[start:pos]
        if not tok.isdigit() or len(tok) > 10:
            raise ValueError(f"{name}: PNM header token {tok[:12]!r}")
        tokens.append(int(tok))
    if pos >= len(data) or data[pos] not in _PNM_SPACE:
        raise ValueError(f"{name}: a PNM header without its last white "
                         f"space")
    w, h = tokens[0], tokens[1]
    maxval = tokens[2] if need == 3 else 1
    _check_size(w, h, name, "PNM")
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM maxval {maxval}")
    return kind, w, h, maxval, pos + 1


def _pnm_samples(data: bytes, name: str) -> Tuple[int, int, np.ndarray]:
    """(kind, maxval, samples): (h, w) for P1/P2/P4/P5, (h, w, 3) for
    P3/P6, int64, as stored (P1/P4: 1 is black)."""
    kind, w, h, maxval, at = _pnm_header(data, name)
    ch = 3 if kind in (3, 6) else 1
    n = w * h * ch
    if kind == 4:
        stride = (w + 7) // 8
        if at + stride * h > len(data):
            raise ValueError(f"{name}: PNM samples past the end (truncated)")
        rows = np.frombuffer(data, np.uint8, stride * h, at).reshape(h, stride)
        return kind, 1, unpack_bits(rows, w, 1).astype(np.int64)
    if kind in (5, 6):
        size = 2 if maxval > 255 else 1
        if at + n * size > len(data):
            raise ValueError(f"{name}: PNM samples past the end (truncated)")
        s = np.frombuffer(data, ">u2" if size == 2 else np.uint8, n, at)
    else:
        body = _strip_comments(data[at - 1:])
        if kind == 1:     # plain PBM: each digit a sample, spaces optional
            digits = bytes(c for c in body if c not in _PNM_SPACE)[:n]
            if any(c not in b"01" for c in digits):
                raise ValueError(f"{name}: a P1 sample that is not 0 or 1")
            s = np.frombuffer(digits, np.uint8) - ord("0")
        else:
            toks = body.split()[:n]
            if any(not t.isdigit() or len(t) > 10 for t in toks):
                raise ValueError(f"{name}: a PNM sample that is not a "
                                 f"number")
            s = np.array([int(t) for t in toks], np.int64)
            if s.size and s.max() > maxval:
                raise ValueError(f"{name}: a PNM sample above maxval "
                                 f"{maxval}")
        if s.size < n:
            raise ValueError(f"{name}: {s.size} PNM samples of {n} "
                             f"(truncated)")
    s = s.astype(np.int64).reshape((h, w, 3) if ch == 3 else (h, w))
    return kind, maxval, s


def _strip_comments(body: bytes) -> bytes:
    """Plain PNM samples without their ``#`` comments (each to the end of
    its line)."""
    out, pos = [], 0
    while True:
        c = body.find(b"#", pos)
        if c < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:c])
        e = min([i for i in (body.find(b"\n", c), body.find(b"\r", c))
                 if i >= 0], default=len(body))
        pos = e


def _pil_scale(s: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """PIL's ``round(value / maxval * top)`` (half to even), clipped to
    ``top``."""
    return np.minimum(np.rint(s / maxval * top), top).astype(np.int64)


def read_pnm(data: bytes, name: str, mode: str) -> np.ndarray:
    """The array of reader ``mode`` for a PBM, PGM or PPM file (P1-P6)."""
    kind, maxval, s = _pnm_samples(data, name)
    if kind in (1, 4):
        if mode == "pil":
            return pil_bool(s == 0)             # "1": white is True
        g = np.where(s == 0, 255, 0).astype(np.uint8)
        return g if mode == "cv2_unchanged" else np.repeat(g[..., None], 3,
                                                           -1)
    plain, grey = kind in (2, 3), kind in (2, 5)
    if mode.startswith("pil"):
        if grey and maxval > 255:               # PIL mode "I"
            v = s if (maxval == 65535 and not plain) else \
                _pil_scale(s, maxval, 65535)
            if mode == "pil":
                return v.astype(np.int32)
            return np.repeat(np.minimum(v, 255).astype(np.uint8)[..., None],
                             3, -1)
        v = s if maxval == 255 else _pil_scale(s, maxval, 255)
        v = v.astype(np.uint8)
        if grey and mode == "pil_rgb":
            return np.repeat(v[..., None], 3, -1)
        return v
    # cv2: plain 8-bit samples through its table i * 255 / maxval, raw ones
    # as stored; 16-bit samples as stored, by their high bytes in colour
    if maxval > 255:
        v = np.minimum(s, maxval).astype(np.uint16)
        if mode == "cv2_color":
            v = (v >> 8).astype(np.uint8)
    else:
        v = (np.minimum(s, maxval) * 255 // maxval if plain else s).astype(
            np.uint8)
    if grey:
        return v if mode == "cv2_unchanged" else np.repeat(v[..., None], 3,
                                                           -1)
    return np.ascontiguousarray(v[..., ::-1] if mode == "cv2_unchanged"
                                else v)
