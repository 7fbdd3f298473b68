"""Image decoding on the host for the dataset readers and the inference CLI,
without PIL or cv2 (the card's machine has neither).

- ``read_jpeg``: a baseline or progressive Huffman JPEG (1, 3 or 4
  components, sampling factors 1-4 on each axis, restart markers) decoded
  by the C++ library ``data/csrc/image_decode.cpp`` to the pixels
  libjpeg-turbo gives by default (its integer IDCT, its upsampling: the
  "fancy" filters for the 2:1 ratios, replication for the other integral
  ones, and its YCbCr->RGB and YCCK->CMYK tables), bit for bit, which are
  what both PIL and cv2 give.
- ``read_png``: the samples of a PNG of any bit depth (1-16) and colour type
  (grey, RGB, palette, grey + alpha, RGBA), without interlace or Adam7, its
  scanlines (each Adam7 pass on its own) unfiltered by the same library.
- BMP, PNM and TIFF: ``data/image_formats.py`` and ``data/tiff.py``, which
  list the forms they read.
- ``read_image(path, mode)``: the array that one of the JAX package's four
  ways of opening a file gives, the format sniffed from the file's first
  bytes:
  - ``"pil"``: ``np.array(Image.open(p))``, its labels' reader. A palette
    PNG gives its indices, 16-bit grey uint16, 1-bit grey bool, 2- and 4-bit
    grey scaled to 8 bits, 16-bit colour its high bytes (16-bit grey +
    alpha as RGBA), a JPEG its RGB or grey pixels, a CMYK or YCCK JPEG
    PIL's inverted CMYK.
  - ``"pil_rgb"``: ``Image.open(p).convert("RGB")``, its images' reader:
    grey repeated (16-bit grey clipped at 255), alpha dropped, the palette
    expanded, CMYK through PIL's ``cmyk2rgb``.
  - ``"cv2_color"``: ``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)``:
    (H, W, 3) uint8, 16-bit samples by their high bytes, palette expanded,
    alpha dropped, CMYK through cv2's ``icvCvt_CMYK2BGR_8u_C4C3R``.
  - ``"cv2_unchanged"``: ``cv2.imread(p, cv2.IMREAD_UNCHANGED)``, in cv2's
    BGR(A) channel order: grey (sub-byte depths scaled to 8 bits) stays
    (H, W), 16 bits stay uint16, a palette or grey + alpha becomes 3 or 4
    channels, a palette or RGB ``tRNS`` chunk an alpha channel, a
    4-component JPEG 3 channels.

  EXIF orientation: ``cv2_color`` turns a JPEG by its APP1 Exif block and a
  PNG by its first ``eXIf`` chunk (before or after the image data), as
  ``cv2.imread`` does; no other mode turns a JPEG or PNG. A TIFF's
  Orientation tag turns it in every mode (PIL's ``exif_transpose`` on load,
  libtiff's RGBA reader in cv2's), see ``data/tiff.py``.

The library is built with g++ at first use (``utils/native_build.py``); a
build that fails raises, and nothing falls back to numpy. ``impl="plain"``
unfilters PNG scanlines in numpy, the plain version the tests hold the
library to. There is no plain JPEG decoder: PIL and cv2 are the CPU tests'
reference. Forms the decoders refuse raise ``NotImplementedError`` naming
ROADMAP.md item 1.13: arithmetic-coded, lossless, hierarchical and 12-bit
JPEG, 2-component JPEG; WebP, GIF, JPEG 2000, AVIF, HDR, PFM, Sun raster and
other formats; the BMP and TIFF forms their modules name. A corrupt JPEG,
one that ends before its EOI marker (PIL and cv2 refuse both), one whose
sampling factors are not integral ratios (libjpeg refuses it) and any image
whose frame has more than 2^30 pixels (cv2's limit) raise ``ValueError``,
as do corrupt files of the other formats.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np

from mtt_tpu_torch.data import image_formats, tiff
from mtt_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "image_decode.cpp"
# -fwrapv: signed overflow (only a corrupt file can cause one) wraps
# rather than being undefined, so no optimisation changes a result
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++20", "-fwrapv")
ITEM = image_formats.ITEM
MODES = ("pil", "pil_rgb", "cv2_color", "cv2_unchanged")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # + BigTIFF

_ERR_LEN = 256
MAX_PIXELS = image_formats.MAX_PIXELS
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def build() -> Path:
    """Compiles ``data/csrc/image_decode.cpp`` unless a library of the same
    source, flags and compiler exists; returns its path."""
    return native_build.build(SOURCE, "image_decode", CXX_FLAGS)


def _bind(handle: ctypes.CDLL) -> None:
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, buf = ctypes.c_int64, ctypes.c_char_p
    handle.mtt_jpeg_info.argtypes = [u8, i64, i32, buf, ctypes.c_int]
    handle.mtt_jpeg_info.restype = ctypes.c_int
    handle.mtt_jpeg_decode.argtypes = [u8, i64, u8, i64, buf, ctypes.c_int]
    handle.mtt_jpeg_decode.restype = ctypes.c_int
    handle.mtt_png_unfilter.argtypes = [u8, i64, i64, i64, u8]
    handle.mtt_png_unfilter.restype = ctypes.c_int
    handle.mtt_tiff_lzw_decode.argtypes = [u8, i64, u8, i64, buf, ctypes.c_int]
    handle.mtt_tiff_lzw_decode.restype = i64
    handle.mtt_tiff_packbits_decode.argtypes = [u8, i64, u8, i64]
    handle.mtt_tiff_packbits_decode.restype = i64


def lib() -> ctypes.CDLL:
    """The loaded decoding library, built at first use."""
    return native_build.load("image_decode", build, _bind)


def _check_impl(impl):
    if impl not in (None, "native", "plain"):
        raise ValueError(f"impl must be 'native' or 'plain', got {impl!r}")


def _bytes(src: Union[str, Path, bytes]) -> Tuple[bytes, str]:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), str(src)


# --- JPEG --------------------------------------------------------------------

def _jpeg_raise(code: int, err, name: str):
    msg = err.value.decode(errors="replace")
    if code == 2:
        raise NotImplementedError(
            f"{name}: {msg}: the port's JPEG decoder reads baseline and "
            f"progressive Huffman JPEG of 8-bit samples, 1, 3 or 4 "
            f"components ({ITEM})")
    if code == 3:
        raise ValueError(f"{name}: {msg}")
    raise ValueError(f"{name}: corrupt JPEG: {msg}")


def read_jpeg(src: Union[str, Path, bytes]) -> np.ndarray:
    """The pixels of a JPEG file (or its bytes): (H, W) uint8 grey, (H, W,
    3) uint8 RGB or (H, W, 4) uint8 CMYK (libjpeg's ``JCS_CMYK``: Adobe's
    stored samples, or converted from YCCK), libjpeg-turbo's default
    decompression bit for bit; no EXIF orientation (``jpeg_orientation``)."""
    return _decode_jpeg(*_bytes(src))


def _decode_jpeg(data: bytes, name: str) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    handle = lib()
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    code = handle.mtt_jpeg_info(buf, buf.size, info, err, _ERR_LEN)
    if code:
        _jpeg_raise(code, err, name)
    w, h, ncomp = int(info[0]), int(info[1]), int(info[2])
    out = np.empty((h, w) if ncomp == 1 else (h, w, ncomp), np.uint8)
    code = handle.mtt_jpeg_decode(buf, buf.size, out.reshape(-1), out.size,
                                  err, _ERR_LEN)
    if code:
        _jpeg_raise(code, err, name)
    return out


def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF header (an Exif block's body), 1 when
    absent or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(e + "HH", tiff[at:at + 4])
        if tag == 0x0112 and kind == 3:
            v = struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def jpeg_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG's APP1 Exif segment, 1 when it
    has none."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return 1
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):       # EOI, SOS: no more headers
            return 1
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body.startswith(b"Exif\x00\x00"):
            return _exif_orientation(body[6:])
        pos += 2 + length
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The image as cv2's ``ExifTransform`` turns it for an EXIF
    orientation: 2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90
    clockwise, 7 transverse, 8 rotate 90 counter-clockwise."""
    if orientation >= 5:
        img = np.swapaxes(img, 0, 1)
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


# --- PNG ---------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


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


def png_unfilter(rows: np.ndarray, bpp: int, impl=None) -> np.ndarray:
    """(h, 1 + stride) uint8 scanlines, each led by its filter type, to the
    (h, stride) bytes before filtering; ``bpp``: bytes a complete pixel
    (at least 1). The library's loop, or with ``impl="plain"`` numpy's."""
    _check_impl(impl)
    if bpp < 1:
        raise ValueError(f"bytes a pixel must be at least 1, got {bpp}")
    rows = np.ascontiguousarray(rows, np.uint8)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG scanline filter {kinds.max()}: not 0-4")
    h, stride = rows.shape[0], rows.shape[1] - 1
    if impl == "plain":
        return (_unfilter_rows(rows, bpp) if kinds.max(initial=0) <= 2
                else _unfilter_wavefront(rows, bpp))
    out = np.empty((h, stride), np.uint8)
    lib().mtt_png_unfilter(rows.reshape(-1), h, stride, bpp, out.reshape(-1))
    return out


def decode_png(data: bytes, name: str = "<bytes>", impl=None
               ) -> Tuple[np.ndarray, Dict]:
    """(samples, info): the samples as stored, (H, W, C) with C the colour
    type's channels (a palette's indices in one), uint16 at depth 16, one
    uint8 a sample below depth 8 (values 0 to 2**depth - 1); info holds
    the header's depth and colour type, the palette ((n, 3) uint8) and the
    tRNS chunk's bytes (None when absent)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name} is not a PNG")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    palette = trns = exif = None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: a {kind!r} chunk ends past the file")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{name}: an IHDR chunk of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"eXIf" and exif is None:   # the first, as libpng
            exif = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"{name}: PNG colour type {colour} at bit depth "
                         f"{depth}")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    if interlace > 1:
        raise ValueError(f"{name}: PNG interlace method {interlace}")
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: a {w}x{h} PNG: no pixels, or above the "
                         f"decoder's limit of 2^30 (cv2's)")
    ch = _CHANNELS[colour]
    bits = ch * depth
    bpp = max(1, bits // 8)
    need = sum((-(-(w - x0) // dx) * bits + 7) // 8 * -(-(h - y0) // dy)
               + -(-(h - y0) // dy) for x0, y0, dx, dy in
               (ADAM7 if interlace else ((0, 0, 1, 1),))
               if w > x0 and h > y0)
    try:      # no more than the image's bytes: a stream can expand 1032x
        raw = np.frombuffer(zlib.decompressobj().decompress(
            b"".join(idat), need), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data: {e}") from None
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:       # an empty pass has no scanlines
            continue
        stride = (pw * bits + 7) // 8
        if raw.size < at + ph * (stride + 1):
            raise ValueError(f"{name}: {raw.size} image bytes for {w}x{h}")
        rows = raw[at:at + ph * (stride + 1)].reshape(ph, stride + 1)
        at += ph * (stride + 1)
        samples[y0::dy, x0::dx] = _unpack(png_unfilter(rows, bpp, impl), pw,
                                          ch, depth)
    return samples, {"depth": depth, "colour": colour, "palette": palette,
                     "trns": trns, "exif": exif}


def _unpack(out: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (h, stride) to (h, w, ch) samples."""
    h = out.shape[0]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return out.reshape(h, w, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    px = (out[:, :, None] >> shifts) & ((1 << depth) - 1)
    return px.reshape(h, -1)[:, :w, None].astype(np.uint8)


def read_png(path: Union[str, Path, bytes], impl=None) -> np.ndarray:
    """The samples of a PNG as stored (``decode_png``), (H, W) for one
    channel: 8-bit grey, RGB and RGBA are the pixels ``cv2.imread`` gives in
    RGB(A) order."""
    data, name = _bytes(path)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name} is not a PNG: read_image takes JPEG too")
    s, _ = decode_png(data, name, impl)
    return s[..., 0] if s.shape[2] == 1 else s


def _scale8(s: np.ndarray, depth: int) -> np.ndarray:
    """Sub-byte grey to 8 bits, as libpng's expand and PIL's L;2 / L;4."""
    return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)


def _high(s: np.ndarray) -> np.ndarray:
    return (s >> 8).astype(np.uint8) if s.dtype == np.uint16 else s


def _png_mode(s: np.ndarray, info: Dict, mode: str) -> np.ndarray:
    colour, depth = info["colour"], info["depth"]
    pal, trns = info["palette"], info["trns"]
    if colour == 3:
        idx = s[..., 0]
        if mode == "pil":
            return idx
        rgb = np.zeros((256, 3), np.uint8)
        rgb[:len(pal)] = pal
        px = rgb[idx]
        if mode == "cv2_unchanged":
            bgr = px[..., ::-1]
            if trns:
                alpha = np.full(256, 255, np.uint8)
                alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
                bgr = np.concatenate([bgr, alpha[idx][..., None]], -1)
            return np.ascontiguousarray(bgr)
        return px
    if colour == 0:
        g = s[..., 0]
        if depth < 8:
            if mode == "pil" and depth == 1:     # PIL's "1": True is 255
                return np.where(g == 1, np.uint8(255), np.uint8(0)).view(
                    np.bool_)
            g = _scale8(g, depth)
        if mode in ("pil", "cv2_unchanged"):
            return g
        if mode == "pil_rgb":
            g = np.minimum(g, 255).astype(np.uint8)
        else:
            g = _high(g)
        return np.repeat(g[..., None], 3, -1)
    if mode == "cv2_unchanged":
        if colour == 4:           # grey + alpha -> BGRA
            s = s[..., [0, 0, 0, 1]]
        elif colour == 2 and trns:
            key = np.array(struct.unpack(">HHH", trns[:6]), s.dtype)
            top = np.iinfo(s.dtype).max
            alpha = np.where((s == key).all(-1), 0, top).astype(s.dtype)
            s = np.concatenate([s, alpha[..., None]], -1)
        order = [2, 1, 0, 3][:s.shape[2]]
        return np.ascontiguousarray(s[..., order])
    s8 = _high(s)
    if mode == "pil":
        if colour == 4 and depth == 16:   # PIL opens it as RGBA
            return np.ascontiguousarray(s8[..., [0, 0, 0, 1]])
        return s8
    if colour == 4:
        return np.repeat(s8[..., :1], 3, -1)
    return np.ascontiguousarray(s8[..., :3])


def read_image(path: Union[str, Path], mode: str) -> np.ndarray:
    """The array that the JAX package's reader ``mode`` (one of ``MODES``,
    see the module's docstring) gives for a JPEG, PNG, BMP, PNM or TIFF
    file (or its bytes)."""
    if mode not in MODES:
        raise ValueError(f"read_image mode {mode!r}: one of {MODES}")
    data, name = _bytes(path)
    if data.startswith(PNG_SIGNATURE):
        s, info = decode_png(data, name)
        img = _png_mode(s, info, mode)
        if mode == "cv2_color" and info["exif"] is not None:
            img = apply_orientation(img, _exif_orientation(info["exif"]))
        return img
    if data[:2] == b"BM":
        return image_formats.read_bmp(data, name, mode)
    if len(data) > 1 and data[0] == ord("P") and data[1] in b"123456":
        return image_formats.read_pnm(data, name, mode)
    if data[:4] in TIFF_SIGNATURES:
        return tiff.read_tiff(data, name, mode)
    if not data.startswith(JPEG_SIGNATURE):
        raise NotImplementedError(
            f"{name}: first bytes {data[:12]!r}: the port decodes JPEG, PNG, "
            f"BMP, PNM and TIFF ({ITEM})")
    img = _decode_jpeg(data, name)
    if img.ndim == 3 and img.shape[2] == 4:
        img = _cmyk_mode(img, mode)
    elif img.ndim == 2:
        if mode in ("pil", "cv2_unchanged"):
            return img
        img = np.repeat(img[..., None], 3, -1)
    if mode == "cv2_unchanged":
        return np.ascontiguousarray(img[..., ::-1])
    if mode == "cv2_color":
        return apply_orientation(img, jpeg_orientation(data))
    return img


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PIL's MULDIV255: a * b / 255 rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _cmyk_mode(cmyk: np.ndarray, mode: str) -> np.ndarray:
    """A 4-component JPEG's CMYK (libjpeg's JCS_CMYK output) as each reader
    gives it: PIL's ``CMYK;I`` raw mode (Adobe's inverted samples) in
    ``pil``, PIL's ``cmyk2rgb`` of that in ``pil_rgb``; cv2's
    ``icvCvt_CMYK2BGR_8u_C4C3R`` in RGB order in both cv2 modes (the caller
    turns it to BGR for ``cv2_unchanged``)."""
    if mode == "pil":
        return 255 - cmyk
    s = cmyk.astype(np.int32)
    if mode == "pil_rgb":
        nk = s[..., 3:]                  # 255 - PIL's inverted K
        out = np.clip(nk - _muldiv255(255 - s[..., :3], nk), 0, 255)
    else:
        k = s[..., 3:]
        out = k - (((255 - s[..., :3]) * k) >> 8)
    return out.astype(np.uint8)
