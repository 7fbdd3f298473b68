"""The port's decoders of the forms beyond baseline JPEG and plain PNG
(``mtt_tpu_torch/data/image_io.py``, ``image_formats.py``, ``tiff.py`` and
the C++ library ``data/csrc/image_decode.cpp``) against PIL and cv2 on the
CPU: a PNG's eXIf orientation, JPEG sampling factors 1-4 and 4-component
JPEG, Adam7 PNG, BMP, PNM and TIFF, each file written on the fly
(``tests/image_writers.py``, PIL, cv2) and read by all three.

Tolerances: none. In each of the four modes ``read_image`` gives the array
of the call it stands for (``pil``: ``np.array(Image.open(p))``,
``pil_rgb``: ``.convert("RGB")``, ``cv2_color``: ``cv2.imread`` in RGB
order, ``cv2_unchanged``: ``IMREAD_UNCHANGED``), dtype and shape included;
where that call refuses the file, ``read_image`` raises.
"""

import hashlib
import io
import json
import os
import struct
import warnings
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from image_writers import bmp, encode_jpeg, pnm, scene, tiff
from test_torch_image_io import ADAM7, _CH, _png, _scanlines
from torch_threads import torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "images")
MODES = ("pil", "pil_rgb", "cv2_color", "cv2_unchanged")


def _reference(path):
    """{mode: array, or None where the reader refuses the file}."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mode, read in (("pil", lambda: np.array(Image.open(path))),
                           ("pil_rgb", lambda: np.array(
                               Image.open(path).convert("RGB")))):
            try:
                out[mode] = read()
            except (OSError, ValueError, SyntaxError):
                out[mode] = None
    a = cv2.imread(str(path))
    out["cv2_color"] = None if a is None else cv2.cvtColor(
        a, cv2.COLOR_BGR2RGB)
    out["cv2_unchanged"] = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return out


def _check(tmp_path, data, suffix=".img", refused=()):
    """``read_image`` of ``data`` in each mode equals the reference's array
    (or raises where the reference refuses); ``refused``: modes where the
    port raises NotImplementedError for a form it leaves out."""
    from mtt_tpu_torch.data.image_io import read_image
    path = tmp_path / f"x{suffix}"
    path.write_bytes(data)
    want = _reference(path)
    for mode in MODES:
        if mode in refused:
            with pytest.raises(NotImplementedError, match="item 1.13"):
                read_image(path, mode)
            continue
        if want[mode] is None:
            with pytest.raises(ValueError):
                read_image(path, mode)
            continue
        got, w = read_image(path, mode), want[mode]
        assert got.dtype == w.dtype and got.shape == w.shape, \
            (mode, got.dtype, got.shape, w.dtype, w.shape)
        assert np.array_equal(got, w), (mode, int(np.abs(
            got.astype(np.int64) - w.astype(np.int64)).max()))
        # bit for bit: PIL's bool arrays store True as 255
        assert np.ascontiguousarray(got).tobytes() == \
            np.ascontiguousarray(w).tobytes(), mode
    return want


# --- step 0: EXIF orientation -----------------------------------------------

def _exif(orientation):
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, orientation):
    """``cv2_color`` turns a PNG by its eXIf chunk's orientation as
    ``cv2.imread`` does (a 6 x 10 image with orientation 6 reads 10 x 6);
    ``pil``, ``pil_rgb`` and ``cv2_unchanged`` leave it as stored."""
    b = io.BytesIO()
    Image.fromarray(scene(6, 10, orientation)).save(
        b, "PNG", exif=_exif(orientation))
    want = _check(tmp_path, b.getvalue(), ".png")
    assert want["cv2_color"].shape[:2] == ((10, 6) if orientation >= 5
                                           else (6, 10))


@pytest.mark.parametrize("where", ["after-idat", "two-chunks"])
def test_png_exif_chunk_position(tmp_path, where):
    """An eXIf chunk after the image data turns the image too, and of two
    the first counts, as in libpng."""
    body = [_exif(o)[6:] for o in ((6,) if where == "after-idat" else (3, 6))]
    data = _png(scene(6, 10, 1).astype(np.int64), 8, 2,
                chunks=[(b"eXIf", e) for e in body])
    if where == "after-idat":       # move the chunk behind IDAT
        i, j = data.index(b"eXIf") - 4, data.index(b"tEXt") - 4
        k = data.index(b"IEND") - 4
        data = data[:i] + data[j:k] + data[i:j] + data[k:]
    want = _check(tmp_path, data, ".png")
    assert want["cv2_color"].shape[:2] == ((10, 6) if where == "after-idat"
                                           else (6, 10))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    """A TIFF's Orientation tag 1-4 turns it in every mode (PIL's
    exif_transpose, libtiff's RGBA reader in cv2, in strips and tiles);
    5-8, which cv2 refuses, raise NotImplementedError in every mode."""
    s = scene(37, 53, orientation)
    for kw in ({}, {"tile": (16, 16)}):
        data = tiff(s, 8, 2, orientation=orientation, **kw)
        if orientation <= 4:
            _check(tmp_path, data, ".tif")
        else:
            _check(tmp_path, data, ".tif", refused=MODES)


# --- step 1-2: JPEG sampling factors and 4 components -----------------------

def _planes(n, h=37, w=53, seed=0):
    return [scene(h, w, seed + c)[..., c % 3] for c in range(n)]


SAMPLING = [((4, 1), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)),
            ((4, 2), (2, 1), (2, 1)), ((2, 4), (1, 2), (1, 2)),
            ((4, 4), (1, 1), (1, 1)), ((1, 1), (4, 4), (1, 1)),
            ((3, 1), (1, 1), (1, 1)), ((3, 2), (1, 1), (1, 1)),
            ((2, 2), (1, 2), (2, 1)), ((2, 3), (1, 1), (2, 3)),
            ((4, 3), (2, 3), (1, 1)), ((4, 1), (2, 1), (4, 1))]


@pytest.mark.parametrize("factors", SAMPLING,
                         ids=["-".join(f"{h}x{v}" for h, v in f)
                              for f in SAMPLING])
def test_jpeg_sampling_factors(tmp_path, factors):
    """Sampling factors 1-4 on each axis: the fancy filters at the 2:1
    ratios, replication at 3:1, 4:1, 2x3 and others, an MCU of at most 10
    blocks interleaved (one scan a component above that), at 53 x 37 and
    at 17 x 9."""
    inter = sum(h * v for h, v in factors) <= 10
    for h, w in ((37, 53), (9, 17)):
        _check(tmp_path, encode_jpeg(_planes(3, h, w), factors,
                                     interleaved=inter), ".jpg")


@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_411_cv2(tmp_path, quality):
    """cv2's own 4:1:1 (Y 4x1) JPEG at 53 x 37."""
    ok, enc = cv2.imencode(".jpg", scene(37, 53, quality), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    _check(tmp_path, enc.tobytes(), ".jpg")


def test_jpeg_fractional_ratio_raises(tmp_path):
    """Y 3x1 beside Cb 2x1 is no integral ratio: libjpeg, and so PIL and
    cv2, refuse it, and the port raises ValueError in every mode."""
    data = encode_jpeg(_planes(3), [(3, 1), (2, 1), (1, 1)])
    _check(tmp_path, data, ".jpg")
    from mtt_tpu_torch.data.image_io import read_jpeg
    with pytest.raises(ValueError, match="integral"):
        read_jpeg(data)


def _pil_cmyk(**kw):
    b = io.BytesIO()
    Image.fromarray(scene(37, 53, 4)).convert("CMYK").save(b, "JPEG", **kw)
    return b.getvalue()


def _adobe_transform(data, value):
    """The bytes with the APP14 Adobe marker's transform byte set."""
    d = bytearray(data)
    d[data.index(b"\xff\xee") + 15] = value
    return bytes(d)


CMYK = {
    "pil-cmyk": lambda: _pil_cmyk(quality=90),
    "pil-cmyk-progressive": lambda: _pil_cmyk(quality=80, progressive=True),
    "ycck": lambda: _adobe_transform(_pil_cmyk(quality=90), 2),
    "ycck-subsampled": lambda: encode_jpeg(
        _planes(4), [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2,
        ids=[67, 77, 89, 75]),
    "adobe-transform-1": lambda: encode_jpeg(
        _planes(4), [(2, 1), (1, 1), (1, 1), (2, 1)], adobe=1),
    "cmyk-no-adobe": lambda: encode_jpeg(
        _planes(4), [(1, 2), (1, 1), (1, 1), (1, 1)]),
}


@pytest.mark.parametrize("form", list(CMYK))
def test_jpeg_four_components(tmp_path, form):
    """4-component JPEG: Adobe CMYK (transform 0, stored inverted), YCCK
    (transform 2, and 1, which libjpeg reads as YCCK), straight CMYK (no
    Adobe marker), at 4:4:4:4 and subsampled: PIL's inverted CMYK and its
    cmyk2rgb, cv2's CMYK-to-BGR in both cv2 modes (three channels)."""
    want = _check(tmp_path, CMYK[form](), ".jpg")
    assert want["pil"].shape == (37, 53, 4)
    assert want["cv2_unchanged"].shape == (37, 53, 3)


# --- step 3: Adam7 PNG -------------------------------------------------------

ADAM7_CASES = [(c, d, None) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                          (3, (1, 2, 4, 8)), (4, (8, 16)),
                                          (6, (8, 16))) for d in ds] + [
    (3, 8, "trns"), (2, 8, "trns"), (0, 16, "trns")]


@pytest.mark.parametrize("colour,depth,trns", ADAM7_CASES,
                         ids=[f"c{c}-d{d}" + ("-trns" if t else "")
                              for c, d, t in ADAM7_CASES])
def test_png_adam7(tmp_path, colour, depth, trns):
    """Adam7 PNGs of each colour type and bit depth (and with tRNS), each
    pass filtered with all five filters, at 13 x 7 and at 2 x 3 and 1 x 1
    (most passes empty); ``read_png`` gives the samples as stored."""
    from mtt_tpu_torch.data.image_io import read_png
    rng = np.random.default_rng(depth * 7 + colour)
    for h, w in ((7, 13), (3, 2), (1, 1)):
        palette = None
        if colour == 3:
            n = min(256, 1 << depth)
            palette = rng.integers(0, 256, (n, 3))
            samples = rng.integers(0, n, (h, w, 1))
        else:
            samples = rng.integers(0, 1 << depth, (h, w, _CH[colour]))
        t = None
        if trns:
            t = (bytes(rng.integers(0, 256, 3).tolist()) if colour == 3 else
                 struct.pack(">HHH", *samples[0, 0]) if colour == 2 else
                 struct.pack(">H", samples[0, 0, 0]))
        data = _png(samples, depth, colour, palette, t,
                    filters=(0, 1, 2, 3, 4), interlace=1)
        _check(tmp_path, data, ".png")
        stored = read_png(data)
        assert np.array_equal(stored, samples[..., 0] if samples.shape[2] == 1
                              else samples)


# --- step 4: BMP -------------------------------------------------------------

def _palette(kind, bits, rng):
    n = 1 << bits
    if kind == "colour":
        return rng.integers(0, 256, (n, 3))
    if kind == "grey":
        return np.repeat(rng.integers(0, 256, (n, 1)), 3, -1)
    if kind == "ramp":                     # 0, 1, ...: PIL's "L"
        return np.repeat(np.arange(n)[:, None], 3, -1)
    if kind == "black-white":              # PIL's "1"
        return np.array([[0, 0, 0], [255, 255, 255]])
    return rng.integers(0, 256, (max(2, n // 2 - 1), 3))   # short


BMP_PALETTED = [(bits, kind) for bits in (1, 4, 8)
                for kind in ("colour", "grey", "short", "black-white")] + [
    (8, "ramp"), (1, "ramp")]


@pytest.mark.parametrize("bits,kind", BMP_PALETTED,
                         ids=[f"{b}bit-{k}" for b, k in BMP_PALETTED])
def test_bmp_palette(tmp_path, bits, kind):
    """1-, 4- and 8-bit BMPs with a colour, a grey, a short (fewer entries
    than the depth allows), a black-and-white and a 0, 1, ... palette:
    PIL's P, L or 1 mode, cv2's grey read of a grey palette; rows
    bottom-up and top-down, headers of 40, 108 and 124 bytes."""
    rng = np.random.default_rng(bits * 10 + len(kind))
    pal = _palette(kind, bits, rng)
    for i, (h, w) in enumerate(((37, 53), (2, 33), (1, 1))):
        idx = rng.integers(0, len(pal), (h, w))
        data = bmp(idx, bits, pal, header=(40, 108, 124)[i],
                   top_down=i == 1)
        _check(tmp_path, data, ".bmp")


BMP_DIRECT = [("24", None, 40), ("24", None, 124), ("32", None, 40),
              ("32", None, 108),
              ("32", (0xFF0000, 0xFF00, 0xFF), 40),
              ("32", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 56),
              ("32", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 108),
              ("32", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
              ("32", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 124),
              ("32", (0xFF0000, 0xFF00, 0xFF, 0), 124),
              ("32", (0xFF000000, 0xFF0000, 0xFF00, 0), 124),
              ("32", (0xFF00, 0xFF0000, 0xFF000000, 0xFF), 124),
              ("32", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 52)]


def _masks_id(bits, masks, header):
    m = "rgb" if masks is None else "-".join(f"{x:x}" for x in masks)
    return f"{bits}-{m}-h{header}"


@pytest.mark.parametrize("bits,masks,header", BMP_DIRECT,
                         ids=[_masks_id(*c) for c in BMP_DIRECT])
def test_bmp_direct(tmp_path, bits, masks, header):
    """24-bit, 32-bit BI_RGB (the fourth byte unused) and 32-bit
    BI_BITFIELDS with byte masks: PIL's masks it knows (refusing the
    others), cv2's raw B, G, R, A bytes below a 56-byte header and its
    masks from there (no alpha mask: 255); bottom-up and top-down."""
    rng = np.random.default_rng(header)
    n = 3 if bits == "24" else 4
    for top_down, (h, w) in ((False, (37, 53)), (True, (3, 5))):
        px = rng.integers(0, 256, (h, w, n))
        _check(tmp_path, bmp(px, int(bits), header=header, top_down=top_down,
                             bitfields=masks), ".bmp")


# --- step 5: PNM -------------------------------------------------------------

PNM_CASES = [(1, 1), (4, 1)] + [(k, m) for k in (2, 3, 5, 6)
                                for m in (1, 100, 255, 1000, 65535)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES,
                         ids=[f"P{k}-max{m}" for k, m in PNM_CASES])
def test_pnm(tmp_path, kind, maxval):
    """P1-P6, plain and raw, maxval 1 to 65535, with and without comments:
    PIL's scaling to 8 bits (16 bits, mode I, for grey above 255), cv2's
    plain samples through its table and raw ones as stored."""
    rng = np.random.default_rng(kind * 7 + maxval)
    ch = (3,) if kind in (3, 6) else ()
    for (h, w), comments in (((37, 53), False), ((5, 7), True)):
        s = rng.integers(0, maxval + 1, (h, w) + ch)
        _check(tmp_path, pnm(kind, s, maxval, comments), ".pnm")


# --- step 6: TIFF ------------------------------------------------------------

# (photometric, bits, samples, extra samples)
TIFF_KINDS = {"grey8": (1, 8, 1, ()), "white8": (0, 8, 1, ()),
              "grey1": (1, 1, 1, ()), "white1": (0, 1, 1, ()),
              "grey4": (1, 4, 1, ()), "grey16": (1, 16, 1, ()),
              "rgb8": (2, 8, 3, ()), "rgba8": (2, 8, 4, (2,)),
              "rgba8-assoc": (2, 8, 4, (1,)), "rgbx8": (2, 8, 4, (0,)),
              "rgba8-untagged": (2, 8, 4, ()), "rgb16": (2, 16, 3, ()),
              "rgba16": (2, 16, 4, (2,)), "palette8": (3, 8, 1, ()),
              "palette4": (3, 4, 1, ()), "palette1": (3, 1, 1, ()),
              "grey-alpha8": (1, 8, 2, (2,))}
# (compression, predictor, planar, tile, rows a strip, big-endian)
TIFF_LAYOUTS = {"none": (1, 1, 1, None, None, False),
                "lzw-pred-strips": (5, 2, 1, None, 5, False),
                "deflate-mm": (8, 1, 1, None, None, True),
                "adobe-deflate-tiles-pred": (32946, 2, 1, (16, 32), None,
                                             False),
                "packbits-tiles-mm": (32773, 1, 1, (32, 16), None, True),
                "lzw-planar": (5, 2, 2, None, 7, False),
                "deflate-planar-tiles-mm": (8, 1, 2, (16, 16), None, True),
                "none-planar": (1, 1, 2, None, 11, True)}
TIFF_CASES = [(k, lay) for k in TIFF_KINDS for lay in TIFF_LAYOUTS
              if TIFF_KINDS[k][2] > 1 or TIFF_LAYOUTS[lay][2] == 1]


def _tiff_refused(kind, layout):
    """The modes where the port leaves a case out (see data/tiff.py)."""
    photo, bps, spp, extra = TIFF_KINDS[kind]
    comp, _, planar, tile, _, _ = TIFF_LAYOUTS[layout]
    if planar == 2 and kind == "grey-alpha8":
        return MODES
    out = ()
    if planar == 2 and (extra == (0,) or comp == 1 and (
            bps == 16 or extra == (1,))):
        out += ("pil", "pil_rgb")
    if planar == 2 and bps == 16:
        out += ("cv2_unchanged",)
    if tile and 53 % tile[0] and photo == 1 and (bps == 16 or spp == 2):
        out += ("cv2_color",) if bps == 16 else ("cv2_color",
                                                 "cv2_unchanged")
    return out


@pytest.mark.parametrize("kind,layout", TIFF_CASES,
                         ids=[f"{k}-{lay}" for k, lay in TIFF_CASES])
def test_tiff(tmp_path, kind, layout):
    """TIFF at 53 x 37: each photometric interpretation, depth and extra
    sample the port reads, in strips and tiles, interleaved and planar, in
    both byte orders, uncompressed, LZW, Deflate and PackBits, with the
    horizontal predictor: PIL's modes, libtiff's RGBA reader in cv2's 8-bit
    modes, the samples as stored in cv2's 16-bit one."""
    photo, bps, spp, extra = TIFF_KINDS[kind]
    comp, pred, planar, tile, rps, big = TIFF_LAYOUTS[layout]
    if bps < 8:
        pred = 1
    rng = np.random.default_rng(len(kind) * 31 + len(layout))
    s = rng.integers(0, 1 << bps, (37, 53, spp)).astype(
        np.uint16 if bps == 16 else np.uint8)
    if extra == (1,):          # associated alpha: colour at most alpha
        a = s[..., 3:].astype(np.int64)
        s[..., :3] = s[..., :3] * a // ((1 << bps) - 1)
    cmap = rng.integers(0, 256, (1 << bps, 3)) * 257 if photo == 3 else None
    data = tiff(s, bps, photo, big=big, comp=comp, predictor=pred,
                planar=planar, tile=tile, rps=rps, extra=extra, cmap=cmap)
    _check(tmp_path, data, ".tif", refused=_tiff_refused(kind, layout))


WRITTEN_BY = [(m, c) for m in ("1", "L", "P", "RGB", "RGBA", "LA", "I;16")
              for c in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits")]


@pytest.mark.parametrize("mode,compression", WRITTEN_BY,
                         ids=[f"{m}-{c}" for m, c in WRITTEN_BY])
def test_tiff_written_by_pil(tmp_path, mode, compression):
    """TIFFs that PIL writes (through libtiff when compressed)."""
    img = scene(37, 53, 5)
    im = Image.fromarray(img[..., 0].astype(np.uint16) * 257) \
        if mode == "I;16" else Image.fromarray(img).convert(mode)
    b = io.BytesIO()
    im.save(b, "TIFF", compression=compression)
    _check(tmp_path, b.getvalue(), ".tif")


@pytest.mark.parametrize("channels,depth", [(1, 8), (3, 8), (4, 8), (1, 16),
                                            (3, 16), (4, 16)])
def test_tiff_written_by_cv2(tmp_path, channels, depth):
    """TIFFs that cv2 writes (LZW with its predictor, and Deflate; four
    channels without an ExtraSamples tag)."""
    img = scene(37, 53, 6, channels)
    if depth == 16:
        img = img.astype(np.uint16) * 257 + 3
    for comp in (5, 8):
        ok, enc = cv2.imencode(".tif", img if channels == 1 else
                               np.ascontiguousarray(img), [
                                   cv2.IMWRITE_TIFF_COMPRESSION, comp])
        assert ok
        _check(tmp_path, enc.tobytes(), ".tif")


# --- robustness --------------------------------------------------------------

def _lzw_bad_code():
    """An LZW strip whose second code (300) is past the table."""
    data = bytearray(tiff(scene(8, 8, 1), 8, 2, comp=5))
    at = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, at)[0]
    for i in range(n):
        tag, _, _, off = struct.unpack_from("<HHII", data, at + 2 + 12 * i)
        if tag == 273:
            data[off:off + 3] = bytes([0x80, 0x4B, 0x00])   # 256, 300
    return bytes(data)


def _tiff_huge():
    data = bytearray(tiff(scene(4, 4, 1), 8, 2))
    at = struct.unpack_from("<I", data, 4)[0]
    struct.pack_into("<I", data, at + 2 + 8, 1 << 20)        # width
    struct.pack_into("<I", data, at + 2 + 12 + 8, 1 << 20)   # height
    return bytes(data)


def _strip_offset(data):
    """The second strip's offset moved past the end of the file."""
    d = bytearray(data)
    at = struct.unpack_from("<I", d, 4)[0]
    n = struct.unpack_from("<H", d, at)[0]
    for i in range(n):
        tag, _, count, off = struct.unpack_from("<HHII", d, at + 2 + 12 * i)
        if tag == 273:
            struct.pack_into("<I", d, off + 4, len(d) + 100)
    return bytes(d)


def _adam7_short():
    """An Adam7 PNG whose image data holds half its passes' bytes."""
    s = np.zeros((9, 9, 1), np.int64)
    raw = b"".join(_scanlines(s[y0::dy, x0::dx], 8, (0,))
                   for x0, y0, dx, dy in ADAM7)
    data = _png(s, 8, 0, interlace=1)
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    body = zlib.compress(raw[:len(raw) // 2])
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body)))
    return data[:i] + chunk + data[i + 12 + n:]


def _bmp_palette_index():
    pal = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    idx = np.zeros((4, 4), np.int64)
    idx[2, 1] = 7                         # past the 3 entries
    return bmp(idx, 8, pal)


CORRUPT = {
    "bmp-truncated": (lambda: bmp(scene(9, 7, 1), 24)[:-10], "truncated"),
    "bmp-palette-index": (_bmp_palette_index, "palette index"),
    "bmp-huge": (lambda: bytes(bytearray(bmp(scene(2, 2, 1), 24))[:18]
                               + struct.pack("<ii", 40000, 40000)
                               + bmp(scene(2, 2, 1), 24)[26:]), "2\\^30"),
    "pnm-truncated": (lambda: pnm(6, scene(9, 7, 1), 255)[:-5], "truncated"),
    "pnm-plain-above-maxval": (lambda: b"P2\n2 1\n15\n3 16\n", "above"),
    "pnm-huge": (lambda: b"P5\n40000 40000\n255\n\x00", "2\\^30"),
    "tiff-lzw-code": (_lzw_bad_code, "LZW code"),
    "tiff-strip-past-end": (lambda: _strip_offset(
        tiff(scene(8, 8, 1), 8, 2, rps=4)), "past the end"),
    "tiff-truncated-deflate": (lambda: tiff(scene(8, 8, 1), 8, 2, comp=8)[
        :40], "past the end|Deflate"),
    "tiff-huge": (_tiff_huge, "2\\^30"),
    "png-adam7-short": (lambda: _adam7_short(), "image bytes"),
}


@pytest.mark.parametrize("form", list(CORRUPT))
def test_corrupt_files_raise(tmp_path, form):
    """A truncated or corrupt BMP, PNM, TIFF or Adam7 PNG, a palette index
    past the palette, an LZW code past the table, a strip past the end and
    a frame above 2^30 pixels raise ValueError in every mode, before
    reading or writing out of bounds (nothing is allocated for the frame
    first)."""
    from mtt_tpu_torch.data.image_io import read_image
    make, match = CORRUPT[form]
    path = tmp_path / "x.img"
    path.write_bytes(make())
    for mode in MODES:
        with pytest.raises(ValueError, match=match):
            read_image(path, mode)


# --- the committed fixtures --------------------------------------------------

def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixtures_match_pixels_json():
    """Every committed fixture of ``tests/data/images`` decodes in every
    mode to the shape, dtype and SHA-256 that ``pixels.json`` records
    (written by ``tools/make_image_fixtures.py`` from PIL and cv2), and PIL
    and cv2 here agree with it; a mode the reader refuses is recorded as
    null and raises."""
    from mtt_tpu_torch.data.image_io import read_image
    with open(os.path.join(FIXTURES, "pixels.json")) as f:
        table = json.load(f)
    assert len(table) >= 12
    total = 0
    for name, entry in sorted(table.items()):
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        want = _reference(path)
        for mode in MODES:
            rec = entry["modes"][mode]
            if rec is None:
                assert want[mode] is None, (name, mode)
                with pytest.raises(ValueError):
                    read_image(path, mode)
                continue
            got = read_image(path, mode)
            assert [list(got.shape), str(got.dtype), _sha(got)] == \
                [rec["shape"], rec["dtype"], rec["sha256"]], (name, mode)
            assert _sha(want[mode]) == rec["sha256"], (name, mode)
    assert total < 400_000
