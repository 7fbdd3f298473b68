"""The port's image decoders (``mtt_tpu_torch/data/image_io.py``, the C++
library ``data/csrc/image_decode.cpp`` built with g++) against PIL and cv2
on the CPU.

Tolerances: none. ``read_jpeg`` equals both PIL's and cv2's pixels (max
difference 0) on every case; each ``read_image`` mode equals the PIL or cv2
call it stands for, to the bit, dtype and shape included; the library's PNG
unfiltering equals the numpy version's bytes.
"""

import hashlib
import io
import json
import os
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, ImageFile

from torch_threads import torch_threads  # noqa: F401

ImageFile.MAXBLOCK = 1 << 24       # PIL's optimised encodes of small images
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")


def _scene(h, w, seed):
    """A seeded photo-like RGB image: smooth fields, hard-edged shapes,
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / 13.0 + c) * np.cos(yy / 9.0 - c)
                    for c in range(3)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 40)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(
        np.uint8)


def _pil_jpeg(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _cv2_jpeg(img, quality=75, sampling=None, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, enc = cv2.imencode(".jpg", img if img.ndim == 2 else img[..., ::-1],
                           params)
    assert ok
    return enc.tobytes()


def _want(data):
    """(PIL's pixels, cv2's pixels in RGB order) of JPEG bytes."""
    pil = np.array(Image.open(io.BytesIO(data)))
    dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return pil, dec if dec.ndim == 2 else dec[..., ::-1]


_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
_SIZES = {"1x1": (1, 1), "15x17": (15, 17), "375x500": (375, 500),
          "333x500": (333, 500)}

JPEG_CASES = (
    [(f"cv2-{s}-{n}", "cv2", dict(size=n, sampling=s))
     for s in _SAMPLING for n in _SIZES]
    + [(f"pil-q{q}", "pil", dict(size="375x500", quality=q, subsampling=2))
       for q in (30, 75, 95, 100)]
    + [(f"restart-{r}-{s}", "cv2", dict(size="333x500", sampling=s,
                                        restart=r))
       for r, s in ((1, "420"), (2, "444"), (7, "422"), (3, "440"))]
    + [(f"grey-{n}", "grey", dict(size=n)) for n in ("15x17", "375x500")]
    + [(f"progressive-{sub}", "pil", dict(size="333x500", quality=85,
                                          subsampling=sub, progressive=True))
       for sub in (0, 1, 2)]
    + [("progressive-grey", "grey", dict(size="375x500", progressive=True)),
       ("progressive-1x1", "pil", dict(size="1x1", quality=90,
                                       subsampling=2, progressive=True)),
       ("optimised", "pil", dict(size="375x500", quality=90, subsampling=1,
                                 optimize=True)),
       ("optimised-progressive", "pil", dict(size="15x17", quality=50,
                                             subsampling=2, progressive=True,
                                             optimize=True))])


def _encode(kind, spec, seed):
    h, w = _SIZES[spec["size"]]
    img = _scene(h, w, seed)
    if kind == "cv2":
        return _cv2_jpeg(img, sampling=_SAMPLING[spec["sampling"]],
                         restart=spec.get("restart", 0))
    if kind == "grey":
        return _pil_jpeg(img[..., 1], quality=80,
                         progressive=spec.get("progressive", False))
    kw = {k: v for k, v in spec.items() if k != "size"}
    return _pil_jpeg(img, **kw)


@pytest.mark.parametrize("name,kind,spec", JPEG_CASES,
                         ids=[c[0] for c in JPEG_CASES])
def test_read_jpeg_matches_pil_and_cv2(name, kind, spec):
    """``read_jpeg`` gives PIL's and cv2's pixels with max difference 0:
    each sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0) at each size, qualities 30
    to 100, restart intervals, grey, progressive (spectral selection and
    successive approximation, EOB runs), optimised Huffman tables."""
    from mtt_tpu_torch.data.image_io import read_jpeg
    data = _encode(kind, spec, seed=len(name))
    pil, ocv = _want(data)
    assert np.array_equal(pil, ocv), "PIL and cv2 disagree"
    got = read_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == pil.shape
    assert np.array_equal(got, pil), int(np.abs(got.astype(int) - pil).max())


def _exif(orientation):
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_read_image_jpeg_exif_orientation(tmp_path, orientation):
    """``cv2_color`` turns a JPEG by its EXIF orientation as ``cv2.imread``
    does; ``pil``, ``pil_rgb`` and ``cv2_unchanged`` leave it as stored, as
    PIL and ``IMREAD_UNCHANGED`` do."""
    from mtt_tpu_torch.data.image_io import read_image
    path = tmp_path / "x.jpg"
    path.write_bytes(_pil_jpeg(_scene(20, 40, orientation), quality=90,
                               exif=_exif(orientation)))
    want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    got = read_image(path, "cv2_color")
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape[:2] == ((40, 20) if orientation >= 5 else (20, 40))
    assert np.array_equal(read_image(path, "pil"), np.array(Image.open(path)))
    assert np.array_equal(read_image(path, "pil_rgb"),
                          np.array(Image.open(path).convert("RGB")))
    assert np.array_equal(read_image(path, "cv2_unchanged"),
                          cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def _scanlines(samples, depth, filters):
    """The filtered scanlines of (H, W, C) samples as stored, each
    scanline y filtered with filters[y % len(filters)] (PNG spec, sections
    7 and 9)."""
    h, w, c = samples.shape
    lines = []
    for y in range(h):
        s = samples[y].reshape(-1).astype(np.int64)
        if depth == 16:
            b = np.stack([s >> 8, s & 255], -1).reshape(-1)
        elif depth == 8:
            b = s
        else:
            per = 8 // depth
            padded = np.zeros(-(-len(s) // per) * per, np.int64)
            padded[:len(s)] = s
            padded = padded.reshape(-1, per)
            b = sum(padded[:, i] << (8 - depth * (i + 1)) for i in range(per))
        lines.append(b)
    bpp = max(1, c * depth // 8)
    raw, prev = bytearray(), np.zeros(len(lines[0]), np.int64)
    for y, x in enumerate(lines):
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
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
            p = a + prev - ul
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prev, ul))
        raw += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prev = x
    return bytes(raw)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png(samples, depth, colour, palette=None, trns=None, filters=(0,),
         interlace=0, chunks=()):
    """PNG bytes of (H, W, C) samples as stored, each scanline y filtered
    with filters[y % len(filters)] (PNG spec, sections 7 and 9), with a
    tEXt chunk the readers skip and ``chunks`` ((type, body) pairs) before
    the image data. ``interlace=1``: Adam7, each of its seven passes (the
    empty ones left out) filtered on its own."""
    h, w, c = samples.shape
    if interlace:
        raw = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, filters)
                       for x0, y0, dx, dy in ADAM7
                       if w > x0 and h > y0)
    else:
        raw = _scanlines(samples, depth, filters)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += b"".join(chunk(k, b) for k, b in chunks)
    return (out + chunk(b"tEXt", b"Comment\x00fixture")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_CASES = [(c, d, None) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                        (3, (1, 2, 4, 8)), (4, (8, 16)),
                                        (6, (8, 16))) for d in ds] + [
    (3, 2, "trns"), (2, 8, "trns"), (0, 8, "trns"), (0, 16, "trns")]


def _png_case(colour, depth, trns, seed):
    rng = np.random.default_rng(seed)
    h, w = 7, 13
    palette = None
    if colour == 3:
        n = min(256, 1 << depth)
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (h, w, 1))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, _CH[colour]))
    t = None
    if trns:
        if colour == 3:
            t = bytes(rng.integers(0, 256, 3).tolist())
        elif colour == 2:
            t = struct.pack(">HHH", *samples[0, 0])   # one pixel keyed out
        else:
            t = struct.pack(">H", samples[0, 0, 0])
    return samples, _png(samples, depth, colour, palette, t,
                         filters=(0, 1, 2, 3, 4))


@pytest.mark.parametrize("colour,depth,trns", PNG_CASES,
                         ids=[f"c{c}-d{d}" + ("-trns" if t else "")
                              for c, d, t in PNG_CASES])
def test_read_image_png_modes(tmp_path, colour, depth, trns):
    """Each ``read_image`` mode against the call it stands for, on a PNG of
    each colour type and bit depth (and with tRNS), its scanlines in all
    five filters: ``pil`` = ``np.array(Image.open(p))``, ``pil_rgb`` =
    ``.convert("RGB")``, ``cv2_color`` = ``cv2.imread`` in RGB order,
    ``cv2_unchanged`` = ``IMREAD_UNCHANGED``; ``read_png`` gives the samples
    as stored."""
    from mtt_tpu_torch.data.image_io import read_image, read_png
    samples, data = _png_case(colour, depth, trns, seed=depth + colour)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    stored = read_png(path)
    assert np.array_equal(stored, samples[..., 0] if samples.shape[2] == 1
                          else samples)
    assert stored.dtype == (np.uint16 if depth == 16 else np.uint8)
    want = {"pil": np.array(Image.open(path)),
            "pil_rgb": np.array(Image.open(path).convert("RGB")),
            "cv2_color": cv2.cvtColor(cv2.imread(str(path)),
                                      cv2.COLOR_BGR2RGB),
            "cv2_unchanged": cv2.imread(str(path), cv2.IMREAD_UNCHANGED)}
    for mode, w in want.items():
        got = read_image(path, mode)
        assert got.dtype == w.dtype and got.shape == w.shape, \
            (mode, got.dtype, got.shape, w.dtype, w.shape)
        assert np.array_equal(got, w), mode


@pytest.mark.parametrize("kind", ["grey", "rgb"])
def test_read_image_jpeg_modes(tmp_path, kind):
    """The four modes on a grey and a colour JPEG (no EXIF): PIL's grey
    stays (H, W) in ``pil``, cv2's in ``cv2_unchanged``; colour is BGR in
    ``cv2_unchanged``."""
    from mtt_tpu_torch.data.image_io import read_image
    img = _scene(30, 50, 9)
    path = tmp_path / "x.jpg"
    path.write_bytes(_pil_jpeg(img[..., 0] if kind == "grey" else img,
                               quality=85))
    want = {"pil": np.array(Image.open(path)),
            "pil_rgb": np.array(Image.open(path).convert("RGB")),
            "cv2_color": cv2.cvtColor(cv2.imread(str(path)),
                                      cv2.COLOR_BGR2RGB),
            "cv2_unchanged": cv2.imread(str(path), cv2.IMREAD_UNCHANGED)}
    for mode, w in want.items():
        got = read_image(path, mode)
        assert got.shape == w.shape and np.array_equal(got, w), mode


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    """The library's scanline unfiltering equals the numpy version's bytes
    on random scanlines with random filter types 0-4 (and on rows of
    filters 0-2 only, the numpy version's row-at-a-time path)."""
    from mtt_tpu_torch.data.image_io import png_unfilter
    rng = np.random.default_rng(bpp)
    for kinds in (5, 3):
        rows = rng.integers(0, 256, (23, 1 + 17 * bpp)).astype(np.uint8)
        rows[:, 0] = rng.integers(0, kinds, 23)
        got = png_unfilter(rows, bpp)
        want = png_unfilter(rows, bpp, impl="plain")
        assert got.dtype == np.uint8 and np.array_equal(got, want), kinds
    rows[3, 0] = 5
    for impl in (None, "plain"):
        with pytest.raises(ValueError, match="filter 5"):
            png_unfilter(rows, bpp, impl=impl)


def _arith_sof(data):
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc9" + data[i + 2:]


def _twelve_bit(data):
    i = data.index(b"\xff\xc0") + 4
    return data[:i] + b"\x0c" + data[i + 1:]


def _lossless(data):
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc3" + data[i + 2:]


def _cmyk():
    b = io.BytesIO()
    Image.fromarray(_scene(16, 16, 1)).convert("CMYK").save(b, "JPEG")
    return b.getvalue()


def _gif():
    b = io.BytesIO()
    Image.fromarray(_scene(16, 16, 1)).save(b, "GIF")
    return b.getvalue()


def _jpeg_in_tiff():
    b = io.BytesIO()
    Image.fromarray(_scene(16, 16, 1)).save(b, "TIFF", compression="jpeg")
    return b.getvalue()


def _bmp_rle8():
    """An 8-bit BMP whose header says RLE8 (compression 1)."""
    data = bytearray(cv2.imencode(".bmp", _scene(4, 4, 1)[..., 0])[1])
    data[30] = 1
    return bytes(data)


UNSUPPORTED = {
    "arithmetic": lambda: _arith_sof(_pil_jpeg(_scene(16, 16, 1))),
    "lossless": lambda: _lossless(_pil_jpeg(_scene(16, 16, 1))),
    "12-bit": lambda: _twelve_bit(_pil_jpeg(_scene(16, 16, 1))),
    "webp": lambda: cv2.imencode(".webp", _scene(16, 16, 1))[1].tobytes(),
    "gif": _gif,
    "jpeg-in-tiff": _jpeg_in_tiff,
    "bmp-rle8": _bmp_rle8,
}


@pytest.mark.parametrize("form", list(UNSUPPORTED))
def test_unsupported_forms_raise(tmp_path, form):
    """Arithmetic-coded, lossless and 12-bit JPEG, WebP, GIF, JPEG-in-TIFF
    and RLE8 BMP raise NotImplementedError naming ROADMAP item 1.13, in
    every mode; PIL reads the WebP, GIF and JPEG-in-TIFF files and takes
    the BMP's header for RLE8."""
    from mtt_tpu_torch.data.image_io import MODES, read_image
    data = UNSUPPORTED[form]()
    path = tmp_path / "x.img"
    path.write_bytes(data)
    if form == "bmp-rle8":
        assert Image.open(path).info["compression"] == 1
    elif form not in ("arithmetic", "lossless", "12-bit"):
        Image.open(path).load()
    for mode in MODES:
        with pytest.raises(NotImplementedError, match="item 1.13"):
            read_image(path, mode)


FORMERLY_REFUSED = {
    "cmyk": _cmyk,
    "sampling-4x1": lambda: _cv2_jpeg(
        _scene(16, 32, 1), sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    "adam7": lambda: _png(np.arange(16).reshape(4, 4, 1) * 16, 8, 0,
                          interlace=1),
    "bmp": lambda: cv2.imencode(".bmp", _scene(4, 4, 1))[1].tobytes(),
}


@pytest.mark.parametrize("form", list(FORMERLY_REFUSED))
def test_formerly_refused_forms_match(tmp_path, form):
    """A CMYK JPEG, a 4:1:1 JPEG, an Adam7 PNG and a BMP, which the port
    refused before, decode in each mode to the array of the call it stands
    for, dtype and shape included."""
    from mtt_tpu_torch.data.image_io import read_image
    path = tmp_path / "x.img"
    path.write_bytes(FORMERLY_REFUSED[form]())
    want = {"pil": np.array(Image.open(path)),
            "pil_rgb": np.array(Image.open(path).convert("RGB")),
            "cv2_color": cv2.cvtColor(cv2.imread(str(path)),
                                      cv2.COLOR_BGR2RGB),
            "cv2_unchanged": cv2.imread(str(path), cv2.IMREAD_UNCHANGED)}
    for mode, w in want.items():
        got = read_image(path, mode)
        assert got.dtype == w.dtype and got.shape == w.shape, mode
        assert np.array_equal(got, w), mode


def _dht(data, table):
    """(offset of a DHT table's counts, its symbol count) in a libjpeg
    baseline file, which writes one table a segment; ``table`` is the
    class-and-id byte: 0x00 DC table 0, 0x10 AC table 0."""
    i = data.index(b"\xff\xc4")
    while data[i + 4] != table:
        i = data.index(b"\xff\xc4", i + 2)
    return i + 5, sum(data[i + 5:i + 21])


def _oversubscribed_dht(data, table):
    """A table with all its codes at length 1, where at most one fits:
    filled as given, its 512-entry lookup would be written up to 81 times
    its size (AC table 0's 162 codes)."""
    at, total = _dht(data, table)
    counts = bytearray(16)
    counts[0] = total
    return data[:at] + bytes(counts) + data[at + 16:]


def _dc_symbol_above_15(data):
    """DC table 0 whose third symbol (a common bit count) is 200."""
    at, _ = _dht(data, 0x00)
    s = at + 16 + 2
    return data[:s] + b"\xc8" + data[s + 1:]


def _huge_frame(data):
    """The frame header claims 65535 x 65535 pixels."""
    i = data.index(b"\xff\xc0") + 5
    return data[:i] + b"\xff\xff\xff\xff" + data[i + 4:]


CORRUPT = {
    "oversubscribed-dc": (lambda d: _oversubscribed_dht(d, 0x00), "Huffman"),
    "oversubscribed-ac": (lambda d: _oversubscribed_dht(d, 0x10), "Huffman"),
    "dc-symbol-above-15": (lambda d: _dc_symbol_above_15(d), "above 15"),
    "truncated-scan": (lambda d: d[:len(d) // 2], "truncated"),
    "truncated-progressive": (None, "truncated"),
    "no-eoi": (lambda d: d[:-2], "truncated"),
    "huge-frame": (lambda d: _huge_frame(d), "limit of 2\\^30"),
}


@pytest.mark.parametrize("form", list(CORRUPT))
def test_corrupt_jpeg_raises(tmp_path, form):
    """A table that oversubscribes a code length or has a DC symbol above
    15, a scan cut short, a missing EOI and a frame above 2^30 pixels raise
    ValueError in every mode, without touching memory outside the decoder's
    buffers; PIL refuses the same bytes."""
    from mtt_tpu_torch.data.image_io import MODES, read_image
    make, match = CORRUPT[form]
    img = _scene(48, 64, 3)
    if make is None:
        data = _pil_jpeg(img, quality=90, progressive=True)
        data = data[:len(data) * 2 // 3]
    else:
        data = make(_pil_jpeg(img, quality=90))
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    for mode in MODES:
        with pytest.raises(ValueError, match=match):
            read_image(path, mode)


def test_fixtures_match_pixels_json():
    """The committed JPEG fixtures decode to the digests ``pixels.json``
    records (written by ``tools/make_jpeg_fixtures.py`` from PIL and cv2),
    and PIL and cv2 here agree with it; decoding from 4 threads at once
    gives the same arrays (the library keeps no state between calls)."""
    from mtt_tpu_torch.data.image_io import read_image
    with open(os.path.join(FIXTURES, "pixels.json")) as f:
        table = json.load(f)
    assert len(table) == 5

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    for name, entry in table.items():
        path = os.path.join(FIXTURES, name)
        ref = {"pil": np.array(Image.open(path)),
               "cv2": cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)}
        for key, mode in (("pil", "pil"), ("cv2", "cv2_color")):
            got = read_image(path, mode)
            assert list(got.shape) == entry[key]["shape"], (name, key)
            assert sha(got) == sha(ref[key]) == entry[key]["sha256"], \
                (name, key)
    results = {}

    def work(i):
        results[i] = [sha(read_image(os.path.join(FIXTURES, n), "pil"))
                      for n in sorted(table)]
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = [table[n]["pil"]["sha256"] for n in sorted(table)]
    assert all(r == want for r in results.values())


def test_build_failure_raises(tmp_path):
    """A library that does not compile raises (no numpy fallback), and the
    built decoder sits under ``build/mtt_tpu_torch/<hash>/``;
    ``save_preds.read_png`` is the decoder's ``read_png``."""
    from mtt_tpu_torch.data import image_io
    from mtt_tpu_torch.evaluation import save_preds
    from mtt_tpu_torch.utils import native_build
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native_build.build(bad, "bad", image_io.CXX_FLAGS, tmp_path / "b")
    lib = image_io.lib()._name
    assert os.path.dirname(os.path.dirname(lib)) == \
        str(native_build.BUILD_ROOT)
    assert save_preds.read_png is image_io.read_png
    with pytest.raises(ValueError, match="impl"):
        image_io.png_unfilter(np.zeros((1, 2), np.uint8), 1, impl="numpy")
