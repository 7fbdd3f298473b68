"""Writers of the image forms that PIL and cv2 read but do not write, for
the tests of the port's decoders and ``tools/make_image_fixtures.py``:
baseline JPEG at any sampling factors and with 4 components, BMP, PNM and
TIFF in the layouts their specifications allow (with TIFF's LZW and
PackBits encoders). PIL and cv2 then read the bytes as the reference.

Each writer is plain numpy and struct, meant for small images.
"""

import struct
import zlib

import numpy as np


def scene(h, w, seed, channels=3):
    """A seeded photo-like (h, w, channels) uint8 image: smooth fields,
    hard-edged shapes, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / 13.0 + c) * np.cos(yy / 9.0 - c)
                    for c in range(channels)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 40)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(
            0, 255, channels)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(
        np.uint8)


# --- JPEG --------------------------------------------------------------------

# ITU T.81 Annex K.3: the typical luminance Huffman tables
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_DC_VALS = tuple(range(12))
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])


def _codes(bits, vals):
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    """Bits most significant first, a 0 stuffed after each 0xFF byte."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(full, factors, q=8, interleaved=True, adobe=None, ids=None):
    """Baseline JPEG bytes of (H, W) planes, one a component, at any
    sampling factors ``factors[i] = (h_i, v_i)`` (1-4): plane i is
    downsampled to ceil(W h_i / hmax) x ceil(H v_i / vmax) samples by
    taking the nearest; one quantisation table of all ``q``; one
    interleaved scan (at most 10 blocks an MCU), or one scan a component;
    an Adobe APP14 marker with ``adobe`` as its transform byte when
    given."""
    H, W = full[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    ids = ids or list(range(1, len(full) + 1))
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    dc, ac = _codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)
    comps = []
    for p, (h, v) in zip(full, factors):
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        sub = np.asarray(p, np.float64)[
            np.arange(ch) * vmax // v][:, np.arange(cw) * hmax // h]
        ph, pw = mcuy * v * 8, mcux * h * 8
        pad = np.pad(sub, ((0, ph - ch), (0, pw - cw)), mode="edge")
        blocks = pad.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", dct, blocks - 128, dct)
        coef = np.round(coef / q).astype(np.int64).reshape(
            ph // 8, pw // 8, 64)[..., _ZIGZAG]
        comps.append(dict(coef=coef, h=h, v=v, bw=-(-cw // 8),
                          bh=-(-ch // 8), pred=0))

    def block(bits, c, by, bx):
        blk = c["coef"][by, bx]
        diff = int(blk[0]) - c["pred"]
        c["pred"] = int(blk[0])
        n = abs(diff).bit_length()
        bits.put(*dc[n])
        if n:
            bits.put(diff if diff > 0 else diff + (1 << n) - 1, n)
        run = 0
        for i in range(1, 64):
            a = int(blk[i])
            if a == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac[0xF0])
                run -= 16
            n = abs(a).bit_length()
            bits.put(*ac[(run << 4) | n])
            bits.put(a if a > 0 else a + (1 << n) - 1, n)
            run = 0
        if run:
            bits.put(*ac[0x00])

    out = b"\xff\xd8"
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                      adobe))
    out += _segment(0xDB, bytes([0]) + bytes([q] * 64))
    out += _segment(0xC0, struct.pack(">BHHB", 8, H, W, len(full)) + b"".join(
        bytes([i, (c["h"] << 4) | c["v"], 0]) for i, c in zip(ids, comps)))
    out += _segment(0xC4, bytes([0x00]) + bytes(_DC_BITS) + bytes(_DC_VALS))
    out += _segment(0xC4, bytes([0x10]) + bytes(_AC_BITS) + _AC_VALS)
    scans = [list(range(len(comps)))] if interleaved else \
        [[i] for i in range(len(comps))]
    for scan in scans:
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[i], 0x00]) for i in scan) + bytes([0, 63, 0]))
        bits = _Bits()
        for i in scan:
            comps[i]["pred"] = 0
        if len(scan) == 1:
            c = comps[scan[0]]
            for by in range(c["bh"]):
                for bx in range(c["bw"]):
                    block(bits, c, by, bx)
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    for i in scan:
                        c = comps[i]
                        for y in range(c["v"]):
                            for x in range(c["h"]):
                                block(bits, c, my * c["v"] + y,
                                      mx * c["h"] + x)
        out += bits.flush()
    return out + b"\xff\xd9"


# --- BMP ---------------------------------------------------------------------

def bmp(px, bits, palette=None, header=40, top_down=False, bitfields=None,
        clrused=None):
    """BMP bytes: ``px`` is (h, w) palette indices at 1, 4 or 8 bits, else
    (h, w, 3|4) bytes in the file's order (B, G, R[, 4th]); ``palette``
    (n, 3) RGB; ``bitfields`` the R, G, B[, A] masks of BI_BITFIELDS (after
    a 40-byte header, else in it); rows bottom-up unless ``top_down``."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 5) * 4
    rows = np.zeros((h, stride), np.uint8)
    if bits <= 8:
        per = 8 // bits
        idx = np.zeros((h, -(-w // per) * per), np.int64)
        idx[:, :w] = px
        idx = idx.reshape(h, -1, per)
        packed = sum(idx[..., i] << (8 - bits * (i + 1)) for i in range(per))
        rows[:, :packed.shape[1]] = packed
    else:
        b = px.reshape(h, -1)
        rows[:, :b.shape[1]] = b
    if not top_down:
        rows = rows[::-1]
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([c[2], c[1], c[0], 0])
                       for c in np.asarray(palette, np.uint8))
    masks, comp = b"", 0
    if bitfields is not None:
        comp = 3
        if header == 40:
            masks = struct.pack("<III", *bitfields[:3])
    n = 0 if palette is None else len(palette) if clrused is None else clrused
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                       bits, comp, rows.size, 2835, 2835, n, 0)
    if header > 40:
        m = tuple(bitfields or ()) + (0,) * (4 - len(bitfields or ()))
        ext = struct.pack("<IIII", *m) + b"BGRs" + bytes(36 + 12 + 16)
        info += ext[:header - 40]
    off = 14 + len(info) + len(masks) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + rows.size, 0, 0, off) + info
            + masks + pal + rows.tobytes())


# --- PNM ---------------------------------------------------------------------

def pnm(kind, s, maxval=1, comments=False):
    """P1-P6 bytes of (h, w) or (h, w, 3) samples; plain kinds (P1-P3) write
    17 samples a line (P1: digits without spaces when ``comments``), with
    ``#`` comments in the header and the data when ``comments``."""
    s = np.asarray(s)
    h, w = s.shape[:2]
    head = (f"P{kind}\n" + ("# a comment\n" if comments else "")
            + f"{w} {h}\n" + (f"{maxval}\n" if kind not in (1, 4) else ""))
    head = head.encode()
    if kind == 4:
        return head + np.packbits(s.astype(np.uint8), axis=1).tobytes()
    if kind in (5, 6):
        return head + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    if kind == 1 and comments:
        return head + b"\n".join("".join(map(str, r)).encode() for r in s)
    flat = s.reshape(-1)
    body = "\n".join(" ".join(map(str, flat[i:i + 17]))
                     for i in range(0, len(flat), 17))
    if comments:
        body = body.replace("\n", " # c\n", 2)
    return head + body.encode() + b"\n"


# --- TIFF --------------------------------------------------------------------

def lzw(data: bytes) -> bytes:
    """TIFF's LZW: codes of 9-12 bits most significant bit first, each
    width taken one code early (libtiff), a clear code before the table
    fills."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    def width(nxt):
        return 9 if nxt < 512 else 10 if nxt < 1024 else 11 if nxt < 2048 \
            else 12
    table, nxt = {bytes([i]): i for i in range(256)}, 258
    put(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width(nxt))
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, 12)
            table, nxt = {bytes([i]): i for i in range(256)}, 258
        w = bytes([c])
    if w:
        put(table[w], width(nxt))
        nxt += 1
    put(257, width(nxt))
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (1 - n, byte), the rest as
    (n - 1, n literal bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        k = i
        while k < n and k - i < 128 and not (k + 1 < n
                                             and data[k + 1] == data[k]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def _pack_samples(v, bps, e):
    rows, cols, nsamp = v.shape
    if bps == 16:
        return v.astype(e + "u2").tobytes()
    if bps == 8:
        return v.astype(np.uint8).tobytes()
    flat = v.reshape(rows, cols * nsamp)
    per = 8 // bps
    pad = np.zeros((rows, -(-flat.shape[1] // per) * per), np.int64)
    pad[:, :flat.shape[1]] = flat
    pad = pad.reshape(rows, -1, per)
    return sum(pad[..., i] << (8 - bps * (i + 1))
               for i in range(per)).astype(np.uint8).tobytes()


def tiff(s, bps, photo, big=False, comp=1, predictor=1, planar=1, tile=None,
         rps=None, extra=(), cmap=None, orientation=None):
    """Classic TIFF bytes of (h, w, spp) samples: one image, in strips of
    ``rps`` rows or (width, height) ``tile``s, samples interleaved
    (``planar=1``) or one plane each (2); compression 1 (none), 5 (LZW), 8
    or 32946 (Deflate) or 32773 (PackBits), horizontal differencing when
    ``predictor=2``; ``cmap`` (2^bps, 3) 16-bit colour map entries."""
    e = ">" if big else "<"
    s = np.asarray(s)
    h, w, spp = s.shape
    planes = [s[..., i:i + 1] for i in range(spp)] if planar == 2 else [s]
    cw, ch = tile if tile else (w, rps or h)
    chunks = []
    for p in planes:
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                blk = p[y0:y0 + ch, x0:x0 + cw].astype(np.int64)
                if tile:
                    full = np.zeros((ch, cw, p.shape[2]), np.int64)
                    full[:blk.shape[0], :blk.shape[1]] = blk
                    blk = full
                if predictor == 2:
                    blk = np.concatenate([blk[:, :1], np.diff(blk, axis=1)],
                                         1) % (1 << bps)
                raw = _pack_samples(blk, bps, e)
                if comp == 5:
                    raw = lzw(raw)
                elif comp in (8, 32946):
                    raw = zlib.compress(raw)
                elif comp == 32773:
                    raw = packbits(raw)
                chunks.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
               259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
               284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if cmap is not None:
        entries[320] = (3, list(np.asarray(cmap).T.reshape(-1)))
    if orientation:
        entries[274] = (3, [orientation])
    if tile:
        entries[322], entries[323] = (4, [cw]), (4, [ch])
    else:
        entries[278] = (4, [ch])
    body = bytearray(b"MM\x00*" if big else b"II*\x00") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    entries[324 if tile else 273] = (4, offsets)
    entries[325 if tile else 279] = (4, [len(c) for c in chunks])
    struct.pack_into(e + "I", body, 4, len(body))
    tags = sorted(entries)
    at = len(body) + 2 + 12 * len(tags) + 4
    ifd, ext = bytearray(struct.pack(e + "H", len(tags))), bytearray()
    for t in tags:
        kind, vals = entries[t]
        data = struct.pack(f"{e}{len(vals)}{'H' if kind == 3 else 'I'}",
                           *[int(v) for v in vals])
        if len(data) <= 4:
            ifd += struct.pack(e + "HHI", t, kind, len(vals)) + data.ljust(
                4, b"\x00")
        else:
            ifd += struct.pack(e + "HHII", t, kind, len(vals), at + len(ext))
            ext += data + b"\x00" * (len(data) % 2)
    return bytes(body + ifd + bytes(4) + ext)
