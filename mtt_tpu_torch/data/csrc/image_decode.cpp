// Host image decoding for the dataset readers and the inference CLI: a
// baseline and progressive Huffman JPEG decoder that gives libjpeg-turbo's
// pixels bit for bit (its default decompression: the JDCT_ISLOW integer
// IDCT of jidctint.c, the upsampling jinit_upsampler picks in jdsample.c,
// the fixed-point YCbCr->RGB and YCCK->CMYK of jdcolor.c), PNG scanline
// unfiltering, and TIFF's LZW and PackBits decoders. Built with g++ at
// first use and called through ctypes (data/image_io.py, data/tiff.py),
// which releases the GIL for the call: the loader's threads decode in
// parallel.
//
// Integer arithmetic only, compiled as C++20 (shifts of negative values
// are arithmetic) with -fwrapv (the signed overflow a corrupt file can
// cause wraps): the result does not depend on the optimisation level or
// the compiler.
//
// JPEG: 1, 3 (YCbCr or RGB) or 4 (CMYK or YCCK, by the Adobe marker)
// components, sampling factors 1-4 on each axis (an interleaved MCU of at
// most 10 blocks, as libjpeg). Refused as forms (the caller names the
// ROADMAP item): arithmetic coding, lossless and hierarchical frames,
// 12-bit samples, 2 components. Refused as libjpeg refuses them: sampling
// factors above 4, ratios that are not integral, MCUs of more blocks.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position; 16 extra entries absorb
// runs past the end of a corrupt block, as libjpeg's jpeg_natural_order
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int code;  // 1: corrupt or truncated, 2: a form the decoder refuses,
            // 3: a frame above kMaxPixels
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Error{code, msg};
}

constexpr int kLookBits = 9;
// cv2's CV_IO_MAX_IMAGE_PIXELS: larger frames are refused, not allocated
constexpr int64_t kMaxPixels = int64_t{1} << 30;

struct Huffman {
  bool defined = false;
  int maxcode[18];  // largest code of each length, -1 when none
  int valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0 when longer

  // jdhuff.c jpeg_make_d_derived_tbl: the codes of each length must fit in
  // that length, the all-ones code excluded; checked before the codes of a
  // length go into `look`, which they would otherwise overrun
  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; l++) {
      int c = counts[l - 1];
      if (code + c >= (1 << l)) fail(1, "bad Huffman table");
      if (c) {
        valoffset[l] = k - code;
        for (int i = 0; i < c; i++, k++, code++) {
          if (l <= kLookBits) {
            int shift = kLookBits - l;
            for (int j = 0; j < (1 << shift); j++)
              look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;  // stops the walk on a corrupt code
    valoffset[17] = 0;
    defined = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // p is at a marker: feed zeros from here

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q < end && *q == 0) {
            p = q + 1;  // a stuffed 0xFF data byte
          } else {
            marker = true;
            p = q - 1;
            b = 0;
          }
        } else {
          p++;
        }
      }
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  int peek(int n) {
    if (bits < n) fill();
    return (int)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& h) {
    int e = h.look[peek(kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = get(kLookBits);
    int l = kLookBits + 1;
    for (;; l++) {
      code = (code << 1) | bit();
      if (code <= h.maxcode[l]) break;
    }
    if (l > 16) return 0;  // corrupt data: libjpeg goes on with 0
    return h.vals[code + h.valoffset[l]];
  }
  void reset() {
    buf = 0;
    bits = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width = 0, height = 0;      // downsampled samples
  int bw = 0, bh = 0;             // non-dummy blocks
  int stride_b = 0, rows_b = 0;   // blocks allocated (whole MCUs)
  bool latched = false;
  int qt[64] = {};                // latched quantisation table, natural
  std::vector<int16_t> coef;      // stride_b * rows_b blocks of 64
  int dc_pred = 0;
  int16_t* block(int bx, int by) {
    return coef.data() + ((size_t)by * stride_b + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, have_frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  int qtab[4][64];  // natural order
  bool qdef[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) fail(1, "truncated JPEG");
    return data[pos++];
  }
  int word() {
    int a = byte();
    return (a << 8) | byte();
  }
  int next_marker() {
    // skips any bytes up to the next 0xFF xx, xx not 0 and not 0xFF
    for (;;) {
      int b = byte();
      if (b != 0xFF) continue;
      int m;
      do m = byte(); while (m == 0xFF);
      if (m != 0) return m;
    }
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail(1, "bad DQT");
      for (int i = 0; i < 64; i++)
        qtab[tq][kNatural[i]] = pq ? word() : byte();
      qdef[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(1, "bad DHT");
      uint8_t counts[16], syms[256];
      int total = 0;
      for (int i = 0; i < 16; i++) total += counts[i] = (uint8_t)byte();
      if (total > 256) fail(1, "bad DHT");
      for (int i = 0; i < total; i++) syms[i] = (uint8_t)byte();
      // a DC symbol is a bit count of at most 15 (jdhuff.c refuses more)
      for (int i = 0; i < total && tc == 0; i++)
        if (syms[i] > 15) fail(1, "DC Huffman table with a symbol above 15");
      (tc ? ac[th] : dc[th]).build(counts, syms, total);
      len -= 17 + total;
    }
  }

  void read_sof(int marker) {
    if (have_frame) fail(1, "two frames in one JPEG");
    word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8)
      fail(2, std::to_string(precision) + "-bit samples");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(ncomp == 2 ? 2 : 1, std::to_string(ncomp) + " components");
    if (width == 0 || height == 0) fail(1, "no image size (DNL)");
    if ((int64_t)width * height > kMaxPixels)
      fail(3, std::to_string(width) + "x" + std::to_string(height) +
                  " pixels, above the decoder's limit of 2^30 (cv2's)");
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      // libjpeg's MAX_SAMP_FACTOR is 4 (JERR_BAD_SAMPLING above it)
      if (c.h < 1 || c.v < 1 || c.h > 4 || c.v > 4 || c.tq > 3)
        fail(1, "bad SOF: sampling factors " + std::to_string(c.h) + "x" +
                    std::to_string(c.v));
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    for (int i = 0; i < ncomp; i++)  // jdsample.c: JERR_FRACT_SAMPLE_NOTIMPL
      if (hmax % comp[i].h || vmax % comp[i].v)
        fail(3, "sampling factors " + std::to_string(comp[i].h) + "x" +
                    std::to_string(comp[i].v) + " of a component against " +
                    std::to_string(hmax) + "x" + std::to_string(vmax) +
                    ": not an integral ratio (libjpeg refuses it too)");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.width = (width * c.h + hmax - 1) / hmax;
      c.height = (height * c.v + vmax - 1) / vmax;
      c.bw = (c.width + 7) / 8;
      c.bh = (c.height + 7) / 8;
      c.stride_b = mcux * c.h;
      c.rows_b = mcuy * c.v;
    }
    have_frame = true;
  }

  void alloc_coefficients() {
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.coef.assign((size_t)c.stride_b * c.rows_b * 64, 0);
    }
  }

  void skip_segment() {
    int len = word();
    if (len < 2 || pos + len - 2 > n) fail(1, "bad segment length");
    pos += len - 2;
  }

  void read_app(int marker) {
    size_t start = pos;
    int len = word();
    if (len < 2 || start + len > n) fail(1, "bad segment length");
    const uint8_t* b = data + start + 2;
    int body = len - 2;
    if (marker == 0xE0 && body >= 5 && !std::memcmp(b, "JFIF", 5))
      jfif = true;
    if (marker == 0xEE && body >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
    pos = start + len;
  }

  // decodes one scan's entropy-coded data
  void scan() {
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail(1, "bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail(1, "SOS names an unknown component");
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail(1, "bad SOS table");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13)
        fail(1, "bad progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (!c->latched) {  // libjpeg latches a table at its first scan
        if (!qdef[c->tq]) fail(1, "quantisation table not defined");
        std::memcpy(c->qt, qtab[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0;
      if (need_dc && !dc[c->dc_tbl].defined) fail(1, "DC table not defined");
      if (need_ac && !ac[c->ac_tbl].defined) fail(1, "AC table not defined");
      c->dc_pred = 0;
    }
    eobrun = 0;
    if (ns > 1) {  // jdinput.c: D_MAX_BLOCKS_IN_MCU (JERR_BAD_MCU_SIZE)
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail(1, "an MCU of more than 10 blocks");
    }

    BitReader br{data + pos, data + n};
    int mx, my;  // MCUs of the scan
    if (ns == 1) {
      mx = sc[0]->bw;
      my = sc[0]->bh;
    } else {
      mx = mcux;
      my = mcuy;
    }
    long total = (long)mx * my, left = restart;
    for (long m = 0; m < total; m++) {
      if (restart && left == 0) {
        br.reset();
        if (!br.marker) br.fill();  // finds the marker after the padding
        if (br.marker && br.p + 1 < br.end && br.p[1] >= 0xD0 &&
            br.p[1] <= 0xD7) {
          br.p += 2;
        }
        br.marker = false;
        br.reset();
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        eobrun = 0;
        left = restart;
      }
      int mcol = (int)(m % mx), mrow = (int)(m / mx);
      if (ns == 1) {
        block(br, *sc[0], sc[0]->block(mcol, mrow), ss, se, ah, al);
      } else {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++)
              block(br, c, c.block(mcol * c.h + x, mrow * c.v + y), ss, se,
                    ah, al);
        }
      }
      if (restart) left--;
    }
    // on to the marker after the entropy-coded data
    pos = (size_t)(br.p - data);
    if (br.marker) return;
  }

  void block(BitReader& br, Component& c, int16_t* b, int ss, int se, int ah,
             int al) {
    if (!progressive) {
      int s = br.decode(dc[c.dc_tbl]);
      if (s) s = extend(br.get(s), s);
      c.dc_pred += s;
      b[0] = (int16_t)c.dc_pred;
      const Huffman& h = ac[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(h);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = (int16_t)extend(br.get(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = br.decode(dc[c.dc_tbl]);
        if (s) s = extend(br.get(s), s);
        c.dc_pred += s;
        b[0] = (int16_t)(c.dc_pred * (1 << al));
      } else if (br.bit()) {
        b[0] |= (int16_t)(1 << al);
      }
      return;
    }
    const Huffman& h = ac[c.ac_tbl];
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = ss; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
        } else {
          if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* t = b + kNatural[k];
          if (*t != 0) {
            if (br.bit() && (*t & p1) == 0)
              *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = b + kNatural[k];
        if (*t != 0 && br.bit() && (*t & p1) == 0)
          *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
      }
      eobrun--;
    }
  }

  // reads the markers up to EOI, decoding every scan's coefficients; with
  // header_only, stops after the frame header (SOF) and allocates nothing.
  // A file that ends before its EOI is truncated: PIL and cv2 refuse it.
  void parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(1, "not a JPEG");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m);
          if (header_only) return;
          alloc_coefficients();
          break;
        case 0xC3:
          fail(2, "lossless JPEG (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail(2, "hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          fail(2, "arithmetic-coded JPEG (marker 0x" +
                      std::string(1, "0123456789ABCDEF"[m >> 4]) +
                      std::string(1, "0123456789ABCDEF"[m & 15]) + ")");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          word();
          restart = word();
          break;
        case 0xDA:
          if (!have_frame) fail(1, "SOS before SOF");
          scan();
          scanned = true;
          break;
        case 0xDC:
          fail(1, "DNL marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // stray RSTn
          if (m == 0x01) break;               // TEM
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          skip_segment();
      }
    }
    if (!scanned) fail(1, "no scan in JPEG");
  }

  // libjpeg's default_decompress_parms for 4 components: YCCK when an
  // Adobe marker says so (transform 2, or any but 0), else straight CMYK
  bool ycck() const { return adobe && adobe_transform != 0; }

  bool rgb_colour() const {
    // libjpeg's default_decompress_parms for 3 components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return false;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      return true;
    return false;
  }
};

// ---- jidctint.c jpeg_idct_islow ----------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// libjpeg's idct range limit: (x & 1023) through its post-IDCT table
inline uint8_t idct_limit(int32_t x) {
  int i = x & 1023;
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int* qp = q + c;
    int32_t* w = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int32_t dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * F0_541;
    int32_t tmp2 = z1 + z3 * -F1_847;
    int32_t tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * -F0_899;
    z2 = z2 * -F2_562;
    z3 = z3 * -F1_961;
    z4 = z4 * -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int i = 0; i < 8; i++) o[i] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * F0_541;
    int32_t tmp2 = z1 + z3 * -F1_847;
    int32_t tmp3 = z1 + z2 * F0_765;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * -F0_899;
    z2 = z2 * -F2_562;
    z3 = z3 * -F1_961;
    z4 = z4 * -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// ---- jdsample.c: one component to the full grid --------------------------

// plane: the component's samples, (c.height, c.width) valid, row pitch
// `pitch`; out: (vmax/v * c.height, hmax/h * c.width) at pitch `opitch`.
// jinit_upsampler's choice: the fancy triangle filters for the ratios h2v1
// and h2v2 (widths above 2) and h1v2, replication (int_upsample, or
// h2v1_upsample / h2v2_upsample) for every other integral ratio
void upsample(const Component& c, int hmax, int vmax, const uint8_t* plane,
              int pitch, uint8_t* out, int opitch, int out_rows) {
  const int w = c.width, hgt = c.height;
  const int hr = hmax / c.h, vr = vmax / c.v;
  auto row = [&](int y) {  // the edge rows repeat (jdmainct.c)
    if (y < 0) y = 0;
    if (y >= hgt) y = hgt - 1;
    return plane + (size_t)y * pitch;
  };
  const bool fancy_h = hr == 2 && w > 2;
  const bool fancy_h2v1 = fancy_h && vr == 1;
  const bool fancy_v = (hr == 1 || fancy_h) && vr == 2;  // h1v2, h2v2
  std::vector<int> colsum(w);
  for (int oy = 0; oy < out_rows; oy++) {
    uint8_t* o = out + (size_t)oy * opitch;
    int iy = oy / vr;
    if (fancy_h2v1) {  // h2v1_fancy_upsample
      const uint8_t* in = row(iy);
      o[0] = in[0];
      o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < w - 1; x++) {
        int v = in[x] * 3;
        o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      o[2 * w - 2] = (uint8_t)((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
      o[2 * w - 1] = in[w - 1];
      continue;
    }
    if (!fancy_v) {  // replication, hr x vr
      const uint8_t* in = row(iy);
      for (int x = 0; x < w; x++)
        for (int k = 0; k < hr; k++) o[x * hr + k] = in[x];
      continue;
    }
    // vr == 2: the nearer row and the next nearer (above for even rows)
    bool below = oy & 1;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row(below ? iy + 1 : iy - 1);
    if (hr == 1) {  // h1v2_fancy_upsample
      int bias = below ? 2 : 1;
      for (int x = 0; x < w; x++)
        o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      continue;
    }
    // h2v2_fancy_upsample
    for (int x = 0; x < w; x++) colsum[x] = in0[x] * 3 + in1[x];
    int t = colsum[0];
    o[0] = (uint8_t)((t * 4 + 8) >> 4);
    o[1] = (uint8_t)((t * 3 + colsum[1] + 7) >> 4);
    for (int x = 1; x < w - 1; x++) {
      t = colsum[x];
      o[2 * x] = (uint8_t)((t * 3 + colsum[x - 1] + 8) >> 4);
      o[2 * x + 1] = (uint8_t)((t * 3 + colsum[x + 1] + 7) >> 4);
    }
    t = colsum[w - 1];
    o[2 * w - 2] = (uint8_t)((t * 3 + colsum[w - 2] + 8) >> 4);
    o[2 * w - 1] = (uint8_t)((t * 4 + 7) >> 4);
  }
}

// ---- jdcolor.c ycc_rgb_convert ------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int sb = 16;
    const int32_t half = 1 << (sb - 1);
    auto fix = [](double x) { return (int32_t)(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> sb);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> sb);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void decode_pixels(Decoder& d, uint8_t* out) {
  const int W = d.width, H = d.height;
  // IDCT of each component's non-dummy blocks, then each to the full grid
  std::vector<std::vector<uint8_t>> full(d.ncomp);
  const int fw = d.mcux * d.hmax * 8, fh = d.mcuy * d.vmax * 8;
  for (int ci = 0; ci < d.ncomp; ci++) {
    Component& c = d.comp[ci];
    const int pitch = c.stride_b * 8;
    std::vector<uint8_t> plane((size_t)pitch * c.rows_b * 8, 0);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.block(bx, by), c.qt,
                   plane.data() + (size_t)by * 8 * pitch + bx * 8, pitch);
    if (c.h == d.hmax && c.v == d.vmax) {
      full[ci].swap(plane);
      continue;
    }
    full[ci].assign((size_t)fw * fh, 0);
    int rows = c.height * (d.vmax / c.v);
    if (rows > fh) rows = fh;
    upsample(c, d.hmax, d.vmax, plane.data(), pitch, full[ci].data(), fw,
             rows);
  }
  auto pitch_of = [&](int ci) {
    const Component& c = d.comp[ci];
    return (c.h == d.hmax && c.v == d.vmax) ? c.stride_b * 8 : fw;
  };
  if (d.ncomp == 1) {
    const int p = pitch_of(0);
    for (int y = 0; y < H; y++)
      std::memcpy(out + (size_t)y * W, full[0].data() + (size_t)y * p, W);
    return;
  }
  const int p0 = pitch_of(0), p1 = pitch_of(1), p2 = pitch_of(2);
  if (d.ncomp == 4) {  // null_convert (CMYK) or ycck_cmyk_convert
    const int p3 = pitch_of(3);
    const bool ycck = d.ycck();
    for (int y = 0; y < H; y++) {
      const uint8_t* a = full[0].data() + (size_t)y * p0;
      const uint8_t* b = full[1].data() + (size_t)y * p1;
      const uint8_t* c = full[2].data() + (size_t)y * p2;
      const uint8_t* k = full[3].data() + (size_t)y * p3;
      uint8_t* o = out + (size_t)y * W * 4;
      for (int x = 0; x < W; x++) {
        if (ycck) {
          int yy = a[x], cb = b[x], cr = c[x];
          o[4 * x] = clamp255(255 - (yy + kYcc.cr_r[cr]));
          o[4 * x + 1] = clamp255(
              255 - (yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          o[4 * x + 2] = clamp255(255 - (yy + kYcc.cb_b[cb]));
        } else {
          o[4 * x] = a[x];
          o[4 * x + 1] = b[x];
          o[4 * x + 2] = c[x];
        }
        o[4 * x + 3] = k[x];
      }
    }
    return;
  }
  const bool rgb = d.rgb_colour();
  for (int y = 0; y < H; y++) {
    const uint8_t* a = full[0].data() + (size_t)y * p0;
    const uint8_t* b = full[1].data() + (size_t)y * p1;
    const uint8_t* c = full[2].data() + (size_t)y * p2;
    uint8_t* o = out + (size_t)y * W * 3;
    if (rgb) {
      for (int x = 0; x < W; x++) {
        o[3 * x] = a[x];
        o[3 * x + 1] = b[x];
        o[3 * x + 2] = c[x];
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      int yy = a[x], cb = b[x], cr = c[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] =
          clamp255(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

void set_error(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
}

// the frame header, read by the same marker loop as the decode
int frame_info(const uint8_t* data, size_t n, int32_t* info) {
  Decoder d{data, n};
  d.parse(true);
  info[0] = d.width;
  info[1] = d.height;
  info[2] = d.ncomp;
  info[3] = d.progressive;
  return 0;
}

}  // namespace

extern "C" {

// info: [width, height, components, progressive]. Returns 0, or 1 for a
// corrupt file, 2 for a form the decoder refuses, 3 for a frame of more
// than 2^30 pixels (message in err).
int mtt_jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err,
                  int errlen) {
  try {
    return frame_info(data, (size_t)n, info);
  } catch (const Error& e) {
    set_error(e, err, errlen);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(Error{1, "out of memory"}, err, errlen);
    return 1;
  }
}

// out: (height, width) grey, (height, width, 3) RGB or (height, width, 4)
// CMYK (libjpeg's JCS_CMYK: as stored, or converted from YCCK), as
// libjpeg-turbo's default decompression gives them.
int mtt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int64_t out_size, char* err, int errlen) {
  try {
    Decoder d{data, (size_t)n};
    d.parse(false);
    if ((int64_t)d.width * d.height * (d.ncomp == 1 ? 1 : d.ncomp) !=
        out_size)
      fail(1, "output buffer size");
    decode_pixels(d, out);
    return 0;
  } catch (const Error& e) {
    set_error(e, err, errlen);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(Error{1, "out of memory"}, err, errlen);
    return 1;
  }
}

// PNG scanlines (h rows of 1 filter byte + stride bytes) to their bytes
// before filtering (PNG spec section 9); bpp: bytes a complete pixel, at
// least 1. Returns 0, or 1 for a filter type above 4.
int mtt_png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* line = raw + y * (stride + 1);
    const int kind = line[0];
    line++;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y ? out + (y - 1) * stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          int pa = std::abs(b - c), pb = std::abs(a - c),
              pc = std::abs(a + b - 2 * c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return 1;
    }
  }
  return 0;
}

// TIFF's LZW (libtiff tif_lzw.c LZWDecode: codes of 9 to 12 bits, most
// significant bit first, the width growing one code early; 256 clears the
// table, 257 ends the data). Decodes into out until EOI or out is full.
// Returns the bytes written, or -1 for a code past the table, data that
// ends before out is full or before an EOI (message in err).
int64_t mtt_tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t out_size, char* err, int errlen) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMax = 4096;
  std::vector<int16_t> prefix(kMax);
  std::vector<uint8_t> suffix(kMax), first(kMax);
  std::vector<uint16_t> length(kMax);
  std::vector<uint8_t> stack(kMax);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int64_t pos = 0, o = 0;
  uint32_t acc = 0;
  int bits = 0, width = 9, next = kFirst, old = -1;
  auto bad = [&](const char* msg) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
    return (int64_t)-1;
  };
  while (o < out_size) {
    while (bits < width) {
      if (pos >= n) return bad("LZW data ends before the strip is full");
      acc = (acc << 8) | in[pos++];
      bits += 8;
    }
    int code = (int)((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      old = -1;
      continue;
    }
    if (code > next || (code == next && old < 0) || next >= kMax)
      return bad("LZW code past the table");
    if (old >= 0) {  // the entry old + first byte of code (or of old: KwKwK)
      prefix[next] = (int16_t)old;
      suffix[next] = code == next ? first[old] : first[code];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      next++;
    }
    int len = length[code];
    int k = len, c = code;
    while (c >= 0) {
      stack[--k] = suffix[c];
      c = prefix[c];
    }
    int64_t take = len < out_size - o ? len : out_size - o;
    std::memcpy(out + o, stack.data(), (size_t)take);
    o += take;
    old = code;
    // early change: the next code is wider once the table's next entry
    // would need it (libtiff: free_ent > maxcode - 1)
    if (next + 1 >= (1 << width) && width < 12) width++;
  }
  if (o < out_size) return bad("LZW data ends before the strip is full");
  return o;
}

// TIFF's PackBits (libtiff tif_packbits.c PackBitsDecode): a count byte n,
// then n + 1 literal bytes (n >= 0) or one byte repeated 1 - n times (n in
// -127..-1); -128 is skipped. Runs past out are cut, as libtiff cuts them.
// Returns the bytes written, or -1 for data that ends before out is full.
int64_t mtt_tiff_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                                 int64_t out_size) {
  int64_t pos = 0, o = 0;
  while (o < out_size && pos < n) {
    int c = (int8_t)in[pos++];
    if (c == -128) continue;
    if (c < 0) {
      if (pos >= n) break;
      int64_t run = 1 - c;
      if (run > out_size - o) run = out_size - o;
      std::memset(out + o, in[pos++], (size_t)run);
      o += run;
    } else {
      int64_t run = c + 1;
      if (run > n - pos) break;
      if (run > out_size - o) run = out_size - o;
      std::memcpy(out + o, in + pos, (size_t)run);
      pos += c + 1;
      o += run;
    }
  }
  return o < out_size ? -1 : o;
}

}  // extern "C"
