// InvPT multi-scale tail: relu(inv * conv3x3(U8(x0) + U4(x1) + U2(x2)) + addv),
// bf16 features in; out either the (B, th, tw, D) bf16 feature map, or, with
// the fused per-task 1x1 head, only the (B, th, tw, n) f32 logits.
//
// Replaces mtt_tpu/kernels/invpt_tail.py:_tail_kernel_st (pallas_call at :608,
// with the head at :593) and computes the function of its twin _tail_kernel
// (:76 -> :228, the height mix as dots). Per scale s with factor f (8, 4, 2):
//   Gm_s[h', w', k, l, d] = bf16(sum_c x_s[h', w', c] kc[k, l, c, d])  (9 taps)
//   M_s[h', k, W, d]      = bf16(sum_{w', l} Gm_s[h', w', k, l, d] Sw_s[w', l, W])
//   Y[H, W, d]            = sum_s sum_{h', k} M_s[h', k, W, d] Sh_s[h', k, H]  (f32)
//   act                   = bf16(max(Y inv[d] + addv[d], 0))
//   logits[H, W, j]       = sum_d act wh[d, j] + bh[j]               (f32, head)
// Sw_s and Sh_s are the shifted f-x bilinear matrices (models/layers.py:
// _upf_shift_stack_np); output column W draws on low-res columns W/f - 1,
// W/f, W/f + 1 only, so the wrapper hands them over as (f g, 3, 3) bands.
//
// What bounds it on the H100: operations. At ViT-L PASCAL shapes (x0 (8, 16,
// 16, 576), x1 32x32, x2 64x64, D = 576) the channel contraction is 257 GFLOP
// on the tensor cores against 50 MB of input and 151 MB of output (11 MB with
// the head). What it must avoid are the three upsampled (8, 128, 128, 576)
// maps and the f32 conv output of the dense composition, and with the head the
// feature map itself.
//
// Design: two stages, cut at the TPU kernel's first bf16 rounding, as the up4
// head (head_up4.cu) is cut.
//  1. Gm, once, on the port's shared wgmma/TMA GEMM (gemm.cu, EPI_TAIL: no
//     bias, its own instantiation so that a profile counts it here): one
//     launch a scale, x_s (B gh gw, CP) . kc^T (9 DP, CP) -> Gm_s (B gh gw,
//     9 DP) bf16, the columns (k, l, d), into one scratch from the wrapper
//     (446 MB at PASCAL, 439 MB at NYUD, alive only inside the call). No
//     halo is formed twice: 257 GFLOP, the minimal contraction.
//  2. invpt_tail_mix_kernel, from the three Gm to the output. A block owns a
//     strip of 8 output columns (no ragged strip: tw % 8 == 0) of one image
//     and a slab of 64 channels, and walks the strip down a range of output
//     rows, two rows a step (rows 2i and 2i + 1 draw on the same low-res rows
//     of every scale). A thread owns one column and a channel pair, and per
//     scale it keeps the last three width-mixed low-res rows M_s of them in
//     registers (only it forms and reads them): scale 2's advance every step,
//     scale 1's every second and scale 0's every fourth, so each M value is
//     formed once (the first two rows of a range are formed by the range
//     above too), from Gm rows staged by cp.async two steps ahead. Each
//     output row or column draws on 2 of the 3 band entries per conv tap
//     (tap_base), and away from the borders the height weights are constant
//     multiples of 1/(2f), so with the row pair's place in the group of 8
//     rows unrolled they are immediates. Then the three scales' sum in f32,
//     the affine and the ReLU, one bf16 rounding; the feature map leaves in
//     16-byte stores, or the head's 1x1 adds the slab's 64 channels to the
//     16 pixels' logits on mma.sync (every n <= 128 logits in registers).
//     Without the head the slabs run side by side over the grid; with it a
//     block owns all D channels of its pixels (no atomics: equal bits from
//     run to run) and walks its rows once per slab, the later slabs' logits
//     added to the first's in device memory by the same thread, which costs
//     a read and a write of the f32 logits per slab after the first.
#include "common.cuh"
#include "gemm.cuh"

using namespace mtt;

namespace {

constexpr int XT = 256;          // 8 warps: thread (column W0 + warp, channel pair lane)
constexpr int WS = 8;            // output columns per strip
constexpr int DCH = 64;          // channels per step
constexpr int NBUF = 3;          // staged steps: two in flight
constexpr int TLD = DCH + 8;     // row pitch of the 16-pixel activation tile
constexpr int kSmemMax = 232448;

// Scale s has factor 8 >> s. A strip's staged Gm columns of scale f are
// W0 / f - 1 .. (W0 + WS) / f; one step stages a row of them for 64 channels.
__host__ __device__ constexpr int scale_cols(int s) { return WS / (8 >> s) + 2; }
__host__ __device__ constexpr int tile_elems(int s) { return scale_cols(s) * 9 * DCH; }
__host__ __device__ constexpr int tile_off(int s) {
  return s == 0 ? 0 : (s == 1 ? tile_elems(0) : tile_elems(0) + tile_elems(1));
}
constexpr int STAGE = tile_off(2) + tile_elems(2);  // bf16 elements of one staged step

// Per scale, column of the strip and conv tap l: the two width weights and
// the offset of the first staged column in the scale's tile (16 bytes).
constexpr int TAPS = 3 * WS * 3;

// staged steps, the 16-pixel tile, the width taps, the head's kp rows of the
// slab
__host__ __device__ constexpr int mix_smem(int NP, bool head) {
  return NBUF * STAGE * 2 + 16 * TLD * 2 + TAPS * 16 + (head ? DCH * (NP + 8) * 2 : 0);
}

// The two low-res rows (or columns) that output row (column) f s + p draws on
// through conv tap k (or l): upsampled position u = p + k - 1 relative to f s
// lies at (2u + 1 - f) / (2f) low-res rows from s, between rows s - 1 and s
// when that is negative, else between s and s + 1. So of the band entries dh
// (dw) = 0, 1, 2 only base, base + 1 can be nonzero (tests/
// test_torch_invpt_kernels.py holds the bands to this).
__host__ __device__ constexpr int tap_base(int f, int p, int k) { return 2 * (p + k - 1) + 1 < f ? 0 : 1; }

// Away from the map's borders the two weights are the bilinear ones: 1 - a,
// a over rows base, base + 1 with a the fractional part of the position
// above, an exact multiple of 1 / (2f); equal to the bands' entries there.
__host__ __device__ constexpr float tap_weight(int f, int p, int k, int e) {
  const int pos = 2 * (p + k - 1) + 1 - f, a = pos < 0 ? pos + 2 * f : pos;
  return (e ? a : 2 * f - a) / (2.0f * f);
}

__device__ __forceinline__ float2 bf2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int V>
struct Int {
  static constexpr int value = V;
};

struct TailArgs {
  const bf16* gm[3];    // Gm_s (B, th / f, tw / f, 9 DP) bf16
  const float* sw[3];   // (tw, 3, 3) width bands
  const float* sh[3];   // (th, 3, 3) height bands
  const bf16* kp;       // head: (DP, NP) bf16, zero-padded
  const float* bh;      // head: (n,) f32
  const float* inv;     // (D,) f32
  const float* addv;    // (D,) f32
  void* out;            // (B, th, tw, D) bf16, or the head's (B, th, tw, n) f32
  int th, tw, D, DP, n, NP, R;
};

// Grid (tw / 8 strips, row ranges of R, B x DP / 64 slabs of channels).
// With the head grid.z is B and a block walks the slabs in turn.
template <bool HEAD>
__global__ void __launch_bounds__(XT, 2) invpt_tail_mix_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int KLD = a.NP + 8;
  bf16* Gs = reinterpret_cast<bf16*>(smem);
  bf16* Ts = Gs + NBUF * STAGE;
  float4* taps = reinterpret_cast<float4*>(Ts + 16 * TLD);
  bf16* Ks = reinterpret_cast<bf16*>(taps + TAPS);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int Wl = warp, dp = lane;  // this thread's output column in the strip, channel pair
  const int W0 = blockIdx.x * WS;
  const int H0 = blockIdx.y * a.R, H1 = min(a.th, H0 + a.R);
  const int nsb = (a.DP + DCH - 1) / DCH;
  const int b = HEAD ? blockIdx.z : blockIdx.z / nsb;
  const int sl_begin = HEAD ? 0 : blockIdx.z % nsb, sl_end = HEAD ? nsb : sl_begin + 1;
  const int nsteps = 2 + (H1 - H0) / 2;

  // the width taps of each column of the strip, per scale and l: the staged
  // columns Wl / f + base + {0, 1} (the offset of the first in the scale's
  // staged tile; the second is one column, 9 DCH elements, on) and their
  // weights. A warp reads its column's as one broadcast: kept in registers,
  // they spilled.
  if (t < TAPS) {
    const int s = t / (3 * WS), c = (t / 3) % WS, l = t % 3, f = 8 >> s;
    const int dw = tap_base(f, c % f, l);
    const float* w = a.sw[s] + (size_t)(W0 + c) * 9 + l * 3 + dw;
    taps[t] = make_float4(w[0], w[1],
                          __int_as_float(tile_off(s) + ((c / f + dw) * 9 + l) * DCH), 0.f);
  }

  for (int sl = sl_begin; sl < sl_end; ++sl) {
    const int d0 = sl * DCH, d = d0 + 2 * dp;  // the slab's first channel, the pair's
    const float iv0 = d < a.D ? a.inv[d] : 0.f, iv1 = d + 1 < a.D ? a.inv[d + 1] : 0.f;
    const float ad0 = d < a.D ? a.addv[d] : 0.f, ad1 = d + 1 < a.D ? a.addv[d + 1] : 0.f;
    __syncthreads();  // the previous slab's last step has read the stages, the tile and Ks
    if (HEAD) {
      // the slab's kp rows, zero past DP; they land with step 0's group
      const int pieces = a.NP / 8;
      for (int e = t; e < DCH * pieces; e += XT) {
        const int r = e / pieces, cc = (e % pieces) * 8;
        const bool ok = d0 + r < a.DP;
        cp_async16(Ks + r * KLD + cc, ok ? a.kp + (size_t)(d0 + r) * a.NP + cc : a.kp, ok);
      }
    }

    // Step i's Gm rows: steps 0 and 1 form rows H0 / f - 1 and H0 / f of
    // every scale, then the step of output rows H, H + 1 forms row H / f + 1
    // of each scale whose f divides H. Zero where the row, the column or the
    // channel is off the map.
    auto stage = [&](int i) {
      if (i < nsteps) {
        bf16* g = Gs + (i % NBUF) * STAGE;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int f = 8 >> s;
          const int H = H0 + 2 * (i - 2);
          if (i >= 2 && H % f) continue;
          const int r = i < 2 ? H0 / f - 1 + i : H / f + 1;
          const int gh = a.th / f, gw = a.tw / f;
          const bool rok = r >= 0 && r < gh;
          const bf16* grow = a.gm[s] + (rok ? ((size_t)b * gh + r) * gw * 9 * a.DP + d0 : 0);
          const int c0 = W0 / f - 1;
          for (int e = t; e < scale_cols(s) * 9 * (DCH / 8); e += XT) {
            const int j = e / (9 * (DCH / 8)), kl = (e / (DCH / 8)) % 9, dd = (e % (DCH / 8)) * 8;
            const int w = c0 + j;
            const bool ok = rok && w >= 0 && w < gw && d0 + dd < a.DP;
            cp_async16(g + tile_off(s) + (j * 9 + kl) * DCH + dd,
                       ok ? grow + ((size_t)w * 9 + kl) * a.DP + dd : a.gm[s], ok);
          }
        }
      }
      cp_async_commit();  // possibly empty: keeps the wait count uniform
    };

    // The width-mixed rows of the thread's column and channel pair, per scale
    // the last three (low-res rows hq - 1, hq, hq + 1 of the current output
    // rows), three taps k each, as bf16 pairs: a ring in registers, as only
    // this thread forms and reads its entries.
    uint32_t ring[3][3][3] = {};
    // width mix of scale s's staged row (3 taps k, the 6 nonzero of 9 (l,
    // dw)), rounded to bf16, pushed into the ring
    auto form = [&](auto S, const bf16* g) {
      constexpr int s = decltype(S)::value;
      float4 tp[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) tp[l] = taps[(s * WS + Wl) * 3 + l];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float m0 = 0.f, m1 = 0.f;
#pragma unroll
        for (int l = 0; l < 3; ++l)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = e ? tp[l].y : tp[l].x;
            const float2 v = bf2f(*reinterpret_cast<const uint32_t*>(
                g + __float_as_int(tp[l].z) + 2 * dp + (e * 9 + k * 3) * DCH));
            m0 = fmaf(w, v.x, m0);
            m1 = fmaf(w, v.y, m1);
          }
        ring[s][0][k] = ring[s][1][k];
        ring[s][1][k] = ring[s][2][k];
        ring[s][2][k] = pack_bf16x2(m0, m1);
      }
    };

    // height mix of scale s into output rows H = Hg + 2J, H + 1 (Hg % 8 == 0)
    auto mix = [&](auto S, auto J, int Hg, float (&y)[2][2]) {
      constexpr int s = decltype(S)::value, f = 8 >> s;
      constexpr int p0 = (2 * decltype(J)::value) % f;  // H % f; H + 1 has p0 + 1 < f
      const int H = Hg + 2 * decltype(J)::value, hq = H / f;
      const bool border = hq == 0 || hq == a.th / f - 1;  // uniform over the block
      const float* sh = a.sh[s] + (size_t)H * 9;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int dh = tap_base(f, p0 + pp, k) + e;
            const float w = border ? __ldg(sh + pp * 9 + k * 3 + dh) : tap_weight(f, p0 + pp, k, e);
            const float2 m = bf2f(ring[s][dh][k]);
            y[pp][0] = fmaf(w, m.x, y[pp][0]);
            y[pp][1] = fmaf(w, m.y, y[pp][1]);
          }
    };

    auto pair_step = [&](auto J, int Hg, int i) {
      constexpr int j = decltype(J)::value;
      const int H = Hg + 2 * j;
      const bf16* g = Gs + (i % NBUF) * STAGE;
      // head: the earlier slabs' logits of this thread's outputs, loaded
      // ahead of the step's work (this thread wrote them a slab ago)
      [[maybe_unused]] float old[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      [[maybe_unused]] float* lo = nullptr;
      if constexpr (HEAD) {
        lo = static_cast<float*>(a.out) + (((size_t)b * a.th + H) * a.tw + W0 + (lane >> 2)) * a.n;
        if (sl > 0 && warp < a.NP / 16)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jn = warp * 16 + h * 8 + 2 * (lane & 3) + (e & 1);
              if (jn < a.n) old[h][e] = lo[(size_t)(e >> 1) * a.tw * a.n + jn];
            }
      }
      // new rows: scale 2 every step, scale 1 every second, scale 0 every
      // fourth (H % 8 == 2 j)
      form(Int<2>{}, g);
      if constexpr (j % 2 == 0) form(Int<1>{}, g);
      if constexpr (j == 0) form(Int<0>{}, g);
      float y[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      mix(Int<0>{}, J, Hg, y);
      mix(Int<1>{}, J, Hg, y);
      mix(Int<2>{}, J, Hg, y);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
        *reinterpret_cast<uint32_t*>(Ts + (pp * WS + Wl) * TLD + 2 * dp) = pack_bf16x2(
            fmaxf(y[pp][0] * iv0 + ad0, 0.f), fmaxf(y[pp][1] * iv1 + ad1, 0.f));
      if constexpr (!HEAD) {
        // the warp's two pixels (its column in rows H, H + 1): 16-byte stores
        __syncwarp();
        if (lane < 16) {
          const int pp = lane >> 3, dd = d0 + (lane & 7) * 8;
          bf16* out =
              static_cast<bf16*>(a.out) + (((size_t)b * a.th + H + pp) * a.tw + W0 + Wl) * a.D + dd;
          const bf16* src = Ts + (pp * WS + Wl) * TLD + (lane & 7) * 8;
          if (a.D % 8 == 0) {
            if (dd < a.D) *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int k = 0; k < 8 && dd + k < a.D; ++k) out[k] = src[k];
          }
        }
        __syncwarp();
      } else {
        // the 16 pixels' logits: t (16 x 64) . kp (64 x NP), warp w logits
        // 16 w .. 16 w + 15, added to the earlier slabs' in device memory
        __syncthreads();
        if (warp < a.NP / 16) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < DCH; kk += 16) {
            uint32_t af[4], bfr[4];
            ldsm_x4(af, Ts + kk + ldsm_a_off(lane, TLD));
            ldsm_x4_trans(bfr, Ks + kk * KLD + warp * 16 + ldsm_b_off(lane, KLD));
            mma_16816(acc[0], af, bfr[0], bfr[1]);
            mma_16816(acc[1], af, bfr[2], bfr[3]);
          }
          const bool last = sl + 1 == nsb;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jn = warp * 16 + h * 8 + 2 * (lane & 3) + (e & 1);
              if (jn < a.n) {
                float v = old[h][e] + acc[h][e];
                if (last) v += a.bh[jn];
                lo[(size_t)(e >> 1) * a.tw * a.n + jn] = v;
              }
            }
        }
      }
    };

    stage(0);
    stage(1);
    int i = 0;
    auto begin = [&]() {
      cp_async_wait<1>();
      __syncthreads();  // step i landed; step i - 1's buffer and tile are read
      stage(i + 2);
    };
    // warm-up: rows H0 / f - 1 and H0 / f of every scale
    for (; i < 2; ++i) {
      begin();
      const bf16* g = Gs + (i % NBUF) * STAGE;
      form(Int<0>{}, g);
      form(Int<1>{}, g);
      form(Int<2>{}, g);
    }
    for (int Hg = H0; Hg < H1; Hg += 8) {
      begin();
      pair_step(Int<0>{}, Hg, i++);
      begin();
      pair_step(Int<1>{}, Hg, i++);
      begin();
      pair_step(Int<2>{}, Hg, i++);
      begin();
      pair_step(Int<3>{}, Hg, i++);
    }
  }
}

}  // namespace

// x0, x1, x2 (B, th/f, tw/f, CP) bf16 for f = 8, 4, 2 (the input channels
// zero-padded to CP % 8 == 0); wg (9 DP, CP) bf16: the conv kernel kc[k, l, c,
// d] at row (3 k + l) DP + d, zero-padded (DP % 8 == 0); sw_s (tw, 3, 3), sh_s
// (th, 3, 3) f32: the bands of each scale's shifted upsample matrices; inv,
// addv (D,) f32; gm: a bf16 scratch of B (th tw / 64 + th tw / 16 + th tw / 4)
// rows of 9 DP. With n == 0: out (B, th, tw, D) bf16. With 0 < n <= NP: kp
// (DP, NP) bf16 zero-padded, NP % 16 == 0 and <= 128, bh (n,) f32 -> out (B,
// th, tw, n) f32. th and tw multiples of 8; every pointer 16-byte aligned.
// Four launches: the shared GEMM once a scale (Gm), then the mix kernel.
extern "C" int mtt_invpt_tail_bf16(const void* x0, const void* x1, const void* x2, const void* wg,
                                   const void* kp, const void* bh, const void* sw0,
                                   const void* sh0, const void* sw1, const void* sh1,
                                   const void* sw2, const void* sh2, const void* inv,
                                   const void* addv, void* gm, void* out, int B, int th, int tw,
                                   int CP, int D, int DP, int n, int NP, void* stream) {
  const bool head = n > 0;
  if (B < 1 || th < 8 || tw < 8 || th % 8 || tw % 8 || CP % 8 || DP % 8 || D < 1 || D > DP ||
      n < 0 || (head && (NP % 16 || NP > 128 || n > NP)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  TailArgs a{};
  const void* xs[3] = {x0, x1, x2};
  const float* bands[6] = {static_cast<const float*>(sw0), static_cast<const float*>(sh0),
                           static_cast<const float*>(sw1), static_cast<const float*>(sh1),
                           static_cast<const float*>(sw2), static_cast<const float*>(sh2)};
  size_t row0 = 0;
  for (int s = 0; s < 3; ++s) {
    const int f = 8 >> s, rows = B * (th / f) * (tw / f);
    bf16* g = static_cast<bf16*>(gm) + row0 * 9 * DP;
    const int e = mtt_gemm_bf16(xs[s], wg, g, nullptr, 0, nullptr, rows, 9 * DP, CP, EPI_TAIL, stream);
    if (e) return e;
    a.gm[s] = g;
    a.sw[s] = bands[2 * s];
    a.sh[s] = bands[2 * s + 1];
    row0 += rows;
  }
  a.kp = static_cast<const bf16*>(kp);
  a.bh = static_cast<const float*>(bh);
  a.inv = static_cast<const float*>(inv);
  a.addv = static_cast<const float*>(addv);
  a.out = out;
  a.th = th;
  a.tw = tw;
  a.D = D;
  a.DP = DP;
  a.n = n;
  a.NP = head ? NP : 0;
  const int smem = mix_smem(a.NP, head);
  auto kernel = head ? invpt_tail_mix_kernel<true> : invpt_tail_mix_kernel<false>;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, XT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the strips and slabs of all images side by side; the rows split into
  // ranges of whole 8-row groups where that takes fewer steps in all: the
  // rounds of blocks over the card times the steps of a range (its row
  // pairs and two steps of warm-up)
  const int strips = tw / WS, cblocks = head ? 1 : (DP + DCH - 1) / DCH;
  const int groups = th / 8, slots = sms * max(occ, 1);
  const long long per_range = (long long)strips * cblocks * B;
  long long best = -1;
  int ranges = 1;
  for (int r = 1; r <= groups; ++r) {
    const int rg = (groups + r - 1) / r, used = (groups + rg - 1) / rg;
    const long long cost = (per_range * used + slots - 1) / slots * (4 * rg + 2);
    if (best < 0 || cost < best) {
      best = cost;
      ranges = used;
      a.R = rg * 8;
    }
  }
  if ((long long)B * cblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(strips, ranges, B * cblocks);
  kernel<<<grid, XT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
