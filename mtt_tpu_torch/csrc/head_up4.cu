// Fused up4 ConvHead: logits = 1x1(gelu(BN(conv3x3(upsample4(x))))), with the
// conv3x3 of the 4x bilinear upsample factored so that the channel contraction
// runs at low resolution. bf16 features in, f32 logits out.
//
// Replaces mtt_tpu/kernels/head_up4.py:_head_kernel_stencil (pallas_call at
// :416, the default) and computes the function of its opt-in twins
// _head_kernel (:65 -> :438) and _head_kernel_stencil2 (:251 -> :391):
//   Gm[h', w', k, l, d] = bf16(sum_c x[h', w', c] kc[k, l, c, d])   (9 taps)
//   M[h', k, W, d]      = bf16(sum_{w', l} Gm[h', w', k, l, d] Sw[w', l, W])
//   Y[H, W, d]          = sum_{h', k} M[h', k, W, d] Sh[h', k, H]     (f32)
//   t                   = bf16(gelu_fast(Y inv[d] + addv[d]))        (f32)
//   logits[H, W, j]     = sum_d t kp[d, j]                           (f32)
// Sw and Sh are the shifted 4x bilinear matrices (models/layers.py:
// up4_shift_stack); each output column W = 4s + p draws on low-res columns
// s-1, s, s+1 only, so the wrapper hands them over as (4g, 3, 3) bands.
//
// What bounds it on the H100: at ViT-L PASCAL shapes (x (8, 32, 32, 350),
// n <= 21) it is 18 GFLOP of channel contraction on the tensor cores plus
// about 2 G f32 operations of spatial mixing, GELU and rounding per output
// pixel and channel (46 M of them) on the CUDA cores; at NYUD's (8, 28, 36,
// 768) 86 GFLOP and 99 M pixel-channels. What it must avoid is the (8, 128,
// 128, 350) upsampled map, 92 MB in bf16 per task.
//
// Design: two launches, cut at the TPU kernel's first bf16 rounding.
//  1. Gm, once, on the port's shared wgmma/TMA GEMM (gemm.cu, EPI_NONE):
//     x (B gh gw, CP) . kc^T (9 DP, CP) -> Gm (B gh gw, 9 DP) bf16, the
//     columns (k, l, d), in a scratch from the wrapper (52 MB at PASCAL).
//  2. head_up4_mix_kernel, from Gm to the logits. A block owns a strip of
//     SW = 2 low-res columns (8 output columns) of one image and walks it
//     down a range of low-res rows. Each step stages one Gm row's 4 columns
//     for 64 channels (cp.async, the next two steps' in flight) and forms that
//     row's width mix M (3 taps k x 8 columns) into a ring of the last three
//     rows, so that every M value is formed once (the first two rows of a
//     range are formed by the range above too), not once per output row
//     group that uses it. The thread that forms M[., ., W, d] is the one that
//     reads it for the height mix, so the ring needs no barrier. Each output
//     row or column draws on 2 of the 3 band entries per conv tap (6 FMAs of
//     9), and away from the borders the height weights are constant
//     eighths, so they are immediates, not loads. With the
//     ring full, the step mixes the row group's 4 output rows in f32,
//     applies the affine and the GELU, rounds t to bf16 into shared memory
//     and adds t . kp for the step's 64 channels to the group's logits,
//     which mma.sync m16n8k16 keeps in registers for every n <= 128 at once.
//     The ring holds a slab of channels: all of PASCAL's 352, or 192 of
//     wider heads (NYUD's 768), so that three blocks share an SM; those walk
//     their rows once per slab and add the later slabs' logits to the first
//     slab's in device memory (the same thread, in a fixed order: no atomics,
//     equal bits run to run). Neighbouring strips run side by side (the
//     strip is the fastest grid axis), so the Gm rows two strips share come
//     from L2.
#include "common.cuh"
#include "gemm.cuh"

using namespace mtt;

namespace {

constexpr int MT = 256;          // 8 warps: thread (W = t / 32, channel pair t % 32)
constexpr int SW = 2;            // low-res columns per strip
constexpr int WS = 4 * SW;       // output columns per strip
constexpr int GC = SW + 2;       // staged Gm columns s0 - 1 .. s0 + SW
constexpr int DCH = 64;          // channels per step
constexpr int DS_MAX = 384;      // channels per slab (the ring's depth), at most
constexpr int PIX = 4 * WS;      // output pixels of a row group
constexpr int TLD = DCH + 8;     // padded rows of the t tile
constexpr int GS = GC * 9 * DCH;          // bf16: [column][k, l][d], one buffer
constexpr int NBUF = 3;                   // staged steps: two in flight
constexpr int kSmemMax = 232448;

// ring (bf16 [row slot][k][W][d] over a slab of DS channels), staged Gm and
// kp steps, the t tile, the slab's inv and addv, the bands
__host__ __device__ constexpr int mix_smem(int NP, int R, int DS) {
  return 3 * 3 * WS * DS * 2 + NBUF * GS * 2 + NBUF * DCH * (NP + 8) * 2 + PIX * TLD * 2 + 2 * DS * 4 +
         WS * 9 * 4 + 4 * R * 9 * 4;
}

// The two low-res rows (or columns) that output row (column) 4 s + p draws on
// through conv tap k (or l): upsampled row u = p + k - 1 relative to 4 s lies
// between rows s - 1 and s for u <= 1 and between s and s + 1 above, so of
// the three band entries dh (dw) = 0, 1, 2 only base, base + 1 can be nonzero
// (tests/test_torch_head.py holds the bands to this).
__host__ __device__ constexpr int tap_base(int p, int k) { return p + k - 1 <= 1 ? 0 : 1; }

// Away from the map's borders the two weights are the bilinear ones: the
// upsampled position (2 u - 3) / 8 rows from s, u = p + k - 1, splits 1 - f,
// f over rows base, base + 1. Exact eighths, equal to the bands' entries
// there (tests/test_torch_head.py).
__host__ __device__ constexpr float tap_weight(int p, int k, int e) {
  const int pos8 = 2 * (p + k - 1) - 3, f8 = pos8 < 0 ? pos8 + 8 : pos8;
  return (e ? f8 : 8 - f8) * 0.125f;
}

__device__ __forceinline__ float2 bf2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// gm (B gh gw, 9 DP) bf16; kp (DP, NP) bf16 with zero padding; inv, addv (D,)
// f32; swb (4gw, 3, 3), shb (4gh, 3, 3) f32 bands -> out (B, 4gh, 4gw, n) f32.
// Grid (gw / SW strips, row ranges of R, B); slabs of DS channels. MINB: the
// blocks an SM must hold (2 for one slab: 128 registers; 3 for the slabbed
// form, whose ring is half as deep: 85).
template <int MINB>
__global__ void __launch_bounds__(MT, MINB) head_up4_mix_kernel(
    const bf16* __restrict__ gm, const bf16* __restrict__ kp, const float* __restrict__ inv,
    const float* __restrict__ addv, const float* __restrict__ swb, const float* __restrict__ shb,
    float* __restrict__ out, int gh, int gw, int D, int DP, int n, int NP, int R, int DS) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* Gs = ring + 3 * 3 * WS * DS;
  bf16* Ks = Gs + NBUF * GS;
  const int KLD = NP + 8;
  bf16* Ts = Ks + NBUF * DCH * KLD;
  float* IVs = reinterpret_cast<float*>(Ts + PIX * TLD);
  float* ADs = IVs + DS;
  float* SWs = ADs + DS;
  float* SHs = SWs + WS * 9;

  const int s0 = blockIdx.x * SW, b = blockIdx.z;
  const int q0 = blockIdx.y * R, q1 = min(gh, q0 + R);
  const int H4 = 4 * gh, W4 = 4 * gw;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int Wl = warp, dp = lane;  // this thread's output column and channel pair

  for (int i = t; i < WS * 9; i += MT) SWs[i] = swb[(size_t)(4 * s0) * 9 + i];
  for (int i = t; i < 4 * (q1 - q0) * 9; i += MT) SHs[i] = shb[(size_t)(4 * q0) * 9 + i];
  __syncthreads();
  // this thread's width taps: per l, staged columns Wl / 4 + base + {0, 1}
  // and their band weights
  float swt[3][2];
  int gof[3][2];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dw = tap_base(Wl % 4, l) + e;
      swt[l][e] = SWs[Wl * 9 + l * 3 + dw];
      gof[l][e] = ((Wl / 4 + dw) * 9 + l) * DCH + 2 * dp;
    }

  // the 1x1's tiles: 2 pixel tiles of 16 x NP / 16 logit tiles of 16; warp
  // w takes tiles w and w + 8
  const int ntiles = 2 * (NP / 16);
  // e / (NP / 8) for the 64 (NP / 8) kp pieces of a step as a multiply and
  // shift: exact while e < 2^16 / (NP / 8)
  const int krcp = (65536 + NP / 8 - 1) / (NP / 8);
  // this thread's 16-byte pieces of a step's Gm columns (GC x 9 (k, l) x 64
  // channels, at most two a thread): their place in the stage, their offset
  // in a Gm row from channel d0, whether their column is on the map
  constexpr int GP = GC * 9 * (DCH / 8);
  int gdst[2], gsrc[2], gdd[2];
  bool gok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = min(t + MT * h, GP - 1);
    const int j = e / (9 * (DCH / 8)), kl = (e / (DCH / 8)) % 9, dd = (e % (DCH / 8)) * 8;
    const int w = s0 - 1 + j;
    gdst[h] = (j * 9 + kl) * DCH + dd;
    gsrc[h] = (w * 9 + kl) * DP + dd;
    gdd[h] = dd;
    gok[h] = t + MT * h < GP && w >= 0 && w < gw;
  }
  const int nsteps_row = q1 - q0 + 2;  // rows q0 - 1 .. q1 are formed

  for (int ds0 = 0; ds0 < DP; ds0 += DS) {
    const int nch = (min(DS, DP - ds0) + DCH - 1) / DCH;
    const int nsteps = nsteps_row * nch;
    __syncthreads();  // the previous slab's last step has read IVs / ADs
    for (int i = t; i < DS; i += MT) {
      const int d = ds0 + i;
      IVs[i] = d < D ? inv[d] : 0.f;
      ADs[i] = d < D ? addv[d] : 0.f;
    }
    // one step's Gm columns and kp rows, zero where the row, the column or
    // the channel is off the map
    auto stage = [&](int i) {
      if (i >= nsteps) {
        cp_async_commit();  // an empty group keeps the wait count uniform
        return;
      }
      const int r = q0 - 1 + i / nch, c = i % nch, buf = i % NBUF;
      const int d0 = ds0 + c * DCH;
      bf16* g = Gs + buf * GS;
      const bool rok = r >= 0 && r < gh;
      const bf16* grow = gm + (rok ? ((size_t)b * gh + r) * gw * 9 * DP + d0 : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t + MT * h >= GP) break;
        const bool ok = gok[h] && rok && d0 + gdd[h] < DP;
        cp_async16(g + gdst[h], ok ? grow + gsrc[h] : gm, ok);
      }
      bf16* k = Ks + buf * DCH * KLD;
      for (int e = t; e < DCH * (NP / 8); e += MT) {
        const int row = (e * krcp) >> 16, cc = (e - row * (NP / 8)) * 8;
        const bool ok = d0 + row < DP;
        cp_async16(k + row * KLD + cc, ok ? kp + (size_t)(d0 + row) * NP + cc : kp, ok);
      }
      cp_async_commit();
    };

    float acc[2][2][4];
    stage(0);
    stage(1);
    for (int i = 0; i < nsteps; ++i) {
      const int r = q0 - 1 + i / nch, c = i % nch, buf = i % NBUF;
      cp_async_wait<1>();
      __syncthreads();  // step i landed; step i - 1's t tile and buffers are read
      stage(i + 2);

      // width mix of row r (3 taps k, the 6 nonzero of its 9 (l, dw)),
      // rounded to bf16, into the ring
      const int dl = c * DCH + 2 * dp;  // the pair's channel in the slab
      const bf16* g = Gs + buf * GS;
      bf16* slot = ring + ((r + 1) % 3) * 3 * WS * DS;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float m0 = 0.f, m1 = 0.f;
#pragma unroll
        for (int l = 0; l < 3; ++l)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 v =
                bf2f(*reinterpret_cast<const uint32_t*>(g + gof[l][e] + k * 3 * DCH));
            m0 = fmaf(swt[l][e], v.x, m0);
            m1 = fmaf(swt[l][e], v.y, m1);
          }
        *reinterpret_cast<uint32_t*>(slot + (k * WS + Wl) * DS + dl) = pack_bf16x2(m0, m1);
      }
      if (r < q0 + 1) continue;  // the ring is not full yet (uniform over the block)

      // row group q = r - 1: height mix over rows q - 1 .. q + 1 in f32, the
      // affine and the GELU, t rounded to bf16 into the tile
      const int q = r - 1;
      if (c == 0) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][h][e] = 0.f;
      }
      {
        float2 m[3][3];  // [dh][k]: rows q - 1 .. q + 1
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            m[dh][k] = bf2f(*reinterpret_cast<const uint32_t*>(
                ring + (((q + dh) % 3) * 3 + k) * WS * DS + Wl * DS + dl));
        float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
        const float* sh = SHs + 4 * (q - q0) * 9;  // [p][k][dh]
        const bool border = q == 0 || q == gh - 1;  // uniform over the block
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int dh = tap_base(p, k) + e;
              const float w = border ? sh[p * 9 + k * 3 + dh] : tap_weight(p, k, e);
              y0[p] = fmaf(w, m[dh][k].x, y0[p]);
              y1[p] = fmaf(w, m[dh][k].y, y1[p]);
            }
        const float iv0 = IVs[dl], iv1 = IVs[dl + 1], ad0 = ADs[dl], ad1 = ADs[dl + 1];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<uint32_t*>(Ts + (p * WS + Wl) * TLD + 2 * dp) =
              pack_bf16x2(gelu_erf_poly_fast(y0[p] * iv0 + ad0),
                          gelu_erf_poly_fast(y1[p] * iv1 + ad1));
      }
      __syncthreads();

      // logits of the group += t (32 pixels x 64) . kp (64 x NP)
      const bf16* kt = Ks + buf * DCH * KLD;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int tile = warp + 8 * a;
        if (tile >= ntiles) break;
        const int mt = tile & 1, n16 = tile >> 1;
#pragma unroll
        for (int kk = 0; kk < DCH; kk += 16) {
          uint32_t af[4], bfr[4];
          ldsm_x4(af, Ts + mt * 16 * TLD + kk + ldsm_a_off(lane, TLD));
          ldsm_x4_trans(bfr, kt + kk * KLD + n16 * 16 + ldsm_b_off(lane, KLD));
          mma_16816(acc[a][0], af, bfr[0], bfr[1]);
          mma_16816(acc[a][1], af, bfr[2], bfr[3]);
        }
      }
      if (c + 1 < nch) continue;

      // the group's logits, f32; the later slabs add to the first one's
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int tile = warp + 8 * a;
        if (tile >= ntiles) break;
        const int mt = tile & 1, n16 = tile >> 1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = mt * 16 + (lane >> 2) + (e >> 1) * 8;
            const int j = n16 * 16 + h * 8 + 2 * (lane & 3) + (e & 1);
            if (j < n) {
              float* o = out + (((size_t)b * H4 + 4 * q + px / WS) * W4 + 4 * s0 + px % WS) * n + j;
              *o = ds0 == 0 ? acc[a][h][e] : *o + acc[a][h][e];
            }
          }
      }
    }
  }
}

}  // namespace

// x (B gh gw, CP) bf16 (the input channels zero-padded to CP % 8 == 0);
// wg (9 DP, CP) bf16: the conv kernel kc[k, l, c, d] at row (3 k + l) DP + d,
// zero-padded; kp (DP, NP) bf16 zero-padded, NP % 16 == 0 and <= 128; inv,
// addv (D,) f32; swb (4gw, 3, 3), shb (4gh, 3, 3) f32 bands; gm (B gh gw,
// 9 DP) bf16 scratch -> out (B, 4gh, 4gw, n) f32. Two launches: the shared
// GEMM (Gm) and the mix kernel. Every pointer 16-byte aligned.
extern "C" int mtt_head_up4_bf16(const void* x, const void* wg, const void* kp, const void* inv,
                                 const void* addv, const void* swb, const void* shb, void* gm,
                                 void* out, int B, int gh, int gw, int CP, int D, int DP, int n,
                                 int NP, void* stream) {
  if (B <= 0 || gh < 1 || gw % SW || CP % 8 || DP % 8 || D > DP || D < 1 || NP % 16 || NP > 128 ||
      n < 1 || n > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int e = mtt_gemm_bf16(x, wg, gm, nullptr, 0, nullptr, B * gh * gw, 9 * DP, CP, EPI_NONE, stream);
  if (e) return e;
  // the strips of all images side by side; the rows split into ranges only
  // as far as the blocks the card holds at once need
  // heads that fit one slab keep it (PASCAL's 352 channels: each row is
  // formed once); wider ones walk slabs of 192 channels, whose smaller ring
  // lets three blocks share an SM
  const int DS = DP <= DS_MAX ? DS_MAX : DS_MAX / 2;
  auto kernel = DS == DS_MAX ? head_up4_mix_kernel<2> : head_up4_mix_kernel<3>;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, MT, mix_smem(NP, gh, DS));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = gw / SW;
  int ranges = min(gh, max(1, sms * max(occ, 1) / (strips * B)));
  const int R = (gh + ranges - 1) / ranges;
  ranges = (gh + R - 1) / R;
  dim3 grid(strips, ranges, B);
  kernel<<<grid, MT, mix_smem(NP, R, DS), st>>>(
      static_cast<const bf16*>(gm), static_cast<const bf16*>(kp), static_cast<const float*>(inv),
      static_cast<const float*>(addv), static_cast<const float*>(swb),
      static_cast<const float*>(shb), static_cast<float*>(out), gh, gw, D, DP, n, NP, R, DS);
  return static_cast<int>(cudaGetLastError());
}
