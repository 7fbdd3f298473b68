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
// Design (csrc/head_up4.cu with three scales): one block owns 8 output rows x
// 32 output columns of one image and walks the output channels in chunks of
// 32. Per chunk it stages the low-res rows and columns it needs with a halo
// of one (18, 40 and 108 pixels of the three scales) in shared memory, takes
// their Gm with wmma (the chunk's weights straight from L2, the two small
// scales in one pass and the large one in a second, which is staged while the
// first is mixed), and mixes width then height on the CUDA cores: each thread
// owns 4 (column, channel) pairs and keeps their 8 output rows in f32 registers
// across the three scales. Then the affine and the ReLU; without the head the chunk is stored, with it the chunk is rounded
// to bf16 and its 1x1 product added into f32 wmma fragments that live through
// the whole walk (a CUDA block cannot carry a sum to another block, so one
// block owns its pixels for all channels, where the TPU kernel accumulates
// over a sequential grid axis). The halo makes neighbouring blocks recompute
// Gm rows: 2.1x the minimal contraction at these shapes, padding included.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int TT = 256;               // 8 warps
constexpr int TDC = 32;               // output channels per chunk
constexpr int TNC = 32;               // logits per block
constexpr int TRS = 8;                // output rows per block
constexpr int TWS = 32;               // output columns per block
constexpr int TGROWS = 112;           // staged pixels, padded to 16-row tiles
constexpr int TGCOLS = 9 * TDC;       // (k, l, d) columns of one chunk's Gm
constexpr int TGLDS = TGCOLS + 8;
constexpr int TPIX = TRS * TWS;       // 256 output pixels per block
constexpr int TTLD = TDC + 8;
constexpr int TKLD = TNC + 8;
constexpr int TSH = TRS * 3 * 6;      // dense height table of one scale

__host__ __device__ constexpr int tail_ts_bytes(bool head) {
  return head ? TPIX * TTLD * 2 : (TT / 32) * 256 * 4;
}

__host__ __device__ constexpr int tail_smem(int CP, bool head) {
  return TGROWS * (CP + 8) * 2 + TGROWS * TGLDS * 2 + tail_ts_bytes(head) + TDC * TKLD * 2 +
         (3 * TWS * 9 + 3 * TSH + 2 * TDC) * 4;
}

// Geometry of one scale's staged pixels: the low-res rows and columns the
// block's 8 x 32 outputs draw on, with a halo of one.
template <int F>
struct Halo {
  static constexpr int R = TRS / F + 2;    // staged rows
  static constexpr int CN = TWS / F + 2;   // staged columns
  static constexpr int PX = R * CN;
};
constexpr int TPX01 = Halo<8>::PX + Halo<4>::PX;   // scales 0 and 1 share a pass

// Stages scale F's pixels (rows q0-1.., columns c0-1..) into Xs from row
// `base`; zero outside the map. The caller commits and waits.
template <int F>
__device__ __forceinline__ void stage_scale(const bf16* __restrict__ x, int gh, int gw, int CP,
                                            int b, int strip, int seg, bf16* Xs, int base) {
  using G = Halo<F>;
  const int XLD = CP + 8, CH = CP / 8;
  const int q0 = strip * (TRS / F), c0 = seg * (TWS / F);
  for (int i = threadIdx.x; i < G::PX * CH; i += TT) {
    const int row = i / CH, c = (i % CH) * 8;
    const int hh = q0 + row / G::CN - 1, ww = c0 + row % G::CN - 1;
    const bool ok = hh >= 0 && hh < gh && ww >= 0 && ww < gw;
    cp_async16(Xs + (base + row) * XLD + c,
               ok ? x + (((size_t)b * gh + hh) * gw + ww) * CP + c : x, ok);
  }
}

// Zero-fills the staged rows [from, to): the padding up to whole 16-row tiles.
__device__ __forceinline__ void stage_zero(bf16* Xs, int CP, int from, int to) {
  const int XLD = CP + 8, CH = CP / 8;
  for (int i = threadIdx.x; i < (to - from) * CH; i += TT)
    *reinterpret_cast<uint4*>(Xs + (from + i / CH) * XLD + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
}

// Gm of the RT*16 staged pixel rows for this chunk: (RT*16 x CP) @ (CP x 9*TDC),
// rounded to bf16 into Gs. The chunk's weights come straight from L2, stored
// (column, c) so that a fragment's pairs along c are single 32-bit loads,
// four k-steps' fragments in flight at a time to cover the latency.
template <int RT>
__device__ __forceinline__ void gm_pass(const bf16* __restrict__ wj, int CP, const bf16* Xs,
                                        bf16* Gs, float* scratch) {
  constexpr int KU = 4;
  const int XLD = CP + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ct = warp; ct < TGCOLS / 16; ct += TT / 32) {
    FragC gm[RT];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(gm[rt], 0.f);
    for (int k0 = 0; k0 < CP; k0 += 16 * KU) {
      FragBt bw[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u)
        if (k0 + 16 * u < CP)
          wmma::load_matrix_sync(bw[u], wj + (size_t)(ct * 16) * CP + k0 + 16 * u, CP);
#pragma unroll
      for (int u = 0; u < KU; ++u)
        if (k0 + 16 * u < CP) {
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            FragA a;
            wmma::load_matrix_sync(a, Xs + rt * 16 * XLD + k0 + 16 * u, XLD);
            wmma::mma_sync(gm[rt], a, bw[u], gm[rt]);
          }
        }
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float v[8];
      frag_row8(gm[rt], scratch, lane, v);
      *reinterpret_cast<uint4*>(Gs + (rt * 16 + (lane >> 1)) * TGLDS + ct * 16 + (lane & 1) * 8) =
          pack8(v);
    }
  }
}

// Scale F's width mix (rounded to bf16) and height mix (into the f32
// registers) from its Gm rows, which start at row `base` of Gs.
template <int F>
__device__ __forceinline__ void mix_scale(const bf16* Gs, int base, int seg, const float* SWs,
                                          const float* SHs, float (&y)[4][TRS]) {
  using G = Halo<F>;
  const int warp = threadIdx.x >> 5, d = threadIdx.x & 31;   // TDC == 32
  const int c0 = seg * (TWS / F);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int Wl = warp + j * (TT / 32);
    float sw[9];                          // [l][dw], dw = column W/F - 1, W/F, W/F + 1
#pragma unroll
    for (int i = 0; i < 9; ++i) sw[i] = SWs[Wl * 9 + i];
    const int cs = (seg * TWS + Wl) / F - c0;
#pragma unroll
    for (int r = 0; r < G::R; ++r) {
      const bf16* gr = Gs + (base + r * G::CN + cs) * TGLDS + d;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float m = 0.f;
#pragma unroll
        for (int l = 0; l < 3; ++l)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            m += sw[l * 3 + dw] * __bfloat162float(gr[dw * TGLDS + (k * 3 + l) * TDC]);
        m = __bfloat162float(__float2bfloat16(m));
#pragma unroll
        for (int p = 0; p < TRS; ++p) y[j][p] += SHs[(p * 3 + k) * 6 + r] * m;
      }
    }
  }
}

template <bool HEAD>
__global__ void __launch_bounds__(TT, 1) invpt_tail_kernel(
    const bf16* __restrict__ x0, const bf16* __restrict__ x1, const bf16* __restrict__ x2,
    const bf16* __restrict__ wf, const float* __restrict__ sw0, const float* __restrict__ sh0,
    const float* __restrict__ sw1, const float* __restrict__ sh1, const float* __restrict__ sw2,
    const float* __restrict__ sh2, const float* __restrict__ inv, const float* __restrict__ addv,
    const bf16* __restrict__ wh, const float* __restrict__ bh, void* __restrict__ out_, int th,
    int tw, int CP, int DP, int D, int n, int NP) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int XLD = CP + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Xs + TGROWS * XLD;
  bf16* Ts = Gs + TGROWS * TGLDS;
  bf16* Ks = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Ts) + tail_ts_bytes(HEAD));
  float* SWs = reinterpret_cast<float*>(Ks + TDC * TKLD);   // [scale][Wl][l][dw]
  float* SHs = SWs + 3 * TWS * 9;                            // [scale][p][k][r]
  float* IVs = SHs + 3 * TSH;
  float* ADs = IVs + TDC;

  const int nchunks = HEAD ? NP / TNC : 1;
  const int seg = blockIdx.x, strip = blockIdx.y;
  const int b = blockIdx.z / nchunks, nc = blockIdx.z % nchunks;
  const int W0 = seg * TWS, H0 = strip * TRS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the block's slices of the three scales' width bands and dense height tables
  for (int i = threadIdx.x; i < 3 * TWS * 9; i += TT) {
    const int s = i / (TWS * 9), W = W0 + (i / 9) % TWS;
    const float* swb = s == 0 ? sw0 : (s == 1 ? sw1 : sw2);
    SWs[i] = W < tw ? swb[(size_t)W * 9 + i % 9] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * TSH; i += TT) {
    const int s = i / TSH, p = (i / 18) % TRS, k = (i / 6) % 3, r = i % 6;
    const int f = 8 >> s;
    const float* shb = s == 0 ? sh0 : (s == 1 ? sh1 : sh2);
    const int H = H0 + p;
    const int dr = r - (H / f - strip * (TRS / f));   // staged row r is low-res row q0 - 1 + r
    SHs[i] = (dr >= 0 && dr < 3) ? shb[((size_t)H * 3 + k) * 3 + dr] : 0.f;
  }
  __syncthreads();

  FragC acc[2][2];
  if (HEAD) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::fill_fragment(acc[i][0], 0.f);
      wmma::fill_fragment(acc[i][1], 0.f);
    }
  }
  float* scratch = reinterpret_cast<float*>(Ts) + warp * 256;

  for (int d0 = 0; d0 < DP; d0 += TDC) {
    const bf16* wj = wf + (size_t)(d0 / TDC) * CP * TGCOLS;
    if (threadIdx.x < TDC) {
      IVs[threadIdx.x] = inv[d0 + threadIdx.x];
      ADs[threadIdx.x] = addv[d0 + threadIdx.x];
    }
    if (HEAD) {
      for (int i = threadIdx.x; i < TDC * TNC / 8; i += TT) {
        const int r = i / (TNC / 8), c = (i % (TNC / 8)) * 8;
        *reinterpret_cast<uint4*>(Ks + r * TKLD + c) =
            *reinterpret_cast<const uint4*>(wh + (size_t)(d0 + r) * NP + nc * TNC + c);
      }
    }
    float y[4][TRS];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < TRS; ++p) y[j][p] = 0.f;

    // scales 0 and 1 in one pass over the chunk's weights, scale 2 in a second
    stage_scale<8>(x0, th / 8, tw / 8, CP, b, strip, seg, Xs, 0);
    stage_scale<4>(x1, th / 4, tw / 4, CP, b, strip, seg, Xs, Halo<8>::PX);
    cp_async_commit();
    stage_zero(Xs, CP, TPX01, (TPX01 + 15) / 16 * 16);
    cp_async_wait<0>();
    __syncthreads();
    gm_pass<(TPX01 + 15) / 16>(wj, CP, Xs, Gs, scratch);
    __syncthreads();
    stage_scale<2>(x2, th / 2, tw / 2, CP, b, strip, seg, Xs, 0);   // in flight under the mix
    cp_async_commit();
    stage_zero(Xs, CP, Halo<2>::PX, TGROWS);
    mix_scale<8>(Gs, 0, seg, SWs, SHs, y);
    mix_scale<4>(Gs, Halo<8>::PX, seg, SWs + TWS * 9, SHs + TSH, y);
    cp_async_wait<0>();
    __syncthreads();
    gm_pass<TGROWS / 16>(wj, CP, Xs, Gs, scratch);
    __syncthreads();
    mix_scale<2>(Gs, 0, seg, SWs + 2 * TWS * 9, SHs + 2 * TSH, y);
    __syncthreads();

    // affine and ReLU in f32, one bf16 rounding
    const int d = lane;
    const float iv = IVs[d], ad = ADs[d];
    if (HEAD) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int Wl = warp + j * (TT / 32);
#pragma unroll
        for (int p = 0; p < TRS; ++p)
          Ts[(p * TWS + Wl) * TTLD + d] = __float2bfloat16(fmaxf(y[j][p] * iv + ad, 0.f));
      }
      __syncthreads();
      // 1x1: the warp's output row (32 pixels) x TNC logits += T @ wh chunk
#pragma unroll
      for (int kk = 0; kk < TDC; kk += 16) {
        FragB bk0, bk1;
        wmma::load_matrix_sync(bk0, Ks + kk * TKLD, TKLD);
        wmma::load_matrix_sync(bk1, Ks + kk * TKLD + 16, TKLD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          FragA a;
          wmma::load_matrix_sync(a, Ts + (warp * 32 + i * 16) * TTLD + kk, TTLD);
          wmma::mma_sync(acc[i][0], a, bk0, acc[i][0]);
          wmma::mma_sync(acc[i][1], a, bk1, acc[i][1]);
        }
      }
      __syncthreads();
    } else {
      bf16* out = static_cast<bf16*>(out_);
      if (d0 + d < D) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int W = W0 + warp + j * (TT / 32);
          if (W < tw) {
#pragma unroll
            for (int p = 0; p < TRS; ++p)
              out[(((size_t)b * th + H0 + p) * tw + W) * D + d0 + d] =
                  __float2bfloat16(fmaxf(y[j][p] * iv + ad, 0.f));
          }
        }
      }
      __syncthreads();   // IVs/ADs are rewritten by the next chunk
    }
  }

  if (HEAD) {
    // f32 logits + bias; columns past tw and logits past n masked
    float* out = static_cast<float*>(out_);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        float v[8];
        frag_row8(acc[i][jt], scratch, lane, v);
        const int W = W0 + i * 16 + (lane >> 1);
        const int j0 = nc * TNC + jt * 16 + (lane & 1) * 8;
        if (W < tw) {
          float* dst = out + (((size_t)b * th + H0 + warp) * tw + W) * n;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (j0 + k < n) dst[j0 + k] = v[k] + bh[j0 + k];
        }
      }
  }
}

}  // namespace

// x0, x1, x2 (B, th/f, tw/f, CP) bf16 for f = 8, 4, 2 with the channels
// zero-padded to CP (% 16); wf (DP/32, 3, 3, 32, CP) bf16: the conv kernel
// kc[k, l, c, d] per chunk of 32 output channels d, zero-padded to DP; sw_s
// (tw, 3, 3), sh_s (th, 3, 3) f32: the bands of each scale's shifted upsample
// matrices; inv, addv (DP,) f32. With n == 0: out (B, th, tw, D) bf16. With
// n > 0: wh (DP, NP) bf16, bh (NP,) f32, NP % 32 == 0 -> out (B, th, tw, n) f32.
extern "C" int mtt_invpt_tail_bf16(const void* x0, const void* x1, const void* x2, const void* wf,
                                   const void* sw0, const void* sh0, const void* sw1,
                                   const void* sh1, const void* sw2, const void* sh2,
                                   const void* inv, const void* addv, const void* wh,
                                   const void* bh, void* out, int B, int th, int tw, int CP, int DP,
                                   int D, int n, void* stream) {
  if (CP % 16 || DP % TDC || th % 8 || tw % 8 || n < 0 || D > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool head = n > 0;
  const int NP = (n + TNC - 1) / TNC * TNC;
  const int smem = tail_smem(CP, head);
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid((tw + TWS - 1) / TWS, th / TRS, B * (head ? NP / TNC : 1));
  auto launch = [&](auto kernel) {
    // set on every launch: the attribute belongs to the current device's context
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, TT, smem, st>>>(
        static_cast<const bf16*>(x0), static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
        static_cast<const bf16*>(wf), static_cast<const float*>(sw0),
        static_cast<const float*>(sh0), static_cast<const float*>(sw1),
        static_cast<const float*>(sh1), static_cast<const float*>(sw2),
        static_cast<const float*>(sh2), static_cast<const float*>(inv),
        static_cast<const float*>(addv), static_cast<const bf16*>(wh),
        static_cast<const float*>(bh), out, th, tw, CP, DP, D, n, NP);
    return static_cast<int>(cudaGetLastError());
  };
  return head ? launch(invpt_tail_kernel<true>) : launch(invpt_tail_kernel<false>);
}
