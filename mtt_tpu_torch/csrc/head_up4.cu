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
// n <= 21) it is about 18 GFLOP of channel contraction on the tensor cores
// plus 6 GFMA of spatial mixing on the CUDA cores, against 5.7 MB of input
// and 11 MB of logits: the work, not the bytes, bounds it. What it must avoid
// is the (8, 128, 128, 350) upsampled map, 92 MB in bf16 per task.
//
// Design: one block per (image, low-res row q, segment of 32 low-res columns,
// chunk of 32 logits); the block owns output rows 4q..4q+3 and 128 output
// columns, and keeps their f32 logits in wmma fragments for the whole walk over
// the output channels (chunks of 32). The block stages the three input rows
// q-1..q+1 it needs in shared memory once; per channel chunk it recomputes
// their Gm rows (wmma, f32 accumulation, one bf16 rounding), mixes width then
// height on the CUDA cores (each thread one (column, channel) pair: 81 + 36
// FMAs for 4 outputs), applies the affine and the GELU, rounds to bf16 and
// adds the chunk's 1x1 product into the fragments. Only the logits reach
// device memory. The TPU kernel sums the per-chunk logits in bf16 for its
// VMEM budget; this one keeps them in f32. Neighbouring blocks recompute each
// Gm row three times (54 GFLOP at main-path shapes) rather than exchange it.
//
// Wide inputs: the staged strip is 112 x (C + 8) bf16, 174 KB at NYUD's
// C = 768, which leaves no room for the rest. Where the strip and the
// per-chunk buffers do not fit in the 227 KB of shared memory (C > 512), the
// kernel runs its streamed form: per chunk of 32 output channels it walks the
// input channels in slices of 128 (two slice buffers, the next one loading
// while the current one is multiplied) and accumulates Gm in f32 in shared
// memory, rounding it to bf16 after the last slice. The sums run in the same
// order as in the resident form, so both give the same bits; the streamed form
// reads the strip from L2 once per chunk of output channels instead of once.
#include <type_traits>

#include "common.cuh"

using namespace mtt;

namespace {

constexpr int HT = 256;               // 8 warps
constexpr int DC = 32;                // output channels per chunk
constexpr int NC = 32;                // logits per block
constexpr int SEG = 32;               // low-res columns per block
constexpr int W4S = 4 * SEG;          // 128 output columns per block
constexpr int GROWS = 3 * (SEG + 2);  // staged (row, column) pairs
constexpr int GROWS_P = 112;          // padded to whole 16-row tiles
constexpr int GRT = GROWS_P / 16;     // 7 row tiles
constexpr int GCOLS = 9 * DC;         // (k, l, d) columns of one chunk's Gm
constexpr int GLDS = GCOLS + 8;
constexpr int TPIX = 4 * W4S;         // 512 output pixels per block
constexpr int TLD = DC + 8;
constexpr int KLD = NC + 8;

constexpr int KC = 128;               // input channels per streamed slice
constexpr int XCLD = KC + 8;
constexpr int kSmemMax = 232448;
constexpr int TS_BYTES = TPIX * TLD * 2;
// the streamed form's Ts and its two input slices share one region
constexpr int UNION_BYTES =
    TS_BYTES > 2 * GROWS_P * XCLD * 2 ? TS_BYTES : 2 * GROWS_P * XCLD * 2;
constexpr int TAIL_BYTES = DC * KLD * 2 + (W4S * 9 + 36 + 2 * DC) * 4;

__host__ __device__ constexpr int head_smem(int CP, bool stream) {
  return stream ? GROWS_P * GLDS * 4 + UNION_BYTES + TAIL_BYTES
                : GROWS_P * (CP + 8) * 2 + GROWS_P * GLDS * 2 + TS_BYTES + TAIL_BYTES;
}

__device__ __forceinline__ float ld_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld_f(const float* p) { return *p; }

// STREAM false: the resident form (the strip staged once); true: the streamed
// form (input slices per chunk, Gm accumulated in f32 in shared memory).
template <bool STREAM>
__global__ void __launch_bounds__(HT, 1) head_up4_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wf, const float* __restrict__ swb,
    const float* __restrict__ shb, const float* __restrict__ inv, const float* __restrict__ addv,
    const bf16* __restrict__ kp, float* __restrict__ out, int gh, int gw, int CP, int DP, int n,
    int NP) {
  using GT = typename std::conditional<STREAM, float, bf16>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int XLD = STREAM ? XCLD : CP + 8;
  unsigned char* sp = smem;
  bf16 *Xs, *Ts;
  GT* Gs;
  if (STREAM) {
    Gs = reinterpret_cast<GT*>(sp);
    Ts = Xs = reinterpret_cast<bf16*>(sp + GROWS_P * GLDS * sizeof(GT));
    sp += GROWS_P * GLDS * sizeof(GT) + UNION_BYTES;
  } else {
    Xs = reinterpret_cast<bf16*>(sp);
    Gs = reinterpret_cast<GT*>(Xs + GROWS_P * XLD);
    Ts = reinterpret_cast<bf16*>(Gs + GROWS_P * GLDS);
    sp = reinterpret_cast<unsigned char*>(Ts + TPIX * TLD);
  }
  bf16* Ks = reinterpret_cast<bf16*>(sp);
  float* SWs = reinterpret_cast<float*>(Ks + DC * KLD);
  float* SHs = SWs + W4S * 9;
  float* IVs = SHs + 36;
  float* ADs = IVs + DC;

  const int nchunks = NP / NC;
  const int seg = blockIdx.x, q = blockIdx.y;
  const int b = blockIdx.z / nchunks, nc = blockIdx.z % nchunks;
  const int s0 = seg * SEG, W0 = 4 * s0;
  const int H4 = 4 * gh, W4 = 4 * gw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // input rows q-1..q+1, columns s0-1..s0+SEG, channels c0..c0+w; zero
  // outside the map
  auto stage = [&](bf16* dst, int c0, int w) {
    const int CH = w / 8;
    for (int i = threadIdx.x; i < GROWS_P * CH; i += HT) {
      const int row = i / CH, c = (i % CH) * 8;
      const int hh = q + row / (SEG + 2) - 1, ww = s0 + row % (SEG + 2) - 1;
      const bool ok = row < GROWS && hh >= 0 && hh < gh && ww >= 0 && ww < gw;
      cp_async16(dst + row * XLD + c,
                 ok ? x + (((size_t)b * gh + hh) * gw + ww) * CP + c0 + c : x, ok);
    }
    cp_async_commit();
  };
  if (!STREAM) stage(Xs, 0, CP);
  for (int i = threadIdx.x; i < W4S * 9; i += HT) {
    const int W = W0 + i / 9;
    SWs[i] = W < W4 ? swb[(size_t)W * 9 + i % 9] : 0.f;
  }
  if (threadIdx.x < 36) SHs[threadIdx.x] = shb[(size_t)q * 36 + threadIdx.x];
  cp_async_wait<0>();
  __syncthreads();

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
  float* scratch = reinterpret_cast<float*>(Ts) + warp * 256;

  for (int d0 = 0; d0 < DP; d0 += DC) {
    // Gm of the staged rows for this chunk: (GROWS_P x CP) @ (CP x 9*DC)
    const bf16* wj = wf + (size_t)(d0 / DC) * CP * GCOLS;
    if (!STREAM) {
      for (int ct = warp; ct < GCOLS / 16; ct += HT / 32) {
        FragC gm[GRT];
#pragma unroll
        for (int rt = 0; rt < GRT; ++rt) wmma::fill_fragment(gm[rt], 0.f);
        for (int k = 0; k < CP; k += 16) {
          FragB bw;
          wmma::load_matrix_sync(bw, wj + (size_t)k * GCOLS + ct * 16, GCOLS);
#pragma unroll
          for (int rt = 0; rt < GRT; ++rt) {
            FragA a;
            wmma::load_matrix_sync(a, Xs + rt * 16 * XLD + k, XLD);
            wmma::mma_sync(gm[rt], a, bw, gm[rt]);
          }
        }
#pragma unroll
        for (int rt = 0; rt < GRT; ++rt) {
          float v[8];
          frag_row8(gm[rt], scratch, lane, v);
          *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(Gs) +
                                    (rt * 16 + (lane >> 1)) * GLDS + ct * 16 + (lane & 1) * 8) =
              pack8(v);
        }
      }
    } else {
      // input slices of KC channels through two buffers; Gm accumulates in
      // f32 in Gs and is rounded to bf16 after the last slice
      const int nkc = (CP + KC - 1) / KC;
      stage(Xs, 0, min(KC, CP));
      for (int kc = 0; kc < nkc; ++kc) {
        const int c0 = kc * KC, w = min(KC, CP - c0);
        if (kc + 1 < nkc) {
          stage(Xs + ((kc + 1) & 1) * GROWS_P * XCLD, c0 + KC, min(KC, CP - c0 - KC));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* Xc = Xs + (kc & 1) * GROWS_P * XCLD;
        float* G32 = reinterpret_cast<float*>(Gs);
        for (int ct = warp; ct < GCOLS / 16; ct += HT / 32) {
          FragC gm[GRT];
#pragma unroll
          for (int rt = 0; rt < GRT; ++rt) {
            if (kc == 0)
              wmma::fill_fragment(gm[rt], 0.f);
            else
              wmma::load_matrix_sync(gm[rt], G32 + rt * 16 * GLDS + ct * 16, GLDS,
                                     wmma::mem_row_major);
          }
          for (int k = 0; k < w; k += 16) {
            FragB bw;
            wmma::load_matrix_sync(bw, wj + (size_t)(c0 + k) * GCOLS + ct * 16, GCOLS);
#pragma unroll
            for (int rt = 0; rt < GRT; ++rt) {
              FragA a;
              wmma::load_matrix_sync(a, Xc + rt * 16 * XCLD + k, XCLD);
              wmma::mma_sync(gm[rt], a, bw, gm[rt]);
            }
          }
#pragma unroll
          for (int rt = 0; rt < GRT; ++rt) {
            if (kc == nkc - 1)
              for (int e = 0; e < gm[rt].num_elements; ++e)
                gm[rt].x[e] = __bfloat162float(__float2bfloat16(gm[rt].x[e]));
            wmma::store_matrix_sync(G32 + rt * 16 * GLDS + ct * 16, gm[rt], GLDS,
                                    wmma::mem_row_major);
          }
        }
        __syncthreads();  // this slice buffer is refilled two slices on
      }
    }
    for (int i = threadIdx.x; i < DC * NC / 8; i += HT) {
      const int r = i / (NC / 8), c = (i % (NC / 8)) * 8;
      *reinterpret_cast<uint4*>(Ks + r * KLD + c) =
          *reinterpret_cast<const uint4*>(kp + (size_t)(d0 + r) * NP + nc * NC + c);
    }
    if (threadIdx.x < DC) {
      IVs[threadIdx.x] = inv[d0 + threadIdx.x];
      ADs[threadIdx.x] = addv[d0 + threadIdx.x];
    }
    __syncthreads();

    // width mix (rounded to bf16), height mix, affine and GELU in f32
    {
      const int d = lane;  // DC == 32
      const float iv = IVs[d], ad = ADs[d];
      for (int W = warp; W < W4S; W += HT / 32) {
        const float* sw = SWs + W * 9;  // [l][dw], dw = column s-1, s, s+1
        float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 3; ++r) {   // input row q + r - 1
          const GT* gr = Gs + (r * (SEG + 2) + (W >> 2)) * GLDS + d;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float m = 0.f;
#pragma unroll
            for (int l = 0; l < 3; ++l)
#pragma unroll
              for (int dw = 0; dw < 3; ++dw)
                m += sw[l * 3 + dw] * ld_f(gr + dw * GLDS + (k * 3 + l) * DC);
            m = __bfloat162float(__float2bfloat16(m));
#pragma unroll
            for (int p = 0; p < 4; ++p) y[p] += SHs[p * 9 + k * 3 + r] * m;
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          Ts[(p * W4S + W) * TLD + d] = __float2bfloat16(gelu_erf_poly_fast(y[p] * iv + ad));
      }
    }
    __syncthreads();

    // 1x1: the warp's 64 pixels x NC logits += T (pixels x DC) @ kp (DC x NC)
#pragma unroll
    for (int kk = 0; kk < DC; kk += 16) {
      FragB bk0, bk1;
      wmma::load_matrix_sync(bk0, Ks + kk * KLD, KLD);
      wmma::load_matrix_sync(bk1, Ks + kk * KLD + 16, KLD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA a;
        wmma::load_matrix_sync(a, Ts + (warp * 64 + i * 16) * TLD + kk, TLD);
        wmma::mma_sync(acc[i][0], a, bk0, acc[i][0]);
        wmma::mma_sync(acc[i][1], a, bk1, acc[i][1]);
      }
    }
    __syncthreads();
  }

  // f32 logits of the block's pixels; columns past 4gw and logits past n masked
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      float v[8];
      frag_row8(acc[i][jt], scratch, lane, v);
      const int pix = warp * 64 + i * 16 + (lane >> 1);
      const int W = W0 + pix % W4S;
      const int j0 = nc * NC + jt * 16 + (lane & 1) * 8;
      if (W < W4) {
        float* dst = out + (((size_t)b * H4 + 4 * q + pix / W4S) * W4 + W) * n;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (j0 + k < n) dst[j0 + k] = v[k];
      }
    }
}

}  // namespace

// x (B, gh, gw, CP) bf16 with the channels zero-padded to CP (% 16);
// wf (DP/32, CP, 3, 3, 32) bf16: the conv kernel kc[k, l, c, d] per chunk of
// 32 output channels, zero-padded to DP; swb (4gw, 3, 3), shb (4gh, 3, 3) f32:
// the bands of the shifted upsample matrices; inv, addv (DP,) f32;
// kp (DP, NP) bf16 with NP % 32 == 0 -> out (B, 4gh, 4gw, n) f32.
extern "C" int mtt_head_up4_bf16(const void* x, const void* wf, const void* swb, const void* shb,
                                 const void* inv, const void* addv, const void* kp, void* out,
                                 int B, int gh, int gw, int CP, int DP, int n, void* stream) {
  if (CP % 16 || DP % DC || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int NP = (n + NC - 1) / NC * NC;
  const bool stream_in = head_smem(CP, false) > kSmemMax;
  const int smem = head_smem(CP, stream_in);
  auto kernel = stream_in ? head_up4_kernel<true> : head_up4_kernel<false>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((gw + SEG - 1) / SEG, gh, B * (NP / NC));
  kernel<<<grid, HT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wf), static_cast<const float*>(swb),
      static_cast<const float*>(shb), static_cast<const float*>(inv),
      static_cast<const float*>(addv), static_cast<const bf16*>(kp), static_cast<float*>(out), gh,
      gw, CP, DP, n, NP);
  return static_cast<int>(cudaGetLastError());
}
