// Transformer MLPs, bf16 in and out, one kernel in two variants:
//   LN_RES = true:  the pre-norm half-block out = x + fc2(gelu(fc1(LN(x)))),
//                   replacing mtt_tpu/kernels/mlp.py:_mlp_ln_res_kernel and its
//                   batch-blocked twin _mlp_ln_res_bb_kernel (every eval block);
//   LN_RES = false: out = fc2(gelu(fc1(x))), replacing mlp.py:_mlp_kernel
//                   (pallas_call at :142), which the training blocks with
//                   drop-path run after a separate LayerNorm.
// The batch blocking of the TPU kernels is a weight-streaming choice over the
// same function; rows are independent, so here the (B*N, C) rows are simply
// cut into blocks of 32. Widths: the ViT trunks (C = 1024, 768), the InvPT
// decoder stages (C = 576, 288, 144, whose hidden 576 ends in half a chunk)
// and, without LN, the Swin-B stages (C = 512, 256, 128; 1024 is shared).
//
// What bounds it on the H100: 138 GFLOP per ViT-L call (8232 rows, C=1024,
// hidden 4096) on the tensor cores, and the (8232, 4096) hidden activation,
// which would be 67 MB each way through device memory. The design keeps the
// hidden out of device memory: a block normalises its 32 rows once into shared
// memory (the variant without LN copies them), then walks the hidden dimension
// in chunks of 128 columns; each chunk is fc1 (wmma, f32), bias + A&S-erf GELU in f32, one bf16 rounding into shared
// memory, and fc2 accumulated into f32 fragments that stay in registers for the
// whole walk (each warp owns its share of the C/16 output column tiles). The
// weights are read from L2 straight into fragments; every block reads both weight matrices once, which is
// the traffic a 32-row block pays for keeping its accumulator on chip.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int MBM = 32;    // rows per block
constexpr int MHC = 128;   // hidden columns per chunk (16 per warp)
constexpr int MT = 256;    // 8 warps
constexpr int HFL = MHC + 4;
constexpr int HSL = MHC + 8;

template <int C>
constexpr int mlp_smem() {
  return MBM * (C + 8) * 2 + MBM * HFL * 4 + MBM * HSL * 2;
}

// The 16-wide output column tile that warp `warp` owns in slot jt: eight
// neighbouring tiles a warp when they divide evenly (the ViT trunks), else
// dealt in turn, with the slots past the last tile left idle.
template <int CT, int NCW>
__device__ __forceinline__ int warp_tile(int warp, int jt) {
  return CT % (MT / 32) == 0 ? warp * NCW + jt : warp + jt * (MT / 32);
}

// FULL: the hidden width is a multiple of the 128-column chunk, so no chunk
// is cut short and the guards for that compile out.
template <int C, bool LN_RES, bool FULL>
__global__ void __launch_bounds__(MT, 1) mlp_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ out, int M, int Hd, float eps) {
  constexpr int XL = C + 8;
  constexpr int CT = C / 16;                   // 16-wide output column tiles
  constexpr int NCW = (CT + MT / 32 - 1) / (MT / 32);  // tiles per warp
  constexpr bool EVEN = CT % (MT / 32) == 0;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XN = reinterpret_cast<bf16*>(smem);
  float* HF = reinterpret_cast<float*>(XN + MBM * XL);
  bf16* HS = reinterpret_cast<bf16*>(HF + MBM * HFL);

  const int m0 = blockIdx.x * MBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // LN(x) of the block's rows, rounded to bf16 once (mlp.py:293-298), or x
  for (int r = warp; r < MBM; r += MT / 32) {
    bf16* dst = XN + r * XL;
    if (m0 + r < M) {
      const bf16* src = x + (size_t)(m0 + r) * C;
      if (LN_RES) {
        ln_row_warp<(C + 255) / 256>(src, gamma, beta, dst, C, eps, lane);
      } else {
        for (int c = lane * 8; c < C; c += 256)
          *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(src + c);
      }
    } else {
      for (int c = lane * 8; c < C; c += 256) *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  FragC acc[2][NCW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NCW; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int j0 = 0; j0 < Hd; j0 += MHC) {
    // fc1: this warp's 16 hidden columns for all 32 rows (none past Hd, in
    // the last chunk of a hidden width that is not a multiple of 128)
    const int jn = FULL ? MHC : min(MHC, Hd - j0);
    {
      FragC h[2];
      wmma::fill_fragment(h[0], 0.f);
      wmma::fill_fragment(h[1], 0.f);
      if (FULL || 16 * warp < jn) {
        const bf16* wp = w1 + (size_t)(j0 + 16 * warp) * C;
#pragma unroll 4
        for (int k = 0; k < C; k += 16) {
          FragBt bt;
          FragA a0, a1;
          wmma::load_matrix_sync(bt, wp + k, C);
          wmma::load_matrix_sync(a0, XN + k, XL);
          wmma::load_matrix_sync(a1, XN + 16 * XL + k, XL);
          wmma::mma_sync(h[0], a0, bt, h[0]);
          wmma::mma_sync(h[1], a1, bt, h[1]);
        }
      }
      wmma::store_matrix_sync(HF + 16 * warp, h[0], HFL, wmma::mem_row_major);
      wmma::store_matrix_sync(HF + 16 * HFL + 16 * warp, h[1], HFL, wmma::mem_row_major);
    }
    __syncthreads();
    // bias + GELU in f32, cast once before fc2 (mlp.py:303)
    for (int i = threadIdx.x; i < MBM * (MHC / 8); i += MT) {
      const int r = i / (MHC / 8), c = (i % (MHC / 8)) * 8;
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        f[k] = (FULL || c < jn) ? gelu_erf_poly(HF[r * HFL + c + k] + b1[j0 + c + k]) : 0.f;
      *reinterpret_cast<uint4*>(HS + r * HSL + c) = pack8(f);
    }
    __syncthreads();
    // fc2: accumulate this chunk into the warp's output columns
#pragma unroll
    for (int kk = 0; kk < MHC; kk += 16) {
      if (!FULL && kk >= jn) break;
      FragA a0, a1;
      wmma::load_matrix_sync(a0, HS + kk, HSL);
      wmma::load_matrix_sync(a1, HS + 16 * HSL + kk, HSL);
#pragma unroll
      for (int jt = 0; jt < NCW; ++jt) {
        const int tile = warp_tile<CT, NCW>(warp, jt);
        if (EVEN || tile < CT) {
          FragBt bt;
          wmma::load_matrix_sync(bt, w2 + (size_t)(tile * 16) * Hd + j0 + kk, Hd);
          wmma::mma_sync(acc[0][jt], a0, bt, acc[0][jt]);
          wmma::mma_sync(acc[1][jt], a1, bt, acc[1][jt]);
        }
      }
    }
  }
  __syncthreads();

  // epilogue: acc + b2 (+ x) in f32, one bf16 rounding (mlp.py:309-310, :105)
  float* scratch = HF + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jt = 0; jt < NCW; ++jt) {
      const int tile = warp_tile<CT, NCW>(warp, jt);
      if (!EVEN && tile >= CT) break;   // the same for every lane of the warp
      float v[8];
      frag_row8(acc[i][jt], scratch, lane, v);
      const int row = m0 + i * 16 + (lane >> 1);
      const int col = tile * 16 + (lane & 1) * 8;
      if (row < M) {
        float xr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (LN_RES) unpack8(*reinterpret_cast<const uint4*>(x + (size_t)row * C + col), xr);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = v[k] + b2[col + k] + xr[k];
        *reinterpret_cast<uint4*>(out + (size_t)row * C + col) = pack8(v);
      }
    }
}

template <int C, bool LN_RES, bool FULL>
int launch_mlp_full(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int M, int Hd, float eps, cudaStream_t st) {
  constexpr int smem = mlp_smem<C>();
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(mlp_kernel<C, LN_RES, FULL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + MBM - 1) / MBM);
  mlp_kernel<C, LN_RES, FULL><<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, Hd, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool LN_RES>
int launch_mlp(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int M, int Hd, float eps, cudaStream_t st) {
  return Hd % MHC == 0
             ? launch_mlp_full<C, LN_RES, true>(x, gamma, beta, w1, b1, w2, b2, out, M, Hd, eps, st)
             : launch_mlp_full<C, LN_RES, false>(x, gamma, beta, w1, b1, w2, b2, out, M, Hd, eps, st);
}

}  // namespace

// x (M, C) bf16; w1 (Hd, C), w2 (C, Hd) bf16 as nn.Linear stores them; gamma,
// beta, b1, b2 f32. C is 1024, 768, 576, 288 or 144; Hd % 16 == 0.
extern "C" int mtt_mlp_ln_res_bf16(const void* x, const void* gamma, const void* beta, const void* w1,
                                   const void* b1, const void* w2, const void* b2, void* out, int M,
                                   int C, int Hd, float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Hd % 16 || Hd < 16) return static_cast<int>(cudaErrorInvalidValue);
#define MTT_MLP_CASE(W) \
  if (C == W) return launch_mlp<W, true>(x, gamma, beta, w1, b1, w2, b2, out, M, Hd, eps, st);
  MTT_MLP_CASE(1024) MTT_MLP_CASE(768) MTT_MLP_CASE(576) MTT_MLP_CASE(288) MTT_MLP_CASE(144)
#undef MTT_MLP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same without LN and residual: out = fc2(gelu(fc1(x))). C may also be 512,
// 256 or 128, the Swin-B stage widths (8, 16 and 32 column tiles: 1, 2 and 4 a
// warp); their row counts run from 73,728 down to the 3 prompt rows, which
// one block takes with 29 of its 32 rows zero-filled and never stored.
extern "C" int mtt_mlp_fc_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int M, int C, int Hd, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Hd % 16 || Hd < 16) return static_cast<int>(cudaErrorInvalidValue);
#define MTT_MLP_CASE(W) \
  if (C == W) return launch_mlp<W, false>(x, nullptr, nullptr, w1, b1, w2, b2, out, M, Hd, 0.f, st);
  MTT_MLP_CASE(1024) MTT_MLP_CASE(768) MTT_MLP_CASE(576) MTT_MLP_CASE(288) MTT_MLP_CASE(144)
  MTT_MLP_CASE(512) MTT_MLP_CASE(256) MTT_MLP_CASE(128)   // the Swin-B stages
#undef MTT_MLP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
