// TaskPrompter per-task feature decode with the first fuse projection folded in.
//
// Replaces mtt_tpu/kernels/task_decode.py:_decode_kernel. For every task t:
//   f_t  = (x * expand(a_t) + x) @ ws_t + bs_t        (spatial pathway)
//   fc_t = (x * cw_t + x) @ wc_t + bc_t                (channel pathway)
//   y_t  = [f_t ; fc_t] @ wf_t + bf_t                  (first 1x1 fuse)
// written as one (B, S, T * F) tensor, task-major.
//
// What bounds it on the H100: at ViT-L PASCAL shapes (B=8, S=1024, C=1024, T=5,
// tar=300, F=350) it is 68 GFLOP of tensor-core work per call, while the XLA
// composition would move two (B, S, T, C) scaled inputs (84 MB each) and the
// (B, S, T, 2 tar) concat through device memory. Here one block owns 32 rows of
// one batch item: x is read once into shared memory, the scaled inputs are
// built there (the head-group expand of a_t is an index c / (C / G), not a 0/1
// matmul), f_t and fc_t are rounded to bf16 into shared memory, and only y_t
// reaches device memory. The weights are read from L2 straight into wmma
// fragments. tar and F are not multiples of 16: the wrapper pads the weight
// rows with zeros to 16, so the padded columns of f_t and fc_t are exactly 0,
// and the store masks the columns of y_t past F.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int DBM = 32;   // rows per block
constexpr int DT = 256;   // 8 warps, each owning up to 3 of the 16-wide output tiles

inline int decode_smem(int C, int TP) { return 2 * DBM * (C + 8) * 2 + DBM * (2 * TP + 8) * 2 + 8 * 256 * 4; }

// acc[i][rt] += A[rt*16 .. +16, 0:K] @ Bw[(warp + 8 i) * 16 .. +16, 0:K]^T
__device__ __forceinline__ void gemm_rows32(const bf16* A, int lda, int K, const bf16* Bw, int ldb,
                                            int ntiles, int warp, FragC (&acc)[3][2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    FragA a0, a1;
    wmma::load_matrix_sync(a0, A + k, lda);
    wmma::load_matrix_sync(a1, A + 16 * lda + k, lda);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ct = warp + 8 * i;
      if (ct < ntiles) {
        FragBt bt;
        wmma::load_matrix_sync(bt, Bw + (size_t)(ct * 16) * ldb + k, ldb);
        wmma::mma_sync(acc[i][0], a0, bt, acc[i][0]);
        wmma::mma_sync(acc[i][1], a1, bt, acc[i][1]);
      }
    }
  }
}

__global__ void __launch_bounds__(DT, 1) task_decode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, const bf16* __restrict__ cw,
    const bf16* __restrict__ ws, const float* __restrict__ bs, const bf16* __restrict__ wc,
    const float* __restrict__ bc, const bf16* __restrict__ wf, const float* __restrict__ bfin,
    bf16* __restrict__ out, int S, int C, int T, int G, int TP, int F, int FP) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int XL = C + 8, FFL = 2 * TP + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* In = Xs + DBM * XL;
  bf16* FF = In + DBM * XL;
  float* scratch = reinterpret_cast<float*>(FF + DBM * FFL);

  const int s0 = blockIdx.x * DBM, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const int gc = C / G;
  const int nrows = min(DBM, S - s0);
  const int chunks = C / 8;

  for (int i = threadIdx.x; i < DBM * chunks; i += DT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r < nrows;
    cp_async16(Xs + r * XL + c, ok ? x + ((size_t)b * S + s0 + r) * C + c : x, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  FragC acc[3][2];
  for (int t = 0; t < T; ++t) {
    // ---- both pathways: scaled input in shared memory, projection into FF ----
    for (int path = 0; path < 2; ++path) {
      for (int i = threadIdx.x; i < DBM * chunks; i += DT) {
        const int r = i / chunks, c = (i % chunks) * 8;
        float xv[8], o[8];
        unpack8(*reinterpret_cast<const uint4*>(Xs + r * XL + c), xv);
        if (path == 0) {
          // x * a + x in the activation dtype: two bf16 roundings (task_decode.py:69)
          const float av = r < nrows
              ? __bfloat162float(a[(((size_t)b * T + t) * S + s0 + r) * G + c / gc]) : 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o[k] = __bfloat162float(__float2bfloat16(xv[k] * av)) + xv[k];
        } else {
          float cv[8];
          unpack8(*reinterpret_cast<const uint4*>(cw + ((size_t)b * T + t) * C + c), cv);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o[k] = __bfloat162float(__float2bfloat16(xv[k] * cv[k])) + xv[k];
        }
        *reinterpret_cast<uint4*>(In + r * XL + c) = pack8(o);
      }
      __syncthreads();
      const bf16* wp = (path == 0 ? ws : wc) + (size_t)t * TP * C;
      const float* bp = (path == 0 ? bs : bc) + (size_t)t * TP;
      gemm_rows32(In, XL, C, wp, C, TP / 16, warp, acc);
      // f / fc + bias in f32, rounded to bf16 before the fuse (task_decode.py:79-82)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ct = warp + 8 * i;
        if (ct < TP / 16) {
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            float v[8];
            frag_row8(acc[i][rt], wscr, lane, v);
            const int col = ct * 16 + (lane & 1) * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] += bp[col + k];
            *reinterpret_cast<uint4*>(FF + (rt * 16 + (lane >> 1)) * FFL + path * TP + col) = pack8(v);
          }
        }
      }
      __syncthreads();
    }
    // ---- y_t = [f_t ; fc_t] @ wf_t^T + bf_t ----
    gemm_rows32(FF, FFL, 2 * TP, wf + (size_t)t * FP * 2 * TP, 2 * TP, FP / 16, warp, acc);
    const float* bp = bfin + (size_t)t * FP;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ct = warp + 8 * i;
      if (ct < FP / 16) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          float v[8];
          frag_row8(acc[i][rt], wscr, lane, v);
          const int r = rt * 16 + (lane >> 1);
          const int col = ct * 16 + (lane & 1) * 8;
          if (r < nrows) {
            bf16* dst = out + ((size_t)b * S + s0 + r) * T * F + (size_t)t * F;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (col + k < F) dst[col + k] = __float2bfloat16(v[k] + bp[col + k]);
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// x (B, S, C), a (B, T, S, G), cw (B, T, C) bf16; ws/wc (T, TP, C) and
// wf (T, FP, 2 TP) bf16 with zero padding rows/columns; bs/bc (T, TP) and
// bf (T, FP) f32 -> out (B, S, T * F) bf16. TP, FP multiples of 16, <= 384.
extern "C" int mtt_task_decode_bf16(const void* x, const void* a, const void* cw, const void* ws,
                                    const void* bs, const void* wc, const void* bc, const void* wf,
                                    const void* bf, void* out, int B, int S, int C, int T, int G,
                                    int TP, int F, int FP, void* stream) {
  const int smem = decode_smem(C, TP);
  cudaError_t e = cudaFuncSetAttribute(task_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + DBM - 1) / DBM, B);
  task_decode_kernel<<<grid, DT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a), static_cast<const bf16*>(cw),
      static_cast<const bf16*>(ws), static_cast<const float*>(bs), static_cast<const bf16*>(wc),
      static_cast<const float*>(bc), static_cast<const bf16*>(wf), static_cast<const float*>(bf),
      static_cast<bf16*>(out), S, C, T, G, TP, F, FP);
  return static_cast<int>(cudaGetLastError());
}
