// TaskPrompter per-task feature decode with the first fuse projection, f32.
//
// The f32 form of task_decode.cu's one launch, for the TaskPrompter-ViT eval
// forward at JAX's default dtype. Replaces, at f32,
// mtt_tpu/kernels/task_decode.py:_decode_kernel (pallas_call at :102), whose
// products (task_decode.py:18-21) it computes in f32. For every task t:
//   f_t  = (x * a_t + x) @ ws_t^T + bs_t        (spatial pathway)
//   fc_t = (x * cw_t + x) @ wc_t^T + bc_t       (channel pathway)
//   y_t  = [f_t ; fc_t] @ wf_t^T + bf_t         (first 1x1 fuse)
// written as one (B, S, T * F) tensor, task-major; a_t's head group of channel
// c is c / (C / G). Every .astype(x.dtype) of the TPU kernel (and of the
// plain version, kernels/task_decode.py: task_decode_plain) is the identity
// at f32: x * a + x is a product and a sum each rounded to f32 (no fused
// multiply-add, as torch computes them), the three products are f32 sums.
//
// What bounds it on the H100: at ViT-L PASCAL shapes (B = 8, S = 1024, C =
// 1024, T = 5, tar = 300, F = 350) it is 68 GFLOP of f32 products, 1.0 ms at
// the 67 TFLOP/s of the CUDA cores, against 34 MB of x read and 57 MB of y
// written. So the FMA rate does, and the design is register tiling: a block
// of 256 threads owns 32 rows of one batch item and one task (blocks in task
// order, so that those in flight share a task's weights in L2); warp w owns
// rows 4 w .. 4 w + 3 and lane l the output columns l + 32 j (j < 11: up to
// 352), 44 sums a thread. K walks in chunks of 16 through shared memory, both
// operands K-major: the scaled x chunk (formed as it is loaded) read as one
// broadcast float4 a step, the weight chunk (transposed on the way in, at a
// row pitch of 353 floats) read by consecutive lanes. Phases F and FC leave
// their sums plus the bias in a shared-memory tile FF (2 tar x 32, K-major),
// f at rows 0 .. tar - 1 and fc at tar .. 2 tar - 1: wf_t's own column
// order, so phase Y reads FF as its A operand in place and wf needs no
// re-layout. y leaves from the sums plus the bias, consecutive lanes on
// consecutive columns. No split-K and no atomics: two runs give the same
// bits.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int BM = 32;            // rows of a tile
constexpr int NT = 256;           // 8 warps: warp w takes rows 4 w .. 4 w + 3
constexpr int BK = 16;            // K of a chunk
constexpr int NJ = 11;            // columns of a lane: l + 32 j, up to 352
constexpr int AP = BM + 4;        // row pitch of the K-major A and FF tiles
constexpr int BP = 32 * NJ + 1;   // row pitch of the K-major weight tile
constexpr int MAX_TAR = 304, MAX_F = 32 * NJ;

__host__ __device__ constexpr int ff_rows(int tar) { return (2 * tar + BK - 1) / BK * BK; }

__host__ __device__ constexpr int decode_smem(int tar) {
  return (BK * AP + BK * BP + ff_rows(tar) * AP) * 4;
}

// x * s + x with both operations rounded, as torch computes x * s + x
__device__ __forceinline__ float scale_add(float x, float s) {
  return __fadd_rn(__fmul_rn(x, s), x);
}

__global__ void __launch_bounds__(NT) task_decode_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ cw,
    const float* __restrict__ ws, const float* __restrict__ bs, const float* __restrict__ wc,
    const float* __restrict__ bc, const float* __restrict__ wf, const float* __restrict__ bfin,
    float* __restrict__ out, int B, int S, int C, int T, int G, int tar, int F) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // [BK][AP]: the scaled x chunk, K-major
  float* Bs = As + BK * AP;    // [BK][BP]: the weight chunk, K-major
  float* FF = Bs + BK * BP;    // [ff_rows(tar)][AP]: [f; fc], K-major
  const int stiles = (S + BM - 1) / BM;
  const int t = blockIdx.x / (B * stiles), b = (blockIdx.x / stiles) % B;
  const int s0 = (blockIdx.x % stiles) * BM;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gc = C / G;
  // FF's rows past 2 tar meet the zero-filled end of wf's last chunk: keep
  // them finite
  for (int i = 2 * tar * AP + tid; i < ff_rows(tar) * AP; i += NT) FF[i] = 0.f;

  const float* xb = x + (size_t)b * S * C;
  const float* ab = a + ((size_t)b * T + t) * S * G;  // a (B, T, S, G)
  const float* cwb = cw + ((size_t)b * T + t) * C;

  for (int ph = 0; ph < 3; ++ph) {
    const int K = ph < 2 ? C : 2 * tar, NW = ph < 2 ? tar : F;
    const float* W = ph == 0   ? ws + (size_t)t * tar * C
                     : ph == 1 ? wc + (size_t)t * tar * C
                               : wf + (size_t)t * F * 2 * tar;
    const float* bias = ph == 0 ? bs + (size_t)t * tar
                        : ph == 1 ? bc + (size_t)t * tar
                                  : bfin + (size_t)t * F;
    const int nj = (NW + 31) / 32;
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      if (ph < 2 && tid < BM * BK / 4) {
        // the x chunk, scaled: x * a + x (a per head group) or x * cw + x
        const int r = tid / (BK / 4), kc = (tid % (BK / 4)) * 4;
        const int s = s0 + r, k = k0 + kc;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s < S && k < C) {
          v = *reinterpret_cast<const float4*>(xb + (size_t)s * C + k);
          if (ph == 0) {
            const float av = ab[(size_t)s * G + k / gc];  // one group: gc % 4 == 0
            v.x = scale_add(v.x, av), v.y = scale_add(v.y, av);
            v.z = scale_add(v.z, av), v.w = scale_add(v.w, av);
          } else {
            const float4 c4 = *reinterpret_cast<const float4*>(cwb + k);
            v.x = scale_add(v.x, c4.x), v.y = scale_add(v.y, c4.y);
            v.z = scale_add(v.z, c4.z), v.w = scale_add(v.w, c4.w);
          }
        }
        As[kc * AP + r] = v.x, As[(kc + 1) * AP + r] = v.y;
        As[(kc + 2) * AP + r] = v.z, As[(kc + 3) * AP + r] = v.w;
      }
      // the weight chunk: rows n < NW, columns k0 .. k0 + 15, zero past K
      for (int i = tid; i < NW * (BK / 4); i += NT) {
        const int n = i / (BK / 4), kc = (i % (BK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kc < K) v = *reinterpret_cast<const float4*>(W + (size_t)n * K + k0 + kc);
        Bs[kc * BP + n] = v.x, Bs[(kc + 1) * BP + n] = v.y;
        Bs[(kc + 2) * BP + n] = v.z, Bs[(kc + 3) * BP + n] = v.w;
      }
      __syncthreads();
      const float* Ap = ph < 2 ? As : FF + k0 * AP;  // phase Y: FF's rows k0 ..
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(Ap + kk * AP + 4 * w);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const float bv = Bs[kk * BP + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
          }
        }
      }
      __syncthreads();  // As and Bs are refilled next
    }

    if (ph < 2) {
      // f or fc plus its bias into FF (read from phase Y's first chunk on,
      // after its barrier)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        if (j < nj && n < tar) {
          const float bv = bias[n];
#pragma unroll
          for (int i = 0; i < 4; ++i) FF[(ph * tar + n) * AP + 4 * w + i] = acc[i][j] + bv;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + 4 * w + i;
        if (s >= S) continue;
        float* orow = out + ((size_t)b * S + s) * T * F + (size_t)t * F;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = lane + 32 * j;
          if (j < nj && n < F) orow[n] = acc[i][j] + bias[n];
        }
      }
    }
  }
}

}  // namespace

// x (B, S, C) f32; a (B, T, S, G), cw (B, T, C), ws, wc (T, tar, C), wf (T, F,
// 2 tar), bs, bc (T, tar), bf (T, F), all f32 -> out (B, S, T F) f32. C % 8 ==
// 0, (C / G) % 4 == 0, tar % 4 == 0 and <= 304, 1 <= F <= 352; every pointer
// 16-byte aligned.
extern "C" int mtt_task_decode_f32(const void* x, const void* a, const void* cw, const void* ws,
                                   const void* bs, const void* wc, const void* bc, const void* wf,
                                   const void* bf, void* out, int B, int S, int C, int T, int G,
                                   int tar, int F, void* stream) {
  if (B < 1 || S < 1 || T < 1 || G < 1 || C < 8 || C % 8 || C % G || (C / G) % 4 || tar % 4 ||
      tar <= 0 || tar > MAX_TAR || F <= 0 || F > MAX_F)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)T * B * ((S + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = decode_smem(tar);
  cudaError_t e = cudaFuncSetAttribute(task_decode_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  task_decode_f32_kernel<<<static_cast<unsigned>(blocks), NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(cw),
      static_cast<const float*>(ws), static_cast<const float*>(bs), static_cast<const float*>(wc),
      static_cast<const float*>(bc), static_cast<const float*>(wf), static_cast<const float*>(bf),
      static_cast<float*>(out), B, S, C, T, G, tar, F);
  return static_cast<int>(cudaGetLastError());
}
