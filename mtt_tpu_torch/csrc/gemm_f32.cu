// The port's f32 GEMM with fused epilogues: tiled FFMA on the CUDA cores.
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B f32, row-major with K
// contiguous (activations, and weights as nn.Linear stores them), the same
// epilogues as the bf16 GEMM (gemm.cuh), summed in the same order:
//   EPI_GELU  gelu_erf_poly(acc + bias)   fc1 of row 4 (mlp.py:303)
//   EPI_RES   acc + bias + res            fc2 of row 4 (mlp.py:309-310)
//   EPI_BIAS  acc + bias                  the qkv projection of rows 1-2
//                                         (attention.py:433-436)
//   EPI_NONE  acc                         the up4 head's Gm (head_up4.py)
// It is the f32 form of the products that gemm.cu computes in bf16, for the
// TaskPrompter-ViT eval forward at JAX's default dtype, where every
// .astype(x.dtype) of the TPU kernels is the identity: nothing is rounded
// but the f32 sums themselves. The operands are not rounded to TF32 (the
// reference is torch.matmul with allow_tf32 False).
//
// What bounds it on the H100: f32 products outside the tensor cores, 67
// TFLOP/s; the qkv projection of a ViT-L block (8232 x 1024 -> 3072) is 52
// GFLOP, 0.77 ms at that peak, against 47 MB of operands (0.014 ms), so the
// FMA rate does. The design is the classic register-tiled SGEMM: a block of
// 256 threads owns a 128 x 128 tile of out, each thread an 8 x 8 sub-tile
// (rows 4 ty .. + 3 and 64 + 4 ty .. + 3, columns 4 tx .. + 3 and 64 + 4 tx
// .. + 3 of the tile, ty, tx in 0..15), so that every value it reads from
// shared memory feeds 8 FMAs and both operands are read as float4 without
// bank conflicts. K walks in steps of 8 through two shared-memory buffers,
// both operands stored K-major (transposed on the way in); the next step's
// two float4 a thread loads from device memory are in flight in registers
// while the current step's 512 FMAs run, and one barrier a step orders the
// buffers. Rows past M, columns past N and K past its end are zero-filled
// on load and clipped on store. No split-K and no atomics: each output is
// one thread's sum over K in order, so two runs give the same bits.
#include "common.cuh"
#include "gemm.cuh"

using namespace mtt;

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256;

// The exact-form GELU on the Abramowitz-Stegun 7.1.26 erf, as the plain
// version (kernels/mlp.py: gelu_erf_poly) and mtt_tpu/kernels/mlp.py:
// _gelu_erf_poly compute it: an IEEE division and expf.
__device__ __forceinline__ float gelu_erf_poly_f32(float h) {
  const float z = h * 0.70710678118654752f;
  const float az = fabsf(z);
  const float t = 1.0f / (1.0f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float r = 1.0f - poly * expf(-az * az);
  return 0.5f * h * (1.0f + (z > 0.f ? r : (z < 0.f ? -r : 0.f)));
}

template <int EPI>
__global__ void __launch_bounds__(NT, 2) gemm_f32_kernel(
    const float* __restrict__ A, long long lda, const float* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ res, float* __restrict__ out,
    long long ldo, int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loads: row lr of the A and B tiles, K columns lk .. lk + 3 of the step
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool arow = m0 + lr < M, brow = n0 + lr < N;
  const float* ap = A + (size_t)(arow ? m0 + lr : 0) * lda + lk;
  const float* bp = B + (size_t)(brow ? n0 + lr : 0) * K + lk;
  float4 ra, rb;
  auto load = [&](int k0) {
    const bool kin = k0 + lk < K;  // K % 4 == 0: a float4 is all in or all out
    ra = arow && kin ? *reinterpret_cast<const float4*>(ap + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = brow && kin ? *reinterpret_cast<const float4*>(bp + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store = [&](int buf) {
    As[buf][lk][lr] = ra.x, As[buf][lk + 1][lr] = ra.y;
    As[buf][lk + 2][lr] = ra.z, As[buf][lk + 3][lr] = ra.w;
    Bs[buf][lk][lr] = rb.x, Bs[buf][lk + 1][lr] = rb.y;
    Bs[buf][lk + 2][lr] = rb.z, Bs[buf][lk + 3][lr] = rb.w;
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // the epilogue in f32, in the order of gemm.cuh; float4 stores where the
  // four columns lie inside N
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      if (col >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = min(col + j, N - 1);
        float x = acc[i][4 * h + j];
        if constexpr (EPI == EPI_GELU) {
          x = gelu_erf_poly_f32(x + bias[c]);
        } else if constexpr (EPI == EPI_RES) {
          x = x + bias[c] + res[(size_t)row * ldo + c];
        } else if constexpr (EPI == EPI_BIAS) {
          x = x + bias[c];
        }
        v[j] = x;
      }
      float* o = out + (size_t)row * ldo + col;
      if (col + 3 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) o[j] = v[j];
      }
    }
  }
}

template <int EPI>
int launch(const void* a, long long lda, const void* b, void* out, long long ldo, const void* bias,
           const void* res, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gemm_f32_kernel<EPI><<<grid, NT, 0, st>>>(
      static_cast<const float*>(a), lda, static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<const float*>(res), static_cast<float*>(out),
      ldo, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mtt_gemm_f32(const void* a, long long lda, const void* b, void* out, long long ldo,
                            const void* bias, const void* res, int M, int N, int K, int epi,
                            void* stream) {
  lda = lda ? lda : K;
  ldo = ldo ? ldo : N;
  if (M < 0 || N <= 0 || K <= 0 || K % 4 || lda < K || lda % 4 || ldo < N || ldo % 4 ||
      (epi == EPI_RES && !res) || (epi_reads_bias(epi) && !bias))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_GELU: return launch<EPI_GELU>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_RES: return launch<EPI_RES>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_BIAS: return launch<EPI_BIAS>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_NONE: return launch<EPI_NONE>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
