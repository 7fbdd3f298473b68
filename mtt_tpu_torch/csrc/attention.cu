// Pre-norm attention front half: qkv = LN(x) @ W^T + b (head-major columns),
// then softmax(q k^T * scale) v per head, written as the head concat.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_ln_qkv_cached_kernel (the 20
// non-tap ViT-L blocks) and the emit variant _attn_ln_qkv_kernel(ln=False,
// emit=True) (the 4 tap blocks). The split into hand-written launches is:
//   1. LN rows (layernorm.cu; the emit path keeps LN(x) as an output),
//   2. gemm_nt_bias_kernel (this file): the qkv projection, bias added in
//      f32, one bf16 rounding, head-major (H, 3, D) columns as the weight rows
//      hold them,
//   3. the attention core, mtt_attn_core_bf16 (attention_generic.cu): the
//      register-resident attn_generic_kernel under its Fast or Safe softmax
//      policy, reading q, k and v as strided views of the packed qkv; the
//      scores never leave registers. Row 13 (_attn_qkv_kernel) is this launch
//      alone.
//
// What bounds it on the H100: at ViT-L shapes (B=8, N=1029, C=1024, H=16,
// D=64) the projection is 52 GFLOP and the attention 35 GFLOP per block, so
// both are tensor-core work; the projection runs on wmma 16x16x16 tiles with
// f32 accumulation through a two-buffer cp.async pipeline.
#include "common.cuh"

using namespace mtt;

namespace {

// ---- qkv projection: Y = bf16(X @ W^T + bias) -------------------------------
constexpr int GBM = 128, GBN = 128, GBK = 32, GLD = GBK + 8, GT = 256;

__global__ void __launch_bounds__(GT) gemm_nt_bias_kernel(const bf16* __restrict__ X,
                                                          const bf16* __restrict__ W,
                                                          const float* __restrict__ bias,
                                                          bf16* __restrict__ Y, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][GBM * GLD];
  __shared__ __align__(128) bf16 Bs[2][GBN * GLD];
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, each 64 x 32 outputs
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const bf16* Xb = X + (size_t)m0 * K;
  const bf16* Wb = W + (size_t)n0 * K;
  const int KT = K / GBK;
  load_tile_async<GBM, GBK, GT>(As[0], GLD, Xb, K, M - m0);
  load_tile_async<GBN, GBK, GT>(Bs[0], GLD, Wb, K, N - n0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_tile_async<GBM, GBK, GT>(As[st ^ 1], GLD, Xb + (kt + 1) * GBK, K, M - m0);
      load_tile_async<GBN, GBK, GT>(Bs[st ^ 1], GLD, Wb + (kt + 1) * GBK, K, N - n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      FragA a[4];
      FragBt b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], As[st] + (wm * 64 + i * 16) * GLD + kk, GLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs[st] + (wn * 32 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: the staging buffers are free now; each warp spills one fragment
  // at a time to its own 256 floats, adds the f32 bias, rounds once
  float* scratch = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[8];
      frag_row8(acc[i][j], scratch, lane, v);
      const int row = m0 + wm * 64 + i * 16 + (lane >> 1);
      const int col = n0 + wn * 32 + j * 16 + (lane & 1) * 8;
      if (row < M) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += bias[col + k];
        *reinterpret_cast<uint4*>(Y + (size_t)row * N + col) = pack8(v);
      }
    }
}

}  // namespace

// xn (M, K) bf16, w (N, K) bf16, bias (N,) f32 -> qkv (M, N) bf16.
// K % 32 == 0 and N % 128 == 0; M is masked.
extern "C" int mtt_qkv_proj_bf16(const void* xn, const void* w, const void* bias, void* qkv, int M,
                                 int N, int K, void* stream) {
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_nt_bias_kernel<<<grid, GT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(qkv), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
