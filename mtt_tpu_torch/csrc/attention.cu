// Pre-norm attention front half: qkv = LN(x) @ W^T + b (head-major columns),
// then softmax(q k^T * scale) v per head, written as the head concat.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_ln_qkv_cached_kernel (the 20
// non-tap ViT-L blocks) and the emit variant _attn_ln_qkv_kernel(ln=False,
// emit=True) (the 4 tap blocks). The split into hand-written launches is:
//   1. LN rows (layernorm.cu; the emit path keeps LN(x) as an output),
//   2. the qkv projection (mtt_qkv_proj_bf16, this file): one launch of the
//      shared wgmma GEMM (gemm.cu) with its bias epilogue, the product and the
//      bias summed in f32 and rounded to bf16 once (attention.py:433-436),
//      head-major (H, 3, D) columns as the weight rows hold them,
//   3. the attention core, mtt_attn_core_bf16 (attention_generic.cu): the
//      register-resident attn_generic_kernel under its Fast or Safe softmax
//      policy, reading q, k and v as strided views of the packed qkv; the
//      scores never leave registers. Row 13 (_attn_qkv_kernel) is this launch
//      alone.
//
// What bounds it on the H100: at ViT-L shapes (B=8, N=1029, C=1024, H=16,
// D=64) the projection is 52 GFLOP and the attention 35 GFLOP per block, so
// both are tensor-core work.
#include "gemm.cuh"

using namespace mtt;

// xn (M, K) bf16, w (N, K) bf16 as nn.Linear stores it, bias (N,) f32 when
// bias_f32 else bf16 -> qkv (M, N) bf16. Any M; N and K multiples of 8; every
// pointer 16-byte aligned.
extern "C" int mtt_qkv_proj_bf16(const void* xn, const void* w, const void* bias, void* qkv, int M,
                                 int N, int K, int bias_f32, void* stream) {
  return mtt_gemm_bf16(xn, w, qkv, bias, bias_f32, nullptr, M, N, K, EPI_BIAS, stream);
}

// The f32 form of the projection (the front half at JAX's default dtype):
// xn (M, K), w (N, K), bias (N,) and qkv (M, N) f32, one launch of the f32
// GEMM (gemm_f32.cu) with its bias epilogue. Any M; N and K multiples of 8;
// every pointer 16-byte aligned.
extern "C" int mtt_qkv_proj_f32(const void* xn, const void* w, const void* bias, void* qkv, int M,
                                int N, int K, void* stream) {
  return mtt_gemm_f32(xn, 0, w, qkv, 0, bias, nullptr, M, N, K, EPI_BIAS, stream);
}
