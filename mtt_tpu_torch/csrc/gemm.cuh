// The port's one bf16 GEMM (gemm.cu): out[M, N] = epilogue(a[M, K] . b[N, K]^T),
// a and b row-major with K contiguous (activations, and weights as nn.Linear
// stores them), f32 accumulators, one bf16 rounding. Row 4's two products
// (mlp.cu), row 8's two (mlp.cu), the qkv projection of rows 1-2
// (attention.cu), the up4 head's Gm (head_up4.cu) and each scale's Gm of the
// InvPT tail (invpt_tail.cu) are each one launch of it.
#pragma once

namespace mtt {

enum GemmEpilogue {
  EPI_GELU = 0,  // gelu_erf_poly(acc + bias)
  EPI_RES = 1,   // acc + bias + res, summed in that order
  EPI_BIAS = 2,  // acc + bias
  EPI_NONE = 3,  // acc alone: no bias is read
  EPI_TAIL = 4,  // EPI_NONE's math under its own instantiation, so that a
                 // profile tells the tail's Gm (gemm_kernel<4,) from the
                 // up4 head's (gemm_kernel<3,)
};

__host__ __device__ constexpr bool epi_reads_bias(int epi) {
  return epi != EPI_NONE && epi != EPI_TAIL;
}

}  // namespace mtt

// bias (N,) is f32 when bias_f32, else bf16, and not read by EPI_NONE or
// EPI_TAIL (it may be null there); res (M, N) bf16, read by EPI_RES only.
// M >= 0 any; N and K positive multiples of 8 and every pointer 16-byte
// aligned (TMA's rule: the row pitch and the base address); anything else
// returns cudaErrorInvalidValue.
extern "C" int mtt_gemm_bf16(const void* a, const void* b, void* out, const void* bias,
                             int bias_f32, const void* res, int M, int N, int K, int epi,
                             void* stream);
