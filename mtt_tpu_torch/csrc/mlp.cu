// Transformer MLPs, bf16 in and out: launches of the shared GEMM (gemm.cu);
// the half-block also at f32 (mtt_mlp_ln_res_f32, at the end).
//
// The pre-norm half-block out = x + fc2(gelu(fc1(LN(x)))) (mtt_mlp_ln_res_bf16)
// replaces mtt_tpu/kernels/mlp.py:_mlp_ln_res_kernel and its batch-blocked twin
// _mlp_ln_res_bb_kernel, which every eval block of the ViT trunks runs. It is
// 138 GFLOP per ViT-L call (8232 rows, C = 1024, hidden 4096): bound by the
// tensor cores (0.140 ms at 989 TFLOP/s). The TPU kernel keeps the (rows, 4C)
// hidden activation on chip; on this card that forces a block to hold its rows'
// fc2 sums in registers for the whole hidden walk, so a block takes 32 rows and
// every block streams both weight matrices. Here the function is cut at its two
// bf16 rounding points (mlp.py:298, :303) into three launches:
//   1. LN(x) -> xn, bf16 (the LayerNorm kernel of layernorm.cu);
//   2. h = bf16(gelu_erf_poly(xn . w1^T + b1))          (EPI_GELU);
//   3. out = bf16(h . w2^T + b2 + x), the sum in f32    (EPI_RES).
// The hidden goes through device memory: 8232 x 4096 bf16 written once and read
// once, 135 MB or 0.04 ms at 3.35 TB/s.
//
// The plain MLP out = fc2(gelu(fc1(x))) (mtt_mlp_fc_bf16) replaces
// mlp.py:_mlp_kernel (pallas_call at :142), which the training blocks with
// drop-path and the Swin-B stages run after a separate LayerNorm. It is the
// half-block without its LayerNorm and residual, cut at the TPU kernel's one
// bf16 rounding (mlp.py:96) into two launches:
//   1. h = bf16(gelu_erf_poly(x . w1^T + b1))           (EPI_GELU);
//   2. out = bf16(h . w2^T + b2), the sum in f32        (EPI_BIAS).
// Its widths run from Swin-B stage 0 (C = 128: fc1 has two 64-deep K stages,
// so there the hidden's round trip, 151 MB at 73,728 rows, costs more than the
// products) to the ViT trunks (C = 1024), its rows from 73,728 down to the 3
// prompt rows; TMA's zero fill and the guarded stores take every ragged edge.
#include "gemm.cuh"

using namespace mtt;

extern "C" int mtt_layernorm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int C, float eps, int flags, void* stream);
extern "C" int mtt_layernorm_ld_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                     int rows, int C, int ld, float eps, int flags, void* stream);
extern "C" int mtt_layernorm_f32(const void* x, const void* gamma, const void* beta, void* y,
                                 int rows, int C, float eps, int flags, void* stream);
extern "C" int mtt_layernorm_ld_f32(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, int C, int ld, float eps, int flags, void* stream);

// The half-block x + fc2(gelu(fc1(LN(x)))) as three launches. x (M, CP) bf16
// with CP = C rounded up to a multiple of 8: the wrapper zero-pads the
// columns past C (and w1's, w2's and b2's), so the LayerNorm launch counts
// the first C columns and writes zeros past them, and the GEMMs run at CP,
// where the zero columns add exact zeros. w1 (Hd, CP), w2 (CP, Hd) bf16 as
// nn.Linear stores them; gamma, beta (C,), b1 (Hd,), b2 (CP,) (flags bits
// 0-3: f32, else bf16); xn (M, CP) and h (M, Hd) bf16 scratch; out (M, CP).
// C <= 16384 (the LayerNorm kernel's rows), Hd a positive multiple of 8;
// every pointer 16-byte aligned (TMA's rule).
extern "C" int mtt_mlp_ln_res_bf16(const void* x, const void* gamma, const void* beta,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* xn, void* h, void* out, int M, int C, int Hd, float eps,
                                   int flags, void* stream) {
  if (M <= 0) return 0;
  const int CP = (C + 7) / 8 * 8;
  if (C <= 0 || CP > 16384 || Hd % 8 || Hd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // whole 16-byte rows take the LayerNorm's packed entry; others its padded pitch
  int e = CP == C ? mtt_layernorm_bf16(x, gamma, beta, xn, M, C, eps, flags & 3, stream)
                  : mtt_layernorm_ld_bf16(x, gamma, beta, xn, M, C, CP, eps, flags & 3, stream);
  if (e) return e;
  e = mtt_gemm_bf16(xn, w1, h, b1, (flags >> 2) & 1, nullptr, M, Hd, CP, EPI_GELU, stream);
  if (e) return e;
  return mtt_gemm_bf16(h, w2, out, b2, (flags >> 3) & 1, x, M, CP, Hd, EPI_RES, stream);
}

// The plain MLP fc2(gelu(fc1(x))) as two launches. x (M, C) bf16; w1 (Hd, C),
// w2 (C, Hd) bf16; b1, b2 (flags bits 0-1: f32, else bf16); h (M, Hd) bf16
// scratch. Any M; C and Hd positive multiples of 8; every pointer 16-byte
// aligned.
extern "C" int mtt_mlp_fc_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h, void* out, int M, int C, int Hd,
                               int flags, void* stream) {
  int e = mtt_gemm_bf16(x, w1, h, b1, flags & 1, nullptr, M, Hd, C, EPI_GELU, stream);
  if (e) return e;
  return mtt_gemm_bf16(h, w2, out, b2, (flags >> 1) & 1, nullptr, M, C, Hd, EPI_BIAS, stream);
}

// The f32 form of the half-block, for the TaskPrompter-ViT eval forward at
// JAX's default dtype: the same three launches, each the f32 form of its
// bf16 one (the LayerNorm kernel at f32, then the f32 GEMM of gemm_f32.cu
// twice), xn and h f32 scratch; at f32 the two cuts round nothing. The
// arguments as mtt_mlp_ln_res_bf16's, every tensor f32 but gamma and beta
// (flags bits 0-1, as stored).
extern "C" int mtt_mlp_ln_res_f32(const void* x, const void* gamma, const void* beta,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* xn, void* h, void* out, int M, int C, int Hd, float eps,
                                  int flags, void* stream) {
  if (M <= 0) return 0;
  const int CP = (C + 7) / 8 * 8;
  if (C <= 0 || CP > 16384 || Hd % 8 || Hd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int e = CP == C ? mtt_layernorm_f32(x, gamma, beta, xn, M, C, eps, flags & 3, stream)
                  : mtt_layernorm_ld_f32(x, gamma, beta, xn, M, C, CP, eps, flags & 3, stream);
  if (e) return e;
  e = mtt_gemm_f32(xn, 0, w1, h, 0, b1, nullptr, M, Hd, CP, EPI_GELU, stream);
  if (e) return e;
  return mtt_gemm_f32(h, 0, w2, out, 0, b2, x, M, CP, Hd, EPI_RES, stream);
}
