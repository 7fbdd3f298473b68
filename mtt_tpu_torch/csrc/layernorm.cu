// Row LayerNorm over the last axis, bf16 in and out, f32 statistics.
//
// Replaces mtt_tpu/kernels/layernorm.py:_ln_kernel. On the H100 it is bound by
// device memory: one read and one write of the (rows, C) tensor, about 34 MB for
// the ViT-L tap input (8, 1029, 1024). One warp owns one row and keeps it in
// registers, so x is read once, the two reductions are warp shuffles, and the
// normalised row is written once with 16-byte stores.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int kThreads = 256;

template <int VPL>
__global__ void __launch_bounds__(kThreads) ln_kernel(const bf16* __restrict__ x,
                                                       const float* __restrict__ gamma,
                                                       const float* __restrict__ beta,
                                                       bf16* __restrict__ y, int rows, int C,
                                                       float eps) {
  int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (row >= rows) return;
  ln_row_warp<VPL>(x + (size_t)row * C, gamma, beta, y + (size_t)row * C, C, eps, threadIdx.x & 31);
}

}  // namespace

extern "C" int mtt_layernorm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int C, float eps, void* stream) {
  dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto g = static_cast<const float*>(gamma);
  auto b = static_cast<const float*>(beta);
  auto yb = static_cast<bf16*>(y);
  if (C <= 256)
    ln_kernel<1><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else if (C <= 512)
    ln_kernel<2><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else if (C <= 1024)
    ln_kernel<4><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else if (C <= 2048)
    ln_kernel<8><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else if (C <= 3072)   // the InvPT stage norm over T*C task-merged channels (2880)
    ln_kernel<12><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else if (C <= 4096)
    ln_kernel<16><<<grid, kThreads, 0, st>>>(xb, g, b, yb, rows, C, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
