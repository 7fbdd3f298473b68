// Shared helpers for the port's hand-written Hopper kernels: bf16 tensor-core
// fragments (nvcuda::wmma 16x16x16, f32 accumulators), 16-byte cp.async tile
// copies, warp reductions, and the per-warp fragment epilogue.
//
// Every kernel of this directory is built by nvcc for sm_90a into one shared
// library with a plain C interface (mtt_tpu_torch/kernels/_build.py). Each
// exported function launches on the stream it is given and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mtt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// B operand read from a weight stored (N, K) row-major, as nn.Linear keeps it:
// element (k, n) of B sits at w[n * ld + k], which is wmma's column-major.
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies a ROWS x COLS bf16 tile (COLS % 8 == 0) of a row-major array with
// leading dimension ldg into shared memory with leading dimension lds. Rows at
// or past row_limit are zero-filled. All NT threads of the block take part.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_async(bf16* s, int lds, const bf16* g, size_t ldg,
                                                int row_limit) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    int r = i / CH, c = (i % CH) * 8;
    bool ok = r < row_limit;
    cp_async16(s + r * lds + c, ok ? g + r * ldg + c : g, ok);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// LayerNorm of one row of C bf16 values by one warp: f32 mean, f32 variance of
// the centred values, rsqrt(var + eps), affine with f32 gamma/beta, rounded to
// bf16 once. C % 8 == 0 and C <= 256 * VPL. Same statistics as the TPU kernel
// (mtt_tpu/kernels/layernorm.py:_ln_kernel).
template <int VPL>
__device__ __forceinline__ void ln_row_warp(const bf16* xr, const float* gamma, const float* beta,
                                            bf16* yr, int C, float eps, int lane) {
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    int c = (j * 32 + lane) * 8;
    if (c < C) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[j][k];
    }
  }
  float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    int c = (j * 32 + lane) * 8;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float d = v[j][k] - mean;
        q += d * d;
      }
    }
  }
  float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    int c = (j * 32 + lane) * 8;
    if (c < C) {
      float o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[j][k] - mean) * rstd * gamma[c + k] + beta[c + k];
      *reinterpret_cast<uint4*>(yr + c) = pack8(o);
    }
  }
}

// Per-warp epilogue helper: spills one 16x16 f32 accumulator to the warp's own
// 256-float scratch and hands each lane row (lane >> 1), columns
// (lane & 1) * 8 .. + 8 of it. The caller finishes the 8 values and stores them.
__device__ __forceinline__ void frag_row8(const FragC& acc, float* scratch, int lane, float* out8) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const float* p = scratch + (lane >> 1) * 16 + (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) out8[k] = p[k];
  __syncwarp();
}

// Abramowitz-Stegun 7.1.26 erf (|err| <= 1.5e-7) and the exact-form GELU built
// on it, as mtt_tpu/kernels/mlp.py:_erf_poly/_gelu_erf_poly compute them.
__device__ __forceinline__ float erf_poly(float z) {
  float az = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * az);
  float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float r = 1.0f - poly * expf(-az * az);
  return z > 0.f ? r : (z < 0.f ? -r : 0.f);
}

__device__ __forceinline__ float gelu_erf_poly(float h) {
  return 0.5f * h * (1.0f + erf_poly(h * 0.70710678118654752f));
}

// The polynomial-only GELU of the up4 head (mtt_tpu/kernels/mlp.py:
// _gelu_erf_poly_fast, |err| <= 2.1e-4): erf(z)/z as a degree-9 polynomial in
// z^2 on z clamped to [-3, 3], evaluated by Horner's rule from the top.
__device__ __forceinline__ float gelu_erf_poly_fast(float h) {
  const float z = fminf(fmaxf(h * 0.70710678118654752f, -3.f), 3.f);
  const float u = z * z;
  float p = -4.8841998736e-09f;
  p = p * u + 2.4628598067e-07f;
  p = p * u + -5.5816809050e-06f;
  p = p * u + 7.6191207693e-05f;
  p = p * u + -7.1228464379e-04f;
  p = p * u + 4.9304063297e-03f;
  p = p * u + -2.6508064540e-02f;
  p = p * u + 1.1261189222e-01f;
  p = p * u + -3.7607042872e-01f;
  p = p * u + 1.1283768672e+00f;
  return 0.5f * h * (1.0f + z * p);
}

}  // namespace mtt
