// Shared helpers for the port's hand-written Hopper kernels: bf16 tensor-core
// fragments (nvcuda::wmma 16x16x16, f32 accumulators), 16-byte cp.async tile
// copies, warp reductions, and the per-warp fragment epilogue; and the
// register-resident layer of the attention kernels (attention_generic.cu,
// attention_bwd.cu): mma.sync m16n8k16 with ldmatrix operands, quad
// reductions over C fragments, and the C-to-A repacking that feeds one
// product's output to the next without shared memory.
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

// ---- streamed tiles for the register-resident kernels ----------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_u32(unsigned s, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// Copies ROWS rows of COLS bf16 (COLS % 8 == 0) of a row-major matrix with
// row stride ldg elements into a tile with leading dimension LDS, with all NT
// threads of the block. Each thread keeps one 16-byte column chunk (its index
// mod CP, COLS / 8 rounded up to a power of two) and walks rows NT / CP apart,
// so its addresses advance by constants. Rows at or past row_limit and
// columns at or past col_limit are zero-filled.
template <int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void load_rows_async_fixed(bf16* s, const bf16* g, long long ldg,
                                                      int row_limit, int col_limit) {
  constexpr int CH = COLS / 8;
  constexpr int CP = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  constexpr int RS = NT / CP;
  static_assert(NT % CP == 0 && ROWS % RS == 0, "tile rows must split over the threads");
  const int cc = threadIdx.x % CP, r0 = threadIdx.x / CP;
  if (cc >= CH) return;
  const bool col_ok = cc * 8 < col_limit;
  const unsigned sa = smem_u32(s + r0 * LDS + cc * 8);
  const bf16* gp = g + r0 * ldg + cc * 8;
#pragma unroll
  for (int k = 0; k < ROWS / RS; ++k) {
    const bool ok = col_ok && r0 + k * RS < row_limit;
    cp_async16_u32(sa + k * RS * LDS * 2, ok ? gp : g, ok);
    gp += RS * ldg;
  }
}

// ---- register-resident fragments: mma.sync m16n8k16 and ldmatrix ----------
//
// Layouts of mma.sync.m16n8k16 (bf16 in, f32 accumulate) for lane
// l = 4 g + t (g = l >> 2, t = l & 3):
//   A (16x16, row-major), 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, 2t+8..)
//   B (16x8), 2 regs: b0 (rows 2t, 2t+1 of column g), b1 (rows 2t+8, 2t+9)
//   C (16x8 f32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// A row of C lives in the 4 lanes of one quad (equal g): quad_max/quad_sum
// reduce over them. Two adjacent C tiles (columns 0-7 and 8-15) hold exactly
// the values of one A fragment whose k runs over those 16 columns: a0 =
// (c0[0], c0[1]), a1 = (c0[2], c0[3]), a2 = (c1[0], c1[1]), a3 = (c1[2],
// c1[3]), so a product's output feeds the next product without shared memory
// (c_to_a).

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// (l & 7) of matrix (l >> 3) (16 contiguous bytes); register i receives
// matrix i's (row g, cols 2t, 2t+1), or with .trans its (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Lane offsets (elements) of the x4 loads into a tile with leading dimension
// ld, for the three operand shapes the attention kernels use:
//   ldsm_a_off: an A fragment, rows r0..r0+15 and k columns k0..k0+15 of a
//     row-major tile -> ldsm_x4 at tile + r0 * ld + k0 + off;
//   ldsm_bt_off: the B fragments of two n8 tiles read from a row-major (n, k)
//     tile (B = tile^T, e.g. K in q k^T): n rows n0..n0+15, k columns
//     k0..k0+15 -> ldsm_x4; registers (0, 1) are n-tile n0, (2, 3) n0 + 8;
//   ldsm_b_off: the B fragments of two n8 tiles read from a row-major (k, n)
//     tile (e.g. V in p v): k rows k0..k0+15, n columns n0..n0+15 ->
//     ldsm_x4_trans; registers (0, 1) are n-tile n0, (2, 3) n0 + 8.
__device__ __forceinline__ int ldsm_a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int ldsm_bt_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldsm_b_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two adjacent m16n8 f32 C tiles (columns 0-7 and 8-15), rounded to bf16,
// as one m16k16 A fragment.
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// A C tile's values (scaled by mul, rounded to bf16) into a row-major bf16
// tile with leading dimension ld at column col0: rows g and g + 8.
__device__ __forceinline__ void c_to_smem(const float (&c)[4], bf16* tile, int ld, int col0,
                                          int lane, float mul) {
  const int g = lane >> 2, col = col0 + 2 * (lane & 3);
  *reinterpret_cast<uint32_t*>(tile + g * ld + col) = pack_bf16x2(c[0] * mul, c[1] * mul);
  *reinterpret_cast<uint32_t*>(tile + (g + 8) * ld + col) = pack_bf16x2(c[2] * mul, c[3] * mul);
}

}  // namespace mtt
