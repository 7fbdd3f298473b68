// Row LayerNorm over the last axis, bf16 in and out, f32 statistics.
//
// Replaces mtt_tpu/kernels/layernorm.py:_ln_kernel. On the H100 it is bound by
// device memory: one read and one write of the (rows, C) tensor, about 34 MB for
// the ViT-L tap input (8, 1029, 1024), 10 us at 3.35 TB/s. A row lives in the
// registers of 8, 16 or 32 lanes of one warp (C <= 64, <= 128, wider), so a
// warp takes four, two or one rows and no lane idles at the Swin-B stage width
// C = 128. x is read once with 16-byte loads, the two reductions are shuffles
// over the row's lanes, and the normalised row is written once with 16-byte
// stores. gamma and beta are read in their stored dtype (bf16 or f32) with
// 16-byte loads, once per lane, and widened in registers (bf16 to f32 is
// exact), so the wrappers launch no cast kernel. The same kernel is the first
// stage of the attention front halves (attention.cu) and of the MLP half-block
// (mlp.cu).
//
// Rows past 4096 columns (InvPT's task-merged stage norm at embed_dim 1024: 5
// tasks x 1088 = 5440) would need more than 128 values a lane in one warp.
// There a block of four warps takes a row (ln_wide_kernel), each lane keeping
// up to VPL 16-byte chunks in registers, and the two sums meet across the
// warps in shared memory; every load and store stays 16 bytes wide. That
// gives one block a row, 2,048 blocks at the stage-0 norm of a PASCAL batch of
// 8 (over 15 an SM), up to 16,384 columns.
//
// Rows of C columns that are not whole 16-byte chunks (InvPT's stage norms
// at embed_dim 600: 5 x 332 = 1660 and 5 x 166 = 830) take ln_wide_kernel in
// its ANY mode, whose rows lie at a pitch ld >= C: the statistics and the
// affine count the first C columns only, and the columns C .. ld - 1 are
// written as zeros. At a pitch that is a multiple of 8 (the MLP half-block's
// zero-padded copy of x: the padded row is LN(x) followed by zeros) the
// loads and stores stay 16 bytes wide; rows packed at pitch C (a LayerNorm
// call on such a tensor) start off the 16-byte grid, so there every value is
// loaded and stored alone (2 bytes). The tail chunk of gamma and beta is
// read value by value.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int kThreads = 256;

// How a row is read and written: FULL rows are whole 16-byte chunks at pitch C
// (every model's width but InvPT's at embed_dim 600); ANY rows lie at a pitch
// ld >= C, with 16-byte accesses where vec (ld % 8 == 0), else 2-byte ones.
enum RowMode { FULL = 0, ANY = 1 };

// Eight parameters from column c, widened to f32, zero at and past C: two
// 16-byte loads of f32 or one of bf16 for a whole chunk, else value by value.
template <int MODE>
__device__ __forceinline__ void load_param8(const void* p, int c, int C, bool is_f32, float* out) {
  if (MODE == FULL || c + 8 <= C) {
    if (is_f32) {
      const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + c);
      const float4 a = q[0], b = q[1];
      out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
      out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
    } else {
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + c), out);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k] = c + k >= C ? 0.f
             : is_f32   ? static_cast<const float*>(p)[c + k]
                        : __bfloat162float(static_cast<const bf16*>(p)[c + k]);
}

// Eight values of the row xr from column c (c % 8 == 0), widened to f32, zero
// at and past C. FULL rows, and ANY rows where vec, start on a 16-byte
// boundary, so a whole chunk is one 16-byte load.
template <int MODE>
__device__ __forceinline__ void load_x8(const bf16* xr, int c, int C, bool vec, float* out) {
  if (MODE == FULL || (vec && c + 8 <= C)) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), out);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = c + k < C ? __bfloat162float(xr[c + k]) : 0.f;
}

// The normalised chunk o of columns c .. c + 7 into the row yr, zeros from C
// on, nothing at or past ld: one 16-byte store where FULL or vec.
template <int MODE>
__device__ __forceinline__ void store_y8(bf16* yr, int c, int C, int ld, bool vec, const float* o) {
  if (MODE == FULL) {
    *reinterpret_cast<uint4*>(yr + c) = pack8(o);
    return;
  }
  float z[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) z[k] = c + k < C ? o[k] : 0.f;
  if (vec) {
    *reinterpret_cast<uint4*>(yr + c) = pack8(z);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (c + k < ld) yr[c + k] = __float2bfloat16(z[k]);
}

// Sum over the LPR lanes of one row (LPR a power of two; all 32 lanes take
// part, each row's lanes only exchange among themselves).
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VPL 16-byte chunks a lane, LPR lanes a row, 32 / LPR rows a warp. Statistics
// as the TPU kernel: f32 mean, f32 variance of the centred values,
// rsqrt(var + eps), affine in f32, one bf16 rounding. FULL rows only.
template <int VPL, int LPR>
__global__ void __launch_bounds__(kThreads) ln_kernel(const bf16* __restrict__ x,
                                                       const void* __restrict__ gamma,
                                                       const void* __restrict__ beta,
                                                       bf16* __restrict__ y, int rows, int C,
                                                       float eps, bool gamma_f32, bool beta_f32) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int warp_row0 = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * RPW;
  if (warp_row0 >= rows) return;  // the same for every lane of the warp
  const int row = warp_row0 + lane / LPR, l = lane % LPR;
  const bool live = row < rows;
  const bf16* xr = x + (size_t)row * C;

  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * 8;
    if (live && c < C) {
      load_x8<FULL>(xr, c, C, true, v[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[j][k];
    }
  }
  const float mean = row_sum<LPR>(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * 8;
    if (live && c < C) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[j][k] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<LPR>(q) / C + eps);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * 8;
    if (c < C) {
      float g[8], b[8], o[8];
      load_param8<FULL>(gamma, c, C, gamma_f32, g);
      load_param8<FULL>(beta, c, C, beta_f32, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[j][k] - mean) * rstd * g[k] + b[k];
      store_y8<FULL>(y + (size_t)row * C, c, C, C, true, o);
    }
  }
}

// Sum over the four warps of a block (every thread gets it): a warp's sum,
// then the four in shared memory, read back in warp order.
__device__ __forceinline__ float block4_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const float t = red[0] + red[1] + red[2] + red[3];
  __syncthreads();   // red is reused by the next sum
  return t;
}

// One row a block of kWideThreads (four warps), VPL 16-byte chunks a thread:
// chunk j of thread i covers columns (j * kWideThreads + i) * 8 .. + 8. The
// statistics as ln_kernel's: f32 mean, f32 variance of the centred values.
constexpr int kWideThreads = 128;

template <int VPL, int MODE>
__global__ void __launch_bounds__(kWideThreads) ln_wide_kernel(const bf16* __restrict__ x,
                                                               const void* __restrict__ gamma,
                                                               const void* __restrict__ beta,
                                                               bf16* __restrict__ y, int C, int ld,
                                                               float eps, bool gamma_f32,
                                                               bool beta_f32) {
  __shared__ float red[4];
  if (MODE == FULL) ld = C;  // a FULL row's pitch is its width: one bound
  const bool vec = ld % 8 == 0;
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * ld;
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * 8;
    if (c < ld) {
      load_x8<MODE>(xr, c, C, vec, v[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[j][k];
    }
  }
  const float mean = block4_sum(s, red) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * 8;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[j][k] - mean;
        if (MODE == FULL || c + k < C) q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block4_sum(q, red) / C + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * 8;
    if (c < ld) {
      float g[8], b[8], o[8];
      load_param8<MODE>(gamma, c, C, gamma_f32, g);
      load_param8<MODE>(beta, c, C, beta_f32, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[j][k] - mean) * rstd * g[k] + b[k];
      store_y8<MODE>(y + row * ld, c, C, ld, vec, o);
    }
  }
}

template <int VPL, int MODE>
int launch_ln_wide(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                   int ld, float eps, int flags, cudaStream_t st) {
  ln_wide_kernel<VPL, MODE><<<rows, kWideThreads, 0, st>>>(static_cast<const bf16*>(x), gamma,
                                                          beta, static_cast<bf16*>(y), C, ld, eps,
                                                          flags & 1, (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

template <int VPL, int LPR>
int launch_ln(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
              float eps, int flags, cudaStream_t st) {
  constexpr int rows_per_block = kThreads / 32 * (32 / LPR);
  dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  ln_kernel<VPL, LPR><<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(x), gamma, beta,
                                                 static_cast<bf16*>(y), rows, C, eps, flags & 1,
                                                 (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

// Rows that are whole 16-byte chunks at pitch C, 8 <= C <= 16384.
int launch_packed(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                  float eps, int flags, cudaStream_t st) {
  if (C <= 64) return launch_ln<1, 8>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 128) return launch_ln<1, 16>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 256) return launch_ln<1, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 512) return launch_ln<2, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 1024) return launch_ln<4, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 2048) return launch_ln<8, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  // the InvPT stage norm over T*C task-merged channels (2880)
  if (C <= 3072) return launch_ln<12, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (C <= 4096) return launch_ln<16, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  // a block of four warps a row: the InvPT stage norm at embed_dim 1024 (5440)
  if (C <= 6144) return launch_ln_wide<6, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  if (C <= 8192) return launch_ln_wide<8, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  if (C <= 16384) return launch_ln_wide<16, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y (rows, ld) bf16, the first C columns of a row normalised and the rest
// up to ld written as zeros; 1 <= C <= ld <= 16384. gamma, beta (C,) f32 or
// bf16 (flags bit 0: gamma is f32, bit 1: beta is f32). Every pointer 16-byte
// aligned; rows at a pitch ld % 8 == 0 take 16-byte loads and stores, others
// 2-byte ones.
extern "C" int mtt_layernorm_ld_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                     int rows, int C, int ld, float eps, int flags, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (C <= 0 || ld < C || ld > 16384) return static_cast<int>(cudaErrorInvalidValue);
  if (ld == C && C % 8 == 0) return launch_packed(x, gamma, beta, y, rows, C, eps, flags, st);
  // a block of four warps a row, whatever the width
  const int W = (ld + 7) / 8 * 8;  // the chunks a row spans
  if (W <= 1024) return launch_ln_wide<1, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (W <= 2048) return launch_ln_wide<2, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (W <= 4096) return launch_ln_wide<4, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (W <= 8192) return launch_ln_wide<8, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  return launch_ln_wide<16, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
}

// x, y (rows, C) bf16, C <= 16384 (any C: rows that are not whole 16-byte
// chunks take 2-byte loads); gamma, beta as above.
extern "C" int mtt_layernorm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int C, float eps, int flags, void* stream) {
  if (rows <= 0) return 0;
  if (C > 0 && C % 8 == 0)
    return launch_packed(x, gamma, beta, y, rows, C, eps, flags, static_cast<cudaStream_t>(stream));
  return mtt_layernorm_ld_bf16(x, gamma, beta, y, rows, C, C, eps, flags, stream);
}

extern "C" const char* mtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
