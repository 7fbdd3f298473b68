// Row LayerNorm over the last axis, bf16 or f32 in and out, f32 statistics.
//
// Replaces mtt_tpu/kernels/layernorm.py:_ln_kernel. On the H100 it is bound by
// device memory: one read and one write of the (rows, C) tensor, about 34 MB for
// the ViT-L tap input (8, 1029, 1024) in bf16, 10 us at 3.35 TB/s (68 MB and
// 20 us in f32). A row lives in the registers of 8, 16 or 32 lanes of one warp
// (8, 16 or more 16-byte chunks a row), so a warp takes four, two or one rows
// and no lane idles at the Swin-B stage width C = 128. x is read once with
// 16-byte loads, the two reductions are shuffles over the row's lanes, and the
// normalised row is written once with 16-byte stores. gamma and beta are read
// in their stored dtype (bf16 or f32) with 16-byte loads (8-byte ones for
// four bf16 values), once per lane, and widened in registers (bf16 to f32 is
// exact), so the wrappers launch no cast kernel. The same kernel is the first
// stage of the attention front halves (attention.cu) and of the MLP half-block
// (mlp.cu).
//
// The kernels are templates over the element type T of x and y: a 16-byte
// chunk is 8 bf16 or 4 f32 values (Chunk<T>::N), and every width below is
// counted in chunks, so the bf16 instantiations are the kernels this file had
// before its f32 form. The f32 form (mtt_layernorm_f32, the TaskPrompter-ViT
// eval forward at JAX's default dtype) computes the same statistics in the
// same order; with nothing to round, y is the f32 value itself.
//
// Rows past 512 chunks (bf16: 4096 columns, InvPT's task-merged stage norm at
// embed_dim 1024 is 5 tasks x 1088 = 5440; f32: 2048 columns) would need more
// than 128 values a lane in one warp. There a block of four warps takes a row
// (ln_wide_kernel), each lane keeping up to VPL 16-byte chunks in registers,
// and the two sums meet across the warps in shared memory; every load and
// store stays 16 bytes wide. That gives one block a row, 2,048 blocks at the
// stage-0 norm of a PASCAL batch of 8 (over 15 an SM), up to 16,384 columns.
//
// Rows of C columns that are not whole 16-byte chunks (InvPT's stage norms
// at embed_dim 600: 5 x 332 = 1660 and 5 x 166 = 830) take ln_wide_kernel in
// its ANY mode, whose rows lie at a pitch ld >= C: the statistics and the
// affine count the first C columns only, and the columns C .. ld - 1 are
// written as zeros. At a pitch that is a whole number of chunks (the MLP
// half-block's zero-padded copy of x: the padded row is LN(x) followed by
// zeros) the loads and stores stay 16 bytes wide; rows packed at pitch C (a
// LayerNorm call on such a tensor) start off the 16-byte grid, so there every
// value is loaded and stored alone. The tail chunk of gamma and beta is read
// value by value.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int kThreads = 256;

// How a row is read and written: FULL rows are whole 16-byte chunks at pitch C
// (every model's width but InvPT's at embed_dim 600); ANY rows lie at a pitch
// ld >= C, with 16-byte accesses where vec (ld a whole number of chunks), else
// value by value.
enum RowMode { FULL = 0, ANY = 1 };

template <typename T>
struct Chunk;
template <>
struct Chunk<bf16> {
  static constexpr int N = 8;
};
template <>
struct Chunk<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// One 16-byte chunk of T, widened to f32, and its packing back.
__device__ __forceinline__ void unpack_chunk(const uint4& raw, float* f, bf16*) { unpack8(raw, f); }
__device__ __forceinline__ void unpack_chunk(const uint4& raw, float* f, float*) {
  f[0] = __uint_as_float(raw.x), f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z), f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack_chunk(const float* f, bf16*) { return pack8(f); }
__device__ __forceinline__ uint4 pack_chunk(const float* f, float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// CH parameters from column c, widened to f32, zero at and past C: 16-byte
// loads of f32 (CH / 4 of them), one 16-byte (CH 8) or 8-byte (CH 4) load of
// bf16 for a whole chunk, else value by value.
template <int MODE, int CH>
__device__ __forceinline__ void load_param(const void* p, int c, int C, bool is_f32, float* out) {
  if (MODE == FULL || c + CH <= C) {
    if (is_f32) {
      const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + c);
#pragma unroll
      for (int i = 0; i < CH / 4; ++i) {
        const float4 a = q[i];
        out[4 * i] = a.x, out[4 * i + 1] = a.y, out[4 * i + 2] = a.z, out[4 * i + 3] = a.w;
      }
    } else if constexpr (CH == 8) {
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + c), out);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + c);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < CH; ++k)
    out[k] = c + k >= C ? 0.f
             : is_f32   ? static_cast<const float*>(p)[c + k]
                        : __bfloat162float(static_cast<const bf16*>(p)[c + k]);
}

// One chunk of the row xr from column c (c a multiple of the chunk), widened
// to f32, zero at and past C. FULL rows, and ANY rows where vec, start on a
// 16-byte boundary, so a whole chunk is one 16-byte load.
template <int MODE, typename T>
__device__ __forceinline__ void load_x(const T* xr, int c, int C, bool vec, float* out) {
  constexpr int CH = Chunk<T>::N;
  if (MODE == FULL || (vec && c + CH <= C)) {
    unpack_chunk(*reinterpret_cast<const uint4*>(xr + c), out, static_cast<T*>(nullptr));
    return;
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) out[k] = c + k < C ? to_f32(xr[c + k]) : 0.f;
}

// The normalised chunk o of columns c .. c + CH - 1 into the row yr, zeros
// from C on, nothing at or past ld: one 16-byte store where FULL or vec.
template <int MODE, typename T>
__device__ __forceinline__ void store_y(T* yr, int c, int C, int ld, bool vec, const float* o) {
  constexpr int CH = Chunk<T>::N;
  if (MODE == FULL) {
    *reinterpret_cast<uint4*>(yr + c) = pack_chunk(o, static_cast<T*>(nullptr));
    return;
  }
  float z[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) z[k] = c + k < C ? o[k] : 0.f;
  if (vec) {
    *reinterpret_cast<uint4*>(yr + c) = pack_chunk(z, static_cast<T*>(nullptr));
    return;
  }
#pragma unroll
  for (int k = 0; k < CH; ++k)
    if (c + k < ld) yr[c + k] = from_f32<T>(z[k]);
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
// rsqrt(var + eps), affine in f32, one rounding to T. FULL rows only.
template <typename T, int VPL, int LPR>
__global__ void __launch_bounds__(kThreads) ln_kernel(const T* __restrict__ x,
                                                       const void* __restrict__ gamma,
                                                       const void* __restrict__ beta,
                                                       T* __restrict__ y, int rows, int C,
                                                       float eps, bool gamma_f32, bool beta_f32) {
  constexpr int RPW = 32 / LPR, CH = Chunk<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp_row0 = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * RPW;
  if (warp_row0 >= rows) return;  // the same for every lane of the warp
  const int row = warp_row0 + lane / LPR, l = lane % LPR;
  const bool live = row < rows;
  const T* xr = x + (size_t)row * C;

  float v[VPL][CH];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * CH;
    if (live && c < C) {
      load_x<FULL>(xr, c, C, true, v[j]);
#pragma unroll
      for (int k = 0; k < CH; ++k) s += v[j][k];
    }
  }
  const float mean = row_sum<LPR>(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * CH;
    if (live && c < C) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const float d = v[j][k] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<LPR>(q) / C + eps);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * LPR + l) * CH;
    if (c < C) {
      float g[CH], b[CH], o[CH];
      load_param<FULL, CH>(gamma, c, C, gamma_f32, g);
      load_param<FULL, CH>(beta, c, C, beta_f32, b);
#pragma unroll
      for (int k = 0; k < CH; ++k) o[k] = (v[j][k] - mean) * rstd * g[k] + b[k];
      store_y<FULL>(y + (size_t)row * C, c, C, C, true, o);
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
// chunk j of thread i covers columns (j * kWideThreads + i) * CH .. + CH. The
// statistics as ln_kernel's: f32 mean, f32 variance of the centred values.
constexpr int kWideThreads = 128;

template <typename T, int VPL, int MODE>
__global__ void __launch_bounds__(kWideThreads) ln_wide_kernel(const T* __restrict__ x,
                                                               const void* __restrict__ gamma,
                                                               const void* __restrict__ beta,
                                                               T* __restrict__ y, int C, int ld,
                                                               float eps, bool gamma_f32,
                                                               bool beta_f32) {
  constexpr int CH = Chunk<T>::N;
  __shared__ float red[4];
  if (MODE == FULL) ld = C;  // a FULL row's pitch is its width: one bound
  const bool vec = ld % CH == 0;
  const size_t row = blockIdx.x;
  const T* xr = x + row * ld;
  float v[VPL][CH];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * CH;
    if (c < ld) {
      load_x<MODE>(xr, c, C, vec, v[j]);
#pragma unroll
      for (int k = 0; k < CH; ++k) s += v[j][k];
    }
  }
  const float mean = block4_sum(s, red) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * CH;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const float d = v[j][k] - mean;
        if (MODE == FULL || c + k < C) q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block4_sum(q, red) / C + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = (j * kWideThreads + threadIdx.x) * CH;
    if (c < ld) {
      float g[CH], b[CH], o[CH];
      load_param<MODE, CH>(gamma, c, C, gamma_f32, g);
      load_param<MODE, CH>(beta, c, C, beta_f32, b);
#pragma unroll
      for (int k = 0; k < CH; ++k) o[k] = (v[j][k] - mean) * rstd * g[k] + b[k];
      store_y<MODE>(y + row * ld, c, C, ld, vec, o);
    }
  }
}

template <typename T, int VPL, int MODE>
int launch_ln_wide(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                   int ld, float eps, int flags, cudaStream_t st) {
  ln_wide_kernel<T, VPL, MODE><<<rows, kWideThreads, 0, st>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), C, ld, eps, flags & 1,
      (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VPL, int LPR>
int launch_ln(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
              float eps, int flags, cudaStream_t st) {
  constexpr int rows_per_block = kThreads / 32 * (32 / LPR);
  dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  ln_kernel<T, VPL, LPR><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), gamma, beta,
                                                    static_cast<T*>(y), rows, C, eps, flags & 1,
                                                    (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

// Rows that are whole 16-byte chunks at pitch C, up to 16384 columns; n the
// chunks a row (bf16: C / 8, f32: C / 4).
template <typename T>
int launch_packed(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                  float eps, int flags, cudaStream_t st) {
  const int n = C / Chunk<T>::N;
  if (n <= 8) return launch_ln<T, 1, 8>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 16) return launch_ln<T, 1, 16>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 32) return launch_ln<T, 1, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 64) return launch_ln<T, 2, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 128) return launch_ln<T, 4, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 256) return launch_ln<T, 8, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  // the InvPT stage norm over T*C task-merged channels (2880)
  if (n <= 384) return launch_ln<T, 12, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  if (n <= 512) return launch_ln<T, 16, 32>(x, gamma, beta, y, rows, C, eps, flags, st);
  // a block of four warps a row: the InvPT stage norm at embed_dim 1024 (5440)
  if (n <= 768) return launch_ln_wide<T, 6, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  if (n <= 1024) return launch_ln_wide<T, 8, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  if (n <= 2048) return launch_ln_wide<T, 16, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  if constexpr (Chunk<T>::N == 4) {
    // f32 rows of 8192 .. 16384 columns
    if (n <= 4096) return launch_ln_wide<T, 32, FULL>(x, gamma, beta, y, rows, C, C, eps, flags, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows at a pitch ld >= C: a block of four warps a row, whatever the width.
template <typename T>
int launch_any(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
               int ld, float eps, int flags, cudaStream_t st) {
  const int n = (ld + Chunk<T>::N - 1) / Chunk<T>::N;  // the chunks a row spans
  if (n <= 128) return launch_ln_wide<T, 1, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (n <= 256) return launch_ln_wide<T, 2, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (n <= 512) return launch_ln_wide<T, 4, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if (n <= 1024) return launch_ln_wide<T, 8, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  if constexpr (Chunk<T>::N == 4) {
    // f32 rows of 8192 .. 16384 columns
    if (n > 2048) return launch_ln_wide<T, 32, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
  }
  return launch_ln_wide<T, 16, ANY>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
}

template <typename T>
int layernorm_ld(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                 int ld, float eps, int flags, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (C <= 0 || ld < C || ld > 16384) return static_cast<int>(cudaErrorInvalidValue);
  if (ld == C && C % Chunk<T>::N == 0)
    return launch_packed<T>(x, gamma, beta, y, rows, C, eps, flags, st);
  return launch_any<T>(x, gamma, beta, y, rows, C, ld, eps, flags, st);
}

template <typename T>
int layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
              float eps, int flags, void* stream) {
  if (rows <= 0) return 0;
  if (C > 0 && C % Chunk<T>::N == 0)
    return launch_packed<T>(x, gamma, beta, y, rows, C, eps, flags,
                            static_cast<cudaStream_t>(stream));
  return layernorm_ld<T>(x, gamma, beta, y, rows, C, C, eps, flags, stream);
}

}  // namespace

// x, y (rows, ld) bf16, the first C columns of a row normalised and the rest
// up to ld written as zeros; 1 <= C <= ld <= 16384. gamma, beta (C,) f32 or
// bf16 (flags bit 0: gamma is f32, bit 1: beta is f32). Every pointer 16-byte
// aligned; rows at a pitch ld % 8 == 0 take 16-byte loads and stores, others
// 2-byte ones.
extern "C" int mtt_layernorm_ld_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                     int rows, int C, int ld, float eps, int flags, void* stream) {
  return layernorm_ld<bf16>(x, gamma, beta, y, rows, C, ld, eps, flags, stream);
}

// x, y (rows, C) bf16, C <= 16384 (any C: rows that are not whole 16-byte
// chunks take 2-byte loads); gamma, beta as above.
extern "C" int mtt_layernorm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int C, float eps, int flags, void* stream) {
  return layernorm<bf16>(x, gamma, beta, y, rows, C, eps, flags, stream);
}

// The f32 forms: x, y f32, 16-byte chunks of 4 values (rows at a pitch
// ld % 4 == 0 take 16-byte accesses, others 4-byte ones); gamma, beta as
// above.
extern "C" int mtt_layernorm_ld_f32(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, int C, int ld, float eps, int flags, void* stream) {
  return layernorm_ld<float>(x, gamma, beta, y, rows, C, ld, eps, flags, stream);
}

extern "C" int mtt_layernorm_f32(const void* x, const void* gamma, const void* beta, void* y,
                                 int rows, int C, float eps, int flags, void* stream) {
  return layernorm<float>(x, gamma, beta, y, rows, C, eps, flags, stream);
}

extern "C" const char* mtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
