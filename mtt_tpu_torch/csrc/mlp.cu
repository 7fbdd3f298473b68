// Transformer MLPs, bf16 in and out.
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
//   2. h = bf16(gelu_erf_poly(xn . w1^T + b1))          (gemm_kernel, EPI_GELU);
//   3. out = bf16(h . w2^T + b2 + x), the sum in f32    (gemm_kernel, EPI_RES).
// The hidden goes through device memory: 8232 x 4096 bf16 written once and read
// once, 135 MB or 0.04 ms at 3.35 TB/s. Each product is a GEMM of two K-major
// operands (x or h rows; w1 (Hd, C), w2 (C, Hd) as nn.Linear stores them):
// wgmma m64n128k16 (bf16 in, f32 accumulate) with A and B in shared memory
// (128-byte swizzle), fed by TMA through a ring of mbarrier stages by one
// producer thread, consumed by two warpgroups (gemm_kernel below): in turns on
// 128 x 128 tiles for fc1, so that one's GELU epilogue runs under the other's
// products, or together on 128 x 256 tiles for fc2. Blocks are persistent,
// one an SM. TMA's zero fill covers every ragged edge (rows past M, columns
// past N, K past its last 64-wide stage); the epilogue guards its stores. No
// split-K and no atomics: two runs give the same bits.
//
// The plain MLP out = fc2(gelu(fc1(x))) (mtt_mlp_fc_bf16) replaces
// mlp.py:_mlp_kernel (pallas_call at :142), which the training blocks with
// drop-path and the Swin-B stages run after a separate LayerNorm. It is still
// the first design (mlp_kernel): a block of 32 rows walks the hidden dimension
// in chunks of 128 columns, fc1 (wmma, f32), bias + A&S-erf GELU in f32, one
// bf16 rounding into shared memory, fc2 accumulated in registers; the hidden
// never leaves the chip, and every block reads both weight matrices from L2.
// Widths: the ViT trunks (C = 1024, 768), the InvPT decoder stages (C = 576,
// 288, 144, whose hidden 576 ends in half a chunk) and the Swin-B stages (C =
// 512, 256, 128).
#include <cuda.h>

#include "common.cuh"

using namespace mtt;

extern "C" int mtt_layernorm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                  int rows, int C, float eps, int flags, void* stream);

namespace {

// ---- the plain MLP (row 8) --------------------------------------------------

constexpr int MBM = 32;    // rows per block
constexpr int MHC = 128;   // hidden columns per chunk (16 per warp)
constexpr int MT = 256;    // 8 warps
constexpr int HFL = MHC + 4;
constexpr int HSL = MHC + 8;

template <int C>
constexpr int mlp_smem() {
  return MBM * (C + 8) * 2 + MBM * HFL * 4 + MBM * HSL * 2;
}

// The 16-wide output column tile that warp `warp` owns in slot jt: eight
// neighbouring tiles a warp when they divide evenly (the ViT trunks), else
// dealt in turn, with the slots past the last tile left idle.
template <int CT, int NCW>
__device__ __forceinline__ int warp_tile(int warp, int jt) {
  return CT % (MT / 32) == 0 ? warp * NCW + jt : warp + jt * (MT / 32);
}

// FULL: the hidden width is a multiple of the 128-column chunk, so no chunk
// is cut short and the guards for that compile out.
template <int C, bool FULL>
__global__ void __launch_bounds__(MT, 1) mlp_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, int M,
    int Hd) {
  constexpr int XL = C + 8;
  constexpr int CT = C / 16;                   // 16-wide output column tiles
  constexpr int NCW = (CT + MT / 32 - 1) / (MT / 32);  // tiles per warp
  constexpr bool EVEN = CT % (MT / 32) == 0;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XN = reinterpret_cast<bf16*>(smem);
  float* HF = reinterpret_cast<float*>(XN + MBM * XL);
  bf16* HS = reinterpret_cast<bf16*>(HF + MBM * HFL);

  const int m0 = blockIdx.x * MBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the block's rows of x, zero past M
  for (int r = warp; r < MBM; r += MT / 32) {
    bf16* dst = XN + r * XL;
    const bool live = m0 + r < M;
    const bf16* src = x + (size_t)(m0 + r) * C;
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(dst + c) =
          live ? *reinterpret_cast<const uint4*>(src + c) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  FragC acc[2][NCW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NCW; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int j0 = 0; j0 < Hd; j0 += MHC) {
    // fc1: this warp's 16 hidden columns for all 32 rows (none past Hd, in
    // the last chunk of a hidden width that is not a multiple of 128)
    const int jn = FULL ? MHC : min(MHC, Hd - j0);
    {
      FragC h[2];
      wmma::fill_fragment(h[0], 0.f);
      wmma::fill_fragment(h[1], 0.f);
      if (FULL || 16 * warp < jn) {
        const bf16* wp = w1 + (size_t)(j0 + 16 * warp) * C;
#pragma unroll 4
        for (int k = 0; k < C; k += 16) {
          FragBt bt;
          FragA a0, a1;
          wmma::load_matrix_sync(bt, wp + k, C);
          wmma::load_matrix_sync(a0, XN + k, XL);
          wmma::load_matrix_sync(a1, XN + 16 * XL + k, XL);
          wmma::mma_sync(h[0], a0, bt, h[0]);
          wmma::mma_sync(h[1], a1, bt, h[1]);
        }
      }
      wmma::store_matrix_sync(HF + 16 * warp, h[0], HFL, wmma::mem_row_major);
      wmma::store_matrix_sync(HF + 16 * HFL + 16 * warp, h[1], HFL, wmma::mem_row_major);
    }
    __syncthreads();
    // bias + GELU in f32, cast once before fc2 (mlp.py:96)
    for (int i = threadIdx.x; i < MBM * (MHC / 8); i += MT) {
      const int r = i / (MHC / 8), c = (i % (MHC / 8)) * 8;
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        f[k] = (FULL || c < jn) ? gelu_erf_poly(HF[r * HFL + c + k] + b1[j0 + c + k]) : 0.f;
      *reinterpret_cast<uint4*>(HS + r * HSL + c) = pack8(f);
    }
    __syncthreads();
    // fc2: accumulate this chunk into the warp's output columns
#pragma unroll
    for (int kk = 0; kk < MHC; kk += 16) {
      if (!FULL && kk >= jn) break;
      FragA a0, a1;
      wmma::load_matrix_sync(a0, HS + kk, HSL);
      wmma::load_matrix_sync(a1, HS + 16 * HSL + kk, HSL);
#pragma unroll
      for (int jt = 0; jt < NCW; ++jt) {
        const int tile = warp_tile<CT, NCW>(warp, jt);
        if (EVEN || tile < CT) {
          FragBt bt;
          wmma::load_matrix_sync(bt, w2 + (size_t)(tile * 16) * Hd + j0 + kk, Hd);
          wmma::mma_sync(acc[0][jt], a0, bt, acc[0][jt]);
          wmma::mma_sync(acc[1][jt], a1, bt, acc[1][jt]);
        }
      }
    }
  }
  __syncthreads();

  // epilogue: acc + b2 in f32, one bf16 rounding (mlp.py:105)
  float* scratch = HF + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jt = 0; jt < NCW; ++jt) {
      const int tile = warp_tile<CT, NCW>(warp, jt);
      if (!EVEN && tile >= CT) break;   // the same for every lane of the warp
      float v[8];
      frag_row8(acc[i][jt], scratch, lane, v);
      const int row = m0 + i * 16 + (lane >> 1);
      const int col = tile * 16 + (lane & 1) * 8;
      if (row < M) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = v[k] + b2[col + k];
        *reinterpret_cast<uint4*>(out + (size_t)row * C + col) = pack8(v);
      }
    }
}

template <int C, bool FULL>
int launch_mlp_full(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* out, int M, int Hd, cudaStream_t st) {
  constexpr int smem = mlp_smem<C>();
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(mlp_kernel<C, FULL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + MBM - 1) / MBM);
  mlp_kernel<C, FULL><<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), M, Hd);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int M, int Hd, cudaStream_t st) {
  return Hd % MHC == 0 ? launch_mlp_full<C, true>(x, w1, b1, w2, b2, out, M, Hd, st)
                       : launch_mlp_full<C, false>(x, w1, b1, w2, b2, out, M, Hd, st);
}

// ---- the GEMM of the half-block: wgmma fed by TMA ---------------------------
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B bf16, row-major with K
// contiguous (K-major for both wgmma operands, so neither is transposed).
// Warpgroup 0 produces: one thread keeps a ring of stages full with TMA, each
// stage one 128 x 64 box of A and BN / 128 such boxes of B. Warpgroups 1 and 2
// consume, each with two m64n128k16 products a 16-deep step into 128 f32
// accumulators, under one of two schedules:
//   ping-pong (the GELU epilogue): a warpgroup owns a whole 128 x 128 tile
//     (its halves are the tile's two 64-row halves) and the two take the
//     block's tiles in turns; a warpgroup issues its products only after the
//     other has issued all of its own. So one warpgroup's epilogue (a
//     reciprocal and an exp per value, 16,384 values) runs while the other's
//     products keep the tensor cores busy.
//   cooperative (the residual epilogue, light, after a long K walk): both
//     warpgroups share a 128 x 256 tile, warpgroup w its rows 64 w .. 64 w +
//     63 (its halves are the two 128-column halves); the wider tile moves a
//     quarter fewer bytes into shared memory per product.
// Blocks are persistent, one an SM, walking the tiles so that neighbouring
// blocks share A panels in L2.

constexpr int GBM = 128;       // rows of a tile, and of every TMA box
constexpr int GBK = 64;        // K per stage: one 128-byte swizzle row
constexpr int GTHREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int GBOX = GBM * GBK * 2;

enum { EPI_GELU = 0, EPI_RES = 1 };

template <bool PP>
struct GemmShape {
  static constexpr int BN = PP ? 128 : 256;
  static constexpr int STAGE = GBOX * (1 + BN / GBM);
  static constexpr int STAGES = PP ? 6 : 4;
  // the ring, 1 KB to align it to the swizzle's 1024-byte period, barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + (2 * STAGES + 2) * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One TMA copy of a (rows, 64) box at (row, k) of a 2-D tensor map into
// shared memory, completing on the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a K-major tile written by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO), the leading offset unused for this layout, layout type 1 (B128).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128, f32) += A (64 x 16) . B (128 x 16)^T, both from shared memory.
// Lane l of warp w of the warpgroup holds, for the 8-column group j, rows
// 16 w + l / 4 (registers 4 j, 4 j + 1) and 16 w + l / 4 + 8 (4 j + 2, 4 j + 3)
// at columns 8 j + 2 (l % 4) and + 1.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// gelu_erf_poly (common.cuh) with the reciprocal of its A&S polynomial taken
// without a branch: the approximate reciprocal refined by one Newton step
// (within an ulp of the rounded quotient; d >= 1 here, so no slow path is
// needed). The division's slow-path branch split every element's chain into
// its own basic block, which kept the compiler from interleaving the epilogue.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}

__device__ __forceinline__ float gelu_erf_poly_nb(float h) {
  const float z = h * 0.70710678118654752f;
  const float az = fabsf(z);
  const float t = rcp_newton(1.0f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float r = 1.0f - poly * expf(-az * az);
  return 0.5f * h * (1.0f + (z > 0.f ? r : (z < 0.f ? -r : 0.f)));
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  if constexpr (sizeof(T) == 4) return *reinterpret_cast<const float2*>(p);
  else return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A warpgroup's 128 accumulators: half h holds rows row_step h + 16 w + l / 4
// (+ 8) and columns col_step h + 8 j + 2 (l % 4) (+ 1) of the tile at (m0, n0).
// EPI_GELU: gelu(acc + bias) (mlp.py:303); EPI_RES: acc + bias + res, summed
// in that order in f32 (mlp.py:309-310); one bf16 rounding. Every value is
// finished first, with its loads clamped into the arrays, so the math has no
// branch; only the stores are guarded.
template <int EPI, typename BiasT>
__device__ __forceinline__ void gemm_epilogue(float (&d)[2][64], bf16* __restrict__ out,
                                              const BiasT* __restrict__ bias,
                                              const bf16* __restrict__ res, int m0, int n0,
                                              int row_step, int col_step, int M, int N, int t) {
  const int lane = t % 32, row0 = m0 + (t / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = min(col0 + h * col_step + 8 * j, N - 2);
      const float2 b = load_pair(bias + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& v0 = d[h][4 * j + 2 * r];
        float& v1 = d[h][4 * j + 2 * r + 1];
        if constexpr (EPI == EPI_GELU) {
          v0 = gelu_erf_poly_nb(v0 + b.x);
          v1 = gelu_erf_poly_nb(v1 + b.y);
        } else {
          const int row = min(row0 + h * row_step + 8 * r, M - 1);
          const float2 x = load_pair(res + (size_t)row * N + col);
          v0 = v0 + b.x + x.x;
          v1 = v1 + b.y + x.y;
        }
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + h * col_step + 8 * j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + h * row_step + 8 * r;
        if (row < M && col < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(d[h][4 * j + 2 * r], d[h][4 * j + 2 * r + 1]);
      }
    }
}

template <int EPI, bool PP, typename BiasT>
__global__ void __launch_bounds__(GTHREADS, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    bf16* __restrict__ out, const BiasT* __restrict__ bias, const bf16* __restrict__ res, int M,
    int N, int K) {
  using G = GemmShape<PP>;
  constexpr int BN = G::BN, STAGES = G::STAGES;
  constexpr uint32_t STAGE = G::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = ring + STAGES * STAGE;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;    // empty[s] at empty0 + 8 s
  const uint32_t done0 = empty0 + STAGES * 8;    // done[p] at done0 + 8 p
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + GBM - 1) / GBM) * tiles_n;
  const int nk = (K + GBK - 1) / GBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, PP ? 4 : 8);  // the consuming warps
    }
    mbar_init(done0, 4);
    mbar_init(done0 + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: the block's tiles in order, every K stage of each
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * GBM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t dst = ring + s * STAGE, bar = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, STAGE);
          tma_load_2d(dst, &map_a, kt * GBK, m0, bar);
#pragma unroll
          for (int i = 0; i < BN / GBM; ++i)
            tma_load_2d(dst + GBOX * (1 + i), &map_b, kt * GBK, n0 + GBM * i, bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    // ping-pong: the block's k-th tile belongs to warpgroup k % 2; its stages
    // are ring iterations k nk .. k nk + nk - 1
    for (int k = PP ? wg : 0;; k += PP ? 2 : 1) {
      const int tile = blockIdx.x + k * gridDim.x;
      if (tile >= tiles) break;
      const int m0 = (tile / tiles_n) * GBM, n0 = (tile % tiles_n) * BN;
      // ping-pong: the other warpgroup has issued every product of tile k - 1
      if (PP && k > 0) mbar_wait(done0 + 8 * ((k - 1) & 1), ((k - 1) >> 1) & 1);
      float d[2][64];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) d[h][i] = 0.f;
      int it = k * nk;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t a = ring + s * STAGE, b = a + GBOX;
        // the A and B rows of half 0 and half 1
        const uint32_t a0 = PP ? a : a + wg * 64 * 128, a1 = PP ? a + 64 * 128 : a0;
        const uint32_t b1 = PP ? b : b + GBOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {
          wgmma_m64n128k16(d[0], wgmma_desc(a0 + kk * 32), wgmma_desc(b + kk * 32));
          wgmma_m64n128k16(d[1], wgmma_desc(a1 + kk * 32), wgmma_desc(b1 + kk * 32));
        }
        wgmma_commit();
        if (PP && kt == nk - 1) {
          // every product of the tile is issued: the other warpgroup may
          // queue its own behind them
          __syncwarp();
          if (lane == 0) mbar_arrive(done0 + 8 * (k & 1));
        }
        // keep this stage's products in flight; release the previous stage
        wgmma_wait<1>();
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      gemm_epilogue<EPI>(d, out, bias, res, PP ? m0 : m0 + 64 * wg, n0, PP ? 64 : 0,
                         PP ? 0 : 128, M, N, t);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime so the
// library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) row-major bf16 tensor as (128, 64) boxes, 128-byte swizzle,
// zero fill past its edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {GBK, GBM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI, bool PP, typename BiasT>
int launch_gemm_s(const void* a, const void* b, void* out, const void* bias, const void* res,
                  int M, int N, int K, int sms, cudaStream_t st) {
  using G = GemmShape<PP>;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, K) || !make_map(&map_b, b, N, K))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_kernel<EPI, PP, BiasT>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + GBM - 1) / GBM) * ((N + G::BN - 1) / G::BN);
  kernel<<<tiles < sms ? tiles : sms, GTHREADS, G::SMEM, st>>>(
      map_a, map_b, static_cast<bf16*>(out), static_cast<const BiasT*>(bias),
      static_cast<const bf16*>(res), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The schedule: ping-pong for the GELU epilogue. For the residual one, the
// cooperative 128 x 256 tile unless its waves over the card take longer than
// the ping-pong tiles' (on the H100 a wave of wide tiles takes about 7/4 of
// a wave of narrow ones at ViT-L's fc2): at ViT-B's fc2 (N = 768) the 195 wide
// tiles are 1.5 waves of 132 SMs and ping-pong wins.
template <int EPI, typename BiasT>
int launch_gemm_t(const void* a, const void* b, void* out, const void* bias, const void* res,
                  int M, int N, int K, cudaStream_t st) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if constexpr (EPI == EPI_GELU) {
    return launch_gemm_s<EPI, true, BiasT>(a, b, out, bias, res, M, N, K, sms, st);
  } else {
    const int tm = (M + GBM - 1) / GBM;
    const int waves_wide = (tm * ((N + 255) / 256) + sms - 1) / sms;
    const int waves_narrow = (tm * ((N + 127) / 128) + sms - 1) / sms;
    return 7 * waves_wide > 4 * waves_narrow
               ? launch_gemm_s<EPI, true, BiasT>(a, b, out, bias, res, M, N, K, sms, st)
               : launch_gemm_s<EPI, false, BiasT>(a, b, out, bias, res, M, N, K, sms, st);
  }
}

template <int EPI>
int launch_gemm(const void* a, const void* b, void* out, const void* bias, bool bias_f32,
                const void* res, int M, int N, int K, cudaStream_t st) {
  return bias_f32 ? launch_gemm_t<EPI, float>(a, b, out, bias, res, M, N, K, st)
                  : launch_gemm_t<EPI, bf16>(a, b, out, bias, res, M, N, K, st);
}

}  // namespace

// The half-block x + fc2(gelu(fc1(LN(x)))) as three launches. x (M, C) bf16;
// w1 (Hd, C), w2 (C, Hd) bf16 as nn.Linear stores them; gamma, beta, b1, b2
// (flags bits 0-3: f32, else bf16); xn (M, C) and h (M, Hd) bf16 scratch. C % 8
// == 0 and C <= 4096, Hd % 8 == 0; every pointer 16-byte aligned (TMA's rule).
extern "C" int mtt_mlp_ln_res_bf16(const void* x, const void* gamma, const void* beta,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* xn, void* h, void* out, int M, int C, int Hd, float eps,
                                   int flags, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (C % 8 || C <= 0 || C > 4096 || Hd % 8 || Hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = mtt_layernorm_bf16(x, gamma, beta, xn, M, C, eps, flags & 3, stream);
  if (e) return e;
  e = launch_gemm<EPI_GELU>(xn, w1, h, b1, (flags >> 2) & 1, nullptr, M, Hd, C, st);
  if (e) return e;
  return launch_gemm<EPI_RES>(h, w2, out, b2, (flags >> 3) & 1, x, M, C, Hd, st);
}

// The plain MLP out = fc2(gelu(fc1(x))): x (M, C) bf16, b1 and b2 f32. C is
// 1024, 768, 576, 288, 144 or a Swin-B stage width 512, 256, 128 (8, 16 and 32
// column tiles: 1, 2 and 4 a warp); Hd % 16 == 0. The Swin-B row counts run
// from 73,728 down to the 3 prompt rows, which one block takes with 29 of its
// 32 rows zero-filled and never stored.
extern "C" int mtt_mlp_fc_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int M, int C, int Hd, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Hd % 16 || Hd < 16) return static_cast<int>(cudaErrorInvalidValue);
#define MTT_MLP_CASE(W) \
  if (C == W) return launch_mlp<W>(x, w1, b1, w2, b2, out, M, Hd, st);
  MTT_MLP_CASE(1024) MTT_MLP_CASE(768) MTT_MLP_CASE(576) MTT_MLP_CASE(288) MTT_MLP_CASE(144)
  MTT_MLP_CASE(512) MTT_MLP_CASE(256) MTT_MLP_CASE(128)   // the Swin-B stages
#undef MTT_MLP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
