// The port's bf16 GEMM with fused epilogues: wgmma fed by TMA.
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B bf16, row-major with K
// contiguous (K-major for both wgmma operands, so neither is transposed): the
// activation rows, and the weight as nn.Linear stores it. The sum is f32 and
// rounded to bf16 once, after the epilogue (gemm.cuh):
//   EPI_GELU  gelu(acc + bias)           fc1 of rows 4 and 8 (mlp.py:96, :303)
//   EPI_RES   acc + bias + res           fc2 of row 4 (mlp.py:309-310)
//   EPI_BIAS  acc + bias                 fc2 of row 8 (mlp.py:105) and the qkv
//                                        projection of rows 1-2 (attention.py:
//                                        433-436)
//   EPI_NONE  acc                        the up4 head's Gm, x . kc over its 9
//                                        taps (head_up4.py:168-190)
//   EPI_TAIL  acc                        the InvPT tail's Gm, one launch a
//                                        scale (invpt_tail.py:297-330)
// These products are the tensor-core work of their TPU kernels (138 GFLOP of
// row 4 at ViT-L eval shapes, 52 GFLOP of one qkv projection), so the design
// is about keeping the tensor cores fed. Warpgroup 0 produces: one thread
// keeps a ring of stages full with TMA, each stage one BM x 64 box of A and
// BN / 128 boxes of 128 x 64 of B (128-byte swizzle, so the boxes are wgmma's
// shared-memory layout as they land). Warpgroups 1 and 2 consume, each with
// m64n128k16 products a 16-deep step into f32 accumulators, under one of
// three schedules (launch_gemm_t picks one by waves):
//   ping-pong (the GELU epilogue): a warpgroup owns a whole 128 x 128 tile
//     (its halves are the tile's two 64-row halves) and the two take the
//     block's tiles in turns; a warpgroup issues its products only after the
//     other has issued all of its own. So one warpgroup's epilogue (a
//     reciprocal and an exp per value, 16,384 values) runs while the other's
//     products keep the tensor cores busy.
//   wide (the light epilogues, after a long K walk): both warpgroups share a
//     128 x 256 tile, warpgroup w its rows 64 w .. 64 w + 63 (its halves are
//     the two 128-column halves); the wider tile moves a quarter fewer bytes
//     into shared memory per product.
//   half (few rows): both warpgroups share a 64 x 256 tile, warpgroup w its
//     columns 128 w .. 128 w + 127 (one half), so that twice as many tiles
//     fill the card where the wide ones would leave SMs idle.
// Blocks are persistent, one an SM, walking the tiles so that neighbouring
// blocks share A panels in L2. TMA's zero fill covers every ragged edge (rows
// past M, columns past N, K past its last 64-wide stage), and the epilogue
// writes through shared memory with TMA stores, which clip at the edges and
// run while the warpgroup goes on to its next tile (at the qkv projection's
// short K, stores from registers had cost 40% of the launch). No split-K and
// no atomics: two runs give the same bits.
#include "gemm.cuh"
#include "tma.cuh"

using namespace mtt;

namespace {

constexpr int GBM = 128;       // rows of a tile, and of every TMA box
constexpr int GBK = TMA_BK;    // K per stage: one 128-byte swizzle row
constexpr int GTHREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int GBOX = GBM * GBK * 2;
constexpr int OBOX = 64 * 64 * 2;  // a 64 x 64 box of the output, bf16

// The three schedules (gemm_kernel): ping-pong 128 x 128 tiles, one a
// warpgroup; wide 128 x 256 tiles and half 64 x 256 tiles, shared by both.
enum { SCHED_PINGPONG = 0, SCHED_WIDE = 1, SCHED_HALF = 2 };

template <int SCHED>
struct GemmShape {
  static constexpr bool PP = SCHED == SCHED_PINGPONG;
  static constexpr int BM = SCHED == SCHED_HALF ? 64 : GBM;
  static constexpr int BN = PP ? 128 : 256;
  static constexpr int ABOX = BM * GBK * 2;
  static constexpr int STAGE = ABOX + GBOX * (BN / GBM);
  static constexpr int STAGES = PP ? 6 : 4;
  // two 64 x 64 output boxes a consumer warpgroup: half of its 8192 outputs
  // at a time, for the TMA store
  static constexpr int OUT = 2 * 2 * OBOX;
  // the ring and the output boxes, 1 KB to align them to the swizzle's
  // 1024-byte period, barriers
  static constexpr int SMEM = STAGES * STAGE + OUT + 1024 + (2 * STAGES + 2) * 8;
};

// The exact-form GELU on the Abramowitz-Stegun 7.1.26 erf (|err| <= 1.5e-7), as
// mtt_tpu/kernels/mlp.py:_erf_poly/_gelu_erf_poly compute it, with the
// reciprocal of its polynomial taken without a branch: the approximate
// reciprocal refined by one Newton step (within an ulp of the rounded
// quotient; d >= 1 here, so no slow path is needed). The division's slow-path
// branch split every element's chain into its own basic block, which kept the
// compiler from interleaving the epilogue.
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

// A warpgroup's accumulators, NH halves of 64: half h holds rows row_step h +
// 16 w + l / 4 (+ 8) and columns col_step h + 8 j + 2 (l % 4) (+ 1) of the
// tile at (m0, n0).
// The epilogue (gemm.cuh) sums in f32 in the order written there and rounds
// once. Every value is finished first, with its loads clamped into the
// arrays, so the math has no branch. Then half by half, the bf16 pairs go to
// the warpgroup's two 64 x 64 output boxes in shared memory (box j / 8, in the
// 128-byte swizzle, so the eight rows of a store land in eight bank groups),
// and one thread hands the boxes to TMA stores, which clip the tensor's edges
// and write whole lines while the warpgroup goes on: to the other half, then
// to its next tile's products.
template <int EPI, int NH, typename BiasT>
__device__ __forceinline__ void gemm_epilogue(float (&d)[2][64], uint32_t boxes,
                                              const CUtensorMap* map_out,
                                              const BiasT* __restrict__ bias,
                                              const bf16* __restrict__ res, int m0, int n0,
                                              int row_step, int col_step, int M, int N, int t,
                                              int wg) {
  const int lane = t % 32, row0 = m0 + (t / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = min(col0 + h * col_step + 8 * j, N - 2);
      float2 b = make_float2(0.f, 0.f);
      if constexpr (epi_reads_bias(EPI)) b = load_pair(bias + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& v0 = d[h][4 * j + 2 * r];
        float& v1 = d[h][4 * j + 2 * r + 1];
        if constexpr (EPI == EPI_GELU) {
          v0 = gelu_erf_poly_nb(v0 + b.x);
          v1 = gelu_erf_poly_nb(v1 + b.y);
        } else if constexpr (EPI == EPI_RES) {
          const int row = min(row0 + h * row_step + 8 * r, M - 1);
          const float2 x = load_pair(res + (size_t)row * N + col);
          v0 = v0 + b.x + x.x;
          v1 = v1 + b.y + x.y;
        } else if constexpr (EPI == EPI_BIAS) {
          v0 = v0 + b.x;
          v1 = v1 + b.y;
        }
      }
    }
  const int rr = (t / 32) * 16 + lane / 4;  // row in the box; rr % 8 == lane / 4
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    // the boxes are free once this warpgroup's previous stores have read them
    if (t == 0) bulk_wait_read();
    warpgroup_bar(1 + wg);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at = boxes + (j / 8) * OBOX + (rr + 8 * r) * 128 +
                            (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16x2(d[h][4 * j + 2 * r], d[h][4 * j + 2 * r + 1]))
                     : "memory");
      }
    fence_proxy_async();
    warpgroup_bar(1 + wg);
    if (t == 0) {
      const int row = m0 + h * row_step;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = n0 + h * col_step + 64 * b;
        if (row < M && col < N) tma_store_2d(map_out, boxes + b * OBOX, col, row);
      }
      bulk_commit();
    }
  }
}

template <int EPI, int SCHED, typename BiasT>
__global__ void __launch_bounds__(GTHREADS, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, const BiasT* __restrict__ bias,
    const bf16* __restrict__ res, int M, int N, int K) {
  using G = GemmShape<SCHED>;
  constexpr bool PP = G::PP, HALF = SCHED == SCHED_HALF;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  constexpr uint32_t STAGE = G::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t boxes = ring + STAGES * STAGE;  // warpgroup w's at boxes + 2 w OBOX
  const uint32_t full0 = boxes + G::OUT;         // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;    // empty[s] at empty0 + 8 s
  const uint32_t done0 = empty0 + STAGES * 8;    // done[p] at done0 + 8 p
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
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
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t dst = ring + s * STAGE, bar = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, STAGE);
          tma_load_2d(dst, &map_a, kt * GBK, m0, bar);
#pragma unroll
          for (int i = 0; i < BN / GBM; ++i)
            tma_load_2d(dst + G::ABOX + GBOX * i, &map_b, kt * GBK, n0 + GBM * i, bar);
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
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
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
        const uint32_t a = ring + s * STAGE, b = a + G::ABOX;
        // the A and B rows of half 0 and half 1 (half: one half, the
        // warpgroup's 128 columns)
        const uint32_t a0 = PP || HALF ? a : a + wg * 64 * 128, a1 = PP ? a + 64 * 128 : a0;
        const uint32_t b0 = HALF ? b + wg * GBOX : b, b1 = PP ? b : b + GBOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {
          wgmma_m64n128k16(d[0], wgmma_desc(a0 + kk * 32), wgmma_desc(b0 + kk * 32));
          if constexpr (!HALF)
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
      gemm_epilogue<EPI, HALF ? 1 : 2>(d, boxes + 2 * OBOX * wg, &map_out, bias, res,
                                       PP || HALF ? m0 : m0 + 64 * wg, HALF ? n0 + 128 * wg : n0,
                                       PP ? 64 : 0, PP ? 0 : 128, M, N, t, wg);
    }
    // the last stores have written the tensor before the block's shared
    // memory goes
    if (t == 0) bulk_wait();
  }
}

template <int EPI, int SCHED, typename BiasT>
int launch_gemm_s(const void* a, const void* b, void* out, const void* bias, const void* res,
                  int M, int N, int K, int dev, int sms, cudaStream_t st) {
  using G = GemmShape<SCHED>;
  CUtensorMap map_a, map_b, map_out;
  if (!make_map(&map_a, a, M, K, G::BM) || !make_map(&map_b, b, N, K, GBM) ||
      !make_map(&map_out, out, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_kernel<EPI, SCHED, BiasT>;
  // the shared-memory allowance belongs to the device's context: set once per
  // device for this instantiation
  static std::atomic<bool> allowed[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !allowed[dev].load(std::memory_order_relaxed)) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) allowed[dev].store(true, std::memory_order_relaxed);
  }
  const int tiles = ((M + G::BM - 1) / G::BM) * ((N + G::BN - 1) / G::BN);
  kernel<<<tiles < sms ? tiles : sms, GTHREADS, G::SMEM, st>>>(
      map_a, map_b, map_out, static_cast<const BiasT*>(bias), static_cast<const bf16*>(res), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}

// The schedule: ping-pong for the GELU epilogue. For the others, the one
// whose waves over the card take the least time, counted in the time of a
// wave of each tile shape on the H100 (ping-pong 8, wide 14, half 9: a wide
// tile is twice the work at 7/8 of the rate; a half tile is a narrow one's
// work with 5/4 of its bytes through shared memory). At ViT-L's fc2 (N =
// 1024) the 260 wide tiles are two waves of 132 SMs; at ViT-B's (N = 768) the
// 195 wide tiles are 1.5 waves and ping-pong wins; at the ViT-L step's 2058
// rows the 132 half tiles are one wave where the 68 wide ones leave half the
// card idle.
template <int EPI, typename BiasT>
int launch_gemm_t(const void* a, const void* b, void* out, const void* bias, const void* res,
                  int M, int N, int K, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = sm_count(dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (EPI == EPI_GELU) {
    return launch_gemm_s<EPI, SCHED_PINGPONG, BiasT>(a, b, out, bias, res, M, N, K, dev, sms, st);
  } else {
    auto waves = [&](int bm, int bn) {
      return (((M + bm - 1) / bm) * ((N + bn - 1) / bn) + sms - 1) / sms;
    };
    const int narrow = 8 * waves(128, 128), wide = 14 * waves(128, 256), half = 9 * waves(64, 256);
    if (wide <= narrow && wide <= half)
      return launch_gemm_s<EPI, SCHED_WIDE, BiasT>(a, b, out, bias, res, M, N, K, dev, sms, st);
    if (narrow <= half)
      return launch_gemm_s<EPI, SCHED_PINGPONG, BiasT>(a, b, out, bias, res, M, N, K, dev, sms,
                                                      st);
    return launch_gemm_s<EPI, SCHED_HALF, BiasT>(a, b, out, bias, res, M, N, K, dev, sms, st);
  }
}

template <int EPI>
int launch_gemm(const void* a, const void* b, void* out, const void* bias, bool bias_f32,
                const void* res, int M, int N, int K, cudaStream_t st) {
  return bias_f32 ? launch_gemm_t<EPI, float>(a, b, out, bias, res, M, N, K, st)
                  : launch_gemm_t<EPI, bf16>(a, b, out, bias, res, M, N, K, st);
}

}  // namespace

extern "C" int mtt_gemm_bf16(const void* a, const void* b, void* out, const void* bias,
                             int bias_f32, const void* res, int M, int N, int K, int epi,
                             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || (epi == EPI_RES && !res))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  switch (epi) {
    case EPI_GELU: return launch_gemm<EPI_GELU>(a, b, out, bias, bias_f32, res, M, N, K, st);
    case EPI_RES: return launch_gemm<EPI_RES>(a, b, out, bias, bias_f32, res, M, N, K, st);
    case EPI_BIAS: return launch_gemm<EPI_BIAS>(a, b, out, bias, bias_f32, res, M, N, K, st);
    case EPI_NONE: return launch_gemm_t<EPI_NONE, float>(a, b, out, nullptr, nullptr, M, N, K, st);
    case EPI_TAIL: return launch_gemm_t<EPI_TAIL, float>(a, b, out, nullptr, nullptr, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
