// The port's f32 GEMM with fused epilogues: 3xTF32 on wgmma, fed by TMA.
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B f32, row-major with K
// contiguous (activations, and weights as nn.Linear stores them), the same
// epilogues as the bf16 GEMM (gemm.cuh), summed in the same order:
//   EPI_GELU  gelu_erf_poly(acc + bias)   fc1 of row 4 (mlp.py:303)
//   EPI_RES   acc + bias + res            fc2 of row 4 (mlp.py:309-310)
//   EPI_BIAS  acc + bias                  the qkv projection of rows 1-2
//                                         (attention.py:433-436)
//   EPI_NONE  acc                         the up4 head's Gm (head_up4.py)
// It is the f32 form of the products that gemm.cu computes in bf16, for the
// TaskPrompter-ViT eval forward at JAX's default dtype, where every
// .astype(x.dtype) of the TPU kernels is the identity: nothing is rounded
// but the f32 sums themselves. The reference is torch.matmul with TF32 off
// (the exact f32 product); this kernel holds it to f32 accuracy with three
// TF32 products: each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
// (common.cuh: split_tf32), and every k-step adds lo.hi, hi.lo, then hi.hi
// (the small terms first). The dropped lo.lo and lo's own rounding leave
// about 2^-22 of each term; a single TF32 pass (2^-11) would not hold the f32
// forms' 1e-5 and is not used. TF32 stays off for every library call of the
// port (utils/precision.py).
//
// What bounds it on the H100: three TF32 passes on the tensor cores, 495
// TFLOP/s dense, so 165 TFLOP/s of f32 products; fc1 and fc2 of a ViT-L
// block (8232 x 1024 x 4096, 69 GFLOP) 0.419 ms each, the qkv projection
// 0.314, against 0.03-0.05 ms of bytes at 3.35 TB/s: the operations bound
// it. (On the CUDA cores, 67 TFLOP/s, the same products take 1.03 ms.)
//
// The design is the shared bf16 GEMM's (gemm.cu, tma.cuh) with TF32
// operands. Both are K-major, as wgmma's tf32 form requires. Warpgroup 0
// produces: one thread keeps a ring of three stages full with TMA, each stage
// a 128 x 32 box of A and one of B (128-byte swizzle: a row of 32 floats is
// one swizzle row, so the boxes are wgmma's shared-memory layout as they
// land; rows past M or N and K past its end are zero-filled, and A is read at
// its row pitch lda). Warpgroups 1 and 2 consume a 128 x 128 tile together,
// warpgroup w its rows 64 w .. 64 w + 63, persistent blocks (one an SM)
// walking the tiles so that neighbouring blocks share A panels in L2. When a
// stage lands, the 256 consumer threads split it once, element by element in
// its swizzled layout: hi over the raw f32 in place, lo into the stage's
// second half; a proxy fence and a barrier of the two warpgroups hand both to
// the tensor core. Each of the stage's four k-steps issues m64n128k8 tf32
// products for lo.hi, hi.lo and hi.hi.
//   The tensor core adds into its f32 accumulator by truncation, at the
// accumulator's ulp: with a K of 1024 folded into one accumulator (384
// products of k 8), row 1's f32 front half read 1.4e-5 relative RMS from its
// exact f32 plain version on the card, and row 4 missed 1e-5 too. So a
// stage's 12 products go into a partial accumulator that starts from zero,
// and the partial joins the tile's f32 sum in registers with round-to-nearest
// adds, once a stage. While one stage's products run the next stage is
// split; then the partial is added and the stage released. The epilogue runs in f32 in registers and stores pairs of
// columns straight to device memory (rows at pitch ldo; edges clipped). No
// split-K and no atomics: each output is one sum over K in a fixed order, so
// two runs give the same bits.
#include "gemm.cuh"
#include "tma.cuh"

using namespace mtt;

namespace {

constexpr int BM = 128;                 // rows of a tile: 64 a consumer warpgroup
constexpr int BN = 128;                 // columns of a tile
constexpr int BK = 32;                  // K per stage: one 128-byte swizzle row of f32
constexpr int STAGES = 3;
constexpr int THREADS = 384;            // warpgroup 0 produces, 1 and 2 consume
constexpr int ABYTES = BM * BK * 4;     // the A box, 16 KB
constexpr int RAW = ABYTES + BN * BK * 4;  // what TMA lands a stage: A and B, 32 KB
constexpr int STAGE = 2 * RAW;          // hi in place of the raw tiles, then lo
// the ring, 1 KB to align it to the swizzle's 1024-byte period, barriers
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;

// The stage's raw tiles (RAW bytes from st) into hi in place and lo at st +
// RAW, float4 by float4 over the 256 consumer threads: element by element,
// so the swizzled layout is kept.
__device__ __forceinline__ void split_stage(unsigned char* st, int ct) {
#pragma unroll 4
  for (int i = ct; i < RAW / 16; i += 256) {
    float4* p = reinterpret_cast<float4*>(st) + i;
    const float4 x = *p;
    float4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *p = hi;
    *reinterpret_cast<float4*>(st + RAW + 16 * i) = lo;
  }
}

// A warpgroup's sums: rows m0 + 16 w + l / 4 (+ 8) and columns n0 + 8 j +
// 2 (l % 4) (+ 1) of the tile. The epilogue of gemm.cuh in f32, in its order;
// pairs of columns go to device memory as one 8-byte store (ldo % 4 == 0, the
// column even), the last odd column alone.
template <int EPI>
__device__ __forceinline__ void epilogue(const float (&d)[64], const float* __restrict__ bias,
                                         const float* __restrict__ res, float* __restrict__ out,
                                         long long ldo, int m0, int n0, int M, int N, int t) {
  const int lane = t % 32, row0 = m0 + (t / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= M) continue;
    float* orow = out + (size_t)row * ldo;
    const float* rrow = res + (size_t)row * ldo;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      float v0 = d[4 * j + 2 * r], v1 = d[4 * j + 2 * r + 1];
      if constexpr (epi_reads_bias(EPI)) {
        const float b0 = bias[col], b1 = two ? bias[col + 1] : 0.f;
        if constexpr (EPI == EPI_GELU) {
          v0 = gelu_erf_poly(v0 + b0);
          v1 = gelu_erf_poly(v1 + b1);
        } else if constexpr (EPI == EPI_RES) {
          v0 = v0 + b0 + rrow[col];
          v1 = v1 + b1 + (two ? rrow[col + 1] : 0.f);
        } else {
          v0 = v0 + b0;
          v1 = v1 + b1;
        }
      }
      if (two)
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      else
        orow[col] = v0;
    }
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1) gemm_f32_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ bias, const float* __restrict__ res, float* __restrict__ out,
    long long ldo, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  unsigned char* ring_p = smem_raw + (ring - base);
  const uint32_t full0 = ring + STAGES * STAGE;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;    // empty[s] at empty0 + 8 s
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // the eight consumer warps
    }
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
          mbar_expect_tx(bar, RAW);
          tma_load_2d(dst, &map_a, kt * BK, m0, bar);
          tma_load_2d(dst + ABYTES, &map_b, kt * BK, n0, bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x - 128, t = ct % 128, lane = t % 32;
    // ring iteration it: wait for the stage, split it, hand it to wgmma
    auto ready = [&](int it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      split_stage(ring_p + s * STAGE, ct);
      fence_proxy_async();
      consumers_bar(1);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      float sum[64], part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = part[i] = 0.f;
      ready(it);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t ah = ring + s * STAGE + wg * 64 * 128, al = ah + RAW;
        const uint32_t bh = ring + s * STAGE + ABYTES, bl = bh + RAW;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t a_hi = wgmma_desc(ah + kk * 32), b_hi = wgmma_desc(bh + kk * 32);
          // the stage's first product starts the partial from zero
          wgmma_m64n128k8_tf32(part, wgmma_desc(al + kk * 32), b_hi, kk > 0);
          wgmma_m64n128k8_tf32(part, a_hi, wgmma_desc(bl + kk * 32), 1);
          wgmma_m64n128k8_tf32(part, a_hi, b_hi, 1);
        }
        wgmma_commit();
        // the next stage is split while this one's products run
        if (kt + 1 < nk) ready(it + 1);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += part[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      epilogue<EPI>(sum, bias, res, out, ldo, m0 + 64 * wg, n0, M, N, t);
    }
  }
}

template <int EPI>
int launch(const void* a, long long lda, const void* b, void* out, long long ldo, const void* bias,
           const void* res, int M, int N, int K, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  if (!make_map_f32(&map_a, a, M, K, lda, BM) || !make_map_f32(&map_b, b, N, K, K, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = sm_count(dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = gemm_f32_kernel<EPI>;
  // the shared-memory allowance belongs to the device's context: set once per
  // device for this instantiation
  static std::atomic<bool> allowed[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !allowed[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) allowed[dev].store(true, std::memory_order_relaxed);
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<tiles < sms ? static_cast<int>(tiles) : sms, THREADS, SMEM, st>>>(
      map_a, map_b, static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<float*>(out), ldo, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mtt_gemm_f32(const void* a, long long lda, const void* b, void* out, long long ldo,
                            const void* bias, const void* res, int M, int N, int K, int epi,
                            void* stream) {
  lda = lda ? lda : K;
  ldo = ldo ? ldo : N;
  if (M < 0 || N <= 0 || K <= 0 || K % 4 || lda < K || lda % 4 || ldo < N || ldo % 4 ||
      (epi == EPI_RES && !res) || (epi_reads_bias(epi) && !bias))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_GELU: return launch<EPI_GELU>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_RES: return launch<EPI_RES>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_BIAS: return launch<EPI_BIAS>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    case EPI_NONE: return launch<EPI_NONE>(a, lda, b, out, ldo, bias, res, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
