// TaskPrompter per-task feature decode with the first fuse projection folded in.
//
// Replaces mtt_tpu/kernels/task_decode.py:_decode_kernel (pallas_call at :102).
// For every task t:
//   f_t  = bf16((bf16(bf16(x * a_t) + x)) @ ws_t^T + bs_t)     (spatial pathway)
//   fc_t = bf16((bf16(bf16(x * cw_t) + x)) @ wc_t^T + bc_t)    (channel pathway)
//   y_t  = bf16([f_t ; fc_t] @ wf_t^T + bf_t)                  (first 1x1 fuse)
// written as one (B, S, T * F) tensor, task-major; a_t's head group of channel
// c is c / (C / G) (the expand of task_decode.py:69 as an index).
//
// What bounds it on the H100: at ViT-L PASCAL shapes (B = 8, S = 1024, C =
// 1024, T = 5, tar = 300, F = 350) it is 68 GFLOP of tensor-core work per call
// (0.069 ms at the bf16 peak), against 17 MB of x read and 29 MB of y written.
// What the design must avoid is the XLA composition's traffic (two (B, S, T,
// C) scaled inputs of 84 MB and the (B, S, T, 2 tar) concat) and, on this
// card, streaming each task's 1.65 MB of weights from L2 for too few rows.
//
// Design: persistent blocks (one an SM) walk tiles of 64 rows of one batch
// item and one task, task-major, so that the blocks in flight share a task's
// weights in L2. Warpgroup 0 produces: one thread streams, per tile, 64-wide K
// chunks of x with ws (phase F), of x with wc (phase FC), then of wf (phase
// Y) through a ring of three stages (TMA, 128-byte swizzle, 3-D maps over
// (batch or task, rows, K) so that TMA's zero fill covers ragged rows, tar, F
// and K: the weights need no padded copy). Warpgroups 1 and 2 consume:
//  - phases F and FC: both scale the landed x chunk in place into the A
//    operand (x * a + x, or x * cw + x, with the TPU kernel's two bf16
//    roundings; every 16-byte unit keeps its swizzled place), fence the
//    async proxy, and then each runs wgmma m64n152k16 on its half of the
//    tar <= 304 columns, sharing the A tile. The sums plus the bias, rounded
//    to bf16, go to the shared-memory tile FF (64 x 2 tar, K-major, in the
//    swizzle wgmma reads), f at columns 0 .. tar - 1 and fc at tar ..
//    2 tar - 1: wf_t's own column order, so wf needs no re-layout.
//  - phase Y: each runs wgmma m64n176k16 on its half of the F <= 352 columns
//    with A = FF and B = the wf chunk, adds the bias, rounds, and the 64 x F
//    tile leaves through shared memory with coalesced 4-byte stores (y's row
//    pitch, T F 2 = 3500 bytes, is not the 16 bytes a TMA store needs).
// Each weight byte that reaches shared memory feeds the tile's 64 rows. No
// split-K and no atomics: two runs give the same bits.
//
// The split form (mtt_task_decode_split_bf16) takes what the one launch does
// not: tar past 304 or F past 352 (TaskPrompter-ViT-L NYUD at embed_dim 768,
// tar = F = 768), and the tar and F that the wrapper zero-pads (tar % 4, odd
// F). It is cut at the TPU kernel's own bf16 rounding of [f; fc]:
//  1. this kernel with ffo set: phases F and FC only, over (tile, chunk)
//     items, a chunk being 304 of the tar columns (ws and wc rows at the
//     chunk's offset; x is read and scaled again for each chunk), the sums
//     plus the bias rounded to bf16 and stored from the accumulators into the
//     (B, S, T, 2 tar) scratch ffo, f at columns 0 .. tar - 1 and fc at tar
//     .. 2 tar - 1 of each (row, task);
//  2. one launch of the shared GEMM a task (gemm.cu, EPI_BIAS), y_t =
//     [f_t; fc_t] . wf_t^T + bf_t, reading the scratch's task-t columns at
//     its row pitch T 2 tar and writing the output's at T F.
// At PASCAL's (8, 1024, 1024) with T = 5 and tar = F = 768 that is 0.23 TFLOP
// (0.23 ms at the bf16 peak), and the scratch moves 126 MB each way.
#include "tma.cuh"

using namespace mtt;

namespace {

constexpr int DT = 384;                    // warpgroup 0 produces, 1 and 2 consume
constexpr int BM = 64;                     // rows of a tile
constexpr int NF = 152;                    // f / fc columns of a consumer warpgroup
constexpr int NY = 176;                    // y columns of a consumer warpgroup
constexpr int XBOX = BM * TMA_BK * 2;      // a 64 x 64 box of x
constexpr int WFBOX = NF * TMA_BK * 2;     // a 152 x 64 box of ws or wc
constexpr int WYBOX = NY * TMA_BK * 2;     // a 176 x 64 box of wf
constexpr int STAGE = XBOX + 2 * WFBOX > 2 * WYBOX ? XBOX + 2 * WFBOX : 2 * WYBOX;
constexpr int STAGES = 3;
constexpr int KY = (4 * NF + TMA_BK - 1) / TMA_BK;  // K chunks of FF: 2 tar <= 608
constexpr int FFBOX = BM * TMA_BK * 2;
constexpr int FF_BYTES = KY * FFBOX;
constexpr int YLD = 2 * NY + 8;            // padded row of the y staging tile
constexpr int SMEM = STAGES * STAGE + FF_BYTES + 1024 + 2 * STAGES * 8;
static_assert(BM * YLD * 2 <= FF_BYTES, "the y tile is staged where FF was");
static_assert(SMEM <= 232448, "shared memory of one block");

// Parameters are read as stored, f32 or bf16 (a flag each; the loads sit
// outside the product loops). a and cw are rounded to bf16 as the plain
// version casts them; the biases are added in f32.
__device__ __forceinline__ float ld_round(const void* p, size_t i, bool f32) {
  return f32 ? __bfloat162float(__float2bfloat16(static_cast<const float*>(p)[i]))
             : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__device__ __forceinline__ float2 ld_pair(const void* p, size_t i, bool f32) {
  return f32 ? *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i)
             : __bfloat1622float2(
                   *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + i));
}

// bf16(bf16(x * s) + x), the TPU kernel's two roundings (task_decode.py:69-70)
__device__ __forceinline__ float scale_add(float x, float s) {
  return __bfloat162float(__float2bfloat16(__bfloat162float(__float2bfloat16(x * s)) + x));
}

// A value pair into the K-major, 128-byte-swizzled FF tile at (row, col), col
// even: 64-wide column chunks of 64 rows x 128 bytes.
__device__ __forceinline__ void ff_store(uint32_t ff, int row, int col, float v0, float v1) {
  const uint32_t at = ff + (col / TMA_BK) * FFBOX + row * 128 +
                      ((((col % TMA_BK) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16x2(v0, v1)) : "memory");
}

// flags: bit 0 a f32, bit 1 cw f32, bit 2 the biases f32 (else bf16). SPLIT:
// the split form's first launch (phases F and FC into ffo); else the one
// launch, whose code is the same as before the split form existed.
template <bool SPLIT>
__global__ void __launch_bounds__(DT, 1) task_decode_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_ws,
    const __grid_constant__ CUtensorMap map_wc, const __grid_constant__ CUtensorMap map_wf,
    const void* __restrict__ a, const void* __restrict__ cw, const void* __restrict__ bs,
    const void* __restrict__ bc, const void* __restrict__ bfin, bf16* __restrict__ out, int B,
    int S, int C, int T, int G, int tar, int F, int flags, bf16* __restrict__ ffo) {
  const bool a32 = flags & 1, cw32 = flags & 2, b32 = flags & 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ff = ring + STAGES * STAGE;
  const uint32_t full0 = ff + FF_BYTES, empty0 = full0 + STAGES * 8;
  // the split form walks (tile, chunk of 2 NF tar columns) items; the one
  // launch has one chunk
  const int nch = SPLIT ? (tar + 2 * NF - 1) / (2 * NF) : 1;
  const int stiles = (S + BM - 1) / BM, tiles = T * nch * B * stiles;
  const int nk = (C + TMA_BK - 1) / TMA_BK, ny = (2 * tar + TMA_BK - 1) / TMA_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      auto next = [&](uint32_t bytes) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, bytes);
        ++it;
        return s;
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int t = tile / (nch * B * stiles), ch = (tile / (B * stiles)) % nch;
        const int b = (tile / stiles) % B, s0 = (tile % stiles) * BM;
        for (int ph = 0; ph < 2; ++ph) {
          const CUtensorMap* w = ph ? &map_wc : &map_ws;
          for (int kt = 0; kt < nk; ++kt) {
            const int s = next(XBOX + 2 * WFBOX);
            const uint32_t dst = ring + s * STAGE, bar = full0 + 8 * s;
            tma_load_3d(dst, &map_x, kt * TMA_BK, s0, b, bar);
            tma_load_3d(dst + XBOX, w, kt * TMA_BK, ch * 2 * NF, t, bar);
            tma_load_3d(dst + XBOX + WFBOX, w, kt * TMA_BK, ch * 2 * NF + NF, t, bar);
          }
        }
        if (SPLIT) continue;  // no phase Y
        for (int ky = 0; ky < ny; ++ky) {
          const int s = next(2 * WYBOX);
          const uint32_t dst = ring + s * STAGE, bar = full0 + 8 * s;
          tma_load_3d(dst, &map_wf, ky * TMA_BK, 0, t, bar);
          tma_load_3d(dst + WYBOX, &map_wf, ky * TMA_BK, NY, t, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = threadIdx.x - 128, wg = ct / 128, lane = ct % 32;
  const int gc = C / G;
  // FF's columns past 2 tar meet wf's zero fill: keep them finite
  for (int i = ct; i < FF_BYTES / 16; i += 256)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(ff + 16 * i), "r"(0)
                 : "memory");
  // the accumulator layout: row r0 (+ 8) and column c0 + 8 j (+ 1) of the
  // warpgroup's 64 x N block
  const int r0 = ((ct % 128) / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
  int it = 0;
  auto release_prev = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile / (nch * B * stiles), ch = (tile / (B * stiles)) % nch;
    const int b = (tile / stiles) % B, s0 = (tile % stiles) * BM;
    const size_t bt = (size_t)b * T + t;

    // ---- phases F and FC: scaled x (in place) . ws_t^T / wc_t^T ----
    for (int ph = 0; ph < 2; ++ph) {
      float acc[NF / 2];
#pragma unroll
      for (int i = 0; i < NF / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t xs = ring + s * STAGE;
        // this thread's two 16-byte units of the x box: row e / 8, swizzled
        // place e % 8, columns kt 64 + 8 ((e % 8) ^ (row % 8)); their scales
        // are read before the wait
        float sc[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = ct + 256 * h, row = e / 8;
          const int col = kt * TMA_BK + 8 * ((e % 8) ^ (row % 8));
          const bool ok = col < C && s0 + row < S;
          if (ph == 0) {
            const float v = ok ? ld_round(a, (bt * S + s0 + row) * G + col / gc, a32) : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) sc[h][i] = v;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) sc[h][i] = ok ? ld_round(cw, bt * C + col + i, cw32) : 0.f;
          }
        }
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t at = xs + (ct + 256 * h) * 16;
          uint4 raw;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                       : "r"(at));
          float xv[8];
          unpack8(raw, xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = scale_add(xv[i], sc[h][i]);
          raw = pack8(xv);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(raw.x),
                       "r"(raw.y), "r"(raw.z), "r"(raw.w)
                       : "memory");
        }
        fence_proxy_async();
        consumers_bar(1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TMA_BK / 16; ++kk)
          wgmma_m64n152k16(acc, wgmma_desc(xs + kk * 32),
                           wgmma_desc(xs + XBOX + wg * WFBOX + kk * 32));
        wgmma_commit();
        // keep this stage's products in flight; release the previous stage
        wgmma_wait<1>();
        if (kt > 0) release_prev();
      }
      wgmma_wait<0>();
      release_prev();
      // + bias, rounded to bf16, into FF at column ph tar + n (the split
      // form: into the scratch ffo, rows past S not stored)
      const void* bias = ph ? bc : bs;
#pragma unroll
      for (int j = 0; j < NF / 8; ++j) {
        const int n = ch * 2 * NF + wg * NF + 8 * j + c0;
        if (n < tar) {
          const float2 bv = ld_pair(bias, (size_t)t * tar + n, b32);
          if (SPLIT) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = s0 + r0 + 8 * h;
              if (r < S)
                *reinterpret_cast<uint32_t*>(
                    ffo + (((size_t)b * S + r) * T + t) * 2 * tar + ph * tar + n) =
                    pack_bf16x2(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
            }
          } else {
            ff_store(ff, r0, ph * tar + n, acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
            ff_store(ff, r0 + 8, ph * tar + n, acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
          }
        }
      }
    }
    if (SPLIT) continue;
    fence_proxy_async();
    consumers_bar(1);

    // ---- phase Y: FF . wf_t^T ----
    float acc[NY / 2];
#pragma unroll
    for (int i = 0; i < NY / 2; ++i) acc[i] = 0.f;
    for (int ky = 0; ky < ny; ++ky, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t wy = ring + s * STAGE + wg * WYBOX, fa = ff + ky * FFBOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk)
        wgmma_m64n176k16(acc, wgmma_desc(fa + kk * 32), wgmma_desc(wy + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      if (ky > 0) release_prev();
    }
    wgmma_wait<0>();
    release_prev();
    consumers_bar(1);  // both warpgroups' products have read FF

    // + bias, rounded to bf16, staged in FF's place, then stored row by row
    {
      bf16* ys = reinterpret_cast<bf16*>(smem_raw + (ff - smem_u32(smem_raw)));
#pragma unroll
      for (int j = 0; j < NY / 8; ++j) {
        const int n = wg * NY + 8 * j + c0;
        if (n < F) {
          const float2 bv = ld_pair(bfin, (size_t)t * F + n, b32);
          *reinterpret_cast<uint32_t*>(ys + r0 * YLD + n) =
              pack_bf16x2(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
          *reinterpret_cast<uint32_t*>(ys + (r0 + 8) * YLD + n) =
              pack_bf16x2(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
        }
      }
      consumers_bar(1);
      const int pairs = F / 2, rows = min(BM, S - s0);
      for (int i = ct; i < rows * pairs; i += 256) {
        const int r = i / pairs, p = i % pairs;
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * S + s0 + r) * T + t) * F + 2 * p) =
            *reinterpret_cast<const uint32_t*>(ys + r * YLD + 2 * p);
      }
      consumers_bar(1);  // the y tile is read before FF is written again
    }
  }
}

// One launch of task_decode_kernel (ffo null: the whole decode into out; else
// phases F and FC into ffo).
int launch_decode(const void* x, const void* a, const void* cw, const void* ws, const void* bs,
                  const void* wc, const void* bc, const void* wf, const void* bf, void* out,
                  void* ffo, int B, int S, int C, int T, int G, int tar, int F, int flags,
                  cudaStream_t st) {
  CUtensorMap map_x, map_ws, map_wc, map_wf;
  const long long dx[3] = {C, S, B}, dw[3] = {C, tar, T}, dy[3] = {2LL * tar, F, T};
  if (!make_map_nd(&map_x, x, 3, dx, BM) || !make_map_nd(&map_ws, ws, 3, dw, NF) ||
      !make_map_nd(&map_wc, wc, 3, dw, NF))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ffo) map_wf = map_ws;  // not read: the split form has no phase Y
  else if (!make_map_nd(&map_wf, wf, 3, dy, NY)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = sm_count(dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = ffo ? task_decode_kernel<true> : task_decode_kernel<false>;
  // the shared-memory allowance belongs to the device's context: set once per
  // device and instantiation
  static std::atomic<bool> allowed[2][MAX_DEVICES];
  std::atomic<bool>* set = allowed[ffo ? 1 : 0];
  if (dev >= MAX_DEVICES || !set[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) set[dev].store(true, std::memory_order_relaxed);
  }
  const int nch = ffo ? (tar + 2 * NF - 1) / (2 * NF) : 1;
  const int tiles = T * nch * B * ((S + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, DT, SMEM, st>>>(
      map_x, map_ws, map_wc, map_wf, a, cw, bs, bc, bf, static_cast<bf16*>(out), B, S, C, T, G,
      tar, F, flags, static_cast<bf16*>(ffo));
  return static_cast<int>(cudaGetLastError());
}

bool widths_ok(int B, int S, int C, int T, int G) {
  return B > 0 && S > 0 && T > 0 && G > 0 && C > 0 && C % 8 == 0 && C % G == 0 &&
         (C / G) % 8 == 0;
}

}  // namespace

// x (B, S, C) bf16; a (B, T, S, G), cw (B, T, C) (flags bit 0, 1: f32, else
// bf16), rounded to bf16 as read; ws, wc (T, tar, C) and wf (T, F, 2 tar)
// bf16 as the grouped convs store them; bs, bc (T, tar) and bf (T, F), all
// three f32 (flags bit 2) or all bf16 -> out (B, S, T F) bf16. C % 8 == 0,
// (C / G) % 8 == 0, tar % 4 == 0 and <= 304, F % 2 == 0 and <= 352; every
// pointer 16-byte aligned (TMA's rule).
extern "C" int mtt_task_decode_bf16(const void* x, const void* a, const void* cw, const void* ws,
                                    const void* bs, const void* wc, const void* bc, const void* wf,
                                    const void* bf, void* out, int B, int S, int C, int T, int G,
                                    int tar, int F, int flags, void* stream) {
  if (!widths_ok(B, S, C, T, G) || tar % 4 || tar <= 0 || tar > 2 * NF || F % 2 || F <= 0 ||
      F > 2 * NY)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode(x, a, cw, ws, bs, wc, bc, wf, bf, out, nullptr, B, S, C, T, G, tar, F,
                       flags, static_cast<cudaStream_t>(stream));
}

extern "C" int mtt_gemm_bias_ld_bf16(const void* a, long long lda, const void* b, void* out,
                                     long long ldo, const void* bias, int bias_f32, int M, int N,
                                     int K, void* stream);

// The split form, T + 1 launches: the arguments of mtt_task_decode_bf16 with
// any tar % 4 == 0 and F % 8 == 0 (the wrapper zero-pads other widths), and
// ff, a (B, S, T, 2 tar) bf16 scratch.
extern "C" int mtt_task_decode_split_bf16(const void* x, const void* a, const void* cw,
                                          const void* ws, const void* bs, const void* wc,
                                          const void* bc, const void* wf, const void* bf,
                                          void* ff, void* out, int B, int S, int C, int T, int G,
                                          int tar, int F, int flags, void* stream) {
  if (!widths_ok(B, S, C, T, G) || tar % 4 || tar <= 0 || F % 8 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int e = launch_decode(x, a, cw, ws, bs, wc, bc, wf, bf, out, ff, B, S, C, T, G, tar, F, flags,
                        st);
  const bool b32 = flags & 4;
  for (int t = 0; t < T && !e; ++t)
    e = mtt_gemm_bias_ld_bf16(
        static_cast<const bf16*>(ff) + (size_t)t * 2 * tar, (long long)T * 2 * tar,
        static_cast<const bf16*>(wf) + (size_t)t * F * 2 * tar,
        static_cast<bf16*>(out) + (size_t)t * F,
        (long long)T * F, static_cast<const char*>(bf) + (size_t)t * F * (b32 ? 4 : 2), b32,
        B * S, F, 2 * tar, stream);
  return e;
}
