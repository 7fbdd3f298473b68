// Swin window attention backward, bf16 q/k/v/g, head dim 32.
//
// Replaces mtt_tpu/kernels/attention.py:_wattn_bwd_kernel (pallas_call at
// :900), per (window, head):
//   logits = scale * q k^T + bias[head] + mask[window % nW]        (f32)
//   pn     = exp(logits - rowmax) / rowsum                         (f32)
//   dp     = g v^T;  r = rowsum(dp * pn);  dl = pn (dp - r)        (f32)
//   dq = (bf16(dl) k) * scale, dk = (bf16(dl)^T q) * scale, dv = bf16(pn)^T g
//                                                  (f32 acc, rounded once)
//   dbias[head] = sum over the windows of the unrounded dl         (f32)
// The backward normalises pn before it rounds it (the forward rounds the
// unnormalised p): the kernel keeps that order. No gradient for the mask.
//
// What bounds it on the H100: bytes. At Swin-B's stage 0 (512 windows of 147
// tokens, 4 heads, head dim 32) q, k, v and g are read and dq, dk and dv
// written once: 7 x 19.3 MB = 135 MB, 0.040 ms at 3.35 TB/s, 0.054 ms with
// the 44 MB f32 mask; five 147 x 147 x 32 products per (window, head) are
// 14 GFLOP, 0.014 ms on the tensor cores. At head dim 32 each product has
// only two k16 steps, so the per-score work (bias and mask reads, the
// softmax, dl) and the dbias sum over windows decide the time, not the
// products.
//
// Design: one block of ten warps per (chunk of windows, head), one block an
// SM and about one wave of blocks; every product an mma.sync m16n8k16 on the
// fragment layer of common.cuh. A window's Q, K, V and G tiles (160 rows: 147
// tokens padded, rows past M zero-filled by cp.async) stream through a
// two-buffer ring: the next window's tiles are copied (and its mask asked
// into L2) while this one computes, one barrier a window. Phase 1, warp w
// owns query rows 16 w .. 16 w + 15 and walks the keys 16 at a time in two
// passes. Pass 1 forms S = Q K^T and the logits (bias and mask read in the
// C-fragment layout straight from device memory, f32, added as the plain
// version adds them), parks the logits in the warp's own rows of the P and
// dL matrices, and takes the row max and the row sums of e = exp(logits -
// max) and of e dp (dp = G V^T), whose ratio is r = rowsum(dp pn), each lane
// against its running max, merged over the quad at the end. Pass 2 reads the
// parked logits back, forms dp again, pn = e / sum against the row max over
// all keys (a true division, before pn is rounded) and dl = pn (dp - r), and
// writes bf16(pn) and bf16(dl) over the logits it has read; the unrounded dl
// is added to dbias. (A row of scores held in registers beside the dbias
// sums needs about 190 registers; ten warps get 168, three of them sharing
// an SM quadrant's 16K registers. So the scores stream, and shared memory
// holds them between the passes.)
// Phase 2, after a barrier, warp w forms dq of query rows 16 w.. (dL rows by
// ldmatrix, K by ldmatrix.trans), and dk and dv of key rows 16 w.. (dL^T and
// P^T as A fragments by ldmatrix.trans of the stored matrices, Q and G by
// ldmatrix.trans), rounds each once and stores it.
//
// dbias is the hard part: the TPU sums dl over the windows on a sequential
// grid axis. Here the lane that computes dl entry (i, j) of a head owns that
// entry in every window of its block's chunk and keeps its running sum in
// registers (19 or 20 C tiles); the block writes its partial once, and a
// second kernel sums the partials over the chunks in a fixed order. No atomics: two runs give equal bits. The chunk
// (bwd_window_chunks in kernels/window_attention.py) gives about one block an
// SM: 11 MB of partials at stage 0.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int BD = 32;                 // head dim
constexpr int BWARPS = 10;             // one 16-row strip each: MP <= 160
constexpr int BT = BWARPS * 32;
constexpr int BMP = 16 * BWARPS;       // rows of a tile: 147 tokens padded to 160
constexpr int BKLD = BD + 8;           // row stride of the Q, K, V and G tiles
constexpr int BPLD = BMP + 8;          // row stride of the P and dL matrices
constexpr int kTile = BMP * BKLD;      // elements of one tile
constexpr int kStage = 4 * kTile;      // Q, K, V, G of one window
constexpr int kMat = BMP * BPLD;       // elements of the P or dL matrix
constexpr int kSmem = (2 * kStage + 2 * kMat) * 2;

// c0, c1 = A B^T over the head dim for the two C tiles of the 16-key pair jj:
// A the two k16 fragments a (16 rows), B the 16 rows jj * 16.. of the
// row-major tile X. The second tile is left out where one (the last pair of
// an odd tile count).
__device__ __forceinline__ void pair_product(const uint32_t (&a)[2][4], const bf16* X, int jj,
                                             int off, bool one, float (&c0)[4], float (&c1)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, X + jj * 16 * BKLD + kk * 16 + off);
    mma_16816(c0, a[kk], b[0], b[1]);
    if (!one) mma_16816(c1, a[kk], b[2], b[3]);
  }
}

// acc (16 x 32) += A^T B: A (kt16 rows of k, the warp's 16 columns m0..) read
// transposed from the row-major matrix Mx (leading dimension BPLD), B the
// row-major tile X (k rows, 32 columns); k runs over kt16 16-row steps.
__device__ __forceinline__ void product_at(const bf16* Mx, int m0, const bf16* X, int kt16,
                                           int lane, float (&acc)[4][4]) {
  const int aoff = ldsm_bt_off(lane, BPLD), boff = ldsm_b_off(lane, BKLD);
#pragma unroll 2
  for (int kk = 0; kk < kt16; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, Mx + kk * 16 * BPLD + m0 + aoff);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t b[4];
      ldsm_x4_trans(b, X + kk * 16 * BKLD + jj * 16 + boff);
      mma_16816(acc[2 * jj], a, b[0], b[1]);
      mma_16816(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 x 32 accumulator times mul, rounded to bf16 once, into rows
// row0 + g and row0 + g + 8 of dst (row stride ld elements), rows below M.
__device__ __forceinline__ void store_c(const float (&acc)[4][4], float mul, bf16* dst, size_t ld,
                                        int row0, int M, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 + g < M)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + g) * ld + col) =
          pack_bf16x2(acc[j][0] * mul, acc[j][1] * mul);
    if (row0 + g + 8 < M)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + g + 8) * ld + col) =
          pack_bf16x2(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// NJ: 8-key C tiles a lane holds (19 for 145-152 tokens, else 20 with the
// tiles at or past nj = ceil(M / 8) left out at run time).
template <int NJ, bool HAS_MASK>
__global__ void __launch_bounds__(BT, 1) wattn_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ dqkv, float* __restrict__ work, int BW, int M, int H, int nW,
    long long sb, long long sm, long long sh, long long gb, long long gm, long long gh, int wpc,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // buffer i: Q, K, V, G at ring + i kStage
  bf16* Ps = ring + 2 * kStage;                 // bf16(pn), query rows x key columns
  bf16* Ls = Ps + kMat;                         // bf16(dl)

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int KT = (M + 15) / 16, nj = (M + 7) / 8;
  const int w0 = chunk * wpc, w1 = min(BW, w0 + wpc);
  const int r0 = warp * 16;
  const bool active = warp < KT;
  // dq, dk and dv are the three slots of the packed (BW, M, 3, H, 32) gradient
  const size_t dsm = 3 * (size_t)H * BD, dsb = (size_t)M * dsm;

  auto issue = [&](int w) {
    bf16* st = ring + ((w - w0) & 1) * kStage;
    const bf16* src[4] = {q + w * sb + h * sh, k + w * sb + h * sh, v + w * sb + h * sh,
                          g + w * gb + h * gh};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_rows_async_fixed<BMP, BD, BKLD, BT>(st + i * kTile, src[i], i < 3 ? sm : gm, M, BD);
    if (HAS_MASK) {
      // the window's mask into L2 ahead of its scalar reads: M x M f32 in
      // 128-byte lines (every head's block asks; the later ones hit)
      const char* mw = reinterpret_cast<const char*>(mask + (size_t)(w % nW) * M * M);
      const int lines = (M * M * 4 + 127) / 128;
      for (int i = threadIdx.x; i < lines; i += BT)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(mw + i * 128));
    }
  };
  issue(w0);
  cp_async_commit();

  // the lane's entries: rows r0 + gq (e < 2) and r0 + gq + 8, key columns
  // j * 8 + 2 t + (e & 1); the running dbias sum of the chunk's windows
  const int row[2] = {r0 + gq, r0 + gq + 8};
  float db[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = 0.f;

  for (int w = w0; w < w1; ++w) {
    cp_async_wait<0>();
    __syncthreads();   // tiles of w landed; the previous window's phase 2 is done everywhere
    if (w + 1 < w1) issue(w + 1);
    cp_async_commit();
    const bf16* Qt = ring + ((w - w0) & 1) * kStage;
    const bf16* Kt = Qt + kTile;
    const bf16* Vt = Kt + kTile;
    const bf16* Gt = Vt + kTile;

    if (active) {
      // ---- phase 1: the warp's 16 query rows against every key, streamed
      // 16 keys at a time in two passes (registers hold the dbias sums, not
      // a row of scores)
      uint32_t qa[2][4], ga[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldsm_x4(qa[kk], Qt + r0 * BKLD + kk * 16 + ldsm_a_off(lane, BKLD));
        ldsm_x4(ga[kk], Gt + r0 * BKLD + kk * 16 + ldsm_a_off(lane, BKLD));
      }
      const int off = ldsm_bt_off(lane, BKLD);
      const float* brow = bias + (size_t)h * M * M;
      const float* mrow = HAS_MASK ? mask + (size_t)(w % nW) * M * M : nullptr;
      // the logits of key pair jj: s * scale + bias (+ mask), added in this
      // order; -inf past M
      auto logits = [&](int jj, float (&x)[2][4]) {
        pair_product(qa, Kt, jj, off, 2 * jj + 1 >= NJ, x[0], x[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = row[e >> 1], c = (2 * jj + u) * 8 + 2 * t + (e & 1);
            float y = -INFINITY;
            if (2 * jj + u < nj && i < M && c < M) {
              y = __fmul_rn(x[u][e], scale) + __ldg(brow + i * M + c);
              if (HAS_MASK) y += __ldg(mrow + i * M + c);
            }
            x[u][e] = y;
          }
      };
      // The logits wait for pass 2 in the warp's own rows of P (key columns
      // 16 jj .. 16 jj + 7 of pair jj) and of dL (16 jj + 8 ..), as f32 at
      // float slots 8 jj .. 8 jj + 7 of each row: exactly the bytes that pass
      // 2 overwrites with pair jj's bf16 P and dL, after it has read them.
      float* park[2] = {reinterpret_cast<float*>(Ps + r0 * BPLD),
                        reinterpret_cast<float*>(Ls + r0 * BPLD)};
      auto slot = [&](int u, int jj, int half) {
        return reinterpret_cast<float2*>(park[u] + (gq + 8 * half) * (BPLD / 2) + 8 * jj + 2 * t);
      };
      // pass 1: the row max over all keys, and the row sums of e =
      // exp(logits - max) and of e dp (dp = g v^T), each lane over its own
      // keys against its running max (rescaled when that grows), then merged
      // over the quad; r = rowsum(dp pn) = rowsum(e dp) / sum
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < (NJ + 1) / 2; ++jj) {
        if (jj < KT) {
          float x[2][4], d[2][4];
          logits(jj, x);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *slot(u, jj, half) = make_float2(x[u][2 * half], x[u][2 * half + 1]);
          pair_product(ga, Vt, jj, off, 2 * jj + 1 >= NJ, d[0], d[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(mx[i], fmaxf(fmaxf(x[0][2 * i], x[0][2 * i + 1]),
                                                   fmaxf(x[1][2 * i], x[1][2 * i + 1])));
            if (m_new == -INFINITY) continue;   // no key of this row so far
            const float alpha = mx[i] == -INFINITY ? 0.f : expf(mx[i] - m_new);
            float s_ = sum[i] * alpha, r_ = rr[i] * alpha;
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float xv = x[u][2 * i + c];
                const float ex = xv == -INFINITY ? 0.f : expf(xv - m_new);
                s_ += ex;
                r_ += ex * d[u][2 * i + c];
              }
            mx[i] = m_new;
            sum[i] = s_;
            rr[i] = r_;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // every lane shuffles, then the rows past M drop out
        const float m = quad_max(mx[i]);
        const float f = mx[i] == -INFINITY ? 0.f : expf(mx[i] - m);
        sum[i] = quad_sum(sum[i] * f);
        rr[i] = quad_sum(rr[i] * f);
        rr[i] = row[i] < M ? rr[i] / sum[i] : 0.f;
        mx[i] = m;
      }
      __syncwarp();   // the parked logits are visible to the whole warp
      // pass 2: pn = e / sum (zero on the rows past M), dl = pn (dp - r);
      // dbias += dl; bf16(pn) and bf16(dl) into the P and dL matrices (zero
      // up to the pair's end: the products read whole 16-key steps)
#pragma unroll
      for (int jj = 0; jj < (NJ + 1) / 2; ++jj) {
        if (jj < KT) {
          float x[2][4], d[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 v2 = *slot(u, jj, half);
              x[u][2 * half] = v2.x;
              x[u][2 * half + 1] = v2.y;
            }
          __syncwarp();   // every lane has read the slots pair jj overwrites
          pair_product(ga, Vt, jj, off, 2 * jj + 1 >= NJ, d[0], d[1]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 2 * jj + u;
            float pn[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
            if (j < NJ) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float ex = x[u][e] == -INFINITY ? 0.f : expf(x[u][e] - mx[e >> 1]);
                pn[e] = row[e >> 1] < M ? ex / sum[e >> 1] : 0.f;
                dl[e] = pn[e] * (d[u][e] - rr[e >> 1]);
                db[j][e] += dl[e];
              }
            }
            const int col = j * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(Ps + row[0] * BPLD + col) = pack_bf16x2(pn[0], pn[1]);
            *reinterpret_cast<uint32_t*>(Ps + row[1] * BPLD + col) = pack_bf16x2(pn[2], pn[3]);
            *reinterpret_cast<uint32_t*>(Ls + row[0] * BPLD + col) = pack_bf16x2(dl[0], dl[1]);
            *reinterpret_cast<uint32_t*>(Ls + row[1] * BPLD + col) = pack_bf16x2(dl[2], dl[3]);
          }
        }
      }
    }
    __syncthreads();   // P and dL complete

    if (active) {
      // ---- phase 2: dq of query rows r0.., dk and dv of key rows r0..
      bf16* dq = dqkv + (size_t)w * dsb + (size_t)h * BD;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // dq = dL K: dL rows as A fragments, K (keys x 32) by ldmatrix.trans
      {
        const int aoff = ldsm_a_off(lane, BPLD), boff = ldsm_b_off(lane, BKLD);
#pragma unroll 2
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, Ls + r0 * BPLD + kk * 16 + aoff);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t b[4];
            ldsm_x4_trans(b, Kt + kk * 16 * BKLD + jj * 16 + boff);
            mma_16816(acc[2 * jj], a, b[0], b[1]);
            mma_16816(acc[2 * jj + 1], a, b[2], b[3]);
          }
        }
      }
      store_c(acc, scale, dq, dsm, r0, M, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      product_at(Ls, r0, Qt, KT, lane, acc);   // dk = dL^T Q
      store_c(acc, scale, dq + H * BD, dsm, r0, M, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      product_at(Ps, r0, Gt, KT, lane, acc);   // dv = P^T G
      store_c(acc, 1.f, dq + 2 * H * BD, dsm, r0, M, lane);
    }
  }

  // the chunk's dbias partial, written once
  if (active) {
    float* wp = work + ((size_t)chunk * H + h) * M * M;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row[e >> 1], c = j * 8 + 2 * t + (e & 1);
        if (j < nj && i < M && c < M) wp[i * M + c] = db[j][e];
      }
  }
}

// dbias[i] = sum over the chunks, in chunk order, of work[chunk][i]
__global__ void wattn_dbias_sum_kernel(const float* __restrict__ work, float* __restrict__ dbias,
                                       int nchunk, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = work[i];
    for (int c = 1; c < nchunk; ++c) s += work[(size_t)c * n + i];
    dbias[i] = s;
  }
}

}  // namespace

// q, k, v: (BW, M, H, 32) bf16 views sharing their strides in elements (sb, sm,
// sh, 1); g: (BW, M, H, 32) bf16 with strides (gb, gm, gh, 1); every row
// 16-byte aligned. bias (H, M, M) f32; mask (nW, M, M) f32 or null. M <= 160.
// -> dqkv (BW, M, 3, H, 32) bf16 contiguous; dbias (H, M, M) f32. work holds
// ceil(BW / wpc) x H x M x M f32 partials, wpc windows a block.
extern "C" int mtt_window_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* g, const void* bias, const void* mask,
                                             void* dqkv, void* work, void* dbias, int BW, int M,
                                             int H, int nW, long long sb, long long sm,
                                             long long sh, long long gb, long long gm,
                                             long long gh, int wpc, float scale, void* stream) {
  if (BW < 1 || M < 1 || M > BMP || H < 1 || H > 65535 || wpc < 1 ||
      (mask && (nW < 1 || BW % nW)) || sb % 8 || sm % 8 || sh % 8 || gb % 8 || gm % 8 || gh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunk = (BW + wpc - 1) / wpc;
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    // set on every launch: the attribute belongs to the current device's context
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(nchunk, H), BT, kSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<bf16*>(dqkv), static_cast<float*>(work), BW,
        M, H, nW, sb, sm, sh, gb, gm, gh, wpc, scale);
    return cudaGetLastError();
  };
  const bool nj19 = (M + 7) / 8 == 19;   // Swin-B's 147 tokens
  cudaError_t e = mask ? (nj19 ? launch(wattn_bwd_kernel<19, true>) : launch(wattn_bwd_kernel<20, true>))
                       : (nj19 ? launch(wattn_bwd_kernel<19, false>) : launch(wattn_bwd_kernel<20, false>));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = H * M * M;
  const int blocks = n < 1024 * 256 ? (n + 255) / 256 : 1024;
  wattn_dbias_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(work),
                                                 static_cast<float*>(dbias), nchunk, n);
  return static_cast<int>(cudaGetLastError());
}
