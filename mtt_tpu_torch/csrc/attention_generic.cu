// Softmax attention core for Hopper, one kernel template over four softmax
// policies:
//   Generic, row 14: out = softmax(q k^T * scale) v over separate (B, Nq, H,
//     D) q and (B, Nk, H, D) k, v, max-subtracted.
//   Fast and Safe, rows 1-2's third launch and row 13: attention over the
//     head-major packed qkv (B, N, H*3*64), fast exp2 or exact-max softmax.
//   Window, row 11 past 160 tokens a window: Swin window attention over the
//     packed (BW, M, 3, H, 32) qkv with a per-head bias and a per-window
//     mask, max-subtracted.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_kernel (pallas_call at :165,
// wrapper fused_attention at :984), _attn_qkv_kernel (:230, pallas_call
// at :257; the same core inside _attn_ln_qkv_cached_kernel :423 and
// _attn_ln_qkv_kernel :393) and _wattn_kernel (:778, pallas_call at :820).
// Rounding points, kept by the plain versions (kernels/attention.py:
// attention_generic_plain, attention_qkv_plain; kernels/window_attention.py:
// window_attention_plain):
//   Generic: q' = bf16(q * bf16(scale))      (the JAX wrapper folds the scale)
//            p  = exp(s - max_k s)           (f32, the row max over ALL keys)
//   Fast:    q' = bf16(q * s2), s2 = bf16(scale * log2 e)
//            p  = exp2(clamp(s, -120, hi)), hi = 126 - ceil(log2 N), no max
//   Safe:    q' as Fast, p = exp2(s - max_k s) over ALL keys
//   Window:  q' = q; l = s * scale + bias[h, q, k] + mask[w % nW, q, k] in
//            f32 (the scale multiplies the f32 logits, it is not folded
//            into q), p = exp(l - max_k l) over ALL keys, the accurate expf
//   all:     s = q' k^T in f32 (bf16 tensor cores, f32 accumulate),
//            o = bf16(p) v / sum_k p  (the sum unrounded, the division after
//            P.V, rounded once)
// The Pallas wrapper of row 14 transposes q, k, v to (B*H, N, D) and pads the
// keys to a multiple of 128 behind a -1e30 bias row; this kernel reads the
// (B, N, H) strides directly and masks the ragged key tile, which is the same
// function. Rows 1, 2 and 13 read q, k and v as strided views of the packed
// qkv: strides (N*3C, 3C, 3*64), bases qkv + 0, 64, 128; row 11 the same
// way from the Swin block's (BW, M, 3, H, 32) projection, writing (BW, M, H *
// 32), which the output projection takes: no transpose is launched.
//
// What bounds it on the H100: at a ViT-L self-attention shape (B=8, N=1029,
// H=16, D=64) it is 35 GFLOP on the tensor cores against 34 MB of q, k, v and
// out, so the operations bound it; at InvPT's cross shape (q 5120 rows, k/v
// 320 rows, D=72) the bytes do, and for Swin windows too.
//
// Design: every product is an mma.sync m16n8k16 (bf16, f32 accumulate) whose
// operands come from registers or ldmatrix; the scores never touch shared
// memory. Each warp owns 16 * MT query rows and keeps their Q fragments, their
// score fragments and their O accumulators in registers. The row max and sum
// are quad shuffles over the C fragment (common.cuh); p is formed in f32 by
// one exp2f (Generic: of one fma, s log2(e) - m log2(e): the per-score
// instructions compete with the products for issue slots), summed unrounded
// into l, and repacked to bf16 A fragments for O += P V, with V read by
// ldmatrix.trans. O is divided by l and rounded once. Key and value tiles
// stream through a ring of STAGES cp.async buffers: the next tile's copy is
// issued right after the barrier that frees its buffer and lands while the
// current tile's products run (one barrier a tile).
//
// The max (Generic and Safe): the TPU kernels hold all keys in VMEM and
// subtract the global row max before they round P to bf16. A streaming kernel
// with an online max would round P relative to a running max and rescale it
// afterwards, another function. So pass 1 walks the keys in 128-row K tiles
// (the K and V halves of one ring buffer) and forms the scores only for their
// row max, in registers; pass 2 walks 64-key K and V tiles, forms them again
// and rounds P relative to that max, as the TPU kernels do. Both passes run
// through one ring, so the first pass-2 tile is in flight during the last
// pass-1 tile. The Fast policy subtracts no max: it runs pass 2 alone.
//
// Layout: one block of four warps per (head, batch item, 64 * MT query rows),
// the query tile the slowest grid axis. The head dim is padded with zeros to
// the tile DT (32, 64, 80 or 128) in shared memory; padded columns add
// nothing. Rows are DT + 8 elements apart, which puts the 8 row addresses of
// every ldmatrix on distinct banks. Each thread copies one fixed 16-byte
// column of its tiles at constant row strides (load_rows_async_fixed): a
// general copy loop's per-copy index arithmetic costs 12% of the kernel. A warp
// whose rows all lie past Nq (the ragged last query tile) takes part in the
// copies and barriers only, and those blocks are dispatched last.
//
// Waves on 132 SMs: at (8, 1029, 16, 64), MT = 2 (over 200 registers, 2
// blocks an SM): 1,152 blocks, 1,024 of them full, 3.88 full waves plus 128
// one-warp blocks; at the cross shape (head dim 72 in the 80 tile), MT = 1
// (shared memory allows 3 blocks an SM): 1,280 blocks, 3.23 waves.
// One m16 tile a warp at head dims up to 64 (4 blocks an SM) measured the
// same within the run-to-run spread; so did a third ring buffer.
//
// The Window policy (row 11 past 160 tokens a window; window_attention.cu
// takes the shorter ones in one pass, faster at Swin-B's 147): query tiles of
// 64 rows (one m16 tile a warp). The scores get the logit scale, the head's
// bias row and the window's mask row in f32 in both passes, so the max of
// pass 1 is over the values that pass 2 exponentiates; bias and mask are
// read where they lie, one float a load, through the read-only cache.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int GK = 64;        // keys per pass-2 tile (pass 1: 2 * GK)
constexpr int GTH = 128;      // four warps
constexpr int STAGES = 2;     // ring buffers of K and V
constexpr float kLog2e = 1.4426950408889634f;

// softmax policies (see the head of this file)
enum Policy { kGeneric, kFast, kSafe, kWindow };

// Query m16 tiles per warp and blocks per SM for each head-dim tile: two m16
// tiles share every K and V fragment (half the shared-memory reads per
// product) where the registers allow it; one for the Window policy, whose
// 147-row windows waste less in 64-row blocks.
template <int DT, int POL>
struct GenTile {
  static constexpr int MT = POL == kWindow ? 1 : (DT <= 64 ? 2 : 1);
  static constexpr int MIN_BLOCKS = POL == kWindow ? 3 : (DT <= 64 ? 2 : (DT <= 80 ? 3 : 2));
  static constexpr int LD = DT + 8;
  static constexpr int ROWS = 64 * MT;
  static constexpr int STAGE = 2 * GK * LD;  // K tile then V tile (elements)
  static constexpr int SMEM = (ROWS * LD + STAGES * STAGE) * 2;
};

// s = the warp's 16 * MT query rows (fragments qa) against 64 keys of the
// row-major tile Kt: MT x 8 C tiles.
template <int DT, int MT>
__device__ __forceinline__ void scores64(const uint32_t (&qa)[MT][DT / 16][4], const bf16* Kt,
                                         int lane, float (&s)[MT][8][4]) {
  constexpr int LD = DT + 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
  const bf16* kp = Kt + ldsm_bt_off(lane, LD);
  // key pairs outermost: the first C tiles complete early, so their
  // exponentials can overlap the later products
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kp + jj * 16 * LD + kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(s[mt][2 * jj], qa[mt][kk], b[0], b[1]);
        mma_16816(s[mt][2 * jj + 1], qa[mt][kk], b[2], b[3]);
      }
    }
  }
}

// The running row max of 64 scores (C tiles sc); lane keys at or past kvt
// (valid keys minus 2 t) are left out where MASK.
template <bool MASK, int MT>
__device__ __forceinline__ void row_max64(const float (&sc)[MT][8][4], int kvt, float (&m)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!MASK || j * 8 + (e & 1) < kvt) m[mt][e >> 1] = fmaxf(m[mt][e >> 1], sc[mt][j][e]);
}

// The Window policy's logits over 64 keys from k0, in place: s * scale +
// bias[q, key] + mask[q, key] (mask may be null) in f32, rounded after each
// operation as the plain version rounds, for the warp's MT m16 tiles of query
// rows from q0. Rows past N and keys past N read row or key N - 1: their
// values are never used.
template <int MT>
__device__ __forceinline__ void window_logits64(float (&sc)[MT][8][4], const float* __restrict__ bias,
                                                const float* __restrict__ mask, int q0, int k0, int N,
                                                float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t row = (size_t)min(q0 + mt * 16 + g + 8 * r, N - 1) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = min(k0 + j * 8 + 2 * t + c, N - 1);
          float& x = sc[mt][j][2 * r + c];
          x = __fadd_rn(__fmul_rn(x, scale), __ldg(bias + row + key));
          if (mask) x = __fadd_rn(x, __ldg(mask + row + key));
        }
    }
}

// p in f32 over 64 scores, in place, by the policy: Generic exp(s - m) =
// exp2(s log2(e) - m log2(e)) (mlog = m log2(e)); Safe exp2(s - m) (the
// scores and m already in log2 units); Window exp(s - m), the accurate expf
// (mlog = m); Fast exp2(clamp(s, -120, hi)).
// l += p unrounded. Keys at or past kvt get p = 0 where MASK.
template <bool MASK, int MT, int POL>
__device__ __forceinline__ void probs64(float (&sc)[MT][8][4], const float (&mlog)[MT][2], int kvt,
                                        float hi, float (&l)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[mt][j][e];
        float p = POL == kGeneric  ? exp2f(fmaf(x, kLog2e, -mlog[mt][e >> 1]))
                  : POL == kSafe   ? exp2f(x - mlog[mt][e >> 1])
                  : POL == kWindow ? expf(x - mlog[mt][e >> 1])
                                   : exp2f(fminf(fmaxf(x, -120.f), hi));
        if (MASK && j * 8 + (e & 1) >= kvt) p = 0.f;
        l[mt][e >> 1] += p;
        sc[mt][j][e] = p;
      }
}

// scale: the factor q is multiplied by before its bf16 rounding (Generic
// bf16(scale), Fast and Safe s2, Window 1); hi: the Fast policy's upper
// clamp. Window: bias (H, N, N) and mask (nW, N, N) or null, f32, window b
// taking mask b % nW; lscale multiplies the f32 logits.
template <int DT, int POL>
__global__ void __launch_bounds__(GTH, GenTile<DT, POL>::MIN_BLOCKS) attn_generic_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int Nq, int Nk, int H, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, float scale, float hi, const float* __restrict__ bias,
    const float* __restrict__ mask, int nW, float lscale) {
  using T = GenTile<DT, POL>;
  constexpr int MT = T::MT, LD = T::LD, ROWS = T::ROWS, KS = DT / 16, NT = DT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + ROWS * LD;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  // Window: the head's bias rows and the window's mask rows
  const float* wbias = POL == kWindow ? bias + (size_t)h * Nk * Nk : nullptr;
  const float* wmask = POL == kWindow && mask ? mask + (size_t)(b % nW) * Nk * Nk : nullptr;

  // ring steps: n1 pass-1 tiles of 2 * GK keys (K only; none for the Fast
  // policy, which takes no max), then n2 pass-2 tiles of GK keys (K and V)
  const int n1 = POL == kFast ? 0 : (Nk + 2 * GK - 1) / (2 * GK), n2 = (Nk + GK - 1) / GK;
  const int nsteps = n1 + n2;
  auto issue = [&](int s) {
    bf16* st = ring + (s % STAGES) * T::STAGE;
    if (s < n1) {
      const int k0 = s * 2 * GK;
      load_rows_async_fixed<2 * GK, DT, LD, GTH>(st, kb + k0 * skn, skn, Nk - k0, D);
    } else {
      const int k0 = (s - n1) * GK;
      load_rows_async_fixed<GK, DT, LD, GTH>(st, kb + k0 * skn, skn, Nk - k0, D);
      load_rows_async_fixed<GK, DT, LD, GTH>(st + GK * LD, vb + k0 * svn, svn, Nk - k0, D);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  // Q tile times the scale, rounded to bf16 once; zero past Nq and D
  for (int i = threadIdx.x; i < ROWS * (DT / 8); i += GTH) {
    const int r = i / (DT / 8), c = (i % (DT / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq && c < D) raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sqn + c);
    float f[8];
    unpack8(raw, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= scale;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = pack8(f);
  }

  const int wrow = warp * 16 * MT;           // the warp's first row in the tile
  const bool active = q0 + wrow < Nq;
  uint32_t qa[MT][KS][4];
  float m[MT][2], l[MT][2], o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  }

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile s landed; every warp is done with the buffer refilled next
    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    if (s == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qa[mt][kk], Qs + (wrow + mt * 16) * LD + kk * 16 + ldsm_a_off(lane, LD));
    }
    const bf16* st = ring + (s % STAGES) * T::STAGE;
    float sc[MT][8][4];
    if (POL != kFast && s < n1) {
      // pass 1: the row max of 128 keys, 64 at a time
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kv = Nk - s * 2 * GK - half * GK;  // valid keys from this half on
        if (kv <= 0) break;
        scores64<DT, MT>(qa, st + half * GK * LD, lane, sc);
        if constexpr (POL == kWindow)
          window_logits64<MT>(sc, wbias, wmask, q0 + wrow, s * 2 * GK + half * GK, Nk, lscale,
                              lane);
        if (kv >= GK)
          row_max64<false, MT>(sc, 0, m);
        else
          row_max64<true, MT>(sc, kv - 2 * t, m);
      }
      continue;
    }
    if (POL != kFast && s == n1) {
      // the row max over all keys, in log2 units for exp2 (Safe: the scores
      // are in log2 units already, q carrying log2(e) in s2; Window: expf
      // takes it as it is)
      const float to_log2 = POL == kGeneric ? kLog2e : 1.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        m[mt][0] = quad_max(m[mt][0]) * to_log2;
        m[mt][1] = quad_max(m[mt][1]) * to_log2;
      }
    }
    // pass 2: p in f32 by the policy, l += p, O += bf16(p) V
    const int kv = Nk - (s - n1) * GK;
    scores64<DT, MT>(qa, st, lane, sc);
    if constexpr (POL == kWindow)
      window_logits64<MT>(sc, wbias, wmask, q0 + wrow, (s - n1) * GK, Nk, lscale, lane);
    if (kv >= GK)
      probs64<false, MT, POL>(sc, m, 0, hi, l);
    else
      probs64<true, MT, POL>(sc, m, kv - 2 * t, hi, l);
    const bf16* vp = st + GK * LD + ldsm_b_off(lane, LD);
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) c_to_a(sc[mt][2 * kk], sc[mt][2 * kk + 1], pa[mt]);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vp + kk * 16 * LD + jj * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(o[mt][2 * jj], pa[mt], bv[0], bv[1]);
          mma_16816(o[mt][2 * jj + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }
  if (!active) return;

  // divide by the row sum after P V, round once; O leaves through the warp's
  // own rows of the Q tile in 16-byte stores
  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = quad_sum(l[mt][0]), l1 = quad_sum(l[mt][1]);
    bf16* rows = Qs + (wrow + mt * 16) * LD;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(rows + g * LD + col) =
          pack_bf16x2(o[mt][j][0] / l0, o[mt][j][1] / l0);
      *reinterpret_cast<uint32_t*>(rows + (g + 8) * LD + col) =
          pack_bf16x2(o[mt][j][2] / l1, o[mt][j][3] / l1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * (DT / 8); i += 32) {
    const int r = i / (DT / 8), c = (i % (DT / 8)) * 8;
    const int n = q0 + wrow + r;
    if (n < Nq && c < D)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Nq + n) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(Qs + (wrow + r) * LD + c);
  }
}

template <int DT, int POL>
int launch_generic(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Nq, int Nk,
                   int H, int D, const long long* st, float scale, float hi, cudaStream_t stream,
                   const float* bias = nullptr, const float* mask = nullptr, int nW = 1,
                   float lscale = 1.f) {
  using T = GenTile<DT, POL>;
  const auto kernel = attn_generic_kernel<DT, POL>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the query tile varies slowest: the ragged last tiles, which carry few
  // active warps, are dispatched last and fill the final wave's gaps
  dim3 grid(H, B, (Nq + T::ROWS - 1) / T::ROWS);
  kernel<<<grid, GTH, T::SMEM, stream>>>(q, k, v, out, Nq, Nk, H, D, st[0], st[1], st[2], st[3],
                                         st[4], st[5], st[6], st[7], st[8], scale, hi, bias,
                                         mask, nW, lscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Nq, H, D), k and v (B, Nk, H, D) bf16 read through their (B, N, H)
// strides in elements (the last axis contiguous, every stride % 8 == 0, the
// bases 16-byte aligned); D % 8 == 0, D <= 128; scale already rounded to
// bf16 -> out (B, Nq, H, D) contiguous bf16.
extern "C" int mtt_attn_generic_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                     int Nq, int Nk, int H, int D, long long sqb, long long sqn,
                                     long long sqh, long long skb, long long skn, long long skh,
                                     long long svb, long long svn, long long svh, float scale,
                                     void* stream) {
  if (D < 8 || D % 8 || D > 128 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  auto qp = static_cast<const bf16*>(q);
  auto kp = static_cast<const bf16*>(k);
  auto vp = static_cast<const bf16*>(v);
  auto op = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_generic<32, kGeneric>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, 0.f, s);
  if (D <= 64) return launch_generic<64, kGeneric>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, 0.f, s);
  if (D <= 80) return launch_generic<80, kGeneric>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, 0.f, s);
  return launch_generic<128, kGeneric>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, 0.f, s);
}

// The attention core of rows 1, 2 and 13: qkv (B, N, H*3*64) head-major bf16
// (16-byte aligned) -> out (B, N, H*64) bf16, the head concat. s2 = bf16(scale
// * log2 e); hi = 126 - ceil(log2 N), the fast softmax's upper clamp; safe
// selects the exact-max softmax.
extern "C" int mtt_attn_core_bf16(const void* qkv, void* out, int B, int N, int H, float s2, float hi,
                                  int safe, void* stream) {
  constexpr int AD = 64;
  if (N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ld3 = 3LL * H * AD;
  // q, k and v share the packed tensor's strides: (N * 3C, 3C, 3 * 64)
  const long long st[9] = {N * ld3, ld3, 3 * AD, N * ld3, ld3, 3 * AD, N * ld3, ld3, 3 * AD};
  auto base = static_cast<const bf16*>(qkv);
  auto op = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return safe ? launch_generic<64, kSafe>(base, base + AD, base + 2 * AD, op, B, N, N, H, AD, st, s2,
                                          hi, s)
              : launch_generic<64, kFast>(base, base + AD, base + 2 * AD, op, B, N, N, H, AD, st, s2,
                                          hi, s);
}

// Row 11 past 160 tokens a window (window_attention.cu takes the shorter
// ones in one pass): q, k, v (BW, M, H, 32) bf16 views that share their
// strides in elements: sb between windows, sm between tokens, sh between
// heads, 1 along the head dim (every stride % 8 == 0, the bases 16-byte
// aligned); bias (H, M, M) f32; mask (nW, M, M) f32 or null, window w taking
// mask w % nW -> out (BW, M, H * 32) bf16, contiguous. scale multiplies the
// f32 logits.
extern "C" int mtt_window_attention_streamed_bf16(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* mask, void* out,
                                                  int BW, int M, int H, int nW, long long sb,
                                                  long long sm, long long sh, float scale,
                                                  void* stream) {
  constexpr int WD = 32;
  if (BW < 1 || BW > 65535 || M < 1 || H < 1 || (mask && (nW < 1 || BW % nW)) || sb % 8 ||
      sm % 8 || sh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sb, sm, sh, sb, sm, sh, sb, sm, sh};
  return launch_generic<WD, kWindow>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), BW, M, M, H, WD, st, 1.f, 0.f, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(bias), static_cast<const float*>(mask), mask ? nW : 1, scale);
}
