// Attention-core backward: dqkv from the head-major qkv (B, N, H*3*D) and the
// output cotangent dOut (B, N, H*D), bf16 in and out; D a multiple of 8 up to
// 128 (ViT-L and ViT-B 64, ViT-T 16).
//
// Replaces mtt_tpu/kernels/attention.py:_attn_bwd_kernel (pallas_call at :655).
// The function is the backward of softmax(q k^T * scale) v with the softmax
// max-subtracted in f32 and the scale applied to the f32 logits:
// p = exp(s - max) / sum, dp = dOut v^T, r = sum(dp * p) in f32 from dp,
// dl = p (dp - r) rounded to bf16, p rounded to bf16 before the dv product;
// dq = dl k * scale, dk = dl^T q * scale, dv = p^T dOut.
//
// What bounds it on the H100: at ViT-L training shapes (B=2, N=1029, H=16,
// D=64) it is tensor-core work, 5 N x N x D products per (item, head); the
// (N, N) probability and cotangent matrices must stay out of device memory.
// The TPU kernel holds a whole head's K and V on chip (264 KB in bf16), more
// than a block's 227 KB of shared memory, so this port streams 64-row tiles in
// a two-kernel design with no atomics (the bits are equal run to run):
//   1. attn_bwd_dq_kernel, one block per (head, item, 64-query tile), each warp
//      owning 16 query rows with their Q and dOut fragments in registers: a
//      stats pass over the key tiles forms S = Q K^T and dP = dOut V^T in
//      registers and keeps each row's max m, sum l and sum(e dp) with an
//      online rescale (quad shuffles), then stores r = sum(e dp) / l and
//      lse = m log2(e) + log2(l) (8 bytes a row); a dq pass forms S and dP
//      again, p = exp(s scale - m) / l as exp2(s scale log2(e) - lse) and
//      dl = bf16(p (dp - r)) straight from the accumulators into A fragments,
//      and runs dQ += dL K with K read by ldmatrix.trans.
//   2. attn_bwd_dkdv_kernel, one block per (head, item, 64-key tile), each warp
//      owning 16 key rows: for every query tile it forms S^T = K Q^T and dP^T =
//      V dOut^T, so that P^T and dL^T leave the accumulators as A fragments,
//      reads lse and r of its fragment's query columns from the stats the
//      first kernel stored, and runs dV += P^T dOut and dK += dL^T Q with Q and
//      dOut read by ldmatrix.trans.
// The exponentials are exp2f of one fma each, and the division by l is folded
// into lse: the per-score instructions compete with the products for issue
// slots. Only the ragged last tile takes the masked path.
// Every product is an mma.sync m16n8k16 (common.cuh); S, P, dP and dL never
// touch shared memory. Both kernels stream their tiles through a two-buffer
// cp.async ring (the next tile's copy lands while the current tile's products
// run, one barrier a tile) and work on 32 keys (queries) of a 64-row tile at a
// time to keep their registers at 128, so four blocks fit on an SM: each of
// the ViT-L step's 544-block grids is one wave on 132 SMs (512 full blocks and
// 32 one-warp blocks of the ragged last tile, dispatched last). The two
// kernels form 9 N x N x D products (S and dP three times) against the 5 the
// function needs: no dq sum crosses blocks. The ragged N is masked: rows past
// N are zero-filled by cp.async and their p is 0.
//
// Head dims: the kernels are templates over the head-dim tile DT (16, 32, 64,
// 80 or 128, the head dim rounded up), which sizes the Q, K, V and dOut tiles
// and the dq, dk and dv accumulators; columns past D are zero-filled by
// cp.async, add nothing to S or dP, and are not stored. The 64-row tiles, the
// stats planes and the rounding points are the same at every DT. Blocks an SM
// (__launch_bounds__): 4 up to DT 64 (128 registers), 3 at 80, 2 at 128,
// whose accumulators (2 x 16 x 4 floats a lane in the dk/dv kernel) and Q and
// dOut fragments (64 registers in the dq kernel) need up to 255 registers and
// whose 6 tiles take 104 KB of shared memory.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int BR = 64;          // rows per tile (16 per warp)
constexpr int KC = 32;          // keys (queries) per chunk of a tile
constexpr int BT = 128;         // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of head-dim tile DT: bf16 rows DT + 8 apart (conflict-free
// ldmatrix rows); Q and dOut tiles then two ring buffers of (K, V) for the dq
// kernel; K and V tiles, two ring buffers of (Q, dOut), then two of (lse, r)
// for the dk/dv kernel.
template <int DT>
struct BwdTile {
  static constexpr int LD = DT + 8;
  static constexpr int TILE = BR * LD;
  static constexpr int DQ_SMEM = 6 * TILE * 2;
  static constexpr int DKDV_SMEM = 6 * TILE * 2 + 2 * 2 * BR * 4;
  static constexpr int MIN_BLOCKS = DT <= 64 ? 4 : (DT <= 80 ? 3 : 2);
};

__device__ __forceinline__ void zero(float (&c)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// The warp's 16 rows against 32 rows of the row-major tiles X and Y (B = X^T,
// Y^T): c = A X^T, d = B Y^T. A and B are DT / 16 k16 fragments each, held
// in registers (fa, fb) or, when As is not null, read step by step from the
// warp's 16 rows of the tiles As and Bs.
template <int DT>
__device__ __forceinline__ void two_products(const uint32_t (&fa)[DT / 16][4],
                                             const uint32_t (&fb)[DT / 16][4], const bf16* As,
                                             const bf16* Bs, const bf16* X, const bf16* Y, int lane,
                                             float (&c)[4][4], float (&d)[4][4]) {
  constexpr int LD = BwdTile<DT>::LD;
  zero(c);
  zero(d);
  const int off = ldsm_bt_off(lane, LD), aoff = ldsm_a_off(lane, LD);
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = fa[kk][i];
      b[i] = fb[kk][i];
    }
    if (As) {
      ldsm_x4(a, As + kk * 16 + aoff);
      ldsm_x4(b, Bs + kk * 16 + aoff);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t x[4], y[4];
      ldsm_x4(x, X + jj * 16 * LD + kk * 16 + off);
      ldsm_x4(y, Y + jj * 16 * LD + kk * 16 + off);
      mma_16816(c[2 * jj], a, x[0], x[1]);
      mma_16816(c[2 * jj + 1], a, x[2], x[3]);
      mma_16816(d[2 * jj], b, y[0], y[1]);
      mma_16816(d[2 * jj + 1], b, y[2], y[3]);
    }
  }
}

// acc (16 x DT) += A (16 x 32, two k16 fragments) times 32 rows of the
// row-major (32, DT) tile X (B = X, read by ldmatrix.trans).
template <int DT>
__device__ __forceinline__ void product_acc(const uint32_t (&a)[2][4], const bf16* X, int lane,
                                            float (&acc)[DT / 8][4]) {
  constexpr int LD = BwdTile<DT>::LD;
  const int off = ldsm_b_off(lane, LD);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int jj = 0; jj < DT / 16; ++jj) {
      uint32_t x[4];
      ldsm_x4_trans(x, X + kk * 16 * LD + jj * 16 + off);
      mma_16816(acc[2 * jj], a[kk], x[0], x[1]);
      mma_16816(acc[2 * jj + 1], a[kk], x[2], x[3]);
    }
  }
}

// The warp's 16 x DT accumulator, times mul and rounded to bf16 once, into
// its rows of the tile T, then 16-byte stores of the valid rows' first D
// columns to dst (row stride ld elements).
template <int DT>
__device__ __forceinline__ void store_rows(const float (&acc)[DT / 8][4], float mul, bf16* T,
                                           int row0, int valid, int D, bf16* dst, size_t ld,
                                           int lane) {
  constexpr int LD = BwdTile<DT>::LD;
  bf16* rows = T + row0 * LD;
#pragma unroll
  for (int j = 0; j < DT / 8; ++j) c_to_smem(acc[j], rows, LD, j * 8, lane, mul);
  __syncwarp();
  for (int i = lane; i < 16 * (DT / 8); i += 32) {
    const int r = i / (DT / 8), c = (i % (DT / 8)) * 8;
    if (r < valid && c < D)
      *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(rows + r * LD + c);
  }
}

// One 32-key chunk of the stats pass (C tiles sc = S, dp = dP): the running
// row max m (log2 units), sum l of e = exp2(s c2 - m) and sum rr of e dp,
// rescaled online. Lane keys at or past kvt are left out where MASK.
template <bool MASK>
__device__ __forceinline__ void stats_chunk(const float (&sc)[4][4], const float (&dp)[4][4],
                                            float c2, int kvt, float (&m)[2], float (&l)[2],
                                            float (&rr)[2]) {
  float x[4][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] = !MASK || j * 8 + (e & 1) < kvt ? sc[j][e] * c2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
    }
  float m_new[2], ps[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) m_new[i] = fmaxf(m[i], quad_max(mx[i]));
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ee = exp2f(x[j][e] - m_new[e >> 1]);
      ps[e >> 1] += ee;
      rs[e >> 1] += ee * dp[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float alpha = exp2f(m[i] - m_new[i]);
    l[i] = l[i] * alpha + ps[i];
    rr[i] = rr[i] * alpha + rs[i];
    m[i] = m_new[i];
  }
}

// dl = p (dp - r) with p = exp(s scale - m) / l = exp2(s c2 - lse), in place
// of sc (rows g and g + 8 of the C tiles: lse and r per row). Lane keys at
// or past kvt get p = 0 where MASK.
template <bool MASK>
__device__ __forceinline__ void dl_chunk(float (&sc)[4][4], const float (&dp)[4][4], float c2,
                                         const float (&lse)[2], const float (&r)[2], int kvt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = exp2f(fmaf(sc[j][e], c2, -lse[i]));
      sc[j][e] = !MASK || j * 8 + (e & 1) < kvt ? p * (dp[j][e] - r[i]) : 0.f;
    }
}

template <int DT, bool FIXED>
__global__ void __launch_bounds__(BT, BwdTile<DT>::MIN_BLOCKS) attn_bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    float* __restrict__ stats, int B, int N, int H, int d_in, float scale) {
  constexpr int BLD = BwdTile<DT>::LD, kTile = BwdTile<DT>::TILE, KS = DT / 16, NT = DT / 8;
  const int D = FIXED ? DT : d_in;   // a head dim that fills its tile is a constant
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + kTile;
  bf16* ring = Gs + kTile;   // buffer i: K at ring + 2 i kTile, V after it

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * BR;
  const int C = H * D;
  const size_t ld3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld3 + h * 3 * D;
  const bf16* gbase = g + (size_t)b * N * C + h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, gq = lane >> 2;
  const int nkt = (N + BR - 1) / BR, nsteps = 2 * nkt;   // stats pass, then dq pass

  auto issue = [&](int s) {
    const int k0 = (s % nkt) * BR;
    bf16* kt = ring + (s & 1) * 2 * kTile;
    load_rows_async_fixed<BR, DT, BLD, BT>(kt, base + (size_t)k0 * ld3 + D, ld3, N - k0, D);
    load_rows_async_fixed<BR, DT, BLD, BT>(kt + kTile, base + (size_t)k0 * ld3 + 2 * D, ld3, N - k0, D);
  };
  load_rows_async_fixed<BR, DT, BLD, BT>(Qs, base + (size_t)q0 * ld3, ld3, N - q0, D);
  load_rows_async_fixed<BR, DT, BLD, BT>(Gs, gbase + (size_t)q0 * C, C, N - q0, D);
  issue(0);
  cp_async_commit();

  const bool active = q0 + warp * 16 < N;
  uint32_t qa[KS][4], ga[KS][4];
  const float c2 = scale * kLog2e;   // logits in log2 units: s * scale * log2(e)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, rr_run[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s landed; every warp is done with the buffer refilled next
    if (s + 1 < nsteps) issue(s + 1);
    cp_async_commit();
    if (!active) continue;
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldsm_x4(qa[kk], Qs + warp * 16 * BLD + kk * 16 + ldsm_a_off(lane, BLD));
        ldsm_x4(ga[kk], Gs + warp * 16 * BLD + kk * 16 + ldsm_a_off(lane, BLD));
      }
    }
    if (s == nkt) {
      // end of the stats pass: whole-row sums, r = sum(e dp) / l, and
      // log2 of the row's softmax denominator, m log2(e) + log2(l)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l = quad_sum(l_run[i]);
        rr[i] = quad_sum(rr_run[i]) / l;
        lse[i] = m_run[i] + log2f(l);
      }
    }
    const bf16* Kt = ring + (s & 1) * 2 * kTile;
    const bf16* Vt = Kt + kTile;
    const int kv = N - (s % nkt) * BR;   // valid keys from this tile's first on
#pragma unroll
    for (int kc = 0; kc < BR; kc += KC) {
      if (kc >= kv) break;
      float sc[4][4], dp[4][4];
      two_products<DT>(qa, ga, nullptr, nullptr, Kt + kc * BLD, Vt + kc * BLD, lane, sc, dp);
      const int kvt = kv - kc - 2 * t;   // lane keys at or past kvt are masked
      if (s < nkt) {
        if (kv - kc >= KC)
          stats_chunk<false>(sc, dp, c2, kvt, m_run, l_run, rr_run);
        else
          stats_chunk<true>(sc, dp, c2, kvt, m_run, l_run, rr_run);
      } else {
        // dq: dl = bf16(p (dp - r)) as A fragments, dQ += dL K
        if (kv - kc >= KC)
          dl_chunk<false>(sc, dp, c2, lse, rr, kvt);
        else
          dl_chunk<true>(sc, dp, c2, lse, rr, kvt);
        uint32_t la[2][4];
        c_to_a(sc[0], sc[1], la[0]);
        c_to_a(sc[2], sc[3], la[1]);
        product_acc<DT>(la, Kt + kc * BLD, lane, dq);
      }
    }
  }

  // log2 of the denominator and r of the warp's rows (rows past N: 0, 0);
  // rows of the stats planes are padded to a multiple of 64
  const int Np = nkt * BR;
  const size_t plane = (size_t)B * H * Np;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + gq + 8 * i;
      const bool ok = active && row < N;
      const size_t at = ((size_t)b * H + h) * Np + row;
      stats[at] = ok ? lse[i] : 0.f;
      stats[plane + at] = ok ? rr[i] : 0.f;
    }
  }
  // dq * scale, rounded once, into the q slot of the head's dqkv columns
  if (active)
    store_rows<DT>(dq, scale, Qs, warp * 16, N - q0 - warp * 16, D,
                   dqkv + ((size_t)b * N + q0 + warp * 16) * ld3 + h * 3 * D, ld3, lane);
}

// p^T and dl^T of one 32-query chunk in place of st = S^T and dpt = dP^T
// (rows: the warp's keys; columns: queries, whose lse and r are at S and
// S + BR): p = exp2(s c2 - lse), dl = p (dp - r). Where MASK, keys past N
// (key_ok) and queries at or past qv get p = dl = 0.
template <bool MASK>
__device__ __forceinline__ void p_dl_chunk(float (&st)[4][4], float (&dpt)[4][4], const float* S,
                                           float c2, const bool (&key_ok)[2], int qv, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = j * 8 + 2 * t;   // query of value e: col + (e & 1)
    const float2 lse = *reinterpret_cast<const float2*>(S + col);
    const float2 r = *reinterpret_cast<const float2*>(S + BR + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(st[j][e], c2, -(e & 1 ? lse.y : lse.x)));
      const float dl = p * (dpt[j][e] - (e & 1 ? r.y : r.x));
      const bool ok = !MASK || (key_ok[e >> 1] && col + (e & 1) < qv);
      st[j][e] = ok ? p : 0.f;
      dpt[j][e] = ok ? dl : 0.f;
    }
  }
}

template <int DT, bool FIXED>
__global__ void __launch_bounds__(BT, BwdTile<DT>::MIN_BLOCKS) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    const float* __restrict__ stats, int B, int N, int H, int d_in, float scale) {
  constexpr int BLD = BwdTile<DT>::LD, kTile = BwdTile<DT>::TILE, KS = DT / 16, NT = DT / 8;
  const int D = FIXED ? DT : d_in;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile;
  bf16* ring = Vs + kTile;   // buffer i: Q at ring + 2 i kTile, dOut after it
  float* St = reinterpret_cast<float*>(ring + 4 * kTile);   // buffer i: lse, r at St + 2 i BR

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BR;
  const int C = H * D;
  const size_t ld3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld3 + h * 3 * D;
  const bf16* gbase = g + (size_t)b * N * C + h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, gq = lane >> 2;
  const int nqt = (N + BR - 1) / BR, Np = nqt * BR;
  const size_t plane = (size_t)B * H * Np;
  const float* sbase = stats + ((size_t)b * H + h) * Np;

  auto issue = [&](int s) {
    const int q0 = s * BR;
    bf16* qt = ring + (s & 1) * 2 * kTile;
    load_rows_async_fixed<BR, DT, BLD, BT>(qt, base + (size_t)q0 * ld3, ld3, N - q0, D);
    load_rows_async_fixed<BR, DT, BLD, BT>(qt + kTile, gbase + (size_t)q0 * C, C, N - q0, D);
    if (threadIdx.x < 2 * BR / 4) {   // 32 x 16 bytes of lse and r
      const int a = threadIdx.x / (BR / 4), c = (threadIdx.x % (BR / 4)) * 4;
      cp_async16(St + (s & 1) * 2 * BR + a * BR + c, sbase + a * plane + q0 + c, true);
    }
  };
  load_rows_async_fixed<BR, DT, BLD, BT>(Ks, base + (size_t)k0 * ld3 + D, ld3, N - k0, D);
  load_rows_async_fixed<BR, DT, BLD, BT>(Vs, base + (size_t)k0 * ld3 + 2 * D, ld3, N - k0, D);
  issue(0);
  cp_async_commit();

  const bool active = k0 + warp * 16 < N;
  const bool keys_full = k0 + warp * 16 + 16 <= N;   // no key row of the warp past N
  // keys of the warp's fragment rows g and g + 8 past N get p = 0
  const bool key_ok[2] = {k0 + warp * 16 + gq < N, k0 + warp * 16 + gq + 8 < N};
  const float c2 = scale * kLog2e;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const uint32_t no_frag[KS][4] = {};

  for (int s = 0; s < nqt; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s landed; every warp is done with the buffer refilled next
    if (s + 1 < nqt) issue(s + 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* Qt = ring + (s & 1) * 2 * kTile;
    const bf16* Gt = Qt + kTile;
    const float* Sm = St + (s & 1) * 2 * BR;
    const int qv = N - s * BR;   // valid queries from this tile's first on
#pragma unroll
    for (int qc = 0; qc < BR; qc += KC) {
      if (qc >= qv) break;
      // the warp's 16 keys against 32 queries: S^T = K Q^T, dP^T = V dOut^T,
      // the K and V fragments read from the resident tiles step by step
      float st[4][4], dpt[4][4];
      two_products<DT>(no_frag, no_frag, Ks + warp * 16 * BLD, Vs + warp * 16 * BLD, Qt + qc * BLD,
                   Gt + qc * BLD, lane, st, dpt);
      if (keys_full && qv - qc >= KC)
        p_dl_chunk<false>(st, dpt, Sm + qc, c2, key_ok, qv - qc, t);
      else
        p_dl_chunk<true>(st, dpt, Sm + qc, c2, key_ok, qv - qc, t);
      uint32_t pa[2][4], la[2][4];
      c_to_a(st[0], st[1], pa[0]);
      c_to_a(st[2], st[3], pa[1]);
      c_to_a(dpt[0], dpt[1], la[0]);
      c_to_a(dpt[2], dpt[3], la[1]);
      product_acc<DT>(pa, Gt + qc * BLD, lane, dv);
      product_acc<DT>(la, Qt + qc * BLD, lane, dk);
    }
  }
  if (!active) return;
  // dk * scale and dv, rounded once, into the k and v slots
  const int valid = N - k0 - warp * 16;
  bf16* dst = dqkv + ((size_t)b * N + k0 + warp * 16) * ld3 + h * 3 * D + D;
  store_rows<DT>(dk, scale, Ks, warp * 16, valid, D, dst, ld3, lane);
  store_rows<DT>(dv, 1.f, Vs, warp * 16, valid, D, dst + D, ld3, lane);
}

template <int DT, bool FIXED>
int launch_bwd_as(const bf16* q, const bf16* gg, bf16* d, float* s, int B, int N, int H, int D,
                  float scale, cudaStream_t st) {
  using T = BwdTile<DT>;
  const auto dq = attn_bwd_dq_kernel<DT, FIXED>;
  const auto dkdv = attn_bwd_dkdv_kernel<DT, FIXED>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // all of the SM's 228 KB as shared memory: MIN_BLOCKS blocks of each fit
  const void* kernels[2] = {(const void*)dq, (const void*)dkdv};
  for (const void* f : kernels) {
    e = cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the row tile varies slowest: the ragged last tiles, which carry few
  // active warps, are dispatched last and fill the wave's gaps
  dim3 grid(H, B, (N + BR - 1) / BR);
  dq<<<grid, BT, T::DQ_SMEM, st>>>(q, gg, d, s, B, N, H, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<grid, BT, T::DKDV_SMEM, st>>>(q, gg, d, s, B, N, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// D in the tile DT: as a constant where it fills the tile (ViT-L's 64, ViT-T's
// 16: the addressing folds as it did when the head dim was fixed), else read
// at run time.
template <int DT>
int launch_bwd(const bf16* q, const bf16* gg, bf16* d, float* s, int B, int N, int H, int D,
               float scale, cudaStream_t st) {
  return D == DT ? launch_bwd_as<DT, true>(q, gg, d, s, B, N, H, D, scale, st)
                 : launch_bwd_as<DT, false>(q, gg, d, s, B, N, H, D, scale, st);
}

}  // namespace

// qkv (B, N, H*3*D) head-major bf16, g (B, N, H*D) bf16 -> dqkv like qkv; D
// a multiple of 8 from 8 to 128, taken in the tile of 16, 32, 64, 80 or 128
// columns that holds it. stats: f32 scratch of 2 * B * H * Np, Np = N rounded
// up to a multiple of 64 (log2 of each row's softmax denominator, r), written
// by the first kernel and read by the second.
extern "C" int mtt_attn_bwd_bf16(const void* qkv, const void* g, void* dqkv, void* stats, int B,
                                 int N, int H, int D, float scale, void* stream) {
  if (D < 8 || D % 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const bf16*>(qkv);
  auto gg = static_cast<const bf16*>(g);
  auto d = static_cast<bf16*>(dqkv);
  auto s = static_cast<float*>(stats);
  if (D <= 16) return launch_bwd<16>(q, gg, d, s, B, N, H, D, scale, st);
  if (D <= 32) return launch_bwd<32>(q, gg, d, s, B, N, H, D, scale, st);
  if (D <= 64) return launch_bwd<64>(q, gg, d, s, B, N, H, D, scale, st);
  if (D <= 80) return launch_bwd<80>(q, gg, d, s, B, N, H, D, scale, st);
  return launch_bwd<128>(q, gg, d, s, B, N, H, D, scale, st);
}
