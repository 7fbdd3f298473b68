// Attention-core backward: dqkv from the head-major qkv (B, N, H*3*64) and the
// output cotangent dOut (B, N, H*64), bf16 in and out.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_bwd_kernel (pallas_call at :655).
// The function is the backward of softmax(q k^T * scale) v with the softmax
// max-subtracted in f32: p = exp(s - max) / sum, dp = dOut v^T,
// r = sum(dp * p), dl = p (dp - r) rounded to bf16, p rounded to bf16 before
// the dv product; dq = dl k * scale, dk = dl^T q * scale, dv = p^T dOut.
//
// What bounds it on the H100: at ViT-L training shapes (B=2, N=1029, H=16,
// D=64) it is tensor-core work, about 5 GFLOP of products per call; the (N, N)
// probability and cotangent matrices must stay out of device memory. The TPU
// kernel holds a whole head's K and V on chip (264 KB in bf16), more than a
// block's 227 KB of shared memory, so this port streams 64-key tiles in a
// flash-style two-kernel design:
//   1. attn_bwd_dq_kernel, one block per (64-query tile, head, item): a first
//      pass over the key tiles finds each row's max, sum and r with an online
//      rescale and stores them (12 bytes a row); a second pass recomputes p and
//      dp per key tile and accumulates dq in f32 fragments.
//   2. attn_bwd_dkdv_kernel, one block per (64-key tile, head, item): loops
//      over the query tiles, recomputes p and dl from the stored row
//      statistics and accumulates dk and dv in f32 fragments.
// Scores and probabilities live only in shared memory and registers. The
// ragged N is masked as the forward masks it: rows past N are zero-filled by
// cp.async and keys past N get p = 0.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int BD = 64;         // head dim
constexpr int BQ = 64;         // query rows per tile (16 per warp)
constexpr int BK = 64;         // keys per tile
constexpr int BLD = BD + 8;    // bf16 leading dim of the Q/G/K/V/P/dL tiles
constexpr int BSL = BK + 4;    // f32 leading dim of the S and dP tiles
constexpr int BT = 128;        // 4 warps
constexpr int kTile = BQ * BLD;
constexpr int kDqSmem = 5 * kTile * 2 + 2 * BQ * BSL * 4;
constexpr int kDkdvSmem = 6 * kTile * 2 + 2 * BQ * BSL * 4 + 3 * BQ * 4;

// S = Q K^T and dP = G V^T for the warp's 16 query rows against one 64-key
// tile, spilled to the warp's rows of Ss and Ps (f32).
__device__ __forceinline__ void scores_and_dp(const bf16* Qs, const bf16* Gs, const bf16* Ks,
                                              const bf16* Vs, float* Ss, float* Ps, int warp) {
  FragC s[4], dp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(s[j], 0.f);
    wmma::fill_fragment(dp[j], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < BD / 16; ++kk) {
    FragA aq, ag;
    wmma::load_matrix_sync(aq, Qs + warp * 16 * BLD + kk * 16, BLD);
    wmma::load_matrix_sync(ag, Gs + warp * 16 * BLD + kk * 16, BLD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBt bk, bv;
      wmma::load_matrix_sync(bk, Ks + j * 16 * BLD + kk * 16, BLD);
      wmma::load_matrix_sync(bv, Vs + j * 16 * BLD + kk * 16, BLD);
      wmma::mma_sync(s[j], aq, bk, s[j]);
      wmma::mma_sync(dp[j], ag, bv, dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(Ss + warp * 16 * BSL + j * 16, s[j], BSL, wmma::mem_row_major);
    wmma::store_matrix_sync(Ps + warp * 16 * BSL + j * 16, dp[j], BSL, wmma::mem_row_major);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(BT) attn_bwd_dq_kernel(const bf16* __restrict__ qkv,
                                                         const bf16* __restrict__ g,
                                                         bf16* __restrict__ dqkv,
                                                         float* __restrict__ stats, int B, int N,
                                                         int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + kTile;
  bf16* Ks = Gs + kTile;
  bf16* Vs = Ks + kTile;
  bf16* Ls = Vs + kTile;
  float* Ss = reinterpret_cast<float*>(Ls + kTile);
  float* Ps = Ss + BQ * BSL;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * BD;
  const size_t ld3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld3 + h * 3 * BD;
  const bf16* gbase = g + (size_t)b * N * C + h * BD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, ch = (lane & 1) * 32;
  const int row = warp * 16 + r;

  load_tile_async<BQ, BD, BT>(Qs, BLD, base + (size_t)q0 * ld3, ld3, N - q0);
  load_tile_async<BQ, BD, BT>(Gs, BLD, gbase + (size_t)q0 * C, C, N - q0);
  cp_async_commit();

  // pass 1: row max, sum of exp and sum of exp * dp, rescaled online; each
  // lane keeps the partial sums of its 32 columns
  float m_run = -INFINITY, l_run = 0.f, rr_run = 0.f;
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kv = min(BK, N - k0);
    load_tile_async<BK, BD, BT>(Ks, BLD, base + (size_t)k0 * ld3 + BD, ld3, kv);
    load_tile_async<BK, BD, BT>(Vs, BLD, base + (size_t)k0 * ld3 + 2 * BD, ld3, kv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores_and_dp(Qs, Gs, Ks, Vs, Ss, Ps, warp);
    const float* srow = Ss + row * BSL + ch;
    const float* prow = Ps + row * BSL + ch;
    float mx = -INFINITY;
    for (int c = 0; c < 32; ++c)
      if (ch + c < kv) mx = fmaxf(mx, srow[c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float ps = 0.f, rs = 0.f;
    for (int c = 0; c < 32; ++c) {
      if (ch + c < kv) {
        const float e = expf(srow[c] * scale - m_new);
        ps += e;
        rs += e * prow[c];
      }
    }
    l_run = l_run * alpha + ps;
    rr_run = rr_run * alpha + rs;
    m_run = m_new;
    __syncthreads();
  }
  const float l_row = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  const float r_row = (rr_run + __shfl_xor_sync(0xffffffffu, rr_run, 1)) / l_row;
  const size_t srow_i = ((size_t)b * H + h) * N + q0 + row;
  const size_t plane = (size_t)B * H * N;
  if ((lane & 1) == 0 && q0 + row < N) {
    stats[srow_i] = m_run;
    stats[plane + srow_i] = l_row;
    stats[2 * plane + srow_i] = r_row;
  }

  // pass 2: dq = dl K, dl = bf16(p (dp - r))
  FragC dq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(dq[j], 0.f);
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kv = min(BK, N - k0);
    load_tile_async<BK, BD, BT>(Ks, BLD, base + (size_t)k0 * ld3 + BD, ld3, kv);
    load_tile_async<BK, BD, BT>(Vs, BLD, base + (size_t)k0 * ld3 + 2 * BD, ld3, kv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores_and_dp(Qs, Gs, Ks, Vs, Ss, Ps, warp);
    const float* srow = Ss + row * BSL + ch;
    const float* prow = Ps + row * BSL + ch;
    bf16* lrow = Ls + row * BLD + ch;
    for (int c = 0; c < 32; ++c) {
      const float p = (ch + c < kv) ? expf(srow[c] * scale - m_run) / l_row : 0.f;
      lrow[c] = __float2bfloat16(p * (prow[c] - r_row));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Ls + warp * 16 * BLD + kk * 16, BLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bk;
        wmma::load_matrix_sync(bk, Ks + kk * 16 * BLD + j * 16, BLD);
        wmma::mma_sync(dq[j], a, bk, dq[j]);
      }
    }
    __syncthreads();
  }
  // dq * scale, rounded once, into the q slot of the head's dqkv columns
  float* scratch = Ss + warp * 16 * BSL;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(scratch + j * 16, dq[j], BSL, wmma::mem_row_major);
  __syncwarp();
  if (q0 + row < N) {
    bf16* dst = dqkv + ((size_t)b * N + q0 + row) * ld3 + h * 3 * BD + ch;
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = scratch[r * BSL + ch + c8 * 8 + k] * scale;
      *reinterpret_cast<uint4*>(dst + c8 * 8) = pack8(f);
    }
  }
}

__global__ void __launch_bounds__(BT) attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                                                           const bf16* __restrict__ g,
                                                           bf16* __restrict__ dqkv,
                                                           const float* __restrict__ stats, int B,
                                                           int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + kTile;
  bf16* Ks = Gs + kTile;
  bf16* Vs = Ks + kTile;
  bf16* Pb = Vs + kTile;
  bf16* Ls = Pb + kTile;
  float* Ss = reinterpret_cast<float*>(Ls + kTile);
  float* Ps = Ss + BQ * BSL;
  float* St = Ps + BQ * BSL;   // m, l, r of the tile's 64 query rows

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int C = H * BD;
  const size_t ld3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld3 + h * 3 * BD;
  const bf16* gbase = g + (size_t)b * N * C + h * BD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, ch = (lane & 1) * 32;
  const int row = warp * 16 + r;
  const int kv = min(BK, N - k0);
  const size_t plane = (size_t)B * H * N;
  const float* sbase = stats + ((size_t)b * H + h) * N;

  load_tile_async<BK, BD, BT>(Ks, BLD, base + (size_t)k0 * ld3 + BD, ld3, kv);
  load_tile_async<BK, BD, BT>(Vs, BLD, base + (size_t)k0 * ld3 + 2 * BD, ld3, kv);
  cp_async_commit();

  FragC dk[4], dv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }
  for (int q0 = 0; q0 < N; q0 += BQ) {
    const int qv = min(BQ, N - q0);
    load_tile_async<BQ, BD, BT>(Qs, BLD, base + (size_t)q0 * ld3, ld3, qv);
    load_tile_async<BQ, BD, BT>(Gs, BLD, gbase + (size_t)q0 * C, C, qv);
    cp_async_commit();
    // rows past N: m = 0, l = 1, r = 0 keep p finite; their Q and dOut rows
    // are zero, so they add nothing to dk or dv
    for (int i = threadIdx.x; i < BQ; i += BT) {
      const bool ok = i < qv;
      St[i] = ok ? sbase[q0 + i] : 0.f;
      St[BQ + i] = ok ? sbase[plane + q0 + i] : 1.f;
      St[2 * BQ + i] = ok ? sbase[2 * plane + q0 + i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    scores_and_dp(Qs, Gs, Ks, Vs, Ss, Ps, warp);
    {
      const float m = St[row], l = St[BQ + row], rr = St[2 * BQ + row];
      const float* srow = Ss + row * BSL + ch;
      const float* prow = Ps + row * BSL + ch;
      for (int c = 0; c < 32; ++c) {
        const float p = (ch + c < kv) ? expf(srow[c] * scale - m) / l : 0.f;
        Pb[row * BLD + ch + c] = __float2bfloat16(p);
        Ls[row * BLD + ch + c] = __float2bfloat16(p * (prow[c] - rr));
      }
    }
    __syncthreads();
    // the warp's 16 keys: dv += P^T dOut, dk += dL^T Q over the tile's queries
#pragma unroll
    for (int qq = 0; qq < BQ / 16; ++qq) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ap, al;
      wmma::load_matrix_sync(ap, Pb + qq * 16 * BLD + warp * 16, BLD);
      wmma::load_matrix_sync(al, Ls + qq * 16 * BLD + warp * 16, BLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bg, bq;
        wmma::load_matrix_sync(bg, Gs + qq * 16 * BLD + j * 16, BLD);
        wmma::load_matrix_sync(bq, Qs + qq * 16 * BLD + j * 16, BLD);
        wmma::mma_sync(dv[j], ap, bg, dv[j]);
        wmma::mma_sync(dk[j], al, bq, dk[j]);
      }
    }
    __syncthreads();
  }
  // dk * scale and dv, rounded once, into the k and v slots
  float* scratch = Ss + warp * 16 * BSL;
  float* scratch2 = Ps + warp * 16 * BSL;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(scratch + j * 16, dk[j], BSL, wmma::mem_row_major);
    wmma::store_matrix_sync(scratch2 + j * 16, dv[j], BSL, wmma::mem_row_major);
  }
  __syncwarp();
  if (k0 + row < N) {
    bf16* dst = dqkv + ((size_t)b * N + k0 + row) * ld3 + h * 3 * BD + BD + ch;
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      float fk[8], fv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        fk[k] = scratch[r * BSL + ch + c8 * 8 + k] * scale;
        fv[k] = scratch2[r * BSL + ch + c8 * 8 + k];
      }
      *reinterpret_cast<uint4*>(dst + c8 * 8) = pack8(fk);
      *reinterpret_cast<uint4*>(dst + BD + c8 * 8) = pack8(fv);
    }
  }
}

}  // namespace

// qkv (B, N, H*3*64) head-major bf16, g (B, N, H*64) bf16 -> dqkv like qkv.
// stats: f32 scratch of 3 * B * H * N (row max, row sum, r), written by the
// first kernel and read by the second.
extern "C" int mtt_attn_bwd_bf16(const void* qkv, const void* g, void* dqkv, void* stats, int B,
                                 int N, int H, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const bf16*>(qkv);
  auto gg = static_cast<const bf16*>(g);
  auto d = static_cast<bf16*>(dqkv);
  auto s = static_cast<float*>(stats);
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDkdvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_bwd_dq_kernel<<<grid, BT, kDqSmem, st>>>(q, gg, d, s, B, N, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<<<grid, BT, kDkdvSmem, st>>>(q, gg, d, s, B, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}
