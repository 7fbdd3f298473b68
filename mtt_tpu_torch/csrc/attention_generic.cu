// Generic multi-head attention: out = softmax(q k^T * scale) v over separate
// (B, Nq, H, D) q and (B, Nk, H, D) k, v, with a max-subtracted softmax.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_kernel (pallas_call at :165,
// wrapper fused_attention at :984). Rounding points, kept by the plain version
// (kernels/attention.py:attention_generic_plain) alike:
//   q' = bf16(q * bf16(scale))              (the JAX wrapper folds the scale)
//   s  = q' k^T in f32                      (bf16 tensor cores, f32 accumulate)
//   p  = exp(s - max_k s)                   (f32, the row max over ALL keys)
//   o  = bf16(p) v / sum_k p                (division after P.V, rounded once)
// The Pallas wrapper transposes q, k, v to (B*H, N, D) and pads the keys to a
// multiple of 128 behind a -1e30 bias row; this kernel reads the (B, N, H)
// strides directly and masks the ragged key tile, which is the same function.
//
// What bounds it on the H100: at a ViT-L self-attention shape (B=8, N=1029,
// H=16, D=64) it is 35 GFLOP on the tensor cores against 34 MB of q, k, v and
// out, so the operations bound it; at InvPT's cross shape (q 5120 rows, k/v
// 320 rows, D=72) the bytes do. The design keeps every product on the bf16
// tensor cores (wmma 16x16x16) and the (Nq, Nk) scores out of device memory.
//
// The max: the TPU kernel holds all Nk keys in VMEM and subtracts the global
// row max before it rounds P to bf16. A streaming kernel with an online max
// would round P relative to a running max and rescale it afterwards, another
// function. This one makes two passes over the key tiles: the first forms the
// scores only for their row max, the second forms them again and rounds P
// relative to that max, as the TPU kernel does. It costs one more q k^T
// product (1.5x the tensor-core work of one pass) and holds for any Nk.
//
// Layout: one block of four warps per (64-query tile, head, batch item); each
// warp owns 16 query rows. The head dim is padded with zeros to the tile DT
// (32, 64, 80 or 128) in shared memory; padded columns add nothing.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int GQ = 64;        // query rows per block (16 per warp)
constexpr int GK = 64;        // keys per streamed tile
constexpr int GSL = GK + 4;   // f32 leading dim of the score tile
constexpr int PLD = GK + 8;   // bf16 leading dim of the P tile
constexpr int GTH = 128;

template <int DT>
constexpr int generic_smem() {
  return (GQ + 2 * GK) * (DT + 8) * 2 + GQ * PLD * 2 + GQ * GSL * 4;
}

// ROWS x DT bf16 tile of a strided matrix (row stride ldg elements, 16-byte
// aligned rows); rows at or past row_limit and columns at or past D are zero.
template <int ROWS, int DT>
__device__ __forceinline__ void load_rows_async(bf16* s, const bf16* g, long long ldg,
                                                int row_limit, int D) {
  constexpr int CH = DT / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += GTH) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < row_limit && c < D;
    cp_async16(s + r * (DT + 8) + c, ok ? g + r * ldg + c : g, ok);
  }
}

// The warp's 16 query rows (Qw) against the 64 keys in Ks -> Sw (f32).
template <int DT>
__device__ __forceinline__ void warp_scores(const bf16* Qw, const bf16* Ks, float* Sw) {
  FragC s[GK / 16];
#pragma unroll
  for (int j = 0; j < GK / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, Qw + kk * 16, DT + 8);
#pragma unroll
    for (int j = 0; j < GK / 16; ++j) {
      FragBt bt;
      wmma::load_matrix_sync(bt, Ks + j * 16 * (DT + 8) + kk * 16, DT + 8);
      wmma::mma_sync(s[j], a, bt, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < GK / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, s[j], GSL, wmma::mem_row_major);
  __syncwarp();
}

template <int DT>
__global__ void __launch_bounds__(GTH) attn_generic_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int Nq, int Nk, int H, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, float scale) {
  constexpr int LD = DT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + GQ * LD;
  bf16* Vs = Ks + GK * LD;
  bf16* Ps = Vs + GK * LD;
  float* Ss = reinterpret_cast<float*>(Ps + GQ * PLD);

  const int q0 = blockIdx.x * GQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;

  // Q tile times the bf16 scale, rounded to bf16 once; zero past Nq and D
  for (int i = threadIdx.x; i < GQ * (DT / 8); i += GTH) {
    const int r = i / (DT / 8), c = (i % (DT / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq && c < D) raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sqn + c);
    float f[8];
    unpack8(raw, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= scale;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = pack8(f);
  }

  // lane owns row (lane >> 1) of its warp's 16 rows, key columns ch .. ch + 31
  const int r = lane >> 1, ch = (lane & 1) * 32;
  const bf16* Qw = Qs + warp * 16 * LD;
  float* Sw = Ss + warp * 16 * GSL;
  bf16* Pw = Ps + warp * 16 * PLD;
  const float* srow = Sw + r * GSL + ch;

  // pass 1: the row max over all keys
  float m = -INFINITY;
  for (int k0 = 0; k0 < Nk; k0 += GK) {
    const int kv = min(GK, Nk - k0);
    load_rows_async<GK, DT>(Ks, kb + k0 * skn, skn, kv, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_scores<DT>(Qw, Ks, Sw);
    for (int c = 0; c < 32; ++c)
      if (ch + c < kv) m = fmaxf(m, srow[c]);
    __syncthreads();  // every warp is done with Ks
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: P = exp(s - m) rounded to bf16, O += P V, the f32 row sum of p
  FragC o[DT / 16];
#pragma unroll
  for (int j = 0; j < DT / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  float l = 0.f;
  bf16* prow = Pw + r * PLD + ch;
  for (int k0 = 0; k0 < Nk; k0 += GK) {
    const int kv = min(GK, Nk - k0);
    load_rows_async<GK, DT>(Ks, kb + k0 * skn, skn, kv, D);
    load_rows_async<GK, DT>(Vs, vb + k0 * svn, svn, kv, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_scores<DT>(Qw, Ks, Sw);
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = (ch + c < kv) ? expf(srow[c] - m) : 0.f;
      l += p;
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Pw + kk * 16, PLD);
#pragma unroll
      for (int j = 0; j < DT / 16; ++j) {
        FragB bv;
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LD + j * 16, LD);
        wmma::mma_sync(o[j], a, bv, o[j]);
      }
    }
    __syncthreads();  // every warp is done with Ks and Vs
  }

  // divide by the row sum after P V, round once; O leaves through the warp's
  // score strip 64 columns at a time
  const float tot = l + __shfl_xor_sync(0xffffffffu, l, 1);
  const int n = q0 + warp * 16 + r;
  bf16* dst = out + (((size_t)b * Nq + n) * H + h) * D;
#pragma unroll
  for (int j0 = 0; j0 < DT / 16; j0 += 4) {
#pragma unroll
    for (int j = j0; j < j0 + 4 && j < DT / 16; ++j)
      wmma::store_matrix_sync(Sw + (j - j0) * 16, o[j], GSL, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      const int cc = ch + c8 * 8, col = j0 * 16 + cc;
      if (n < Nq && col < D) {
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = Sw[r * GSL + cc + j] / tot;
        *reinterpret_cast<uint4*>(dst + col) = pack8(f);
      }
    }
    __syncwarp();
  }
}

template <int DT>
int launch_generic(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Nq, int Nk,
                   int H, int D, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem = generic_smem<DT>();
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(attn_generic_kernel<DT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Nq + GQ - 1) / GQ, H, B);
  attn_generic_kernel<DT><<<grid, GTH, smem, stream>>>(q, k, v, out, Nq, Nk, H, D, st[0], st[1],
                                                       st[2], st[3], st[4], st[5], st[6], st[7],
                                                       st[8], scale);
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
  if (D <= 32) return launch_generic<32>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, s);
  if (D <= 64) return launch_generic<64>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, s);
  if (D <= 80) return launch_generic<80>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, s);
  return launch_generic<128>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, s);
}
