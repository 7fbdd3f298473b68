// Softmax attention core in f32, 3xTF32 on mma.sync: the f32 form of
// attn_generic_kernel (attention_generic.cu) under its Generic, Fast and Safe
// softmax policies.
//   Generic, row 14: out = softmax(q k^T * scale) v over separate (B, Nq, H,
//     D) q and (B, Nk, H, D) k, v, max-subtracted.
//   Fast and Safe, rows 1-2's third launch and row 13: attention over the
//     head-major packed qkv (B, N, H*3*D), fast exp2 or max-subtracted
//     softmax.
//
// Replaces, at f32, mtt_tpu/kernels/attention.py:_attn_kernel (pallas_call at
// :165) and _attn_qkv_kernel (:230, pallas_call at :257; the same core inside
// _attn_ln_qkv_cached_kernel :423 and _attn_ln_qkv_kernel :393). The TPU
// kernels compute in the input dtype with f32 sums; at f32 every rounding
// point of theirs (and of the plain versions, kernels/attention.py:
// attention_generic_plain, attention_qkv_plain) is the identity:
//   Generic: q' = q * scale; p = exp(s - max_k s)
//   Fast:    q' = q * s2, s2 = f32(scale * log2 e); p = exp2(clamp(s, -120,
//            hi)), hi = 126 - ceil(log2 N), no max
//   Safe:    q' as Fast, p = exp2(s - max_k s)
//   all:     s = q' k^T, o = (p v) / sum_k p, all in f32.
// The products hold f32 accuracy as three TF32 products of split operands
// (common.cuh: split_tf32): x = hi + lo, and lo.hi + hi.lo + hi.hi summed in
// f32, the small terms first. Generic and Safe take the max in one online
// pass: a running row max, O and the row sum rescaled by exp2(m_old - m_new)
// when a key tile raises it. At f32 nothing but f32 sums is rounded, so this
// moves results by f32 rounding only (the plain versions keep the exact max
// of the TPU kernels, which hold every key in VMEM). Safe needs no clamp:
// every exponent is at most 0 against the running max.
//
// What bounds it on the H100: at a ViT-L self-attention shape (B=8, N=1029,
// H=16, D=64) it is 35 GFLOP against 136 MB of q, k, v and out; three TF32
// passes at 495 TFLOP/s take 0.210 ms, the bytes 0.041: the operations bound
// it. (On the CUDA cores, 67 TFLOP/s, 0.518 ms.)
//
// Design: the bf16 core's structure (attention_generic.cu: mma.sync, scores
// in registers) carried to tf32 m16n8k8. A block of four warps owns 64 MT
// query rows of one (head, batch item), a warp 16 MT of them: MT = 2 at head
// dims up to 64, so that two m16 row tiles share every K and V fragment and
// its split (10% faster than one on the card), 1 at 128 (the registers);
// key tiles of 32 stream through a ring of two cp.async stages (64-key tiles
// measured 2-4% slower). Each k-step's operands come from
// shared memory as f32 and are split in registers: Q and K rows with one
// 16-byte read per lane, the 16 head-dim columns of a read permuted alike in
// both (a q.k sum does not care in what order it runs over d); V by columns.
// S = q'k^T is three products a k-step, then the policy's p in f32, then P.V,
// three products a k-step with P straight from the score registers: the C
// fragment holds keys 2t, 2t + 1 of each group of 8 where the A fragment
// wants t, t + 4, so the keys of each group are permuted alike in P and V
// (V's rows 2t and 2t + 1 feed the k rows t and t + 4). Row pitches put every
// read on distinct banks. The tensor core adds into its accumulator by
// truncation at the accumulator's ulp, an error that grows with the number
// of products folded in (387 of k 8 over a walk of 1029 keys): each key
// tile's P.V starts from zero and joins O with a round-to-nearest add, as
// the f32 GEMM's stages do (gemm_f32.cu). At the end
// the row sums meet by quad shuffles, O is divided by them once and written.
// No atomics: two runs give the same bits.
#include <type_traits>

#include "common.cuh"

using namespace mtt;

namespace {

constexpr int NT = 128;     // threads: four warps
constexpr int STAGES = 2;   // ring buffers of K and V
constexpr float kLog2e = 1.4426950408889634f;

enum Policy { kGeneric, kFast, kSafe };

template <int DT>
struct F32Tile {
  // m16 row tiles a warp: two share every K and V fragment (and its split)
  // where the registers allow it
  static constexpr int MT = DT <= 64 ? 2 : 1;
  static constexpr int QT = 64 * MT;  // query rows of a block
  static constexpr int KT = 32;       // keys of a tile
  // Q and K rows: a quarter-warp's 16-byte reads (rows g, g + 1, columns 4 t)
  // on distinct banks needs a pitch of 16 mod 32 floats
  static constexpr int LDK = DT % 32 == 16 ? DT : DT + 16;
  // V rows: a warp's reads (rows 2 t, column g) on distinct banks needs 4 or
  // 20 mod 32 (8 t + g over the warp)
  static constexpr int LDV = DT + 4;
  static constexpr int STAGE = KT * (LDK + LDV);  // K tile then V tile (floats)
  static constexpr int SMEM = (QT * LDK + STAGES * STAGE) * 4;
};

// D (16 x 8, f32) += A (16 x 8) . B (8 x 8), tf32 operands: lane 4 g + t
// holds a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, column g), b1 (k t + 4, g); d0, d1 (row g, columns 2 t, 2 t + 1),
// d2, d3 (row g + 8).
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b over split operands: lo.hi, hi.lo, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_1688(d, al, bh0, bh1);
  mma_1688(d, ah, bl0, bl1);
  mma_1688(d, ah, bh0, bh1);
}

__device__ __forceinline__ void split_u(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split_tf32(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// Copies the rows of one tile (ROWS x DT floats of a row-major matrix with
// row stride ldg) into shared memory at pitch LD with cp.async, zero-filling
// rows at or past row_limit and columns at or past D (D % 4 == 0).
template <int ROWS, int DT, int LD>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long ldg, int row_limit,
                                          int D) {
  constexpr int CH = DT / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r < row_limit && c < D;
    cp_async16(s + r * LD + c, ok ? g + r * ldg + c : g, ok);
  }
}

// The running max of the tile's scores (C tiles sc) over valid keys, per row
// (g, g + 8); lane keys at or past kvt (valid keys minus 2 t) are left out
// where MASK.
template <bool MASK, int NS>
__device__ __forceinline__ void tile_max(const float (&sc)[NS][4], int kvt, float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASK || 8 * j + (e & 1) < kvt) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
}

// p in f32 over the tile's scores, in place, by the policy: Generic exp(s - m)
// = exp2(s log2(e) - m log2(e)), Safe exp2(s - m) (the scores and the running
// max in log2 units), Fast exp2(clamp(s, -120, hi)); l += p. Keys at or past
// kvt get p = 0 where MASK.
template <bool MASK, int POL, int NS>
__device__ __forceinline__ void probs(float (&sc)[NS][4], const float (&mlog)[2], int kvt,
                                      float hi, float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[j][e];
      float p = POL == kGeneric ? exp2f(fmaf(x, kLog2e, -mlog[e >> 1]))
                : POL == kSafe  ? exp2f(x - mlog[e >> 1])
                                : exp2f(fminf(fmaxf(x, -120.f), hi));
      if (MASK && 8 * j + (e & 1) >= kvt) p = 0.f;
      l[e >> 1] += p;
      sc[j][e] = p;
    }
}

// scale: the factor q is multiplied by (Generic scale, Fast and Safe s2);
// hi: the Fast policy's upper clamp.
template <int DT, int POL>
__global__ void __launch_bounds__(NT, 2) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Nq, int Nk, int H, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, float scale, float hi) {
  using T = F32Tile<DT>;
  constexpr int KT = T::KT, LDK = T::LDK, LDV = T::LDV, MT = T::MT, QT = T::QT;
  constexpr int NS = KT / 8, NO = DT / 8, KG = DT / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + QT * LDK;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  const int nt = (Nk + KT - 1) / KT;
  auto issue = [&](int s) {
    float* st = ring + (s % STAGES) * T::STAGE;
    const int k0 = s * KT;
    load_tile<KT, DT, LDK>(st, kb + k0 * skn, skn, Nk - k0, D);
    load_tile<KT, DT, LDV>(st + KT * LDK, vb + k0 * svn, svn, Nk - k0, D);
  };
  issue(0);
  cp_async_commit();

  // the Q tile times the scale (one f32 product, as the plain version's);
  // zero past Nq and D
  for (int i = threadIdx.x; i < QT * (DT / 4); i += NT) {
    const int r = i / (DT / 4), c = (i % (DT / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Nq && c < D) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sqn + c);
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * LDK + c) = x;
  }

  const int wrow = warp * 16 * MT;  // the warp's first row in the tile
  const bool active = q0 + wrow < Nq;
  float mlog[MT][2], l[MT][2], o[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mlog[mt][0] = mlog[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  const float* qrow = Qs + (wrow + g) * LDK + 4 * t;
  for (int s = 0; s < nt; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s (and the Q tile) landed; every warp is done with s - 1
    if (s + 1 < nt) issue(s + 1);
    cp_async_commit();
    if (!active) continue;
    const float* Ks = ring + (s % STAGES) * T::STAGE;
    const float* Vs = Ks + KT * LDK;
    const int kvt = Nk - s * KT - 2 * t;  // this lane's valid keys of the tile, less 2 t

    // S = q' K^T: per group of 16 head-dim columns, lane (g, t) reads columns
    // 4 t .. 4 t + 3 of rows g and g + 8 of each m16 tile (Q) and of key g of
    // each 8-key group (K); k-step 0 takes columns 4 t, 4 t + 1 as k rows t,
    // t + 4, k-step 1 columns 4 t + 2, 4 t + 3. Each K fragment, split once,
    // feeds the warp's MT row tiles.
    float sc[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) {
      uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 qa = *reinterpret_cast<const float4*>(qrow + 16 * mt * LDK + 16 * kg);
        const float4 qc =
            *reinterpret_cast<const float4*>(qrow + (16 * mt + 8) * LDK + 16 * kg);
        split_u(qa.x, ah[mt][0][0], al[mt][0][0]);
        split_u(qc.x, ah[mt][0][1], al[mt][0][1]);
        split_u(qa.y, ah[mt][0][2], al[mt][0][2]);
        split_u(qc.y, ah[mt][0][3], al[mt][0][3]);
        split_u(qa.z, ah[mt][1][0], al[mt][1][0]);
        split_u(qc.z, ah[mt][1][1], al[mt][1][1]);
        split_u(qa.w, ah[mt][1][2], al[mt][1][2]);
        split_u(qc.w, ah[mt][1][3], al[mt][1][3]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kx = *reinterpret_cast<const float4*>(Ks + (8 * j + g) * LDK + 16 * kg + 4 * t);
        uint32_t bh[4], bl[4];
        split_u(kx.x, bh[0], bl[0]);
        split_u(kx.y, bh[1], bl[1]);
        split_u(kx.z, bh[2], bl[2]);
        split_u(kx.w, bh[3], bl[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma3(sc[mt][j], ah[mt][0], al[mt][0], bh[0], bh[1], bl[0], bl[1]);
          mma3(sc[mt][j], ah[mt][1], al[mt][1], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }

    // p by the policy; Generic and Safe against the running max, O and l
    // rescaled when the tile raises it
    const bool full = kvt + 2 * t >= KT;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (POL != kFast) {
        float mx[2] = {-INFINITY, -INFINITY};
        if (full)
          tile_max<false, NS>(sc[mt], kvt, mx);
        else
          tile_max<true, NS>(sc[mt], kvt, mx);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mtl = quad_max(mx[r]) * (POL == kGeneric ? kLog2e : 1.f);
          const float mnew = fmaxf(mlog[mt][r], mtl);
          const float alpha = exp2f(mlog[mt][r] - mnew);  // 0 on the first tile
          mlog[mt][r] = mnew;
          l[mt][r] *= alpha;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            o[mt][n][2 * r] *= alpha;
            o[mt][n][2 * r + 1] *= alpha;
          }
        }
      }
      if (full)
        probs<false, POL, NS>(sc[mt], mlog[mt], kvt, hi, l[mt]);
      else
        probs<true, POL, NS>(sc[mt], mlog[mt], kvt, hi, l[mt]);
    }

    // O += P V: the C tile of keys 8 kk .. 8 kk + 7 is the A fragment with
    // keys 2 t, 2 t + 1 as k rows t, t + 4; V's rows 2 t, 2 t + 1 at column
    // 8 n + g are its B fragment, split once for the MT row tiles. The tile's
    // products go into a partial from zero, added to O with round-to-nearest
    // (the tensor core truncates at its accumulator's ulp)
    float pv[MT][NO][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_u(sc[mt][kk][0], ph[mt][0], pl[mt][0]);
        split_u(sc[mt][kk][2], ph[mt][1], pl[mt][1]);
        split_u(sc[mt][kk][1], ph[mt][2], pl[mt][2]);
        split_u(sc[mt][kk][3], ph[mt][3], pl[mt][3]);
      }
      const float* vr = Vs + (8 * kk + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t vh0, vl0, vh1, vl1;
        split_u(vr[8 * n], vh0, vl0);
        split_u(vr[LDV + 8 * n], vh1, vl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(pv[mt][n], ph[mt], pl[mt], vh0, vh1, vl0, vl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] += pv[mt][n][e];
  }
  if (!active) return;

  // the row sums meet across the quad; O / l once, rows g and g + 8 of each
  // row tile, columns 8 n + 2 t and + 1 (D % 4 == 0: a pair is all in or all
  // out)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n_ = q0 + wrow + 16 * mt + g + 8 * r;
      if (n_ >= Nq) continue;
      const float li = quad_sum(l[mt][r]);
      float* orow = out + (((size_t)b * Nq + n_) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < D)
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(o[mt][n][2 * r] / li, o[mt][n][2 * r + 1] / li);
      }
    }
}

template <int DT, int POL>
int launch_f32(const float* q, const float* k, const float* v, float* out, int B, int Nq, int Nk,
               int H, int D, const long long* st, float scale, float hi, cudaStream_t stream) {
  using T = F32Tile<DT>;
  const auto kernel = attn_f32_kernel<DT, POL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Nq + T::QT - 1) / T::QT);
  kernel<<<grid, NT, T::SMEM, stream>>>(q, k, v, out, Nq, Nk, H, D, st[0], st[1], st[2], st[3],
                                        st[4], st[5], st[6], st[7], st[8], scale, hi);
  return static_cast<int>(cudaGetLastError());
}

// The head-dim tile: 16, 32, 64 or 128 (D rounded up; the zero columns add
// nothing).
template <typename F>
int by_tile(int D, F&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>());
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

}  // namespace

// q (B, Nq, H, D), k and v (B, Nk, H, D) f32 read through their (B, N, H)
// strides in elements (the last axis contiguous, every stride % 4 == 0, the
// bases 16-byte aligned); D % 4 == 0, D <= 128; scale as the plain version
// multiplies q by it -> out (B, Nq, H, D) contiguous f32.
extern "C" int mtt_attn_generic_f32(const void* q, const void* k, const void* v, void* out, int B,
                                    int Nq, int Nk, int H, int D, long long sqb, long long sqn,
                                    long long sqh, long long skb, long long skn, long long skh,
                                    long long svb, long long svn, long long svh, float scale,
                                    void* stream) {
  if (D < 4 || D % 4 || D > 128 || Nq < 1 || Nk < 1 || B < 1 || B > 65535 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  for (long long s : st)
    if (s % 4) return static_cast<int>(cudaErrorInvalidValue);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return by_tile(D, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    return launch_f32<DT, kGeneric>(qp, kp, vp, op, B, Nq, Nk, H, D, st, scale, 0.f, s);
  });
}

// The attention core of rows 1, 2 and 13 at f32: qkv (B, N, H*3*D) head-major
// f32 (16-byte aligned) -> out (B, N, H*D) f32, the head concat; 4 <= D <=
// 128, D % 4 == 0. s2 = f32(scale * log2 e); hi = 126 - ceil(log2 N), the fast
// softmax's upper clamp; safe selects the max-subtracted softmax.
extern "C" int mtt_attn_core_f32(const void* qkv, void* out, int B, int N, int H, int D, float s2,
                                 float hi, int safe, void* stream) {
  if (N < 1 || H < 1 || B < 1 || B > 65535 || D < 4 || D % 4 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ld3 = 3LL * H * D;
  // q, k and v share the packed tensor's strides: (N * 3C, 3C, 3D)
  const long long st[9] = {N * ld3, ld3, 3LL * D, N * ld3, ld3, 3LL * D, N * ld3, ld3, 3LL * D};
  auto q = static_cast<const float*>(qkv);
  auto op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return by_tile(D, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    return safe ? launch_f32<DT, kSafe>(q, q + D, q + 2 * D, op, B, N, N, H, D, st, s2, hi, s)
                : launch_f32<DT, kFast>(q, q + D, q + 2 * D, op, B, N, N, H, D, st, s2, hi, s);
  });
}
