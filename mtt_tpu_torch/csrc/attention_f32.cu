// Softmax attention core in f32, on the CUDA cores: the f32 form of
// attn_generic_kernel (attention_generic.cu) under its Generic, Fast and Safe
// softmax policies.
//   Generic, row 14: out = softmax(q k^T * scale) v over separate (B, Nq, H,
//     D) q and (B, Nk, H, D) k, v, max-subtracted.
//   Fast and Safe, rows 1-2's third launch and row 13: attention over the
//     head-major packed qkv (B, N, H*3*D), fast exp2 or exact-max softmax.
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
//   Safe:    q' as Fast, p = exp2(s - max_k s) over ALL keys
//   all:     s = q' k^T, o = (p v) / sum_k p, all in f32, nothing rounded.
// The scores, the softmax and P.V run in f32 throughout; no operand is
// rounded to bf16 or TF32.
//
// What bounds it on the H100: at a ViT-L self-attention shape (B=8, N=1029,
// H=16, D=64) it is 35 GFLOP against 136 MB of q, k, v and out, so at the
// f32 rate of 67 TFLOP/s outside the tensor cores the operations bound it
// (0.52 ms). The design is a register-tiled SGEMM twice over: a block of 256
// threads (16 x 16) owns 64 query rows of one (head, batch item), thread
// (ty, tx) the rows 4 ty .. 4 ty + 3; key tiles of 64 stream through a ring
// of two cp.async stages (K and V rows as they lie, at a padded pitch of
// DT + 4 floats, so that the 16-byte reads of a quarter-warp land on distinct
// banks). For each tile a thread forms the scores of its 4 rows against keys
// tx, tx + 16, tx + 32, tx + 48 from float4 reads of Q and K (64 FMAs per
// 8 reads), forms p in f32 by the policy, adds it to its rows' partial sums
// and writes it to a shared P tile; after a barrier it adds P . V to its 4 x
// DT / 16 outputs (columns DT / 16 tx ..), again from float4 reads. The max
// (Generic and Safe) is taken over all keys before any p is formed, in a
// first pass over the K tiles alone, as the TPU kernels hold every key
// before they subtract it; the Fast policy runs the second pass alone. At
// the end the 16 partial sums of a row meet by shuffles, O is divided by
// them once and written (16-byte stores where a thread's columns are four
// or more). Nothing is atomic: two runs
// give the same bits.
#include <type_traits>

#include "common.cuh"

using namespace mtt;

namespace {

constexpr int QT = 64;      // query rows of a block
constexpr int KT = 64;      // keys of a tile
constexpr int NT = 256;     // threads: 16 x 16
constexpr int STAGES = 2;   // ring buffers of K and V
constexpr int PLD = KT + 4; // row pitch of the P tile

enum Policy { kGeneric, kFast, kSafe };

template <int DT>
struct F32Tile {
  static constexpr int LD = DT + 4;  // row pitch of the Q, K and V tiles
  static constexpr int DC = DT / 16; // output columns of a thread
  static constexpr int STAGE = 2 * KT * LD;
  static constexpr int SMEM = (QT * LD + STAGES * STAGE + QT * PLD) * 4;
};

// Copies the rows of one tile (ROWS x DT floats of a row-major matrix with
// row stride ldg) into shared memory at pitch LD with cp.async, zero-filling
// rows at or past row_limit and columns at or past D (D % 4 == 0).
template <int ROWS, int DT>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long ldg, int row_limit,
                                          int D) {
  constexpr int LD = DT + 4, CH = DT / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r < row_limit && c < D;
    cp_async16(s + r * LD + c, ok ? g + r * ldg + c : g, ok);
  }
}

// The scores of the thread's 4 query rows against keys tx + 16 j of the tile
// Kt (64 keys): s[i][j] = sum_d Qs[4 ty + i][d] Kt[tx + 16 j][d].
template <int DT>
__device__ __forceinline__ void scores(const float* Qs, const float* Kt, int ty, int tx,
                                       float (&s)[4][4]) {
  constexpr int LD = DT + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DT; d += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
      }
  }
}

// The max over the 16 lanes of one row group (lanes of equal ty: a half-warp).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// scale: the factor q is multiplied by (Generic scale, Fast and Safe s2);
// hi: the Fast policy's upper clamp.
template <int DT, int POL>
__global__ void __launch_bounds__(NT) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Nq, int Nk, int H, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, float scale, float hi) {
  using T = F32Tile<DT>;
  constexpr int LD = T::LD, DC = T::DC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + QT * LD;
  float* Ps = ring + STAGES * T::STAGE;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * QT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  // ring steps: n1 pass-1 tiles (K only; none for the Fast policy, which
  // takes no max), then n2 pass-2 tiles (K and V), 64 keys each
  const int n2 = (Nk + KT - 1) / KT, n1 = POL == kFast ? 0 : n2;
  const int nsteps = n1 + n2;
  auto issue = [&](int s) {
    float* st = ring + (s % STAGES) * T::STAGE;
    const int k0 = (s < n1 ? s : s - n1) * KT;
    load_tile<KT, DT>(st, kb + k0 * skn, skn, Nk - k0, D);
    if (s >= n1) load_tile<KT, DT>(st + KT * LD, vb + k0 * svn, svn, Nk - k0, D);
  };
  issue(0);
  cp_async_commit();

  // the Q tile times the scale (one f32 product, as the plain version's);
  // zero past Nq and D
  for (int i = tid; i < QT * (DT / 4); i += NT) {
    const int r = i / (DT / 4), c = (i % (DT / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Nq && c < D) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sqn + c);
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * LD + c) = x;
  }

  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s landed; every thread is done with step s - 1
    if (s + 1 < nsteps) issue(s + 1);
    cp_async_commit();
    const float* st = ring + (s % STAGES) * T::STAGE;
    const int k0 = (s < n1 ? s : s - n1) * KT;
    float sc[4][4];
    scores<DT>(Qs, st, ty, tx, sc);
    if (POL != kFast && s < n1) {
      // pass 1: the running max of the thread's scores over valid keys
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < Nk)
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], sc[i][j]);
      if (s == n1 - 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = group_max(m[i]);
      continue;
    }
    // pass 2: p in f32 by the policy, l += p, P to shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx + 16 * j < Nk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sc[i][j];
        float p = POL == kGeneric ? expf(x - m[i])
                  : POL == kSafe  ? exp2f(x - m[i])
                                  : exp2f(fminf(fmaxf(x, -120.f), hi));
        if (!valid) p = 0.f;
        l[i] += p;
        Ps[(4 * ty + i) * PLD + tx + 16 * j] = p;
      }
    }
    __syncthreads();  // the P tile is whole
    // O += P V: rows 4 ty .. + 3, columns DC tx .. + DC - 1
    const float* Vt = st + KT * LD + DC * tx;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * PLD + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[DC];
        const float* vr = Vt + (kk + e) * LD;
        if constexpr (DC % 4 == 0) {
#pragma unroll
          for (int c = 0; c < DC; c += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vr + c);
            vv[c] = t.x, vv[c + 1] = t.y, vv[c + 2] = t.z, vv[c + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = vr[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pe, vv[c], o[i][c]);
        }
      }
    }
  }

  // the row sums meet across the 16 lanes of the row group; O / l once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = group_sum(l[i]);
    const int n = q0 + 4 * ty + i;
    if (n >= Nq) continue;
    float* orow = out + (((size_t)b * Nq + n) * H + h) * D + DC * tx;
    if constexpr (DC % 4 == 0) {
      if (DC * tx + DC <= D) {
#pragma unroll
        for (int c = 0; c < DC; c += 4)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(o[i][c] / li, o[i][c + 1] / li, o[i][c + 2] / li, o[i][c + 3] / li);
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (DC * tx + c < D) orow[c] = o[i][c] / li;
  }
}

template <int DT, int POL>
int launch_f32(const float* q, const float* k, const float* v, float* out, int B, int Nq, int Nk,
               int H, int D, const long long* st, float scale, float hi, cudaStream_t stream) {
  using T = F32Tile<DT>;
  const auto kernel = attn_f32_kernel<DT, POL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Nq + QT - 1) / QT);
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
// softmax's upper clamp; safe selects the exact-max softmax.
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
