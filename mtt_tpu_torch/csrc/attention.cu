// Pre-norm attention front half: qkv = LN(x) @ W^T + b (head-major columns),
// then softmax(q k^T * scale) v per head, written as the head concat.
//
// Replaces mtt_tpu/kernels/attention.py:_attn_ln_qkv_cached_kernel (the 20
// non-tap ViT-L blocks) and the emit variant _attn_ln_qkv_kernel(ln=False,
// emit=True) (the 4 tap blocks). The split into hand-written launches is:
//   1. LN rows (layernorm.cu; the emit path keeps LN(x) as an output),
//   2. gemm_nt_bias_kernel: the qkv projection, bias added in f32, one bf16
//      rounding, head-major (H, 3, D) columns as the weight rows hold them,
//   3. attn_core_kernel: one block per (query tile, head, batch item) that
//      streams K/V tiles through shared memory; scores and probabilities live
//      only in shared memory and registers, never in device memory.
//
// What bounds it on the H100: at ViT-L shapes (B=8, N=1029, C=1024, H=16,
// D=64) the projection is 52 GFLOP and the attention 35 GFLOP per block, so
// both are tensor-core work; the design keeps every product on the bf16 tensor
// cores (wmma 16x16x16, f32 accumulation) and keeps the (N, N) score matrix out
// of device memory, which bounds the traffic to reading qkv once per query
// tile. The fast softmax subtracts no max (attention.py:89-115): probabilities
// are exp2 of the clamped logits, summed directly and divided at the end, so the
// loop needs no online rescale. The safe softmax keeps an online row max and
// rescales the running output, as training will need.
#include "common.cuh"

using namespace mtt;

namespace {

// ---- qkv projection: Y = bf16(X @ W^T + bias) -------------------------------
constexpr int GBM = 128, GBN = 128, GBK = 32, GLD = GBK + 8, GT = 256;

__global__ void __launch_bounds__(GT) gemm_nt_bias_kernel(const bf16* __restrict__ X,
                                                          const bf16* __restrict__ W,
                                                          const float* __restrict__ bias,
                                                          bf16* __restrict__ Y, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][GBM * GLD];
  __shared__ __align__(128) bf16 Bs[2][GBN * GLD];
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, each 64 x 32 outputs
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const bf16* Xb = X + (size_t)m0 * K;
  const bf16* Wb = W + (size_t)n0 * K;
  const int KT = K / GBK;
  load_tile_async<GBM, GBK, GT>(As[0], GLD, Xb, K, M - m0);
  load_tile_async<GBN, GBK, GT>(Bs[0], GLD, Wb, K, N - n0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_tile_async<GBM, GBK, GT>(As[st ^ 1], GLD, Xb + (kt + 1) * GBK, K, M - m0);
      load_tile_async<GBN, GBK, GT>(Bs[st ^ 1], GLD, Wb + (kt + 1) * GBK, K, N - n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      FragA a[4];
      FragBt b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], As[st] + (wm * 64 + i * 16) * GLD + kk, GLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs[st] + (wn * 32 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: the staging buffers are free now; each warp spills one fragment
  // at a time to its own 256 floats, adds the f32 bias, rounds once
  float* scratch = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[8];
      frag_row8(acc[i][j], scratch, lane, v);
      const int row = m0 + wm * 64 + i * 16 + (lane >> 1);
      const int col = n0 + wn * 32 + j * 16 + (lane & 1) * 8;
      if (row < M) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += bias[col + k];
        *reinterpret_cast<uint4*>(Y + (size_t)row * N + col) = pack8(v);
      }
    }
}

// ---- attention core over head-major qkv -------------------------------------
constexpr int AD = 64;        // head dim
constexpr int AQ = 64;        // query rows per block (16 per warp)
constexpr int AK = 64;        // keys per streamed tile
constexpr int ALD = AD + 8;   // bf16 leading dim of the Q/K/V/P tiles
constexpr int ASL = AK + 4;   // f32 leading dim of the score tile
constexpr int AT = 128;
constexpr int kAttnSmem = 4 * AQ * ALD * 2 + AQ * ASL * 4;

template <bool SAFE>
__global__ void __launch_bounds__(AT) attn_core_kernel(const bf16* __restrict__ qkv,
                                                       bf16* __restrict__ out, int N, int H, float s2,
                                                       float hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AQ * ALD;
  bf16* Vs = Ks + AK * ALD;
  bf16* Ps = Vs + AK * ALD;
  float* Ss = reinterpret_cast<float*>(Ps + AQ * ALD);

  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * AD;
  const size_t ld3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld3 + h * 3 * AD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Q tile scaled by s2 = bf16(scale * log2 e): one bf16 rounding, as q * s2
  // is taken in the activation dtype (attention.py:404-410)
  for (int i = threadIdx.x; i < AQ * (AD / 8); i += AT) {
    const int r = i / (AD / 8), c = (i % (AD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < N) raw = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld3 + c);
    float f[8];
    unpack8(raw, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] *= s2;
    *reinterpret_cast<uint4*>(Qs + r * ALD + c) = pack8(f);
  }

  FragC o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(o[j], 0.f);
  // lane owns row (lane >> 1) of its warp's 16 rows, columns ch .. ch + 31
  const int r = lane >> 1, ch = (lane & 1) * 32;
  float m_run = -INFINITY, l_run = 0.f;
  float* Sw = Ss + warp * 16 * ASL;
  bf16* Pw = Ps + warp * 16 * ALD;

  for (int k0 = 0; k0 < N; k0 += AK) {
    const int kv = min(AK, N - k0);
    load_tile_async<AK, AD, AT>(Ks, ALD, base + (size_t)k0 * ld3 + AD, ld3, kv);
    load_tile_async<AK, AD, AT>(Vs, ALD, base + (size_t)k0 * ld3 + 2 * AD, ld3, kv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < AD / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * ALD + kk * 16, ALD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBt bt;
        wmma::load_matrix_sync(bt, Ks + j * 16 * ALD + kk * 16, ALD);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], ASL, wmma::mem_row_major);
    __syncwarp();

    const float* srow = Sw + r * ASL + ch;
    bf16* prow = Pw + r * ALD + ch;
    float psum = 0.f;
    if (!SAFE) {
      // exp2 of logits clamped to [-120, 126 - ceil(log2 N)] (attention.py:113-115)
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = (ch + c < kv) ? exp2f(fminf(fmaxf(srow[c], -120.f), hi)) : 0.f;
        psum += p;
        prow[c] = __float2bfloat16(p);
      }
      l_run += psum;
    } else {
      float mx = -INFINITY;
      for (int c = 0; c < 32; ++c)
        if (ch + c < kv) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = (ch + c < kv) ? exp2f(srow[c] - m_new) : 0.f;
        psum += p;
        prow[c] = __float2bfloat16(p);
      }
      l_run = l_run * alpha + psum;
      m_run = m_new;
      // rescale the running output rows by alpha through the warp's score rows
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, o[j], ASL, wmma::mem_row_major);
      __syncwarp();
      for (int c = 0; c < 32; ++c) Sw[r * ASL + ch + c] *= alpha;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(o[j], Sw + j * 16, ASL, wmma::mem_row_major);
    }
    __syncwarp();

    // O += P V with P rounded to bf16 (attention.py:416-418)
#pragma unroll
    for (int kk = 0; kk < AK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, Pw + kk * 16, ALD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bv;
        wmma::load_matrix_sync(bv, Vs + kk * 16 * ALD + j * 16, ALD);
        wmma::mma_sync(o[j], a, bv, o[j]);
      }
    }
    __syncthreads();
  }

  // divide by the row sum after P V, round once
  const float tot = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, o[j], ASL, wmma::mem_row_major);
  __syncwarp();
  const int n = q0 + warp * 16 + r;
  if (n < N) {
    bf16* dst = out + ((size_t)b * N + n) * C + h * AD + ch;
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = Sw[r * ASL + ch + c8 * 8 + k] / tot;
      *reinterpret_cast<uint4*>(dst + c8 * 8) = pack8(f);
    }
  }
}

template <bool SAFE>
int launch_attn_core(const bf16* qkv, bf16* out, int B, int N, int H, float s2, float hi,
                     cudaStream_t st) {
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<SAFE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + AQ - 1) / AQ, H, B);
  attn_core_kernel<SAFE><<<grid, AT, kAttnSmem, st>>>(qkv, out, N, H, s2, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xn (M, K) bf16, w (N, K) bf16, bias (N,) f32 -> qkv (M, N) bf16.
// K % 32 == 0 and N % 128 == 0; M is masked.
extern "C" int mtt_qkv_proj_bf16(const void* xn, const void* w, const void* bias, void* qkv, int M,
                                 int N, int K, void* stream) {
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_nt_bias_kernel<<<grid, GT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(qkv), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// qkv (B, N, H*3*64) head-major bf16 -> out (B, N, H*64) bf16.
extern "C" int mtt_attn_core_bf16(const void* qkv, void* out, int B, int N, int H, float s2, float hi,
                                  int safe, void* stream) {
  auto q = static_cast<const bf16*>(qkv);
  auto o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return safe ? launch_attn_core<true>(q, o, B, N, H, s2, hi, st)
              : launch_attn_core<false>(q, o, B, N, H, s2, hi, st);
}
