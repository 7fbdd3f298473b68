// Swin window attention with a per-head bias and a per-window mask, bf16
// q/k/v, head dim 32: the single-pass kernel of windows of up to 160 tokens.
//
// Replaces mtt_tpu/kernels/attention.py:_wattn_kernel (pallas_call at :820),
// per (window, head):
//   logits = scale * q k^T + bias[head] + mask[window % nW]        (f32)
//   p      = exp(logits - max over all keys)                        (f32)
//   out    = (bf16(p) v) / rowsum(p)                               (f32 acc)
// The softmax is the max-subtracted exp one: masked entries are -100 and must
// lose all probability. Rounding points as kernels/window_attention.py:
// window_attention_plain: the logits rounded after the product, the scale,
// the bias and the mask in that order; p = exp2(l log2(e) - max log2(e)), one
// fma and the accurate exp2f (not the hardware's approximate exp: the ex2
// form of __expf once moved a Swin-B map from 0.011 to 0.032 relative RMS
// away from f32).
//
// What bounds it on the H100: bytes. Swin-B on a 768x1536 input has 512, 128,
// 32 and 8 windows of 147 tokens (144 patches + 3 prompts) with 4, 8, 16 and
// 32 heads; q, k, v and out are 19 MB each at stage 0 against 6 GFLOP of
// tensor-core work. q, k and v are read where they lie, as strided (window,
// token, head, 32) views of the block's packed qkv projection, and the output
// is written as (window, token, head * 32), which the output projection
// takes: no transpose is launched.
//
// Design: one block of five warps per (window, head), the window fastest in
// the grid. The window's Q, K and V (147 rows, padded to 160 with zeros) land
// in shared memory by cp.async, once. Each warp then takes m16 tiles of query
// rows (two of Swin-B's ten) and keeps everything of a tile in registers, on
// common.cuh's mma.sync fragment layer: the scores of all 160 keys (20 n8
// tiles, 80 f32 a thread), the logit scale, bias and mask added in f32, the
// exact row max over all keys by quad shuffles, p = exp(l - max), the
// unrounded row sum, P repacked to bf16 A fragments for P.V (V by
// ldmatrix.trans), and the division by the sum once at the end. One pass
// over the keys: a whole window's scores fit in registers, so no second
// pass recomputes them and no running max rescales P. Bias and mask are f32
// rows of M (odd at 147: no 8-byte loads in the fragments' pattern, whose
// loads would each touch eight rows' lines); each warp copies its tile's rows
// into shared memory with consecutive lanes on consecutive keys (4-byte
// cp.async, half the keys at a time) and reads them back in float2s. Every
// block of a head reads the same bias rows and every block of a window the
// same mask rows (4 MB in all at stage 2, held in L2). The old kernel (wmma
// scores through a shared-memory strip, then scalar softmax passes a row at
// a time) took two thirds of its time in those passes.
// Longer windows take the streamed two-pass form, the Window policy of
// attention_generic.cu.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int WD = 32;          // head dim
constexpr int WWARPS = 5;
constexpr int WTH = WWARPS * 32;
constexpr int WMAX = 160;       // tokens the register-resident scores hold
constexpr int WLD = WD + 8;     // row pitch of the Q, K and V tiles (bf16)
constexpr int WN8 = WMAX / 8;   // key n8 tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr int KH = WMAX / 2;    // keys of a staged half of the bias and mask rows
constexpr int BLD = KH + 8;     // its row pitch (f32): float2 reads of a fragment's rows
                                // fall two words a bank
// Q, K and V, then per warp the staged bias and mask rows of a tile's half
constexpr int WSMEM = 3 * WMAX * WLD * 2 + WWARPS * 2 * 16 * BLD * 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__global__ void __launch_bounds__(WTH, 2) wattn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ out, int M,
    int H, int nW, long long sb, long long sm, long long sh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + WMAX * WLD;
  bf16* Vs = Ks + WMAX * WLD;
  const int bw = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bw * sb + (size_t)h * sh;
  const int MP = (M + 15) / 16 * 16, nk16 = MP / 16;

  // the window's Q, K and V; rows past M are zero
  for (int i = threadIdx.x; i < MP * (WD / 8); i += WTH) {
    const int r = i / (WD / 8), c = (i % (WD / 8)) * 8;
    const bool ok = r < M;
    const size_t off = base + (size_t)r * sm + c;
    cp_async16(Qs + r * WLD + c, ok ? q + off : q, ok);
    cp_async16(Ks + r * WLD + c, ok ? k + off : k, ok);
    cp_async16(Vs + r * WLD + c, ok ? v + off : v, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* brow = bias + (size_t)h * M * M;
  const float* mrow = mask ? mask + (size_t)(bw % nW) * M * M : nullptr;
  float* Bw = reinterpret_cast<float*>(Vs + WMAX * WLD) + warp * 2 * 16 * BLD;
  float* Mw = Bw + 16 * BLD;

  for (int mt = warp; mt < nk16; mt += WWARPS) {
    const int r0 = mt * 16;
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], Qs + r0 * WLD + kk * 16 + ldsm_a_off(lane, WLD));

    // scores of the 16 rows against every key: 20 n8 tiles
    float sc[WN8][4];
#pragma unroll
    for (int j = 0; j < WN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < WN8 / 2; ++jj) {
      if (jj >= nk16) break;  // uniform: the keys end with the window
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, Ks + jj * 16 * WLD + kk * 16 + ldsm_bt_off(lane, WLD));
        mma_16816(sc[2 * jj], qa[kk], b[0], b[1]);
        mma_16816(sc[2 * jj + 1], qa[kk], b[2], b[3]);
      }
    }

    // logits in f32 and the row max. The tile's bias and mask rows (rows
    // past M read row M - 1 and are never stored) come in two halves of 80
    // keys through the warp's staging rows, copied with consecutive lanes on
    // consecutive keys; keys past M get a bias of -inf, so that they take no
    // part in the max and get p = 0 with no test in the loops below.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k0 = hf * KH;
      if (k0 >= M) break;  // uniform
      __syncwarp();        // the previous half's rows are read
      for (int r = 0; r < 16; ++r) {
        const float* bsrc = brow + (size_t)min(r0 + r, M - 1) * M + k0;
        const float* msrc = mrow ? mrow + (bsrc - brow) : nullptr;
#pragma unroll
        for (int cc = 0; cc < KH; cc += 32) {
          const int c = cc + lane;
          if (c >= KH) break;
          if (k0 + c < M) {
            cp_async4(Bw + r * BLD + c, bsrc + c, true);
            if (mrow) cp_async4(Mw + r * BLD + c, msrc + c, true);
          } else {
            Bw[r * BLD + c] = -INFINITY;
            Mw[r * BLD + c] = 0.f;
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll
      for (int jh = 0; jh < WN8 / 2; ++jh) {
        const int j = hf * (WN8 / 2) + jh;
        if (j >= 2 * nk16) break;
        const int col = jh * 8 + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(Bw + g * BLD + col);
        const float2 b1 = *reinterpret_cast<const float2*>(Bw + (g + 8) * BLD + col);
        float l[4] = {__fadd_rn(__fmul_rn(sc[j][0], scale), b0.x),
                      __fadd_rn(__fmul_rn(sc[j][1], scale), b0.y),
                      __fadd_rn(__fmul_rn(sc[j][2], scale), b1.x),
                      __fadd_rn(__fmul_rn(sc[j][3], scale), b1.y)};
        if (mrow) {
          const float2 m0 = *reinterpret_cast<const float2*>(Mw + g * BLD + col);
          const float2 m1 = *reinterpret_cast<const float2*>(Mw + (g + 8) * BLD + col);
          l[0] = __fadd_rn(l[0], m0.x);
          l[1] = __fadd_rn(l[1], m0.y);
          l[2] = __fadd_rn(l[2], m1.x);
          l[3] = __fadd_rn(l[3], m1.y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = l[e];
        mx0 = fmaxf(mx0, fmaxf(l[0], l[1]));
        mx1 = fmaxf(mx1, fmaxf(l[2], l[3]));
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);

    // p = exp(l - max) in f32 as exp2 of one fma, unrounded into the row
    // sums; keys past M (l = -inf) get 0
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < WN8; ++j) {
      if (j >= 2 * nk16) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p0 = exp2f(fmaf(sc[j][c], kLog2e, -ml0));
        const float p1 = exp2f(fmaf(sc[j][2 + c], kLog2e, -ml1));
        s0 += p0;
        s1 += p1;
        sc[j][c] = p0;
        sc[j][2 + c] = p1;
      }
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);

    // O = bf16(P) V over the window's keys, 16 at a time
    float o[WD / 8][4];
#pragma unroll
    for (int j = 0; j < WD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WN8 / 2; ++kk) {
      if (kk >= nk16) break;
      uint32_t pa[4];
      c_to_a(sc[2 * kk], sc[2 * kk + 1], pa);
#pragma unroll
      for (int jj = 0; jj < WD / 16; ++jj) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vs + kk * 16 * WLD + jj * 16 + ldsm_b_off(lane, WLD));
        mma_16816(o[2 * jj], pa, bv[0], bv[1]);
        mma_16816(o[2 * jj + 1], pa, bv[2], bv[3]);
      }
    }

    // divide by the row sum after P V, round once; the rows leave through
    // the warp's own rows of the Q tile in 16-byte stores
    bf16* rows = Qs + r0 * WLD;
#pragma unroll
    for (int j = 0; j < WD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(rows + g * WLD + col) = pack_bf16x2(o[j][0] / s0, o[j][1] / s0);
      *reinterpret_cast<uint32_t*>(rows + (g + 8) * WLD + col) =
          pack_bf16x2(o[j][2] / s1, o[j][3] / s1);
    }
    __syncwarp();
    for (int i = lane; i < 16 * (WD / 8); i += 32) {
      const int r = i / (WD / 8), c = (i % (WD / 8)) * 8;
      if (r0 + r < M)
        *reinterpret_cast<uint4*>(out + ((size_t)bw * M + r0 + r) * H * WD + h * WD + c) =
            *reinterpret_cast<const uint4*>(rows + r * WLD + c);
    }
  }
}

}  // namespace

// The streamed two-pass form for windows of more than 160 tokens
// (attention_generic.cu, the Window policy); the same arguments.
extern "C" int mtt_window_attention_streamed_bf16(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* mask, void* out,
                                                  int BW, int M, int H, int nW, long long sb,
                                                  long long sm, long long sh, float scale,
                                                  void* stream);

// q, k, v: (BW, M, H, 32) bf16 views that share their strides in elements: sb
// between windows, sm between tokens, sh between heads, 1 along the head dim;
// every stride % 8 == 0, the bases 16-byte aligned. bias (H, M, M) f32; mask
// (nW, M, M) f32 or null, window w taking mask w % nW. -> out (BW, M, H * 32)
// bf16, contiguous. scale multiplies the f32 logits.
extern "C" int mtt_window_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* mask, void* out, int BW,
                                         int M, int H, int nW, long long sb, long long sm,
                                         long long sh, float scale, void* stream) {
  if (BW < 1 || M < 1 || H < 1 || H > 65535 || (mask && (nW < 1 || BW % nW)) || sb % 8 ||
      sm % 8 || sh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > WMAX)
    return mtt_window_attention_streamed_bf16(q, k, v, bias, mask, out, BW, M, H, nW, sb, sm, sh,
                                              scale, stream);
  // set on every launch: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(wattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(BW, H);
  wattn_kernel<<<grid, WTH, WSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(out), M,
      H, mask ? nW : 1, sb, sm, sh, scale);
  return static_cast<int>(cudaGetLastError());
}
