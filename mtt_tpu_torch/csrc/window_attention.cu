// Swin window attention with a per-head bias and a per-window mask, bf16
// q/k/v, head dim 32.
//
// Replaces mtt_tpu/kernels/attention.py:_wattn_kernel (pallas_call at :820),
// per (window, head):
//   logits = scale * q k^T + bias[head] + mask[window % nW]        (f32)
//   p      = exp(logits - rowmax)                                  (f32)
//   out    = (bf16(p) v) / rowsum(p)                               (f32 acc)
// The softmax is the max-subtracted exp one: masked entries are -100 and must
// lose all probability.
//
// What bounds it on the H100: bytes. Swin-B on a 768x1536 input has 512, 128,
// 32 and 8 windows of 147 tokens (144 patches + 3 prompts) with 4, 8, 16 and
// 32 heads: 2048 (window, head) pairs at stage 0 and half as many at each
// later stage; q, k, v and out are 19 MB each at stage 0 against 6 GFLOP of
// tensor-core work. The TPU wrapper transposes q, k, v to head-major and the
// result back, four more copies of as many bytes. This kernel reads q, k and
// v where they lie, as strided (window, token, head, 32) views of the
// block's packed qkv projection, and writes (window, token, head * 32),
// which is what the output projection takes: no transpose is launched.
//
// Design: one block per (window, head), the window fastest in the grid, so
// that the blocks in flight share one head's bias in L2 (every block re-reads
// 86 KB of bias and as much mask, more than all the device-memory traffic).
// M = 147 is padded to 160 inside the kernel: the padded keys are zero rows
// of K and V and get no probability, the padded query rows are never stored.
// A whole window's K and V (12.8 KB each) sit in shared memory; each of the 5
// warps takes 16 query rows at a time: scores with wmma into its own f32
// strip, then one row at a time by the whole warp, the row's logits (scale,
// bias, mask) held in registers between the max and the exp, the bf16
// probabilities into the warp's own strip, p.v with wmma, division by the
// row sum in the epilogue. Whole score rows fit on chip, so no online
// softmax. On the card the scalar softmax passes, not memory, take most of
// the time: with every global access cut out the kernel still took two
// thirds of its time. The exponential stays the accurate expf: the
// hardware's ex2 (__expf) was no faster beyond the spread between runs and
// passed the 2-ulp check, but the Swin-B depth map moved from 0.011 to 0.032
// relative RMS away from an f32 run of the same weights.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int WD = 32;        // head dim
constexpr int WWARPS = 5;
constexpr int WT = WWARPS * 32;
constexpr int WKLD = WD + 8;  // row stride of K, V and the staged Q tile

// Row stride of a warp's score and probability strips: at least WKLD, because
// the probability strip first stages the 16 x 32 q tile.
__host__ __device__ constexpr int wattn_ld(int MP) { return MP + 8 > WKLD ? MP + 8 : WKLD; }

__host__ __device__ constexpr int wattn_smem(int MP) {
  return 2 * MP * WKLD * 2 + WWARPS * 16 * wattn_ld(MP) * (4 + 2);
}

// NJ: score columns a lane holds, ceil(MP / 32).
template <bool HAS_MASK, int NJ>
__global__ void __launch_bounds__(WT, 2) wattn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ out, int M,
    int MP, int H, int nW, long long sb, long long sm, long long sh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int SLD = wattn_ld(MP), PLD = SLD;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + MP * WKLD;
  float* Sall = reinterpret_cast<float*>(Vs + MP * WKLD);
  bf16* Pall = reinterpret_cast<bf16*>(Sall + WWARPS * 16 * SLD);

  const int bw = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bw * sb + (size_t)h * sh;

  // the window's K and V; rows past M are zero
  for (int i = threadIdx.x; i < MP * (WD / 8); i += WT) {
    const int r = i / (WD / 8), c = (i % (WD / 8)) * 8;
    const bool ok = r < M;
    cp_async16(Ks + r * WKLD + c, ok ? k + base + (size_t)r * sm + c : k, ok);
    cp_async16(Vs + r * WKLD + c, ok ? v + base + (size_t)r * sm + c : v, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float* Sw = Sall + warp * 16 * SLD;
  bf16* Pw = Pall + warp * 16 * PLD;
  const float* brow0 = bias + (size_t)h * M * M;
  const float* mrow0 = HAS_MASK ? mask + (size_t)(bw % nW) * M * M : nullptr;
  const int KT = MP / 16;

  for (int rt = warp; rt < KT; rt += WWARPS) {
    const int r0 = rt * 16;
    // this tile's 16 q rows through the probability strip; rows past M zero
    for (int i = lane; i < 16 * (WD / 8); i += 32) {
      const int r = i / (WD / 8), c = (i % (WD / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < M) val = *reinterpret_cast<const uint4*>(q + base + (size_t)(r0 + r) * sm + c);
      *reinterpret_cast<uint4*>(Pw + r * WKLD + c) = val;
    }
    __syncwarp();
    FragA qa0, qa1;
    wmma::load_matrix_sync(qa0, Pw, WKLD);
    wmma::load_matrix_sync(qa1, Pw + 16, WKLD);
    __syncwarp();

    // raw scores of the 16 rows against every key
    for (int kt = 0; kt < KT; ++kt) {
      FragBt b0, b1;
      FragC s;
      wmma::fill_fragment(s, 0.f);
      wmma::load_matrix_sync(b0, Ks + kt * 16 * WKLD, WKLD);
      wmma::load_matrix_sync(b1, Ks + kt * 16 * WKLD + 16, WKLD);
      wmma::mma_sync(s, qa0, b0, s);
      wmma::mma_sync(s, qa1, b1, s);
      wmma::store_matrix_sync(Sw + kt * 16, s, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // bias, mask and softmax, one row at a time by the whole warp; lane r
    // keeps row r's sum for the epilogue
    float mysum = 1.f;
    for (int r = 0; r < 16; ++r) {
      const float* sr = Sw + r * SLD;
      bf16* pr = Pw + r * PLD;
      const int gr = r0 + r;
      if (gr >= M) {   // the same for every lane of the warp
        for (int c = lane; c < MP; c += 32) pr[c] = __float2bfloat16(0.f);
        continue;
      }
      const float* br = brow0 + (size_t)gr * M;
      const float* mr = HAS_MASK ? mrow0 + (size_t)gr * M : nullptr;
      float lv[NJ];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        lv[j] = -INFINITY;   // the padded keys: exp gives them 0
        if (c < M) {
          float l = sr[c] * scale + br[c];
          if (HAS_MASK) l += mr[c];
          lv[j] = l;
          mx = fmaxf(mx, l);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < MP) {
          const float e = expf(lv[j] - mx);
          sum += e;
          pr[c] = __float2bfloat16(e);
        }
      }
      sum = warp_sum(sum);
      if (lane == r) mysum = sum;
    }
    __syncwarp();

    // out = P V for the two 16-column halves of the head dim
    FragC o0, o1;
    wmma::fill_fragment(o0, 0.f);
    wmma::fill_fragment(o1, 0.f);
    for (int kk = 0; kk < MP; kk += 16) {
      FragA pa;
      FragB v0, v1;
      wmma::load_matrix_sync(pa, Pw + kk, PLD);
      wmma::load_matrix_sync(v0, Vs + kk * WKLD, WKLD);
      wmma::load_matrix_sync(v1, Vs + kk * WKLD + 16, WKLD);
      wmma::mma_sync(o0, pa, v0, o0);
      wmma::mma_sync(o1, pa, v1, o1);
    }
    __syncwarp();
    const float rs = __shfl_sync(0xffffffffu, mysum, lane >> 1);
    const int gr = r0 + (lane >> 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float vals[8];
      frag_row8(i == 0 ? o0 : o1, Sw, lane, vals);   // the scores are no longer needed
      if (gr < M) {
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = vals[j] / rs;
        *reinterpret_cast<uint4*>(out + ((size_t)bw * M + gr) * H * WD + h * WD + i * 16 +
                                  (lane & 1) * 8) = pack8(vals);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// q, k, v: (BW, M, H, 32) bf16 views that share their strides in elements: sb
// between windows, sm between tokens, sh between heads, 1 along the head dim;
// every row 16-byte aligned. bias (H, M, M) f32; mask (nW, M, M) f32 or null.
// -> out (BW, M, H * 32) bf16, contiguous.
extern "C" int mtt_window_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* mask, void* out, int BW,
                                         int M, int H, int nW, long long sb, long long sm,
                                         long long sh, float scale, void* stream) {
  if (BW < 1 || M < 1 || H < 1 || H > 65535 || (mask && (nW < 1 || BW % nW)) || sb % 8 ||
      sm % 8 || sh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MP = (M + 15) / 16 * 16;
  const int smem = wattn_smem(MP);
  if (smem > 232448 || MP > 352) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid(BW, H);
  auto launch = [&](auto kernel) {
    // set on every launch: the attribute belongs to the current device's context
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, WT, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<const float*>(bias),
                                   static_cast<const float*>(mask), static_cast<bf16*>(out), M, MP,
                                   H, nW, sb, sm, sh, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if (MP <= 160) return mask ? launch(wattn_kernel<true, 5>) : launch(wattn_kernel<false, 5>);
  return mask ? launch(wattn_kernel<true, 11>) : launch(wattn_kernel<false, 11>);
}
