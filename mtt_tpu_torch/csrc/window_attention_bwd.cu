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
// 14 GFLOP, 0.014 ms on the tensor cores.
//
// Design: one block per (chunk of windows, head), five warps, one block an
// SM. A window's Q, K, V and G tiles sit in shared memory, read where they
// lie (strided views of the packed projection, as the forward reads them;
// rows past M zero: 147 tokens are padded to 160 here). Phase 1, a 16-row
// query strip per warp: the scores with wmma into the warp's f32 strip, the
// softmax a row at a time into pn (f32, in the strip) and bf16(pn) (the
// block's P matrix); dp = g v^T a 16x16 tile at a time, twice (row sums, then
// dl), so no second f32 strip is needed; bf16(dl) into the block's dL
// matrix, dq = dL k. Phase 2, after a barrier, a 16-row key tile per warp:
// dk = dL^T q and dv = P^T g from the two matrices read column-major.
//
// dbias is the hard part: the TPU sums dl over the windows on a sequential
// grid axis. Blocks here run in no order, so each block walks its chunk of
// windows in order and adds dl into its own f32 partial (the lane that owns
// an entry always owns it), and a second kernel sums the partials over the
// chunks in a fixed order. Two runs give equal bits; atomics would not. The
// chunk (bwd_window_chunks in kernels/window_attention.py) keeps about two
// waves of blocks: 22 MB of partials at stage 0 instead of 177 MB.
#include "common.cuh"

using namespace mtt;

namespace {

constexpr int BD = 32;        // head dim
constexpr int BWARPS = 5;
constexpr int BT = BWARPS * 32;
constexpr int BKLD = BD + 8;  // row stride of the Q, K, V and G tiles
constexpr int BNJ = 5;        // score columns a lane holds: MP <= 160

// A operand read transposed from a row-major matrix in shared memory
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

// row stride of the P and dL matrices and of the warps' f32 strips
__host__ __device__ constexpr int wbwd_ld(int MP) { return MP + 8; }

__host__ __device__ constexpr int wbwd_smem(int MP) {
  return 4 * MP * BKLD * 2 + 2 * MP * wbwd_ld(MP) * 2 + BWARPS * 16 * wbwd_ld(MP) * 4 +
         BWARPS * 256 * 4;
}

template <bool HAS_MASK>
__global__ void __launch_bounds__(BT, 1) wattn_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ dqkv, float* __restrict__ work, int BW, int M, int MP, int H, int nW,
    long long sb, long long sm, long long sh, long long gb, long long gm, long long gh, int wpc,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = wbwd_ld(MP);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + MP * BKLD;
  bf16* Vs = Ks + MP * BKLD;
  bf16* Gs = Vs + MP * BKLD;
  bf16* Ps = Gs + MP * BKLD;  // bf16(pn), MP x LD
  bf16* Ls = Ps + MP * LD;    // bf16(dl), MP x LD
  float* Sall = reinterpret_cast<float*>(Ls + MP * LD);
  float* scr_all = Sall + BWARPS * 16 * LD;

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int er = lane >> 1, ec = (lane & 1) * 8;  // a lane's row and columns of a 16x16 tile
  float* Sw = Sall + warp * 16 * LD;
  float* scr = scr_all + warp * 256;
  const int KT = MP / 16;
  const float* brow0 = bias + (size_t)h * M * M;
  float* wrow0 = work + ((size_t)chunk * H + h) * M * M;
  // dq, dk and dv are the three slots of the packed (BW, M, 3, H, 32) gradient
  const size_t dsm = 3 * (size_t)H * BD, dsb = (size_t)M * dsm;
  const int w0 = chunk * wpc, w1 = min(BW, w0 + wpc);

  for (int w = w0; w < w1; ++w) {
    const bool first = w == w0;
    const size_t base = (size_t)w * sb + (size_t)h * sh;
    const size_t gbase = (size_t)w * gb + (size_t)h * gh;
    for (int i = threadIdx.x; i < MP * (BD / 8); i += BT) {
      const int r = i / (BD / 8), c = (i % (BD / 8)) * 8;
      const bool ok = r < M;
      const size_t o = base + (size_t)r * sm + c;
      cp_async16(Qs + r * BKLD + c, ok ? q + o : q, ok);
      cp_async16(Ks + r * BKLD + c, ok ? k + o : k, ok);
      cp_async16(Vs + r * BKLD + c, ok ? v + o : v, ok);
      cp_async16(Gs + r * BKLD + c, ok ? g + gbase + (size_t)r * gm + c : g, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const float* mrow0 = HAS_MASK ? mask + (size_t)(w % nW) * M * M : nullptr;
    bf16* dq = dqkv + (size_t)w * dsb + (size_t)h * BD;
    bf16* dk = dq + (size_t)H * BD;
    bf16* dv = dk + (size_t)H * BD;

    // phase 1: 16-row query strips, one warp each
    for (int rt = warp; rt < KT; rt += BWARPS) {
      const int r0 = rt * 16;
      FragA qa0, qa1;
      wmma::load_matrix_sync(qa0, Qs + r0 * BKLD, BKLD);
      wmma::load_matrix_sync(qa1, Qs + r0 * BKLD + 16, BKLD);
      for (int kt = 0; kt < KT; ++kt) {
        FragBt b0, b1;
        FragC s;
        wmma::fill_fragment(s, 0.f);
        wmma::load_matrix_sync(b0, Ks + kt * 16 * BKLD, BKLD);
        wmma::load_matrix_sync(b1, Ks + kt * 16 * BKLD + 16, BKLD);
        wmma::mma_sync(s, qa0, b0, s);
        wmma::mma_sync(s, qa1, b1, s);
        wmma::store_matrix_sync(Sw + kt * 16, s, LD, wmma::mem_row_major);
      }
      __syncwarp();

      // the normalised probabilities, a row at a time by the whole warp: f32
      // into the strip (in place of the scores), bf16 into P; zero for the
      // padded keys and query rows
      for (int r = 0; r < 16; ++r) {
        float* sr = Sw + r * LD;
        bf16* pr = Ps + (r0 + r) * LD;
        const int gr = r0 + r;
        if (gr >= M) {  // the same for every lane of the warp
          for (int c = lane; c < MP; c += 32) {
            sr[c] = 0.f;
            pr[c] = __float2bfloat16(0.f);
          }
          continue;
        }
        const float* br = brow0 + (size_t)gr * M;
        const float* mr = HAS_MASK ? mrow0 + (size_t)gr * M : nullptr;
        float lv[BNJ];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BNJ; ++j) {
          const int c = lane + 32 * j;
          lv[j] = -INFINITY;
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
        for (int j = 0; j < BNJ; ++j) {
          lv[j] = expf(lv[j] - mx);  // 0 for the padded keys
          sum += lv[j];
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int j = 0; j < BNJ; ++j) {
          const int c = lane + 32 * j;
          if (c < MP) {
            const float pn = lv[j] / sum;
            sr[c] = pn;
            pr[c] = __float2bfloat16(pn);
          }
        }
      }
      __syncwarp();

      // dp = g v^T a 16x16 tile at a time: the row sums of dp * pn first, then
      // dl = pn (dp - r) with the tile computed again
      FragA ga0, ga1;
      wmma::load_matrix_sync(ga0, Gs + r0 * BKLD, BKLD);
      wmma::load_matrix_sync(ga1, Gs + r0 * BKLD + 16, BKLD);
      auto dp_tile = [&](int kt, float* out8) {
        FragBt b0, b1;
        FragC d;
        wmma::fill_fragment(d, 0.f);
        wmma::load_matrix_sync(b0, Vs + kt * 16 * BKLD, BKLD);
        wmma::load_matrix_sync(b1, Vs + kt * 16 * BKLD + 16, BKLD);
        wmma::mma_sync(d, ga0, b0, d);
        wmma::mma_sync(d, ga1, b1, d);
        frag_row8(d, scr, lane, out8);
      };
      float racc = 0.f;
      for (int kt = 0; kt < KT; ++kt) {
        float d8[8];
        dp_tile(kt, d8);
        const float* pnr = Sw + er * LD + kt * 16 + ec;
#pragma unroll
        for (int i = 0; i < 8; ++i) racc += d8[i] * pnr[i];
      }
      const float rsum = racc + __shfl_xor_sync(0xffffffffu, racc, 1);
      const int gr = r0 + er;
      for (int kt = 0; kt < KT; ++kt) {
        float d8[8], dl[8];
        dp_tile(kt, d8);
        const float* pnr = Sw + er * LD + kt * 16 + ec;
#pragma unroll
        for (int i = 0; i < 8; ++i) dl[i] = pnr[i] * (d8[i] - rsum);
        *reinterpret_cast<uint4*>(Ls + gr * LD + kt * 16 + ec) = pack8(dl);
        if (gr < M) {  // this lane owns these dbias entries in every window
          float* wr = wrow0 + (size_t)gr * M + kt * 16 + ec;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (kt * 16 + ec + i < M) wr[i] = first ? dl[i] : wr[i] + dl[i];
        }
      }
      __syncwarp();

      // dq of the strip = bf16(dl) k * scale
      FragC o0, o1;
      wmma::fill_fragment(o0, 0.f);
      wmma::fill_fragment(o1, 0.f);
      for (int kk = 0; kk < MP; kk += 16) {
        FragA la;
        FragB k0, k1;
        wmma::load_matrix_sync(la, Ls + r0 * LD + kk, LD);
        wmma::load_matrix_sync(k0, Ks + kk * BKLD, BKLD);
        wmma::load_matrix_sync(k1, Ks + kk * BKLD + 16, BKLD);
        wmma::mma_sync(o0, la, k0, o0);
        wmma::mma_sync(o1, la, k1, o1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float vals[8];
        frag_row8(i == 0 ? o0 : o1, scr, lane, vals);
        if (gr < M) {
#pragma unroll
          for (int j = 0; j < 8; ++j) vals[j] *= scale;
          *reinterpret_cast<uint4*>(dq + (size_t)gr * dsm + i * 16 + ec) = pack8(vals);
        }
      }
    }
    __syncthreads();

    // phase 2: 16-row key tiles, one warp each: dk = dL^T q, dv = P^T g
    for (int kt = warp; kt < KT; kt += BWARPS) {
      FragC ak0, ak1, av0, av1;
      wmma::fill_fragment(ak0, 0.f);
      wmma::fill_fragment(ak1, 0.f);
      wmma::fill_fragment(av0, 0.f);
      wmma::fill_fragment(av1, 0.f);
      for (int qt = 0; qt < KT; ++qt) {
        FragAc pa, la;
        FragB g0, g1, q0, q1;
        wmma::load_matrix_sync(pa, Ps + qt * 16 * LD + kt * 16, LD);
        wmma::load_matrix_sync(la, Ls + qt * 16 * LD + kt * 16, LD);
        wmma::load_matrix_sync(g0, Gs + qt * 16 * BKLD, BKLD);
        wmma::load_matrix_sync(g1, Gs + qt * 16 * BKLD + 16, BKLD);
        wmma::load_matrix_sync(q0, Qs + qt * 16 * BKLD, BKLD);
        wmma::load_matrix_sync(q1, Qs + qt * 16 * BKLD + 16, BKLD);
        wmma::mma_sync(av0, pa, g0, av0);
        wmma::mma_sync(av1, pa, g1, av1);
        wmma::mma_sync(ak0, la, q0, ak0);
        wmma::mma_sync(ak1, la, q1, ak1);
      }
      const int gr = kt * 16 + er;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float vals[8];
        frag_row8(i == 0 ? av0 : av1, scr, lane, vals);
        if (gr < M)
          *reinterpret_cast<uint4*>(dv + (size_t)gr * dsm + i * 16 + ec) = pack8(vals);
        frag_row8(i == 0 ? ak0 : ak1, scr, lane, vals);
        if (gr < M) {
#pragma unroll
          for (int j = 0; j < 8; ++j) vals[j] *= scale;
          *reinterpret_cast<uint4*>(dk + (size_t)gr * dsm + i * 16 + ec) = pack8(vals);
        }
      }
    }
    __syncthreads();  // the tiles and matrices are refilled for the next window
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
// 16-byte aligned. bias (H, M, M) f32; mask (nW, M, M) f32 or null.
// -> dqkv (BW, M, 3, H, 32) bf16 contiguous; dbias (H, M, M) f32. work holds
// ceil(BW / wpc) x H x M x M f32 partials, wpc windows a block.
extern "C" int mtt_window_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* g, const void* bias, const void* mask,
                                             void* dqkv, void* work, void* dbias, int BW, int M,
                                             int H, int nW, long long sb, long long sm,
                                             long long sh, long long gb, long long gm,
                                             long long gh, int wpc, float scale, void* stream) {
  if (BW < 1 || M < 1 || H < 1 || H > 65535 || wpc < 1 || (mask && (nW < 1 || BW % nW)) ||
      sb % 8 || sm % 8 || sh % 8 || gb % 8 || gm % 8 || gh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MP = (M + 15) / 16 * 16;
  if (MP > 32 * BNJ) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wbwd_smem(MP);
  const int nchunk = (BW + wpc - 1) / wpc;
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    // set on every launch: the attribute belongs to the current device's context
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(nchunk, H), BT, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<bf16*>(dqkv), static_cast<float*>(work), BW,
        M, MP, H, nW, sb, sm, sh, gb, gm, gh, wpc, scale);
    return cudaGetLastError();
  };
  cudaError_t e = mask ? launch(wattn_bwd_kernel<true>) : launch(wattn_bwd_kernel<false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = H * M * M;
  const int blocks = n < 1024 * 256 ? (n + 255) / 256 : 1024;
  wattn_dbias_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(work),
                                                 static_cast<float*>(dbias), nchunk, n);
  return static_cast<int>(cudaGetLastError());
}
