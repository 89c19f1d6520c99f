// One evaluation of the ODE-ViT vector field, fused into one CUDA kernel.
//
// Replaces the TPU kernel odevit_tpu/kernels/vector_field.py::_vf_kernel
// (its plain, Euler, stage-advance and JaSMin-statistics modes, the
// dropout of the plain and JaSMin modes, the L2+bias mode of the plain
// and JaSMin modes, and the residual stash of the plain and JaSMin modes),
// and, as the instance kChain, _vf_euler_chain_kernel (`chain` Euler steps
// per launch), on Hopper (sm_90a).
//
//   f(x)  = (MLP(CN_m x) + Attn(CN_a x)) * scaler
//   plain : out = f(x)
//   euler : out = x + coef * f(x)            (f not rounded first)
//   base  : out = base + coef * f(x)         (Kutta 3/8 stage advance)
//
// x, base, out: [B * n_pad, D] row-major (bf16 or f32); gamma/beta: [D]
// f32; weights in [in, out] layout and x's dtype: Wqkv [D, 3D],
// Wout [D, D], W1 [D, dh], W2 [dh, D].
//
// Numerics follow the TPU kernel: CenterNorm centering in f32; cn_a, cn_m,
// gelu(h), qkv (before the heads are sliced), p and ctx are rounded to the
// compute dtype; every product accumulates in f32; mlp_o and attn_o stay
// in f32. Padded keys (index >= n_real) are masked by selection, and the
// padded rows of v are zeroed, so garbage or NaN in padded rows of x never
// reaches a real row (0 * NaN would).
//
// L2+bias mode (instance kL2, the TPU kernel's l2_attention with biases):
// qkv = round(cn_a Wqkv + qkv_bias); per head, q2 and k2 are the f32 row
// norms of the rounded q and k, and p = round(e / (sum e + 1e-8)) with
// e = exp(-(q2 + k2 - 2 q.k) tau) over the real keys, 0 on padded keys.
// No max is subtracted, as in the TPU kernel: a row whose exponentials all
// underflow gives p = 0 (the 1e-8 keeps it finite). expf, never __expf,
// which flushes the small exponentials that guard exists for. out_bias is
// added to the f32 accumulator once, before the scaler. The norms' extra
// work is under 1 % of the products', so the bound is the softmax one.
//
// JaSMin-statistics mode (the training tail, `jas_kk` = k + 1 > 0): the
// output is f(x), and for every head and query row the kernel also takes
// kk max-extraction passes over the rounded p of the real keys, each
// removing the first column that holds the maximum (as the TPU kernel
// and JAX's argmax do), and keeps ranks (1, 2, kk-1, kk), the columns they
// came from, and the row sum of clip(p, 1e-12, 1). The [n, n] map never
// leaves shared memory; the passes run on registers (four columns per
// lane), so the mode needs no more shared memory than the plain one. The
// backward scatters the statistics' cotangents onto the saved columns.
//
// Residual stash (instance kStash, the TPU kernel's emit_resid, :205,
// :242-244, :266-270; plain and JaSMin modes, softmax, no dropout): the
// evaluation also writes the two products the backward would recompute,
// in the compute dtype and JAX's padded row layout: rqkv [B * n_pad, 3D],
// the qkv the heads are sliced from (rounded after the product, exactly
// what a recompute rounds; the padded value rows as the product gives
// them, not zeroed), and rh1 [B * n_pad, dh], the pre-GELU hidden
// round(cn_m W1) of each dh chunk, stored from the f32 stage before the
// GELU reads it. f(x) is the non-stash instance's, bit for bit: the stores
// read values the evaluation computes anyway. They add 2 (3D + dh) bytes
// per row to the state's traffic (220 MB at B=1024 on the CIFAR shape in
// bf16, 66 us at 3.35 TB/s), below the products' bound.
//
// Bound. At the serving shape (B=1024, 69 real tokens padded to 80,
// D=192, 3 heads, dh=768) one evaluation needs about 64.7 MFLOP per
// image, 66 GFLOP in all: 67 us at the H100's 989 TFLOP/s in bf16. Its
// state traffic is about 54 MB in and out, 16 us at 3.35 TB/s. So the
// kernel is bound by tensor-core operations once it is good. With dropout
// 0.1 the masks take 23.6 k Philox calls per image (real rows and keys),
// 24.2 M per launch. Their busiest pipe is the FMA pipe, which takes the
// 40 multiply halves of each call (the xors and compares go to the ALU
// pipe, the key schedule is per site): 58 us at 64 lanes per SM, below
// the products' 67 us, which still bind.
//
// Design. One CTA per image keeps the whole evaluation in shared memory:
// only x (and base) come in and only the new state goes out. The MLP runs
// over dh in chunks, so the [n_pad, dh] hidden never exists whole, and the
// attention output is accumulated head by head into the same f32
// accumulator as the MLP (attn_o = sum_h ctx_h Wout[h]); where shared
// memory allows, q, k and v of a head come from one product. Products use
// bf16 WMMA fragments (16x16x16, f32 accumulators); each warp owns a
// column tile and walks its rows, so each weight fragment is read from L2
// once per image, one step ahead of its use; 12 warps match the 12 column
// tiles of D=192. Shared-memory rows are padded by 16 bytes so fragment
// loads hit distinct banks. Weights (0.9 MB in bf16) stay in L2 across
// the batch.
// f32 (the dtype the recipes train in) runs vf_kernel_f32 below: every
// product on split TF32 (three TF32 passes on mma.sync, operands staged
// through shared memory by cp.async, each weight slice once per CTA), the
// accumulator in shared memory. Its bound is split TF32's floor, 0.40 ms
// at the CIFAR training shape; one 12-warp CTA per SM, a barrier per K
// slice and the small dependent products of each head limit it.
//
// What limits it today: the shared memory of one image (~223 KB) allows
// one 12-warp CTA per SM, so the barriers between small dependent
// products and the elementwise phases leave the tensor cores idle most of
// the time (vf_attribution.py breaks the time down). Not yet done:
// accumulators in registers (two CTAs per SM), ldmatrix/wgmma, TMA,
// multi-stage pipelines.

// The device helpers below (namespace vf) are shared with the backward,
// vector_field_bwd.cu, which includes this file with VF_HELPERS_ONLY
// defined. Products: bf16 WMMA fragments (16x16x16, f32 accumulators) or
// plain f32 loops on the CUDA cores (the f32 overload of vf::mm, which the
// tiled route's f32 attention CTAs still call). Both walk K in the same
// order whatever the product's layout, so a product recomputed by the
// backward is bit-identical to the forward's; the f32 one-CTA kernels
// share mac::gemm_tf32 (split_tf32.cuh) in the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace vf {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;            // 12 warps: one per column tile of D=192
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowTiles = 8;          // n_pad <= 128
constexpr int kMaxSmem = 232448;         // 227 KB of dynamic shared memory

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv gelu(v) = 0.5 (1 + erf(v / sqrt 2)) + v exp(-v^2 / 2) / sqrt(2 pi)
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// C[M,N] (=|+=) A[M,K] @ B[K,N], C f32 row-major (shared or global).
// A is row-major (lda) or, with AT, stored transposed: A(m, k) =
// A[k*lda + m]. B is row-major (ldb) or, with BT, stored transposed:
// B(k, n) = B[n*ldb + k]. M, N, K are multiples of 16. B's columns may
// come in strips: column tile t is read from strip t / strip (each `strip`
// tiles wide, `strip_stride` elements apart), so one product can gather
// the q, k and v columns of a head. Each warp owns a column tile (and,
// when there are fewer column tiles than warps, a group of row tiles): it
// reads each B fragment once, one step ahead of its use. A warp's group
// holds at most kRows row tiles (its accumulators live in registers).
template <bool AT, bool BT, int kRows = kMaxRowTiles>
__device__ void mm(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                   int ldc, bool accumulate, int M, int N, int K,
                   int strip = 1 << 30, int strip_stride = 0) {
  using ALayout =
      typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLayout =
      typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout>;
  const int warp = threadIdx.x / 32;
  const int mt = M / 16, nt = N / 16, kt = K / 16;
  const int groups = imin(imax(kWarps / nt, 1), mt);
  const int rg = (mt + groups - 1) / groups;
  for (int task = warp; task < nt * groups; task += kWarps) {
    const int tn = task % nt;
    const int r0 = (task / nt) * rg;
    const int rows = imin(mt - r0, rg);
    const int col = (tn / strip) * strip_stride + (tn % strip) * 16;
    const bf16* bcol = BT ? B + (size_t)col * ldb : B + col;
    const size_t bstep = BT ? 16 : (size_t)16 * ldb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        if (accumulate)
          wmma::load_matrix_sync(c[r], C + (r0 + r) * 16 * ldc + tn * 16,
                                 ldc, wmma::mem_row_major);
        else
          wmma::fill_fragment(c[r], 0.0f);
      }
    }
    FragB b, b_next;
    wmma::load_matrix_sync(b, bcol, ldb);
    for (int kk = 0; kk < kt; ++kk) {
      if (kk + 1 < kt)
        wmma::load_matrix_sync(b_next, bcol + (kk + 1) * bstep, ldb);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
          const bf16* ap = AT ? A + kk * 16 * lda + (r0 + r) * 16
                              : A + (r0 + r) * 16 * lda + kk * 16;
          wmma::load_matrix_sync(a, ap, lda);
          wmma::mma_sync(c[r], a, b, c[r]);
        }
      }
      b = b_next;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows)
        wmma::store_matrix_sync(C + (r0 + r) * 16 * ldc + tn * 16, c[r], ldc,
                                wmma::mem_row_major);
    }
  }
}

// The f32 version of the same product, on the CUDA cores (kRows unused).
template <bool AT, bool BT, int kRows = kMaxRowTiles>
__device__ void mm(const float* A, int lda, const float* B, int ldb,
                   float* C, int ldc, bool accumulate, int M, int N, int K,
                   int strip = 1 << 30, int strip_stride = 0) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, nc = i % N, t = nc / 16;
    const int n = (t / strip) * strip_stride + (t % strip) * 16 + nc % 16;
    float s = 0.0f;
    for (int k = 0; k < K; ++k)
      s = fmaf(AT ? A[(size_t)k * lda + m] : A[(size_t)m * lda + k],
               BT ? B[(size_t)n * ldb + k] : B[(size_t)k * ldb + n], s);
    float* c = C + (size_t)m * ldc + nc;
    *c = accumulate ? *c + s : s;
  }
}

// cn = round(((x - mean) * d/(d-1)) * gamma + beta), one warp per row.
// Rows >= n_real read as zeros when zero_pad (the backward, so that
// whatever the padded rows hold never reaches a cotangent). With `mean`,
// each row's mean is stored there too.
template <typename T>
__device__ void center_norm(const T* x, const float* gamma,
                            const float* beta, T* cn, int ld, int n, int d,
                            int n_real = 1 << 30, float* mean_out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = (float)((double)d / (d - 1.0));
  for (int r = warp; r < n; r += kWarps) {
    const T* row = x + (size_t)r * d;
    const bool real = r < n_real;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += real ? to_f(row[c]) : 0.0f;
    const float mean = warp_sum(sum) / d;
    if (mean_out != nullptr && lane == 0) mean_out[r] = mean;
    for (int c = lane; c < d; c += 32) {
      const float xv = real ? to_f(row[c]) : 0.0f;
      cn[r * ld + c] = from_f<T>(((xv - mean) * scale) * gamma[c] + beta[c]);
    }
  }
}

// p = round(softmax(s * qk_scale)) over keys < n_real; padded keys get 0
// by selection. One warp per query row. With `pf`, the unrounded
// probabilities are stored there too (f32).
template <typename T>
__device__ void softmax_rows(const float* s, int lds, T* p, int ldp, int n,
                             int n_real, float qk_scale,
                             float* pf = nullptr, int ldpf = 0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const float* row = s + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < n_real; c += 32) mx = fmaxf(mx, row[c] * qk_scale);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < n_real; c += 32) sum += expf(row[c] * qk_scale - mx);
    sum = warp_sum(sum);
    for (int c = lane; c < n; c += 32) {
      const float v = c < n_real ? expf(row[c] * qk_scale - mx) / sum : 0.0f;
      p[r * ldp + c] = from_f<T>(v);
      if (pf != nullptr) pf[r * ldpf + c] = v;
    }
  }
}

// p = round(e / (sum e + 1e-8)) with e = exp(-(q2 + k2 - 2 s) tau) over
// keys < n_real (L2 attention); padded keys get 0 by selection. q2, k2:
// the f32 row norms of q and k. One warp per query row. With `ef` the f32
// e is stored there too, and with `esum` each row's sum e + 1e-8.
template <typename T>
__device__ void l2_rows(const float* s, int lds, const float* q2,
                        const float* k2, T* p, int ldp, int n, int n_real,
                        float tau, float* ef = nullptr, int ldef = 0,
                        float* esum = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const float* row = s + r * lds;
    const float qr = q2[r];
    auto e_of = [&](int c) {
      return expf(-(qr + k2[c] - 2.0f * row[c]) * tau);
    };
    float sum = 0.0f;
    for (int c = lane; c < n_real; c += 32) sum += e_of(c);
    sum = warp_sum(sum) + 1e-8f;
    if (esum != nullptr && lane == 0) esum[r] = sum;
    for (int c = lane; c < n; c += 32) {
      const float e = c < n_real ? e_of(c) : 0.0f;
      p[r * ldp + c] = from_f<T>(e / sum);
      if (ef != nullptr) ef[r * ldef + c] = e;
    }
  }
}

// out[r] = sum over c < w of a[r, c]^2 in f32, one warp per row.
template <typename T>
__device__ void sq_rows(const T* a, int lda, int n, int w, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.0f;
    for (int c = lane; c < w; c += 32) {
      const float v = to_f(a[r * lda + c]);
      sum += v * v;
    }
    sum = warp_sum(sum);
    if (lane == 0) out[r] = sum;
  }
}

// dst[r, c] = round(scale * src[r, c] (+ bias[c])) for an [n, w] block;
// rows >= zero_from are written as 0. One warp per row. With `dst2`
// (global, row stride ld2) the same values are stored there as well, or,
// with zero_dst2 false, the values before the zeroing of rows >= zero_from.
template <typename T>
__device__ void round_block(const float* src, int lds, T* dst, int ldd, int n,
                            int w, int zero_from, float scale = 1.0f,
                            T* dst2 = nullptr, int ld2 = 0,
                            const float* bias = nullptr,
                            bool zero_dst2 = true) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps)
    for (int c = lane; c < w; c += 32) {
      const float f = src[r * lds + c] * scale;
      const T full = bias != nullptr ? from_f<T>(f + bias[c]) : from_f<T>(f);
      const T v = r >= zero_from ? from_f<T>(0.0f) : full;
      if (dst != nullptr) dst[r * ldd + c] = v;
      if (dst2 != nullptr) dst2[(size_t)r * ld2 + c] = zero_dst2 ? v : full;
    }
}

// ---- dropout: one counter-based stream (kernels/dropout.py) ----
// A keep bit is a pure function of (seed, site, image, row, column), so the
// forward, the backward and the generator (dropout_masks.cu) draw the same
// bits whatever their grids. Philox4x32-10 with key = (the site's seed,
// kPhiloxKeyHi) and counter = (image, row, column / 4, 0); word column % 4
// of the output; keep where bits >= the site's threshold, kept values
// scaled by 1 / (1 - rate). Sites: gelu(h) 0, mlp_o 1, attn_o 2, the maps
// of head h 3 + h. Only real rows and real keys are drawn: padding is 0.

constexpr unsigned kSeedGold = 0x9E3779B9u;
constexpr unsigned kPhiloxKeyHi = 0x6F766974u;
constexpr int kSiteH = 0, kSiteMlpOut = 1, kSiteAttnOut = 2, kSiteP = 3;

// One evaluation's dropout (ctypes: kernels/dropout.py::Drop). th_*: keep
// thresholds, 0 where the site has no dropout; sc_*: kept values. p: the
// attention maps (attn_drop); ao: attn_o (proj_drop); m: gelu(h) and mlp_o
// (mlp_drop).
struct Drop {
  unsigned seed;
  unsigned th_p, th_ao, th_m;
  float sc_p, sc_ao, sc_m;
};

// seed + 0x9E3779B9 * (site + 1), wrapping as int32 does
__host__ __device__ inline unsigned site_key(unsigned seed, int site) {
  return seed + kSeedGold * (unsigned)(site + 1);
}

__device__ __forceinline__ uint4 philox(unsigned key, unsigned img,
                                        unsigned row, unsigned col4) {
  unsigned c0 = img, c1 = row, c2 = col4, c3 = 0u;
  unsigned k0 = key, k1 = kPhiloxKeyHi;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// m[j]: the kept value of column 4 g + j of one real row: `sc` where kept,
// 0 where dropped or at a column >= n_valid (a padded key).
__device__ __forceinline__ void keep4(unsigned key, unsigned img, int row,
                                      int g, int n_valid, unsigned th,
                                      float sc, float m[4]) {
  const uint4 b = philox(key, img, row, g);
  const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    m[j] = 4 * g + j < n_valid && w[j] >= th ? sc : 0.0f;
}

// The keep bits of one real row of `ncols` columns, by one warp: column
// group g = 32 i + lane (columns 4 g .. 4 g + 3) sets bit `lane` of word
// 4 i + j for column 4 g + j. 4 * ceil(ncols / 128) words per row.
__device__ void keep_bits_row(unsigned key, unsigned img, int row, int ncols,
                              int n_valid, unsigned th, unsigned* words) {
  const int lane = threadIdx.x % 32;
  for (int i = 0; 128 * i < ncols; ++i) {
    const int g = 32 * i + lane;
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (4 * g < n_valid) keep4(key, img, row, g, n_valid, th, 1.0f, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned word = __ballot_sync(0xffffffffu, m[j] != 0.0f);
      if (lane == 0) words[4 * i + j] = word;
    }
  }
}

__device__ __forceinline__ bool kept(const unsigned* words, int c) {
  return (words[(c >> 7) * 4 + (c & 3)] >> ((c >> 2) & 31)) & 1u;
}

}  // namespace vf

#ifndef VF_HELPERS_ONLY

#include "split_tf32.cuh"

using namespace vf;

namespace {

constexpr int kChunks[] = {128, 64, 32, 16};

struct Shape {
  int n_pad, n_real, d, heads, hd, dh, hc;
  int qkv_fused;  // 1: q, k and v of a head come from one product
  int drop;       // 1: the dropout instance's plan
  int l2;         // 1: the L2 instance's plan (q2 and k2 of a head)
};

// Shared-memory layout of one CTA: byte offsets and row strides (in
// elements). Every row is padded by 16 bytes, so consecutive rows start in
// different banks and fragment loads are free of bank conflicts. The f32
// accumulator lives in shared memory for bf16 and in the (unpadded) output
// buffer for f32. The dropout instance also keeps attn_o's keep bits, and
// in bf16 takes each head's attn_o product in `stage` (so it is >= D wide);
// in f32 that product goes to a global scratch. The L2 instance also
// keeps the row norms q2 and k2 of one head.
struct Plan {
  size_t cn, stage, hbuf, q, k, v, p, acc, bits, norms, total;
  int ld_cn, ld_stage, ld_h, ld_qkv, ld_p, ld_acc, ld_bits;
};

__host__ __device__ inline Plan make_plan(const Shape& s, int tbytes) {
  const int pad = 16 / tbytes;
  Plan p;
  p.ld_cn = s.d + pad;
  p.ld_stage = imax(imax(imax(s.hc, s.qkv_fused ? 3 * s.hd : s.hd), s.n_pad),
                    s.drop && tbytes == 2 ? s.d : 0) + 4;
  p.ld_h = imax(s.hc, s.hd) + pad;
  p.ld_qkv = s.hd + pad;
  p.ld_p = s.n_pad + pad;
  p.ld_acc = tbytes == 2 ? s.d + 4 : s.d;
  const size_t n = s.n_pad;
  size_t off = 0;
  p.cn = off;    off += align128(n * p.ld_cn * tbytes);
  p.stage = off; off += align128(n * p.ld_stage * 4);
  p.hbuf = off;  off += align128(n * p.ld_h * tbytes);
  p.q = off;     off += align128(n * p.ld_qkv * tbytes);
  p.k = off;     off += align128(n * p.ld_qkv * tbytes);
  p.v = off;     off += align128(n * p.ld_qkv * tbytes);
  p.p = off;     off += align128(n * p.ld_p * tbytes);
  p.acc = off;
  if (tbytes == 2) off += align128(n * p.ld_acc * 4);
  p.bits = off;
  p.ld_bits = 4 * ((s.d + 127) / 128);
  if (s.drop) off += align128(n * p.ld_bits * 4);
  p.norms = off;
  if (s.l2) off += 2 * align128(n * 4);
  p.total = off;
  return p;
}

// JaSMin order statistics of one head, computed on the rounded p: one
// warp per query row, kk passes over the real keys, each taking the row's
// largest remaining value and removing the FIRST column that holds it
// (the row lives in registers, four columns per lane). Ranks (1, 2, kk-1,
// kk) are kept with the columns they came from, and the clipped row sum.
// stats: [5, n_pad] f32, idx: [4, n_pad] int32 of this image and head;
// padded query rows get zeros.
template <typename T>
__device__ void jas_stats_rows(const T* p, int ldp, int n, int n_real,
                               int kk, float* stats, int* idx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    if (r >= n_real) {
      if (lane < 5) stats[lane * n + r] = 0.0f;
      if (lane < 4) idx[lane * n + r] = 0;
      continue;
    }
    float v[kMaxRowTiles / 2];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxRowTiles / 2; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < n_real ? to_f(p[r * ldp + c]) : -INFINITY;
      if (c < n_real) sum += fminf(fmaxf(v[j], 1e-12f), 1.0f);
    }
    sum = warp_sum(sum);
    if (lane == 0) stats[4 * n + r] = sum;
    for (int pass = 0; pass < kk; ++pass) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxRowTiles / 2; ++j) m = fmaxf(m, v[j]);
      m = warp_max(m);
      int first = 1 << 30;
#pragma unroll
      for (int j = kMaxRowTiles / 2 - 1; j >= 0; --j)
        if (v[j] == m) first = lane + 32 * j;
      first = warp_min_int(first);
      if (lane == 0) {
        const int rows[4] = {0, 1, kk - 2, kk - 1};
        for (int i = 0; i < 4; ++i) {
          if (pass == rows[i]) {
            stats[i * n + r] = m;
            idx[i * n + r] = first;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxRowTiles / 2; ++j)
        if (lane + 32 * j == first) v[j] = -INFINITY;
    }
  }
}

// kJas: the JaSMin-statistics mode; kDrop: dropout; kChain: `chain` Euler
// steps in one launch (the TPU's _vf_euler_chain_kernel); kL2: L2
// attention with biases (plain and JaSMin modes, no dropout); kStash: the
// residual stash (plain and JaSMin modes, softmax, no dropout: rqkv and
// rh1, see the top of the file). Each is compiled apart so that the other
// modes keep their registers.
//
// Chain (kChain, mode 1): the CTA runs the whole evaluation `chain` times
// on its image. Each step's epilogue writes round(x + coef f(x)) to the
// image's rows of `out`, the state the next step reads (the TPU kernel
// rounds the state to its dtype between steps too, so a chain is step for
// step the per-step Euler route, bit for bit), and a barrier ends the step.
// The state and the f32 accumulator stay apart: in f32 `acc_global` is a
// scratch and not `out`. Steps after the first read the state through
// `out`, never through x, so x stays __restrict__ (read-only).
//
// Dropout (kDrop), at the sites the TPU kernel uses: h = round(round(
// gelu(h1)) * mask_h) per chunk; mlp_o * mask_mo, applied to the
// accumulator in place after the MLP loop; p = round(p * mask_p) per head
// after the JaSMin statistics, which stay those of the pre-dropout p; and
// attn_o * mask_ao. attn_o is a sum over heads that meets mlp_o in one
// accumulator, so each head's Wout product goes to `ao` (`stage` in bf16,
// a global scratch in f32) and is added masked: acc += mask_ao * ctx_h
// Wout_h. That sums attn_o in another order than (sum_h ctx_h Wout_h) *
// mask_ao; the f32 difference is rounding. attn_o's keep bits are drawn
// once, before the heads, into shared memory.
template <typename T, bool kJas, bool kDrop, bool kChain = false,
          bool kL2 = false, bool kStash = false>
__global__ void __launch_bounds__(kThreads)
vf_kernel(const T* __restrict__ x, const T* __restrict__ base,
          T* out, float* acc_global,  // may alias (f32: acc is out), not
                                      // with kChain
          const float* __restrict__ ga, const float* __restrict__ ba,
          const float* __restrict__ gm, const float* __restrict__ bm,
          const T* __restrict__ wqkv, const T* __restrict__ wout,
          const T* __restrict__ w1, const T* __restrict__ w2,
          const float* __restrict__ qkv_bias,  // kL2: [3D], else null
          const float* __restrict__ out_bias,  // kL2: [D], else null
          float* __restrict__ jas, int* __restrict__ jas_idx, int jas_kk,
          Shape s, float scaler, float coef, float qk_scale, int mode,
          Drop drop, float* __restrict__ ao_global, int chain,
          T* __restrict__ rqkv, T* __restrict__ rh1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan pl = make_plan(s, sizeof(T));
  T* cn = reinterpret_cast<T*>(smem + pl.cn);
  float* stage = reinterpret_cast<float*>(smem + pl.stage);
  T* hbuf = reinterpret_cast<T*>(smem + pl.hbuf);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  T* p = reinterpret_cast<T*>(smem + pl.p);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + pl.bits);
  float* q2 = reinterpret_cast<float*>(smem + pl.norms);
  float* k2 = q2 + align128(s.n_pad * 4) / 4;

  const int n = s.n_pad, d = s.d, hd = s.hd, hc = s.hc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned b = blockIdx.x;
  const size_t img = (size_t)blockIdx.x * n * d;
  T* oi = out + img;
  // kStash: this image's rows of rqkv [n, 3D] and rh1 [n, dh]
  T* rqkv_i = kStash ? rqkv + (size_t)blockIdx.x * n * 3 * d : nullptr;
  T* rh1_i = kStash ? rh1 + (size_t)blockIdx.x * n * s.dh : nullptr;
  float* acc = sizeof(T) == 2 ? reinterpret_cast<float*>(smem + pl.acc)
                              : acc_global + img;

  // one evaluation of the state xi; the epilogue writes this image's rows
  // of `out`
  auto evaluate = [&](const T* xi) {
    // MLP branch: acc = sum over dh chunks of gelu(cn_m W1[:, c]) W2[c, :]
    center_norm(xi, gm, bm, cn, pl.ld_cn, n, d);
    __syncthreads();
    for (int c0 = 0; c0 < s.dh; c0 += hc) {
      mm<false, false>(cn, pl.ld_cn, w1 + c0, s.dh, stage, pl.ld_stage, false,
                       n, hc, d);
      __syncthreads();
      if (kDrop && drop.th_m) {
        const unsigned key = site_key(drop.seed, kSiteH);
        for (int r = warp; r < n; r += kWarps)
          for (int g = lane; 4 * g < hc; g += 32) {
            float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < s.n_real)
              keep4(key, b, r, (c0 >> 2) + g, s.dh, drop.th_m, drop.sc_m, m);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 4 * g + j;
              const T h = from_f<T>(gelu(stage[r * pl.ld_stage + c]));
              hbuf[r * pl.ld_h + c] = from_f<T>(to_f(h) * m[j]);
            }
          }
      } else {
        for (int r = warp; r < n; r += kWarps)
          for (int c = lane; c < hc; c += 32) {
            const float h1 = stage[r * pl.ld_stage + c];
            // kStash: the pre-GELU hidden, rounded to the compute dtype
            if (kStash) rh1_i[(size_t)r * s.dh + c0 + c] = from_f<T>(h1);
            hbuf[r * pl.ld_h + c] = from_f<T>(gelu(h1));
          }
      }
      __syncthreads();
      mm<false, false>(hbuf, pl.ld_h, w2 + (size_t)c0 * d, d, acc, pl.ld_acc,
                       c0 > 0, n, d, hc);
      __syncthreads();
    }
    if (kDrop && drop.th_m) {
      // acc = mlp_o * mask_mo
      const unsigned key = site_key(drop.seed, kSiteMlpOut);
      for (int r = warp; r < n; r += kWarps)
        for (int g = lane; 4 * g < d; g += 32) {
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (r < s.n_real) keep4(key, b, r, g, d, drop.th_m, drop.sc_m, m);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r * pl.ld_acc + 4 * g + j] *= m[j];
        }
    }
    if (kDrop && drop.th_ao) {
      const unsigned key = site_key(drop.seed, kSiteAttnOut);
      for (int r = warp; r < n; r += kWarps) {
        if (r < s.n_real)
          keep_bits_row(key, b, r, d, d, drop.th_ao, bits + r * pl.ld_bits);
        else
          for (int i = lane; i < pl.ld_bits; i += 32)
            bits[r * pl.ld_bits + i] = 0;
      }
    }

    // attention branch, head by head: acc += ctx_h Wout[h*hd:(h+1)*hd, :]
    center_norm(xi, ga, ba, cn, pl.ld_cn, n, d);
    __syncthreads();
    for (int h = 0; h < s.heads; ++h) {
      T* dst[3] = {q, k, v};
      // padded value rows are zeroed so that 0 * NaN cannot reach p @ v
      if (s.qkv_fused) {
        mm<false, false>(cn, pl.ld_cn, wqkv + h * hd, 3 * d, stage,
                         pl.ld_stage, false, n, 3 * hd, d, hd / 16, d);
        __syncthreads();
        // kStash: the same rounded q, k and v to rqkv (value rows unzeroed)
        for (int j = 0; j < 3; ++j)
          round_block(stage + j * hd, pl.ld_stage, dst[j], pl.ld_qkv, n, hd,
                      j == 2 ? s.n_real : n, 1.0f,
                      kStash ? rqkv_i + j * d + h * hd : nullptr, 3 * d,
                      kL2 ? qkv_bias + j * d + h * hd : nullptr, false);
        __syncthreads();
      } else {
        for (int j = 0; j < 3; ++j) {
          mm<false, false>(cn, pl.ld_cn, wqkv + j * d + h * hd, 3 * d, stage,
                           pl.ld_stage, false, n, hd, d);
          __syncthreads();
          round_block(stage, pl.ld_stage, dst[j], pl.ld_qkv, n, hd,
                      j == 2 ? s.n_real : n, 1.0f,
                      kStash ? rqkv_i + j * d + h * hd : nullptr, 3 * d,
                      kL2 ? qkv_bias + j * d + h * hd : nullptr, false);
          __syncthreads();
        }
      }
      if (kL2) {
        // the rounded q's and k's row norms, beside the score product
        sq_rows(q, pl.ld_qkv, n, hd, q2);
        sq_rows(k, pl.ld_qkv, n, hd, k2);
      }
      mm<false, true>(q, pl.ld_qkv, k, pl.ld_qkv, stage, pl.ld_stage, false, n,
                      n, hd);
      __syncthreads();
      if (kL2) {
        l2_rows(stage, pl.ld_stage, q2, k2, p, pl.ld_p, n, s.n_real,
                qk_scale);
      } else {
        softmax_rows(stage, pl.ld_stage, p, pl.ld_p, n, s.n_real, qk_scale);
      }
      __syncthreads();
      if (kJas) {
        const size_t bh = (size_t)blockIdx.x * s.heads + h;
        jas_stats_rows(p, pl.ld_p, n, s.n_real, jas_kk, jas + bh * 5 * n,
                       jas_idx + bh * 4 * n);
      }
      if (kDrop && drop.th_p) {
        if (kJas) __syncthreads();  // the statistics read the pre-dropout p
        const unsigned key = site_key(drop.seed, kSiteP + h);
        for (int r = warp; r < n; r += kWarps)
          for (int g = lane; 4 * g < n; g += 32) {
            float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < s.n_real)
              keep4(key, b, r, g, s.n_real, drop.th_p, drop.sc_p, m);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              T* pj = p + r * pl.ld_p + 4 * g + j;
              *pj = from_f<T>(to_f(*pj) * m[j]);
            }
          }
        __syncthreads();
      }
      mm<false, false>(p, pl.ld_p, v, pl.ld_qkv, stage, pl.ld_stage, false, n,
                       hd, n);
      __syncthreads();
      round_block(stage, pl.ld_stage, hbuf, pl.ld_h, n, hd, n);
      __syncthreads();
      if (kDrop && drop.th_ao) {
        // acc += mask_ao * ctx_h Wout_h
        float* ao = sizeof(T) == 2 ? stage : ao_global + img;
        const int ld_ao = sizeof(T) == 2 ? pl.ld_stage : d;
        mm<false, false>(hbuf, pl.ld_h, wout + (size_t)h * hd * d, d, ao,
                         ld_ao, false, n, d, hd);
        __syncthreads();
        for (int r = warp; r < n; r += kWarps)
          for (int c = lane; c < d; c += 32)
            acc[r * pl.ld_acc + c] +=
                ao[r * ld_ao + c] *
                (kept(bits + r * pl.ld_bits, c) ? drop.sc_ao : 0.0f);
      } else {
        mm<false, false>(hbuf, pl.ld_h, wout + (size_t)h * hd * d, d, acc,
                         pl.ld_acc, true, n, d, hd);
      }
      __syncthreads();
    }

    const T* bi = mode == 2 ? base + img : xi;
    for (int r = warp; r < n; r += kWarps) {
      for (int c = lane; c < d; c += 32) {
        float a = acc[r * pl.ld_acc + c];
        if (kL2) a += out_bias[c];
        const float f = a * scaler;
        const size_t i = (size_t)r * d + c;
        oi[i] = from_f<T>(mode == 0 ? f : to_f(bi[i]) + coef * f);
      }
    }
  };
  evaluate(x + img);
  // kChain: each further step reads the state the previous one wrote,
  // through `out`
  for (int step = 1; kChain && step < chain; ++step) {
    __syncthreads();
    evaluate(oi);
  }
}

Shape make_shape(int n_pad, int n_real, int d, int heads, int dh, int hc,
                 int qkv_fused, int drop, int l2) {
  return Shape{n_pad, n_real, d,  heads,     heads > 0 ? d / heads : 0,
               dh,    hc,     qkv_fused, drop, l2};
}

bool shape_ok(const Shape& s) {
  return s.heads > 0 && s.d % s.heads == 0 && s.d % 16 == 0 &&
         s.hd % 16 == 0 && s.dh % 16 == 0 && s.n_pad % 16 == 0 &&
         s.n_pad > 0 && s.n_pad <= 16 * kMaxRowTiles && s.n_real > 0 &&
         s.n_real <= s.n_pad;
}

// ---- the f32 instance: vf_kernel_f32 ----
// vf_kernel's evaluation in f32 with every product on mac::gemm_tf32
// (split_tf32.cuh): operands in device memory reach shared memory by
// 16-byte cp.async through a ring of K slices and are split once, where
// they land, into big and small TF32 planes; each warp multiplies a
// register tile of up to 48 x 32 by mma.sync in three passes (small x big,
// big x small, big x big); epilogues run from registers. Each weight slice
// is staged once per CTA and shared by the 12 warps, not read from L2 once
// per output row.
//
// Where each operand lives. cn (of either norm) and the head's q | k | v
// go to a per-image workspace in device memory (they stay in L2: one
// image's is n_pad (D + 3 hd) floats), from where the ring stages them;
// ctx of the head overwrites q there. The products the CTA makes and
// reuses as an A operand stay in shared memory as split planes: the GELU
// chunk, and p (the scores land there in f32, the softmax and the JaSMin
// passes run on those rows in place, then the split, with the mask_p of
// dropout). mlp_o + attn_o accumulate in an f32 [n_pad, D] block: in
// shared memory where the plan has room for it (acc_smem), else in the
// workspace. Each product is summed over its own K (a dh chunk, a head)
// from zero and added to the accumulator by f32 adds, in the order of
// vf_kernel: the chunks, then the heads.
//
// Numerics: vf_kernel's in f32 (no rounding but the products'), with the
// products, the qkv, h1, score and ctx ones among them, split TF32 with
// the same K order as vfb_rows_f32's recomputation, so the stash's rqkv
// and rh1 are bit for bit what the backward recomputes. The split keeps
// NaN (split_bits), and padded rows of v are zeroed in the workspace, so
// a NaN in a padded row of x stays in its own rows, as in vf_kernel.
//
// Bound: split TF32 is three TF32 passes of every product, 199 GFLOP at
// the CIFAR training shape (B=1024), 0.40 ms at 495 TFLOP/s; its state
// traffic is 0.02 ms. What limits it: one 12-warp CTA per SM (the ring,
// the accumulator and the planes take most of the 227 KB), with a barrier
// per K slice of 16 and between the small dependent products of a head.
//
// f32 plan (vf_plan_f32; kernels/vector_field.py::f32_plan repeats it):
// the ring for column blocks of nb, the accumulator (acc_smem), then one
// region used by the MLP (the chunk's planes, hc + 4 floats a row) and by
// each head (p's planes, n_pad + 4 floats a row: a fragment row read 4 g +
// t hits 32 banks), then dropout's keep bits and L2's row norms. The
// choice prefers wide chunks, then wide column blocks (fewer K passes and
// barriers, fuller warp tiles), then the accumulator in shared memory:
// at the CIFAR shape chunks of 128 and blocks of 192 leave it no room, and
// that plan, with the accumulator's adds through L2, beat both plans that
// keep it in shared memory on the card. Which shapes take this kernel is
// vf_plan's decision (the route rule, unchanged): every shape it sends to
// one CTA has an f32 plan.
struct PlanF32 {
  size_t ring, acc, hbig, hsmall, pbig, psmall, bits, norms, total;
  size_t ws_qkv, ws_acc, ws;  // floats of one image's workspace (cn at 0)
  int slot, ld_acc, ld_h, ld_p, ld_bits, ld_qkv;
};

__host__ __device__ inline PlanF32 make_plan_f32(const Shape& s, int nb,
                                                 int acc_smem) {
  PlanF32 p;
  const size_t n = s.n_pad;
  p.slot = mac::ring_slot(s.n_pad, nb);
  p.ld_acc = s.d + 8;
  p.ld_h = s.hc + 4;
  p.ld_p = s.n_pad + 4;
  p.ld_bits = 4 * ((s.d + 127) / 128);
  p.ld_qkv = 3 * s.hd;
  size_t off = 0;
  p.ring = off;  off += align128((size_t)2 * mac::kStages * p.slot * 4);
  p.acc = off;
  if (acc_smem) off += align128(n * p.ld_acc * 4);
  const size_t fh = align128(n * p.ld_h * 4), fp = align128(n * p.ld_p * 4);
  p.hbig = off;
  p.hsmall = off + fh;
  p.pbig = off;
  p.psmall = off + fp;
  off += 2 * (fh > fp ? fh : fp);
  p.bits = off;
  if (s.drop) off += align128(n * p.ld_bits * 4);
  p.norms = off;
  if (s.l2) off += 2 * align128(n * 4);
  p.total = off;
  p.ws_qkv = n * s.d;
  p.ws_acc = p.ws_qkv + n * p.ld_qkv;
  p.ws = p.ws_acc + (acc_smem ? 0 : n * s.d);
  return p;
}

template <bool kJas, bool kDrop, bool kChain, bool kL2, bool kStash>
__global__ void __launch_bounds__(kThreads, 1)
vf_kernel_f32(const float* __restrict__ x, const float* __restrict__ base,
              float* out, float* __restrict__ ws,
              const float* __restrict__ ga, const float* __restrict__ ba,
              const float* __restrict__ gm, const float* __restrict__ bm,
              const float* __restrict__ wqkv, const float* __restrict__ wout,
              const float* __restrict__ w1, const float* __restrict__ w2,
              const float* __restrict__ qkv_bias,
              const float* __restrict__ out_bias, float* __restrict__ jas,
              int* __restrict__ jas_idx, int jas_kk, Shape s, int nb,
              int acc_smem, float scaler, float coef, float qk_scale,
              int mode, Drop drop, int chain, float* __restrict__ rqkv,
              float* __restrict__ rh1) {
  extern __shared__ __align__(128) unsigned char smem[];
  using mac::gemm_tf32;
  using mac::kAPlanes;
  using mac::kAStaged;
  using mac::op_b;
  using mac::put2;
  const PlanF32 pl = make_plan_f32(s, nb, acc_smem);
  const int n = s.n_pad, d = s.d, hd = s.hd, hc = s.hc, dh = s.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned b = blockIdx.x;
  const size_t img = (size_t)blockIdx.x * n * d;
  float* oi = out + img;
  float* cn = ws + (size_t)blockIdx.x * pl.ws;
  float* qkv = cn + pl.ws_qkv;
  const int lq = pl.ld_qkv, lh = pl.ld_h, lp = pl.ld_p;
  float* acc = acc_smem ? reinterpret_cast<float*>(smem + pl.acc)
                        : cn + pl.ws_acc;
  const int la = acc_smem ? pl.ld_acc : d;
  const mac::Ring ring{reinterpret_cast<unsigned*>(smem + pl.ring), pl.slot};
  unsigned* hbig = reinterpret_cast<unsigned*>(smem + pl.hbig);
  unsigned* hsmall = reinterpret_cast<unsigned*>(smem + pl.hsmall);
  unsigned* pbig = reinterpret_cast<unsigned*>(smem + pl.pbig);
  unsigned* psmall = reinterpret_cast<unsigned*>(smem + pl.psmall);
  float* sf = reinterpret_cast<float*>(pbig);  // the f32 scores, then p
  unsigned* bits = reinterpret_cast<unsigned*>(smem + pl.bits);
  float* q2 = reinterpret_cast<float*>(smem + pl.norms);
  float* k2 = q2 + align128(s.n_pad * 4) / 4;
  float* rqkv_i = kStash ? rqkv + (size_t)blockIdx.x * n * 3 * d : nullptr;
  float* rh1_i = kStash ? rh1 + (size_t)blockIdx.x * n * dh : nullptr;
  auto staged = [](const float* p, int ld) {
    return mac::OpA{p, ld, nullptr, nullptr};
  };
  const mac::OpA hpl{nullptr, lh, hbig, hsmall};
  const mac::OpA ppl{nullptr, lp, pbig, psmall};
  // an accumulator in the workspace takes gemm_tf32's cadd (all of a
  // warp's loads at once), one in shared memory adds in the epilogue;
  // attn_o under dropout is masked before it is added
  const bool ao_masked = kDrop && drop.th_ao;

  auto evaluate = [&](const float* xi) {
    // MLP branch: acc = sum over dh chunks of gelu(cn_m W1[:, c]) W2[c, :]
    center_norm(xi, gm, bm, cn, d, n, d);
    for (int c0 = 0; c0 < dh; c0 += hc) {
      gemm_tf32<kAStaged, false>(
          ring, n, hc, d, nb, staged(cn, d), op_b(w1 + c0, dh),
          [&](int r, int c, float v0, float v1) {
            hbig[r * lh + c] = __float_as_uint(v0);
            hbig[r * lh + c + 1] = __float_as_uint(v1);
          });
      __syncthreads();
      // h = gelu(h1) (x mask_h) to the chunk's planes, in place
      if (kDrop && drop.th_m) {
        const unsigned key = site_key(drop.seed, kSiteH);
        for (int r = warp; r < n; r += kWarps)
          for (int g = lane; 4 * g < hc; g += 32) {
            float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < s.n_real)
              keep4(key, b, r, (c0 >> 2) + g, dh, drop.th_m, drop.sc_m, m);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = r * lh + 4 * g + j;
              split_bits(gelu(__uint_as_float(hbig[i])) * m[j], hbig[i],
                         hsmall[i]);
            }
          }
      } else {
        for (int r = warp; r < n; r += kWarps)
          for (int c = lane; c < hc; c += 32) {
            const int i = r * lh + c;
            const float h1 = __uint_as_float(hbig[i]);
            // kStash: the pre-GELU hidden
            if (kStash) rh1_i[(size_t)r * dh + c0 + c] = h1;
            split_bits(gelu(h1), hbig[i], hsmall[i]);
          }
      }
      const bool first = c0 == 0;
      gemm_tf32<kAPlanes, false>(
          ring, n, d, hc, nb, hpl, op_b(w2 + (size_t)c0 * d, d),
          [&](int r, int c, float v0, float v1) {
            float* a = acc + r * la + c;
            if (acc_smem && !first) {
              v0 += a[0];
              v1 += a[1];
            }
            put2(a, v0, v1);
          },
          acc_smem || first ? nullptr : acc, la);
    }
    __syncthreads();
    if (kDrop && drop.th_m) {
      // acc = mlp_o * mask_mo
      const unsigned key = site_key(drop.seed, kSiteMlpOut);
      for (int r = warp; r < n; r += kWarps)
        for (int g = lane; 4 * g < d; g += 32) {
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (r < s.n_real) keep4(key, b, r, g, d, drop.th_m, drop.sc_m, m);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r * la + 4 * g + j] *= m[j];
        }
    }
    if (ao_masked) {
      const unsigned key = site_key(drop.seed, kSiteAttnOut);
      for (int r = warp; r < n; r += kWarps) {
        if (r < s.n_real)
          keep_bits_row(key, b, r, d, d, drop.th_ao, bits + r * pl.ld_bits);
        else
          for (int i = lane; i < pl.ld_bits; i += 32)
            bits[r * pl.ld_bits + i] = 0;
      }
    }

    // attention branch, head by head: acc += ctx_h Wout[h*hd:(h+1)*hd, :]
    center_norm(xi, ga, ba, cn, d, n, d);
    for (int h = 0; h < s.heads; ++h) {
      // q | k | v of the head in one product to the workspace (padded
      // value rows zeroed so that 0 * NaN cannot reach p @ v; kStash: the
      // same values to rqkv, value rows unzeroed)
      gemm_tf32<kAStaged, false>(
          ring, n, 3 * hd, d, nb, staged(cn, d),
          op_b(wqkv + h * hd, 3 * d, 1.0f, hd, d),
          [&](int r, int c, float v0, float v1) {
            const int j = c / hd, cc = j * d + h * hd + c % hd;
            if (kL2) {
              v0 += qkv_bias[cc];
              v1 += qkv_bias[cc + 1];
            }
            if (kStash) put2(rqkv_i + (size_t)r * 3 * d + cc, v0, v1);
            const bool zero = j == 2 && r >= s.n_real;
            put2(qkv + (size_t)r * lq + c, zero ? 0.0f : v0,
                 zero ? 0.0f : v1);
          });
      if (kL2) {
        // q's and k's row norms, beside the score product
        __syncthreads();
        sq_rows(qkv, lq, n, hd, q2);
        sq_rows(qkv + hd, lq, n, hd, k2);
      }
      gemm_tf32<kAStaged, true>(
          ring, n, n, hd, nb, staged(qkv, lq), op_b(qkv + hd, lq),
          [&](int r, int c, float v0, float v1) {
            sf[r * lp + c] = v0;
            sf[r * lp + c + 1] = v1;
          });
      __syncthreads();
      if (kL2)
        l2_rows(sf, lp, q2, k2, sf, lp, n, s.n_real, qk_scale);
      else
        softmax_rows(sf, lp, sf, lp, n, s.n_real, qk_scale);
      __syncthreads();
      if (kJas) {
        const size_t bh = (size_t)blockIdx.x * s.heads + h;
        jas_stats_rows(sf, lp, n, s.n_real, jas_kk, jas + bh * 5 * n,
                       jas_idx + bh * 4 * n);
        __syncthreads();
      }
      // p (x mask_p; the statistics took the pre-dropout p) to its planes,
      // in place
      if (kDrop && drop.th_p) {
        const unsigned key = site_key(drop.seed, kSiteP + h);
        for (int r = warp; r < n; r += kWarps)
          for (int g = lane; 4 * g < n; g += 32) {
            float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < s.n_real)
              keep4(key, b, r, g, s.n_real, drop.th_p, drop.sc_p, m);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = r * lp + 4 * g + j;
              split_bits(sf[i] * m[j], pbig[i], psmall[i]);
            }
          }
      } else {
        for (int r = warp; r < n; r += kWarps)
          for (int c = lane; c < n; c += 32) {
            const int i = r * lp + c;
            split_bits(sf[i], pbig[i], psmall[i]);
          }
      }
      // ctx = p v over q's columns, then acc += ctx Wout_h (x mask_ao)
      gemm_tf32<kAPlanes, false>(
          ring, n, hd, n, nb, ppl, op_b(qkv + 2 * hd, lq),
          [&](int r, int c, float v0, float v1) {
            put2(qkv + (size_t)r * lq + c, v0, v1);
          });
      gemm_tf32<kAStaged, false>(
          ring, n, d, hd, nb, staged(qkv, lq),
          op_b(wout + (size_t)h * hd * d, d),
          [&](int r, int c, float v0, float v1) {
            float* a = acc + r * la + c;
            if (ao_masked) {
              const unsigned* w = bits + r * pl.ld_bits;
              v0 *= kept(w, c) ? drop.sc_ao : 0.0f;
              v1 *= kept(w, c + 1) ? drop.sc_ao : 0.0f;
            }
            if (acc_smem || ao_masked) {
              v0 += a[0];
              v1 += a[1];
            }
            put2(a, v0, v1);
          },
          acc_smem || ao_masked ? nullptr : acc, la);
    }
    __syncthreads();

    const float* bi = mode == 2 ? base + img : xi;
    for (int r = warp; r < n; r += kWarps) {
      for (int c = lane; c < d; c += 32) {
        float a = acc[r * la + c];
        if (kL2) a += out_bias[c];
        const float f = a * scaler;
        const size_t i = (size_t)r * d + c;
        oi[i] = mode == 0 ? f : bi[i] + coef * f;
      }
    }
  };
  evaluate(x + img);
  // kChain: each further step reads the state the previous one wrote,
  // through `out`
  for (int step = 1; kChain && step < chain; ++step) {
    __syncthreads();
    evaluate(oi);
  }
}

// The f32 plan of one CTA (see PlanF32): the widest MLP chunk, then the
// widest column block, with the accumulator in shared memory where it
// still fits, else in the workspace. Returns false when no plan fits.
bool plan_f32(Shape s, int* acc_smem, int* hc, int* nb, PlanF32* out) {
  for (int c : kChunks) {
    if (s.dh % c) continue;
    s.hc = c;
    for (int b : mac::kBlocksF32) {
      if (!mac::block_ok(s.n_pad, b)) continue;
      for (int as = 1; as >= 0; --as) {
        const PlanF32 p = make_plan_f32(s, b, as);
        if (p.total <= (size_t)kMaxSmem) {
          *acc_smem = as;
          *hc = c;
          *nb = b;
          *out = p;
          return true;
        }
      }
    }
  }
  return false;
}

// vf_kernel_f32's launches so far (chip_smoke.py holds the count against
// the route's)
unsigned long long f32_launches = 0;

int launch_f32(const float* x, const float* base, float* out, float* ws,
               const float* ga, const float* ba, const float* gm,
               const float* bm, const float* wqkv, const float* wout,
               const float* w1, const float* w2, const float* qkvb,
               const float* outb, float* jas, int* jas_idx, int jas_kk,
               int batch, Shape s, float scaler, float coef, float qk_scale,
               int mode, const Drop& drop, bool has_drop, int chain,
               float* rqkv, float* rh1, cudaStream_t st) {
  int acc_smem, hc, nb;
  PlanF32 p;
  if (ws == nullptr || !shape_ok(s) ||
      !plan_f32(s, &acc_smem, &hc, &nb, &p))
    return (int)cudaErrorInvalidValue;
  s.hc = hc;
  auto kernel = rqkv != nullptr
                    ? (jas_kk > 0 ? vf_kernel_f32<true, false, false, false,
                                                  true>
                                  : vf_kernel_f32<false, false, false, false,
                                                  true>)
                : chain > 1 ? vf_kernel_f32<false, false, true, false, false>
                : s.l2      ? (jas_kk > 0 ? vf_kernel_f32<true, false, false,
                                                          true, false>
                                          : vf_kernel_f32<false, false, false,
                                                          true, false>)
                : has_drop  ? (jas_kk > 0 ? vf_kernel_f32<true, true, false,
                                                          false, false>
                                          : vf_kernel_f32<false, true, false,
                                                          false, false>)
                : jas_kk > 0 ? vf_kernel_f32<true, false, false, false, false>
                             : vf_kernel_f32<false, false, false, false,
                                             false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, p.total, st>>>(
      x, base, out, ws, ga, ba, gm, bm, wqkv, wout, w1, w2, qkvb, outb, jas,
      jas_idx, jas_kk, s, nb, acc_smem, scaler, coef, qk_scale, mode, drop,
      chain, rqkv, rh1);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++f32_launches;
  return (int)err;
}

template <typename T, bool kDrop>
int launch(const void* x, const void* base, void* out, void* acc,
           const float* ga, const float* ba, const float* gm,
           const float* bm, const void* wqkv, const void* wout,
           const void* w1, const void* w2, const float* qkvb,
           const float* outb, void* jas, void* jas_idx, int jas_kk,
           int batch, int smem, Shape s, float scaler, float coef,
           float qk_scale, int mode, const Drop& drop, void* ao, int chain,
           void* rqkv, void* rh1, cudaStream_t st) {
  auto kernel = rqkv != nullptr
                    ? (jas_kk > 0 ? vf_kernel<T, true, false, false, false, true>
                                  : vf_kernel<T, false, false, false, false,
                                              true>)
                : chain > 1  ? vf_kernel<T, false, false, true>
                : s.l2       ? (jas_kk > 0 ? vf_kernel<T, true, false, false,
                                                         true>
                                           : vf_kernel<T, false, false, false,
                                                       true>)
                : jas_kk > 0 ? vf_kernel<T, true, kDrop>
                             : vf_kernel<T, false, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(base),
      static_cast<T*>(out), static_cast<float*>(acc), ga, ba, gm, bm,
      static_cast<const T*>(wqkv), static_cast<const T*>(wout),
      static_cast<const T*>(w1), static_cast<const T*>(w2), qkvb, outb,
      static_cast<float*>(jas), static_cast<int*>(jas_idx), jas_kk, s,
      scaler, coef, qk_scale, mode, drop, static_cast<float*>(ao), chain,
      static_cast<T*>(rqkv), static_cast<T*>(rh1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Chooses the plan of one CTA: whether q, k and v of a head come from one
// product, the MLP chunk width and the shared memory, preferring the
// fused q|k|v product and wide chunks. `drop` asks for the dropout
// instance's plan, `l2` for the L2 instance's (kernels/vector_field.py::
// l2_plan repeats this rule in Python). Returns 0 when the shape has a
// plan, 1 when it has none (the wrapper raises).
int vf_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
            int drop, int l2, int* qkv_fused_out, int* hc_out,
            int* smem_out) {
  for (int fused = 1; fused >= 0; --fused) {
    for (int hc : kChunks) {
      const Shape s = make_shape(n_pad, n_real, d, heads, dh, hc, fused,
                                 drop != 0, l2 != 0);
      if (!shape_ok(s) || dh % hc) continue;
      const Plan p = make_plan(s, tbytes);
      if (p.total <= (size_t)kMaxSmem) {
        *qkv_fused_out = fused;
        *hc_out = hc;
        *smem_out = (int)p.total;
        return 0;
      }
    }
  }
  return 1;
}

// Launches one evaluation on `stream`; returns cudaGetLastError() after
// the launch (0 on success). mode: 0 plain, 1 euler, 2 base. jas_kk > 0
// also writes the JaSMin statistics ([B, H, 5, n_pad] f32) and their
// columns ([B, H, 4, n_pad] int32) of kk = k + 1 extraction passes. A
// non-null `drop` launches the dropout instance (planned with drop=1).
// chain > 1 runs `chain` Euler steps in one launch (mode 1, no
// statistics, no dropout). In f32 every instance runs vf_kernel_f32 on the
// plan of vf_plan_f32 (the passed qkv_fused, hc and smem are bf16's), and
// `acc` is its workspace: B * vf_plan_f32's ws_floats f32, apart from
// `out`; `ao` is unused.
// Non-null biases (qkvb [3D], outb [D], f32) launch the L2 instance
// (planned with l2=1): mode 0, no chain, no dropout. Non-null rqkv and rh1
// ([B * n_pad, 3D] and [B * n_pad, dh], x's dtype) launch the stash
// instance (the deterministic plan): mode 0, softmax, no chain, no
// dropout.
int vf_launch(int tbytes, const void* x, const void* base, void* out,
              void* acc, const float* ga, const float* ba, const float* gm,
              const float* bm, const void* wqkv, const void* wout,
              const void* w1, const void* w2, const float* qkvb,
              const float* outb, int batch, int n_pad, int n_real, int d,
              int heads, int dh, int qkv_fused, int hc, int smem,
              float scaler, float coef, float qk_scale, int mode, void* jas,
              void* jas_idx, int jas_kk, const Drop* drop, void* ao,
              int chain, void* rqkv, void* rh1, void* stream) {
  if (chain > 1 && (mode != 1 || jas_kk > 0 || drop != nullptr))
    return (int)cudaErrorInvalidValue;
  if (tbytes == 4 && (acc == nullptr || acc == out))
    return (int)cudaErrorInvalidValue;
  const bool l2 = qkvb != nullptr;
  if (l2 != (outb != nullptr) ||
      (l2 && (mode != 0 || chain > 1 || drop != nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((rqkv != nullptr) != (rh1 != nullptr) ||
      (rqkv != nullptr && (mode != 0 || chain > 1 || drop != nullptr || l2)))
    return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(n_pad, n_real, d, heads, dh, hc, qkv_fused,
                             drop != nullptr, l2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop none = {};
  const Drop& dr = drop != nullptr ? *drop : none;
#define VF_LAUNCH(T, D)                                                    \
  launch<T, D>(x, base, out, acc, ga, ba, gm, bm, wqkv, wout, w1, w2, qkvb, \
               outb, jas, jas_idx, jas_kk, batch, smem, s, scaler, coef,   \
               qk_scale, mode, dr, ao, chain, rqkv, rh1, st)
  if (tbytes == 2)
    return drop != nullptr ? VF_LAUNCH(bf16, true) : VF_LAUNCH(bf16, false);
#undef VF_LAUNCH
  // f32: vf_kernel_f32 on its own plan; `acc` is its workspace
  return launch_f32(
      static_cast<const float*>(x), static_cast<const float*>(base),
      static_cast<float*>(out), static_cast<float*>(acc), ga, ba, gm, bm,
      static_cast<const float*>(wqkv), static_cast<const float*>(wout),
      static_cast<const float*>(w1), static_cast<const float*>(w2), qkvb,
      outb, static_cast<float*>(jas), static_cast<int*>(jas_idx), jas_kk,
      batch, s, scaler, coef, qk_scale, mode, dr, drop != nullptr, chain,
      static_cast<float*>(rqkv), static_cast<float*>(rh1), st);
}

// The f32 instances' plan (vf_kernel_f32, see PlanF32), with the same
// flags as vf_plan: the accumulator in shared memory, the MLP chunk, the
// column block, the shared memory and the workspace's floats per image.
// Returns 0 when the shape has one, 1 when not.
int vf_plan_f32(int n_pad, int n_real, int d, int heads, int dh, int drop,
                int l2, int* acc_smem_out, int* hc_out, int* nb_out,
                int* smem_out, long long* ws_out) {
  const Shape s = make_shape(n_pad, n_real, d, heads, dh, 0, 1, drop != 0,
                             l2 != 0);
  PlanF32 p;
  if (!shape_ok(s) || !plan_f32(s, acc_smem_out, hc_out, nb_out, &p))
    return 1;
  *smem_out = (int)p.total;
  *ws_out = (long long)p.ws;
  return 0;
}

unsigned long long vf_f32_launches() { return f32_launches; }

const char* vf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // VF_HELPERS_ONLY
