// The tiled route of the fused vector-field evaluation and its backward,
// on Hopper (sm_90a), for shapes where one image does not fit one CTA.
//
// Replaces the TPU kernels odevit_tpu/kernels/vector_field.py::_vf_kernel
// (plain, Euler, stage-advance, JaSMin-statistics and attention-map modes,
// L2+bias, emit_masks, emit_resid) and
// odevit_tpu/kernels/vector_field_bwd.py::_vf_bwd_kernel (with the JaSMin
// cotangent and the attention-map cotangent; L2+bias; the stashed
// residuals) at shapes such as TS-Base
// (224 px, patch 16: 207 tokens padded to 208, D=768, 12 heads, dh=768),
// where one image's activations (320 KB for one bf16 [208, 768] tensor)
// exceed the 227 KB of shared memory that vector_field.cu and
// vector_field_bwd.cu keep one image in.
//
// The arithmetic is the one of vector_field.cu (the same rounding to the
// compute dtype, f32 accumulation, selection masks for padded keys); only
// the split of the work differs. Past 256 padded tokens (kMaxCols) the
// attention CTAs stream the keys in tiles (vft_attn_kt, vft_attn_keys_kt:
// see "key-tiled attention" below); every other kernel of the route tiles
// rows already and takes any n_pad. Rows >= n_real of each image read as
// zeros, so nothing a padded row holds reaches a real row or a cotangent;
// the attention map and the JaSMin statistics hold zeros on padded query
// rows, and x_bar holds zeros on padded rows.
//
// Forward, five launches:
//   vft_norm        cn_a, cn_m = round(CenterNorm(x)), one warp per row;
//   vft_gemm (x2)   qkv = round(cn_a Wqkv); h = round(gelu(cn_m W1));
//   vft_attn        one CTA per (image, head, query tile): K and V of the
//                   head in shared memory, f32 scores, softmax over the real
//                   keys, p rounded; the map (attention-map mode) or the
//                   JaSMin statistics and their columns; ctx = round(p v)
//                   (past kMaxCols padded tokens vft_attn_kt, and in bf16
//                   softmax vft_attn_kt_fwd: scores, p and ctx in mma.sync
//                   registers, K and V through a cp.async ring);
//   vft_gemm        out = round(scaler * ([ctx | h] [Wout; W2])), the two
//                   products summed in one f32 accumulator; the Euler and
//                   stage-advance modes (the TPU kernel's euler_dt and
//                   base, reached through fused_euler_step_from_params and
//                   fused_rk4_step_from_params) read x or the stage base
//                   per element in this epilogue and write round(x + dt
//                   (scaler acc)) or round(base + dt (scaler acc)), summed
//                   in f32 as vector_field.cu's epilogue sums: one 20 MB
//                   read more at TS-Base and B=64, no elementwise pass.
// Backward, twelve launches, no atomics (two runs are bit-identical):
//   vft_norm        cn_a, cn_m, the row means, gd = round(g * scaler);
//   vft_gemm (x4)   h1 (f32) and h; qkv; h1_bar = round((gd W2^T)
//                   gelu'(h1)); cb = round(gd Wout^T);
//   vft_attn<bwd>   per (image, head, query tile): p recomputed, ctx,
//                   p_bar = cb v^T + g_attn + the JaSMin scatter onto the
//                   saved columns, s_bar = round(p (p_bar - sum p p_bar)),
//                   q_bar = round(s_bar k tau); p and s_bar go to global
//                   scratch (past kMaxCols padded tokens vft_attn_kt<bwd>,
//                   and in bf16 softmax vft_attn_kt_bwd: scores and
//                   accumulators in mma.sync registers, K and V through a
//                   cp.async ring, the keep bits drawn once);
//   vft_attn_keys   per (image, head, key tile): k_bar = round(s_bar^T
//                   round(q tau)), v_bar = round(p^T cb) (past kMaxCols
//                   vft_attn_keys_kt, in bf16 softmax vft_attn_keys_kt2);
//   vft_gemm (x2)   a_bar = [q_bar k_bar v_bar] Wqkv^T, m_bar = h1_bar W1^T
//                   (f32);
//   vft_norm_bwd    x_bar and the per-image partial sums of the four norm
//                   cotangents;
//   vfb_wgrad_*, vfb_reduce (from vector_field_bwd.cu): the four weight
//                   cotangents as split-K products with per-split partials,
//                   then a fixed-order reduce of the weight and norm
//                   partials.
//
// Products. In bf16 vft_gemm is vft_gemm_wgmma: a persistent CTA whose
// two warpgroups take turns on wgmma with their own 128x128 tiles, fed by
// a TMA ring from a producer warpgroup, 16-byte epilogues (see there). In f32 (the main path of a
// Macaron model, whose states are f32) it is vft_gemm_tf32: split TF32 in
// three passes on wgmma, operands staged by cp.async, A split in
// registers and B once into swizzled K-major planes (see there). The
// whole-row attention kernels use vector_field.cu's WMMA helper (vf::mm)
// in bf16 and its split-TF32 twin (vf::mm_f32, split_tf32.cuh) in f32;
// the key-tiled f32 CTAs still run vf::mm's f32 loops on the CUDA cores.
// Nothing goes to a library.
//
// Bound. At TS-Base and B=64 one evaluation does ~102 GFLOP (0.10 ms at
// 989 TFLOP/s in bf16) and one backward ~3x that; operations, not bytes,
// bound both. Intermediates stay in device memory between launches.
//
// Dropout (the TPU kernels' fused_vf_dropout, fused_vf_jasmin_dropout,
// fused_vf_attn_dropout and _vf_bwd_kernel with a seed). Instances
// compiled apart (template flag kDrop, runtime `drop` of TiledArgs) draw
// the masks of vector_field.cu's stream, so the bits are those of the
// one-image-per-CTA kernels and of dropout_masks.cu: a flattened row r is
// row r % n_pad of image r / n_pad. Where they apply, as the XLA twin:
//   forward   h = round(round(gelu(h1)) mask_h) in the GELU epilogue;
//             ctx from round(round(p) mask_p), the map and the JaSMin
//             statistics from the pre-dropout p; the output product in
//             two passes, attn_o = ctx Wout into f32, then out =
//             round(scaler (mask_mo (h W2) + mask_ao attn_o)) in the
//             epilogue of the second (one f32 accumulator cannot carry
//             two masks);
//   backward  two cotangent operands, gd = round(g scaler mask_mo) (W2
//             and h1_bar, W2_bar) and gd2 = round(g scaler mask_ao) (cb,
//             Wout_bar); h1_bar = round((gd W2^T) mask_h gelu'(h1)); the
//             masked h for W2_bar; p_bar = mask_p (cb v^T) + g_attn + the
//             JaSMin scatter (the latter two on the pre-dropout p), the
//             keep bits of the query tile kept in shared memory between
//             the two; v_bar from the masked p.
// emit_masks (the TPU kernel's, :221-223, :252-261, :355, :370): the
// forward's dropout instance also writes each mask it draws, as f32 kept
// values (1 / (1 - rate) or 0; 0 on padded rows and keys), from the
// epilogue that applies it: mask_h from the GELU epilogue, mask_mo and
// mask_ao from the output pass, mask_p from vft_attn.
//
// L2 attention (the TPU kernel's l2_attention with biases, :293-301,
// :260-261, :364-365, and _vf_bwd_kernel's L2 branch): instances compiled
// apart (template flag kL2, chosen by non-null biases) in the plain and
// JaSMin modes, without dropout. The qkv product's epilogue adds the f32
// qkv_bias before rounding, the output product's adds out_bias to the f32
// sum of both products before the scaler. vft_attn takes the f32 row norms
// q2 (its query tile) and k2 (every key) of the rounded q and k, and p =
// round(e / (sum e + 1e-8)), e = exp(-(q2 + k2 - 2 q.k) tau) over the
// real keys: the expanded form, as the TPU kernel, and no max. Its
// backward, as vector_field_bwd.cu's one-CTA kL2 instances: e_bar = (p_bar -
// sum p_bar p) / esum, d2b = -tau e e_bar (f32), q_bar = round(2 q rsum -
// 2 round(d2b) k) in vft_attn, k_bar = round(2 k csum - 2 round(d2b)^T q)
// in vft_attn_keys, with rsum a row's sum of d2b and csum a key's column
// sum, the query tiles' partials (l2cs) summed in order; the biases'
// cotangents are per-image column sums of [q_bar k_bar v_bar] and of gd
// (vft_norm_bwd) in the fixed-order reduce, so repeats stay
// bit-identical.
//
// Residual stash (the TPU kernels' emit_resid and has_resid; softmax, no
// dropout). Forward: the qkv scratch is already round(cn_a Wqkv) of every
// row, so the caller keeps it as rqkv (a buffer of its own for each
// evaluation); the kGelu epilogue also writes rh1 = round(h1), the
// pre-GELU hidden, in the compute dtype (TiledArgs::rh1). Backward with
// rqkv and rh1: the qkv and h1 products are skipped, and with them the f32
// h1 scratch (164 MB at TS-Base ratio 1 and B=64). The kGeluGradResid
// epilogue of the h_bar product reads rh1 and writes both h1_bar =
// round(h_bar gelu'(h1)) and h = round(gelu(h1)), the operand of W2_bar:
// folded there rather than in a pass of its own, rh1 is read once and no
// launch is added. The attention kernels read q, k and v from rqkv, with
// padded rows of q and k (as of v, always) read as zeros, and so does the
// epilogue with padded rows of rh1: a NaN there reaches no cotangent.
//
// macaron_tiled.cu runs the Macaron field on these products and attention
// kernels: kGelu adds a bias (b1) before the GELU, kMacResid writes the
// f32 state x + alpha rs (v + bias) (and v + bias itself), kMacOut the
// last residual step's round(scaler x3) or its Euler / stage update.
//
// The product epilogues draw one Philox call per 4 columns of a row (both
// product kernels stage their whole tile in shared memory first, so a
// thread takes a row's 4 or 8 consecutive columns whatever the fragment
// layout).
// Masks add ~16 M Philox calls per forward at B=64, drawn between
// barriers: below the products' bound on the FMA pipe, but they add to
// the time rather than hide under it.

#define VFB_KERNELS_ONLY
#include "vector_field_bwd.cu"
#include "split_tf32.cuh"

namespace vft {

using namespace nvcuda;
using vf::bf16;

constexpr int kMaxCols = 256;           // whole rows: 8 columns per lane
constexpr int kQTiles[] = {64, 32, 16};  // query-tile rows, largest first
constexpr int kKeyTile = 64;

// ---------------------------------------------------------------- norms

// cn_a, cn_m = round(((x - mean) d/(d-1)) gamma + beta), one warp per row;
// rows >= n_real of each image read as zeros. With `mean`, the row means
// are stored; with `gd`, gd = round(g * scaler) (zeros on padded rows).
// kDrop: gd = round(g * scaler * mask_mo) and gd2 = round(g * scaler *
// mask_ao), a Philox call per 4 columns and site.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(256)
vft_norm(const T* __restrict__ x, const T* __restrict__ g, int rows,
         int n_pad, int n_real, int d, const float* __restrict__ ga,
         const float* __restrict__ ba, const float* __restrict__ gm,
         const float* __restrict__ bm, T* cna, T* cnm, float* mean, T* gd,
         float scaler, T* gd2, vf::Drop drop) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * 8 + warp;
  if (r >= rows) return;
  const bool real = r % n_pad < n_real;
  const T* row = x + (size_t)r * d;
  const float scale = (float)((double)d / (d - 1.0));
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32) sum += real ? vf::to_f(row[c]) : 0.0f;
  const float mu = vf::warp_sum(sum) / d;
  if (mean != nullptr && lane == 0) mean[r] = mu;
  for (int c = lane; c < d; c += 32) {
    const float xv = real ? vf::to_f(row[c]) : 0.0f;
    const float cent = (xv - mu) * scale;
    const size_t i = (size_t)r * d + c;
    cna[i] = vf::from_f<T>(cent * ga[c] + ba[c]);
    cnm[i] = vf::from_f<T>(cent * gm[c] + bm[c]);
    if (!kDrop && gd != nullptr)
      gd[i] = vf::from_f<T>(real ? vf::to_f(g[i]) * scaler : 0.0f);
  }
  if (kDrop && gd != nullptr) {
    const unsigned img = r / n_pad, row = r % n_pad;
    const unsigned kmo = vf::site_key(drop.seed, vf::kSiteMlpOut);
    const unsigned kao = vf::site_key(drop.seed, vf::kSiteAttnOut);
    for (int q = lane; 4 * q < d; q += 32) {
      float mo[4] = {1.0f, 1.0f, 1.0f, 1.0f}, ma[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (real && drop.th_m)
        vf::keep4(kmo, img, row, q, d, drop.th_m, drop.sc_m, mo);
      if (real && drop.th_ao)
        vf::keep4(kao, img, row, q, d, drop.th_ao, drop.sc_ao, ma);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t i = (size_t)r * d + 4 * q + j;
        const float gv = real ? vf::to_f(g[i]) * scaler : 0.0f;
        gd[i] = vf::from_f<T>(gv * mo[j]);
        gd2[i] = vf::from_f<T>(gv * ma[j]);
      }
    }
  }
}

// x_bar = d/(d-1) (c_bar - mean(c_bar)), c_bar = a_bar gamma_a + m_bar
// gamma_m, zeros on padded rows; then this image's partial sums of
// (a_bar cent, a_bar, m_bar cent, m_bar) over its real rows, and with L2
// (qkvb given) those of [q_bar k_bar v_bar] and of gd, the biases'
// cotangents, in x's dtype as written. One CTA per image.
template <typename T>
__global__ void __launch_bounds__(vf::kThreads)
vft_norm_bwd(const float* __restrict__ abar, const float* __restrict__ mbar,
             const T* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ ga, const float* __restrict__ gm,
             T* xbar, float* npart, int n_pad, int n_real, int d,
             const T* __restrict__ qkvb = nullptr,
             const T* __restrict__ gd = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)blockIdx.x * n_pad;
  const float scale = (float)((double)d / (d - 1.0));
  for (int r = warp; r < n_pad; r += vf::kWarps) {
    const size_t o = (row0 + r) * d;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32)
      sum += abar[o + c] * ga[c] + mbar[o + c] * gm[c];
    const float cm = vf::warp_sum(sum) / d;
    for (int c = lane; c < d; c += 32) {
      const float cbar = abar[o + c] * ga[c] + mbar[o + c] * gm[c];
      xbar[o + c] = vf::from_f<T>(r < n_real ? scale * (cbar - cm) : 0.0f);
    }
  }
  float* np = npart + (size_t)blockIdx.x * (qkvb != nullptr ? 8 : 4) * d;
  if (qkvb != nullptr) {
    for (int c = threadIdx.x; c < 3 * d; c += vf::kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r)
        sum += vf::to_f(qkvb[(row0 + r) * 3 * d + c]);
      np[4 * d + c] = sum;
    }
    for (int c = threadIdx.x; c < d; c += vf::kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += vf::to_f(gd[(row0 + r) * d + c]);
      np[7 * d + c] = sum;
    }
  }
  for (int c = threadIdx.x; c < d; c += vf::kThreads) {
    float sa1 = 0.0f, sa0 = 0.0f, sm1 = 0.0f, sm0 = 0.0f;
    for (int r = 0; r < n_real; ++r) {
      const size_t i = (row0 + r) * d + c;
      const float cent = (vf::to_f(x[i]) - mean[row0 + r]) * scale;
      sa1 += abar[i] * cent;
      sa0 += abar[i];
      sm1 += mbar[i] * cent;
      sm0 += mbar[i];
    }
    np[c] = sa1;
    np[d + c] = sa0;
    np[2 * d + c] = sm1;
    np[3 * d + c] = sm0;
  }
}

// ---------------------------------------------------------------- GEMM

// What each epilogue writes from the f32 sum v, round() to x's dtype:
// kRound round(v (+ bias)); kScale round((v (+ bias)) scale); kGelu, h1 =
// v (+ bias): out = round(gelu(h1)), out32 = h1, out2 = round(h1) (each
// optional); kGeluGrad round(v gelu'(aux)); kF32 out32 = v.
enum Epilogue { kRound = 0, kGelu = 1, kScale = 2, kGeluGrad = 3, kF32 = 4,
                // the dropout epilogues (vft_gemm_*<BT, true>): out =
                // round(round(gelu(v)) mask0) and out32 = v, round(v mask0
                // gelu'(aux)), round(scale (v mask0 + aux mask1))
                kGeluDrop = 5, kGeluGradDrop = 6, kOutDrop = 7,
                // the Euler and stage-advance output: round(res + dt
                // (scale v)), res = x (Euler) or the stage base
                kAdvance = 8,
                // the Macaron field's residual steps (macaron_tiled.cu), f
                // = v + bias in f32: kMacResid writes fout = f and out32 =
                // aux + alpha rs f; kMacOut writes round(scale x3), or
                // round(res + dt (scale x3)), x3 = aux + alpha rs f
                kMacResid = 9, kMacOut = 10,
                // the stash backward: h1 = f32(res) (rh1, x's dtype, ldo; 0
                // on padded rows), out = round(v gelu'(h1)), out2 =
                // round(gelu(h1))
                kGeluGradResid = 11 };

// C[m, n] = sum over pairs of A_p[m, :] B_p[:, n]; A row-major (lda), B
// row-major [K, N] (ldb) or, with BT, stored transposed [N, K]. M and N
// are multiples of 16, every K a multiple of 16, every leading dimension a
// multiple of 8 (16-byte rows).
struct GemmArgs {
  const void* a[2];
  const void* b[2];
  int lda[2], ldb[2], k[2];
  int pairs, m, n;
  int epi;
  void* out;         // x's dtype
  int ldo;
  float* out32;      // f32 (kGelu: the pre-GELU value, optional; kF32)
  int ld32;
  void* out2;        // x's dtype, ldo (kGelu: round(h1), the stash's rh1,
                     // optional; kGeluGradResid: h)
  const float* aux;  // kGeluGrad: the pre-GELU value h1; kOutDrop: attn_o
  int ldaux;
  float scale;
  const void* res;   // kAdvance: x or the stage base, x's dtype, ldo;
                     // kGeluGradResid: rh1
  float dt;          // kAdvance
  // dropout epilogues: the keep masks of up to two sites over the output
  // (kGeluDrop, kGeluGradDrop: mask_h; kOutDrop: mask_mo, mask_ao), th 0
  // where a site has no dropout; output row m is row m % n_pad of image
  // m / n_pad (kGeluGradResid: its padded rows)
  unsigned key[2], th[2];
  float sc[2];
  int n_pad, n_real;
  // L2: the f32 bias added to the accumulator before kRound / kScale
  const float* bias;
  // emit_masks: the kept values of masks 0 and 1, f32 [m, n], or null
  float* mask[2];
  // kMacResid, kMacOut: rs (read on the device), its factor, and f (f32,
  // ld32; optional)
  const float* rs;
  float alpha;
  float* fout;
};

// mask[j]: the kept value of column 4 grp + j of output row m under mask i
// of a dropout epilogue; 1 where the site has no dropout, 0 on padded rows
__device__ __forceinline__ void gemm_keep4(const GemmArgs& g, int i, int m,
                                           int grp, float mask[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mask[j] = g.th[i] ? 0.0f : 1.0f;
  const int row = m % g.n_pad;
  if (g.th[i] && row < g.n_real)
    vf::keep4(g.key[i], m / g.n_pad, row, grp, g.n, g.th[i], g.sc[i], mask);
}

// The WMMA product mainloop of vector_field_bwd_split.cu's vfs_hidden_bf16
// (two chained products a CTA): a 128x128 tile of 8 warps, each warp 64x32
// in WMMA fragments (16x16x16, f32 accumulators), K in steps of 32 staged
// through shared memory with the next step's loads held in registers.
constexpr int kBM = 128, kBN = 128, kBK = 32, kGThreads = 256;
constexpr int kLdA = kBK + 8;   // shared rows padded by 16 bytes
constexpr int kLdB = kBN + 8;
constexpr int kLdE = 20;

template <bool BT>
__device__ __forceinline__ void gemm_fetch(const GemmArgs& g, int p, int k0,
                                           int m0, int n0, uint4 (&ra)[2],
                                           uint4 (&rb)[2]) {
  const bf16* A = static_cast<const bf16*>(g.a[p]);
  const bf16* B = static_cast<const bf16*>(g.b[p]);
  const int K = g.k[p];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kGThreads;
    const int row = v >> 2, c8 = (v & 3) * 8;
    ra[i] = m0 + row < g.m && k0 + c8 < K
                ? *reinterpret_cast<const uint4*>(
                      A + (size_t)(m0 + row) * g.lda[p] + k0 + c8)
                : zero;
    if (BT) {
      rb[i] = n0 + row < g.n && k0 + c8 < K
                  ? *reinterpret_cast<const uint4*>(
                        B + (size_t)(n0 + row) * g.ldb[p] + k0 + c8)
                  : zero;
    } else {
      const int kr = v >> 4, n8 = (v & 15) * 8;
      rb[i] = k0 + kr < K && n0 + n8 < g.n
                  ? *reinterpret_cast<const uint4*>(
                        B + (size_t)(k0 + kr) * g.ldb[p] + n0 + n8)
                  : zero;
    }
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// The 128x128 output tile at (m0, n0) of the product g into the
// accumulators c of this warp (rows wm 64 + 16 i, columns wn 32 + 16 j,
// wm = warp / 4, wn = warp % 4), staged through As and Bs (kBM * kLdA
// elements each). Ends with a barrier: As and Bs are free again.
template <bool BT>
__device__ __forceinline__ void gemm_mainloop(const GemmArgs& g, int m0,
                                              int n0, bf16* As, bf16* Bs,
                                              Acc (&c)[4][2]) {
  using BLayout =
      typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int nk0 = (g.k[0] + kBK - 1) / kBK;
  const int nk1 = g.pairs > 1 ? (g.k[1] + kBK - 1) / kBK : 0;
  const int steps = nk0 + nk1;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  uint4 ra[2], rb[2];
  gemm_fetch<BT>(g, 0, 0, m0, n0, ra, rb);
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + i * kGThreads;
      *reinterpret_cast<uint4*>(As + (v >> 2) * kLdA + (v & 3) * 8) = ra[i];
      if (BT)
        *reinterpret_cast<uint4*>(Bs + (v >> 2) * kLdA + (v & 3) * 8) = rb[i];
      else
        *reinterpret_cast<uint4*>(Bs + (v >> 4) * kLdB + (v & 15) * 8) =
            rb[i];
    }
    __syncthreads();
    if (t + 1 < steps) {
      const int p = t + 1 < nk0 ? 0 : 1;
      const int kt = p ? t + 1 - nk0 : t + 1;
      gemm_fetch<BT>(g, p, kt * kBK, m0, n0, ra, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        if (BT)
          wmma::load_matrix_sync(fb[j], Bs + col * kLdA + kk, kLdA);
        else
          wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + col, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 64 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], fa, fb[j], c[i][j]);
      }
    }
    __syncthreads();
  }
}

// ---- the bf16 products: vft_gemm_wgmma ----
//
// Replaces no TPU kernel of its own: it is the product layer of this
// route, which replaces the products inside the TPU kernels
// odevit_tpu/kernels/vector_field.py::_vf_kernel, vector_field_bwd.py::
// _vf_bwd_kernel, _mlp_bwd_kernel and _attn_bwd_kernel, and macaron.py's
// _macaron_kernel and _macaron_bwd_kernel (each a jnp.dot inside the
// Pallas kernel). Every bf16 vft::gemm launches it: the tiled and
// key-tiled forwards and backwards, the split backward's products and the
// tiled bf16 Macaron route.
//
// Bound. 2 M N K operations at 989 TFLOP/s against (M K + K N + M N) 2
// bytes at 3.35 TB/s: operations bound every shape the route launches;
// the 384 px qkv product (37,888 x 2,304 x 768) is 134 GFLOP, 0.136 ms,
// against 0.070 ms of bytes. The epilogues that read or write f32 [M, N]
// (kGeluGrad's h1, kF32, kGelu's out32) move up to three times those
// bytes and come near the line.
//
// Design. A persistent CTA an SM (grid: the SMs or the tiles, the fewer)
// walks the output tiles t = blockIdx.x, + gridDim.x, ... (N fastest, so
// the CTAs at work share their rows of A in L2). Two consumer warpgroups
// take the CTA's tiles in turn, each its own 128 x 128 tile (two wgmma
// m64n128k16 a k step), all of K in one f32 accumulator in registers (as the WMMA kernel this one
// replaced summed it: K is at most d + dh = 3,840 here, where the tensor
// cores' truncated sums err below 1e-5 of the output scale). A producer
// warpgroup (one thread at work, its registers handed to the consumers by
// setmaxnreg) keeps a ring of stages in flight by TMA (128-byte swizzle,
// one mbarrier pair a stage): a stage is kWgK = 64 of K, A's 128 x 64
// box (K-major) and B's, either one 128 x 64 box of a B stored [N, K]
// (K-major) or two boxes of 64 x 64 of a B stored [K, N] (MN-major, read
// through the descriptor's transpose bit). Two pairs: the producer
// walks pair 0's slices, then pair 1's, into the same accumulator. The
// TMA zero fill covers ragged M, N and K. The warpgroups take turns on
// the tensor cores (a turn barrier: one starts its tile's products once
// the other has all of its stages), so one warpgroup's epilogue runs
// while the other's products do. The epilogue takes the tile in four 64
// x 64 chunks through a staging buffer of the warpgroup (16-byte chunks
// XOR-swizzled by row: the fragments' stores and the rows' reads on
// distinct banks); each thread then runs the epilogue on eight
// consecutive columns of a row, one Philox call per four columns in the
// dropout epilogues (drawn as keep bits a chunk at a time), and writes 16
// bytes of bf16 or two times 16 of f32. What the epilogue reads of [M, N] (aux f32 or res bf16) a second
// producer thread brings by TMA, chunk by chunk, into four buffers that
// the previous tile's epilogue frees chunk by chunk, so a tile's inputs
// land while its products run.
// No split of K across CTAs and no atomics: two runs give the same bits,
// and a product the backward recomputes (qkv, h1) equals the forward's.
constexpr int kWgM = 128, kWgN = 128;  // a warpgroup's tile
constexpr int kWgK = 64;               // K of a stage: 128 bytes of bf16
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 256;      // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer's
constexpr int kWgABytes = kWgM * kWgK * 2;      // A's box of a stage
constexpr int kWgStageBytes = kWgABytes + kWgN * kWgK * 2;
constexpr int kWgInBytes = 64 * 1024;     // four chunks' epilogue inputs
constexpr int kWgStageOut = 64 * 64 * 4;  // a warpgroup's staged chunk
constexpr int kWgRegsProducer = 40, kWgRegsConsumer = 232;  // setmaxnreg
// the ring, the epilogue's input chunks, the two staging buffers, room to
// start them on a 1024-byte boundary, the barriers
constexpr int kWgSmem = kWgStages * kWgStageBytes + kWgInBytes +
                        2 * kWgStageOut + 1024 + 8 * (2 * kWgStages + 10);
static_assert(kWgSmem <= 232448, "one CTA an SM: 227 KB of shared memory");
static_assert(4 * 64 * 64 * 4 <= kWgInBytes,
              "four f32 input chunks fit their buffers");
static_assert(kWgRegsConsumer * kWgConsumers + kWgRegsProducer * 128 <=
                  65536,
              "the register file");

// The tensor maps of a launch: a[p] A [M, K] in 64 x 128 boxes; b[p] B [N,
// K] in 64 x 128 boxes, or B [K, N] in 64 x 64 boxes; in, the epilogue's
// input [M, N] (aux f32 in 32 x 64 boxes, or res bf16 in 64 x 64).
struct WgMaps {
  CUtensorMap a[2], b[2], in;
};

// What the epilogue reads of [M, N], brought by TMA: 1 aux (f32; kMacOut
// reads res from device memory), 2 res (bf16), 0 nothing.
__host__ __device__ inline int wg_input(const GemmArgs& g) {
  switch (g.epi) {
    case kGeluGrad:
    case kGeluGradDrop:
    case kOutDrop:
    case kMacOut:
      return 1;
    case kMacResid:
      return g.out32 != nullptr ? 1 : 0;
    case kAdvance:
    case kGeluGradResid:
      return 2;
    default:
      return 0;
  }
}

// The descriptor of a B stored [K, N] (MN-major) stage: 64-column boxes of
// kWgK rows of 128 bytes, 128-byte swizzle; boxes 8 KB apart (the leading,
// N, offset), 8-row groups 1024 bytes apart (the stride, K, offset).
__device__ __forceinline__ uint64_t wg_mn_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((64 * kWgK * 2) >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (+)= a b for a 64 x 128 tile, k = 16, bf16 operands from shared memory
// (a K-major, b K-major or, with kTransB, MN-major), f32 accumulators:
// d[4 j + 2 h + e] holds row 16 warp + lane / 4 + 8 h and column 8 j +
// 2 (lane % 4) + e; accumulate = 0 ignores d.
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_m64n128(float (&d)[64], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// The epilogue (enum Epilogue; the dropout ones with kDrop) of columns n
// .. n + 7 of output row m: v the products, a the aux and t the res values
// where the epilogue reads them, b0 and b1 the dropout epilogues' keep
// bits (wg_keep_word: bit q for column n + q). Every value is f32 until it
// is written; bf16 buffers take 16-byte stores, f32 ones two.
template <bool kDrop>
__device__ __forceinline__ void epilogue8(const GemmArgs& g, int m, int n,
                                          const float (&v)[8],
                                          const float (&a)[8],
                                          const float (&t)[8], uint32_t b0,
                                          uint32_t b1) {
  auto st = [](void* p, size_t i, const float (&r)[8]) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(r[0], r[1], r[2], r[3]);
    q[1] = make_float4(r[4], r[5], r[6], r[7]);
  };
  auto st16 = [](void* p, size_t i, const float (&r)[8]) {
    uint4 w;
    bf16* e = reinterpret_cast<bf16*>(&w);
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = vf::from_f<bf16>(r[q]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p) + i) = w;
  };
  const size_t o = (size_t)m * g.ldo + n, s = (size_t)m * g.ld32 + n;
  const bool bias = g.bias != nullptr;
  float r[8], f[8], b[8] = {};
  if (bias) {
    const float4* q = reinterpret_cast<const float4*>(g.bias + n);
    const float4 x = q[0], y = q[1];
    b[0] = x.x, b[1] = x.y, b[2] = x.z, b[3] = x.w;
    b[4] = y.x, b[5] = y.y, b[6] = y.z, b[7] = y.w;
  }
  if (kDrop) {
    // kept: the site's scale (1 where it has no dropout); dropped or a
    // padded row: 0
    float k0[8], k1[8];
    const float s0 = g.th[0] ? g.sc[0] : 1.0f;
    const float s1 = g.th[1] ? g.sc[1] : 1.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      k0[q] = (b0 >> q) & 1u ? s0 : 0.0f;
      k1[q] = g.epi == kOutDrop ? ((b1 >> q) & 1u ? s1 : 0.0f) : 1.0f;
    }
    switch (g.epi) {
      case kGeluDrop:  // round(round(gelu(h1)) mask_h)
        if (g.out32 != nullptr) st(g.out32, s, v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          r[q] = vf::to_f(vf::from_f<bf16>(vf::gelu(v[q]))) * k0[q];
        st16(g.out, o, r);
        break;
      case kGeluGradDrop:
#pragma unroll
        for (int q = 0; q < 8; ++q)
          r[q] = v[q] * k0[q] * vf::gelu_grad(a[q]);
        st16(g.out, o, r);
        break;
      default:  // kOutDrop
#pragma unroll
        for (int q = 0; q < 8; ++q)
          r[q] = (v[q] * k0[q] + a[q] * k1[q]) * g.scale;
        st16(g.out, o, r);
        break;
    }
    if (g.mask[0] != nullptr) st(g.mask[0], (size_t)m * g.n + n, k0);
    if (g.mask[1] != nullptr) st(g.mask[1], (size_t)m * g.n + n, k1);
    return;
  }
  switch (g.epi) {
    case kRound:
    case kScale:
#pragma unroll
      for (int q = 0; q < 8; ++q)
        r[q] = (bias ? v[q] + b[q] : v[q]) * (g.epi == kScale ? g.scale
                                                              : 1.0f);
      st16(g.out, o, r);
      break;
    case kGelu:
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        f[q] = bias ? v[q] + b[q] : v[q];
        r[q] = vf::gelu(f[q]);
      }
      if (g.out32 != nullptr) st(g.out32, s, f);
      if (g.out2 != nullptr) st16(g.out2, o, f);
      st16(g.out, o, r);
      break;
    case kGeluGradResid: {
      const bool real = m % g.n_pad < g.n_real;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float h1 = real ? t[q] : 0.0f;
        r[q] = v[q] * vf::gelu_grad(h1);
        f[q] = vf::gelu(h1);
      }
      st16(g.out, o, r);
      st16(g.out2, o, f);
      break;
    }
    case kGeluGrad:
#pragma unroll
      for (int q = 0; q < 8; ++q) r[q] = v[q] * vf::gelu_grad(a[q]);
      st16(g.out, o, r);
      break;
    case kAdvance:
#pragma unroll
      for (int q = 0; q < 8; ++q) r[q] = t[q] + g.dt * (v[q] * g.scale);
      st16(g.out, o, r);
      break;
    case kMacResid:
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = v[q] + b[q];
      if (g.fout != nullptr) st(g.fout, s, f);
      if (g.out32 != nullptr) {
#pragma unroll
        for (int q = 0; q < 8; ++q) r[q] = a[q] + g.alpha * g.rs[0] * f[q];
        st(g.out32, s, r);
      }
      break;
    case kMacOut:
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        f[q] = (a[q] + g.alpha * g.rs[0] * (v[q] + b[q])) * g.scale;
        r[q] = g.res != nullptr ? t[q] + g.dt * f[q] : f[q];
      }
      st16(g.out, o, r);
      break;
    default:  // kF32
      st(g.out32, s, v);
      break;
  }
}

// Chunk C of a warpgroup's tile (rows 64 (C / 2), columns 64 (C % 2), 64
// x 64) from its accumulators into the staging buffer `stg`: f32 rows of
// 256 bytes, 16-byte chunk c of row r at c ^ (r % 8).
template <int C>
__device__ __forceinline__ void wg_stage(const float (&acc)[2][64],
                                         unsigned char* stg) {
  constexpr int rh = C / 2, j0 = 8 * (C % 2);
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = 2 * j + (lane % 4) / 2;
      *reinterpret_cast<float2*>(stg + r * 256 + ((c ^ (r & 7)) << 4) +
                                 8 * (lane % 2)) =
          make_float2(acc[rh][4 * (j0 + j) + 2 * h],
                      acc[rh][4 * (j0 + j) + 2 * h + 1]);
    }
}

// The keep bits of this thread's four groups of eight columns of chunk c
// (its steps 0-3) of the tile at (m0, n0) under mask s of a dropout
// epilogue: bit 8 step + q set where column q of the step's group keeps a
// nonzero value (gemm_keep4).
__device__ __forceinline__ uint32_t wg_keep_word(const GemmArgs& g, int s,
                                                 int m0, int n0, int c) {
  const int tid = threadIdx.x % 128;
  uint32_t word = 0u;
#pragma unroll 1
  for (int step = 0; step < 4; ++step) {
    const int i = tid + 128 * step;
    const int m = m0 + 64 * (c / 2) + i / 8;
    const int n = n0 + 64 * (c % 2) + 8 * (i % 8);
    if (m >= g.m || n >= g.n) continue;
    float k[8];
    gemm_keep4(g, s, m, n >> 2, k);
    gemm_keep4(g, s, m, (n >> 2) + 1, k + 4);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      word |= (k[q] != 0.0f ? 1u : 0u) << (8 * step + q);
  }
  return word;
}

// A warpgroup's tile at (m0, n0), the CTA's tile i, through the
// epilogue, chunk by chunk: staged (wg_stage), then eight columns of a row
// a thread and step, with what the epilogue reads from the chunk's input
// buffer in[c] (16 KB each; TMA's 128-byte swizzle: 16-byte chunk j of row
// r of a box at j ^ (r % 8)); the dropout epilogues' keep bits drawn a
// chunk at a time (wg_keep_word).
template <bool kDrop>
__device__ __forceinline__ void wg_epilogue(
    const GemmArgs& g, const float (&acc)[2][64], int m0, int n0, int i,
    const unsigned char* in, uint64_t* in_full, uint64_t* in_empty,
    unsigned char* stg, int input) {
  const int tid = threadIdx.x % 128, bar = 2 + threadIdx.x / 128;
  auto chunk = [&](int c) {
    // the chunk before is read: the buffer is free
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    switch (c) {
      case 0: wg_stage<0>(acc, stg); break;
      case 1: wg_stage<1>(acc, stg); break;
      case 2: wg_stage<2>(acc, stg); break;
      default: wg_stage<3>(acc, stg); break;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    const unsigned char* buf = in + c * (kWgInBytes / 4);
    if (input) {
      // the other warpgroup is done with this buffer's previous chunk, so
      // the next completion of in_full[c] is this tile's
      if (i > 0) mbar_wait(&in_empty[c], (i - 1) & 1);
      mbar_wait(&in_full[c], i & 1);
    }
    const int rb = 64 * (c / 2), cb = 64 * (c % 2);
    // this chunk's keep bits, 8 a step
    uint32_t bits[2] = {0u, 0u};
    if (kDrop) {
      bits[0] = wg_keep_word(g, 0, m0, n0, c);
      if (g.epi == kOutDrop) bits[1] = wg_keep_word(g, 1, m0, n0, c);
    }
#pragma unroll 1
    for (int e = tid; e < 64 * 8; e += 128, bits[0] >>= 8, bits[1] >>= 8) {
      const int r = e / 8, lc = 8 * (e % 8);
      const int m = m0 + rb + r, n = n0 + cb + lc;
      if (m >= g.m || n >= g.n) continue;
      // lanes 4-7 of each eight read their upper half first: the 16-byte
      // reads of eight lanes on distinct banks
      const int up = (e >> 2) & 1, ck = 2 * (e % 8);
      const unsigned char* row = stg + r * 256;
      const float4 x = *reinterpret_cast<const float4*>(
          row + (((ck + up) ^ (r & 7)) << 4));
      const float4 y = *reinterpret_cast<const float4*>(
          row + (((ck + 1 - up) ^ (r & 7)) << 4));
      const float4 lo = up ? y : x, hi = up ? x : y;
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float a[8], t[8];
      if (input == 1) {
        const unsigned char* ar = buf + (lc / 32) * 8192 + r * 128;
        const int j = (lc % 32) / 4;
        const float4 x0 = *reinterpret_cast<const float4*>(
            ar + ((j ^ (r & 7)) << 4));
        const float4 x1 = *reinterpret_cast<const float4*>(
            ar + (((j + 1) ^ (r & 7)) << 4));
        a[0] = x0.x, a[1] = x0.y, a[2] = x0.z, a[3] = x0.w;
        a[4] = x1.x, a[5] = x1.y, a[6] = x1.z, a[7] = x1.w;
      }
      const bool res =
          !kDrop && (input == 2 || (g.epi == kMacOut && g.res != nullptr));
      if (res) {
        const uint4 raw =
            input == 2
                ? *reinterpret_cast<const uint4*>(
                      buf + r * 128 + (((lc / 8) ^ (r & 7)) << 4))
                : *reinterpret_cast<const uint4*>(
                      static_cast<const bf16*>(g.res) + (size_t)m * g.ldo +
                      n);
        const bf16* w = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) t[q] = vf::to_f(w[q]);
      }
      epilogue8<kDrop>(g, m, n, v, a, t, bits[0] & 0xFFu, bits[1] & 0xFFu);
    }
    if (input) mbar_arrive(&in_empty[c]);
  };
  for (int c = 0; c < 4; ++c) chunk(c);
}

// Threads 0-255: two consumer warpgroups; 256-383: the producer
// warpgroup, of which thread 256 issues the operands' copies and thread
// 288 the epilogue's input chunks. The CTA's tiles i = 0, 1, ... are tiles
// blockIdx.x + i gridDim.x of the grid; warpgroup w takes i = w, w + 2,
// ...; the producer loads stage i T + kt (T stages a tile) into slot (i T
// + kt) % S.
template <bool BT, bool kDrop>
__global__ void __launch_bounds__(kWgThreads, 1)
vft_gemm_wgmma(const __grid_constant__ WgMaps maps,
               const __grid_constant__ GemmArgs g) {
  constexpr int S = kWgStages;
  extern __shared__ unsigned char wg_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* in_tile = ring + S * kWgStageBytes;
  unsigned char* staging = in_tile + kWgInBytes;  // [w]: kWgStageOut each
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + 2 * kWgStageOut);
  uint64_t* empty = full + S;
  uint64_t* in_full = empty + S;   // [c]: input chunk c of a tile
  uint64_t* in_empty = in_full + 4;
  uint64_t* turn = in_empty + 4;   // [w]: the other warpgroup has its stages
  const int tiles_n = (g.n + kWgN - 1) / kWgN;
  const int tiles = (g.m + kWgM - 1) / kWgM * tiles_n;
  const int local = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  const int nk0 = (g.k[0] + kWgK - 1) / kWgK;
  const int T = nk0 + (g.pairs > 1 ? (g.k[1] + kWgK - 1) / kWgK : 0);
  const int input = wg_input(g);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    for (int c = 0; c < 4; ++c) {
      mbar_init(&in_full[c], 1);
      mbar_init(&in_empty[c], 128);
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWgRegsProducer));
    // the producer: each tile's stages, pair 0's slices, then pair 1's
    if (threadIdx.x == kWgConsumers) {
      for (int i = 0; i < local; ++i) {
        const int t = blockIdx.x + i * gridDim.x;
        const int m0 = t / tiles_n * kWgM, n0 = t % tiles_n * kWgN;
        for (int kt = 0; kt < T; ++kt) {
          const int s = i * T + kt, slot = s % S;
          if (s >= S) mbar_wait(&empty[slot], ((s / S) & 1) ^ 1);
          mbar_expect_tx(&full[slot], kWgStageBytes);
          unsigned char* dst = ring + slot * kWgStageBytes;
          const int p = kt >= nk0;
          const int k0 = (p ? kt - nk0 : kt) * kWgK;
          tma_box(dst, &maps.a[p], k0, m0, &full[slot]);
          if (BT) {
            tma_box(dst + kWgABytes, &maps.b[p], k0, n0, &full[slot]);
          } else {
#pragma unroll
            for (int j = 0; j < kWgN / 64; ++j)
              tma_box(dst + kWgABytes + j * 64 * kWgK * 2, &maps.b[p],
                      n0 + 64 * j, k0, &full[slot]);
          }
        }
      }
    } else if (threadIdx.x == kWgConsumers + 32 && input) {
      // the second producer: input chunk c of each tile into buffer c once
      // the previous tile's epilogue is done with it
      for (int i = 0; i < local; ++i) {
        const int t = blockIdx.x + i * gridDim.x;
        const int m0 = t / tiles_n * kWgM, n0 = t % tiles_n * kWgN;
        for (int c = 0; c < 4; ++c) {
          if (i > 0) mbar_wait(&in_empty[c], (i - 1) & 1);
          mbar_expect_tx(&in_full[c], 64 * 64 * (input == 1 ? 4 : 2));
          const int r0 = m0 + 64 * (c / 2), c0 = n0 + 64 * (c % 2);
          unsigned char* dst = in_tile + c * (kWgInBytes / 4);
          tma_box(dst, &maps.in, c0, r0, &in_full[c]);
          if (input == 1)
            tma_box(dst + 8192, &maps.in, c0 + 32, r0, &in_full[c]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWgRegsConsumer));
    const int wg = threadIdx.x / 128;
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* stg = staging + wg * kWgStageOut;
    float acc[2][64];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[rh][c] = 0.0f;
    for (int i = wg, k = 0; i < local; i += 2, ++k) {
      const int t = blockIdx.x + i * gridDim.x;
      const int m0 = t / tiles_n * kWgM, n0 = t % tiles_n * kWgN;
      // the other warpgroup has all of tile i - 1's stages: every earlier
      // phase of the ring's barriers is complete
      if (i > 0) mbar_wait(&turn[wg], (wg ? k : k - 1) & 1);
      for (int kt = 0; kt < T; ++kt) {
        const int s = i * T + kt, slot = s % S;
        mbar_wait(&full[slot], (s / S) & 1);
        if (kt == T - 1 && leader) mbar_arrive(&turn[1 - wg]);
        const unsigned char* st = ring + slot * kWgStageBytes;
        const uint64_t db = BT ? vf::wg_desc(st + kWgABytes)
                               : wg_mn_desc(st + kWgABytes);
        vf::wg_fence();
#pragma unroll
        for (int kk = 0; kk < kWgK / 16; ++kk)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            // 32 bytes further along K-major rows; 16 rows of 128 bytes
            // further along MN-major ones (descriptor units of 16 bytes)
            wgmma_bf16_m64n128<BT ? 0 : 1>(
                acc[rh], vf::wg_desc(st + rh * 64 * 128) + 2 * kk,
                db + (BT ? 2 * kk : 128 * kk), kt > 0 || kk > 0);
        vf::wg_commit();
        // the stage before this one is done: free its slot
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0) mbar_arrive(&empty[(s - 1) % S]);
      }
      vf::wg_wait_all();
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) vf::wg_pin(acc[rh]);
      mbar_arrive(&empty[(i * T + T - 1) % S]);
      wg_epilogue<kDrop>(g, acc, m0, n0, i, in_tile, in_full, in_empty, stg,
                         input);
    }
  }
}

// ---- the f32 products: vft_gemm_tf32, split TF32 on wgmma ----
//
// Bound. The f32 products of one 224 px Macaron evaluation (B=64, 208
// padded rows, D=768, dh=1536) are 188 GFLOP; as split TF32 (three TF32
// passes, split_tf32.cuh) they take 1.14 ms at 495 TFLOP/s. Operations
// bound them: a 128x128 tile reads 32 KB of operands per 32-wide slice of
// K for 3.1 MFLOP of TF32 work, and the weights and a row block of A stay
// in L2 while the CTAs of one row block run.
//
// Design. One CTA of two warpgroups per 128x128 output tile, each
// warpgroup 64 rows of it. K goes in slices of 32: 16-byte cp.async bring
// a slice's raw f32 rows of A and B into a landing slot (kTfLand slots:
// the next three slices land while one is multiplied). Each thread
// takes its own A fragments from the landing slot and splits them in
// registers; B is split once into big and small TF32 planes (K-major,
// 128-byte swizzle; a B stored [K, N] is transposed on the way) while the
// tensor cores multiply the previous slice from the other pair of planes.
// Per k8 step three wgmma m64n128k8 with A from registers, in mm_f32's
// order (small x big, big x small, big x big). Each slice sums into a
// fresh accumulator set, added to the running total by f32 adds (the
// tensor cores truncate their own sums, and K runs to 2304 here). The
// total goes through shared memory to the epilogues, which take four
// consecutive columns of a row a thread (16-byte loads and stores; the
// dropout epilogues one Philox call per 4-column group). No split of K
// across CTAs and no atomics: two runs are bit-identical, and a product
// the backward recomputes equals the forward's.
constexpr int kTfM = 128, kTfN = 128, kTfK = 32, kTfThreads = 256;
constexpr int kTfLand = 4;                 // landing slots
constexpr int kTfLdA = kTfK + 4;           // landed A rows: fragment loads
                                           // on 32 distinct banks
constexpr int kTfLdB = kTfN + 4;           // a B stored [K, N] lands so
constexpr int kTfLdE = kTfN + 8;           // the staged output tile
constexpr int kTfPlane = kTfN * kTfK * 4;  // one swizzled B plane: 16 KB
constexpr int kTfLandA = kTfM * kTfLdA * 4;
constexpr int kTfLandSlot = kTfLandA + kTfK * kTfLdB * 4;  // A, then B
// two sets of B planes (big, small), the landing slots, and room to start
// the planes on a 1024-byte boundary; the output tile, staged after the
// last product, takes the planes and landing slots' bytes
constexpr int kTfSmem = 2 * 2 * kTfPlane + kTfLand * kTfLandSlot + 1024;
static_assert(kTfM * kTfLdE * 4 <= kTfSmem - 1024, "staged tile");
static_assert(kTfSmem <= 232448, "one CTA an SM: 227 KB of shared memory");

// The f32 epilogues (enum Epilogue) of columns n .. n + 3 of output row
// m: v the products, k0 and k1 the dropout epilogues' kept values.
__device__ __forceinline__ void epilogue4(const GemmArgs& g, int m, int n,
                                          const float (&v)[4],
                                          const float (&k0)[4],
                                          const float (&k1)[4]) {
  auto ld = [](const void* p, size_t i, float (&r)[4]) {
    const float4 t =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  };
  auto st = [](void* p, size_t i, const float (&r)[4]) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(r[0], r[1], r[2], r[3]);
  };
  const size_t o = (size_t)m * g.ldo + n, s = (size_t)m * g.ld32 + n,
               x = (size_t)m * g.ldaux + n;
  const bool bias = g.bias != nullptr;
  float r[4], f[4], a[4], t[4], b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (bias) ld(g.bias, n, b);
  switch (g.epi) {
    case kRound:
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = bias ? v[q] + b[q] : v[q];
      st(g.out, o, r);
      break;
    case kScale:
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = (bias ? v[q] + b[q] : v[q]) * g.scale;
      st(g.out, o, r);
      break;
    case kGelu:
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[q] = bias ? v[q] + b[q] : v[q];
        r[q] = vf::gelu(f[q]);
      }
      if (g.out32 != nullptr) st(g.out32, s, f);
      if (g.out2 != nullptr) st(g.out2, o, f);
      st(g.out, o, r);
      break;
    case kGeluGradResid:
      if (m % g.n_pad < g.n_real) {
        ld(g.res, o, t);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) t[q] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        r[q] = v[q] * vf::gelu_grad(t[q]);
        f[q] = vf::gelu(t[q]);
      }
      st(g.out, o, r);
      st(g.out2, o, f);
      break;
    case kGeluGrad:
      ld(g.aux, x, a);
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = v[q] * vf::gelu_grad(a[q]);
      st(g.out, o, r);
      break;
    case kAdvance:
      ld(g.res, o, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = t[q] + g.dt * (v[q] * g.scale);
      st(g.out, o, r);
      break;
    case kMacResid:
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = v[q] + b[q];
      if (g.fout != nullptr) st(g.fout, s, f);
      if (g.out32 != nullptr) {
        ld(g.aux, s, a);
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = a[q] + g.alpha * g.rs[0] * f[q];
        st(g.out32, s, r);
      }
      break;
    case kMacOut:
      ld(g.aux, x, a);
      if (g.res != nullptr) ld(g.res, o, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[q] = (a[q] + g.alpha * g.rs[0] * (v[q] + b[q])) * g.scale;
        r[q] = g.res != nullptr ? t[q] + g.dt * f[q] : f[q];
      }
      st(g.out, o, r);
      break;
    case kGeluDrop:
      if (g.out32 != nullptr) st(g.out32, s, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = vf::gelu(v[q]) * k0[q];
      st(g.out, o, r);
      break;
    case kGeluGradDrop:
      ld(g.aux, x, a);
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = v[q] * k0[q] * vf::gelu_grad(a[q]);
      st(g.out, o, r);
      break;
    case kOutDrop:
      ld(g.aux, x, a);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = (v[q] * k0[q] + a[q] * k1[q]) * g.scale;
      st(g.out, o, r);
      break;
    default:  // kF32
      st(g.out32, s, v);
      break;
  }
  if (g.epi == kGeluDrop || g.epi == kGeluGradDrop || g.epi == kOutDrop) {
    if (g.mask[0] != nullptr) st(g.mask[0], (size_t)m * g.n + n, k0);
    if (g.mask[1] != nullptr) st(g.mask[1], (size_t)m * g.n + n, k1);
  }
}

template <bool BT, bool kDrop>
__global__ void __launch_bounds__(kTfThreads, 1) vft_gemm_tf32(GemmArgs g) {
  extern __shared__ unsigned char tf_raw[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(tf_raw));
  unsigned char* smem = tf_raw + ((1024 - (base & 1023)) & 1023);
  unsigned char* land0 = smem + 2 * 2 * kTfPlane;
  const int m0 = blockIdx.y * kTfM, n0 = blockIdx.x * kTfN;
  const int M = g.m, N = g.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;  // rows 64 wg .. 64 wg + 63 of the tile
  // the operands of both pairs, without run-time indexing of g's arrays
  const float* const a0 = static_cast<const float*>(g.a[0]);
  const float* const a1 = static_cast<const float*>(g.a[1]);
  const float* const b0 = static_cast<const float*>(g.b[0]);
  const float* const b1 = static_cast<const float*>(g.b[1]);
  const int lda0 = g.lda[0], lda1 = g.lda[1], ldb0 = g.ldb[0],
            ldb1 = g.ldb[1], k0s = g.k[0], k1s = g.pairs > 1 ? g.k[1] : 0;
  const int nk0 = (k0s + kTfK - 1) / kTfK;
  const int slices = nk0 + (k1s + kTfK - 1) / kTfK;

  // slice s (of pair 0, then pair 1) into landing slot s % kTfLand, zeros
  // past M, N and K; a commit group each, empty past the last slice
  auto load = [&](int s) {
    if (s < slices) {
      const bool p = s >= nk0;
      const int k0 = (p ? s - nk0 : s) * kTfK, K = p ? k1s : k0s;
      const float* A = p ? a1 : a0;
      const float* B = p ? b1 : b0;
      const int la_ = p ? lda1 : lda0, lb_ = p ? ldb1 : ldb0;
      float* la = reinterpret_cast<float*>(land0 + (s % kTfLand) * kTfLandSlot);
      float* lb = la + kTfLandA / 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = threadIdx.x + j * kTfThreads;
        const int r = i >> 3, c = (i & 7) * 4;
        const bool ina = m0 + r < M && k0 + c < K;
        vf::cp_async16(la + r * kTfLdA + c,
                       ina ? A + (size_t)(m0 + r) * la_ + k0 + c : A, ina);
        if (BT) {
          const bool inb = n0 + r < N && k0 + c < K;
          vf::cp_async16(lb + r * kTfK + c,
                         inb ? B + (size_t)(n0 + r) * lb_ + k0 + c : B, inb);
        } else {
          const int kr = i >> 5, c4 = (i & 31) * 4;
          const bool inb = k0 + kr < K && n0 + c4 < N;
          vf::cp_async16(lb + kr * kTfLdB + c4,
                         inb ? B + (size_t)(k0 + kr) * lb_ + n0 + c4 : B,
                         inb);
        }
      }
    }
    vf::cp_async_commit();
  };
  // B of slice s from its landing slot into plane pair s % 2: rows of a B
  // stored [N, K] chunk by chunk, a B stored [K, N] a float4 of a K row at
  // a time, each value to its own N row
  auto split_b = [&](int s) {
    const float* lb = reinterpret_cast<const float*>(
        land0 + (s % kTfLand) * kTfLandSlot + kTfLandA);
    unsigned char* big = smem + (s & 1) * 2 * kTfPlane;
    unsigned char* small = big + kTfPlane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * kTfThreads;
      if (BT) {
        const int r = i >> 3, c = (i & 7) * 4, o = vf::swz128(r, c);
        const float4 v = *reinterpret_cast<const float4*>(lb + r * kTfK + c);
        uint4 hi, lo;
        vf::split_bits(v.x, hi.x, lo.x);
        vf::split_bits(v.y, hi.y, lo.y);
        vf::split_bits(v.z, hi.z, lo.z);
        vf::split_bits(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(big + o) = hi;
        *reinterpret_cast<uint4*>(small + o) = lo;
      } else {
        const int k = i & 31, n4 = (i >> 5) * 4;
        vf::split_kn4(lb + k * kTfLdB + n4, k, n4, big, small);
      }
    }
    vf::fence_async_shared();
  };
  // this thread's A fragments of slice s, raw: element (r, k) of fragment
  // kk at raw[4 kk + 2 (k >= 4) + (r >= 8)], r and k within it
  const int fr = wg * 64 + (warp & 3) * 16 + (lane >> 2), fk = lane & 3;
  auto load_a = [&](int s, float (&raw)[16]) {
    const float* la = reinterpret_cast<const float*>(
        land0 + (s % kTfLand) * kTfLandSlot) + fr * kTfLdA + fk;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      raw[4 * kk] = la[8 * kk];
      raw[4 * kk + 1] = la[8 * kTfLdA + 8 * kk];
      raw[4 * kk + 2] = la[8 * kk + 4];
      raw[4 * kk + 3] = la[8 * kTfLdA + 8 * kk + 4];
    }
  };

  float tot[64], acc[64], raw[16];
  unsigned ahi[4][4], alo[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = acc[i] = 0.0f;
  for (int s = 0; s < kTfLand; ++s) load(s);
  vf::cp_async_wait<kTfLand - 1>();
  __syncthreads();  // slice 0 has landed
  split_b(0);
  load_a(0, raw);
  vf::split_frags(raw, ahi, alo);
  vf::cp_async_wait<kTfLand - 2>();
  __syncthreads();  // its B planes are written, slice 1 has landed
  for (int s = 0; s < slices; ++s) {
    const unsigned char* pl = smem + (s & 1) * 2 * kTfPlane;
    const uint64_t b_big = vf::wg_desc(pl);
    const uint64_t b_small = vf::wg_desc(pl + kTfPlane);
    vf::wg_pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vf::wg_pin(ahi[kk]);
      vf::wg_pin(alo[kk]);
    }
    vf::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTfK / 8; ++kk) {
      const uint64_t step = kk * 32 / 16;  // 32 bytes, in 16-byte units
      vf::wgmma_tf32_m64n128_rs(acc, alo[kk], b_big + step, kk > 0);
      vf::wgmma_tf32_m64n128_rs(acc, ahi[kk], b_small + step, 1);
      vf::wgmma_tf32_m64n128_rs(acc, ahi[kk], b_big + step, 1);
    }
    vf::wg_commit();
    // beside the tensor cores' work: slice s + kTfLand into the landing
    // slot slice s left, slice s + 1's B planes and raw A fragments
    load(s + kTfLand);
    if (s + 1 < slices) {
      split_b(s + 1);
      load_a(s + 1, raw);
    }
    vf::wg_wait_all();
    vf::wg_pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vf::wg_pin(ahi[kk]);
      vf::wg_pin(alo[kk]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    if (s + 1 < slices) vf::split_frags(raw, ahi, alo);
    vf::cp_async_wait<kTfLand - 2>();
    // slice s + 1's B planes are written, plane pair s % 2 and landing
    // slot (s + 1) % kTfLand are free, slice s + 2 has landed
    __syncthreads();
  }

  // the total through shared memory (the planes and landing slots are
  // free once every warpgroup has left the loop), then the epilogues
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (fr + 8 * h) * kTfLdE + 8 * j +
                                 2 * fk) =
          make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
  __syncthreads();
  for (int i = threadIdx.x; i < kTfM * kTfN / 4; i += kTfThreads) {
    const int r = i / (kTfN / 4), c = (i % (kTfN / 4)) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 t = *reinterpret_cast<const float4*>(tile + r * kTfLdE + c);
    const float v[4] = {t.x, t.y, t.z, t.w};
    float k0[4] = {1.0f, 1.0f, 1.0f, 1.0f}, k1[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (kDrop) {
      gemm_keep4(g, 0, m, n >> 2, k0);
      if (g.epi == kOutDrop) gemm_keep4(g, 1, m, n >> 2, k1);
    }
    epilogue4(g, m, n, v, k0, k1);
  }
}

// ---------------------------------------------------------------- attention

// JaSMin statistics of one real query row qi of rounded p (one warp): kk
// passes, each taking the largest remaining value and removing the FIRST
// column that holds it; ranks (1, 2, kk-1, kk), their columns and the row
// sum of clip(p, 1e-12, 1). The rule of vector_field.cu's jas_stats_rows,
// over up to 256 columns.
template <typename T>
__device__ void jas_row(const T* prow, int n_real, int kk, int qi, int n,
                        float* stats, int* idx) {
  const int lane = threadIdx.x % 32;
  constexpr int kPer = kMaxCols / 32;
  float v[kPer];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n_real ? vf::to_f(prow[c]) : -INFINITY;
    if (c < n_real) sum += fminf(fmaxf(v[j], 1e-12f), 1.0f);
  }
  sum = vf::warp_sum(sum);
  if (lane == 0) stats[4 * n + qi] = sum;
  for (int pass = 0; pass < kk; ++pass) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) m = fmaxf(m, v[j]);
    m = vf::warp_max(m);
    int first = 1 << 30;
#pragma unroll
    for (int j = kPer - 1; j >= 0; --j)
      if (v[j] == m) first = lane + 32 * j;
    first = vf::warp_min_int(first);
    if (lane == 0) {
      const int ranks[4] = {0, 1, kk - 2, kk - 1};
      for (int i = 0; i < 4; ++i)
        if (pass == ranks[i]) {
          stats[i * n + qi] = m;
          idx[i * n + qi] = first;
        }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (lane + 32 * j == first) v[j] = -INFINITY;
  }
}

struct AttnArgs {
  const void* qkv;       // [R, 3D]
  const void* cb;        // [R, D]   backward: round(gd Wout^T)
  void* ctx;             // [R, D]
  void* pmap;            // forward, attention-map mode: [B, H, n, n]
  float* stats;          // forward, JaSMin mode: [B, H, 5, n]
  int* idx;              //                       [B, H, 4, n]
  const void* g_attn;    // backward: [B, H, n, n] or null
  const float* g_jas;    // backward: [B, H, 5, n] or null
  const int* jas_idx;    //           [B, H, 4, n]
  void* pg;              // backward: p      [B, H, n, n] scratch
  void* sbar;            // backward: s_bar  [B, H, n, n] scratch (L2:
                         //           round(d2b))
  void* qkvb;            // backward: [R, 3D]
  float* l2cs;           // backward, L2: each query tile's column sums of
                         //           d2b [B, H, query tiles, n]
  float* mask_p;         // forward with dropout, emit_masks: [B, H, n, n]
  int n_pad, n_real, d, heads, mt, mode, jas_kk;
  int resid;             // backward: qkv is the stash's rqkv; its padded
                         // rows of q and k are read as zeros too
  float qk_scale;
  vf::Drop drop;         // the dropout instances: mask_p (th_p, sc_p)
};

enum AttnMode { kPlain = 0, kJasmin = 1, kMap = 2 };

// Shared memory of one attention CTA (byte offsets; row strides in
// elements, rows padded by 16 bytes). The backward's dropout instance also
// keeps the query tile's keep bits (vf::keep_bits_row's words); the L2
// instances the f32 k2 of every key, then q2, the row sums of e (+ 1e-8)
// and, in the backward, of d2b, for the query tile.
struct AttnPlan {
  size_t k, v, q, s, p, cb, pbar, bits, l2, total;
  int ld_hd, ld_s, ld_p, ld_bits;
};

__host__ __device__ inline AttnPlan attn_plan(int n, int hd, int mt, int tb,
                                              bool bwd, bool drop,
                                              bool l2 = false) {
  const int pad = 16 / tb;
  AttnPlan a;
  a.ld_hd = hd + pad;
  a.ld_s = vf::imax(n, hd) + 4;
  a.ld_p = n + pad;
  size_t off = 0;
  a.k = off;  off += vf::align128((size_t)n * a.ld_hd * tb);
  a.v = off;  off += vf::align128((size_t)n * a.ld_hd * tb);
  a.q = off;  off += vf::align128((size_t)mt * a.ld_hd * tb);
  a.s = off;  off += vf::align128((size_t)mt * a.ld_s * 4);
  a.p = off;  off += vf::align128((size_t)mt * a.ld_p * tb);
  a.cb = a.pbar = off;
  if (bwd) {
    a.cb = off;    off += vf::align128((size_t)mt * a.ld_hd * tb);
    a.pbar = off;  off += vf::align128((size_t)mt * a.ld_s * 4);
  }
  a.bits = off;
  a.ld_bits = 4 * ((n + 127) / 128);
  if (bwd && drop) off += vf::align128((size_t)mt * a.ld_bits * 4);
  a.l2 = off;
  if (l2) off += vf::align128((size_t)(n + 3 * mt) * 4);
  a.total = off;
  return a;
}

// Rows of a head into shared memory 16 bytes (4 f32 or 8 bf16) at a time,
// four loads in flight a thread: row r < rows of the hd columns at src +
// r lds, times scale where it is not 1, to dst + r ldd, or zeros where
// zero(r). hd a multiple of 16 / sizeof(T), 16-byte aligned rows.
template <typename T, typename Z>
__device__ __forceinline__ void load_rows16(T* dst, int ldd, const T* src,
                                            size_t lds, int rows, int hd,
                                            float scale, Z zero) {
  constexpr int kV = 16 / sizeof(T);
  const int hq = hd / kV;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * hq; i += vf::kThreads) {
    const int r = i / hq, c = (i % hq) * kV;
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (!zero(r)) {
      t = *reinterpret_cast<const uint4*>(src + r * lds + c);
      if (scale != 1.0f) {
        T* e = reinterpret_cast<T*>(&t);
#pragma unroll
        for (int j = 0; j < kV; ++j)
          e[j] = vf::from_f<T>(vf::to_f(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = t;
  }
}

// The whole-row attention CTAs' products, vf::mm's arguments: bf16 WMMA
// fragments, f32 as split TF32 on the tensor cores (vf::mm_f32).
template <bool AT, bool BT>
__device__ __forceinline__ void attn_mm(const bf16* A, int lda, const bf16* B,
                                        int ldb, float* C, int ldc, int M,
                                        int N, int K) {
  vf::mm<AT, BT>(A, lda, B, ldb, C, ldc, false, M, N, K);
}

template <bool AT, bool BT>
__device__ __forceinline__ void attn_mm(const float* A, int lda,
                                        const float* B, int ldb, float* C,
                                        int ldc, int M, int N, int K) {
  vf::mm_f32<AT, BT>(A, lda, B, ldb, C, ldc, M, N, K);
}

// One CTA per (query tile, head, image). Forward: the scores, p, the map
// or statistics, ctx. With kBwd also p_bar, s_bar and q_bar (see the top
// of the file). kDrop: ctx (and in the backward v_bar, through the p
// scratch) takes the masked p; the map, the statistics, the JaSMin
// scatter and s_bar the pre-dropout p. kL2: L2 scores (see the top of the
// file), no dropout and no map.
template <typename T, bool kBwd, bool kDrop, bool kL2 = false>
__global__ void __launch_bounds__(vf::kThreads) vft_attn(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, n_real = a.n_real, d = a.d, hd = d / a.heads;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * a.mt;
  const int rows = vf::imin(a.mt, n - q0);
  const AttnPlan pl = attn_plan(n, hd, a.mt, sizeof(T), kBwd, kDrop, kL2);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  float* s = reinterpret_cast<float*>(smem + pl.s);
  T* p = reinterpret_cast<T*>(smem + pl.p);
  T* cbs = reinterpret_cast<T*>(smem + pl.cb);
  float* pbar = reinterpret_cast<float*>(smem + pl.pbar);
  float* k2 = reinterpret_cast<float*>(smem + pl.l2);
  float *q2 = k2 + n, *esum = q2 + a.mt, *rsum = esum + a.mt;
  const int lh = pl.ld_hd, ls = pl.ld_s, lp = pl.ld_p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * n;
  const size_t bh = (size_t)b * a.heads + h;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T zero = vf::from_f<T>(0.0f);

  // K and V of the head (padded value rows zeroed, so that 0 * NaN cannot
  // reach p v), the query tile, and in the backward the tile of cb
  const T* hq = qkv + row0 * 3 * d + h * hd;
  load_rows16(k, lh, hq + d, 3 * d, n, hd, 1.0f,
              [&](int r) { return a.resid && r >= n_real; });
  load_rows16(v, lh, hq + 2 * d, 3 * d, n, hd, 1.0f,
              [&](int r) { return r >= n_real; });
  load_rows16(q, lh, hq + (size_t)q0 * 3 * d, 3 * d, rows, hd, 1.0f,
              [&](int r) { return a.resid && q0 + r >= n_real; });
  if (kBwd)
    load_rows16(cbs, lh,
                static_cast<const T*>(a.cb) + (row0 + q0) * d + h * hd, d,
                rows, hd, 1.0f, [](int) { return false; });
  __syncthreads();

  if (kL2) {
    // the rounded q's and k's f32 row norms, beside the score product
    vf::sq_rows(k, lh, n, hd, k2);
    vf::sq_rows(q, lh, rows, hd, q2);
  }
  attn_mm<false, true>(q, lh, k, lh, s, ls, rows, n, hd);
  __syncthreads();
  // softmax over the real keys, or L2: e = exp(-(q2 + k2 - 2 q.k) tau)
  // over (sum e + 1e-8), no max; p rounded; in the backward the unrounded
  // p (L2: e, with the row sum in esum) replaces the scores in place (each
  // lane rewrites its own columns)
  for (int r = warp; r < rows; r += vf::kWarps) {
    float* row = s + r * ls;
    const int qi = q0 + r;
    T* mrow = a.mode == kMap
                  ? static_cast<T*>(a.pmap) + (bh * n + qi) * n
                  : nullptr;
    if (kL2) {
      const float qr = q2[r];
      float sum = 0.0f;
      for (int c = lane; c < n_real; c += 32)
        sum += expf(-(qr + k2[c] - 2.0f * row[c]) * a.qk_scale);
      sum = vf::warp_sum(sum) + 1e-8f;
      if (lane == 0) esum[r] = sum;
      for (int c = lane; c < n; c += 32) {
        const float e =
            c < n_real ? expf(-(qr + k2[c] - 2.0f * row[c]) * a.qk_scale)
                       : 0.0f;
        p[r * lp + c] = vf::from_f<T>(e / sum);
        if (kBwd) row[c] = e;
      }
      continue;
    }
    float mx = -INFINITY;
    for (int c = lane; c < n_real; c += 32) mx = fmaxf(mx, row[c] * a.qk_scale);
    mx = vf::warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < n_real; c += 32) sum += expf(row[c] * a.qk_scale - mx);
    sum = vf::warp_sum(sum);
    for (int c = lane; c < n; c += 32) {
      const float pv = c < n_real ? expf(row[c] * a.qk_scale - mx) / sum : 0.0f;
      const T pr = vf::from_f<T>(pv);
      p[r * lp + c] = pr;
      if (kBwd) row[c] = pv;
      if (mrow != nullptr) mrow[c] = qi < n_real ? pr : zero;
    }
  }
  __syncthreads();
  if (!kBwd && a.mode == kJasmin) {
    float* st = a.stats + bh * 5 * n;
    int* ix = a.idx + bh * 4 * n;
    for (int r = warp; r < rows; r += vf::kWarps) {
      const int qi = q0 + r;
      if (qi >= n_real) {
        if (lane < 5) st[lane * n + qi] = 0.0f;
        if (lane < 4) ix[lane * n + qi] = 0;
        continue;
      }
      jas_row(p + r * lp, n_real, a.jas_kk, qi, n, st, ix);
    }
  }
  unsigned* bits = reinterpret_cast<unsigned*>(smem + pl.bits);
  const bool drop_p = kDrop && a.drop.th_p;
  if (drop_p) {
    // p = round(p mask_p) on real query rows, 0 on padded ones; the map
    // and the statistics above keep the pre-dropout p; with emit_masks the
    // mask's kept values go to a.mask_p
    __syncthreads();
    const unsigned key = vf::site_key(a.drop.seed, vf::kSiteP + h);
    for (int r = warp; r < rows; r += vf::kWarps) {
      const int qi = q0 + r;
      T* prow = p + r * lp;
      if (kBwd) {
        // the keep bits stay for p_bar
        unsigned* words = bits + r * pl.ld_bits;
        if (qi < n_real)
          vf::keep_bits_row(key, b, qi, n, n_real, a.drop.th_p, words);
        else if (lane < pl.ld_bits)
          words[lane] = 0u;
        __syncwarp();
        for (int c = lane; c < n; c += 32)
          prow[c] = vf::from_f<T>(
              vf::to_f(prow[c]) * (vf::kept(words, c) ? a.drop.sc_p : 0.0f));
      } else {
        float* mrow =
            a.mask_p != nullptr ? a.mask_p + (bh * n + qi) * n : nullptr;
        for (int q4 = lane; 4 * q4 < n; q4 += 32) {
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (qi < n_real)
            vf::keep4(key, b, qi, q4, n_real, a.drop.th_p, a.drop.sc_p, m);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            prow[4 * q4 + j] = vf::from_f<T>(vf::to_f(prow[4 * q4 + j]) * m[j]);
            if (mrow != nullptr) mrow[4 * q4 + j] = m[j];
          }
        }
      }
    }
    __syncthreads();
  }

  // ctx = round(p v) for this tile
  float* cst = kBwd ? pbar : s;
  attn_mm<false, false>(p, lp, v, lh, cst, ls, rows, hd, n);
  __syncthreads();
  T* ctx = static_cast<T*>(a.ctx);
  for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
    const int r = i / hd, c = i % hd;
    ctx[(row0 + q0 + r) * d + h * hd + c] = vf::from_f<T>(cst[r * ls + c]);
  }
  if (!kBwd) return;

  // p to global scratch for v_bar (zeros on padded query rows)
  T* pg = static_cast<T*>(a.pg) + bh * n * n;
  for (int i = threadIdx.x; i < rows * n; i += vf::kThreads) {
    const int r = i / n, c = i % n;
    pg[(size_t)(q0 + r) * n + c] = q0 + r < n_real ? p[r * lp + c] : zero;
  }
  __syncthreads();
  // p_bar = cb v^T (+ g_attn, + the JaSMin scatter); s_bar (L2: round(d2b))
  // into p
  attn_mm<false, true>(cbs, lh, v, lh, pbar, ls, rows, n, hd);
  __syncthreads();
  T* sb = static_cast<T*>(a.sbar) + bh * n * n;
  const T* gat = a.g_attn != nullptr
                     ? static_cast<const T*>(a.g_attn) + bh * n * n
                     : nullptr;
  for (int r = warp; r < rows; r += vf::kWarps) {
    const int qi = q0 + r;
    float* prow = pbar + r * ls;
    const float* frow = s + r * ls;
    if (qi >= n_real) {
      for (int c = lane; c < n; c += 32) {
        p[r * lp + c] = zero;
        sb[(size_t)qi * n + c] = zero;
        if (kL2) prow[c] = 0.0f;
      }
      if (kL2 && lane == 0) rsum[r] = 0.0f;
      continue;
    }
    // the f32 p of column c (L2: e over its row sum)
    const float es = kL2 ? esum[r] : 1.0f;
    auto p_of = [&](int c) { return kL2 ? frow[c] / es : frow[c]; };
    if (drop_p)
      for (int c = lane; c < n_real; c += 32)
        prow[c] *= vf::kept(bits + r * pl.ld_bits, c) ? a.drop.sc_p : 0.0f;
    if (gat != nullptr)
      for (int c = lane; c < n_real; c += 32)
        prow[c] += vf::to_f(gat[(size_t)qi * n + c]);
    if (a.g_jas != nullptr) {
      const float* gj = a.g_jas + bh * 5 * n;
      const int* ji = a.jas_idx + bh * 4 * n;
      const float g4 = gj[4 * n + qi];
      for (int c = lane; c < n_real; c += 32) {
        // the pre-dropout rounded p (with dropout, p holds the masked one)
        const float pj = kDrop ? vf::to_f(vf::from_f<T>(frow[c]))
                               : vf::to_f(p[r * lp + c]);
        const float lo = ((pj >= 1e-12f) + (pj > 1e-12f)) * 0.5f;
        const float hi = ((pj <= 1.0f) + (pj < 1.0f)) * 0.5f;
        float t = g4 * (lo * hi);
        for (int i = 0; i < 4; ++i)
          if (ji[i * n + qi] == c) t += gj[i * n + qi];
        prow[c] += t;
      }
    }
    float dot = 0.0f;
    for (int c = lane; c < n_real; c += 32) dot += prow[c] * p_of(c);
    dot = vf::warp_sum(dot);
    if (kL2) {
      // d2b = -tau e (p_bar - dot) / esum in f32 stays in pbar for the
      // column sums; p and the scratch take round(d2b)
      float sum = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float v2 =
            c < n_real ? -a.qk_scale * frow[c] * ((prow[c] - dot) / es) : 0.0f;
        const T sv = vf::from_f<T>(v2);
        prow[c] = v2;
        p[r * lp + c] = sv;
        sb[(size_t)qi * n + c] = sv;
        sum += v2;
      }
      sum = vf::warp_sum(sum);
      if (lane == 0) rsum[r] = sum;
      continue;
    }
    for (int c = lane; c < n; c += 32) {
      const T sv = vf::from_f<T>(c < n_real ? frow[c] * (prow[c] - dot) : 0.0f);
      p[r * lp + c] = sv;
      sb[(size_t)qi * n + c] = sv;
    }
  }
  __syncthreads();
  if (kL2) {
    // this tile's column sums of d2b, over its rows in order
    float* cs = a.l2cs + (bh * gridDim.x + blockIdx.x) * n;
    for (int c = threadIdx.x; c < n; c += vf::kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < rows; ++r) sum += pbar[r * ls + c];
      cs[c] = sum;
    }
  }
  // softmax: q_bar = round(s_bar k tau); L2: q_bar = round(2 q rsum - 2
  // round(d2b) k)
  attn_mm<false, false>(p, lp, k, lh, s, ls, rows, hd, n);
  __syncthreads();
  T* qkvb = static_cast<T*>(a.qkvb);
  for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
    const int r = i / hd, c = i % hd;
    const float qb =
        kL2 ? (q0 + r < n_real ? 2.0f * vf::to_f(q[r * lh + c]) * rsum[r] -
                                     2.0f * s[r * ls + c]
                               : 0.0f)
            : s[r * ls + c] * a.qk_scale;
    qkvb[(row0 + q0 + r) * 3 * d + h * hd + c] = vf::from_f<T>(qb);
  }
}

struct KeyPlan {
  size_t qs, cbs, st, cs, total;
  int ld_hd, ld_st;
};

__host__ __device__ inline KeyPlan key_plan(int n, int hd, int tb,
                                            bool l2 = false) {
  KeyPlan a;
  a.ld_hd = hd + 16 / tb;
  a.ld_st = hd + 4;
  size_t off = 0;
  a.qs = off;   off += vf::align128((size_t)n * a.ld_hd * tb);
  a.cbs = off;  off += vf::align128((size_t)n * a.ld_hd * tb);
  a.st = off;   off += vf::align128((size_t)kKeyTile * a.ld_st * 4);
  a.cs = off;
  if (l2) off += vf::align128((size_t)kKeyTile * 4);
  a.total = off;
  return a;
}

// One CTA per (key tile, head, image): k_bar = round(s_bar^T round(q tau))
// and v_bar = round(p^T cb) over every query of the image, the s_bar and p
// rows read from global scratch. kL2: k_bar = round(2 k csum - 2
// round(d2b)^T q), csum the key's column sum of d2b, summed over the query
// tiles' partials in order.
template <typename T, bool kL2 = false>
__global__ void __launch_bounds__(vf::kThreads) vft_attn_keys(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, d = a.d, hd = d / a.heads;
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * kKeyTile;
  const int rows = vf::imin(kKeyTile, n - j0);
  const KeyPlan pl = key_plan(n, hd, sizeof(T), kL2);
  T* qs = reinterpret_cast<T*>(smem + pl.qs);
  T* cbs = reinterpret_cast<T*>(smem + pl.cbs);
  float* st = reinterpret_cast<float*>(smem + pl.st);
  float* cs = reinterpret_cast<float*>(smem + pl.cs);
  const int lh = pl.ld_hd, ls = pl.ld_st;
  const size_t row0 = (size_t)b * n;
  const size_t bh = (size_t)b * a.heads + h;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* cb = static_cast<const T*>(a.cb);
  load_rows16(qs, lh, qkv + row0 * 3 * d + h * hd, 3 * d, n, hd,
              kL2 ? 1.0f : a.qk_scale,
              [&](int r) { return a.resid && r >= a.n_real; });
  load_rows16(cbs, lh, cb + row0 * d + h * hd, d, n, hd, 1.0f,
              [](int) { return false; });
  if (kL2) {
    const int tiles = (n + a.mt - 1) / a.mt;
    for (int r = threadIdx.x; r < rows; r += vf::kThreads) {
      float sum = 0.0f;
      for (int t = 0; t < tiles; ++t)
        sum += a.l2cs[(bh * tiles + t) * n + j0 + r];
      cs[r] = sum;
    }
  }
  __syncthreads();
  T* qkvb = static_cast<T*>(a.qkvb);
  const T* src[2] = {static_cast<const T*>(a.sbar) + bh * n * n + j0,
                     static_cast<const T*>(a.pg) + bh * n * n + j0};
  const T* rhs[2] = {qs, cbs};
  for (int part = 0; part < 2; ++part) {
    attn_mm<true, false>(src[part], n, rhs[part], lh, st, ls, rows, hd, n);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
      const int r = i / hd, c = i % hd;
      const size_t o = (row0 + j0 + r) * 3 * d + (part + 1) * d + h * hd + c;
      const float kb =
          kL2 && part == 0
              ? 2.0f * vf::to_f(qkv[o]) * cs[r] - 2.0f * st[r * ls + c]
              : st[r * ls + c];
      qkvb[o] = vf::from_f<T>(kb);
    }
    __syncthreads();
  }
}

// ------------------------------------------------- key-tiled attention
//
// Past kMaxCols padded tokens (the TS-Base student at 384 px: 587 tokens
// padded to 592) a row of scores no longer fits the whole-row CTA above: K
// and V of the head, f32 rows of [mt, n_pad] scores and, in the backward,
// p_bar. These instances stream K and V through shared memory in key tiles
// of kKeyTile rows, one CTA per (query tile, head, image) as above:
//   pass 1   over the key tiles holding real keys: each query row's max and
//            sum of exp(s tau - max) over the real keys, the sum rescaled
//            when the max grows (L2: the sum of e, then + 1e-8; no max);
//   pass 2   the scores again, p = round(exp(s tau - m) / l) per tile; the
//            map, the emitted mask and the masked p per tile (the Philox
//            stream's bits depend on (seed, site, image, row, column),
//            never on the tile); the JaSMin statistics as a running top-kk
//            per row, merged tile by tile in column order (rounding is
//            monotone, so the ranks, their first columns and the clipped
//            row sum are those of the whole row); ctx accumulated in f32
//            over the tiles and rounded once.
// The backward takes pass 1, then pass 2 with p_bar = cb v^T of the tile
// (masked by the tile's keep bits, + g_attn, + the JaSMin scatter), the
// row's dot = sum p_bar p and ctx; then pass 3 recomputes the scores and
// p_bar, writes s_bar = round(p (p_bar - dot)) (L2: round(d2b), its row
// sums and each tile's column sums) and accumulates q_bar = s_bar k over
// the tiles. p and s_bar go to the [B, H, n, n] scratch as above, and
// vft_attn_keys_kt loops over query tiles instead of holding all n queries.
// The arithmetic is the whole-row kernels' (the same rounding points; the
// plain versions stay the reference); only the order of the f32 sums over
// keys differs. No atomics: two runs are bit-identical.
//
// Bound and design. At 592 tokens, B=64, D=768 the attention products
// take 69 GFLOP of an evaluation's 337 (0.34 ms at 989 TFLOP/s); these
// CTAs run 1.5x that in the forward (pass 1 recomputes the scores) and
// about 1.75x the whole-row backward's. Operations bound them, but the
// CTAs are latency-bound: tiles of 64 x 64 products between barriers. So
// K and V move in 16-byte loads, vf::mm keeps at most 4 row tiles of
// accumulators (M <= 64), and __launch_bounds__(384, 2) holds the CTAs to
// 80 registers so that two share an SM. These first CTAs now run the f32
// and L2 instances only; the bf16 softmax backward, which spilled at that
// cap, runs vft_attn_kt_bwd and vft_attn_keys_kt2, and the bf16 softmax
// forward vft_attn_kt_fwd (below: operands and accumulators in
// registers).

constexpr int kMaxJas = 16;  // JaSMin extraction passes (k + 1) past kMaxCols
constexpr int kRowVals = 6;  // per query row: max, sum, dot, q2, rsum, jsum

struct KtPlan {
  size_t q, k, v, s, p, acc, cb, pbar, rows, topv, topc, total;
  int ld_hd, ld_s, ld_p, ld_acc;
};

__host__ __device__ inline KtPlan kt_plan(int hd, int mt, int tb, bool bwd) {
  const int pad = 16 / tb;
  KtPlan a;
  a.ld_hd = hd + pad;
  a.ld_s = kKeyTile + 4;
  a.ld_p = kKeyTile + pad;
  a.ld_acc = hd + 4;
  size_t off = 0;
  a.q = off;    off += vf::align128((size_t)mt * a.ld_hd * tb);
  a.k = off;    off += vf::align128((size_t)kKeyTile * a.ld_hd * tb);
  a.v = off;    off += vf::align128((size_t)kKeyTile * a.ld_hd * tb);
  a.s = off;    off += vf::align128((size_t)mt * a.ld_s * 4);
  a.p = off;    off += vf::align128((size_t)mt * a.ld_p * tb);
  a.acc = off;  off += vf::align128((size_t)mt * a.ld_acc * 4);
  a.cb = a.pbar = off;
  if (bwd) {
    a.cb = off;    off += vf::align128((size_t)mt * a.ld_hd * tb);
    a.pbar = off;  off += vf::align128((size_t)mt * a.ld_s * 4);
  }
  a.rows = off;  off += vf::align128((size_t)(kRowVals * mt + kKeyTile) * 4);
  a.topv = a.topc = off;
  if (!bwd) {
    a.topv = off;  off += vf::align128((size_t)mt * kMaxJas * 4);
    a.topc = off;  off += vf::align128((size_t)mt * kMaxJas * 4);
  }
  a.total = off;
  return a;
}

struct KeyKtPlan {
  size_t qs, cbs, stk, stv, cs, total;
  int ld_hd, ld_st;
};

__host__ __device__ inline KeyKtPlan key_kt_plan(int hd, int mt, int tb) {
  KeyKtPlan a;
  a.ld_hd = hd + 16 / tb;
  a.ld_st = hd + 4;
  size_t off = 0;
  a.qs = off;   off += vf::align128((size_t)mt * a.ld_hd * tb);
  a.cbs = off;  off += vf::align128((size_t)mt * a.ld_hd * tb);
  a.stk = off;  off += vf::align128((size_t)kKeyTile * a.ld_st * 4);
  a.stv = off;  off += vf::align128((size_t)kKeyTile * a.ld_st * 4);
  a.cs = off;   off += vf::align128((size_t)kKeyTile * 4);
  a.total = off;
  return a;
}

// The keep bits of columns c0 .. c0 + kKeyTile - 1 of one real row, for
// every lane of the warp: bit c % 32 of word c / 32 for column c0 + c (lane
// j < 16 draws vf::keep4's group c0 / 4 + j).
__device__ __forceinline__ uint2 keep_tile(unsigned key, unsigned img,
                                           int row, int c0, int n_valid,
                                           unsigned th) {
  const int lane = threadIdx.x % 32;
  unsigned nib = 0u;
  if (lane < kKeyTile / 4 && c0 + 4 * lane < n_valid) {
    float m[4];
    vf::keep4(key, img, row, c0 / 4 + lane, n_valid, th, 1.0f, m);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m[j] != 0.0f) nib |= 1u << j;
  }
  const unsigned lo = __reduce_or_sync(0xffffffffu,
                                       lane < 8 ? nib << (4 * lane) : 0u);
  const unsigned hi = __reduce_or_sync(
      0xffffffffu, lane >= 8 && lane < 16 ? nib << (4 * (lane - 8)) : 0u);
  return make_uint2(lo, hi);
}

__device__ __forceinline__ bool kept_tile(uint2 w, int c) {
  return ((c < 32 ? w.x : w.y) >> (c & 31)) & 1u;
}

// Merges one key tile's candidates (two a lane: rounded p of real keys and
// their columns, -inf where absent) into a row's running top list (kk
// entries, value descending, ties by the earlier column; tv, tc in shared
// memory), by one warp: kk passes, each taking the largest value and its
// FIRST column, as jas_row over the whole row. The list's columns precede
// the tile's, so the merged list is the whole row's top kk so far.
__device__ void jas_merge(float (&cv)[2], int (&cc)[2], float* tv, int* tc,
                          int kk) {
  const int lane = threadIdx.x % 32;
  float lv = lane < kk ? tv[lane] : -INFINITY;
  int lc = lane < kk ? tc[lane] : 1 << 30;
  float nv = -INFINITY;
  int nc = 1 << 30;
  for (int pass = 0; pass < kk; ++pass) {
    const float m = vf::warp_max(fmaxf(lv, fmaxf(cv[0], cv[1])));
    int first = 1 << 30;
    if (lv == m) first = min(first, lc);
    if (cv[0] == m) first = min(first, cc[0]);
    if (cv[1] == m) first = min(first, cc[1]);
    first = vf::warp_min_int(first);
    if (lane == pass) {
      nv = m;
      nc = first;
    }
    if (lc == first) lv = -INFINITY;
    if (cc[0] == first) cv[0] = -INFINITY;
    if (cc[1] == first) cv[1] = -INFINITY;
  }
  __syncwarp();
  if (lane < kk) {
    tv[lane] = nv;
    tc[lane] = nc;
  }
  __syncwarp();
}

// Rows of a head's hd columns in 16-byte vectors (hd is a multiple of 16,
// every row of the operands and of the shared tiles starts 16-byte
// aligned): the vectors a row holds, and vector i's row and column.
template <typename T>
struct RowVecs {
  static constexpr int kPer = 16 / sizeof(T);
  int per_row;
  __device__ explicit RowVecs(int hd) : per_row(hd / kPer) {}
  __device__ int row(int i) const { return i / per_row; }
  __device__ int col(int i) const { return i % per_row * kPer; }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// K (and, with with_v, V) rows c0 .. c0 + kc of head h into shared memory,
// as vft_attn loads them (padded value rows, and with resid padded key
// rows, as zeros), 16 bytes a load; with kL2 then the f32 k2 of the tile.
// Syncs.
template <typename T, bool kL2>
__device__ void kt_load(const AttnArgs& a, const T* qkv, size_t row0, int h,
                        int hd, int c0, int kc, T* k, T* v, int lh,
                        float* k2, bool with_v) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int d = a.d;
  const RowVecs<T> rv(hd);
  for (int i = threadIdx.x; i < kc * rv.per_row; i += vf::kThreads) {
    const int r = rv.row(i), c = rv.col(i);
    const T* src = qkv + (row0 + c0 + r) * 3 * d + h * hd + c;
    st16(k + r * lh + c, a.resid && c0 + r >= a.n_real ? zero : ld16(src + d));
    if (with_v)
      st16(v + r * lh + c, c0 + r < a.n_real ? ld16(src + 2 * d) : zero);
  }
  __syncthreads();
  if (kL2) vf::sq_rows(k, lh, kc, hd, k2);
}

// One CTA per (query tile, head, image) past kMaxCols padded tokens (see
// above): the forward's (kBwd false) or the backward's key-tiled passes,
// with the modes, dropout and L2 of vft_attn.
template <typename T, bool kBwd, bool kDrop, bool kL2 = false>
__global__ void __launch_bounds__(vf::kThreads, 2) vft_attn_kt(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, n_real = a.n_real, d = a.d, hd = d / a.heads;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * a.mt;
  const int rows = vf::imin(a.mt, n - q0);
  const KtPlan pl = kt_plan(hd, a.mt, sizeof(T), kBwd);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  float* s = reinterpret_cast<float*>(smem + pl.s);
  T* p = reinterpret_cast<T*>(smem + pl.p);
  float* acc = reinterpret_cast<float*>(smem + pl.acc);
  T* cbs = reinterpret_cast<T*>(smem + pl.cb);
  float* pbar = reinterpret_cast<float*>(smem + pl.pbar);
  float* rm = reinterpret_cast<float*>(smem + pl.rows);
  float *rl = rm + a.mt, *rdot = rl + a.mt, *q2 = rdot + a.mt;
  float *rsum = q2 + a.mt, *jsum = rsum + a.mt, *k2 = jsum + a.mt;
  float* topv = reinterpret_cast<float*>(smem + pl.topv);
  int* topc = reinterpret_cast<int*>(smem + pl.topc);
  const int lh = pl.ld_hd, ls = pl.ld_s, lp = pl.ld_p, la = pl.ld_acc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * n;
  const size_t bh = (size_t)b * a.heads + h;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T zero = vf::from_f<T>(0.0f);
  const float tau = a.qk_scale;
  const bool jas = !kBwd && a.mode == kJasmin;
  const bool drop_p = kDrop && a.drop.th_p;
  const unsigned pkey = vf::site_key(a.drop.seed, vf::kSiteP + h);

  const RowVecs<T> rv(hd);
  for (int i = threadIdx.x; i < rows * rv.per_row; i += vf::kThreads) {
    const int r = rv.row(i), c = rv.col(i);
    const T* src = qkv + (row0 + q0 + r) * 3 * d + h * hd + c;
    st16(q + r * lh + c, a.resid && q0 + r >= n_real
                             ? make_uint4(0u, 0u, 0u, 0u)
                             : ld16(src));
    if (kBwd)
      st16(cbs + r * lh + c, ld16(static_cast<const T*>(a.cb) +
                                  (row0 + q0 + r) * d + h * hd + c));
  }
  for (int r = threadIdx.x; r < a.mt; r += vf::kThreads) {
    rm[r] = -INFINITY;
    rl[r] = rdot[r] = rsum[r] = jsum[r] = 0.0f;
  }
  if (jas)
    for (int i = threadIdx.x; i < a.mt * kMaxJas; i += vf::kThreads) {
      topv[i] = -INFINITY;
      topc[i] = 1 << 30;
    }
  __syncthreads();
  if (kL2) {
    vf::sq_rows(q, lh, rows, hd, q2);
    __syncthreads();
  }

  // pass 1: each row's max and sum over the real keys
  for (int c0 = 0; c0 < n_real; c0 += kKeyTile) {
    const int kc = vf::imin(kKeyTile, n - c0);
    kt_load<T, kL2>(a, qkv, row0, h, hd, c0, kc, k, v, lh, k2, false);
    vf::mm<false, true, 4>(q, lh, k, lh, s, ls, false, rows, kc, hd);
    __syncthreads();
    const int creal = vf::imin(kc, n_real - c0);
    for (int r = warp; r < rows; r += vf::kWarps) {
      const float* row = s + r * ls;
      if (kL2) {
        const float qr = q2[r];
        float sum = 0.0f;
        for (int c = lane; c < creal; c += 32)
          sum += expf(-(qr + k2[c] - 2.0f * row[c]) * tau);
        sum = vf::warp_sum(sum);
        if (lane == 0) rl[r] += sum;
        continue;
      }
      const float m_old = rm[r], l_old = rl[r];
      float mx = -INFINITY;
      for (int c = lane; c < creal; c += 32) mx = fmaxf(mx, row[c] * tau);
      const float m_new = fmaxf(m_old, vf::warp_max(mx));
      float sum = 0.0f;
      for (int c = lane; c < creal; c += 32) sum += expf(row[c] * tau - m_new);
      sum = vf::warp_sum(sum);
      if (lane == 0) {
        rl[r] = l_old * expf(m_old - m_new) + sum;
        rm[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (kL2) {
    for (int r = threadIdx.x; r < rows; r += vf::kThreads) rl[r] += 1e-8f;
    __syncthreads();
  }

  // column c of the tile at c0, row r: the f32 p (L2: e, p = e / rl)
  auto e_of = [&](int r, int c, int col) {
    if (col >= n_real) return 0.0f;
    const float sv = s[r * ls + c];
    return kL2 ? expf(-(q2[r] + k2[c] - 2.0f * sv) * tau)
               : expf(sv * tau - rm[r]) / rl[r];
  };
  T* pg = kBwd ? static_cast<T*>(a.pg) + bh * n * n : nullptr;
  T* sb = kBwd ? static_cast<T*>(a.sbar) + bh * n * n : nullptr;
  const T* gat = kBwd && a.g_attn != nullptr
                     ? static_cast<const T*>(a.g_attn) + bh * n * n
                     : nullptr;
  const float* gj = kBwd && a.g_jas != nullptr ? a.g_jas + bh * 5 * n
                                               : nullptr;
  const int* ji = gj != nullptr ? a.jas_idx + bh * 4 * n : nullptr;
  // the backward's full p_bar of one real key column (on the pre-dropout
  // rounded p pr for the JaSMin scatter)
  auto pbar_of = [&](int r, int c, int col, int qi, uint2 bits, float pr) {
    float pb = pbar[r * ls + c];
    if (drop_p) pb *= kept_tile(bits, c) ? a.drop.sc_p : 0.0f;
    if (gat != nullptr) pb += vf::to_f(gat[(size_t)qi * n + col]);
    if (gj != nullptr) {
      const float lo = ((pr >= 1e-12f) + (pr > 1e-12f)) * 0.5f;
      const float hi = ((pr <= 1.0f) + (pr < 1.0f)) * 0.5f;
      float t = gj[4 * n + qi] * (lo * hi);
      for (int i = 0; i < 4; ++i)
        if (ji[i * n + qi] == col) t += gj[i * n + qi];
      pb += t;
    }
    return pb;
  };

  // pass 2: p per tile; the map, the masks, the statistics; ctx (and in
  // the backward p to the scratch and the rows' dot)
  for (int c0 = 0; c0 < n; c0 += kKeyTile) {
    const int kc = vf::imin(kKeyTile, n - c0);
    kt_load<T, kL2>(a, qkv, row0, h, hd, c0, kc, k, v, lh, k2, true);
    vf::mm<false, true, 4>(q, lh, k, lh, s, ls, false, rows, kc, hd);
    if (kBwd)
      vf::mm<false, true, 4>(cbs, lh, v, lh, pbar, ls, false, rows, kc, hd);
    __syncthreads();
    for (int r = warp; r < rows; r += vf::kWarps) {
      const int qi = q0 + r;
      const bool real = qi < n_real;
      const uint2 bits = drop_p && real ? keep_tile(pkey, b, qi, c0, n_real,
                                                    a.drop.th_p)
                                        : make_uint2(0u, 0u);
      T* mrow = !kBwd && a.mode == kMap
                    ? static_cast<T*>(a.pmap) + (bh * n + qi) * n
                    : nullptr;
      float* krow = !kBwd && drop_p && a.mask_p != nullptr
                        ? a.mask_p + (bh * n + qi) * n
                        : nullptr;
      float cv[2] = {-INFINITY, -INFINITY}, dot = 0.0f, csum = 0.0f;
      int cc[2] = {1 << 30, 1 << 30};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = c0 + c;
        if (c >= kc) continue;
        const float e = e_of(r, c, col);
        const float pf = kL2 ? e / rl[r] : e;
        const T pr = vf::from_f<T>(pf);
        T pm = pr;
        if (drop_p) {
          const float mk = kept_tile(bits, c) ? a.drop.sc_p : 0.0f;
          pm = vf::from_f<T>(vf::to_f(pr) * mk);
          if (krow != nullptr) krow[col] = mk;
        }
        p[r * lp + c] = pm;
        if (mrow != nullptr) mrow[col] = real ? pr : zero;
        if (jas && real && col < n_real) {
          cv[j] = vf::to_f(pr);
          cc[j] = col;
          csum += fminf(fmaxf(cv[j], 1e-12f), 1.0f);
        }
        if (kBwd) {
          pg[(size_t)qi * n + col] = real ? pm : zero;
          if (real && col < n_real)
            dot += pbar_of(r, c, col, qi, bits, vf::to_f(pr)) * pf;
        }
      }
      if (jas && real) {
        csum = vf::warp_sum(csum);
        if (lane == 0) jsum[r] += csum;
        jas_merge(cv, cc, topv + r * kMaxJas, topc + r * kMaxJas, a.jas_kk);
      }
      if (kBwd && real) {
        dot = vf::warp_sum(dot);
        if (lane == 0) rdot[r] += dot;
      }
    }
    __syncthreads();
    vf::mm<false, false, 4>(p, lp, v, lh, acc, la, c0 > 0, rows, hd, kc);
    __syncthreads();
  }
  T* ctx = static_cast<T*>(a.ctx);
  for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
    const int r = i / hd, c = i % hd;
    ctx[(row0 + q0 + r) * d + h * hd + c] = vf::from_f<T>(acc[r * la + c]);
  }
  if (jas) {
    float* st = a.stats + bh * 5 * n;
    int* ix = a.idx + bh * 4 * n;
    const int kk = a.jas_kk;
    const int ranks[4] = {0, 1, kk - 2, kk - 1};
    for (int r = threadIdx.x; r < rows; r += vf::kThreads) {
      const int qi = q0 + r;
      const bool real = qi < n_real;
      for (int i = 0; i < 4; ++i) {
        st[i * n + qi] = real ? topv[r * kMaxJas + ranks[i]] : 0.0f;
        ix[i * n + qi] = real ? topc[r * kMaxJas + ranks[i]] : 0;
      }
      st[4 * n + qi] = real ? jsum[r] : 0.0f;
    }
  }
  if (!kBwd) return;

  // pass 3: s_bar (L2: round(d2b)) per tile to the scratch, q_bar
  for (int c0 = 0; c0 < n; c0 += kKeyTile) {
    const int kc = vf::imin(kKeyTile, n - c0);
    kt_load<T, kL2>(a, qkv, row0, h, hd, c0, kc, k, v, lh, k2, true);
    vf::mm<false, true, 4>(q, lh, k, lh, s, ls, false, rows, kc, hd);
    vf::mm<false, true, 4>(cbs, lh, v, lh, pbar, ls, false, rows, kc, hd);
    __syncthreads();
    for (int r = warp; r < rows; r += vf::kWarps) {
      const int qi = q0 + r;
      if (qi >= n_real) {
        for (int c = lane; c < kc; c += 32) {
          p[r * lp + c] = zero;
          sb[(size_t)qi * n + c0 + c] = zero;
          if (kL2) pbar[r * ls + c] = 0.0f;
        }
        continue;
      }
      const uint2 bits = drop_p ? keep_tile(pkey, b, qi, c0, n_real,
                                            a.drop.th_p)
                                : make_uint2(0u, 0u);
      const float dot = rdot[r];
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = c0 + c;
        if (c >= kc) continue;
        float v2 = 0.0f;
        if (col < n_real) {
          const float e = e_of(r, c, col);
          const float pf = kL2 ? e / rl[r] : e;
          const float pb = pbar_of(r, c, col, qi, bits,
                                   vf::to_f(vf::from_f<T>(pf)));
          v2 = kL2 ? -tau * e * ((pb - dot) / rl[r]) : e * (pb - dot);
        }
        const T sv = vf::from_f<T>(v2);
        if (kL2) pbar[r * ls + c] = v2;
        p[r * lp + c] = sv;
        sb[(size_t)qi * n + col] = sv;
        part += v2;
      }
      if (kL2) {
        part = vf::warp_sum(part);
        if (lane == 0) rsum[r] += part;
      }
    }
    __syncthreads();
    if (kL2) {
      // this query tile's column sums of d2b, over its rows in order
      float* cs = a.l2cs + (bh * gridDim.x + blockIdx.x) * n + c0;
      for (int c = threadIdx.x; c < kc; c += vf::kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < rows; ++r) sum += pbar[r * ls + c];
        cs[c] = sum;
      }
    }
    vf::mm<false, false, 4>(p, lp, k, lh, acc, la, c0 > 0, rows, hd, kc);
    __syncthreads();
  }
  T* qkvb = static_cast<T*>(a.qkvb);
  for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
    const int r = i / hd, c = i % hd;
    const float qb =
        kL2 ? (q0 + r < n_real ? 2.0f * vf::to_f(q[r * lh + c]) * rsum[r] -
                                     2.0f * acc[r * la + c]
                               : 0.0f)
            : acc[r * la + c] * tau;
    qkvb[(row0 + q0 + r) * 3 * d + h * hd + c] = vf::from_f<T>(qb);
  }
}

// One CTA per (key tile, head, image) past kMaxCols padded tokens:
// vft_attn_keys' k_bar and v_bar, with the queries taken a query tile (mt
// rows) at a time into shared memory and both products accumulated in
// f32 over the tiles, rounded once.
template <typename T, bool kL2 = false>
__global__ void __launch_bounds__(vf::kThreads, 2)
    vft_attn_keys_kt(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, d = a.d, hd = d / a.heads, mq = a.mt;
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * kKeyTile;
  const int rows = vf::imin(kKeyTile, n - j0);
  const KeyKtPlan pl = key_kt_plan(hd, mq, sizeof(T));
  T* qs = reinterpret_cast<T*>(smem + pl.qs);
  T* cbs = reinterpret_cast<T*>(smem + pl.cbs);
  float* stk = reinterpret_cast<float*>(smem + pl.stk);
  float* stv = reinterpret_cast<float*>(smem + pl.stv);
  float* cs = reinterpret_cast<float*>(smem + pl.cs);
  const int lh = pl.ld_hd, ls = pl.ld_st;
  const size_t row0 = (size_t)b * n;
  const size_t bh = (size_t)b * a.heads + h;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* cb = static_cast<const T*>(a.cb);
  if (kL2) {
    const int tiles = (n + mq - 1) / mq;
    for (int r = threadIdx.x; r < rows; r += vf::kThreads) {
      float sum = 0.0f;
      for (int t = 0; t < tiles; ++t)
        sum += a.l2cs[(bh * tiles + t) * n + j0 + r];
      cs[r] = sum;
    }
  }
  const T* sb = static_cast<const T*>(a.sbar) + bh * n * n + j0;
  const T* pg = static_cast<const T*>(a.pg) + bh * n * n + j0;
  const RowVecs<T> rv(hd);
  for (int i0 = 0; i0 < n; i0 += mq) {
    const int qr = vf::imin(mq, n - i0);
    for (int i = threadIdx.x; i < qr * rv.per_row; i += vf::kThreads) {
      const int r = rv.row(i), c = rv.col(i);
      uint4 qv = a.resid && i0 + r >= a.n_real
                     ? make_uint4(0u, 0u, 0u, 0u)
                     : ld16(qkv + (row0 + i0 + r) * 3 * d + h * hd + c);
      if (!kL2) {
        T* e = reinterpret_cast<T*>(&qv);
#pragma unroll
        for (int j = 0; j < RowVecs<T>::kPer; ++j)
          e[j] = vf::from_f<T>(vf::to_f(e[j]) * a.qk_scale);
      }
      st16(qs + r * lh + c, qv);
      st16(cbs + r * lh + c, ld16(cb + (row0 + i0 + r) * d + h * hd + c));
    }
    __syncthreads();
    vf::mm<true, false, 4>(sb + (size_t)i0 * n, n, qs, lh, stk, ls, i0 > 0,
                           rows, hd, qr);
    vf::mm<true, false, 4>(pg + (size_t)i0 * n, n, cbs, lh, stv, ls, i0 > 0,
                           rows, hd, qr);
    __syncthreads();
  }
  T* qkvb = static_cast<T*>(a.qkvb);
  for (int i = threadIdx.x; i < rows * hd; i += vf::kThreads) {
    const int r = i / hd, c = i % hd;
    const size_t o = (row0 + j0 + r) * 3 * d + d + h * hd + c;
    const float kb = kL2 ? 2.0f * vf::to_f(qkv[o]) * cs[r] -
                               2.0f * stk[r * ls + c]
                         : stk[r * ls + c];
    qkvb[o] = vf::from_f<T>(kb);
    qkvb[o + d] = vf::from_f<T>(stv[r * ls + c]);
  }
}

// ---------------- the bf16 softmax backward past kMaxCols, on registers
//
// vft_attn_kt_bwd (query-major) and vft_attn_keys_kt2 (key-major) replace
// vft_attn_kt<bf16, true, ...> and vft_attn_keys_kt<bf16, false> for every
// bf16 softmax backward past kMaxCols padded tokens: the tiled backward
// (± dropout, ± JaSMin and map cotangents, ± residuals), the split
// backward's attention half and the bf16 tiled Macaron backward. They
// stand for odevit_tpu/kernels/vector_field_bwd.py::_vf_bwd_kernel (:117;
// dropout :182-233, :261-284) and _attn_bwd_kernel (:432). The f32 and L2
// instances keep the two kernels above.
//
// Arithmetic: the whole-row kernels' rounding points. p = round(exp(s tau
// - m) / l) (exp2 with log2 e folded into tau; e / l by one FMA correction
// of e (1 / l)); pm = round(round(p) keep sc); ctx = round(sum pm v);
// p_bar = keep sc (cb v^T) + g_attn + the JaSMin scatter on the
// pre-dropout round(p); dot = sum p_bar p (f32 p); s_bar = round(p (p_bar
// - dot)); q_bar = round(tau sum s_bar k); k_bar = round(sum s_bar^T
// round(q tau)); v_bar = round(sum pm^T cb). Otherwise only the order of
// the f32 sums differs from the plain versions. No atomics: two runs are
// bit-identical.
//
// Bound. At 587 of 592 tokens, B=64, 12 heads, hd=64 the pair needs six
// [n x 64] x [64 x n] head products (QK^T, P V for ctx, cb V^T, s_bar K,
// s_bar^T q, p^T cb): 203 GFLOP, 0.206 ms at 989 TFLOP/s, against 0.14 ms
// for its q, k, v, cb in and ctx, q_bar, k_bar, v_bar out. This design
// also writes the p and s_bar scratch ([B, H, n_pad, n_pad] bf16, 538 MB
// each) once and reads it once: 2.15 GB, a floor of 0.64 ms at 3.35
// TB/s. The query-major kernel runs 9 head products, not 6 (QK^T three
// times, cb V^T twice): recomputing them (69 GFLOP at tensor-core rate)
// costs less than keeping the f32 p_bar in device memory between passes
// (2.15 GB more traffic).
//
// Design (vft_attn_kt_bwd). One CTA of 4 warps per (64-row query tile,
// head, image); each warp owns 16 query rows. Q and cb arrive once by
// cp.async and go into registers as mma.sync.m16n8k16 A fragments
// (ldmatrix; at head widths other than 64, kGeneric, they are read from
// shared memory at each use). K and V stream in 64-key tiles through a
// ring of two cp.async slots (one where two do not fit, past hd = 272):
// one barrier per tile, none inside the tile's math; keys past the tile's
// end land as zeros, so every k-step runs whole. The scores, p_bar, p and
// s_bar live in the warp's accumulator fragments, a 16-key k-step at a
// time (a loop, not unrolled: the registers stay below 255 without
// spilling): row max, sum and dot reduce over the quad by __shfl_xor, and
// p and s_bar turn in registers into the A fragments of the next product
// (FlashAttention-2's register reuse). ctx and q_bar accumulate in
// registers over the whole stream (at other head widths in 64-column
// chunks, each chunk streaming the keys again). Three passes, because dot
// needs the whole row before any s_bar: pass 1 m and l; pass 2 p_bar, dot,
// pm, ctx and the p scratch; pass 3 s_bar, its scratch and q_bar. The
// per-element code has no branch: absent cotangents read as zeros, a rate
// of 0 as kept bits, padding by selection. Dropout keep bits are drawn
// once, in pass 2, one Philox call per thread and 8 keys (the partner
// lane of the quad draws the other row's group; a shuffle swaps the
// halves), and kept as a word per thread and key tile in shared memory for
// pass 3 (5 KB at 592 tokens; where they do not fit, pass 3 draws them
// again). Each row's JaSMin columns and cotangents sit in registers. The
// scratch rows go out through a per-warp staging tile in 16-byte stores.
//
// Design (vft_attn_keys_kt2). One CTA of 4 warps per (64-key tile, head,
// image), 16 keys a warp. The query tiles stream in ascending order
// through two cp.async slots, each holding the [64 q x 64 k] tiles of
// s_bar and p, q (each thread rounds the vectors it copied to round(q tau)
// once they land) and cb; s_bar^T and p^T come by ldmatrix.trans as A
// fragments, q and cb as .trans B fragments. k_bar and v_bar accumulate in
// registers and are rounded once (past hd = 64, 64 columns at a time).
// Reading its half of the scratch (1.08 GB) bounds it at 0.32 ms.
//
// ---------------- the bf16 softmax forward past kMaxCols, on registers
//
// vft_attn_kt_fwd replaces vft_attn_kt<bf16, false, ...> for every bf16
// softmax forward past kMaxCols padded tokens: the tiled forward in its
// plain, Euler, stage-advance, JaSMin and map modes, ± dropout, ±
// emit_masks, the stash's forwards, and the bf16 tiled Macaron forward. It
// stands for odevit_tpu/kernels/vector_field.py::_vf_kernel (:196; the
// JaSMin statistics :282-351, the map and dropout of fused_vf_attn,
// fused_vf_dropout, fused_vf_jasmin_dropout, fused_vf_attn_dropout, and
// emit_masks :221-223). The f32 and L2 instances keep vft_attn_kt.
//
// Bound. At 587 of 592 tokens, B=64, 12 heads, hd=64 it needs three head
// products (QK^T in pass 1 and again in pass 2, P V): 103 GFLOP, 0.105 ms
// at 989 TFLOP/s, against 0.07 ms for q, k, v in and ctx out; the dropout
// instance adds mask_p's Philox calls, one per 4 keys of a real row.
//
// Design. vft_attn_kt_bwd's layout and code: one CTA of 4 warps per
// (64-row query tile, head, image), 16 query rows a warp; Q by cp.async
// into mma.sync A fragments (read from shared memory at other head
// widths); K and V through the same KvRing (two slots, one where two do
// not fit). Two passes, because the rounding points need the row's final
// m and l before any p is rounded: pass 1 is kt_pass1, the backward's own;
// pass 2 computes p = round(kt_p(s)) in the accumulator fragments, 32
// keys at a time (a whole tile's scores beside ctx and Q would exceed the
// 128 registers that let four CTAs share an SM), pm = round(p keep sc)
// with kt_keep's bits (the backward's draw, one Philox call per thread and
// 8 keys), packs pm into the A fragments of P V and accumulates ctx in f32
// registers over the stream (at other head widths in 64-column chunks,
// each streaming the keys again), rounded once; so the forward's p, keep
// bits and ctx are the backward's, bit for bit. The map (pre-dropout p) and mask_p (keep
// flags, written as sc or 0) go out through the warp's staging tile in
// 16-byte stores. JaSMin: each lane keeps a running top-kk of its own
// columns of each of its two rows in shared memory (values descending;
// real keys only), so no lane waits for another. A tile's values are
// filtered in registers against the lane's kk-th value as the tile began;
// what passes is marked in a bit mask and staged as bf16 in the warp's
// staging tile, and each lane inserts its own candidates by the mask's set
// bits, in column order (so the warp steps as often as its busiest lane
// has candidates, not once per position): a value enters only if it is
// strictly greater than the current kk-th (an equal value comes from a
// later column and loses the tie), behind the equal values it meets.
// After the stream one lane of the quad merges its row's four lists
// (value, then the earlier column) into the row's ranks; the clipped row
// sum accumulates in registers and reduces over the quad. The lists take
// kk entries a lane and row (6 KB at k = 2, 32 KB at most), in the JaSMin
// mode's launches only. Padding by selection (NaN in padded rows reaches
// no real row), no atomics: repeats are bit-identical.

constexpr int kBThreads = 128;              // 4 warps of 16 rows
constexpr int kLdStg = kKeyTile + 8;        // staged 64-wide bf16 tiles
constexpr size_t kStgTile = (size_t)kKeyTile * kLdStg * 2;

// Shared memory of vft_attn_kt_bwd (byte offsets; rows of ld bf16): Q and
// cb of the query tile, the warps' staging tiles, the K/V ring (`stages`
// slots of K and V), then with `keep` the keep bits of pass 2 (a word per
// thread and key tile).
struct KtbPlan {
  size_t q, cb, stg, ring, slot, bits, total;
  int ld, stages;
  bool keep;
};

__host__ __device__ inline KtbPlan ktb_plan(int hd, int n_pad, bool drop) {
  KtbPlan a;
  a.ld = hd + 8;
  const size_t tile = (size_t)kKeyTile * a.ld * 2;
  a.q = 0;
  a.cb = tile;
  a.stg = 2 * tile;
  a.ring = a.stg + kStgTile;
  a.slot = 2 * tile;
  a.stages = a.ring + 2 * a.slot <= (size_t)vf::kMaxSmem ? 2 : 1;
  a.bits = a.ring + a.stages * a.slot;
  const size_t bits =
      (size_t)((n_pad + kKeyTile - 1) / kKeyTile) * kBThreads * 4;
  a.keep = drop && a.bits + bits <= (size_t)vf::kMaxSmem;
  a.total = a.bits + (a.keep ? bits : 0);
  return a;
}

// Shared memory of vft_attn_kt_fwd (byte offsets; rows of ld bf16): Q of
// the query tile, the warps' staging tiles, the K/V ring (`stages` slots
// of K and V), then the lanes' JaSMin lists of kk entries (values, then
// columns: entry i of row hf of thread tid at (hf kk + i) kBThreads +
// tid), which only the JaSMin mode's launches take (`top` bytes and
// lane_lists(kk) more; `total` at kk = kMaxJas). It does not depend on
// n_pad or dropout.
__host__ __device__ constexpr size_t lane_lists(int kk) {
  return (size_t)2 * 2 * kk * kBThreads * 4;
}
constexpr size_t kLaneLists = lane_lists(kMaxJas);

struct KtfPlan {
  size_t q, stg, ring, slot, top, total;
  int ld, stages;
};

__host__ __device__ inline KtfPlan ktf_plan(int hd) {
  KtfPlan a;
  a.ld = hd + 8;
  const size_t tile = (size_t)kKeyTile * a.ld * 2;
  a.q = 0;
  a.stg = tile;
  a.ring = a.stg + kStgTile;
  a.slot = 2 * tile;
  a.stages =
      a.ring + 2 * a.slot + kLaneLists <= (size_t)vf::kMaxSmem ? 2 : 1;
  a.top = a.ring + a.stages * a.slot;
  a.total = a.top + kLaneLists;
  return a;
}

// vft_attn_keys_kt2's two slots of s_bar, p, q and cb tiles
constexpr size_t kKeybSmem = 2 * 4 * kStgTile;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros where !in
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// closes this thread's copies so far into a group
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every group of this thread (a barrier shows them to others)
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory: lane l gives row l % 8 of
// matrix l / 8; with kTrans each matrix arrives transposed
template <bool kTrans>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
}

// c += a b for one m16n8k16 tile (bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values rounded to bf16 and packed, the first in the low half (the
// lower column of a fragment)
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// s = A B^T for this warp's 16 rows and kJ * 8 keys (B's rows from bs;
// rows past the tile's keys hold zeros), over depth hd: A from the
// registers af (hd = 64) or, with kGeneric, from shared memory (as: the
// warp's first row). s[j]: keys 8 j .. 8 j + 7 in the accumulator layout.
template <bool kGeneric, int kJ>
__device__ __forceinline__ void qk_tile(float (&s)[kJ][4],
                                        const unsigned (&af)[4][4],
                                        const bf16* as, const bf16* bs,
                                        int ld, int hd) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  const bf16* brow =
      bs + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
  auto step = [&](const unsigned (&a4)[4], int ks) {
#pragma unroll
    for (int jj = 0; jj < kJ / 2; ++jj) {
      unsigned b4[4];
      ldsm4<false>(b4, brow + 16 * jj * ld + 16 * ks);
      mma_bf16(s[2 * jj], a4, b4[0], b4[1]);
      mma_bf16(s[2 * jj + 1], a4, b4[2], b4[3]);
    }
  };
  if constexpr (kGeneric) {
    const bf16* arow =
        as + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
    for (int ks = 0; ks < hd / 16; ++ks) {
      unsigned a4[4];
      ldsm4<false>(a4, arow + 16 * ks);
      step(a4, ks);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) step(af[ks], ks);
  }
}

// acc += a B for k-step kk: a the warp's A fragment of rows x (16 kk ..
// 16 kk + 15), B's rows those 16 in shared memory (bs, stride ld; its
// first wc columns, wc a multiple of 16: 64 unless kGeneric), read by
// ldmatrix.trans.
template <bool kGeneric>
__device__ __forceinline__ void pv_step(float (&acc)[8][4],
                                        const unsigned (&a4)[4],
                                        const bf16* bs, int ld, int kk,
                                        int wc) {
  const int lane = threadIdx.x % 32;
  const bf16* brow =
      bs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
      8 * (lane >> 4);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!kGeneric || 16 * jj < wc) {
      unsigned b4[4];
      ldsm4<true>(b4, brow + 16 * jj);
      mma_bf16(acc[2 * jj], a4, b4[0], b4[1]);
      mma_bf16(acc[2 * jj + 1], a4, b4[2], b4[3]);
    }
  }
}

// 2^x (ex2.approx.ftz, the instruction exp2f compiles to, without the
// rescaling of subnormal results)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e / l for 0 <= e <= 1 <= l by one FMA correction of e (1 / l), il the
// correctly rounded 1 / l: the correctly rounded quotient (Markstein) for
// normal quotients, with no branch
__device__ __forceinline__ float div_by(float e, float l, float il) {
  const float q = e * il;
  return fmaf(fmaf(-l, q, e), il, q);
}

// round(acc scale) of the warp's 16 rows x wc columns into its staging
// tile st (stride kLdStg)
__device__ __forceinline__ void stage_acc(bf16* st, const float (&acc)[8][4],
                                          float scale, int wc) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j < wc) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<unsigned*>(st + (g + 8 * hf) * kLdStg + 8 * j +
                                     2 * t4) =
            pack2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
}

// fn(r, c) for each 16-byte vector (row r, column c) of a [64 x width]
// bf16 tile that this thread of kBThreads takes; width a multiple of 8
// (64: no division, one vector column a thread)
template <typename F>
__device__ __forceinline__ void tile_vecs(int width, F&& fn) {
  const int tid = threadIdx.x;
  if (width == kKeyTile) {
    const int c = tid % 8 * 8;
#pragma unroll
    for (int r = tid / 8; r < kKeyTile; r += kBThreads / 8) fn(r, c);
  } else {
    const int per = width / 8;
    for (int i = tid; i < kKeyTile * per; i += kBThreads)
      fn(i / per, i % per * 8);
  }
}

// The warp's staged rows (the first `rows` of 16, `cols` columns) to dst
// (stride ldd), 16 bytes a store.
__device__ __forceinline__ void warp_store(bf16* dst, size_t ldd,
                                           const bf16* st, int rows,
                                           int cols) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
  if (cols == kKeyTile) {
    const int c = lane % 8 * 8;
    for (int r = lane / 8; r < rows; r += 4)
      st16(dst + r * ldd + c, ld16(st + r * kLdStg + c));
  } else {
    const int per = cols / 8;
    for (int i = lane; i < rows * per; i += 32) {
      const int r = i / per, c = i % per * 8;
      st16(dst + r * ldd + c, ld16(st + r * kLdStg + c));
    }
  }
  __syncwarp();
}

// The K/V ring of vft_attn_kt_bwd and vft_attn_kt_fwd: tile t of a stream
// of `count` key tiles sits in slot seq % stages (seq counts the tiles of
// every stream). start loads the stream's first tile; wait(t) waits for
// tile t, starts tile t + 1 (two slots) and returns its K (V follows);
// done(t) starts tile t + 1 once every warp is done with the one slot.
struct KvRing {
  unsigned char* base;  // slot 0
  size_t slot;          // bytes of a slot: K and V, 64 rows of ld each
  const bf16* qkv;      // [R, 3D]
  size_t row0;          // the image's first row
  int stages, ld, hd, n, n_real, d, h, seq;
  bool resid;

  // K (and V) of the key tile at c0 into slot s (keys >= n, padded value
  // rows, and with resid padded key rows, as zeros); one commit group
  __device__ void load(int c0, int s, bool with_v) const {
    bf16* ks = reinterpret_cast<bf16*>(base + s * slot);
    bf16* vs = ks + kKeyTile * ld;
    tile_vecs(hd, [&](int r, int c) {
      const int key = c0 + r;
      const bf16* src =
          qkv + (row0 + vf::imin(key, n - 1)) * 3 * d + h * hd + c;
      cp16(ks + r * ld + c, src + d, key < n && !(resid && key >= n_real));
      if (with_v) cp16(vs + r * ld + c, src + 2 * d, key < n_real);
    });
    cp_commit();
  }
  __device__ void start(bool with_v) {
    if (stages == 1) __syncthreads();  // the slot's last readers
    load(0, seq % stages, with_v);
  }
  __device__ const bf16* wait(int t, int count, bool with_v) {
    cp_wait_all();
    __syncthreads();
    if (stages > 1 && t + 1 < count)
      load((t + 1) * kKeyTile, (seq + 1) % stages, with_v);
    return reinterpret_cast<const bf16*>(base + (seq % stages) * slot);
  }
  __device__ void done(int t, int count, bool with_v) {
    ++seq;
    if (stages == 1 && t + 1 < count) {
      __syncthreads();
      load((t + 1) * kKeyTile, 0, with_v);
    }
  }
};

// Pass 1 of vft_attn_kt_bwd and vft_attn_kt_fwd: the max m (of s tau log2
// e) and the sum l of 2^(s tau log2 e - m) over the real keys of the
// thread's two rows (m0, l0: row g of the warp's 16; m1, l1: row g + 8),
// reduced over the quad, streaming K through the ring. The A operand as
// qk_tile takes it (qa, or with kGeneric the warp's rows at qw).
template <bool kGeneric>
__device__ void kt_pass1(KvRing& ring, bool active,
                         const unsigned (&qa)[4][4], const bf16* qw,
                         float tl2, float& m0, float& m1, float& l0,
                         float& l1) {
  const int t4 = threadIdx.x % 4, n_real = ring.n_real;
  m0 = m1 = -INFINITY;
  l0 = l1 = 0.0f;
  const int tiles1 = (n_real + kKeyTile - 1) / kKeyTile;
  ring.start(false);
  for (int t = 0; t < tiles1; ++t) {
    const bf16* k = ring.wait(t, tiles1, false);
    if (active) {
      const int c0 = t * kKeyTile;
      float s[8][4];
      qk_tile<kGeneric, 8>(s, qa, qw, k, ring.ld, ring.hd);
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = c0 + 8 * j + 2 * t4 + e < n_real;
          x0 = in ? fmaxf(x0, s[j][e] * tl2) : x0;
          x1 = in ? fmaxf(x1, s[j][2 + e] * tl2) : x1;
        }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = c0 + 8 * j + 2 * t4 + e < n_real;
          s0 += in ? ex2(s[j][e] * tl2 - n0) : 0.0f;
          s1 += in ? ex2(s[j][2 + e] * tl2 - n1) : 0.0f;
        }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      l0 = l0 * ex2(m0 - n0) + s0;
      l1 = l1 * ex2(m1 - n1) + s1;
      m0 = n0;
      m1 = n1;
    }
    ring.done(t, tiles1, false);
  }
}

// The f32 p of score sv at column col of a row with pass 1's m and l (il
// = 1 / l): 2^(sv tau log2 e - m) / l, 0 on padded keys.
__device__ __forceinline__ float kt_p(float sv, float tl2, float m, float l,
                                      float il, int col, int n_real) {
  const float p = div_by(ex2(sv * tl2 - m), l, il);
  return col < n_real ? p : 0.0f;
}

// The keep bits (vf::keep4's stream, site kSiteP + h) of the thread's 32
// elements of the key tile at c0: bit 4 j + 2 hf + e for column c0 + 8 j +
// 2 t4 + e of row hf (rw0, rw1; 0 on padded rows and keys). The even lane
// of a pair draws its first row's group of 4 columns, the odd lane its
// second row's (the same group), and they swap halves: one Philox call per
// thread and 8 keys. kUnroll calls at once (all 8 spill in the backward;
// the forward, held to 128 registers, takes 2).
template <int kUnroll>
__device__ __forceinline__ unsigned kt_keep(unsigned pkey, int img, int rw0,
                                            int rw1, int n_real, unsigned th,
                                            int c0) {
  const int t4 = threadIdx.x & 3;
  unsigned kb = 0u;
  const int odd = t4 & 1, row = odd ? rw1 : rw0, sh = 2 * odd;
#pragma unroll(kUnroll)
  for (int j = 0; j < 8; ++j) {
    const int grp = c0 / 4 + 2 * j + (t4 >> 1), c = 4 * grp;
    const uint4 w = vf::philox(pkey, img, row, grp);
    const bool on = row < n_real;
    const unsigned nib = (unsigned)(on && c < n_real && w.x >= th) |
                         (unsigned)(on && c + 1 < n_real && w.y >= th) << 1 |
                         (unsigned)(on && c + 2 < n_real && w.z >= th) << 2 |
                         (unsigned)(on && c + 3 < n_real && w.w >= th) << 3;
    const unsigned other = __shfl_xor_sync(0xffffffffu, nib, 1);
    const unsigned n0 = odd ? other : nib, n1 = odd ? nib : other;
    kb |= ((n0 >> sh) & 3u) << (4 * j) | ((n1 >> sh) & 3u) << (4 * j + 2);
  }
  return kb;
}

// One CTA per (64-row query tile, head, image): see above. kDrop: the
// dropout instance (keep bits of mask_p); kGeneric: a head width other
// than 64 (Q and cb read from shared memory, ctx and q_bar in 64-column
// chunks). The per-element code is straight-line: absent cotangents read
// as zeros, rates of 0 as kept bits, padding by selection.
template <bool kDrop, bool kGeneric>
__global__ void __launch_bounds__(kBThreads) vft_attn_kt_bwd(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the hd = 64 instance knows its width (the launch routes by it)
  const int n = a.n_pad, n_real = a.n_real, d = a.d;
  const int hd = kGeneric ? d / a.heads : kKeyTile;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kKeyTile;
  const KtbPlan pl = ktb_plan(hd, n, kDrop);
  const int ld = pl.ld, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(smem + pl.q);
  bf16* cbs = reinterpret_cast<bf16*>(smem + pl.cb);
  bf16* stg = reinterpret_cast<bf16*>(smem + pl.stg) + warp * 16 * kLdStg;
  unsigned* kbits = reinterpret_cast<unsigned*>(smem + pl.bits);
  const size_t row0 = (size_t)b * n, bh = (size_t)b * a.heads + h;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* cb = static_cast<const bf16*>(a.cb);
  const int wr = q0 + 16 * warp;  // the warp's first query row
  const bool active = wr < n;
  const int wrows = vf::imin(16, n - wr);
  const int rw0 = wr + g, rw1 = wr + g + 8;  // the thread's two rows
  const bool real0 = rw0 < n_real, real1 = rw1 < n_real;
  const int tiles = (n + kKeyTile - 1) / kKeyTile;
  const float tl2 = a.qk_scale * 1.4426950408889634f;
  const bool drop_p = kDrop && a.drop.th_p;
  const float sc = drop_p ? a.drop.sc_p : 1.0f;
  const unsigned pkey = vf::site_key(a.drop.seed, vf::kSiteP + h);

  // Q and cb of the query tile (rows >= n, and with resid padded rows of
  // q, as zeros)
  tile_vecs(hd, [&](int r, int c) {
    const int qi = q0 + r;
    const size_t src = row0 + vf::imin(qi, n - 1);
    cp16(qs + r * ld + c, qkv + src * 3 * d + h * hd + c,
         qi < n && !(a.resid && qi >= n_real));
    cp16(cbs + r * ld + c, cb + src * d + h * hd + c, qi < n);
  });
  cp_commit();
  // each row's JaSMin columns and cotangents (columns -1 and zeros
  // without the cotangent); g_attn (zeros without it)
  const float* gjb = a.g_jas != nullptr ? a.g_jas + bh * 5 * n : nullptr;
  const int* jib = gjb != nullptr ? a.jas_idx + bh * 4 * n : nullptr;
  float gj0[6], gj1[6];  // [5]: gj[4] / 2
  int jc0[4], jc1[4];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    gj0[i] = gjb != nullptr && real0 ? gjb[i * n + rw0] : 0.0f;
    gj1[i] = gjb != nullptr && real1 ? gjb[i * n + rw1] : 0.0f;
  }
  gj0[5] = 0.5f * gj0[4];
  gj1[5] = 0.5f * gj1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    jc0[i] = jib != nullptr && real0 ? jib[i * n + rw0] : -1;
    jc1[i] = jib != nullptr && real1 ? jib[i * n + rw1] : -1;
  }
  const bf16* gat = a.g_attn != nullptr
                        ? static_cast<const bf16*>(a.g_attn) + bh * n * n
                        : nullptr;
  cp_wait_all();
  __syncthreads();
  unsigned qa[4][4], ca[4][4];
  if constexpr (!kGeneric) {
    const int o = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                  8 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      ldsm4<false>(qa[ks], qs + o + 16 * ks);
      ldsm4<false>(ca[ks], cbs + o + 16 * ks);
    }
  }
  const bf16* qw = qs + 16 * warp * ld;
  const bf16* cw = cbs + 16 * warp * ld;

  KvRing ring = {smem + pl.ring, pl.slot, qkv, row0, pl.stages, ld, hd, n,
                 n_real, d, h, 0, a.resid != 0};
  // the full p_bar of a real row's real key from cb v^T (pb), its keep
  // value mk, g_attn (ga) and its pre-dropout rounded p (pr). pr is a
  // bf16 value in [0, 1], never 1e-12f: the plain versions' clip factor
  // ((pr >= 1e-12) + (pr > 1e-12)) ((pr <= 1) + (pr < 1)) / 4 is 1 inside
  // (1e-12, 1), 1/2 at 1 and 0 below.
  auto pbar_full = [&](float pb, float mk, float ga, const float (&gj)[6],
                       const int (&jc)[4], int col, float pr) {
    float t = pr > 1e-12f ? (pr < 1.0f ? gj[4] : gj[5]) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) t += jc[i] == col ? gj[i] : 0.0f;
    return (kDrop ? pb * mk : pb) + ga + t;
  };
  // g_attn of columns col, col + 1 of row `row` (zeros where absent)
  auto gattn2 = [&](int row, bool real, int col) {
    return gat != nullptr && real && col < n_real
               ? *reinterpret_cast<const unsigned*>(gat + (size_t)row * n +
                                                    col)
               : 0u;
  };

  // pass 1: each row's max and sum over the real keys
  float m0, m1, l0, l1;
  kt_pass1<kGeneric>(ring, active, qa, qw, tl2, m0, m1, l0, l1);
  const float il0 = 1.0f / l0, il1 = 1.0f / l1;
  // the f32 p of score sv at column col (0 on padded keys)
  auto p_of = [&](float sv, int hf, int col) {
    return hf ? kt_p(sv, tl2, m1, l1, il1, col, n_real)
              : kt_p(sv, tl2, m0, l0, il0, col, n_real);
  };

  // pass 2 (per 64 columns of hd): pm, ctx; with the first chunk p_bar,
  // dot, the keep bits and the p scratch
  float dot0 = 0.0f, dot1 = 0.0f;
  bf16* pg = static_cast<bf16*>(a.pg) + bh * n * n;
  bf16* sbg = static_cast<bf16*>(a.sbar) + bh * n * n;
  for (int hc = 0; hc < hd; hc += kKeyTile) {
    const bool first = !kGeneric || hc == 0;
    const int wc = vf::imin(kKeyTile, hd - hc);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    ring.start(true);
    for (int t = 0; t < tiles; ++t) {
      const bf16* k = ring.wait(t, tiles, true);
      const bf16* v = k + kKeyTile * ld;
      const int c0 = t * kKeyTile, kc = vf::imin(kKeyTile, n - c0);
      if (!active) {
        ring.done(t, tiles, true);
        continue;
      }
      unsigned kb = ~0u;
      if (drop_p) {
        unsigned* word = kbits + t * kBThreads + tid;
        kb = first || !pl.keep
                 ? kt_keep<4>(pkey, b, rw0, rw1, n_real, a.drop.th_p, c0)
                 : *word;
        if (first && pl.keep) *word = kb;
      }
      // the tile a k-step (16 keys) at a time
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk) {
        float s[2][4], pb[2][4];
        qk_tile<kGeneric, 2>(s, qa, qw, k + 16 * kk * ld, ld, hd);
        if (first) qk_tile<kGeneric, 2>(pb, ca, cw, v + 16 * kk * ld, ld, hd);
        unsigned a4[4];
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          const int j = 2 * kk + jh, col = c0 + 8 * j + 2 * t4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const bool real = hf ? real1 : real0;
            const unsigned gw = first ? gattn2(hf ? rw1 : rw0, real, col) : 0u;
            float pm[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pf = p_of(s[jh][2 * hf + e], hf, col + e);
              const float pr = rbf(pf);
              const float mk = (kb >> (4 * j + 2 * hf + e)) & 1u ? sc : 0.0f;
              pm[e] = kDrop ? pr * mk : pr;
              if (first) {
                const float pbf = pbar_full(
                    pb[jh][2 * hf + e], mk, e ? bf_hi(gw) : bf_lo(gw),
                    hf ? gj1 : gj0, hf ? jc1 : jc0, col + e, pr);
                const float c = real && col + e < n_real ? pbf * pf : 0.0f;
                if (hf)
                  dot1 += c;
                else
                  dot0 += c;
              }
            }
            const unsigned w = pack2(pm[0], pm[1]);
            a4[hf + 2 * jh] = w;
            if (first)
              *reinterpret_cast<unsigned*>(stg + (g + 8 * hf) * kLdStg +
                                           8 * j + 2 * t4) = real ? w : 0u;
          }
        }
        pv_step<kGeneric>(acc, a4, v + hc, ld, kk, wc);
      }
      if (first) warp_store(pg + (size_t)wr * n + c0, n, stg, wrows, kc);
      ring.done(t, tiles, true);
    }
    if (first) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
    }
    if (active) {
      stage_acc(stg, acc, 1.0f, wc);
      warp_store(static_cast<bf16*>(a.ctx) + (row0 + wr) * d + h * hd + hc, d,
                 stg, wrows, wc);
    }
  }

  // pass 3 (per 64 columns of hd): s_bar, q_bar; with the first chunk the
  // s_bar scratch
  for (int hc = 0; hc < hd; hc += kKeyTile) {
    const bool first = !kGeneric || hc == 0;
    const int wc = vf::imin(kKeyTile, hd - hc);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    ring.start(true);
    for (int t = 0; t < tiles; ++t) {
      const bf16* k = ring.wait(t, tiles, true);
      const bf16* v = k + kKeyTile * ld;
      const int c0 = t * kKeyTile, kc = vf::imin(kKeyTile, n - c0);
      if (!active) {
        ring.done(t, tiles, true);
        continue;
      }
      unsigned kb = ~0u;
      if (drop_p)
        kb = pl.keep ? kbits[t * kBThreads + tid]
                     : kt_keep<4>(pkey, b, rw0, rw1, n_real, a.drop.th_p, c0);
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk) {
        float s[2][4], pb[2][4];
        qk_tile<kGeneric, 2>(s, qa, qw, k + 16 * kk * ld, ld, hd);
        qk_tile<kGeneric, 2>(pb, ca, cw, v + 16 * kk * ld, ld, hd);
        unsigned a4[4];
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          const int j = 2 * kk + jh, col = c0 + 8 * j + 2 * t4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const bool real = hf ? real1 : real0;
            const unsigned gw = gattn2(hf ? rw1 : rw0, real, col);
            float sv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pf = p_of(s[jh][2 * hf + e], hf, col + e);
              const float mk = (kb >> (4 * j + 2 * hf + e)) & 1u ? sc : 0.0f;
              const float pbf = pbar_full(
                  pb[jh][2 * hf + e], mk, e ? bf_hi(gw) : bf_lo(gw),
                  hf ? gj1 : gj0, hf ? jc1 : jc0, col + e, rbf(pf));
              sv[e] = real && col + e < n_real
                          ? pf * (pbf - (hf ? dot1 : dot0))
                          : 0.0f;
            }
            const unsigned w = pack2(sv[0], sv[1]);
            a4[hf + 2 * jh] = w;
            if (first)
              *reinterpret_cast<unsigned*>(stg + (g + 8 * hf) * kLdStg +
                                           8 * j + 2 * t4) = w;
          }
        }
        pv_step<kGeneric>(acc, a4, k + hc, ld, kk, wc);
      }
      if (first) warp_store(sbg + (size_t)wr * n + c0, n, stg, wrows, kc);
      ring.done(t, tiles, true);
    }
    if (active) {
      stage_acc(stg, acc, a.qk_scale, wc);
      warp_store(static_cast<bf16*>(a.qkvb) + (row0 + wr) * 3 * d + h * hd +
                     hc,
                 3 * d, stg, wrows, wc);
    }
  }
}

// Puts (v, c) into a lane's top list (kk entries of stride kBThreads in
// shared memory, value descending) where v is strictly greater than its
// kk-th value, behind the entries equal to v, the last entry falling off.
// c is past every column of the list, so this keeps ties in column order.
__device__ __forceinline__ void lane_insert(float* tv, int* tc, int kk,
                                            float v, int c) {
  constexpr int S = kBThreads;
  if (!(v > tv[(kk - 1) * S])) return;
  int i = kk - 1;
  for (; i > 0 && tv[(i - 1) * S] < v; --i) {
    tv[i * S] = tv[(i - 1) * S];
    tc[i * S] = tc[(i - 1) * S];
  }
  tv[i * S] = v;
  tc[i * S] = c;
}

// The warp's staged keep flags (bf16 1 or 0; the first `rows` of 16,
// `cols` columns) to dst (f32, stride ldd) as sc or 0, 16 bytes a store.
__device__ __forceinline__ void warp_store_mask(float* dst, size_t ldd,
                                                const bf16* st, int rows,
                                                int cols, float sc) {
  const int lane = threadIdx.x % 32, per = cols / 8;
  __syncwarp();
  for (int i = lane; i < rows * per; i += 32) {
    const int r = i / per, c = i % per * 8;
    const uint4 f = ld16(st + r * kLdStg + c);
    const unsigned w[4] = {f.x, f.y, f.z, f.w};
    unsigned o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = __float_as_uint(bf_lo(w[e]) * sc);
      o[2 * e + 1] = __float_as_uint(bf_hi(w[e]) * sc);
    }
    st16(dst + r * ldd + c, make_uint4(o[0], o[1], o[2], o[3]));
    st16(dst + r * ldd + c + 4, make_uint4(o[4], o[5], o[6], o[7]));
  }
  __syncwarp();
}

// One CTA per (64-row query tile, head, image): the forward's softmax
// attention past kMaxCols padded tokens (see above). kDrop: the dropout
// instance (keep bits of mask_p, drawn as vft_attn_kt_bwd draws them);
// kGeneric: a head width other than 64 (Q read from shared memory, ctx in
// 64-column chunks). Modes: a.mode (plain, JaSMin statistics, the map),
// the map, the statistics and mask_p from the first chunk.
template <bool kDrop, bool kGeneric>
__global__ void __launch_bounds__(kBThreads, kGeneric ? 1 : 4)
    vft_attn_kt_fwd(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, n_real = a.n_real, d = a.d;
  const int hd = kGeneric ? d / a.heads : kKeyTile;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kKeyTile;
  const KtfPlan pl = ktf_plan(hd);
  const int ld = pl.ld, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(smem + pl.q);
  bf16* stg = reinterpret_cast<bf16*>(smem + pl.stg) + warp * 16 * kLdStg;
  const bool jas = a.mode == kJasmin, map = a.mode == kMap;
  const int kk = a.jas_kk;
  // the lanes' top lists: values, then columns; this thread's of its
  // rows hf at lv + hf * kk * kBThreads (entries kBThreads apart)
  float* lv = reinterpret_cast<float*>(smem + pl.top);
  int* lc = reinterpret_cast<int*>(lv + 2 * kk * kBThreads);
  float *tv0 = lv + tid, *tv1 = tv0 + kk * kBThreads;
  int *tc0 = lc + tid, *tc1 = tc0 + kk * kBThreads;
  const size_t row0 = (size_t)b * n, bh = (size_t)b * a.heads + h;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const int wr = q0 + 16 * warp;  // the warp's first query row
  const bool active = wr < n;
  const int wrows = vf::imin(16, n - wr);
  const int rw0 = wr + g, rw1 = wr + g + 8;  // the thread's two rows
  const bool real0 = rw0 < n_real, real1 = rw1 < n_real;
  const int tiles = (n + kKeyTile - 1) / kKeyTile;
  const float tl2 = a.qk_scale * 1.4426950408889634f;
  const bool drop_p = kDrop && a.drop.th_p;
  const float sc = drop_p ? a.drop.sc_p : 1.0f;
  const unsigned pkey = vf::site_key(a.drop.seed, vf::kSiteP + h);
  const bool masks = drop_p && a.mask_p != nullptr;
  // the map's and mask_p's rows of the warp from column c0 (taken from
  // the arguments where used: two 64-bit pointers fewer in the loop)
  auto at = [&](auto* base, int c0) { return base + (bh * n + wr) * n + c0; };

  // Q of the query tile (rows >= n, and with resid padded rows, as zeros)
  tile_vecs(hd, [&](int r, int c) {
    const int qi = q0 + r;
    cp16(qs + r * ld + c,
         qkv + (row0 + vf::imin(qi, n - 1)) * 3 * d + h * hd + c,
         qi < n && !(a.resid && qi >= n_real));
  });
  cp_commit();
  if (jas)
    for (int i = 0; i < kk; ++i) {
      tv0[i * kBThreads] = tv1[i * kBThreads] = -INFINITY;
      tc0[i * kBThreads] = tc1[i * kBThreads] = 1 << 30;
    }
  cp_wait_all();
  __syncthreads();
  unsigned qa[4][4];
  if constexpr (!kGeneric) {
    const int o = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                  8 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldsm4<false>(qa[ks], qs + o + 16 * ks);
  }
  const bf16* qw = qs + 16 * warp * ld;

  KvRing ring = {smem + pl.ring, pl.slot, qkv, row0, pl.stages, ld, hd, n,
                 n_real, d, h, 0, a.resid != 0};
  // pass 1: each row's max and sum over the real keys
  float m0, m1, l0, l1;
  kt_pass1<kGeneric>(ring, active, qa, qw, tl2, m0, m1, l0, l1);
  const float il0 = 1.0f / l0, il1 = 1.0f / l1;

  // pass 2 (per 64 columns of hd): p, pm and ctx; with the first chunk
  // the map, mask_p and the statistics. thr: the lane's kk-th value of
  // the row when the tile began (values not above it cannot enter), js:
  // the lane's part of the row's clipped sum.
  float thr0 = -INFINITY, thr1 = -INFINITY, js0 = 0.0f, js1 = 0.0f;
  // a tile's candidates: bit 4 j + 2 hf + e of cm, their p pairs (j, hf)
  // staged as bf16 in the warp's staging tile, word 32 (2 j + hf) + lane
  unsigned* cw = reinterpret_cast<unsigned*>(stg) + lane;
  for (int hc = 0; hc < hd; hc += kKeyTile) {
    const bool first = !kGeneric || hc == 0;
    const int wc = vf::imin(kKeyTile, hd - hc);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    ring.start(true);
    for (int t = 0; t < tiles; ++t) {
      const bf16* k = ring.wait(t, tiles, true);
      const bf16* v = k + kKeyTile * ld;
      const int c0 = t * kKeyTile, kc = vf::imin(kKeyTile, n - c0);
      if (!active) {
        ring.done(t, tiles, true);
        continue;
      }
      const unsigned kb =
          drop_p ? kt_keep<2>(pkey, b, rw0, rw1, n_real, a.drop.th_p, c0)
                 : ~0u;
      unsigned cm = 0u;
      // the tile in halves of 32 keys (the scores of a whole tile beside
      // ctx and Q exceed the 128 registers that four CTAs an SM allow)
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float s[4][4];
        qk_tile<kGeneric, 4>(s, qa, qw, k + 32 * half * ld, ld, hd);
#pragma unroll
        for (int ks2 = 0; ks2 < 2; ++ks2) {
          const int ks = 2 * half + ks2;
          unsigned a4[4];
#pragma unroll
          for (int jh = 0; jh < 2; ++jh) {
            const int j = 2 * ks + jh, col = c0 + 8 * j + 2 * t4;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const bool real = hf ? real1 : real0;
              float pr[2], pm[2];
              unsigned pc = 0u;  // this pair's candidates
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float sv = s[2 * ks2 + jh][2 * hf + e];
                pr[e] = rbf(hf ? kt_p(sv, tl2, m1, l1, il1, col + e, n_real)
                               : kt_p(sv, tl2, m0, l0, il0, col + e, n_real));
                const float mk = (kb >> (4 * j + 2 * hf + e)) & 1u ? sc : 0.0f;
                pm[e] = kDrop ? pr[e] * mk : pr[e];
                if (jas && first) {
                  const bool in = real && col + e < n_real;
                  const float cl =
                      in ? fminf(fmaxf(pr[e], 1e-12f), 1.0f) : 0.0f;
                  if (hf)
                    js1 += cl;
                  else
                    js0 += cl;
                  pc |= (unsigned)(in && pr[e] > (hf ? thr1 : thr0)) << e;
                }
              }
              a4[hf + 2 * jh] = pack2(pm[0], pm[1]);
              if (map && first)
                *reinterpret_cast<unsigned*>(stg + (g + 8 * hf) * kLdStg +
                                             8 * j + 2 * t4) =
                    real ? pack2(pr[0], pr[1]) : 0u;
              if (jas && first) {
                cm |= pc << (4 * j + 2 * hf);
                cw[32 * (2 * j + hf)] = pack2(pr[0], pr[1]);
              }
            }
          }
          pv_step<kGeneric>(acc, a4, v + hc, ld, ks, wc);
        }
      }
      // the statistics: this lane's candidates into its lists, in column
      // order (as many steps as the warp's busiest lane has candidates)
      if (jas && first) {
        for (; cm != 0u; cm &= cm - 1u) {
          const int pos = __ffs(cm) - 1, hf = (pos >> 1) & 1;
          const unsigned w = cw[32 * (pos >> 1)];
          lane_insert(hf ? tv1 : tv0, hf ? tc1 : tc0, kk,
                      pos & 1 ? bf_hi(w) : bf_lo(w),
                      c0 + 8 * (pos >> 2) + 2 * t4 + (pos & 1));
        }
        thr0 = tv0[(kk - 1) * kBThreads];
        thr1 = tv1[(kk - 1) * kBThreads];
        __syncwarp();  // the staging tile's next writers
      }
      if (map && first)
        warp_store(at(static_cast<bf16*>(a.pmap), c0), n, stg, wrows, kc);
      if (masks && first) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<unsigned*>(stg + (g + 8 * hf) * kLdStg + 8 * j +
                                         2 * t4) =
                pack2((kb >> (4 * j + 2 * hf)) & 1u ? 1.0f : 0.0f,
                      (kb >> (4 * j + 2 * hf + 1)) & 1u ? 1.0f : 0.0f);
        warp_store_mask(at(a.mask_p, c0), n, stg, wrows, kc, sc);
      }
      ring.done(t, tiles, true);
    }
    if (active) {
      stage_acc(stg, acc, 1.0f, wc);
      warp_store(static_cast<bf16*>(a.ctx) + (row0 + wr) * d + h * hd + hc, d,
                 stg, wrows, wc);
    }
  }
  if (jas && active) {
    js0 += __shfl_xor_sync(0xffffffffu, js0, 1);
    js0 += __shfl_xor_sync(0xffffffffu, js0, 2);
    js1 += __shfl_xor_sync(0xffffffffu, js1, 1);
    js1 += __shfl_xor_sync(0xffffffffu, js1, 2);
    __syncwarp();  // the quad's lists
    if (t4 == 0) {
      // the row's ranks: the four lanes' lists merged, the larger value
      // first, then the earlier column
      float* st = a.stats + bh * 5 * n;
      int* ix = a.idx + bh * 4 * n;
      const int ranks[4] = {0, 1, kk - 2, kk - 1};
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        const int row = hf ? rw1 : rw0;
        const bool real = hf ? real1 : real0;
        const float* qv = (hf ? tv1 : tv0);
        const int* qc = (hf ? tc1 : tc0);
        int at[4] = {0, 0, 0, 0};
        for (int r = 0; r < kk; ++r) {
          float bv = -INFINITY;
          int bc = 1 << 30, bq = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = at[q] < kk ? qv[at[q] * kBThreads + q] : -INFINITY;
            const int c = at[q] < kk ? qc[at[q] * kBThreads + q] : 1 << 30;
            if (v > bv || (v == bv && c < bc)) {
              bv = v;
              bc = c;
              bq = q;
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) at[q] += bq == q;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r == ranks[i]) {
              st[i * n + row] = real ? bv : 0.0f;
              ix[i * n + row] = real ? bc : 0;
            }
        }
        st[4 * n + row] = real ? (hf ? js1 : js0) : 0.0f;
      }
    }
  }
}

// One CTA per (64-key tile, head, image): see above.
__global__ void __launch_bounds__(kBThreads) vft_attn_keys_kt2(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, n_real = a.n_real, d = a.d, hd = d / a.heads;
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * kKeyTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int ld = kLdStg;
  const size_t row0 = (size_t)b * n, bh = (size_t)b * a.heads + h;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* cb = static_cast<const bf16*>(a.cb);
  const bf16* sbg = static_cast<const bf16*>(a.sbar) + bh * n * n;
  const bf16* pgg = static_cast<const bf16*>(a.pg) + bh * n * n;
  const int wr = j0 + 16 * warp;  // the warp's first key
  const bool active = wr < n;
  const int wrows = vf::imin(16, n - wr);
  const int count = (n + kKeyTile - 1) / kKeyTile;
  const float tau = a.qk_scale;
  auto slot = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s & 1) * 4 * kStgTile);
  };
  // query tile t into slot s: s_bar and p [64 q x 64 keys from j0], q and
  // cb [64 q x wc from hc] (rows >= n, with resid padded rows of q, and
  // keys >= n as zeros); one commit group
  auto load = [&](int t, int s, int hc, int wc) {
    bf16* sp = slot(s);
    bf16* pp = sp + kKeyTile * ld;
    bf16* qp = pp + kKeyTile * ld;
    bf16* cp = qp + kKeyTile * ld;
    tile_vecs(kKeyTile, [&](int r, int c) {
      const int q = t * kKeyTile + r;
      const size_t o = (size_t)vf::imin(q, n - 1) * n + vf::imin(j0 + c, n - 8);
      const bool in = q < n && j0 + c < n;
      cp16(sp + r * ld + c, sbg + o, in);
      cp16(pp + r * ld + c, pgg + o, in);
    });
    tile_vecs(wc, [&](int r, int c) {
      const int q = t * kKeyTile + r;
      const size_t src = row0 + vf::imin(q, n - 1);
      cp16(qp + r * ld + c, qkv + src * 3 * d + h * hd + hc + c,
           q < n && !(a.resid && q >= n_real));
      cp16(cp + r * ld + c, cb + src * d + h * hd + hc + c, q < n);
    });
    cp_commit();
  };
  // q = round(q tau) for the vectors this thread copied into slot s (its
  // own copies have landed)
  auto scale_q = [&](int s, int wc) {
    bf16* qp = slot(s) + 2 * kKeyTile * ld;
    tile_vecs(wc, [&](int r, int c) {
      bf16* p = qp + r * ld + c;
      uint4 v = ld16(p);
      unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack2(bf_lo(w[e]) * tau, bf_hi(w[e]) * tau);
      st16(p, v);
    });
  };
  // A fragments of s_bar^T and p^T: this warp's keys, queries 16 kk ..
  const int arow = ((lane & 7) + 8 * (lane >> 4)) * ld + 16 * warp +
                   8 * ((lane >> 3) & 1);
  int seq = 0;
  for (int hc = 0; hc < hd; hc += kKeyTile) {
    const int wc = vf::imin(kKeyTile, hd - hc);
    float kacc[8][4], vacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) kacc[j][e] = vacc[j][e] = 0.0f;
    load(0, seq, hc, wc);
    for (int t = 0; t < count; ++t, ++seq) {
      cp_wait_all();
      scale_q(seq, wc);
      __syncthreads();
      if (t + 1 < count) load(t + 1, seq + 1, hc, wc);
      if (active) {
        const bf16* sp = slot(seq);
        const bf16* pp = sp + kKeyTile * ld;
        const bf16* qp = pp + kKeyTile * ld;
        const bf16* cp = qp + kKeyTile * ld;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned as[4], ap[4];
          ldsm4<true>(as, sp + arow + 16 * kk * ld);
          ldsm4<true>(ap, pp + arow + 16 * kk * ld);
          pv_step<true>(kacc, as, qp, ld, kk, wc);
          pv_step<true>(vacc, ap, cp, ld, kk, wc);
        }
      }
    }
    __syncthreads();  // the slots are free: they stage the results
    if (active) {
      bf16* st = slot(0) + warp * 16 * kLdStg;
      bf16* o = static_cast<bf16*>(a.qkvb) + (row0 + wr) * 3 * d + d +
                h * hd + hc;
      stage_acc(st, kacc, 1.0f, wc);
      warp_store(o, 3 * d, st, wrows, wc);
      stage_acc(st, vacc, 1.0f, wc);
      warp_store(o + d, 3 * d, st, wrows, wc);
    }
    __syncthreads();
  }
}

}  // namespace vft

// Everything one tiled evaluation or backward needs, passed by pointer from
// Python (ctypes). Scratch buffers are allocated by the caller.
struct TiledArgs {
  const void* x;
  const void* base;        // forward, stage-advance mode: [R, D]
  const void* g;           // backward: the dx cotangent
  const float* g_jas;      // backward: [B, H, 5, n_pad] or null
  const int* jas_idx;      //           [B, H, 4, n_pad]
  const void* g_attn;      // backward: [B, H, n_pad, n_pad] or null
  const float* ga;
  const float* ba;
  const float* gm;
  const float* bm;
  const void* wqkv;
  const void* wout;
  const void* w1;
  const void* w2;
  void* out;               // forward: f(x); backward: x_bar
  float* stats;            // forward, JaSMin mode
  int* idx;
  void* pmap;              // forward, attention-map mode
  void* cna;               // [R, D]
  void* cnm;               // [R, D]
  void* qkv;               // [R, 3D]
  void* h;                 // [R, dh]
  void* ctx;               // [R, D]
  float* ao;               // forward with dropout: attn_o [R, D] f32
  float* mean;             // backward: [R]
  void* gd;                // [R, D]   with dropout: g scaler mask_mo
  void* gd2;               // [R, D]   with dropout: g scaler mask_ao
  float* h1;               // [R, dh] f32
  void* h1b;               // [R, dh]
  void* cb;                // [R, D]
  void* pg;                // [B, H, n_pad, n_pad]
  void* sbar;              // [B, H, n_pad, n_pad]
  void* qkvb;              // [R, 3D]
  float* abar;             // [R, D] f32
  float* mbar;             // [R, D] f32
  float* npart;            // [B, 4, D]; L2 [B, 8, D]
  float* wpart;            // [splits, W]
  float* wbars;            // [W + 4D]: Wqkv, Wout, W1, W2, ga, ba, gm, bm
                           // (L2 [W + 8D]: then qkv_bias, out_bias)
  const float* qkv_bias;   // L2: [3D] f32, else null (the softmax field)
  const float* out_bias;   // L2: [D] f32, else null
  float* l2cs;             // backward, L2: [B, H, query tiles, n_pad]
  float* mask_h;           // forward with dropout, emit_masks: the kept
  float* mask_mo;          // values of each site drawn, f32: [R, dh],
  float* mask_ao;          // [R, D], [R, D], [B, H, n_pad, n_pad]; null
  float* mask_p;           // where not asked for or the rate is 0
  void* rqkv;              // backward with residuals: [R, 3D] (the forward
                           // keeps its qkv scratch as rqkv)
  void* rh1;               // forward, stash: written; backward: read [R, dh]
  int batch, n_pad, n_real, d, heads, dh, mode, jas_kk, mt, splits;
  float scaler, qk_scale;
  float dt;                // forward, Euler and stage-advance modes
  vf::Drop drop;           // all zeros: the deterministic instances
};

namespace vft {

GemmArgs gemm_args(const void* a, int lda, const void* b, int ldb, int k,
                   int m, int n, int epi, void* out, int ldo) {
  GemmArgs g = {};
  g.a[0] = a;
  g.lda[0] = lda;
  g.b[0] = b;
  g.ldb[0] = ldb;
  g.k[0] = k;
  g.pairs = 1;
  g.m = m;
  g.n = n;
  g.epi = epi;
  g.out = out;
  g.ldo = ldo;
  g.ld32 = n;
  g.ldaux = n;
  return g;
}

// What vft_gemm_tf32 takes: M, N and every K multiples of 16, one or two
// pairs, rows of a multiple of 16 bytes from 16-byte-aligned bases (its
// 16-byte cp.async and the epilogues' 16-byte loads and stores).
bool tf32_ok(const GemmArgs& g) {
  if (g.pairs < 1 || g.pairs > 2 || g.m <= 0 || g.n <= 0 || g.m % 16 ||
      g.n % 16)
    return false;
  for (int p = 0; p < g.pairs; ++p)
    if (g.k[p] <= 0 || g.k[p] % 16 || g.lda[p] % 4 || g.ldb[p] % 4 ||
        reinterpret_cast<uintptr_t>(g.a[p]) % 16 ||
        reinterpret_cast<uintptr_t>(g.b[p]) % 16)
      return false;
  // the epilogues' 16-byte loads and stores
  const void* bufs[] = {g.out, g.out32, g.out2, g.aux, g.res, g.bias,
                        g.mask[0], g.mask[1], g.fout};
  for (const void* b : bufs)
    if (reinterpret_cast<uintptr_t>(b) % 16) return false;
  return g.ldo % 4 == 0 && g.ld32 % 4 == 0 && g.ldaux % 4 == 0;
}

template <bool BT, bool kDrop>
int gemm_tf32(const GemmArgs& g, cudaStream_t st) {
  if (!tf32_ok(g)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(vft_gemm_tf32<BT, kDrop>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTfSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.n + kTfN - 1) / kTfN, (g.m + kTfM - 1) / kTfM);
  vft_gemm_tf32<BT, kDrop><<<grid, kTfThreads, kTfSmem, st>>>(g);
  return (int)cudaGetLastError();
}

// vft_gemm_wgmma's launches in this library (vft_gemm_wgmma_launches
// reads them), so that a check can see the route's products without a
// profiler
static unsigned long long wgmma_launches;

// What vft_gemm_wgmma takes: M, N and every K multiples of 16, one or two
// pairs, rows of a multiple of 16 bytes from 16-byte-aligned bases (TMA's
// global strides and addresses, the epilogues' 16-byte loads and stores).
bool wgmma_ok(const GemmArgs& g) {
  if (g.pairs < 1 || g.pairs > 2 || g.m <= 0 || g.n <= 0 || g.m % 16 ||
      g.n % 16)
    return false;
  for (int p = 0; p < g.pairs; ++p)
    if (g.k[p] <= 0 || g.k[p] % 16 || g.lda[p] % 8 || g.ldb[p] % 8 ||
        reinterpret_cast<uintptr_t>(g.a[p]) % 16 ||
        reinterpret_cast<uintptr_t>(g.b[p]) % 16)
      return false;
  const void* bufs[] = {g.out, g.out32, g.out2, g.aux, g.res, g.bias,
                        g.mask[0], g.mask[1], g.fout};
  for (const void* b : bufs)
    if (reinterpret_cast<uintptr_t>(b) % 16) return false;
  // kMacResid's aux is read through the input chunks, at ldaux
  return g.ldo % 8 == 0 && g.ld32 % 4 == 0 && g.ldaux % 4 == 0 &&
         (g.epi != kMacResid || g.ldaux == g.ld32);
}

// The SMs of the current device (the persistent grid's size at most).
int wg_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// One bf16 product on vft_gemm_wgmma.
template <bool BT, bool kDrop>
int gemm_bf16(const GemmArgs& g, cudaStream_t st) {
  if (!wgmma_ok(g) || wg_sms() == 0) return (int)cudaErrorInvalidValue;
  WgMaps maps = {};
  for (int p = 0; p < g.pairs; ++p) {
    const bool b_ok =
        BT ? encode_operand(&maps.b[p], g.b[p], g.n, g.k[p], g.ldb[p], kWgN)
           : encode_operand(&maps.b[p], g.b[p], g.k[p], g.n, g.ldb[p], kWgK);
    if (!b_ok ||
        !encode_operand(&maps.a[p], g.a[p], g.m, g.k[p], g.lda[p], kWgM))
      return (int)cudaErrorInvalidValue;
  }
  const int input = wg_input(g);
  if (input == 1 &&
      !encode_operand(&maps.in, g.aux, g.m, g.n, g.ldaux, 64, 4))
    return (int)cudaErrorInvalidValue;
  if (input == 2 && !encode_operand(&maps.in, g.res, g.m, g.n, g.ldo, 64))
    return (int)cudaErrorInvalidValue;
  auto kernel = vft_gemm_wgmma<BT, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (g.m + kWgM - 1) / kWgM * ((g.n + kWgN - 1) / kWgN);
  kernel<<<tiles < wg_sms() ? tiles : wg_sms(), kWgThreads, kWgSmem, st>>>(
      maps, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++wgmma_launches;
  return (int)err;
}

// The route's products: bf16 on vft_gemm_wgmma, f32 on vft_gemm_tf32 (a
// shape either does not take returns cudaErrorInvalidValue).
template <typename T, bool BT, bool kDrop = false>
int gemm(const GemmArgs& g, cudaStream_t st) {
  if (sizeof(T) != 2) return gemm_tf32<BT, kDrop>(g, st);
  return gemm_bf16<BT, kDrop>(g, st);
}

// mask i of a dropout epilogue: the keep mask of `site` (mask_h and mask_mo
// at mlp_drop, mask_ao at proj_drop)
void gemm_mask(GemmArgs& g, int i, const TiledArgs& t, int site) {
  const bool ao = site == vf::kSiteAttnOut;
  g.key[i] = vf::site_key(t.drop.seed, site);
  g.th[i] = ao ? t.drop.th_ao : t.drop.th_m;
  g.sc[i] = ao ? t.drop.sc_ao : t.drop.sc_m;
  g.n_pad = t.n_pad;
  g.n_real = t.n_real;
}

AttnArgs attn_args(const TiledArgs& t) {
  AttnArgs a = {};
  a.qkv = t.rqkv != nullptr ? t.rqkv : t.qkv;
  a.resid = t.rqkv != nullptr;
  a.cb = t.cb;
  a.ctx = t.ctx;
  a.pmap = t.pmap;
  a.stats = t.stats;
  a.idx = t.idx;
  a.g_attn = t.g_attn;
  a.g_jas = t.g_jas;
  a.jas_idx = t.jas_idx;
  a.pg = t.pg;
  a.sbar = t.sbar;
  a.qkvb = t.qkvb;
  a.l2cs = t.l2cs;
  a.mask_p = t.mask_p;
  a.n_pad = t.n_pad;
  a.n_real = t.n_real;
  a.d = t.d;
  a.heads = t.heads;
  a.mt = t.mt;
  // the Euler and stage-advance modes attend as the plain mode
  a.mode = t.mode == kJasmin || t.mode == kMap ? t.mode : kPlain;
  a.jas_kk = t.jas_kk;
  a.qk_scale = t.qk_scale;
  a.drop = t.drop;
  return a;
}

// Launches of the key-tiled backward attention CTAs, counted by the host
// where it launches them: [0] vft_attn_kt_bwd, [1] vft_attn_keys_kt2 (the
// bf16 softmax pair), [2] vft_attn_kt with kBwd, [3] vft_attn_keys_kt.
// vft_kt_bwd_launches reads them, so that a check can see which CTAs a
// backward took without a profiler (which can drop a kernel's events).
static unsigned long long kt_bwd_launches[4];

// Launches of the key-tiled forward attention CTAs, counted as above: [0]
// vft_attn_kt_fwd (the bf16 softmax forward), [1] vft_attn_kt without
// kBwd (f32 and L2). vft_kt_fwd_launches reads them.
static unsigned long long kt_fwd_launches[2];

// The key-tiled attention CTA past kMaxCols padded tokens; its JaSMin
// mode keeps at most kMaxJas extraction passes.
template <typename T, bool kBwd, bool kDrop, bool kL2>
int attn_kt(const TiledArgs& t, cudaStream_t st) {
  if (!kBwd && t.mode == kJasmin && t.jas_kk > kMaxJas)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kt_plan(t.d / t.heads, t.mt, sizeof(T), kBwd).total;
  cudaError_t err = cudaFuncSetAttribute(
      vft_attn_kt<T, kBwd, kDrop, kL2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t.n_pad + t.mt - 1) / t.mt, t.heads, t.batch);
  vft_attn_kt<T, kBwd, kDrop, kL2><<<grid, vf::kThreads, smem, st>>>(
      attn_args(t));
  ++(kBwd ? kt_bwd_launches[2] : kt_fwd_launches[1]);
  return (int)cudaGetLastError();
}

// The bf16 softmax forward's CTA past kMaxCols padded tokens
// (vft_attn_kt_fwd; kGeneric for head widths other than 64), on a grid of
// 64-row query tiles; its JaSMin mode keeps at most kMaxJas entries a row.
template <bool kDrop>
int attn_kt_fwd(const TiledArgs& t, cudaStream_t st) {
  if (t.mode == kJasmin && t.jas_kk > kMaxJas)
    return (int)cudaErrorInvalidValue;
  const int hd = t.d / t.heads;
  const KtfPlan pl = ktf_plan(hd);
  const size_t smem = pl.top + (t.mode == kJasmin ? lane_lists(t.jas_kk) : 0);
  void (*kernel)(AttnArgs) = hd != 64 ? &vft_attn_kt_fwd<kDrop, true>
                                      : &vft_attn_kt_fwd<kDrop, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t.n_pad + kKeyTile - 1) / kKeyTile, t.heads, t.batch);
  kernel<<<grid, kBThreads, smem, st>>>(attn_args(t));
  ++kt_fwd_launches[0];
  return (int)cudaGetLastError();
}

// The bf16 softmax backward's query-major CTA past kMaxCols padded tokens
// (vft_attn_kt_bwd; kGeneric for head widths other than 64).
template <bool kDrop>
int attn_kt_bwd(const TiledArgs& t, cudaStream_t st) {
  const int hd = t.d / t.heads;
  const size_t smem = ktb_plan(hd, t.n_pad, kDrop).total;
  void (*kernel)(AttnArgs) = hd != 64 ? &vft_attn_kt_bwd<kDrop, true>
                                      : &vft_attn_kt_bwd<kDrop, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t.n_pad + kKeyTile - 1) / kKeyTile, t.heads, t.batch);
  kernel<<<grid, kBThreads, smem, st>>>(attn_args(t));
  ++kt_bwd_launches[0];
  return (int)cudaGetLastError();
}

// The attention CTAs of one evaluation or backward: whole rows up to
// kMaxCols padded tokens, key tiles past that (bf16 softmax on
// vft_attn_kt_fwd and vft_attn_kt_bwd).
template <typename T, bool kBwd, bool kDrop, bool kL2 = false>
int attn(const TiledArgs& t, cudaStream_t st) {
  if (t.n_pad > kMaxCols) {
    if constexpr (!kL2 && std::is_same<T, bf16>::value) {
      if constexpr (kBwd)
        return attn_kt_bwd<kDrop>(t, st);
      else
        return attn_kt_fwd<kDrop>(t, st);
    } else {
      return attn_kt<T, kBwd, kDrop, kL2>(t, st);
    }
  }
  const int hd = t.d / t.heads;
  const size_t smem =
      attn_plan(t.n_pad, hd, t.mt, sizeof(T), kBwd, kDrop, kL2).total;
  cudaError_t err = cudaFuncSetAttribute(
      vft_attn<T, kBwd, kDrop, kL2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t.n_pad + t.mt - 1) / t.mt, t.heads, t.batch);
  vft_attn<T, kBwd, kDrop, kL2><<<grid, vf::kThreads, smem, st>>>(
      attn_args(t));
  return (int)cudaGetLastError();
}

// The key-tile kernel of the backward (its L2 instance with kL2), over
// every query at once up to kMaxCols padded tokens, a query tile at a time
// past that (bf16 softmax: vft_attn_keys_kt2).
template <typename T, bool kL2>
int attn_keys(const TiledArgs& t, cudaStream_t st) {
  const dim3 grid((t.n_pad + kKeyTile - 1) / kKeyTile, t.heads, t.batch);
  if constexpr (!kL2 && std::is_same<T, bf16>::value) {
    if (t.n_pad > kMaxCols) {
      cudaError_t err = cudaFuncSetAttribute(
          vft_attn_keys_kt2, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kKeybSmem);
      if (err != cudaSuccess) return (int)err;
      vft_attn_keys_kt2<<<grid, kBThreads, kKeybSmem, st>>>(attn_args(t));
      ++kt_bwd_launches[1];
      return (int)cudaGetLastError();
    }
  }
  if (t.n_pad > kMaxCols) {
    const size_t smem = key_kt_plan(t.d / t.heads, t.mt, sizeof(T)).total;
    cudaError_t err = cudaFuncSetAttribute(
        vft_attn_keys_kt<T, kL2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    vft_attn_keys_kt<T, kL2><<<grid, vf::kThreads, smem, st>>>(attn_args(t));
    ++kt_bwd_launches[3];
    return (int)cudaGetLastError();
  }
  const size_t ksmem = key_plan(t.n_pad, t.d / t.heads, sizeof(T), kL2).total;
  cudaError_t err = cudaFuncSetAttribute(
      vft_attn_keys<T, kL2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ksmem);
  if (err != cudaSuccess) return (int)err;
  vft_attn_keys<T, kL2><<<grid, vf::kThreads, ksmem, st>>>(attn_args(t));
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int norm(const TiledArgs& t, bool bwd, cudaStream_t st) {
  const int rows = t.batch * t.n_pad;
  vft_norm<T, kDrop><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(t.x), static_cast<const T*>(t.g), rows, t.n_pad,
      t.n_real, t.d, t.ga, t.ba, t.gm, t.bm, static_cast<T*>(t.cna),
      static_cast<T*>(t.cnm), bwd ? t.mean : nullptr,
      bwd ? static_cast<T*>(t.gd) : nullptr, t.scaler,
      static_cast<T*>(t.gd2), t.drop);
  return (int)cudaGetLastError();
}

#define VFT_CHECK(call)           \
  do {                            \
    const int e_ = (call);        \
    if (e_ != 0) return e_;       \
  } while (0)

bool has_drop(const TiledArgs& t) {
  return t.drop.th_p | t.drop.th_ao | t.drop.th_m;
}

// TiledArgs::mode: the attention modes, then the output's
enum ForwardMode { kEuler = 3, kBase = 4 };

// The L2 instances (biases given) have no dropout, no map and no Euler or
// stage-advance mode, as the TPU kernel's.
bool l2_ok(const TiledArgs& t) {
  return t.qkv_bias == nullptr ||
         (t.out_bias != nullptr && !has_drop(t) &&
          (t.mode == kPlain || t.mode == kJasmin));
}

template <typename T>
int forward(const TiledArgs& t, cudaStream_t st) {
  const int R = t.batch * t.n_pad, d = t.d, dh = t.dh;
  const bool drop = has_drop(t);
  const bool advance = t.mode == kEuler || t.mode == kBase;
  const bool l2 = t.qkv_bias != nullptr;
  // no dropout instance advances the state (nor does the TPU kernel); the
  // stash (rh1) exists for the deterministic softmax plain and JaSMin
  // modes only
  if ((advance && drop) || !l2_ok(t) ||
      (t.rh1 != nullptr && (drop || l2 || advance || t.mode == kMap)))
    return (int)cudaErrorInvalidValue;
  VFT_CHECK((norm<T, false>(t, false, st)));
  GemmArgs qg =
      gemm_args(t.cna, d, t.wqkv, 3 * d, d, R, 3 * d, kRound, t.qkv, 3 * d);
  qg.bias = t.qkv_bias;
  VFT_CHECK((gemm<T, false>(qg, st)));
  GemmArgs hg = gemm_args(t.cnm, d, t.w1, dh, d, R, dh, kGelu, t.h, dh);
  hg.out2 = t.rh1;
  if (drop && t.drop.th_m) {
    // h = round(round(gelu(h1)) mask_h)
    hg.epi = kGeluDrop;
    gemm_mask(hg, 0, t, vf::kSiteH);
    hg.mask[0] = t.mask_h;
    VFT_CHECK((gemm<T, false, true>(hg, st)));
  } else {
    VFT_CHECK((gemm<T, false>(hg, st)));
  }
  VFT_CHECK((l2     ? attn<T, false, false, true>(t, st)
             : drop ? attn<T, false, true>(t, st)
                    : attn<T, false, false>(t, st)));
  if (drop && (t.drop.th_m || t.drop.th_ao)) {
    // attn_o = ctx Wout (f32), then out = round(scaler (mask_mo (h W2) +
    // mask_ao attn_o))
    GemmArgs ao = gemm_args(t.ctx, d, t.wout, d, d, R, d, kF32, nullptr, d);
    ao.out32 = t.ao;
    VFT_CHECK((gemm<T, false>(ao, st)));
    GemmArgs o = gemm_args(t.h, dh, t.w2, d, dh, R, d, kOutDrop, t.out, d);
    o.aux = t.ao;
    o.scale = t.scaler;
    gemm_mask(o, 0, t, vf::kSiteMlpOut);
    gemm_mask(o, 1, t, vf::kSiteAttnOut);
    o.mask[0] = t.drop.th_m ? t.mask_mo : nullptr;
    o.mask[1] = t.drop.th_ao ? t.mask_ao : nullptr;
    return gemm<T, false, true>(o, st);
  }
  // out = round(scaler acc), or with the Euler and stage-advance modes
  // round(res + dt (scaler acc)), res = x or base, read in the epilogue
  GemmArgs o = gemm_args(t.ctx, d, t.wout, d, d, R, d,
                         advance ? kAdvance : kScale, t.out, d);
  o.pairs = 2;
  o.a[1] = t.h;
  o.lda[1] = dh;
  o.b[1] = t.w2;
  o.ldb[1] = d;
  o.k[1] = dh;
  o.scale = t.scaler;
  o.bias = t.out_bias;
  o.res = t.mode == kBase ? t.base : t.x;
  o.dt = t.dt;
  return gemm<T, false>(o, st);
}

// The first `count` weight products of ps (A^T G over the B n_pad rows,
// t.splits slices of rows, into t.wpart), then the fixed-order reduce of
// their partials and of the per-image norm partials (t.npart, `nlen`
// floats an image) into t.wbars: the products' cotangents in order, then
// the norms'.
template <typename T>
int weight_bars(Problems ps, int count, const TiledArgs& t, int nlen,
                cudaStream_t st) {
  ps.total = 0;
  for (int i = 0; i < 4; ++i) {
    if (i >= count) ps.p[i] = {};
    ps.total += (size_t)ps.p[i].m * ps.p[i].n;
  }
  ps.rows = t.batch * t.n_pad;
  VFT_CHECK(wgrad<T>(ps, t.wpart, t.splits, st));
  const size_t all = ps.total + (size_t)nlen;
  vfb_reduce<<<(unsigned)((all + 255) / 256), 256, 0, st>>>(
      t.wpart, t.splits, ps.total, t.npart, t.batch, nlen, t.wbars);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const TiledArgs& t, cudaStream_t st) {
  const int R = t.batch * t.n_pad, d = t.d, dh = t.dh;
  const bool drop = has_drop(t);
  const bool l2 = t.qkv_bias != nullptr;
  const bool resid = t.rqkv != nullptr;
  // L2: no dropout, no map cotangent (nor has the TPU kernel); residuals:
  // both or neither, softmax, no dropout
  if (!l2_ok(t) || (l2 && t.g_attn != nullptr) ||
      resid != (t.rh1 != nullptr) || (resid && (drop || l2)))
    return (int)cudaErrorInvalidValue;
  // with dropout, gd carries mask_mo and gd2 mask_ao
  const void* gda = drop ? t.gd2 : t.gd;
  VFT_CHECK((drop ? norm<T, true>(t, true, st) : norm<T, false>(t, true, st)));
  GemmArgs h1 = gemm_args(t.cnm, d, t.w1, dh, d, R, dh, kGelu, t.h, dh);
  h1.out32 = t.h1;
  // h1_bar = round((gd W2^T) gelu'(h1)); cb = round(gd Wout^T)
  GemmArgs hb = gemm_args(t.gd, d, t.w2, d, d, R, dh, kGeluGrad, t.h1b, dh);
  hb.aux = t.h1;
  if (resid) {
    // h1 from rh1: the epilogue writes h1_bar and h (no h1 or qkv product)
    hb.epi = kGeluGradResid;
    hb.res = t.rh1;
    hb.out2 = t.h;
    hb.n_pad = t.n_pad;
    hb.n_real = t.n_real;
  } else if (drop && t.drop.th_m) {
    // the masked h (for W2_bar) and h1_bar = round(h_bar mask_h gelu'(h1))
    h1.epi = kGeluDrop;
    hb.epi = kGeluGradDrop;
    gemm_mask(h1, 0, t, vf::kSiteH);
    gemm_mask(hb, 0, t, vf::kSiteH);
    VFT_CHECK((gemm<T, false, true>(h1, st)));
  } else {
    VFT_CHECK((gemm<T, false>(h1, st)));
  }
  if (!resid) {
    GemmArgs qg = gemm_args(t.cna, d, t.wqkv, 3 * d, d, R, 3 * d, kRound,
                            t.qkv, 3 * d);
    qg.bias = t.qkv_bias;
    VFT_CHECK((gemm<T, false>(qg, st)));
  }
  VFT_CHECK((hb.epi == kGeluGradDrop ? gemm<T, true, true>(hb, st)
                                     : gemm<T, true>(hb, st)));
  VFT_CHECK((gemm<T, true>(
      gemm_args(gda, d, t.wout, d, d, R, d, kRound, t.cb, d), st)));
  VFT_CHECK((l2     ? attn<T, true, false, true>(t, st)
             : drop ? attn<T, true, true>(t, st)
                    : attn<T, true, false>(t, st)));
  VFT_CHECK((l2 ? attn_keys<T, true>(t, st) : attn_keys<T, false>(t, st)));
  // a_bar = qkv_bar Wqkv^T, m_bar = h1_bar W1^T (f32)
  GemmArgs ab = gemm_args(t.qkvb, 3 * d, t.wqkv, 3 * d, 3 * d, R, d, kF32,
                          nullptr, d);
  ab.out32 = t.abar;
  VFT_CHECK((gemm<T, true>(ab, st)));
  GemmArgs mb = gemm_args(t.h1b, dh, t.w1, dh, dh, R, d, kF32, nullptr, d);
  mb.out32 = t.mbar;
  VFT_CHECK((gemm<T, true>(mb, st)));
  vft_norm_bwd<T><<<t.batch, vf::kThreads, 0, st>>>(
      t.abar, t.mbar, static_cast<const T*>(t.x), t.mean, t.ga, t.gm,
      static_cast<T*>(t.out), t.npart, t.n_pad, t.n_real, d,
      l2 ? static_cast<const T*>(t.qkvb) : nullptr,
      static_cast<const T*>(t.gd));
  VFT_CHECK((int)cudaGetLastError());

  // the weight cotangents: split-K products, then a fixed-order reduce
  // (the kernels of vector_field_bwd.cu)
  Problems ps = {};
  ps.p[0] = {t.cna, t.qkvb, d, 3 * d, 0};
  ps.p[1] = {t.ctx, gda, d, d, (size_t)3 * d * d};
  ps.p[2] = {t.cnm, t.h1b, d, dh, (size_t)4 * d * d};
  ps.p[3] = {t.h, t.gd, dh, d, (size_t)4 * d * d + (size_t)d * dh};
  return weight_bars<T>(ps, 4, t, (l2 ? 8 : 4) * d, st);
}

bool shape_ok(int n_pad, int n_real, int d, int heads, int dh) {
  return heads > 0 && d % heads == 0 && d % 16 == 0 &&
         (d / heads) % 16 == 0 && dh % 16 == 0 && n_pad % 16 == 0 &&
         n_pad > 0 && n_real > 0 && n_real <= n_pad;
}

// Chooses the query-tile rows of the attention kernels: the largest whose
// backward CTA (of the dropout instance with `drop`, of the L2 instance
// with `l2`) fits the shared memory; past kMaxCols padded tokens, of the
// key-tiled instances (whose CTAs, forward, backward and key tile, must
// all fit). There bf16 softmax runs vft_attn_kt_fwd, vft_attn_kt_bwd and
// vft_attn_keys_kt2, whose shared memory does not depend on mt (with
// `drop` the backward's grows with n_pad by the keep bits); the others'
// does not grow with n_pad. Returns 0 with the plan, 1 when the shape has
// none (the wrappers raise). kernels/tiled.py::tiled_plan_rule repeats
// this rule in Python.
int plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
         bool drop, bool l2, int* mt_out, int* smem_fwd_out,
         int* smem_bwd_out, int* smem_keys_out) {
  if (!shape_ok(n_pad, n_real, d, heads, dh)) return 1;
  const int hd = d / heads;
  if (n_pad > kMaxCols) {
    const bool regs = tbytes == 2 && !l2;
    for (int mt : kQTiles) {
      const size_t fwd =
          regs ? ktf_plan(hd).total : kt_plan(hd, mt, tbytes, false).total;
      const size_t bwd = regs ? ktb_plan(hd, n_pad, drop).total
                              : kt_plan(hd, mt, tbytes, true).total;
      const size_t keys = regs ? kKeybSmem : key_kt_plan(hd, mt, tbytes).total;
      if (vf::imax(vf::imax((int)fwd, (int)bwd), (int)keys) <= vf::kMaxSmem) {
        *mt_out = mt;
        *smem_fwd_out = (int)fwd;
        *smem_bwd_out = (int)bwd;
        *smem_keys_out = (int)keys;
        return 0;
      }
    }
    return 1;
  }
  const size_t keys = key_plan(n_pad, hd, tbytes, l2).total;
  if (keys > (size_t)vf::kMaxSmem) return 1;
  for (int mt : kQTiles) {
    const size_t bwd = attn_plan(n_pad, hd, mt, tbytes, true, drop, l2).total;
    if (bwd <= (size_t)vf::kMaxSmem) {
      *mt_out = mt;
      *smem_fwd_out =
          (int)attn_plan(n_pad, hd, mt, tbytes, false, drop, l2).total;
      *smem_bwd_out = (int)bwd;
      *smem_keys_out = (int)keys;
      return 0;
    }
  }
  return 1;
}

}  // namespace vft

// In every library that includes this file: vft::kt_bwd_launches so far.
extern "C" void vft_kt_bwd_launches(unsigned long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = vft::kt_bwd_launches[i];
}

// In every library that includes this file: vft::wgmma_launches so far.
extern "C" unsigned long long vft_gemm_wgmma_launches() {
  return vft::wgmma_launches;
}

// In every library that includes this file: vft::kt_fwd_launches so far.
extern "C" void vft_kt_fwd_launches(unsigned long long* out) {
  for (int i = 0; i < 2; ++i) out[i] = vft::kt_fwd_launches[i];
}

// vector_field_bwd_split.cu and macaron_tiled.cu include this file with
// VFT_KERNELS_ONLY for its kernels and launch helpers; they have entry
// points of their own.
#ifndef VFT_KERNELS_ONLY

extern "C" {

// The plan of vft::plan (query-tile rows, shared memory of the forward,
// backward and key-tile attention CTAs); returns 0 with it, 1 without.
int vft_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int drop, int l2, int* mt_out, int* smem_fwd_out,
             int* smem_bwd_out, int* smem_keys_out) {
  return vft::plan(tbytes, n_pad, n_real, d, heads, dh, drop != 0, l2 != 0,
                   mt_out, smem_fwd_out, smem_bwd_out, smem_keys_out);
}

// One evaluation (mode 0 plain, 1 JaSMin statistics, 2 attention map,
// 3 Euler: x + dt f(x), 4 stage advance: base + dt f(x)) on `stream`;
// returns the first cudaGetLastError() that is not 0, else 0. A nonzero
// threshold in args->drop runs the dropout instances (planned with
// drop=1), which also take the ao scratch (and gd2 in the backward); modes
// 3 and 4 have none and return cudaErrorInvalidValue with one.
int vft_forward(int tbytes, const TiledArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? vft::forward<bf16>(*args, st)
                     : vft::forward<float>(*args, st);
}

// The bf16 softmax forward's attention launch alone, on args->qkv (ctx
// and, by mode, the statistics or the map out; args->mt the plan's): with
// kt vft_attn_kt_fwd at any n_pad that is a multiple of 16, whole-row
// shapes included, else the CTA vft::attn chooses. For measurement; no
// evaluation calls it. Returns as vft_forward.
int vft_attn_fwd_only(int kt, const TiledArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vft::has_drop(*args))
    return kt ? vft::attn_kt_fwd<true>(*args, st)
              : vft::attn<vf::bf16, false, true>(*args, st);
  return kt ? vft::attn_kt_fwd<false>(*args, st)
            : vft::attn<vf::bf16, false, false>(*args, st);
}

// One backward on `stream`; returns as vft_forward.
int vft_backward(int tbytes, const TiledArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? vft::backward<bf16>(*args, st)
                     : vft::backward<float>(*args, st);
}

// One f32 product of the route (vft_gemm_tf32), B stored transposed with
// bt, the dropout epilogues' instance with drop; returns as vft_forward.
int vft_tf32_gemm(int bt, int drop, const vft::GemmArgs* g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bt ? (drop ? vft::gemm_tf32<true, true>(*g, st)
                    : vft::gemm_tf32<true, false>(*g, st))
            : (drop ? vft::gemm_tf32<false, true>(*g, st)
                    : vft::gemm_tf32<false, false>(*g, st));
}

// One bf16 product of the route (vft_gemm_wgmma), B stored transposed
// with bt, the dropout epilogues' instance with drop; returns as
// vft_forward.
int vft_bf16_gemm(int bt, int drop, const vft::GemmArgs* g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bt ? (drop ? vft::gemm_bf16<true, true>(*g, st)
                    : vft::gemm_bf16<true, false>(*g, st))
            : (drop ? vft::gemm_bf16<false, true>(*g, st)
                    : vft::gemm_bf16<false, false>(*g, st));
}

const char* vft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // VFT_KERNELS_ONLY
