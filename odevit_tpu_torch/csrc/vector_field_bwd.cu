// Backward of one evaluation of the ODE-ViT vector field, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// odevit_tpu/kernels/vector_field_bwd.py::_vf_bwd_kernel (plain, with the
// JaSMin-statistics cotangent, with dropout, in its L2+bias mode, and with
// the forward's stashed residuals).
// Given x, the weights and the dx cotangent g (and optionally the
// cotangent of the JaSMin statistics with the columns the forward took
// them from, and the forward's dropout seed and rates), it produces x_bar
// and the 8 cotangents of the norms and weight matrices, in float32 (10
// with L2 attention's two biases):
//
//   dx = (MLP(cn_m) + Attn(cn_a)) * scaler,   gd = round(g * scaler)
//   MLP:   h1 = cn_m W1, h = round(gelu(h1)), h_bar = gd W2^T,
//          h1_bar = round(h_bar gelu'(h1)), m_bar = h1_bar W1^T,
//          W2_bar = h^T gd, W1_bar = cn_m^T h1_bar
//   Attn:  per head: p recomputed (f32 and rounded), ctx = round(p v),
//          cb = round(gd Wout_h^T), v_bar = p^T cb, p_bar = cb v^T (+ the
//          JaSMin scatter), s_bar = round(p (p_bar - sum(p_bar p))),
//          q_bar = s_bar k tau, k_bar = s_bar^T round(q tau);
//          a_bar = [q_bar k_bar v_bar] Wqkv^T, Wout_bar = ctx^T gd,
//          Wqkv_bar = cn_a^T [q_bar k_bar v_bar]
//   Norms: gamma_bar = sum(bar * cent), beta_bar = sum(bar);
//          x_bar = d/(d-1) (c_bar - mean(c_bar)),
//          c_bar = a_bar gamma_a + m_bar gamma_m
// rounding where the TPU kernel rounds (to x's dtype), every product
// accumulated in f32.
//
// L2 attention (instance kL2, no dropout): qkv gets its bias before it is
// rounded; p = e / esum with e = exp(-(q2 + k2 - 2 q.k) tau) and esum =
// sum e + 1e-8 over the real keys, recomputed as the forward takes them.
// With p_bar as above (+ the JaSMin scatter):
//   e_bar = (p_bar - sum(p_bar p)) / esum,  d2b = -tau e e_bar  (f32)
//   q_bar = 2 q sum_k d2b - 2 round(d2b) k
//   k_bar = 2 k sum_q d2b - 2 round(d2b)^T q
// and the bias cotangents are column sums of two operands the kernel
// already writes in x's dtype: out_bias_bar = sum_rows gd, qkv_bias_bar =
// sum_rows [q_bar k_bar v_bar], taken as per-image partials beside the
// norms' and summed by vfb_reduce in a fixed order.
//
// JaSMin. Row 4 of the statistics (the clipped row sum) sends its
// cotangent to every real key through clip's subgradient, 0.5 at either
// bound as JAX's clip gives it (bf16 rows round to exactly 1.0 on peaked
// heads). Rows 0..3 send theirs to the columns the forward kernel took
// them from (it saves them beside the statistics), so each lands on
// exactly one column however the values tie.
//
// Padding. Rows >= n_real of x and g are read as zeros and x_bar's are
// written as zeros, so nothing a padded row holds reaches a cotangent.
//
// Residuals (instance kResid, the TPU kernel's has_resid, :125, :173-188;
// softmax, no dropout): the forward's stash instance wrote rqkv, the
// rounded qkv [B * n_pad, 3D], and rh1, the rounded pre-GELU hidden
// [B * n_pad, dh]. vfb_rows reads each dh chunk of h1 from rh1 instead of
// the cn_m W1 product, and q, k and v of each head from rqkv instead of
// the three cn_a Wqkv products: h = round(gelu(f32(rh1))), h1_bar =
// round(h_bar gelu'(f32(rh1))), as JAX's stash backward takes them. cn_m
// and cn_a are still computed: the weight products read them. Padded rows
// of rqkv and rh1 (their q, k, v and h1) are read as zeros, so a NaN there
// reaches no cotangent. The plan, and so the shared memory, is the
// deterministic instance's: the residuals stay in device memory. It skips
// 2 n_pad D (3D + dh) of the recomputed products per image (12 % of the
// backward's operations at the CIFAR shape) for a read of the residuals.
//
// Bound. At the training shape (B=1024, 69 real tokens padded to 80,
// D=192, 3 heads, dh=768) the backward recomputes the forward's products
// and does two for each of them: about 2.6x the forward's 66 GFLOP, 0.17
// ms at the H100's 989 TFLOP/s in bf16. Operations, not bytes, bound it;
// with dropout the masks' integer work (the forward's, 58 us on its
// busiest pipe) stays below.
//
// Design: three launches, all deterministic.
//  1. vfb_rows: one CTA of 12 warps per image, as the forward kernel:
//     recompute, the MLP backward over dh in chunks, the attention
//     backward head by head, x_bar and the image's norm partial sums. It
//     writes the operands of the weight products (cn_m, cn_a, gd, ctx, h,
//     h1_bar, [q_bar k_bar v_bar]) to global scratch in x's dtype.
//  2. vfb_wgrad: the four weight cotangents as A^T G products over all
//     B*n_pad rows. The TPU accumulates them with += across its sequential
//     grid; here CTAs run in parallel, so each CTA sums one 64x64 output
//     tile over one fixed slice of rows into its own partial buffer.
//  3. vfb_reduce: sums the partials (and the per-image norm partials) in
//     a fixed order. Two runs give bit-identical cotangents.
// Products are the repo's own WMMA code (the helpers of vector_field.cu);
// nothing goes to a library. Not yet done: wgmma/TMA, keeping the weight products' A and
// G operands on chip.

#define VF_HELPERS_ONLY
#include "vector_field.cu"

using namespace vf;

// Everything one backward needs, passed by pointer from Python (ctypes)
// and by value to the kernels. Outside the anonymous namespace: the C
// entry point takes it, so it needs external linkage.
struct Args {
  const void* x;
  const void* g;
  const float* g_jas;      // [B, H, 5, n_pad] or null
  const int* jas_idx;      // [B, H, 4, n_pad] or null
  const float* ga;
  const float* ba;
  const float* gm;
  const float* bm;
  const void* wqkv;
  const void* wout;
  const void* w1;
  const void* w2;
  void* xbar;              // [B, n_pad, D]
  void* cnm;               // [B*n_pad, D]   scratch, x's dtype
  void* cna;               // [B*n_pad, D]
  void* gd;                // [B*n_pad, D]
  void* gd2;               // [B*n_pad, D]   dropout: attn's gd, else null
  void* ctx;               // [B*n_pad, D]
  void* h;                 // [B*n_pad, dh]
  void* h1b;               // [B*n_pad, dh]
  void* qkvb;              // [B*n_pad, 3D]
  float* macc;             // [B*n_pad, D]   m_bar
  float* npart;            // [B, 4, D]      per-image norm partials;
                           // with L2 [B, 8, D]: then the bias partials
  float* wpart;            // [splits, W]    per-split weight partials
  float* out;              // [W + 4D]: Wqkv, Wout, W1, W2, ga, ba, gm, bm;
                           // with L2 [W + 8D]: then qkv_bias, out_bias
  const float* qkv_bias;   // L2: [3D] f32, else null (the softmax field)
  const float* out_bias;   // L2: [D] f32, else null
  const void* rqkv;        // kResid: [B*n_pad, 3D] x's dtype, else null
  const void* rh1;         // kResid: [B*n_pad, dh] x's dtype, else null
  int batch, n_pad, n_real, d, heads, dh;
  int cn_smem, hc, smem, splits;
  float scaler, qk_scale;
  Drop drop;               // all zeros: the deterministic instance
};

namespace {

constexpr int kChunks[] = {128, 64, 32, 16};
constexpr int kTile = 64;        // weight-product output tile
constexpr int kRowStep = 32;     // rows per staged chunk
constexpr int kWThreads = 128;   // 4 warps, 32x32 of the tile each

struct Plan {
  size_t cn, gd, gd2, mean, st_m, st2_m, hb_m, st_a, pf, pb, q, k, v, cb,
      pbits, l2, abar, total;
  int ld_cn, ld_st_m, ld_hb, ld_st_a, ld_pf, ld_p, ld_hd, ld_abar;
};

// Shared memory of one CTA: cn and gd (unless they stay in global
// scratch; with dropout also the attention's gd2), the row means, then a
// region used by the MLP phase (two f32 stages and the rounded h1_bar
// chunk) and again by the attention phase (with dropout also the keep bits
// of one head's map, 4 words per row; with L2 five f32 vectors of one
// head: q2, k2, esum, the rows' and the columns' sums of d2b).
// kernels/vector_field_bwd.py::l2_bwd_plan repeats the L2 plan in Python.
__host__ __device__ inline Plan make_plan(int n, int d, int hd, int hc,
                                          int cn_smem, int tb, bool drop,
                                          bool l2) {
  const int pad = 16 / tb;
  Plan p;
  p.ld_cn = cn_smem ? d + pad : d;
  p.ld_st_m = hc + 4;
  p.ld_hb = hc + pad;
  p.ld_st_a = imax(hd, n) + 4;
  p.ld_pf = n + 4;
  p.ld_p = n + pad;
  p.ld_hd = hd + pad;
  p.ld_abar = d + 4;
  size_t off = 0;
  p.cn = off;
  p.gd = off;
  p.gd2 = off;
  if (cn_smem) {
    off += align128((size_t)n * p.ld_cn * tb);
    p.gd = off;
    off += align128((size_t)n * p.ld_cn * tb);
    p.gd2 = off;
    if (drop) off += align128((size_t)n * p.ld_cn * tb);
  }
  p.mean = off;  off += align128((size_t)n * 4);
  size_t m = off;
  p.st_m = m;   m += align128((size_t)n * p.ld_st_m * 4);
  p.st2_m = m;  m += align128((size_t)n * p.ld_st_m * 4);
  p.hb_m = m;   m += align128((size_t)n * p.ld_hb * tb);
  size_t a = off;
  p.st_a = a;   a += align128((size_t)n * p.ld_st_a * 4);
  p.pf = a;     a += align128((size_t)n * p.ld_pf * 4);
  p.pb = a;     a += align128((size_t)n * p.ld_p * tb);
  p.q = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.k = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.v = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.cb = a;     a += align128((size_t)n * p.ld_hd * tb);
  p.pbits = a;
  if (drop) a += align128((size_t)n * 4 * 4);
  p.l2 = a;
  if (l2) a += 5 * align128((size_t)n * 4);
  p.abar = off;
  const size_t e = off + align128((size_t)n * p.ld_abar * 4);
  p.total = m > a ? m : a;
  if (e > p.total) p.total = e;
  return p;
}

// L2: dst[r, c] = round(2 a[r, c] sum[r] - 2 prod[r, c]) for an [n, w]
// block, a in shared memory; dst is global (row stride ldd). One warp per
// row.
template <typename T>
__device__ void l2_bar(const float* prod, int lds, const T* a, int lda,
                       const float* sum, int n, int w, T* dst, int ldd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps)
    for (int c = lane; c < w; c += 32)
      dst[(size_t)r * ldd + c] = from_f<T>(
          2.0f * to_f(a[r * lda + c]) * sum[r] - 2.0f * prod[r * lds + c]);
}

// kDrop: dropout, compiled apart so that the deterministic instance keeps
// its registers. The forward's masks are drawn again from the same (seed,
// site, image, row, column), as the TPU kernel regenerates them, and
// applied where the XLA twin applies them: two operands, gd = round(g *
// scaler * mask_mo) for the MLP and W2_bar, gd2 = round(g * scaler *
// mask_ao) for the attention and Wout_bar; h = round(round(gelu(h1)) *
// mask_h) and h_bar * mask_h; p = round(round(p) * mask_p) for ctx and
// v_bar, p_bar * mask_p before the JaSMin scatter, which with s_bar stays
// on the pre-dropout p. kL2: L2 attention with biases (see the top of the
// file), compiled apart as well, as is kResid: the forward's residuals in
// place of the qkv and h1 products (see the top of the file).
template <typename T, bool kDrop, bool kL2 = false, bool kResid = false>
__global__ void __launch_bounds__(kThreads) vfb_rows(Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = args.n_pad, n_real = args.n_real, d = args.d;
  const int heads = args.heads, hd = d / heads, dh = args.dh, hc = args.hc;
  const Plan pl =
      make_plan(n, d, hd, hc, args.cn_smem, sizeof(T), kDrop, kL2);
  const Drop& dr = args.drop;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * n;
  const T* x = static_cast<const T*>(args.x) + row0 * d;
  const T* g = static_cast<const T*>(args.g) + row0 * d;
  const T* wqkv = static_cast<const T*>(args.wqkv);
  const T* wout = static_cast<const T*>(args.wout);
  const T* w1 = static_cast<const T*>(args.w1);
  const T* w2 = static_cast<const T*>(args.w2);
  T* cnm_g = static_cast<T*>(args.cnm) + row0 * d;
  T* cna_g = static_cast<T*>(args.cna) + row0 * d;
  T* gd_g = static_cast<T*>(args.gd) + row0 * d;
  T* ctx_g = static_cast<T*>(args.ctx) + row0 * d;
  T* h_g = static_cast<T*>(args.h) + row0 * dh;
  T* h1b_g = static_cast<T*>(args.h1b) + row0 * dh;
  T* qkvb_g = static_cast<T*>(args.qkvb) + row0 * 3 * d;
  float* macc = args.macc + row0 * d;
  float* mean = reinterpret_cast<float*>(smem + pl.mean);
  T* gd = args.cn_smem ? reinterpret_cast<T*>(smem + pl.gd) : gd_g;
  // the attention's operand: gd, or with dropout gd2
  T* gd2_g = kDrop ? static_cast<T*>(args.gd2) + row0 * d : gd_g;
  T* gda = !kDrop ? gd
           : args.cn_smem ? reinterpret_cast<T*>(smem + pl.gd2) : gd2_g;
  const float scale = (float)((double)d / (d - 1.0));

  // gd = round(g * scaler); rows >= n_real are zeros
  if (kDrop) {
    // gd = round(g * scaler * mask_mo), gd2 = round(g * scaler * mask_ao)
    const unsigned kmo = site_key(dr.seed, kSiteMlpOut);
    const unsigned kao = site_key(dr.seed, kSiteAttnOut);
    for (int r = warp; r < n; r += kWarps)
      for (int gg = lane; 4 * gg < d; gg += 32) {
        float mo[4] = {1.0f, 1.0f, 1.0f, 1.0f}, ma[4] = {1.0f, 1.0f, 1.0f,
                                                         1.0f};
        if (r < n_real && dr.th_m) keep4(kmo, b, r, gg, d, dr.th_m, dr.sc_m, mo);
        if (r < n_real && dr.th_ao)
          keep4(kao, b, r, gg, d, dr.th_ao, dr.sc_ao, ma);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * gg + j;
          const float gv =
              r < n_real ? to_f(g[(size_t)r * d + c]) * args.scaler : 0.0f;
          const T vm = from_f<T>(gv * mo[j]), va = from_f<T>(gv * ma[j]);
          gd[r * pl.ld_cn + c] = vm;
          gda[r * pl.ld_cn + c] = va;
          if (args.cn_smem) {
            gd_g[(size_t)r * d + c] = vm;
            gd2_g[(size_t)r * d + c] = va;
          }
        }
      }
  } else {
    for (int r = warp; r < n; r += kWarps)
      for (int c = lane; c < d; c += 32) {
        const T v = r < n_real ? from_f<T>(to_f(g[(size_t)r * d + c]) *
                                           args.scaler)
                               : from_f<T>(0.0f);
        gd[r * pl.ld_cn + c] = v;
        if (args.cn_smem) gd_g[(size_t)r * d + c] = v;
      }
  }

  // ---- MLP backward, over dh in chunks of hc ----
  T* cn = args.cn_smem ? reinterpret_cast<T*>(smem + pl.cn) : cnm_g;
  center_norm(x, args.gm, args.bm, cn, pl.ld_cn, n, d, n_real, mean);
  __syncthreads();
  if (args.cn_smem)
    for (int i = threadIdx.x; i < n * d; i += kThreads)
      cnm_g[i] = cn[(i / d) * pl.ld_cn + i % d];
  float* st = reinterpret_cast<float*>(smem + pl.st_m);
  float* st2 = reinterpret_cast<float*>(smem + pl.st2_m);
  T* hb = reinterpret_cast<T*>(smem + pl.hb_m);
  for (int c0 = 0; c0 < dh; c0 += hc) {
    if (kResid) {
      // h1 of the chunk from rh1; padded rows read as zeros
      const T* rh1 = static_cast<const T*>(args.rh1) + row0 * dh + c0;
      for (int i = threadIdx.x; i < n * hc; i += kThreads) {
        const int r = i / hc, c = i % hc;
        st[r * pl.ld_st_m + c] =
            r < n_real ? to_f(rh1[(size_t)r * dh + c]) : 0.0f;
      }
    } else {
      mm<false, false>(cn, pl.ld_cn, w1 + c0, dh, st, pl.ld_st_m, false, n,
                       hc, d);
    }
    mm<false, true>(gd, pl.ld_cn, w2 + (size_t)c0 * d, d, st2, pl.ld_st_m,
                    false, n, hc, d);
    __syncthreads();
    if (kDrop && dr.th_m) {
      // h = round(round(gelu(h1)) * mask_h); h1_bar from h_bar * mask_h
      const unsigned kh = site_key(dr.seed, kSiteH);
      for (int r = warp; r < n; r += kWarps)
        for (int gg = lane; 4 * gg < hc; gg += 32) {
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (r < n_real)
            keep4(kh, b, r, (c0 >> 2) + gg, dh, dr.th_m, dr.sc_m, m);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 4 * gg + j;
            const float h1 = st[r * pl.ld_st_m + c];
            const T v =
                from_f<T>(st2[r * pl.ld_st_m + c] * m[j] * gelu_grad(h1));
            h_g[(size_t)r * dh + c0 + c] =
                from_f<T>(to_f(from_f<T>(gelu(h1))) * m[j]);
            h1b_g[(size_t)r * dh + c0 + c] = v;
            hb[r * pl.ld_hb + c] = v;
          }
        }
    } else {
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hc; c += 32) {
          const float h1 = st[r * pl.ld_st_m + c];
          const T v = from_f<T>(st2[r * pl.ld_st_m + c] * gelu_grad(h1));
          h_g[(size_t)r * dh + c0 + c] = from_f<T>(gelu(h1));
          h1b_g[(size_t)r * dh + c0 + c] = v;
          hb[r * pl.ld_hb + c] = v;
        }
    }
    __syncthreads();
    mm<false, true>(hb, pl.ld_hb, w1 + c0, dh, macc, d, c0 > 0, n, d, hc);
    __syncthreads();
  }

  // ---- attention backward, head by head ----
  if (!args.cn_smem) cn = cna_g;
  center_norm(x, args.ga, args.ba, cn, pl.ld_cn, n, d, n_real);
  __syncthreads();
  if (args.cn_smem)
    for (int i = threadIdx.x; i < n * d; i += kThreads)
      cna_g[i] = cn[(i / d) * pl.ld_cn + i % d];
  st = reinterpret_cast<float*>(smem + pl.st_a);
  float* pf = reinterpret_cast<float*>(smem + pl.pf);
  T* pb = reinterpret_cast<T*>(smem + pl.pb);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  T* cb = reinterpret_cast<T*>(smem + pl.cb);
  unsigned* pbits = reinterpret_cast<unsigned*>(smem + pl.pbits);
  // kL2: q2, k2, esum, then the rows' and the columns' sums of d2b
  const size_t nv = align128((size_t)n * 4) / 4;
  float* q2 = reinterpret_cast<float*>(smem + pl.l2);
  float *k2 = q2 + nv, *esum = q2 + 2 * nv, *rsum = q2 + 3 * nv,
        *csum = q2 + 4 * nv;
  T* const none = nullptr;  // q_bar, k_bar, v_bar go to global scratch only
  const int ls = pl.ld_st_a, lh = pl.ld_hd;
  for (int hh = 0; hh < heads; ++hh) {
    T* dst[3] = {q, k, v};
    if (kResid) {
      // q, k and v of the head from rqkv; padded rows read as zeros
      const T* rq = static_cast<const T*>(args.rqkv) + row0 * 3 * d + hh * hd;
      for (int i = threadIdx.x; i < n * hd; i += kThreads) {
        const int r = i / hd, c = i % hd;
        for (int j = 0; j < 3; ++j)
          dst[j][r * lh + c] = r < n_real ? rq[(size_t)r * 3 * d + j * d + c]
                                          : from_f<T>(0.0f);
      }
      __syncthreads();
    }
    for (int j = 0; !kResid && j < 3; ++j) {
      mm<false, false>(cn, pl.ld_cn, wqkv + j * d + hh * hd, 3 * d, st, ls,
                       false, n, hd, d);
      __syncthreads();
      // padded value rows are zeroed so that 0 * NaN cannot reach p @ v
      round_block(st, ls, dst[j], lh, n, hd, j == 2 ? n_real : n, 1.0f, none,
                  0, kL2 ? args.qkv_bias + j * d + hh * hd : nullptr);
      __syncthreads();
    }
    if (kL2) {
      sq_rows(q, lh, n, hd, q2);
      sq_rows(k, lh, n, hd, k2);
    }
    mm<false, true>(q, lh, k, lh, st, ls, false, n, n, hd);
    __syncthreads();
    // pf: the f32 p (softmax) or e (L2, with esum: p = e / esum)
    if (kL2)
      l2_rows(st, ls, q2, k2, pb, pl.ld_p, n, n_real, args.qk_scale, pf,
              pl.ld_pf, esum);
    else
      softmax_rows(st, ls, pb, pl.ld_p, n, n_real, args.qk_scale, pf,
                   pl.ld_pf);
    __syncthreads();
    if (kDrop && dr.th_p) {
      // pb = round(pb * mask_p); the keep bits stay for p_bar
      const unsigned kp = site_key(dr.seed, kSiteP + hh);
      for (int r = warp; r < n; r += kWarps) {
        unsigned* words = pbits + 4 * r;
        if (r < n_real)
          keep_bits_row(kp, b, r, n, n_real, dr.th_p, words);
        else if (lane < 4)
          words[lane] = 0;
        __syncwarp();
        for (int c = lane; c < n; c += 32)
          pb[r * pl.ld_p + c] = from_f<T>(
              to_f(pb[r * pl.ld_p + c]) * (kept(words, c) ? dr.sc_p : 0.0f));
      }
      __syncthreads();
    }
    mm<false, false>(pb, pl.ld_p, v, lh, st, ls, false, n, hd, n);
    __syncthreads();
    // ctx of this head for Wout_bar; q becomes round(q * tau) for k_bar
    // (softmax; L2's k_bar takes q as it is)
    round_block(st, ls, none, 0, n, hd, n, 1.0f, ctx_g + hh * hd, d);
    if (!kL2)
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hd; c += 32)
          q[r * lh + c] = from_f<T>(to_f(q[r * lh + c]) * args.qk_scale);
    __syncthreads();
    // cb = round(gd Wout[h*hd:(h+1)*hd, :]^T)
    mm<false, true>(gda, pl.ld_cn, wout + (size_t)hh * hd * d, d, st, ls,
                    false, n, hd, d);
    __syncthreads();
    round_block(st, ls, cb, lh, n, hd, n);
    __syncthreads();
    // v_bar = p^T cb
    mm<true, false>(pb, pl.ld_p, cb, lh, st, ls, false, n, hd, n);
    __syncthreads();
    round_block(st, ls, none, 0, n, hd, n, 1.0f, qkvb_g + 2 * d + hh * hd,
                3 * d);
    __syncthreads();
    // p_bar = cb v^T (+ JaSMin), then s_bar (softmax) or round(d2b) (L2)
    // into pb
    mm<false, true>(cb, lh, v, lh, st, ls, false, n, n, hd);
    __syncthreads();
    const size_t bh = (size_t)b * heads + hh;
    for (int r = warp; r < n; r += kWarps) {
      float* prow = st + r * ls;
      const float* frow = pf + r * pl.ld_pf;
      if (r >= n_real) {
        for (int c = lane; c < n; c += 32) {
          pb[r * pl.ld_p + c] = from_f<T>(0.0f);
          if (kL2) prow[c] = 0.0f;
        }
        if (kL2 && lane == 0) rsum[r] = 0.0f;
        continue;
      }
      // the f32 p of column c
      const float es = kL2 ? esum[r] : 1.0f;
      auto p_of = [&](int c) { return kL2 ? frow[c] / es : frow[c]; };
      if (kDrop && dr.th_p)
        for (int c = lane; c < n_real; c += 32)
          prow[c] *= kept(pbits + 4 * r, c) ? dr.sc_p : 0.0f;
      if (args.g_jas != nullptr) {
        const float* gj = args.g_jas + bh * 5 * n;
        const int* ji = args.jas_idx + bh * 4 * n;
        const float g4 = gj[4 * n + r];
        for (int c = lane; c < n_real; c += 32) {
          const float pj = to_f(from_f<T>(p_of(c)));  // pre-dropout, rounded
          const float lo = ((pj >= 1e-12f) + (pj > 1e-12f)) * 0.5f;
          const float hi = ((pj <= 1.0f) + (pj < 1.0f)) * 0.5f;
          float t = g4 * (lo * hi);
          for (int i = 0; i < 4; ++i)
            if (ji[i * n + r] == c) t += gj[i * n + r];
          prow[c] += t;
        }
      }
      float dot = 0.0f;
      for (int c = lane; c < n_real; c += 32) dot += prow[c] * p_of(c);
      dot = warp_sum(dot);
      if (kL2) {
        // d2b in f32 stays in st for the column sums; pb = round(d2b)
        float sum = 0.0f;
        for (int c = lane; c < n; c += 32) {
          const float v2 = c < n_real
              ? -args.qk_scale * frow[c] * ((prow[c] - dot) / es) : 0.0f;
          prow[c] = v2;
          pb[r * pl.ld_p + c] = from_f<T>(v2);
          sum += v2;
        }
        sum = warp_sum(sum);
        if (lane == 0) rsum[r] = sum;
      } else {
        for (int c = lane; c < n; c += 32)
          pb[r * pl.ld_p + c] =
              from_f<T>(c < n_real ? frow[c] * (prow[c] - dot) : 0.0f);
      }
    }
    __syncthreads();
    if (kL2) {
      // the columns' sums of d2b, each over the rows in order
      for (int c = threadIdx.x; c < n; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < n; ++r) sum += st[r * ls + c];
        csum[c] = sum;
      }
      __syncthreads();
    }
    // softmax: q_bar = s_bar k tau, k_bar = s_bar^T round(q tau); L2:
    // q_bar = 2 q rsum - 2 round(d2b) k, k_bar = 2 k csum - 2 round(d2b)^T q
    mm<false, false>(pb, pl.ld_p, k, lh, st, ls, false, n, hd, n);
    __syncthreads();
    if (kL2)
      l2_bar(st, ls, q, lh, rsum, n, hd, qkvb_g + hh * hd, 3 * d);
    else
      round_block(st, ls, none, 0, n, hd, n, args.qk_scale, qkvb_g + hh * hd,
                  3 * d);
    __syncthreads();
    mm<true, false>(pb, pl.ld_p, q, lh, st, ls, false, n, hd, n);
    __syncthreads();
    if (kL2)
      l2_bar(st, ls, k, lh, csum, n, hd, qkvb_g + d + hh * hd, 3 * d);
    else
      round_block(st, ls, none, 0, n, hd, n, 1.0f, qkvb_g + d + hh * hd,
                  3 * d);
    __syncthreads();
  }

  // a_bar = [q_bar k_bar v_bar] Wqkv^T, one product over 3D
  float* abar = reinterpret_cast<float*>(smem + pl.abar);
  mm<false, true>(qkvb_g, 3 * d, wqkv, 3 * d, abar, pl.ld_abar, false, n, d,
                  3 * d);
  __syncthreads();

  // norm partials of this image: (ga, ba, gm, bm) sums over real rows
  float* np = args.npart + (size_t)b * (kL2 ? 8 : 4) * d;
  if (kL2) {
    // bias partials: qkv_bias_bar over [q_bar k_bar v_bar], out_bias_bar
    // over gd (both written above, in x's dtype)
    for (int c = threadIdx.x; c < 3 * d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r)
        sum += to_f(qkvb_g[(size_t)r * 3 * d + c]);
      np[4 * d + c] = sum;
    }
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += to_f(gd_g[(size_t)r * d + c]);
      np[7 * d + c] = sum;
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sa1 = 0.0f, sa0 = 0.0f, sm1 = 0.0f, sm0 = 0.0f;
    for (int r = 0; r < n_real; ++r) {
      const float cent = (to_f(x[(size_t)r * d + c]) - mean[r]) * scale;
      const float a = abar[r * pl.ld_abar + c];
      const float m = macc[(size_t)r * d + c];
      sa1 += a * cent;
      sa0 += a;
      sm1 += m * cent;
      sm0 += m;
    }
    np[c] = sa1;
    np[d + c] = sa0;
    np[2 * d + c] = sm1;
    np[3 * d + c] = sm0;
  }

  // x_bar = d/(d-1) (c_bar - mean(c_bar)); padded rows are zeros
  T* xb = static_cast<T*>(args.xbar) + row0 * d;
  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32)
      sum += abar[r * pl.ld_abar + c] * args.ga[c] +
             macc[(size_t)r * d + c] * args.gm[c];
    const float cm = warp_sum(sum) / d;
    for (int c = lane; c < d; c += 32) {
      const float cbar = abar[r * pl.ld_abar + c] * args.ga[c] +
                         macc[(size_t)r * d + c] * args.gm[c];
      xb[(size_t)r * d + c] =
          from_f<T>(r < n_real ? scale * (cbar - cm) : 0.0f);
    }
  }
}

// The four weight products W_bar[M, N] = A[R, M]^T G[R, N].
struct Problem {
  const void* a;
  const void* g;
  int m, n;
  size_t out;  // offset in the flat weight buffer
};

struct Problems {
  Problem p[4];
  int rows, rows_per_split;
  size_t total;  // floats of one split's partial buffer
};

__device__ inline int tiles(int m) { return (m + kTile - 1) / kTile; }

// blockIdx.x: a 64x64 output tile of one problem; blockIdx.y: a slice of
// rows. Each CTA writes its own partial tile; nothing is shared.
__global__ void __launch_bounds__(kWThreads)
vfb_wgrad_bf16(Problems ps, float* wpart) {
  __shared__ __align__(128) bf16 as[kRowStep][kTile + 8];
  __shared__ __align__(128) bf16 gs[kRowStep][kTile + 8];
  int t = blockIdx.x, pi = 0;
  while (t >= tiles(ps.p[pi].m) * tiles(ps.p[pi].n)) {
    t -= tiles(ps.p[pi].m) * tiles(ps.p[pi].n);
    ++pi;
  }
  const Problem pr = ps.p[pi];
  const int tn = tiles(pr.n);
  const int m0 = (t / tn) * kTile, n0 = (t % tn) * kTile;
  const bf16* a = static_cast<const bf16*>(pr.a);
  const bf16* g = static_cast<const bf16*>(pr.g);
  const int r_begin = blockIdx.y * ps.rows_per_split;
  const int r_end = imin(ps.rows, r_begin + ps.rows_per_split);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);
  for (int r0 = r_begin; r0 < r_end; r0 += kRowStep) {
    for (int i = threadIdx.x; i < kRowStep * kTile; i += kWThreads) {
      const int rr = i / kTile, cc = i % kTile, r = r0 + rr;
      const bool in = r < r_end;
      as[rr][cc] = in && m0 + cc < pr.m ? a[(size_t)r * pr.m + m0 + cc]
                                        : __float2bfloat16_rn(0.0f);
      gs[rr][cc] = in && n0 + cc < pr.n ? g[(size_t)r * pr.n + n0 + cc]
                                        : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
    for (int kk = 0; kk < kRowStep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &as[kk][wm + 16 * i], kTile + 8);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &gs[kk][wn + 16 * j], kTile + 8);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
    __syncthreads();
  }
  float* out = wpart + blockIdx.y * ps.total + pr.out;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm + 16 * i, nn = n0 + wn + 16 * j;
      if (m < pr.m && nn < pr.n)
        wmma::store_matrix_sync(out + (size_t)m * pr.n + nn, c[i][j], pr.n,
                                wmma::mem_row_major);
    }
}

// The f32 version, on the CUDA cores (checks at small shapes).
__global__ void __launch_bounds__(kWThreads)
vfb_wgrad_f32(Problems ps, float* wpart) {
  int t = blockIdx.x, pi = 0;
  while (t >= tiles(ps.p[pi].m) * tiles(ps.p[pi].n)) {
    t -= tiles(ps.p[pi].m) * tiles(ps.p[pi].n);
    ++pi;
  }
  const Problem pr = ps.p[pi];
  const int tn = tiles(pr.n);
  const int m0 = (t / tn) * kTile, n0 = (t % tn) * kTile;
  const float* a = static_cast<const float*>(pr.a);
  const float* g = static_cast<const float*>(pr.g);
  const int r_begin = blockIdx.y * ps.rows_per_split;
  const int r_end = imin(ps.rows, r_begin + ps.rows_per_split);
  float* out = wpart + blockIdx.y * ps.total + pr.out;
  for (int i = threadIdx.x; i < kTile * kTile; i += kWThreads) {
    const int m = m0 + i / kTile, nn = n0 + i % kTile;
    if (m >= pr.m || nn >= pr.n) continue;
    float s = 0.0f;
    for (int r = r_begin; r < r_end; ++r)
      s = fmaf(a[(size_t)r * pr.m + m], g[(size_t)r * pr.n + nn], s);
    out[(size_t)m * pr.n + nn] = s;
  }
}

// out[i] = sum over splits of wpart (weights), then sum over images of
// npart (norms), each in a fixed order.
__global__ void vfb_reduce(const float* wpart, int splits, size_t wtotal,
                           const float* npart, int batch, int nlen,
                           float* out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < wtotal) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += wpart[k * wtotal + i];
    out[i] = s;
  } else if (i < wtotal + nlen) {
    const size_t j = i - wtotal;
    float s = 0.0f;
    for (int k = 0; k < batch; ++k) s += npart[(size_t)k * nlen + j];
    out[i] = s;
  }
}

bool shape_ok(int n_pad, int n_real, int d, int heads, int dh) {
  return heads > 0 && d % heads == 0 && d % 16 == 0 && (d / heads) % 16 == 0 &&
         dh % 16 == 0 && n_pad % 16 == 0 && n_pad > 0 &&
         n_pad <= 16 * kMaxRowTiles && n_real > 0 && n_real <= n_pad;
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const bool drop = a.drop.th_p | a.drop.th_ao | a.drop.th_m;
  const bool l2 = a.qkv_bias != nullptr;
  const bool resid = a.rqkv != nullptr;
  if (l2 && (drop || a.out_bias == nullptr)) return (int)cudaErrorInvalidValue;
  if (resid != (a.rh1 != nullptr) || (resid && (drop || l2)))
    return (int)cudaErrorInvalidValue;
  auto rows = l2      ? vfb_rows<T, false, true>
              : drop  ? vfb_rows<T, true>
              : resid ? vfb_rows<T, false, false, true>
                      : vfb_rows<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  rows<<<a.batch, kThreads, a.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int d = a.d, dh = a.dh;
  Problems ps;
  ps.p[0] = {a.cna, a.qkvb, d, 3 * d, 0};
  ps.p[1] = {a.ctx, drop ? a.gd2 : a.gd, d, d, (size_t)3 * d * d};
  ps.p[2] = {a.cnm, a.h1b, d, dh, (size_t)4 * d * d};
  ps.p[3] = {a.h, a.gd, dh, d, (size_t)4 * d * d + (size_t)d * dh};
  ps.total = (size_t)4 * d * d + (size_t)2 * d * dh;
  ps.rows = a.batch * a.n_pad;
  ps.rows_per_split = (ps.rows + a.splits - 1) / a.splits;
  ps.rows_per_split = (ps.rows_per_split + kRowStep - 1) / kRowStep * kRowStep;
  int ntiles = 0;
  for (const Problem& p : ps.p)
    ntiles += ((p.m + kTile - 1) / kTile) * ((p.n + kTile - 1) / kTile);
  const dim3 grid(ntiles, a.splits);
  if (sizeof(T) == 2)
    vfb_wgrad_bf16<<<grid, kWThreads, 0, st>>>(ps, a.wpart);
  else
    vfb_wgrad_f32<<<grid, kWThreads, 0, st>>>(ps, a.wpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nlen = (l2 ? 8 : 4) * d;
  const size_t all = ps.total + (size_t)nlen;
  vfb_reduce<<<(unsigned)((all + 255) / 256), 256, 0, st>>>(
      a.wpart, a.splits, ps.total, a.npart, a.batch, nlen, a.out);
  return (int)cudaGetLastError();
}

}  // namespace

// vector_field_tiled.cu includes this file with VFB_KERNELS_ONLY for its
// weight products and reduce; it has entry points of its own.
#ifndef VFB_KERNELS_ONLY

extern "C" {

// Chooses the plan of vfb_rows: whether cn and gd live in shared memory
// (preferred) or in their global scratch, and the MLP chunk width; `drop`
// asks for the dropout instance's plan, `l2` for the L2 instance's.
// Returns 0 when the shape has a plan, 1 when it has none.
int vfb_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int drop, int l2, int* cn_smem_out, int* hc_out,
             int* smem_out) {
  if (!shape_ok(n_pad, n_real, d, heads, dh)) return 1;
  for (int cn_smem = 1; cn_smem >= 0; --cn_smem) {
    for (int hc : kChunks) {
      if (dh % hc) continue;
      const Plan p = make_plan(n_pad, d, d / heads, hc, cn_smem, tbytes,
                               drop != 0, l2 != 0);
      if (p.total <= (size_t)kMaxSmem) {
        *cn_smem_out = cn_smem;
        *hc_out = hc;
        *smem_out = (int)p.total;
        return 0;
      }
    }
  }
  return 1;
}

// Launches the backward (three kernels) on `stream`; returns the first
// cudaGetLastError() that is not 0, else 0. `tbytes` is x's element size.
// A nonzero threshold in args->drop launches the dropout instance (planned
// with drop=1), which also takes the gd2 scratch. Non-null biases launch
// the L2 instance (planned with l2=1; no dropout), whose `out` and
// `npart` hold 8D norm and bias entries. Non-null rqkv and rh1 launch the
// kResid instance (the deterministic plan; no dropout, no biases).
int vfb_launch(int tbytes, const Args* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? launch<bf16>(*args, st) : launch<float>(*args, st);
}

const char* vfb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // VFB_KERNELS_ONLY
