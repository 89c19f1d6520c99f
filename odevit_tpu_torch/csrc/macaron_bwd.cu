// Backward of one evaluation of the Macaron vector field, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel odevit_tpu/kernels/macaron.py::
// _macaron_bwd_kernel. Given x, the weights and the cotangent g of
// f = x3 * scaler (macaron.cu), it produces x_bar and the 15 parameter
// cotangents in f32, as the TPU kernel does:
//
//   forward chain, recomputed:
//     z1 = LN1(x), h_1 = round(gelu(z1 W1 + b1)), f1 = h_1 W2 + b2,
//     x1 = x + rs/2 f1;  z2 = LN2(x1), qkv = round(z2 Wqkv + qkv_bias),
//     p = softmax per head (f32, and rounded), ctx = round(p v),
//     ao = ctx Wout + out_bias, x2 = x1 + rs ao;  z3 = LN3(x2),
//     h_3, f3 as for the first half.
//   backward chain, with x3_bar = g * scaler (f32):
//     FFN half (out_bar = rs/2 x_bar of its output state):
//       ob = round(out_bar), W2_bar += h^T ob, b2_bar += sum(out_bar),
//       h1_bar = round((ob W2^T) gelu'(h1)), W1_bar += z^T h1_bar,
//       b1_bar += sum(h1_bar), z_bar = h1_bar W1^T
//     LayerNorm (the TPU kernel's ln_bwd): s_bar += sum(z_bar chat),
//       b_bar += sum(z_bar), u = z_bar s,
//       x_bar += rstd (u - mean(u) - chat mean(u chat))
//     attention: ao_bar = rs x2_bar, out_bias_bar = sum(ao_bar) in f32,
//       aod = round(ao_bar), Wout_bar = ctx^T aod, per head
//       cb = round(aod Wout_h^T), v_bar = round(p)^T cb, p_bar = cb v^T,
//       s_bar = round(p (p_bar - sum(p_bar p))) with the f32 p,
//       q_bar = round(tau s_bar k), k_bar = round(s_bar^T round(q tau));
//       qkv_bias_bar = sum(qkv_bar), Wqkv_bar = z2^T qkv_bar,
//       z2_bar = qkv_bar Wqkv^T
//     rs_bar = 1/2 sum(x3_bar f3) + sum(x2_bar ao) + 1/2 sum(x1_bar f1)
// rounding where the TPU kernel rounds (to x's dtype), every product
// accumulated in f32. Rows >= n_real of x and g are read as zeros and
// x_bar's are written as zeros, so nothing a padded row holds reaches a
// cotangent.
//
// Bound. The backward recomputes the forward's products (99.1 MFLOP per
// image at the Macaron CIFAR shape) and does two for each of them: about
// 3x the forward, 304 GFLOP at B=1024, 0.31 ms at the H100's 989 TFLOP/s
// in bf16. Operations bound it.
//
// Design. The TPU kernel recomputes the whole chain in VMEM and emits the
// 16 cotangents in one pass; its f32 hidden alone (80 x 768 x 4 bytes)
// exceeds a CTA's shared memory. Here, as in vector_field_bwd.cu, three
// kinds of launch, all deterministic:
//  1. mcb_rows (bf16) or mcb_rows_f32: one CTA of 12 warps per image runs
//     the chain forward and back. The FFN halves run over dh in chunks
//     (h1 recomputed per chunk), the attention head by head. The image's
//     f32 states (x1, x2, f1, ao), its running x_bar and z_bar, and the
//     operands of the weight products (z1, z3, z2, h_1, h_3, h1_bar of
//     each half, ob of each half, ctx, aod, qkv, qkv_bar, in x's dtype)
//     go to a global workspace; the column sums (the six LayerNorm
//     vectors, the four biases) and rs_bar go to per-image partials, each
//     summed over rows in a fixed order.
//  2. vfb_wgrad_wgmma (vector_field_bwd.cu; in f32 mcb_wgrad_f32), twice:
//     Wqkv_bar = z2^T qkv_bar and
//     Wout_bar = ctx^T aod over the B*n_pad rows; the shared FFN's
//     W1_bar = [z1; z3]^T [h1_bar_1; h1_bar_3] and W2_bar = [h_1; h_3]^T
//     [ob_1; ob_3], one product each over the two halves' rows stacked.
//     Each CTA sums one output tile over a fixed slice of rows into its
//     own partial buffer.
//  3. vfb_reduce: sums the weight partials and the per-image partials in
//     a fixed order. Two runs give bit-identical cotangents.
// Products are the repo's own code; nothing goes to a library. In bf16,
// mcb_rows takes vf::mm's WMMA fragments. In f32 (the main path: a
// Macaron model's states are f32) every product is split TF32 in three
// passes, 913 GFLOP of TF32 work at the CIFAR shape (1.85 ms at 495
// TFLOP/s), and each is built for this card (mac::gemm_tf32 in
// macaron.cu): operands in device memory are staged through shared memory
// by 16-byte cp.async in K slices, two slices in flight; each element is
// split once where it lands into big and small TF32 planes; each warp
// multiplies a register tile of up to 48 x 32 by mma.sync; elementwise
// epilogues (GELU and its gradient, the bias, the copies to the
// workspace) run from registers. mcb_rows_f32 keeps in shared memory the
// operands it makes and reuses (the FFN chunk's h or h1_bar, p and s_bar
// as planes) and the f32 rows a row pass needs (the scores and p_bar for
// the softmax, the FFN chunk's pre-activation); the rest streams in
// through the staging ring. It skips two products the bf16 kernel runs:
// the second half's f3 = h_3 W2 + b2 (rs_bar's term sum(x3_bar f3) is
// sum(h_3 (x3_bar W2^T)) + sum(b2 x3_bar), and x3_bar W2^T is the product
// that h1_bar needs anyway, times rs/2), and the first half's
// recomputation of z1 W1 + b1 (the forward leaves it in h1_bar_1's
// workspace rows, which its backward then overwrites). mcb_wgrad_f32
// stages 128 x 64 output tiles the same way with 8 warps of 32 x 32.

// macaron_tiled.cu includes this file with MCB_KERNELS_ONLY, after the
// sources below, for mcb_wgrad_f32 and the per-image partials' layout.
#ifndef MCB_KERNELS_ONLY
#define VFB_KERNELS_ONLY
#include "vector_field_bwd.cu"
#define MAC_HELPERS_ONLY
#include "macaron.cu"
#endif

// Everything one backward needs, passed by pointer from Python (ctypes).
// The workspace pointers are per-row buffers of B * n_pad rows (2 * B *
// n_pad for the two FFN halves' operands, the first half's rows first).
struct McbArgs {
  const void* x;
  const void* g;
  const float* ln1s;
  const float* ln1b;
  const float* ln2s;
  const float* ln2b;
  const float* ln3s;
  const float* ln3b;
  const void* wqkv;
  const float* qkv_bias;
  const void* wout;
  const float* out_bias;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* rs;
  void* xbar;     // [B*n_pad, D] x's dtype
  void* z13;      // [2, B*n_pad, D]
  void* z2;       // [B*n_pad, D]
  void* h13;      // [2, B*n_pad, dh]
  void* h1b13;    // [2, B*n_pad, dh]
  void* ob13;     // [2, B*n_pad, D]
  void* qkv;      // [B*n_pad, 3D]
  void* ctx;      // [B*n_pad, D]
  void* aod;      // [B*n_pad, D]
  void* qkvbar;   // [B*n_pad, 3D]
  float* st32;    // [7, B*n_pad, D]: x1, x2, f1, f3 (f32: the heads' cb),
                  // ao, x_bar, z_bar
  float* npart;   // [B, NP] per-image partials (see np_offsets)
  float* wpart;   // [splits, W]
  float* out;     // [W + NP]: Wqkv, Wout, W1, W2, then the partials' sums
  int batch, n_pad, n_real, d, heads, dh, hc, nb, smem, splits;
  float scaler, qk_scale;
};

namespace macb {

using namespace vf;

// Offsets in one image's partials: the six LayerNorm vectors (s1, b1, s2,
// b2, s3, b3), qkv_bias [3D], out_bias [D], b1 [dh], b2 [D], rs [1].
struct NpOff {
  int ln, qkvb, outb, b1, b2, rs, total;
};

__host__ __device__ inline NpOff np_offsets(int d, int dh) {
  NpOff o;
  o.ln = 0;
  o.qkvb = 6 * d;
  o.outb = 9 * d;
  o.b1 = 10 * d;
  o.b2 = 10 * d + dh;
  o.rs = 11 * d + dh;
  o.total = 11 * d + dh + 1;
  return o;
}

// Shared memory of one mcb_rows CTA (bf16): a reduction scratch and the
// rows' LayerNorm statistics, the f32 stage of the products, then a region
// used by the FFN phases (a second f32 stage and the rounded hidden chunk)
// and again by the attention phases (the f32 and rounded p, q, k, v and cb
// of a head). A shape takes the one-CTA route, in either dtype, where this
// layout fits (mcb_plan); the f32 kernel then lays its CTA out by
// make_plan_f32. kernels/macaron_bwd.py::macaron_bwd_plan repeats both in
// Python.
struct Plan {
  size_t red, st, st2, hb, pf, pb, q, k, v, cb, total;
  int ld_st, ld_st2, ld_hb, ld_pf, ld_pb, ld_hd;
};

__host__ __device__ inline Plan make_plan(int n, int d, int hd, int hc,
                                          int tb) {
  const int pad = 16 / tb;
  Plan p;
  p.ld_st = imax(imax(hc, 3 * hd), n) + 4;
  p.ld_st2 = hc + 4;
  p.ld_hb = hc + pad;
  p.ld_pf = n + 4;
  p.ld_pb = n + pad;
  p.ld_hd = hd + pad;
  size_t off = 0;
  p.red = off;  off += align128((size_t)(kWarps + 2 * 16 * kMaxRowTiles) * 4);
  p.st = off;   off += align128((size_t)n * p.ld_st * 4);
  size_t m = off;
  p.st2 = m;    m += align128((size_t)n * p.ld_st2 * 4);
  p.hb = m;     m += align128((size_t)n * p.ld_hb * tb);
  size_t a = off;
  p.pf = a;     a += align128((size_t)n * p.ld_pf * 4);
  p.pb = a;     a += align128((size_t)n * p.ld_pb * tb);
  p.q = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.k = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.v = a;      a += align128((size_t)n * p.ld_hd * tb);
  p.cb = a;     a += align128((size_t)n * p.ld_hd * tb);
  p.total = m > a ? m : a;
  return p;
}

// The block's sum of one value per thread, in a fixed order: each warp's
// butterfly, then the warps in order. `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The backward of z = LN(xs) * s + b over the image's rows, given z_bar
// (f32, global): x_bar += rstd (u - mean(u) - chat mean(u chat)) with
// u = z_bar s, and the image's partials s_part = sum_r z_bar chat,
// b_part = sum_r z_bar over the real rows, in row order. `stats` holds 2n
// floats (each row's mean and rstd). Rows >= zero_from of xs read as zeros.
template <typename S>
__device__ void ln_bwd(const S* xs, const float* zbar, const float* s,
                       float* xbar, int n, int n_real, int d, int zero_from,
                       float* stats, float* s_part, float* b_part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mean = stats;
  float* rstd = stats + n;
  auto xv = [&](int r, int c) {
    return r < zero_from ? to_f(xs[(size_t)r * d + c]) : 0.0f;
  };
  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += xv(r, c);
    const float mu = warp_sum(sum) / d;
    float var = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float cv = xv(r, c) - mu;
      var += cv * cv;
    }
    var = warp_sum(var);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(var / d + mac::kLnEps);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s1 = 0.0f, s0 = 0.0f;
    for (int r = 0; r < n_real; ++r) {
      const float zb = zbar[(size_t)r * d + c];
      s1 += zb * ((xv(r, c) - mean[r]) * rstd[r]);
      s0 += zb;
    }
    s_part[c] = s1;
    b_part[c] = s0;
  }
  for (int r = warp; r < n; r += kWarps) {
    const float mu = mean[r], rs = rstd[r];
    float su = 0.0f, suc = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float u = zbar[(size_t)r * d + c] * s[c];
      su += u;
      suc += u * ((xv(r, c) - mu) * rs);
    }
    su = warp_sum(su) / d;
    suc = warp_sum(suc) / d;
    for (int c = lane; c < d; c += 32) {
      const float u = zbar[(size_t)r * d + c] * s[c];
      const float chat = (xv(r, c) - mu) * rs;
      xbar[(size_t)r * d + c] += rs * (u - su - chat * suc);
    }
  }
  __syncthreads();
}

// The bf16 instance (mcb_rows_f32 below is the f32 one).
template <typename T>
__global__ void __launch_bounds__(kThreads) mcb_rows(McbArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n_pad, n_real = a.n_real, d = a.d, heads = a.heads;
  const int hd = d / heads, dh = a.dh, hc = a.hc;
  const Plan pl = make_plan(n, d, hd, hc, sizeof(T));
  const NpOff no = np_offsets(d, dh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const size_t rows = (size_t)a.batch * n;
  const size_t row0 = (size_t)b * n;
  const float rs = a.rs[0], hrs = 0.5f * rs;

  const T* x = static_cast<const T*>(a.x) + row0 * d;
  const T* g = static_cast<const T*>(a.g) + row0 * d;
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wout = static_cast<const T*>(a.wout);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  T* z1 = static_cast<T*>(a.z13) + row0 * d;
  T* z3 = static_cast<T*>(a.z13) + (rows + row0) * d;
  T* z2 = static_cast<T*>(a.z2) + row0 * d;
  T* h_1 = static_cast<T*>(a.h13) + row0 * dh;
  T* h_3 = static_cast<T*>(a.h13) + (rows + row0) * dh;
  T* h1b_1 = static_cast<T*>(a.h1b13) + row0 * dh;
  T* h1b_3 = static_cast<T*>(a.h1b13) + (rows + row0) * dh;
  T* ob_1 = static_cast<T*>(a.ob13) + row0 * d;
  T* ob_3 = static_cast<T*>(a.ob13) + (rows + row0) * d;
  T* qkv = static_cast<T*>(a.qkv) + row0 * 3 * d;
  T* ctx = static_cast<T*>(a.ctx) + row0 * d;
  T* aod = static_cast<T*>(a.aod) + row0 * d;
  T* qkvbar = static_cast<T*>(a.qkvbar) + row0 * 3 * d;
  float* x1 = a.st32 + row0 * d;
  float* x2 = a.st32 + (rows + row0) * d;
  float* f1 = a.st32 + (2 * rows + row0) * d;
  float* f3 = a.st32 + (3 * rows + row0) * d;
  float* ao = a.st32 + (4 * rows + row0) * d;
  float* xb = a.st32 + (5 * rows + row0) * d;
  float* zb = a.st32 + (6 * rows + row0) * d;
  float* np = a.npart + (size_t)b * no.total;

  float* red = reinterpret_cast<float*>(smem + pl.red);
  float* stats = red + kWarps;
  float* st = reinterpret_cast<float*>(smem + pl.st);
  float* st2 = reinterpret_cast<float*>(smem + pl.st2);
  T* hb = reinterpret_cast<T*>(smem + pl.hb);
  float* pf = reinterpret_cast<float*>(smem + pl.pf);
  T* pb = reinterpret_cast<T*>(smem + pl.pb);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  T* cb = reinterpret_cast<T*>(smem + pl.cb);
  const int ls = pl.ld_st, lh = pl.ld_hd;
  T* const none = nullptr;

  // ---- the forward chain ----
  // the first FFN half: h_1 to the workspace, f1 = h_1 W2 + b2 (f32)
  auto ffn_fwd = [&](const T* zz, T* hh, float* ff) {
    for (int c0 = 0; c0 < dh; c0 += hc) {
      mac::prod<false, false>(zz, d, w1 + c0, dh, st, ls, false, n, hc, d);
      __syncthreads();
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hc; c += 32) {
          const T h = from_f<T>(gelu(st[r * ls + c] + a.b1[c0 + c]));
          hb[r * pl.ld_hb + c] = h;
          hh[(size_t)r * dh + c0 + c] = h;
        }
      __syncthreads();
      mac::prod<false, false>(hb, pl.ld_hb, w2 + (size_t)c0 * d, d, ff, d, c0 > 0, n,
                       d, hc);
      __syncthreads();
    }
    mac::add_row_vector(ff, d, a.b2, 1.0f, n, d);
    __syncthreads();
  };

  mac::layer_norm_rows(x, d, a.ln1s, a.ln1b, z1, d, n, d, n_real);
  __syncthreads();
  ffn_fwd(z1, h_1, f1);
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int r = i / d;
    x1[i] = (r < n_real ? to_f(x[i]) : 0.0f) + hrs * f1[i];
  }
  __syncthreads();
  mac::layer_norm_rows(x1, d, a.ln2s, a.ln2b, z2, d, n, d);
  __syncthreads();
  for (int hh = 0; hh < heads; ++hh) {
    // q | k | v of the head in one product; rounded after the bias, to
    // shared memory and the workspace (padded value rows zeroed)
    mac::prod<false, false>(z2, d, wqkv + hh * hd, 3 * d, st, ls, false, n, 3 * hd,
                     d, hd / 16, d);
    __syncthreads();
    T* dst[3] = {q, k, v};
    for (int j = 0; j < 3; ++j)
      round_block(st + j * hd, ls, dst[j], lh, n, hd, j == 2 ? n_real : n,
                  1.0f, qkv + j * d + hh * hd, 3 * d,
                  a.qkv_bias + j * d + hh * hd);
    __syncthreads();
    mac::prod<false, true>(q, lh, k, lh, st, ls, false, n, n, hd);
    __syncthreads();
    softmax_rows(st, ls, pb, pl.ld_pb, n, n_real, a.qk_scale);
    __syncthreads();
    mac::prod<false, false>(pb, pl.ld_pb, v, lh, st, ls, false, n, hd, n);
    __syncthreads();
    round_block(st, ls, none, 0, n, hd, n, 1.0f, ctx + hh * hd, d);
    __syncthreads();
  }
  mac::prod<false, false>(ctx, d, wout, d, ao, d, false, n, d, d);
  __syncthreads();
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const float av = ao[i] + a.out_bias[i % d];
    ao[i] = av;
    x2[i] = x1[i] + rs * av;
  }
  __syncthreads();
  mac::layer_norm_rows(x2, d, a.ln3s, a.ln3b, z3, d, n, d);
  __syncthreads();

  // ---- the backward chain ----
  // a FFN half's backward: out_bar = rs/2 xb, ob to the workspace (and
  // the f32 column sums to b2's partial), h1_bar of each chunk to the
  // workspace (its column sums to b1's partial), zb = h1_bar W1^T. The
  // second half also recomputes h_3 and f3 = h_3 W2 + b2 for rs_bar.
  auto ffn_bwd = [&](const T* zz, T* ob, T* h1b, T* hh, float* ff,
                     bool first) {
    for (int i = threadIdx.x; i < n * d; i += kThreads)
      ob[i] = from_f<T>(hrs * xb[i]);
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += hrs * xb[(size_t)r * d + c];
      np[no.b2 + c] = first ? sum : np[no.b2 + c] + sum;
    }
    __syncthreads();
    for (int c0 = 0; c0 < dh; c0 += hc) {
      mac::prod<false, false>(zz, d, w1 + c0, dh, st, ls, false, n, hc, d);
      mac::prod<false, true>(ob, d, w2 + (size_t)c0 * d, d, st2, pl.ld_st2, false,
                      n, hc, d);
      __syncthreads();
      if (hh != nullptr) {
        for (int r = warp; r < n; r += kWarps)
          for (int c = lane; c < hc; c += 32) {
            const T h = from_f<T>(gelu(st[r * ls + c] + a.b1[c0 + c]));
            hb[r * pl.ld_hb + c] = h;
            hh[(size_t)r * dh + c0 + c] = h;
          }
        __syncthreads();
        mac::prod<false, false>(hb, pl.ld_hb, w2 + (size_t)c0 * d, d, ff, d, c0 > 0,
                         n, d, hc);
        __syncthreads();
      }
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hc; c += 32) {
          const float h1 = st[r * ls + c] + a.b1[c0 + c];
          const T v1 = from_f<T>(st2[r * pl.ld_st2 + c] * gelu_grad(h1));
          hb[r * pl.ld_hb + c] = v1;
          h1b[(size_t)r * dh + c0 + c] = v1;
        }
      __syncthreads();
      for (int c = threadIdx.x; c < hc; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < n_real; ++r) sum += to_f(hb[r * pl.ld_hb + c]);
        np[no.b1 + c0 + c] = first ? sum : np[no.b1 + c0 + c] + sum;
      }
      mac::prod<false, true>(hb, pl.ld_hb, w1 + c0, dh, zb, d, c0 > 0, n, d, hc);
      __syncthreads();
    }
  };

  // stage 3: x3 = x2 + rs/2 FFN(LN3 x2), x3_bar = g * scaler
  for (int i = threadIdx.x; i < n * d; i += kThreads)
    xb[i] = i / d < n_real ? to_f(g[i]) * a.scaler : 0.0f;
  __syncthreads();
  ffn_bwd(z3, ob_3, h1b_3, h_3, f3, true);
  mac::add_row_vector(f3, d, a.b2, 1.0f, n, d);
  __syncthreads();
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n * d; i += kThreads) acc += xb[i] * f3[i];
  const float rs3 = block_sum(acc, red);
  ln_bwd(x2, zb, a.ln3s, xb, n, n_real, d, 1 << 30, stats,
         np + no.ln + 4 * d, np + no.ln + 5 * d);

  // stage 2: x2 = x1 + rs ao
  acc = 0.0f;
  for (int i = threadIdx.x; i < n * d; i += kThreads) acc += xb[i] * ao[i];
  const float rs2 = block_sum(acc, red);
  for (int i = threadIdx.x; i < n * d; i += kThreads)
    aod[i] = from_f<T>(rs * xb[i]);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < n_real; ++r) sum += rs * xb[(size_t)r * d + c];
    np[no.outb + c] = sum;
  }
  __syncthreads();
  for (int hh = 0; hh < heads; ++hh) {
    const T* qkv_h[3] = {qkv + hh * hd, qkv + d + hh * hd,
                         qkv + 2 * d + hh * hd};
    T* dst[3] = {q, k, v};
    for (int j = 0; j < 3; ++j)
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hd; c += 32)
          dst[j][r * lh + c] = qkv_h[j][(size_t)r * 3 * d + c];
    __syncthreads();
    mac::prod<false, true>(q, lh, k, lh, st, ls, false, n, n, hd);
    __syncthreads();
    softmax_rows(st, ls, pb, pl.ld_pb, n, n_real, a.qk_scale, pf, pl.ld_pf);
    __syncthreads();
    // q becomes round(q * tau) for k_bar
    for (int r = warp; r < n; r += kWarps)
      for (int c = lane; c < hd; c += 32)
        q[r * lh + c] = from_f<T>(to_f(q[r * lh + c]) * a.qk_scale);
    // cb = round(aod Wout[h*hd:(h+1)*hd, :]^T)
    mac::prod<false, true>(aod, d, wout + (size_t)hh * hd * d, d, st, ls, false, n,
                    hd, d);
    __syncthreads();
    round_block(st, ls, cb, lh, n, hd, n);
    __syncthreads();
    // v_bar = round(p)^T cb
    mac::prod<true, false>(pb, pl.ld_pb, cb, lh, st, ls, false, n, hd, n);
    __syncthreads();
    round_block(st, ls, none, 0, n, hd, n, 1.0f, qkvbar + 2 * d + hh * hd,
                3 * d);
    __syncthreads();
    // p_bar = cb v^T, then s_bar = round(p (p_bar - sum(p_bar p))) into pb
    mac::prod<false, true>(cb, lh, v, lh, st, ls, false, n, n, hd);
    __syncthreads();
    for (int r = warp; r < n; r += kWarps) {
      const float* prow = st + r * ls;
      const float* frow = pf + r * pl.ld_pf;
      if (r >= n_real) {
        for (int c = lane; c < n; c += 32) pb[r * pl.ld_pb + c] = from_f<T>(0.0f);
        continue;
      }
      float dot = 0.0f;
      for (int c = lane; c < n_real; c += 32) dot += prow[c] * frow[c];
      dot = warp_sum(dot);
      for (int c = lane; c < n; c += 32)
        pb[r * pl.ld_pb + c] =
            from_f<T>(c < n_real ? frow[c] * (prow[c] - dot) : 0.0f);
    }
    __syncthreads();
    // q_bar = round(tau s_bar k), k_bar = round(s_bar^T round(q tau))
    mac::prod<false, false>(pb, pl.ld_pb, k, lh, st, ls, false, n, hd, n);
    __syncthreads();
    round_block(st, ls, none, 0, n, hd, n, a.qk_scale, qkvbar + hh * hd,
                3 * d);
    __syncthreads();
    mac::prod<true, false>(pb, pl.ld_pb, q, lh, st, ls, false, n, hd, n);
    __syncthreads();
    round_block(st, ls, none, 0, n, hd, n, 1.0f, qkvbar + d + hh * hd,
                3 * d);
    __syncthreads();
  }
  for (int c = threadIdx.x; c < 3 * d; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < n_real; ++r) sum += to_f(qkvbar[(size_t)r * 3 * d + c]);
    np[no.qkvb + c] = sum;
  }
  // z2_bar = qkv_bar Wqkv^T, one product over 3D
  mac::prod<false, true>(qkvbar, 3 * d, wqkv, 3 * d, zb, d, false, n, d, 3 * d);
  __syncthreads();
  ln_bwd(x1, zb, a.ln2s, xb, n, n_real, d, 1 << 30, stats,
         np + no.ln + 2 * d, np + no.ln + 3 * d);

  // stage 1: x1 = x + rs/2 FFN(LN1 x)
  acc = 0.0f;
  for (int i = threadIdx.x; i < n * d; i += kThreads) acc += xb[i] * f1[i];
  const float rs1 = block_sum(acc, red);
  ffn_bwd(z1, ob_1, h1b_1, nullptr, nullptr, false);
  ln_bwd(x, zb, a.ln1s, xb, n, n_real, d, n_real, stats, np + no.ln,
         np + no.ln + d);
  if (threadIdx.x == 0) np[no.rs] = 0.5f * rs3 + rs2 + 0.5f * rs1;

  T* xbar = static_cast<T*>(a.xbar) + row0 * d;
  for (int i = threadIdx.x; i < n * d; i += kThreads)
    xbar[i] = from_f<T>(i / d < n_real ? xb[i] : 0.0f);
}

// ---- the f32 instance: mcb_rows_f32 ----

// Shared memory of one mcb_rows_f32 CTA: the reduction scratch and the
// rows' LayerNorm statistics, the staging ring of mac::gemm_tf32, then a
// region used by the FFN phases (the chunk's f32 pre-activation, later its
// f32 h1_bar, and the planes of h or h1_bar) and again by the attention
// phases (the f32 scores or p_bar, the f32 p, and the planes of p or
// s_bar). Row strides are 4 mod 16 floats: a fragment row read 4g + t
// hits 32 banks. nb: the column block of a product (the ring's width).
struct PlanF32 {
  size_t red, ring, pre, hbig, hsmall, st, pf, pbig, psmall, total;
  int slot, ld_h, ld_p;
};

__host__ __device__ inline PlanF32 make_plan_f32(int n, int hc, int nb) {
  PlanF32 p;
  p.slot = mac::ring_slot(n, nb);
  p.ld_h = hc + 4;
  p.ld_p = n + 4;
  const size_t fh = align128((size_t)n * p.ld_h * 4);
  const size_t fp = align128((size_t)n * p.ld_p * 4);
  size_t off = 0;
  p.red = off;   off += align128((size_t)(kWarps + 2 * 16 * kMaxRowTiles) * 4);
  p.ring = off;  off += align128((size_t)2 * mac::kStages * p.slot * 4);
  p.pre = off;
  p.hbig = off + fh;
  p.hsmall = off + 2 * fh;
  p.st = off;
  p.pf = off + fp;
  p.pbig = off + 2 * fp;
  p.psmall = off + 3 * fp;
  p.total = off + (3 * fh > 4 * fp ? 3 * fh : 4 * fp);
  return p;
}

// Column blocks of the f32 plan, widest first. A block of nb columns has
// ceil(nb / 32) column groups, each row group of up to 3 m16 tiles one
// warp per column group: one round of warp tiles where they fit. That
// also keeps a slice's 16-byte chunks (4 n + 4 nb) within mac::kMaxOwn
// per thread: n <= 96 at nb = 192, n <= 128 below.
constexpr int kBlocks[] = {192, 128, 96, 64, 32, 16};

__host__ __device__ inline bool block_fits(int n, int nb) {
  return ((nb + 31) / 32) *
             ((n / 16 + mac::kTileRows - 1) / mac::kTileRows) <=
         kWarps;
}

// p = softmax(s * qk_scale) over keys < n_real as split planes (padded keys
// 0), and with pf the f32 p too: vf::softmax_rows in f32, one warp per row.
__device__ void softmax_planes(const float* s, int lds, unsigned* big,
                               unsigned* small, int ldp, int n, int n_real,
                               float qk_scale, float* pf) {
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
      vf::split_bits(v, big[r * ldp + c], small[r * ldp + c]);
      if (pf != nullptr) pf[r * ldp + c] = v;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// dst[i] = f(row of i, a[i], b[i]) over an image's [n, d] f32 rows, four
// floats a thread at a time, each thread's loads of kU steps issued before
// its stores (a store may alias a later load, so one load at a time would
// wait out the memory's latency at every step). b may be null.
template <typename F>
__device__ void map_rows(float* dst, const float* a, const float* b, int n,
                         int d, F f) {
  constexpr int kU = 4;
  const int count = n * d;
  for (int i0 = threadIdx.x * 4; i0 < count; i0 += kThreads * 4 * kU) {
    float4 va[kU], vb[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads * 4;
      if (i < count) {
        va[u] = *reinterpret_cast<const float4*>(a + i);
        vb[u] = b != nullptr ? *reinterpret_cast<const float4*>(b + i)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads * 4;
      if (i < count) {
        const int r = i / d;
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(f(r, va[u].x, vb[u].x), f(r, va[u].y, vb[u].y),
                        f(r, va[u].z, vb[u].z), f(r, va[u].w, vb[u].w));
      }
    }
  }
}

// mcb_rows's chain in f32 on mac::gemm_tf32 (see the file's comment).
__global__ void __launch_bounds__(kThreads, 1) mcb_rows_f32(McbArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using mac::gemm_tf32;
  using mac::kAPlanes;
  using mac::kAPlanesT;
  using mac::kAStaged;
  using mac::op_b;
  using vf::split_bits;
  const int n = a.n_pad, n_real = a.n_real, d = a.d, heads = a.heads;
  const int hd = d / heads, dh = a.dh, hc = a.hc, nb = a.nb;
  const PlanF32 pl = make_plan_f32(n, hc, nb);
  const NpOff no = np_offsets(d, dh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const size_t rows = (size_t)a.batch * n;
  const size_t row0 = (size_t)b * n;
  const float rs = a.rs[0], hrs = 0.5f * rs, tau = a.qk_scale;

  const float* x = static_cast<const float*>(a.x) + row0 * d;
  const float* g = static_cast<const float*>(a.g) + row0 * d;
  const float* wqkv = static_cast<const float*>(a.wqkv);
  const float* wout = static_cast<const float*>(a.wout);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  float* z1 = static_cast<float*>(a.z13) + row0 * d;
  float* z3 = static_cast<float*>(a.z13) + (rows + row0) * d;
  float* z2 = static_cast<float*>(a.z2) + row0 * d;
  float* h_1 = static_cast<float*>(a.h13) + row0 * dh;
  float* h_3 = static_cast<float*>(a.h13) + (rows + row0) * dh;
  float* h1b_1 = static_cast<float*>(a.h1b13) + row0 * dh;
  float* h1b_3 = static_cast<float*>(a.h1b13) + (rows + row0) * dh;
  float* ob_1 = static_cast<float*>(a.ob13) + row0 * d;
  float* ob_3 = static_cast<float*>(a.ob13) + (rows + row0) * d;
  float* qkv = static_cast<float*>(a.qkv) + row0 * 3 * d;
  float* ctx = static_cast<float*>(a.ctx) + row0 * d;
  float* aod = static_cast<float*>(a.aod) + row0 * d;
  float* qkvbar = static_cast<float*>(a.qkvbar) + row0 * 3 * d;
  float* x1 = a.st32 + row0 * d;
  float* x2 = a.st32 + (rows + row0) * d;
  float* f1 = a.st32 + (2 * rows + row0) * d;
  float* cbg = a.st32 + (3 * rows + row0) * d;
  float* ao = a.st32 + (4 * rows + row0) * d;
  float* xb = a.st32 + (5 * rows + row0) * d;
  float* zb = a.st32 + (6 * rows + row0) * d;
  float* np = a.npart + (size_t)b * no.total;

  float* red = reinterpret_cast<float*>(smem + pl.red);
  float* stats = red + kWarps;
  const mac::Ring ring{reinterpret_cast<unsigned*>(smem + pl.ring), pl.slot};
  float* pre = reinterpret_cast<float*>(smem + pl.pre);
  unsigned* hbig = reinterpret_cast<unsigned*>(smem + pl.hbig);
  unsigned* hsmall = reinterpret_cast<unsigned*>(smem + pl.hsmall);
  float* st = reinterpret_cast<float*>(smem + pl.st);
  float* pf = reinterpret_cast<float*>(smem + pl.pf);
  unsigned* pbig = reinterpret_cast<unsigned*>(smem + pl.pbig);
  unsigned* psmall = reinterpret_cast<unsigned*>(smem + pl.psmall);
  const int lh = pl.ld_h, lp = pl.ld_p;
  auto staged = [](const float* p, int ld) {
    return mac::OpA{p, ld, nullptr, nullptr};
  };
  const mac::OpA hpl{nullptr, lh, hbig, hsmall};
  const mac::OpA ppl{nullptr, lp, pbig, psmall};
  auto to_st = [&](int r, int c, float v0, float v1) {
    st[r * lp + c] = v0;
    st[r * lp + c + 1] = v1;
  };

  // ---- the forward chain ----
  // the first FFN half: h_1 to the workspace and its planes, and its
  // pre-activation z1 W1 + b1 to h1b_1 (its backward reads it there, then
  // writes h1_bar_1 over it); f1 = h_1 W2 summed over the chunks in the
  // workspace; after the last chunk f1 += b2 and x1 = x + rs/2 f1
  mac::layer_norm_rows(x, d, a.ln1s, a.ln1b, z1, d, n, d, n_real);
  for (int c0 = 0; c0 < dh; c0 += hc) {
    gemm_tf32<kAStaged, false>(
        ring, n, hc, d, nb, staged(z1, d), op_b(w1 + c0, dh),
        [&](int r, int c, float v0, float v1) {
          const float p0 = v0 + a.b1[c0 + c], p1 = v1 + a.b1[c0 + c + 1];
          const float h0 = gelu(p0), h1 = gelu(p1);
          split_bits(h0, hbig[r * lh + c], hsmall[r * lh + c]);
          split_bits(h1, hbig[r * lh + c + 1], hsmall[r * lh + c + 1]);
          store2(h_1 + (size_t)r * dh + c0 + c, h0, h1);
          store2(h1b_1 + (size_t)r * dh + c0 + c, p0, p1);
        });
    const bool last = c0 + hc == dh;
    gemm_tf32<kAPlanes, false>(
        ring, n, d, hc, nb, hpl, op_b(w2 + (size_t)c0 * d, d),
        [&](int r, int c, float v0, float v1) {
          store2(f1 + (size_t)r * d + c, last ? v0 + a.b2[c] : v0,
                 last ? v1 + a.b2[c + 1] : v1);
        },
        c0 > 0 ? f1 : nullptr, d);
  }
  __syncthreads();
  map_rows(x1, x, f1, n, d, [&](int r, float xv, float f) {
    return (r < n_real ? xv : 0.0f) + hrs * f;
  });
  __syncthreads();
  mac::layer_norm_rows(x1, d, a.ln2s, a.ln2b, z2, d, n, d);
  for (int hh = 0; hh < heads; ++hh) {
    // q | k | v of the head in one product, + bias, to the workspace
    // (padded value rows zeroed)
    gemm_tf32<kAStaged, false>(
        ring, n, 3 * hd, d, nb, staged(z2, d),
        op_b(wqkv + hh * hd, 3 * d, 1.0f, hd, d),
        [&](int r, int c, float v0, float v1) {
          const int j = c / hd, cc = j * d + hh * hd + c % hd;
          const bool zero = j == 2 && r >= n_real;
          store2(qkv + (size_t)r * 3 * d + cc,
                 zero ? 0.0f : v0 + a.qkv_bias[cc],
                 zero ? 0.0f : v1 + a.qkv_bias[cc + 1]);
        });
    gemm_tf32<kAStaged, true>(ring, n, n, hd, nb,
                              staged(qkv + hh * hd, 3 * d),
                              op_b(qkv + d + hh * hd, 3 * d), to_st);
    __syncthreads();
    softmax_planes(st, lp, pbig, psmall, lp, n, n_real, tau, nullptr);
    gemm_tf32<kAPlanes, false>(
        ring, n, hd, n, nb, ppl, op_b(qkv + 2 * d + hh * hd, 3 * d),
        [&](int r, int c, float v0, float v1) {
          store2(ctx + (size_t)r * d + hh * hd + c, v0, v1);
        });
  }
  gemm_tf32<kAStaged, false>(
      ring, n, d, d, nb, staged(ctx, d), op_b(wout, d),
      [&](int r, int c, float v0, float v1) {
        store2(ao + (size_t)r * d + c, v0 + a.out_bias[c],
               v1 + a.out_bias[c + 1]);
      });
  __syncthreads();
  map_rows(x2, x1, ao, n, d,
           [&](int, float xv, float av) { return xv + rs * av; });
  __syncthreads();
  mac::layer_norm_rows(x2, d, a.ln3s, a.ln3b, z3, d, n, d);

  // ---- the backward chain ----
  // a FFN half's backward: out_bar = rs/2 xb, ob to the workspace (and the
  // f32 column sums to b2's partial); per chunk the pre-activation
  // h1 = z W1 + b1 (the second half's recomputed from zz, which also
  // writes h_3 = gelu(h1); the first half's, zz null, copied from where
  // the forward left it in h1b), then
  // G = xb W2^T and h1_bar = (rs/2 G) gelu'(h1) to the workspace and its
  // planes (its column sums to b1's partial), zb (+)= h1_bar W1^T. Returns
  // this thread's share of sum(x3_bar f3) = sum(h_3 G) + sum(b2 x3_bar)
  // (meaningful for the second half, whose f3 it is).
  auto ffn_bwd = [&](const float* zz, float* ob, float* h1b, float* hout,
                     bool first) {
    float racc = 0.0f;
    map_rows(ob, xb, nullptr, n, d,
             [&](int, float v, float) { return hrs * v; });
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.0f, sx = 0.0f;
      for (int r = 0; r < n_real; ++r) {
        const float v = xb[(size_t)r * d + c];
        sum += hrs * v;
        sx += v;
      }
      np[no.b2 + c] = first ? sum : np[no.b2 + c] + sum;
      racc += sx * a.b2[c];
    }
    for (int c0 = 0; c0 < dh; c0 += hc) {
      if (zz != nullptr) {
        gemm_tf32<kAStaged, false>(
            ring, n, hc, d, nb, staged(zz, d), op_b(w1 + c0, dh),
            [&](int r, int c, float v0, float v1) {
              const float p0 = v0 + a.b1[c0 + c];
              const float p1 = v1 + a.b1[c0 + c + 1];
              pre[r * lh + c] = p0;
              pre[r * lh + c + 1] = p1;
              if (hout != nullptr)
                store2(hout + (size_t)r * dh + c0 + c, gelu(p0), gelu(p1));
            });
      } else {
        for (int i = threadIdx.x * 4; i < n * hc; i += kThreads * 4)
          vf::cp_async16(pre + (i / hc) * lh + i % hc,
                         h1b + (size_t)(i / hc) * dh + c0 + i % hc);
        vf::cp_async_commit();
        vf::cp_async_wait<0>();  // the next product's barrier shows it
      }
      gemm_tf32<kAStaged, true>(
          ring, n, hc, d, nb, staged(xb, d), op_b(w2 + (size_t)c0 * d, d),
          [&](int r, int c, float v0, float v1) {
            float* pp = pre + r * lh + c;
            const float p0 = pp[0], p1 = pp[1];
            const float u0 = (hrs * v0) * gelu_grad(p0);
            const float u1 = (hrs * v1) * gelu_grad(p1);
            if (hout != nullptr) racc += gelu(p0) * v0 + gelu(p1) * v1;
            pp[0] = u0;
            pp[1] = u1;
            split_bits(u0, hbig[r * lh + c], hsmall[r * lh + c]);
            split_bits(u1, hbig[r * lh + c + 1], hsmall[r * lh + c + 1]);
            store2(h1b + (size_t)r * dh + c0 + c, u0, u1);
          });
      __syncthreads();
      for (int c = threadIdx.x; c < hc; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < n_real; ++r) sum += pre[r * lh + c];
        np[no.b1 + c0 + c] = first ? sum : np[no.b1 + c0 + c] + sum;
      }
      gemm_tf32<kAPlanes, true>(
          ring, n, d, hc, nb, hpl, op_b(w1 + c0, dh),
          [&](int r, int c, float v0, float v1) {
            store2(zb + (size_t)r * d + c, v0, v1);
          },
          c0 > 0 ? zb : nullptr, d);
    }
    __syncthreads();
    return racc;
  };

  // stage 3: x3 = x2 + rs/2 FFN(LN3 x2), x3_bar = g * scaler
  __syncthreads();
  map_rows(xb, g, nullptr, n, d, [&](int r, float gv, float) {
    return r < n_real ? gv * a.scaler : 0.0f;
  });
  __syncthreads();
  const float rs3 = block_sum(ffn_bwd(z3, ob_3, h1b_3, h_3, true), red);
  ln_bwd(x2, zb, a.ln3s, xb, n, n_real, d, 1 << 30, stats,
         np + no.ln + 4 * d, np + no.ln + 5 * d);

  // stage 2: x2 = x1 + rs ao
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n * d; i += kThreads) acc += xb[i] * ao[i];
  const float rs2 = block_sum(acc, red);
  map_rows(aod, xb, nullptr, n, d,
           [&](int, float v, float) { return rs * v; });
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < n_real; ++r) sum += rs * xb[(size_t)r * d + c];
    np[no.outb + c] = sum;
  }
  for (int hh = 0; hh < heads; ++hh) {
    const float* qh = qkv + hh * hd;
    const float* kh = qkv + d + hh * hd;
    const float* vh = qkv + 2 * d + hh * hd;
    float* cbh = cbg + hh * hd;
    gemm_tf32<kAStaged, true>(ring, n, n, hd, nb, staged(qh, 3 * d),
                              op_b(kh, 3 * d), to_st);
    __syncthreads();
    softmax_planes(st, lp, pbig, psmall, lp, n, n_real, tau, pf);
    // cb = aod Wout[h*hd:(h+1)*hd, :]^T to the workspace
    gemm_tf32<kAStaged, true>(
        ring, n, hd, d, nb, staged(aod, d),
        op_b(wout + (size_t)hh * hd * d, d),
        [&](int r, int c, float v0, float v1) {
          store2(cbh + (size_t)r * d + c, v0, v1);
        });
    // v_bar = p^T cb
    gemm_tf32<kAPlanesT, false>(
        ring, n, hd, n, nb, ppl, op_b(cbh, d),
        [&](int r, int c, float v0, float v1) {
          store2(qkvbar + (size_t)r * 3 * d + 2 * d + hh * hd + c, v0, v1);
        });
    // p_bar = cb v^T, then s_bar = p (p_bar - sum(p_bar p)) as planes
    gemm_tf32<kAStaged, true>(ring, n, n, hd, nb, staged(cbh, d),
                              op_b(vh, 3 * d), to_st);
    __syncthreads();
    for (int r = warp; r < n; r += kWarps) {
      const float* prow = st + r * lp;
      const float* frow = pf + r * lp;
      float dot = 0.0f;
      for (int c = lane; c < n_real; c += 32) dot += prow[c] * frow[c];
      dot = warp_sum(dot);
      for (int c = lane; c < n; c += 32) {
        const float v =
            r < n_real && c < n_real ? frow[c] * (prow[c] - dot) : 0.0f;
        split_bits(v, pbig[r * lp + c], psmall[r * lp + c]);
      }
    }
    // q_bar = tau s_bar k, k_bar = s_bar^T (q tau)
    gemm_tf32<kAPlanes, false>(
        ring, n, hd, n, nb, ppl, op_b(kh, 3 * d),
        [&](int r, int c, float v0, float v1) {
          store2(qkvbar + (size_t)r * 3 * d + hh * hd + c, v0 * tau,
                 v1 * tau);
        });
    gemm_tf32<kAPlanesT, false>(
        ring, n, hd, n, nb, ppl, op_b(qh, 3 * d, tau),
        [&](int r, int c, float v0, float v1) {
          store2(qkvbar + (size_t)r * 3 * d + d + hh * hd + c, v0, v1);
        });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * d; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < n_real; ++r) sum += qkvbar[(size_t)r * 3 * d + c];
    np[no.qkvb + c] = sum;
  }
  // z2_bar = qkv_bar Wqkv^T, one product over 3D
  gemm_tf32<kAStaged, true>(
      ring, n, d, 3 * d, nb, staged(qkvbar, 3 * d), op_b(wqkv, 3 * d),
      [&](int r, int c, float v0, float v1) {
        store2(zb + (size_t)r * d + c, v0, v1);
      });
  __syncthreads();
  ln_bwd(x1, zb, a.ln2s, xb, n, n_real, d, 1 << 30, stats,
         np + no.ln + 2 * d, np + no.ln + 3 * d);

  // stage 1: x1 = x + rs/2 FFN(LN1 x)
  acc = 0.0f;
  for (int i = threadIdx.x; i < n * d; i += kThreads) acc += xb[i] * f1[i];
  const float rs1 = block_sum(acc, red);
  ffn_bwd(nullptr, ob_1, h1b_1, nullptr, false);
  ln_bwd(x, zb, a.ln1s, xb, n, n_real, d, n_real, stats, np + no.ln,
         np + no.ln + d);
  if (threadIdx.x == 0) np[no.rs] = 0.5f * rs3 + rs2 + 0.5f * rs1;

  map_rows(static_cast<float*>(a.xbar) + row0 * d, xb, nullptr, n, d,
           [&](int r, float v, float) { return r < n_real ? v : 0.0f; });
}

// ---- the f32 weight products: mcb_wgrad_f32 ----
// W_bar = A^T G of vfb_wgrad_wgmma in f32, as split TF32 in three passes:
// blockIdx.x a 128 x 64 output tile of one problem, blockIdx.y a slice of
// rows; each CTA writes its own partial tile. 8 warps, 32 x 32 each. Rows
// come in chunks of kRowStep through a ring of two slots by 16-byte
// cp.async (zeros past the slice or the matrix), split once where they
// land; each chunk sums into a fresh register tile, added to the total
// with f32 adds: the tensor cores' own accumulation is not rounded to
// nearest, and over thousands of rows its error would grow with the row
// count.
constexpr int kWgM = 128, kWgN = 64, kWgThreads = 256;
constexpr int kWgLdA = kWgM + 8, kWgLdG = kWgN + 8;  // 8 mod 32: 8t + g
constexpr int kWgSlot = kRowStep * (kWgLdA + kWgLdG);  // one plane
constexpr int kWgSmem = 4 * kWgSlot * 4;               // 2 slots x 2 planes

__host__ __device__ inline int wg_tiles(const Problem& p) {
  return ((p.m + kWgM - 1) / kWgM) * ((p.n + kWgN - 1) / kWgN);
}

__global__ void __launch_bounds__(kWgThreads, 2)
mcb_wgrad_f32(Problems ps, float* wpart) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned* ring = reinterpret_cast<unsigned*>(wg_smem);
  int t = blockIdx.x, pi = 0;
  while (t >= wg_tiles(ps.p[pi])) {
    t -= wg_tiles(ps.p[pi]);
    ++pi;
  }
  const Problem pr = ps.p[pi];
  const int tn = (pr.n + kWgN - 1) / kWgN;
  const int m0 = (t / tn) * kWgM, n0 = (t % tn) * kWgN;
  const float* a = static_cast<const float*>(pr.a);
  const float* g = static_cast<const float*>(pr.g);
  const int r_begin = blockIdx.y * ps.rows_per_split;
  const int r_end = imin(ps.rows, r_begin + ps.rows_per_split);
  const int chunks = imax(0, (r_end - r_begin + kRowStep - 1) / kRowStep);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // this thread's 16-byte chunks of row chunk c (copied, then split)
  auto own = [&](int c, auto&& fn) {
    unsigned* big = ring + (size_t)(c & 1) * 2 * kWgSlot;
    const int r0 = r_begin + c * kRowStep;
    for (int i = threadIdx.x; i < kRowStep * kWgM / 4; i += kWgThreads) {
      const int rr = i / (kWgM / 4), q = (i % (kWgM / 4)) * 4;
      const int r = r0 + rr, m = m0 + q;
      const bool in = r < r_end && m < pr.m;
      fn(big + rr * kWgLdA + q, in ? a + (size_t)r * pr.m + m : a, in);
    }
    for (int i = threadIdx.x; i < kRowStep * kWgN / 4; i += kWgThreads) {
      const int rr = i / (kWgN / 4), q = (i % (kWgN / 4)) * 4;
      const int r = r0 + rr, nn = n0 + q;
      const bool in = r < r_end && nn < pr.n;
      fn(big + kRowStep * kWgLdA + rr * kWgLdG + q,
         in ? g + (size_t)r * pr.n + nn : g, in);
    }
  };
  auto stage = [&](int c) {
    own(c, [](unsigned* dst, const float* src, bool in) {
      vf::cp_async16(dst, src, in);
    });
    vf::cp_async_commit();
  };

  float tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.0f;
  if (chunks > 0) stage(0);
  for (int c = 0; c < chunks; ++c) {
    vf::cp_async_wait<0>();
    own(c, [](unsigned* dst, const float*, bool) {
      vf::split4(dst, kWgSlot, 1.0f);
    });
    __syncthreads();  // chunk c is split; the other slot is free
    if (c + 1 < chunks) stage(c + 1);
    const unsigned* ab = ring + (size_t)(c & 1) * 2 * kWgSlot;
    const unsigned* as = ab + kWgSlot;
    const unsigned* gb = ab + kRowStep * kWgLdA;
    const unsigned* gs = as + kRowStep * kWgLdA;
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kRowStep; kk += 8) {
      unsigned fb[4][2], fs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i0 = (kk + tq) * kWgLdG + wn + j * 8 + gq;
        fb[j][0] = gb[i0];
        fb[j][1] = gb[i0 + 4 * kWgLdG];
        fs[j][0] = gs[i0];
        fs[j][1] = gs[i0 + 4 * kWgLdG];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A^T: element (m, k = row) at row * kWgLdA + m
        const int i0 = (kk + tq) * kWgLdA + wm + i * 16 + gq;
        const int dk = 4 * kWgLdA;
        const unsigned fa[4] = {ab[i0], ab[i0 + 8], ab[i0 + dk],
                                ab[i0 + dk + 8]};
        const unsigned fas[4] = {as[i0], as[i0 + 8], as[i0 + dk],
                                 as[i0 + dk + 8]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vf::mma_tf32(part[i][j], fas, fb[j]);
          vf::mma_tf32(part[i][j], fa, fs[j]);
          vf::mma_tf32(part[i][j], fa, fb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] += part[i][j][e];
  }
  float* out = wpart + blockIdx.y * ps.total + pr.out;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm + i * 16 + gq, nn = n0 + wn + j * 8 + 2 * tq;
      if (nn >= pr.n) continue;
      if (m < pr.m)
        store2(out + (size_t)m * pr.n + nn, tot[i][j][0], tot[i][j][1]);
      if (m + 8 < pr.m)
        store2(out + (size_t)(m + 8) * pr.n + nn, tot[i][j][2], tot[i][j][3]);
    }
}

// Launches mcb_wgrad_f32 over the problems of `ps` (unused entries m = 0;
// ps.rows set) and `splits` slices of rows; returns the first CUDA error,
// else 0.
inline int wgrad_f32(Problems ps, float* wpart, int splits,
                     cudaStream_t st) {
  ps.rows_per_split = slice_rows(ps.rows, splits, kRowStep);
  int ntiles = 0;
  for (const Problem& p : ps.p)
    if (p.m > 0) ntiles += wg_tiles(p);
  cudaError_t err = cudaFuncSetAttribute(
      mcb_wgrad_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  mcb_wgrad_f32<<<dim3(ntiles, splits), kWgThreads, kWgSmem, st>>>(ps,
                                                                   wpart);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const McbArgs& a, cudaStream_t st) {
  auto rows_kernel = sizeof(T) == 2 ? mcb_rows<bf16> : mcb_rows_f32;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<a.batch, kThreads, a.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int d = a.d, dh = a.dh;
  const size_t rows = (size_t)a.batch * a.n_pad;
  const size_t wtotal = (size_t)4 * d * d + (size_t)2 * d * dh;
  // the attention's products over B*n_pad rows, then the shared FFN's over
  // the two halves' 2*B*n_pad rows; both write the same partial layout
  for (int pass = 0; pass < 2; ++pass) {
    Problems ps = {};
    if (pass == 0) {
      ps.p[0] = {a.z2, a.qkvbar, d, 3 * d, 0};
      ps.p[1] = {a.ctx, a.aod, d, d, (size_t)3 * d * d};
    } else {
      ps.p[0] = {a.z13, a.h1b13, d, dh, (size_t)4 * d * d};
      ps.p[1] = {a.h13, a.ob13, dh, d, (size_t)4 * d * d + (size_t)d * dh};
    }
    ps.total = wtotal;
    ps.rows = (int)(pass == 0 ? rows : 2 * rows);
    err = (cudaError_t)(sizeof(T) == 2
                            ? wgrad_bf16(ps, a.wpart, a.splits, st)
                            : wgrad_f32(ps, a.wpart, a.splits, st));
    if (err != cudaSuccess) return (int)err;
  }
  const int nlen = np_offsets(d, dh).total;
  const size_t all = wtotal + (size_t)nlen;
  vfb_reduce<<<(unsigned)((all + 255) / 256), 256, 0, st>>>(
      a.wpart, a.splits, wtotal, a.npart, a.batch, nlen, a.out);
  return (int)cudaGetLastError();
}

bool shape_ok(int n_pad, int n_real, int d, int heads, int dh) {
  return heads > 0 && d % heads == 0 && d % 16 == 0 && (d / heads) % 16 == 0 &&
         dh % 16 == 0 && n_pad % 16 == 0 && n_pad > 0 &&
         n_pad <= 16 * kMaxRowTiles && n_real > 0 && n_real <= n_pad;
}

}  // namespace macb

#ifndef MCB_KERNELS_ONLY

extern "C" {

// Chooses the plan of the per-image kernel: the FFN chunk width, the
// shared memory and, in f32, the column block. A shape has one where
// mcb_rows's layout (make_plan) fits with some chunk; in bf16 that layout
// is the plan (wide chunks first), in f32 make_plan_f32's (wide column
// blocks, then wide chunks). Returns 0 when the shape has a plan, 1 when
// it has none (the wrapper raises).
int mcb_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int* hc_out, int* smem_out, int* nb_out) {
  if (!macb::shape_ok(n_pad, n_real, d, heads, dh)) return 1;
  for (int hc : mac::kChunks) {
    if (dh % hc) continue;
    const macb::Plan p = macb::make_plan(n_pad, d, d / heads, hc, tbytes);
    if (p.total > (size_t)vf::kMaxSmem) continue;
    if (tbytes == 2) {
      *hc_out = hc;
      *smem_out = (int)p.total;
      *nb_out = 0;
      return 0;
    }
    for (int nb : macb::kBlocks) {
      if (!macb::block_fits(n_pad, nb)) continue;
      for (int hc32 : mac::kChunks) {
        if (dh % hc32) continue;
        const macb::PlanF32 q = macb::make_plan_f32(n_pad, hc32, nb);
        if (q.total <= (size_t)vf::kMaxSmem) {
          *hc_out = hc32;
          *smem_out = (int)q.total;
          *nb_out = nb;
          return 0;
        }
      }
    }
    return 1;
  }
  return 1;
}

// Launches the backward (four kernels) on `stream`; returns the first
// cudaGetLastError() that is not 0, else 0. `tbytes` is x's element size.
int mcb_launch(int tbytes, const McbArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? macb::launch<vf::bf16>(*args, st)
                     : macb::launch<float>(*args, st);
}

const char* mcb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // MCB_KERNELS_ONLY
