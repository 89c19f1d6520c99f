// The tiled route of one evaluation of the Macaron vector field and of its
// backward, on Hopper (sm_90a), for shapes where one image does not fit one
// CTA of macaron.cu / macaron_bwd.cu (more than 128 padded tokens, such as
// a 224 px ViTMacaron at patch 16: 197 tokens padded to 208, D=768, 12
// heads, dh=1536). Past 256 padded tokens the attention runs
// vector_field_tiled.cu's key-tiled instances.
//
// Replaces the TPU kernels odevit_tpu/kernels/macaron.py::_macaron_kernel
// (plain, Euler and stage-advance modes) and _macaron_bwd_kernel (the 16
// cotangents) at those shapes. The arithmetic is the one-CTA kernels'
// (macaron.cu's header): the state x -> x1 -> x2 -> x3 in f32, the
// LayerNorm outputs (eps 1e-6), qkv after its bias, p, ctx and gelu(h)
// rounded to x's dtype, every product accumulated in f32, the FFN output
// and attn_o added to the state in f32, f rounded once (or, in the Euler
// and stage-advance modes, x + dt f and base + dt f formed from the f32 f).
// Only the split of the work differs: a sequence of launches over all B
// n_pad rows, intermediates in device memory between them, built from the
// tiled route of vector_field_tiled.cu (its 128x128 products, with the
// bias, GELU and Macaron residual epilogues, and its softmax attention
// kernels) and the weight-product kernels of vector_field_bwd.cu and
// macaron_bwd.cu.
//
// Forward, ten launches:
//   mct_ln        z = round(LN1(x)), and the f32 state x (one warp a row,
//                 macaron.cu's LayerNorm);
//   vft_gemm      h = round(gelu(z W1 + b1));
//   vft_gemm      x1 = x + rs/2 (h W2 + b2), in place in the f32 state;
//   mct_ln        z = round(LN2(x1));
//   vft_gemm      qkv = round(z Wqkv + qkv_bias);
//   vft_attn      ctx = round(round(softmax(q k^T tau)) v), per (image,
//                 head, query tile), padded keys masked by selection;
//   vft_gemm      x2 = x1 + rs (ctx Wout + out_bias), in place;
//   mct_ln        z = round(LN3(x2));
//   vft_gemm      h = round(gelu(z W1 + b1));
//   vft_gemm      out = round(scaler x3), x3 = x2 + rs/2 (h W2 + b2), or
//                 round(x + dt scaler x3) / round(base + dt scaler x3).
// Rows >= n_real evolve on their own, as in macaron.cu: LayerNorm and the
// products are per row, keys >= n_real get p = 0 by selection and value
// rows >= n_real are zeroed, so nothing a padded row holds reaches a real
// row.
//
// Backward, twenty-five launches, no atomics (two runs are bit-identical).
// Rows >= n_real of x and g read as zeros, so every operand of a weight
// product is finite and zero-cotangent on them:
//   the forward chain again (mct_ln, vft_gemm x2, mct_ln, vft_gemm,
//   vft_attn, vft_gemm, mct_ln, vft_gemm x2), keeping z1, z3, z2, h_1, h_3
//   and their f32 pre-GELU values, qkv, ctx, and in f32 x1, x2, f1 = h_1 W2
//   + b2, ao = ctx Wout + out_bias and f3;
//   mct_stage 3   x3_bar = g scaler, ob_3 = round(rs/2 x3_bar), b2's
//                 partial, sum(x3_bar f3);
//   vft_gemm x2   h1_bar_3 = round((ob_3 W2^T) gelu'(h1_3)), z_bar =
//                 h1_bar_3 W1^T (f32);
//   mct_stage 2   LN3's backward into x_bar (macb::ln_bwd), its vectors'
//                 partials, b1's partial, sum(x2_bar ao), aod = round(rs
//                 x2_bar), out_bias's partial;
//   vft_gemm      cb = round(aod Wout^T);
//   vft_attn<bwd>, vft_attn_keys
//                 q_bar, k_bar, v_bar (vector_field_tiled.cu);
//   vft_gemm      z_bar = qkv_bar Wqkv^T (f32);
//   mct_stage 1   LN2's backward, qkv_bias's partial, sum(x1_bar f1), ob_1,
//                 b2's partial;
//   vft_gemm x2   h1_bar_1, z_bar;
//   mct_stage 0   LN1's backward (x read as zeros on padded rows), b1's
//                 partial, x_bar = round(x_bar), rs_bar = 1/2 sum(x3_bar
//                 f3) + sum(x2_bar ao) + 1/2 sum(x1_bar f1);
//   vfb_wgrad_wgmma or mcb_wgrad_f32, twice: Wqkv_bar = z2^T qkv_bar and
//                 Wout_bar = ctx^T aod over the B n_pad rows; the shared
//                 FFN's W1_bar = [z1; z3]^T [h1_bar_1; h1_bar_3] and W2_bar
//                 = [h_1; h_3]^T [ob_1; ob_3] over both halves' rows
//                 concatenated, as macaron_bwd.cu lays them out;
//   vfb_reduce    the weight partials over the row slices and the
//                 per-image partials (macb::np_offsets' layout) over the
//                 images, each in a fixed order.
// The column sums (the six LayerNorm vectors, the four biases) and the
// three rs terms are per-image partials, each summed over rows in order
// by one CTA per image (mct_stage).
//
// Bound. At B=64, 197 real tokens, D=768, dh=1536 one evaluation does
// 186 GFLOP (two FFN halves, the projections, the attention): 0.19 ms at
// 989 TFLOP/s in bf16 and, as split TF32 (three TF32 passes at 495
// TFLOP/s, faster than the 67 TFLOP/s f32 peak outside the tensor cores),
// 1.13 ms in f32; the backward about 3x that. Operations bound both. The
// f32 forward's products alone, 188 GFLOP over the padded rows, take
// 1.14 ms as split TF32. The f32 instance (the main path: a
// Macaron model's states are f32) runs its products on vft_gemm_tf32
// (split TF32 on wgmma: A split in registers, B once into swizzled
// planes) and its whole-row attention on vf::mm_f32 (split TF32 WMMA);
// past 256 padded tokens the key-tiled f32 attention CTAs still run on
// the CUDA cores. Intermediates stay in device memory between launches.
// Nothing goes to a library.

#define VFT_KERNELS_ONLY
#include "vector_field_tiled.cu"
#define MAC_HELPERS_ONLY
#include "macaron.cu"
#define MCB_KERNELS_ONLY
#include "macaron_bwd.cu"

// Everything one tiled evaluation or backward needs, passed by pointer from
// Python (ctypes). Scratch buffers are allocated by the caller; R = B n_pad
// rows, "2R" buffers hold the first FFN half's rows, then the second's.
struct MctArgs {
  const void* x;
  const void* base;        // forward, mode 2: [R, D]
  const void* g;           // backward: the cotangent of f(x)
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
  void* out;               // forward: the result; backward: x_bar
  void* z;                 // forward [R, D]; backward z1, z3 [2R, D]
  void* z2;                // backward [R, D]
  void* h;                 // forward [R, dh]; backward h_1, h_3 [2R, dh]
  float* h1;               // backward: the pre-GELU values [2R, dh]
  void* h1b;               // backward: h1_bar_1, h1_bar_3 [2R, dh]
  void* ob;                // backward: ob_1, ob_3 [2R, D]
  void* qkv;               // [R, 3D]
  void* ctx;               // [R, D]
  void* aod;               // backward [R, D]
  void* cb;                // backward [R, D]
  void* qkvb;              // backward [R, 3D]
  void* pg;                // backward [B, H, n_pad, n_pad]
  void* sbar;              // backward [B, H, n_pad, n_pad]
  float* x1;               // the f32 state; backward: x1 [R, D]
  float* x2;               // backward, f32 [R, D] each: x2, f1, f3, ao,
  float* f1;               // the running x_bar and z_bar
  float* f3;
  float* ao;
  float* xb;
  float* zb;
  float* npart;            // backward [B, NP] (macb::np_offsets)
  float* rsp;              // backward [B, 3]: the image's three rs sums
  float* wpart;            // backward [splits, W]
  float* wbars;            // backward [W + NP]: Wqkv, Wout, W1, W2, then
                           // the partials' sums
  int batch, n_pad, n_real, d, heads, dh, mode, mt, splits;
  float scaler, qk_scale, dt;
};

namespace mct {

using vft::GemmArgs;

// z = round(LN(x) s + b) over kWarps rows of image blockIdx.x (from row
// blockIdx.y kWarps): macaron.cu's layer_norm_rows, one warp per row. With
// zero_pad, rows >= n_real read as zeros; with `copy`, the rows (as read)
// are stored there in f32.
template <typename S, typename T>
__global__ void __launch_bounds__(vf::kThreads)
mct_ln(const S* src, int n_pad, int n_real, bool zero_pad, int d,
       const float* s, const float* b, T* z, float* copy) {
  const int r0 = blockIdx.y * vf::kWarps;
  const int rows = vf::imin(vf::kWarps, n_pad - r0);
  const int zero_from = zero_pad ? n_real - r0 : 1 << 30;
  const size_t o = ((size_t)blockIdx.x * n_pad + r0) * d;
  mac::layer_norm_rows(src + o, d, s, b, z + o, d, rows, d, zero_from);
  if (copy != nullptr)
    for (int i = threadIdx.x; i < rows * d; i += vf::kThreads)
      copy[o + i] = i / d < zero_from ? vf::to_f(src[o + i]) : 0.0f;
}

// sum over the image's real rows of column c of src (ld columns), scaled
// by `scale`, written to dst[c] or added to it (`add`), for c < w; rows in
// order.
template <typename S>
__device__ void colsum(const S* src, int ld, int w, int n_real, float scale,
                       float* dst, bool add) {
  for (int c = threadIdx.x; c < w; c += vf::kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < n_real; ++r)
      sum += scale * vf::to_f(src[(size_t)r * ld + c]);
    dst[c] = add ? dst[c] + sum : sum;
  }
}

// One CTA per image: the backward's per-row steps between products (see
// the top of the file), `stage` 3 (x3_bar), 2 (LN3), 1 (LN2), 0 (LN1).
// The LayerNorm statistics (2 n_pad floats: each row's mean and rstd) take
// dynamic shared memory, so that they follow n_pad.
template <typename T>
__global__ void __launch_bounds__(vf::kThreads)
mct_stage(MctArgs a, int stage) {
  __shared__ float red[vf::kWarps];
  extern __shared__ __align__(128) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem);
  const int n = a.n_pad, n_real = a.n_real, d = a.d, dh = a.dh;
  const size_t R = (size_t)a.batch * n, row0 = (size_t)blockIdx.x * n;
  const macb::NpOff no = macb::np_offsets(d, dh);
  float* np = a.npart + (size_t)blockIdx.x * no.total;
  float* rsp = a.rsp + (size_t)blockIdx.x * 3;
  float* xb = a.xb + row0 * d;
  const float* zb = a.zb + row0 * d;
  const float rs = a.rs[0], hrs = 0.5f * rs;
  T* ob1 = static_cast<T*>(a.ob) + row0 * d;
  T* ob3 = static_cast<T*>(a.ob) + (R + row0) * d;
  const T* hb1 = static_cast<const T*>(a.h1b) + row0 * dh;
  const T* hb3 = static_cast<const T*>(a.h1b) + (R + row0) * dh;
  float acc = 0.0f;
  switch (stage) {
    case 3: {  // x3_bar = g scaler (0 on padded rows), the FFN3 output's
      const T* g = static_cast<const T*>(a.g) + row0 * d;
      const float* f3 = a.f3 + row0 * d;
      for (int i = threadIdx.x; i < n * d; i += vf::kThreads) {
        const float v = i / d < n_real ? vf::to_f(g[i]) * a.scaler : 0.0f;
        xb[i] = v;
        ob3[i] = vf::from_f<T>(hrs * v);
        acc += v * f3[i];
      }
      const float r3 = macb::block_sum(acc, red);  // syncs: xb is written
      colsum(xb, d, d, n_real, hrs, np + no.b2, false);
      if (threadIdx.x == 0) rsp[0] = r3;
      break;
    }
    case 2: {  // x2_bar = x3_bar + LN3's backward; the attention's output
      macb::ln_bwd(a.x2 + row0 * d, zb, a.ln3s, xb, n, n_real, d, 1 << 30,
                   stats, np + no.ln + 4 * d, np + no.ln + 5 * d);
      colsum(hb3, dh, dh, n_real, 1.0f, np + no.b1, false);
      const float* ao = a.ao + row0 * d;
      T* aod = static_cast<T*>(a.aod) + row0 * d;
      for (int i = threadIdx.x; i < n * d; i += vf::kThreads) {
        acc += xb[i] * ao[i];
        aod[i] = vf::from_f<T>(rs * xb[i]);
      }
      colsum(xb, d, d, n_real, rs, np + no.outb, false);
      const float r2 = macb::block_sum(acc, red);
      if (threadIdx.x == 0) rsp[1] = r2;
      break;
    }
    case 1: {  // x1_bar = x2_bar + LN2's backward; the FFN1 output's
      macb::ln_bwd(a.x1 + row0 * d, zb, a.ln2s, xb, n, n_real, d, 1 << 30,
                   stats, np + no.ln + 2 * d, np + no.ln + 3 * d);
      colsum(static_cast<const T*>(a.qkvb) + row0 * 3 * d, 3 * d, 3 * d,
             n_real, 1.0f, np + no.qkvb, false);
      const float* f1 = a.f1 + row0 * d;
      for (int i = threadIdx.x; i < n * d; i += vf::kThreads) {
        acc += xb[i] * f1[i];
        ob1[i] = vf::from_f<T>(hrs * xb[i]);
      }
      colsum(xb, d, d, n_real, hrs, np + no.b2, true);
      const float r1 = macb::block_sum(acc, red);
      if (threadIdx.x == 0) rsp[2] = r1;
      break;
    }
    default: {  // x_bar = x1_bar + LN1's backward, rounded; rs_bar
      const T* x = static_cast<const T*>(a.x) + row0 * d;
      macb::ln_bwd(x, zb, a.ln1s, xb, n, n_real, d, n_real, stats,
                   np + no.ln, np + no.ln + d);
      colsum(hb1, dh, dh, n_real, 1.0f, np + no.b1, true);
      T* xbar = static_cast<T*>(a.out) + row0 * d;
      for (int i = threadIdx.x; i < n * d; i += vf::kThreads)
        xbar[i] = vf::from_f<T>(i / d < n_real ? xb[i] : 0.0f);
      if (threadIdx.x == 0)
        np[no.rs] = 0.5f * rsp[0] + rsp[1] + 0.5f * rsp[2];
      break;
    }
  }
}

template <typename S, typename T>
int ln(const MctArgs& a, const S* src, bool zero_pad, const float* s,
       const float* b, void* z, float* copy, cudaStream_t st) {
  const dim3 grid(a.batch, (a.n_pad + vf::kWarps - 1) / vf::kWarps);
  mct_ln<S, T><<<grid, vf::kThreads, 0, st>>>(
      src, a.n_pad, a.n_real, zero_pad, a.d, s, b, static_cast<T*>(z), copy);
  return (int)cudaGetLastError();
}

// h = round(gelu(z W1 + b1)) over the R rows; with h1, the f32 pre-GELU
// value too.
template <typename T>
int hidden(const MctArgs& a, const void* z, void* h, float* h1,
           cudaStream_t st) {
  GemmArgs g = vft::gemm_args(z, a.d, a.w1, a.dh, a.d, a.batch * a.n_pad,
                              a.dh, vft::kGelu, h, a.dh);
  g.bias = a.b1;
  g.out32 = h1;
  return vft::gemm<T, false>(g, st);
}

// f = A B + bias (K = k; fout, if given), and state_out = state_in + alpha
// rs f (if state_out is given; in place where the two are one buffer).
template <typename T>
int resid(const MctArgs& a, const void* A, const void* B, int k,
          const float* bias, float alpha, const float* state_in,
          float* state_out, float* fout, cudaStream_t st) {
  GemmArgs g = vft::gemm_args(A, k, B, a.d, k, a.batch * a.n_pad, a.d,
                              vft::kMacResid, nullptr, a.d);
  g.bias = bias;
  g.aux = state_in;
  g.out32 = state_out;
  g.fout = fout;
  g.rs = a.rs;
  g.alpha = alpha;
  return vft::gemm<T, false>(g, st);
}

// C = A B^T with B stored [N, K] (the weights as they are stored), epilogue
// kGeluGrad (aux: the pre-GELU value), kRound or kF32 (into out32).
template <typename T>
int bt(const MctArgs& a, const void* A, int k, const void* B, int n,
       int epi, void* out, float* out32, const float* aux, cudaStream_t st) {
  GemmArgs g = vft::gemm_args(A, k, B, k, k, a.batch * a.n_pad, n, epi, out,
                              n);
  g.out32 = out32;
  g.aux = aux;
  return vft::gemm<T, true>(g, st);
}

TiledArgs attn_targs(const MctArgs& a) {
  TiledArgs t = {};
  t.qkv = a.qkv;
  t.ctx = a.ctx;
  t.cb = a.cb;
  t.pg = a.pg;
  t.sbar = a.sbar;
  t.qkvb = a.qkvb;
  t.batch = a.batch;
  t.n_pad = a.n_pad;
  t.n_real = a.n_real;
  t.d = a.d;
  t.heads = a.heads;
  t.dh = a.dh;
  t.mode = vft::kPlain;
  t.mt = a.mt;
  t.qk_scale = a.qk_scale;
  return t;
}

template <typename T>
int qkv(const MctArgs& a, const void* z, cudaStream_t st) {
  const int d = a.d;
  GemmArgs g = vft::gemm_args(z, d, a.wqkv, 3 * d, d, a.batch * a.n_pad,
                              3 * d, vft::kRound, a.qkv, 3 * d);
  g.bias = a.qkv_bias;
  return vft::gemm<T, false>(g, st);
}

template <typename T>
int forward(const MctArgs& a, cudaStream_t st) {
  if (a.mode < 0 || a.mode > 2 || (a.mode == 2) != (a.base != nullptr))
    return (int)cudaErrorInvalidValue;
  const int d = a.d, dh = a.dh;
  const T* x = static_cast<const T*>(a.x);
  float* xs = a.x1;
  VFT_CHECK((ln<T, T>(a, x, false, a.ln1s, a.ln1b, a.z, xs, st)));
  VFT_CHECK(hidden<T>(a, a.z, a.h, nullptr, st));
  VFT_CHECK(resid<T>(a, a.h, a.w2, dh, a.b2, 0.5f, xs, xs, nullptr, st));
  VFT_CHECK((ln<float, T>(a, xs, false, a.ln2s, a.ln2b, a.z, nullptr, st)));
  VFT_CHECK(qkv<T>(a, a.z, st));
  VFT_CHECK((vft::attn<T, false, false>(attn_targs(a), st)));
  VFT_CHECK(resid<T>(a, a.ctx, a.wout, d, a.out_bias, 1.0f, xs, xs, nullptr,
                     st));
  VFT_CHECK((ln<float, T>(a, xs, false, a.ln3s, a.ln3b, a.z, nullptr, st)));
  VFT_CHECK(hidden<T>(a, a.z, a.h, nullptr, st));
  GemmArgs g = vft::gemm_args(a.h, dh, a.w2, d, dh, a.batch * a.n_pad, d,
                              vft::kMacOut, a.out, d);
  g.bias = a.b2;
  g.aux = xs;
  g.rs = a.rs;
  g.alpha = 0.5f;
  g.scale = a.scaler;
  g.res = a.mode == 0 ? nullptr : a.mode == 1 ? a.x : a.base;
  g.dt = a.dt;
  return vft::gemm<T, false>(g, st);
}

template <typename T>
int stage(const MctArgs& a, int s, cudaStream_t st) {
  const size_t smem = (size_t)2 * a.n_pad * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      mct_stage<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mct_stage<T><<<a.batch, vf::kThreads, smem, st>>>(a, s);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const MctArgs& a, cudaStream_t st) {
  const int d = a.d, dh = a.dh;
  const size_t R = (size_t)a.batch * a.n_pad;
  T* z1 = static_cast<T*>(a.z);
  T* z3 = z1 + R * d;
  T* h_1 = static_cast<T*>(a.h);
  T* h_3 = h_1 + R * dh;
  float* h1_1 = a.h1;
  float* h1_3 = a.h1 + R * dh;
  T* hb1 = static_cast<T*>(a.h1b);
  T* hb3 = hb1 + R * dh;
  T* ob1 = static_cast<T*>(a.ob);
  T* ob3 = ob1 + R * d;
  const T* x = static_cast<const T*>(a.x);

  // the forward chain from x with its padded rows read as zeros
  VFT_CHECK((ln<T, T>(a, x, true, a.ln1s, a.ln1b, z1, a.x1, st)));
  VFT_CHECK(hidden<T>(a, z1, h_1, h1_1, st));
  VFT_CHECK(resid<T>(a, h_1, a.w2, dh, a.b2, 0.5f, a.x1, a.x1, a.f1, st));
  VFT_CHECK((ln<float, T>(a, a.x1, false, a.ln2s, a.ln2b, a.z2, nullptr,
                          st)));
  VFT_CHECK(qkv<T>(a, a.z2, st));
  VFT_CHECK((vft::attn<T, false, false>(attn_targs(a), st)));
  VFT_CHECK(resid<T>(a, a.ctx, a.wout, d, a.out_bias, 1.0f, a.x1, a.x2, a.ao,
                     st));
  VFT_CHECK((ln<float, T>(a, a.x2, false, a.ln3s, a.ln3b, z3, nullptr, st)));
  VFT_CHECK(hidden<T>(a, z3, h_3, h1_3, st));
  VFT_CHECK(resid<T>(a, h_3, a.w2, dh, a.b2, 0.5f, nullptr, nullptr, a.f3,
                     st));

  // the backward chain
  VFT_CHECK(stage<T>(a, 3, st));
  VFT_CHECK(bt<T>(a, ob3, d, a.w2, dh, vft::kGeluGrad, hb3, nullptr, h1_3,
                  st));
  VFT_CHECK(bt<T>(a, hb3, dh, a.w1, d, vft::kF32, nullptr, a.zb, nullptr,
                  st));
  VFT_CHECK(stage<T>(a, 2, st));
  VFT_CHECK(bt<T>(a, a.aod, d, a.wout, d, vft::kRound, a.cb, nullptr,
                  nullptr, st));
  VFT_CHECK((vft::attn<T, true, false>(attn_targs(a), st)));
  VFT_CHECK((vft::attn_keys<T, false>(attn_targs(a), st)));
  VFT_CHECK(bt<T>(a, a.qkvb, 3 * d, a.wqkv, d, vft::kF32, nullptr, a.zb,
                  nullptr, st));
  VFT_CHECK(stage<T>(a, 1, st));
  VFT_CHECK(bt<T>(a, ob1, d, a.w2, dh, vft::kGeluGrad, hb1, nullptr, h1_1,
                  st));
  VFT_CHECK(bt<T>(a, hb1, dh, a.w1, d, vft::kF32, nullptr, a.zb, nullptr,
                  st));
  VFT_CHECK(stage<T>(a, 0, st));

  // the weight cotangents: the attention's products over R rows, then the
  // shared FFN's over both halves' 2R rows, into one partial layout; then
  // the fixed-order reduce of the weight and per-image partials
  const size_t wtotal = (size_t)4 * d * d + (size_t)2 * d * dh;
  for (int pass = 0; pass < 2; ++pass) {
    Problems ps = {};
    if (pass == 0) {
      ps.p[0] = {a.z2, a.qkvb, d, 3 * d, 0};
      ps.p[1] = {a.ctx, a.aod, d, d, (size_t)3 * d * d};
    } else {
      ps.p[0] = {a.z, a.h1b, d, dh, (size_t)4 * d * d};
      ps.p[1] = {a.h, a.ob, dh, d, (size_t)4 * d * d + (size_t)d * dh};
    }
    ps.total = wtotal;
    ps.rows = (int)(pass == 0 ? R : 2 * R);
    VFT_CHECK(sizeof(T) == 2 ? wgrad_bf16(ps, a.wpart, a.splits, st)
                             : macb::wgrad_f32(ps, a.wpart, a.splits, st));
  }
  const int nlen = macb::np_offsets(d, dh).total;
  const size_t all = wtotal + (size_t)nlen;
  vfb_reduce<<<(unsigned)((all + 255) / 256), 256, 0, st>>>(
      a.wpart, a.splits, wtotal, a.npart, a.batch, nlen, a.wbars);
  return (int)cudaGetLastError();
}

}  // namespace mct

extern "C" {

// The tiled plan of a Macaron shape: vft::plan's for the deterministic
// softmax instances, whose attention kernels the route runs (query-tile
// rows; shared memory of the forward, backward and key-tile attention
// CTAs; past 256 padded tokens those of the key-tiled instances). Returns
// 0 with the plan, 1 when the shape has none: sizes that are not
// multiples of 16 (the wrapper raises).
// kernels/macaron_tiled.py::tiled_macaron_plan repeats this rule in
// Python.
int mct_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int* mt_out, int* smem_fwd_out, int* smem_bwd_out,
             int* smem_keys_out) {
  return vft::plan(tbytes, n_pad, n_real, d, heads, dh, false, false,
                   mt_out, smem_fwd_out, smem_bwd_out, smem_keys_out);
}

// One evaluation (mode 0 plain, 1 Euler: x + dt f(x), 2 stage advance:
// base + dt f(x)) on `stream`; returns the first cudaGetLastError() that
// is not 0, else 0.
int mct_forward(int tbytes, const MctArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? mct::forward<vf::bf16>(*args, st)
                     : mct::forward<float>(*args, st);
}

// One backward (the 16 cotangents) on `stream`; returns as mct_forward.
int mct_backward(int tbytes, const MctArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? mct::backward<vf::bf16>(*args, st)
                     : mct::backward<float>(*args, st);
}

const char* mct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
