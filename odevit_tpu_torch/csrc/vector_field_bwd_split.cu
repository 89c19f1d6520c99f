// The split backward of one evaluation of the ODE-ViT vector field, on
// Hopper (sm_90a): an MLP-branch half and an attention-branch half,
// chained through x_bar.
//
// Replaces the TPU kernels odevit_tpu/kernels/vector_field_bwd.py::
// _mlp_bwd_kernel and _attn_bwd_kernel, which JAX's _pallas_vf_bwd_split
// chains where its combined backward is pinned to one image: TS-Base at
// MLP ratio 4 (197 tokens padded to 208, D=768, 12 heads, dh=3072). The
// arithmetic is the one of vector_field_tiled.cu (rounding to the compute
// dtype where the TPU kernel rounds, f32 accumulation, padded rows read as
// zeros); each half computes only its own branch.
//
// vfs_mlp, the MLP half (_mlp_bwd_kernel): x_bar_m (f32), W1_bar, W2_bar
// and the MLP norm's cotangents. The TPU kernel walks the hidden width in
// chunks so that the [rows, dh] f32 hidden never lives whole; so does this
// one. Six launches:
//   vft_norm          cn_m, the row means, gd = round(g scaler) (with
//                     dropout round(g scaler mask_mo));
//   vfs_hidden        one CTA per (128-row tile, 128-column chunk of dh):
//                     h1_c = cn_m W1[:, c] into f32 shared memory, then
//                     h_bar_c = gd W2[c, :]^T in registers, and in the
//                     epilogue h = round(gelu(h1)) and h1_bar =
//                     round(h_bar gelu'(h1)) (with mask_h: h = round(round(
//                     gelu(h1)) mask_h), h1_bar = round(h_bar mask_h
//                     gelu'(h1))). Only the two bf16 chunks reach device
//                     memory; the f32 h1 of the tiled route's backward
//                     (164 MB at B=64) does not exist here;
//   vft_gemm          m_bar = h1_bar W1^T (f32, K = dh);
//   vfs_norm_bwd      x_bar_m = d/(d-1) (c - mean(c)), c = m_bar gamma_m,
//                     and the per-image partials of the MLP norm's
//                     cotangents;
//   vfb_wgrad, vfb_reduce  W1_bar = cn_m^T h1_bar, W2_bar = h^T gd as
//                     split-K products with per-split partials, then a
//                     fixed-order reduce (two runs are bit-identical).
// vfs_attn, the attention half (_attn_bwd_kernel): x_bar = x_bar_m plus the
// attention branch's term, rounded once, Wqkv_bar, Wout_bar and the
// attention norm's cotangents, with the JaSMin scatter and the maps'
// cotangent. Its body is the attention half of the tiled route's backward,
// whose kernels it launches (vft_norm, vft_gemm, vft_attn<bwd>,
// vft_attn_keys, vfb_wgrad, vfb_reduce); what is new is the launch
// sequence, with no MLP product in it, and vfs_norm_bwd adding the prior
// x_bar_m. Nine launches: vft_norm, vft_gemm (qkv, then cb), vft_attn<bwd>,
// vft_attn_keys, vft_gemm (a_bar), vfs_norm_bwd, vfb_wgrad, vfb_reduce.
//
// Residuals (the TPU kernels' has_resid: _mlp_bwd_kernel's rh1, :399-403,
// and _attn_bwd_kernel's rqkv, :477-478; softmax, no dropout). With
// TiledArgs::rh1 the MLP half has no h1 product: vfs_hidden<kResid> loads
// the CTA's 128x128 tile of rh1 into the f32 h1 tile (16-byte loads,
// padded rows as zeros) where the other instances compute it, then runs
// the h_bar product and the same epilogue. With TiledArgs::rqkv the
// attention half skips its qkv product
// and its attention kernels read rqkv (padded rows of q and k as zeros);
// cn_a is still computed, for Wqkv_bar. Each half skips 2 R D dh
// (MLP) or 6 R D^2 (attention) operations for a read of its residual.
//
// Dropout, where a half's rates are nonzero (template flag kDrop, runtime
// TiledArgs::drop): the stream of vector_field.cu (sites H and MLP_OUT in
// the MLP half, ATTN_OUT and P + head in the attention half), so the bits
// are those of every other route.
//
// Bound. At B=64, 197 real tokens, dh=3072: the MLP half does ~10 R D dh =
// 298 GFLOP (0.30 ms at 989 TFLOP/s in bf16), the attention half ~22 R D^2
// + 12 n^2 D B = 187 GFLOP (0.19 ms); operations, not bytes, bound both.
// This first design is simple: WMMA fragments (16x16x16) staged through
// shared memory, no wgmma, no TMA. In f32 the products launched through
// vft::gemm run vft_gemm_tf32 (split TF32 on wgmma), while vfs_hidden's
// own products stay on the CUDA cores. Nothing goes to a library.

#define VFT_KERNELS_ONLY
#include "vector_field_tiled.cu"

namespace vfs {

using namespace nvcuda;
using vf::bf16;
using vft::Acc;
using vft::GemmArgs;
using vft::kBK;
using vft::kBM;
using vft::kBN;
using vft::kGThreads;
using vft::kLdA;
using vft::kLdE;

constexpr int kLdH = kBN + 4;  // f32 rows of the staged h1 tile

// Shared memory of one vfs_hidden_bf16 CTA: the product's two staging
// buffers, the f32 h1 tile, one 16x16 epilogue tile per warp (96 KB: two
// CTAs per SM).
constexpr size_t kHiddenSmem =
    (size_t)2 * kBM * kLdA * sizeof(bf16) + (size_t)kBM * kLdH * 4 +
    (size_t)(kGThreads / 32) * 16 * kLdE * 4;

// h = round(gelu(h1)), h1_bar = round(hb gelu'(h1)); with dropout (m: the
// kept value of mask_h) h = round(round(gelu(h1)) m), h1_bar = round(hb m
// gelu'(h1)), as vft_gemm's kGelu / kGeluGrad epilogues and their dropout
// instances write them.
template <typename T, bool kDrop>
__device__ __forceinline__ void hidden_out(T* h, T* h1b, size_t o, float h1,
                                           float hb, float m) {
  if (kDrop) {
    h[o] = vf::from_f<T>(vf::to_f(vf::from_f<T>(vf::gelu(h1))) * m);
    h1b[o] = vf::from_f<T>(hb * m * vf::gelu_grad(h1));
  } else {
    h[o] = vf::from_f<T>(vf::gelu(h1));
    h1b[o] = vf::from_f<T>(hb * vf::gelu_grad(h1));
  }
}

// a: h1 = cn_m W1 (B row-major), its output h and, with dropout, mask_h in
// its mask fields; b: h_bar = gd W2^T (W2 read as stored, [dh, D]), its
// output h1_bar. Both [R, dh], K = D. One CTA per 128x128 output tile.
// kResid: h1 is read from a.res (the stash's rh1, [R, dh] bf16, row
// stride a.ldo), rows m % n_pad >= n_real as zeros; no h1 product.
__device__ __forceinline__ bool resid_row(const GemmArgs& a, int m) {
  return m < a.m && m % a.n_pad < a.n_real;
}

template <bool kDrop, bool kResid = false>
__global__ void __launch_bounds__(kGThreads)
vfs_hidden_bf16(GemmArgs a, GemmArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * kLdA;
  float* h1s = reinterpret_cast<float*>(Bs + kBM * kLdA);
  float* ep = h1s + kBM * kLdH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  Acc c[4][2];
  if (kResid) {
    // the tile of rh1, 8 columns a load; the h_bar product's barriers
    // order these stores before the epilogue reads them
    const bf16* rh1 = static_cast<const bf16*>(a.res);
    for (int v = threadIdx.x; v < kBM * (kBN / 8); v += kGThreads) {
      const int rr = v / (kBN / 8), c8 = (v % (kBN / 8)) * 8;
      const int m = m0 + rr, n = n0 + c8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (resid_row(a, m) && n < a.n)
        raw = *reinterpret_cast<const uint4*>(rh1 + (size_t)m * a.ldo + n);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        h1s[rr * kLdH + c8 + q] = __bfloat162float(e[q]);
    }
  } else {
    vft::gemm_mainloop<false>(a, m0, n0, As, Bs, c);
    // each warp stages its own 64x32 of h1 and reads back only that
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(h1s + (wm * 64 + i * 16) * kLdH + wn * 32 +
                                    j * 16,
                                c[i][j], kLdH, wmma::mem_row_major);
  }
  vft::gemm_mainloop<true>(b, m0, n0, As, Bs, c);

  float* sc = ep + warp * 16 * kLdE;
  bf16* h = static_cast<bf16*>(a.out);
  bf16* h1b = static_cast<bf16*>(b.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int lr = wm * 64 + i * 16, lc = wn * 32 + j * 16;
      const int mb = m0 + lr, nb = n0 + lc;
      if (mb >= a.m || nb >= a.n) continue;  // the same for the whole warp
      wmma::store_matrix_sync(sc, c[i][j], kLdE, wmma::mem_row_major);
      __syncwarp();
      if (kDrop) {
        // a lane takes 4 consecutive columns of a row: one Philox call
        for (int e = lane; e < 64; e += 32) {
          const int rr = e >> 2, c4 = (e & 3) * 4, m = mb + rr;
          if (m >= a.m) continue;
          float keep[4];
          vft::gemm_keep4(a, 0, m, (nb + c4) >> 2, keep);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hidden_out<bf16, true>(
                h, h1b, (size_t)m * a.ldo + nb + c4 + q,
                h1s[(lr + rr) * kLdH + lc + c4 + q], sc[rr * kLdE + c4 + q],
                keep[q]);
        }
      } else {
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, cc = e & 15, m = mb + rr;
          if (m < a.m)
            hidden_out<bf16, false>(h, h1b, (size_t)m * a.ldo + nb + cc,
                                    h1s[(lr + rr) * kLdH + lc + cc],
                                    sc[rr * kLdE + cc], 1.0f);
        }
      }
      __syncwarp();
    }
}

// The f32 instance on the CUDA cores: a 64x64 tile of both products per
// CTA, 4x4 outputs of each a thread, K in steps of 16 through shared
// memory; its dropout draws one Philox call per element (it exists for
// checks). kResid: h1 read from a.res per element, no h1 product.
template <bool kDrop, bool kResid = false>
__global__ void __launch_bounds__(kGThreads)
vfs_hidden_f32(GemmArgs a, GemmArgs b) {
  __shared__ float Cs[16][65], W1s[16][65], Gs[16][65], W2s[16][65];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const float* cn = static_cast<const float*>(a.a[0]);
  const float* w1 = static_cast<const float*>(a.b[0]);
  const float* gd = static_cast<const float*>(b.a[0]);
  const float* w2 = static_cast<const float*>(b.b[0]);
  const int K = a.k[0];
  float h1[4][4] = {}, hb[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kGThreads;
      const int mm = e / 16, kk = e % 16;
      const bool in = k0 + kk < K;
      Cs[kk][mm] = m0 + mm < a.m && in
                       ? cn[(size_t)(m0 + mm) * a.lda[0] + k0 + kk] : 0.0f;
      Gs[kk][mm] = m0 + mm < a.m && in
                       ? gd[(size_t)(m0 + mm) * b.lda[0] + k0 + kk] : 0.0f;
      // W2 is [dh, D]: element (k, n) of W2^T is w2[n * ldb + k]
      W2s[kk][mm] = n0 + mm < a.n && in
                        ? w2[(size_t)(n0 + mm) * b.ldb[0] + k0 + kk] : 0.0f;
      const int kr = e / 64, nn = e % 64;
      W1s[kr][nn] = k0 + kr < K && n0 + nn < a.n
                        ? w1[(size_t)(k0 + kr) * a.ldb[0] + n0 + nn] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < 16; ++kk)
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          if (!kResid)
            h1[i][j] = fmaf(Cs[kk][ty + 16 * i], W1s[kk][tx + 16 * j],
                            h1[i][j]);
          hb[i][j] = fmaf(Gs[kk][ty + 16 * i], W2s[kk][tx + 16 * j], hb[i][j]);
        }
    __syncthreads();
  }
  float* h = static_cast<float*>(a.out);
  float* h1b = static_cast<float*>(b.out);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= a.m || n >= a.n) continue;
      float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (kDrop) vft::gemm_keep4(a, 0, m, n >> 2, keep);
      const size_t o = (size_t)m * a.ldo + n;
      const float h1v = !kResid          ? h1[i][j]
                        : resid_row(a, m) ? static_cast<const float*>(a.res)[o]
                                          : 0.0f;
      hidden_out<float, kDrop>(h, h1b, o, h1v, hb[i][j], keep[n & 3]);
    }
}

// CenterNorm's backward of one branch: x_bar = prior + d/(d-1) (c -
// mean(c)), c = bar gamma, zeros on padded rows (O: f32 for the MLP half's
// x_bar_m, x's dtype for the attention half's x_bar; prior: the MLP half's
// x_bar_m, or null); then this image's partial sums of (bar cent, bar)
// over its real rows. One CTA per image.
template <typename T, typename O>
__global__ void __launch_bounds__(vf::kThreads)
vfs_norm_bwd(const float* __restrict__ bar, const T* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ gamma,
             const float* __restrict__ prior, O* xbar, float* npart,
             int n_pad, int n_real, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)blockIdx.x * n_pad;
  const float scale = (float)((double)d / (d - 1.0));
  for (int r = warp; r < n_pad; r += vf::kWarps) {
    const size_t o = (row0 + r) * d;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += bar[o + c] * gamma[c];
    const float cm = vf::warp_sum(sum) / d;
    for (int c = lane; c < d; c += 32) {
      float v = 0.0f;
      if (r < n_real) {
        v = scale * (bar[o + c] * gamma[c] - cm);
        if (prior != nullptr) v += prior[o + c];
      }
      xbar[o + c] = vf::from_f<O>(v);
    }
  }
  float* np = npart + (size_t)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < d; c += vf::kThreads) {
    float s1 = 0.0f, s0 = 0.0f;
    for (int r = 0; r < n_real; ++r) {
      const size_t i = (row0 + r) * d + c;
      s1 += bar[i] * (vf::to_f(x[i]) - mean[row0 + r]) * scale;
      s0 += bar[i];
    }
    np[c] = s1;
    np[d + c] = s0;
  }
}

#define VFS_CHECK(call)           \
  do {                            \
    const int e_ = (call);        \
    if (e_ != 0) return e_;       \
  } while (0)

template <typename T, bool kDrop, bool kResid = false>
int hidden(GemmArgs a, GemmArgs b, cudaStream_t st) {
  if (sizeof(T) == 2) {
    auto kernel = vfs_hidden_bf16<kDrop, kResid>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kHiddenSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
    kernel<<<grid, kGThreads, kHiddenSmem, st>>>(a, b);
  } else {
    const dim3 grid((a.n + 63) / 64, (a.m + 63) / 64);
    vfs_hidden_f32<kDrop, kResid><<<grid, kGThreads, 0, st>>>(a, b);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int norm_bwd(const TiledArgs& t, const float* bar, const float* gamma,
             const float* prior, cudaStream_t st) {
  vfs_norm_bwd<T, O><<<t.batch, vf::kThreads, 0, st>>>(
      bar, static_cast<const T*>(t.x), t.mean, gamma, prior,
      static_cast<O*>(t.out), t.npart, t.n_pad, t.n_real, t.d);
  return (int)cudaGetLastError();
}

// The MLP half. TiledArgs: x, g, the weights; scratch cna, cnm, mean, gd
// (gd2 with dropout, which vft_norm also writes), h, h1b, mbar (m_bar,
// f32), npart [B, 2, D], wpart [splits, 2 D dh]; out: x_bar_m [R, D] f32;
// wbars: W1_bar, W2_bar, gm_bar, bm_bar.
template <typename T>
int mlp(const TiledArgs& t, cudaStream_t st) {
  const int R = t.batch * t.n_pad, d = t.d, dh = t.dh;
  const bool drop = t.drop.th_m != 0;
  if (drop && t.rh1 != nullptr) return (int)cudaErrorInvalidValue;
  VFS_CHECK((drop ? vft::norm<T, true>(t, true, st)
                  : vft::norm<T, false>(t, true, st)));
  GemmArgs a = vft::gemm_args(t.cnm, d, t.w1, dh, d, R, dh, vft::kGelu, t.h,
                              dh);
  GemmArgs b = vft::gemm_args(t.gd, d, t.w2, d, d, R, dh, vft::kGeluGrad,
                              t.h1b, dh);
  if (t.rh1 != nullptr) {
    // h1 from the stash's rh1 in place of the cn_m W1 product
    a.res = t.rh1;
    a.n_pad = t.n_pad;
    a.n_real = t.n_real;
    VFS_CHECK((hidden<T, false, true>(a, b, st)));
  } else {
    if (drop) vft::gemm_mask(a, 0, t, vf::kSiteH);
    VFS_CHECK((drop ? hidden<T, true>(a, b, st)
                    : hidden<T, false>(a, b, st)));
  }
  // m_bar = h1_bar W1^T (f32)
  GemmArgs mb = vft::gemm_args(t.h1b, dh, t.w1, dh, dh, R, d, vft::kF32,
                               nullptr, d);
  mb.out32 = t.mbar;
  VFS_CHECK((vft::gemm<T, true>(mb, st)));
  VFS_CHECK((norm_bwd<T, float>(t, t.mbar, t.gm, nullptr, st)));
  Problems ps = {};
  ps.p[0] = {t.cnm, t.h1b, d, dh, 0};
  ps.p[1] = {t.h, t.gd, dh, d, (size_t)d * dh};
  return vft::weight_bars<T>(ps, 2, t, 2 * d, st);
}

// The attention half. TiledArgs: x, g, g_jas / jas_idx or g_attn (or
// none), the weights, mbar: the MLP half's x_bar_m (f32, input); scratch
// cna, cnm, qkv, ctx, mean, gd (gd2 with dropout), cb, pg, sbar, qkvb,
// abar (f32), npart [B, 2, D], wpart [splits, 4 D^2]; out: x_bar in x's
// dtype; wbars: Wqkv_bar, Wout_bar, ga_bar, ba_bar.
template <typename T>
int attn(const TiledArgs& t, cudaStream_t st) {
  const int R = t.batch * t.n_pad, d = t.d;
  const bool drop = (t.drop.th_p | t.drop.th_ao) != 0;
  if (drop && t.rqkv != nullptr) return (int)cudaErrorInvalidValue;
  // with dropout, gd2 = round(g scaler mask_ao) is the branch's operand
  const void* gda = drop ? t.gd2 : t.gd;
  VFS_CHECK((drop ? vft::norm<T, true>(t, true, st)
                  : vft::norm<T, false>(t, true, st)));
  // with rqkv, the attention kernels read it instead (vft::attn_args)
  if (t.rqkv == nullptr)
    VFS_CHECK((vft::gemm<T, false>(
        vft::gemm_args(t.cna, d, t.wqkv, 3 * d, d, R, 3 * d, vft::kRound,
                       t.qkv, 3 * d),
        st)));
  VFS_CHECK((vft::gemm<T, true>(
      vft::gemm_args(gda, d, t.wout, d, d, R, d, vft::kRound, t.cb, d), st)));
  VFS_CHECK((drop ? vft::attn<T, true, true>(t, st)
                  : vft::attn<T, true, false>(t, st)));
  VFS_CHECK((vft::attn_keys<T, false>(t, st)));
  // a_bar = qkv_bar Wqkv^T (f32)
  GemmArgs ab = vft::gemm_args(t.qkvb, 3 * d, t.wqkv, 3 * d, 3 * d, R, d,
                               vft::kF32, nullptr, d);
  ab.out32 = t.abar;
  VFS_CHECK((vft::gemm<T, true>(ab, st)));
  VFS_CHECK((norm_bwd<T, T>(t, t.abar, t.ga, t.mbar, st)));
  Problems ps = {};
  ps.p[0] = {t.cna, t.qkvb, d, 3 * d, 0};
  ps.p[1] = {t.ctx, gda, d, d, (size_t)3 * d * d};
  return vft::weight_bars<T>(ps, 2, t, 2 * d, st);
}

}  // namespace vfs

extern "C" {

// The MLP half on `stream`; returns the first cudaGetLastError() that is
// not 0, else 0. A nonzero th_m in args->drop runs the dropout instances;
// a non-null args->rh1 reads the stashed pre-GELU hidden (no dropout).
int vfs_mlp(int tbytes, const TiledArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? vfs::mlp<vf::bf16>(*args, st)
                     : vfs::mlp<float>(*args, st);
}

// The attention half on `stream` (args->mt from vft_plan, planned with
// drop=1 when th_p or th_ao is nonzero); returns as vfs_mlp. A non-null
// args->rqkv reads the stashed qkv (no dropout).
int vfs_attn(int tbytes, const TiledArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? vfs::attn<vf::bf16>(*args, st)
                     : vfs::attn<float>(*args, st);
}

const char* vfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
