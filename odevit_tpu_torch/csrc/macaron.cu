// One evaluation of the Macaron vector field, fused into one CUDA kernel.
//
// Replaces the TPU kernel odevit_tpu/kernels/macaron.py::_macaron_kernel
// (its plain, Euler and stage-advance modes) on Hopper (sm_90a).
//
//   x1 = x  + rs/2 * FFN(LN1 x)        FFN(z) = gelu(z W1 + b1) W2 + b2
//   x2 = x1 + rs   * Attn(LN2 x1)      biased q|k|v and output projections
//   x3 = x2 + rs/2 * FFN(LN3 x2)       the same FFN weights as the first half
//   f  = x3 * scaler
//   plain : out = f
//   euler : out = x + coef * f          (f not rounded first)
//   base  : out = base + coef * f       (Kutta 3/8 stage advance)
//
// x, base, out: [B * n_pad, D] row-major (bf16 or f32); the six LayerNorm
// vectors, qkv_bias [3D], out_bias [D], b1 [dh], b2 [D] and rs [1] in f32;
// weights in [in, out] layout and x's dtype: Wqkv [D, 3D], Wout [D, D],
// W1 [D, dh], W2 [dh, D]. rs is read on the device, so no launch waits
// for the host.
//
// Numerics follow the TPU kernel: the state x -> x1 -> x2 -> x3 stays in
// f32 through the whole evaluation; LayerNorm (eps 1e-6, flax's default)
// in f32 with its outputs rounded to x's dtype; qkv rounded after its bias;
// p, ctx and gelu(h) rounded; every product accumulated in f32; the FFN
// output and attn_o stay f32 until they reach the state; f rounded once.
// Padded keys (index >= n_real) are masked by selection and the padded
// rows of v are zeroed, so garbage or NaN in padded rows of x never
// reaches a real row. Padded rows evolve on their own (LayerNorm is per
// row).
//
// Bound. At the Macaron CIFAR shape (B=1024, 65 real tokens padded to 80,
// D=192, 3 heads, dh=768) one evaluation needs 99.1 MFLOP per image (two
// FFN halves and the attention), 101.5 GFLOP in all: 0.103 ms at the
// H100's 989 TFLOP/s in bf16. Its state traffic (x in, out; 63 MB in f32)
// takes 0.019 ms at 3.35 TB/s. Operations bound it. JAX's bf16 Macaron
// model integrates in f32 (its patch projection adds an f32 bias), so its
// main path runs the f32 instance. Its products take three TF32 passes
// each (split TF32, split_tf32.cuh): 304 GFLOP of TF32 work, 0.615 ms at
// 495 TFLOP/s; on the CUDA cores' 67 TFLOP/s f32 peak the evaluation
// would take 1.5 ms.
//
// Design. One CTA of 12 warps per image, as vf_kernel (vector_field.cu):
// only x (and base) come in and only the new state goes out. The FFN runs
// over dh in chunks of hc, so the [n_pad, dh] hidden never exists whole;
// each chunk's product h_c W2[c, :] is added to the state scaled by rs/2
// (b2 once, after the last chunk), and each head's ctx_h Wout[h] scaled by
// rs (out_bias once, after the last head). That sums each FFN output and
// attn_o in another order than the TPU kernel (which adds the whole
// product to the state); the difference is f32 rounding.
//  - bf16 (mac_kernel): the state lives in shared memory; products are
//    the bf16 WMMA fragments of vector_field.cu (16x16x16, f32
//    accumulators).
//  - f32 (mac_kernel_f32, below): every product runs on mac::gemm_tf32
//    (split_tf32.cuh), as in vf_kernel_f32: operands in device memory are
//    staged by 16-byte cp.async through a ring of K slices and split once,
//    where they land, into big and small TF32 planes; each warp multiplies
//    a register tile of up to 48 x 32 by mma.sync in three passes; the
//    epilogues run from registers. Each weight slice is staged once per
//    CTA and shared by the 12 warps. Three passes keep f32's accuracy to
//    within a few ulps on the tensor cores. What limits it: one CTA per SM
//    (the ring and the planes take most of the 227 KB), a barrier per
//    16-wide K slice, and the small dependent products of each head.
//
// macaron_bwd.cu includes this file with MAC_HELPERS_ONLY for the shared
// helpers (namespace mac).

#ifndef VF_HELPERS_ONLY
#define VF_HELPERS_ONLY
#include "vector_field.cu"
#endif
#include "split_tf32.cuh"

namespace mac {

using namespace vf;

constexpr float kLnEps = 1e-6f;  // flax nn.LayerNorm's default
constexpr int kChunks[] = {128, 64, 32, 16};

// z = round(((xs - mean) * rsqrt(var + eps)) * g + b) over each row of D,
// in f32: the mean first, then the centred variance, as the TPU kernel
// takes them. One warp per row. Rows >= zero_from read as zeros (the
// backward's padded rows).
template <typename S, typename T>
__device__ void layer_norm_rows(const S* xs, int ldx, const float* g,
                                const float* b, T* z, int ldz, int n, int d,
                                int zero_from = 1 << 30) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const S* row = xs + (size_t)r * ldx;
    const bool real = r < zero_from;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += real ? to_f(row[c]) : 0.0f;
    const float mean = warp_sum(sum) / d;
    float var = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float cv = (real ? to_f(row[c]) : 0.0f) - mean;
      var += cv * cv;
    }
    const float rstd = rsqrtf(warp_sum(var) / d + kLnEps);
    for (int c = lane; c < d; c += 32) {
      const float cv = (real ? to_f(row[c]) : 0.0f) - mean;
      z[(size_t)r * ldz + c] = from_f<T>((cv * rstd) * g[c] + b[c]);
    }
  }
}

// C[M,N] += alpha * (A[M,K] @ B[K,N]); A, B row-major, C f32. Each 16x16
// tile's product is summed over K first and then added to C once. Work is
// split as in vf::mm: each warp owns a column tile (and a group of row
// tiles when there are fewer column tiles than warps).
__device__ void mm_axpy(const bf16* A, int lda, const bf16* B, int ldb,
                        float* C, int ldc, float alpha, int M, int N, int K) {
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const int warp = threadIdx.x / 32;
  const int mt = M / 16, nt = N / 16, kt = K / 16;
  const int groups = imin(imax(kWarps / nt, 1), mt);
  const int rg = (mt + groups - 1) / groups;
  for (int task = warp; task < nt * groups; task += kWarps) {
    const int tn = task % nt;
    const int r0 = (task / nt) * rg;
    const int rows = imin(mt - r0, rg);
    const bf16* bcol = B + tn * 16;
    FragC c[kMaxRowTiles];
#pragma unroll
    for (int r = 0; r < kMaxRowTiles; ++r)
      if (r < rows) wmma::fill_fragment(c[r], 0.0f);
    FragB b, b_next;
    wmma::load_matrix_sync(b, bcol, ldb);
    for (int kk = 0; kk < kt; ++kk) {
      if (kk + 1 < kt)
        wmma::load_matrix_sync(b_next, bcol + (size_t)(kk + 1) * 16 * ldb,
                               ldb);
#pragma unroll
      for (int r = 0; r < kMaxRowTiles; ++r) {
        if (r < rows) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + (size_t)(r0 + r) * 16 * lda + kk * 16,
                                 lda);
          wmma::mma_sync(c[r], a, b, c[r]);
        }
      }
      b = b_next;
    }
#pragma unroll
    for (int r = 0; r < kMaxRowTiles; ++r) {
      if (r < rows) {
        float* cp = C + (size_t)(r0 + r) * 16 * ldc + tn * 16;
        FragC t;
        wmma::load_matrix_sync(t, cp, ldc, wmma::mem_row_major);
        for (int i = 0; i < t.num_elements; ++i)
          t.x[i] = fmaf(alpha, c[r].x[i], t.x[i]);
        wmma::store_matrix_sync(cp, t, ldc, wmma::mem_row_major);
      }
    }
  }
}

// The bf16 kernels' products (mac_kernel, mcb_rows) through vf::mm.
template <bool AT, bool BT>
__device__ void prod(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                     int ldc, bool accumulate, int M, int N, int K,
                     int strip = 1 << 30, int strip_stride = 0) {
  mm<AT, BT>(A, lda, B, ldb, C, ldc, accumulate, M, N, K, strip,
             strip_stride);
}

// dst[r, c] += alpha * v[c] for an [n, w] f32 block.
__device__ inline void add_row_vector(float* dst, int ld, const float* v,
                                      float alpha, int n, int w) {
  for (int i = threadIdx.x; i < n * w; i += kThreads)
    dst[(size_t)(i / w) * ld + i % w] += alpha * v[i % w];
}

// The split-TF32 products staged through shared memory (gemm_tf32, its
// Ring, OpA and OpB) live in split_tf32.cuh, in this namespace: the f32
// Macaron kernels (mac_kernel_f32 below, mcb_rows_f32) and the f32 ViTODE
// kernels (vf_kernel_f32, vfb_rows_f32) share them.

}  // namespace mac

#ifndef MAC_HELPERS_ONLY

namespace mac {

struct Shape {
  int n_pad, n_real, d, heads, hd, dh, hc;
  int qkv_fused;  // 1: q, k and v of a head come from one product
};

// Shared memory of one mac_kernel CTA: byte offsets and row strides (in
// elements). Rows are padded by 16 bytes so fragment loads hit distinct
// banks. z (the rounded LayerNorm output), the f32 stage of the products,
// the rounded hidden chunk (also ctx of a head), q, k, v, p, and in bf16
// the f32 state. The bf16 kernel lays its CTA out by it; in f32 it only
// decides which shapes take one CTA (the route, mac_plan: a shape takes
// it in f32 where this layout fits), and mac_kernel_f32 then lays its CTA
// out by make_plan_f32. kernels/macaron.py::macaron_plan repeats this
// layout in Python.
struct Plan {
  size_t z, stage, hbuf, q, k, v, p, state, total;
  int ld_z, ld_stage, ld_h, ld_qkv, ld_p, ld_state;
};

__host__ __device__ inline Plan make_plan(const Shape& s, int tbytes) {
  const int pad = 16 / tbytes;
  Plan p;
  p.ld_z = s.d + pad;
  p.ld_stage = imax(imax(s.hc, s.qkv_fused ? 3 * s.hd : s.hd), s.n_pad) + 4;
  p.ld_h = imax(s.hc, s.hd) + pad;
  p.ld_qkv = s.hd + pad;
  p.ld_p = s.n_pad + pad;
  p.ld_state = s.d + 4;
  const size_t n = s.n_pad;
  size_t off = 0;
  p.z = off;     off += align128(n * p.ld_z * tbytes);
  p.stage = off; off += align128(n * p.ld_stage * 4);
  p.hbuf = off;  off += align128(n * p.ld_h * tbytes);
  p.q = off;     off += align128(n * p.ld_qkv * tbytes);
  p.k = off;     off += align128(n * p.ld_qkv * tbytes);
  p.v = off;     off += align128(n * p.ld_qkv * tbytes);
  p.p = off;     off += align128(n * p.ld_p * tbytes);
  p.state = off;
  if (tbytes == 2) off += align128(n * p.ld_state * 4);
  p.total = off;
  return p;
}

bool shape_ok(const Shape& s) {
  return s.heads > 0 && s.d % s.heads == 0 && s.d % 16 == 0 &&
         s.hd % 16 == 0 && s.dh % 16 == 0 && s.n_pad % 16 == 0 &&
         s.n_pad > 0 && s.n_pad <= 16 * kMaxRowTiles && s.n_real > 0 &&
         s.n_real <= s.n_pad;
}

}  // namespace mac

// Everything one evaluation needs, passed by pointer from Python (ctypes).
struct MacArgs {
  const void* x;
  const void* base;   // mode 2, else null
  void* out;          // [B * n_pad, D]; in f32 also the state
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
  float* ws;          // f32: B * mac_plan_f32's ws floats, else null
  int batch, n_pad, n_real, d, heads, dh, qkv_fused, hc, smem, mode;
  int nb;             // f32: the plan's column block
  float scaler, coef, qk_scale;
};

namespace mac {

// The bf16 instance (mac_kernel_f32 below is the f32 one).
template <typename T>
__global__ void __launch_bounds__(kThreads) mac_kernel(MacArgs a) {
  static_assert(sizeof(T) == 2, "f32 runs mac_kernel_f32");
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape s{a.n_pad, a.n_real, a.d,  a.heads,
                a.d / a.heads, a.dh, a.hc, a.qkv_fused};
  const Plan pl = make_plan(s, sizeof(T));
  T* z = reinterpret_cast<T*>(smem + pl.z);
  float* stage = reinterpret_cast<float*>(smem + pl.stage);
  T* hbuf = reinterpret_cast<T*>(smem + pl.hbuf);
  T* q = reinterpret_cast<T*>(smem + pl.q);
  T* k = reinterpret_cast<T*>(smem + pl.k);
  T* v = reinterpret_cast<T*>(smem + pl.v);
  T* p = reinterpret_cast<T*>(smem + pl.p);

  const int n = s.n_pad, d = s.d, hd = s.hd, hc = s.hc, dh = s.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t img = (size_t)blockIdx.x * n * d;
  const T* xi = static_cast<const T*>(a.x) + img;
  T* oi = static_cast<T*>(a.out) + img;
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wout = static_cast<const T*>(a.wout);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  // the f32 state, in shared memory
  float* xs = reinterpret_cast<float*>(smem + pl.state);
  const int lds = pl.ld_state;
  const float rs = a.rs[0];

  for (int r = warp; r < n; r += kWarps)
    for (int c = lane; c < d; c += 32)
      xs[r * lds + c] = to_f(xi[(size_t)r * d + c]);
  __syncthreads();

  // state += rs/2 * FFN(LN(state)), over dh in chunks of hc
  auto ffn_half = [&](const float* g, const float* b) {
    layer_norm_rows(xs, lds, g, b, z, pl.ld_z, n, d);
    __syncthreads();
    for (int c0 = 0; c0 < dh; c0 += hc) {
      prod<false, false>(z, pl.ld_z, w1 + c0, dh, stage, pl.ld_stage, false, n,
                       hc, d);
      __syncthreads();
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hc; c += 32)
          hbuf[r * pl.ld_h + c] =
              from_f<T>(gelu(stage[r * pl.ld_stage + c] + a.b1[c0 + c]));
      __syncthreads();
      mm_axpy(hbuf, pl.ld_h, w2 + (size_t)c0 * d, d, xs, lds, 0.5f * rs, n,
              d, hc);
      __syncthreads();
    }
    add_row_vector(xs, lds, a.b2, 0.5f * rs, n, d);
    __syncthreads();
  };

  ffn_half(a.ln1s, a.ln1b);

  // state += rs * (sum_h ctx_h Wout[h*hd:(h+1)*hd, :] + out_bias)
  layer_norm_rows(xs, lds, a.ln2s, a.ln2b, z, pl.ld_z, n, d);
  __syncthreads();
  for (int h = 0; h < s.heads; ++h) {
    T* dst[3] = {q, k, v};
    // padded value rows are zeroed so that 0 * NaN cannot reach p @ v
    if (s.qkv_fused) {
      prod<false, false>(z, pl.ld_z, wqkv + h * hd, 3 * d, stage, pl.ld_stage,
                       false, n, 3 * hd, d, hd / 16, d);
      __syncthreads();
      for (int j = 0; j < 3; ++j)
        round_block(stage + j * hd, pl.ld_stage, dst[j], pl.ld_qkv, n, hd,
                    j == 2 ? s.n_real : n, 1.0f, (T*)nullptr, 0,
                    a.qkv_bias + j * d + h * hd);
      __syncthreads();
    } else {
      for (int j = 0; j < 3; ++j) {
        prod<false, false>(z, pl.ld_z, wqkv + j * d + h * hd, 3 * d, stage,
                         pl.ld_stage, false, n, hd, d);
        __syncthreads();
        round_block(stage, pl.ld_stage, dst[j], pl.ld_qkv, n, hd,
                    j == 2 ? s.n_real : n, 1.0f, (T*)nullptr, 0,
                    a.qkv_bias + j * d + h * hd);
        __syncthreads();
      }
    }
    prod<false, true>(q, pl.ld_qkv, k, pl.ld_qkv, stage, pl.ld_stage, false, n,
                    n, hd);
    __syncthreads();
    softmax_rows(stage, pl.ld_stage, p, pl.ld_p, n, s.n_real, a.qk_scale);
    __syncthreads();
    prod<false, false>(p, pl.ld_p, v, pl.ld_qkv, stage, pl.ld_stage, false, n,
                     hd, n);
    __syncthreads();
    round_block(stage, pl.ld_stage, hbuf, pl.ld_h, n, hd, n);
    __syncthreads();
    mm_axpy(hbuf, pl.ld_h, wout + (size_t)h * hd * d, d, xs, lds, rs, n, d,
            hd);
    __syncthreads();
  }
  add_row_vector(xs, lds, a.out_bias, rs, n, d);
  __syncthreads();

  ffn_half(a.ln3s, a.ln3b);

  const T* bi = a.mode == 2 ? static_cast<const T*>(a.base) + img : xi;
  for (int r = warp; r < n; r += kWarps) {
    for (int c = lane; c < d; c += 32) {
      const float f = xs[r * lds + c] * a.scaler;
      const size_t i = (size_t)r * d + c;
      oi[i] = from_f<T>(a.mode == 0 ? f : to_f(bi[i]) + a.coef * f);
    }
  }
}

int launch_bf16(const MacArgs& a, cudaStream_t st) {
  auto kernel = mac_kernel<bf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.batch, kThreads, a.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---- the f32 instance: mac_kernel_f32 ----
// mac_kernel's evaluation in f32 with every product on gemm_tf32 (see the
// file's comment): z W1 per chunk of hc, h W2 per chunk, z Wqkv (a head's
// q | k | v in one product, through strips of the columns), q k^T, p v and
// ctx Wout per head. Each weight slice is staged once per CTA and shared
// by the 12 warps, not re-read and re-split by every warp that needs it.
//
// Where each operand lives. z (the LayerNorm output of either half) and
// the head's q | k | v go to a per-image workspace in device memory (one
// image's is n_pad (D + 3 hd) floats, 122,880 bytes at the CIFAR shape; the
// resident CTAs' shares stay in L2), from where the ring stages them;
// ctx of the head overwrites q there. The GELU chunk goes to its split
// planes from the W1 product's registers (bias and GELU in the
// epilogue); the scores land in p's planes in f32, the softmax runs on
// those rows in place, then the split. The f32 state is updated from
// registers by the W2 and Wout epilogues, chunk by chunk scaled by rs/2
// and head by head scaled by rs, b2 and out_bias once after the last
// (mac_kernel's order of sums). It lives in the output buffer (through
// L2): gemm_tf32's cadd reads all of a warp's elements at once and forms
// state + alpha v with one rounding (fmaf).
//
// Numerics: mac_kernel's in f32 (nothing is rounded but the products):
// LayerNorm in f32 with eps 1e-6, the mean first, then the centred
// variance; qkv after its bias; padded keys masked by selection; padded
// rows of v zeroed in the workspace. The split keeps NaN (split_bits), so
// a NaN in a padded row of x stays in its own rows and one in a real row
// reaches what it reaches in the plain version.
//
// f32 plan (mac_plan_f32; kernels/macaron.py::macaron_plan_f32 repeats
// it): the ring for column blocks of nb, then one region used by each FFN
// chunk (the GELU chunk's planes, hc + 4 floats a row) and by each head
// (p's planes, n_pad + 4 floats a row). Both strides are 4 mod 16 floats,
// so a fragment row read at 4 g + t hits 32 banks. The choice prefers wide
// chunks (up to 192, each chunk's z W1 product one column block: every
// chunk stages z again, so fewer chunks take fewer K slices), then wide
// column blocks. At the CIFAR shape that is chunks and blocks of 192 (the
// ring 85 KB, the chunk's planes 122.5 KB), the fastest plan an H100 was
// timed on (PERF.md). Which shapes take this kernel is mac_plan's
// decision (the route, unchanged): every shape it sends to one CTA in f32
// has an f32 plan.
struct PlanF32 {
  size_t ring, hbig, hsmall, pbig, psmall, total;
  size_t ws_qkv, ws;  // floats of one image's workspace (z at 0)
  int slot, ld_h, ld_p, ld_qkv;
};

__host__ __device__ inline PlanF32 make_plan_f32(const Shape& s, int nb) {
  PlanF32 p;
  const size_t n = s.n_pad;
  p.slot = ring_slot(s.n_pad, nb);
  p.ld_h = s.hc + 4;
  p.ld_p = s.n_pad + 4;
  p.ld_qkv = 3 * s.hd;
  size_t off = 0;
  p.ring = off;  off += align128((size_t)2 * kStages * p.slot * 4);
  const size_t fh = align128(n * p.ld_h * 4), fp = align128(n * p.ld_p * 4);
  p.hbig = off;
  p.hsmall = off + fh;
  p.pbig = off;
  p.psmall = off + fp;
  off += 2 * (fh > fp ? fh : fp);
  p.total = off;
  p.ws_qkv = n * s.d;
  p.ws = p.ws_qkv + n * p.ld_qkv;
  return p;
}

__global__ void __launch_bounds__(kThreads, 1) mac_kernel_f32(MacArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape s{a.n_pad, a.n_real, a.d,  a.heads,
                a.d / a.heads, a.dh, a.hc, 1};
  const PlanF32 pl = make_plan_f32(s, a.nb);
  const int n = s.n_pad, d = s.d, hd = s.hd, hc = s.hc, dh = s.dh;
  const int nb = a.nb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t img = (size_t)blockIdx.x * n * d;
  const float* xi = static_cast<const float*>(a.x) + img;
  float* oi = static_cast<float*>(a.out) + img;
  const float* wqkv = static_cast<const float*>(a.wqkv);
  const float* wout = static_cast<const float*>(a.wout);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  float* z = a.ws + (size_t)blockIdx.x * pl.ws;
  float* qkv = z + pl.ws_qkv;
  float* xs = oi;  // the f32 state
  const int lq = pl.ld_qkv, lh = pl.ld_h, lp = pl.ld_p;
  const Ring ring{reinterpret_cast<unsigned*>(smem + pl.ring), pl.slot};
  unsigned* hbig = reinterpret_cast<unsigned*>(smem + pl.hbig);
  unsigned* hsmall = reinterpret_cast<unsigned*>(smem + pl.hsmall);
  unsigned* pbig = reinterpret_cast<unsigned*>(smem + pl.pbig);
  unsigned* psmall = reinterpret_cast<unsigned*>(smem + pl.psmall);
  float* sf = reinterpret_cast<float*>(pbig);  // the f32 scores, then p
  const OpA hpl{nullptr, lh, hbig, hsmall};
  const OpA ppl{nullptr, lp, pbig, psmall};
  const float* b1 = a.b1;
  const float* qkv_bias = a.qkv_bias;
  const float rs = a.rs[0], hrs = 0.5f * rs;
  auto staged = [](const float* p, int ld) {
    return OpA{p, ld, nullptr, nullptr};
  };
  // state = state + alpha v, formed by gemm_tf32's cadd
  auto put_state = [&](int r, int c, float v0, float v1) {
    put2(xs + r * d + c, v0, v1);
  };

  for (int i = threadIdx.x * 4; i < n * d; i += kThreads * 4)
    *reinterpret_cast<float4*>(xs + i) =
        *reinterpret_cast<const float4*>(xi + i);
  __syncthreads();

  // state += rs/2 * FFN(LN(state)), over dh in chunks of hc
  auto ffn_half = [&](const float* g, const float* b) {
    layer_norm_rows(xs, d, g, b, z, d, n, d);
    for (int c0 = 0; c0 < dh; c0 += hc) {
      // h = gelu(z W1[:, c] + b1[c]) to the chunk's planes
      gemm_tf32<kAStaged, false>(
          ring, n, hc, d, nb, staged(z, d), op_b(w1 + c0, dh),
          [&](int r, int c, float v0, float v1) {
            const int i = r * lh + c;
            split_bits(gelu(v0 + b1[c0 + c]), hbig[i], hsmall[i]);
            split_bits(gelu(v1 + b1[c0 + c + 1]), hbig[i + 1],
                       hsmall[i + 1]);
          });
      gemm_tf32<kAPlanes, false>(
          ring, n, d, hc, nb, hpl, op_b(w2 + (size_t)c0 * d, d), put_state,
          xs, d, hrs);
    }
    __syncthreads();
    add_row_vector(xs, d, a.b2, hrs, n, d);
    __syncthreads();
  };

  // The three residual steps, FFN (LN1), attention, FFN (LN3), as one
  // loop: the FFN's code is emitted once, which keeps the kernel within
  // its 168 registers without spills.
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    if (part != 1) {
      ffn_half(part == 0 ? a.ln1s : a.ln3s, part == 0 ? a.ln1b : a.ln3b);
      continue;
    }
    // state += rs * (sum_h ctx_h Wout[h*hd:(h+1)*hd, :] + out_bias)
    layer_norm_rows(xs, d, a.ln2s, a.ln2b, z, d, n, d);
    for (int h = 0; h < s.heads; ++h) {
      // q | k | v of the head in one product, + bias, to the workspace
      // (padded value rows zeroed so that 0 * NaN cannot reach p @ v)
      gemm_tf32<kAStaged, false>(
          ring, n, 3 * hd, d, nb, staged(z, d),
          op_b(wqkv + h * hd, 3 * d, 1.0f, hd, d),
          [&](int r, int c, float v0, float v1) {
            const int j = c / hd, cc = j * d + h * hd + c % hd;
            const bool zero = j == 2 && r >= s.n_real;
            put2(qkv + (size_t)r * lq + c,
                 zero ? 0.0f : v0 + qkv_bias[cc],
                 zero ? 0.0f : v1 + qkv_bias[cc + 1]);
          });
      gemm_tf32<kAStaged, true>(
          ring, n, n, hd, nb, staged(qkv, lq), op_b(qkv + hd, lq),
          [&](int r, int c, float v0, float v1) {
            sf[r * lp + c] = v0;
            sf[r * lp + c + 1] = v1;
          });
      __syncthreads();
      softmax_rows(sf, lp, sf, lp, n, s.n_real, a.qk_scale);
      // p to its planes, in place (each thread splits what it wrote)
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < n; c += 32) {
          const int i = r * lp + c;
          split_bits(sf[i], pbig[i], psmall[i]);
        }
      // ctx = p v over q's columns, then state += rs ctx Wout_h
      gemm_tf32<kAPlanes, false>(
          ring, n, hd, n, nb, ppl, op_b(qkv + 2 * hd, lq),
          [&](int r, int c, float v0, float v1) {
            put2(qkv + (size_t)r * lq + c, v0, v1);
          });
      gemm_tf32<kAStaged, false>(
          ring, n, d, hd, nb, staged(qkv, lq),
          op_b(wout + (size_t)h * hd * d, d), put_state, xs, d, rs);
    }
    __syncthreads();
    add_row_vector(xs, d, a.out_bias, rs, n, d);
    __syncthreads();
  }

  const float* bi =
      a.mode == 2 ? static_cast<const float*>(a.base) + img : xi;
  for (int i = threadIdx.x * 4; i < n * d; i += kThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(xs + i);
    float f[4] = {v.x * a.scaler, v.y * a.scaler, v.z * a.scaler,
                  v.w * a.scaler};
    if (a.mode != 0) {
      const float4 u = *reinterpret_cast<const float4*>(bi + i);
      f[0] = u.x + a.coef * f[0];
      f[1] = u.y + a.coef * f[1];
      f[2] = u.z + a.coef * f[2];
      f[3] = u.w + a.coef * f[3];
    }
    *reinterpret_cast<float4*>(oi + i) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// The FFN chunks of the f32 plan, widest first.
constexpr int kChunksF32[] = {192, 128, 64, 32, 16};

// The f32 plan of one CTA (see PlanF32): the widest FFN chunk, then the
// widest column block no narrower than the chunk. Returns false when no
// plan fits.
bool plan_f32(Shape s, int* hc, int* nb, PlanF32* out) {
  for (int c : kChunksF32) {
    if (s.dh % c) continue;
    s.hc = c;
    for (int b : kBlocksF32) {
      if (!block_ok(s.n_pad, b) || b < c) continue;
      const PlanF32 p = make_plan_f32(s, b);
      if (p.total <= (size_t)kMaxSmem) {
        *hc = c;
        *nb = b;
        *out = p;
        return true;
      }
    }
  }
  return false;
}

// mac_kernel_f32's launches so far (chip_smoke.py holds the count against
// the route's)
unsigned long long f32_launches = 0;

// Launches mac_kernel_f32 on mac_plan_f32's plan, which the arguments
// carry (hc, nb, smem).
int launch_f32(const MacArgs& a, cudaStream_t st) {
  const Shape s{a.n_pad, a.n_real, a.d,  a.heads,
                a.heads > 0 ? a.d / a.heads : 0, a.dh, 0, 1};
  int hc, nb;
  PlanF32 p;
  if (a.ws == nullptr || !shape_ok(s) || !plan_f32(s, &hc, &nb, &p) ||
      hc != a.hc || nb != a.nb || p.total != (size_t)a.smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mac_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  mac_kernel_f32<<<a.batch, kThreads, a.smem, st>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++f32_launches;
  return (int)err;
}

}  // namespace mac

extern "C" {

// Chooses the plan of one CTA: whether q, k and v of a head come from one
// product, the FFN chunk width and the shared memory, preferring the fused
// q|k|v product and wide chunks (kernels/macaron.py::macaron_plan repeats
// this rule in Python). Returns 0 when the shape has a plan, 1 when it has
// none (the wrapper raises).
int mac_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int* qkv_fused_out, int* hc_out, int* smem_out) {
  for (int fused = 1; fused >= 0; --fused) {
    for (int hc : mac::kChunks) {
      const mac::Shape s{n_pad, n_real, d,  heads, heads > 0 ? d / heads : 0,
                         dh,    hc,     fused};
      if (!mac::shape_ok(s) || dh % hc) continue;
      const mac::Plan p = mac::make_plan(s, tbytes);
      if (p.total <= (size_t)vf::kMaxSmem) {
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
// the launch (0 on success). mode: 0 plain, 1 euler, 2 base. bf16 runs
// mac_kernel on the plan of mac_plan (qkv_fused, hc, smem); f32 runs
// mac_kernel_f32 on the plan of mac_plan_f32 (hc, nb, smem) with `ws`
// its workspace, apart from `out` and x.
int mac_launch(int tbytes, const MacArgs* args, void* stream) {
  if (args->mode < 0 || args->mode > 2 ||
      (args->mode == 2) != (args->base != nullptr))
    return (int)cudaErrorInvalidValue;
  if (tbytes == 4 && args->out == args->x) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? mac::launch_bf16(*args, st)
                     : mac::launch_f32(*args, st);
}

// The f32 plan (mac_kernel_f32, see PlanF32): the FFN chunk, the column
// block, the shared memory and the workspace's floats per image. Returns
// 0 when the shape has one, 1 when not.
int mac_plan_f32(int n_pad, int n_real, int d, int heads, int dh,
                 int* hc_out, int* nb_out, int* smem_out, long long* ws_out) {
  const mac::Shape s{n_pad, n_real, d,  heads, heads > 0 ? d / heads : 0,
                     dh,    0,      1};
  mac::PlanF32 p;
  if (!mac::shape_ok(s) || !mac::plan_f32(s, hc_out, nb_out, &p))
    return 1;
  *smem_out = (int)p.total;
  *ws_out = (long long)p.ws;
  return 0;
}

unsigned long long mac_f32_launches() { return mac::f32_launches; }

const char* mac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // MAC_HELPERS_ONLY
