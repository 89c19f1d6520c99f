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
// each (below): 304 GFLOP of TF32 work, 0.62 ms at 495 TFLOP/s; on the
// CUDA cores' 67 TFLOP/s f32 peak the evaluation would take 1.5 ms.
//
// Design. One CTA of 12 warps per image, as vf_kernel (vector_field.cu):
// only x (and base) come in and only the new state goes out. The FFN runs
// over dh in chunks of hc, so the [n_pad, dh] hidden never exists whole;
// each chunk's product h_c W2[c, :] is added to the state scaled by rs/2
// (b2 once, after the last chunk), and each head's ctx_h Wout[h] scaled by
// rs (out_bias once, after the last head). That sums each FFN output and
// attn_o in another order than the TPU kernel (which adds the whole
// product to the state); the difference is f32 rounding. The state lives
// in shared memory in bf16 and in the output buffer in f32. Products are
// the bf16 WMMA fragments of vector_field.cu (16x16x16, f32 accumulators)
// or, in f32, split-TF32 WMMA in three passes (mm_f32 of split_tf32.cuh),
// which keeps f32's accuracy to within a few ulps on the tensor cores.
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

__device__ void mm_axpy(const float* A, int lda, const float* B, int ldb,
                        float* C, int ldc, float alpha, int M, int N, int K) {
  mm_f32<false, false>(A, lda, B, ldb, C, ldc, true, M, N, K, alpha);
}

// The Macaron kernels' products: bf16 through vf::mm, f32 through mm_f32.
template <bool AT, bool BT>
__device__ void prod(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                     int ldc, bool accumulate, int M, int N, int K,
                     int strip = 1 << 30, int strip_stride = 0) {
  mm<AT, BT>(A, lda, B, ldb, C, ldc, accumulate, M, N, K, strip,
             strip_stride);
}

template <bool AT, bool BT>
__device__ void prod(const float* A, int lda, const float* B, int ldb,
                     float* C, int ldc, bool accumulate, int M, int N, int K,
                     int strip = 1 << 30, int strip_stride = 0) {
  mm_f32<AT, BT>(A, lda, B, ldb, C, ldc, accumulate, M, N, K, 1.0f, strip,
                 strip_stride);
}

// dst[r, c] += alpha * v[c] for an [n, w] f32 block.
__device__ inline void add_row_vector(float* dst, int ld, const float* v,
                                      float alpha, int n, int w) {
  for (int i = threadIdx.x; i < n * w; i += kThreads)
    dst[(size_t)(i / w) * ld + i % w] += alpha * v[i % w];
}

// The split-TF32 products staged through shared memory (gemm_tf32, its
// Ring, OpA and OpB) live in split_tf32.cuh, in this namespace: the
// Macaron backward and the f32 ViTODE kernels (vf_kernel_f32,
// vfb_rows_f32) share them.

}  // namespace mac

#ifndef MAC_HELPERS_ONLY

namespace mac {

struct Shape {
  int n_pad, n_real, d, heads, hd, dh, hc;
  int qkv_fused;  // 1: q, k and v of a head come from one product
};

// Shared memory of one CTA: byte offsets and row strides (in elements).
// Rows are padded by 16 bytes so fragment loads hit distinct banks. z (the
// rounded LayerNorm output), the f32 stage of the products, the rounded
// hidden chunk (also ctx of a head), q, k, v, p, and in bf16 the f32 state
// (in f32 it lives in the output buffer).
// kernels/macaron.py::macaron_plan repeats this layout in Python.
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
  p.ld_state = tbytes == 2 ? s.d + 4 : s.d;
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
  int batch, n_pad, n_real, d, heads, dh, qkv_fused, hc, smem, mode;
  float scaler, coef, qk_scale;
};

namespace mac {

template <typename T>
__global__ void __launch_bounds__(kThreads) mac_kernel(MacArgs a) {
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
  // the f32 state: shared memory in bf16, the output buffer in f32 (each
  // element is read and written by the same thread in the epilogue)
  float* xs = sizeof(T) == 2 ? reinterpret_cast<float*>(smem + pl.state)
                             : reinterpret_cast<float*>(oi);
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

template <typename T>
int launch(const MacArgs& a, cudaStream_t st) {
  auto kernel = mac_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.batch, kThreads, a.smem, st>>>(a);
  return (int)cudaGetLastError();
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
// the launch (0 on success). mode: 0 plain, 1 euler, 2 base.
int mac_launch(int tbytes, const MacArgs* args, void* stream) {
  if (args->mode < 0 || args->mode > 2 ||
      (args->mode == 2) != (args->base != nullptr))
    return (int)cudaErrorInvalidValue;
  if (tbytes == 4 && args->out == args->x) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tbytes == 2 ? mac::launch<vf::bf16>(*args, st)
                     : mac::launch<float>(*args, st);
}

const char* mac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // MAC_HELPERS_ONLY
