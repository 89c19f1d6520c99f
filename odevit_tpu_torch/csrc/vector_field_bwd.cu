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
// [B * n_pad, dh]. The rows kernel reads each dh chunk of h1 from rh1
// instead of the cn_m W1 product, and q, k and v of each head from rqkv
// instead of
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
// ms at the H100's 989 TFLOP/s in bf16. The rows kernel's own products
// (all but the weight products) are 130 GFLOP on the 80 padded rows, 0.13
// ms; the scratch operands it writes (566 MB) take 0.17 ms at 3.35 TB/s;
// with dropout the masks' integer work (the forward's, 58 us on its
// busiest pipe) stays below.
//
// Design: three launches, all deterministic.
//  1. The rows kernel, one CTA of 12 warps per image (bf16:
//     vfb_rows_bf16, on mma.sync register tiles with the weights staged
//     once per CTA; f32: vfb_rows_f32, split TF32 on mma.sync; both
//     below): the attention backward head by head, the MLP backward over
//     dh in chunks (recomputing what the forward computed), a_bar, x_bar
//     and the image's norm partial sums, m_bar kept on chip. It writes
//     the operands of the weight products (cn_m, cn_a, gd, ctx, h,
//     h1_bar, [q_bar k_bar v_bar]) to global scratch in x's dtype.
//  2. vfb_wgrad_wgmma (f32: vfb_wgrad_tf32): the four weight cotangents
//     as A^T G products over all B*n_pad rows. The TPU accumulates them
//     with += across its sequential grid; here CTAs run in parallel, so
//     each CTA sums one output tile over one fixed slice of rows into its
//     own partial buffer (bf16: wgmma fed by a TMA ring; f32: split TF32
//     on wgmma fed by cp.async; below).
//  3. vfb_reduce: sums the partials (and the per-image norm partials) in
//     a fixed order. Two runs give bit-identical cotangents.
// Products are the repo's own code (mma.sync and split TF32 in
// split_tf32.cuh, wgmma and TMA here); nothing goes to a library. Not
// yet done: keeping the weight products' A and G operands on chip.

#define VF_HELPERS_ONLY
#include "vector_field.cu"
#include "split_tf32.cuh"

#include <cuda.h>

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
  float* ws;               // f32: B * vfb_plan_f32's ws_floats, else null
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
  int nb, acc_smem;        // f32: set by the launcher from its own plan
  int stages;              // bf16: set by the launcher from its own plan
  float scaler, qk_scale;
  Drop drop;               // all zeros: the deterministic instance
};

namespace {

constexpr int kChunks[] = {128, 64, 32, 16};
constexpr int kRowStep = 32;     // rows of a chunk of mcb_wgrad_f32

// The bytes of shared memory the one-CTA route was planned with: cn and
// gd (with dropout also gd2) in shared memory unless cn_smem is 0, the row
// means, then the larger of an MLP region (two f32 stages and the rounded
// h1_bar chunk) and an attention region (scores, p in f32 and in x's
// dtype, q, k, v, cb; with dropout the keep bits, with L2 five vectors)
// or a_bar in f32. This was the layout of PR 3's kernel; vfb_plan keeps
// it as the rule of which shapes take one CTA (in either dtype: the f32
// and bf16 kernels lay their CTAs out by plans of their own, PlanB32 and
// PlanB16). kernels/vector_field_bwd.py::cta_bwd_plan repeats it.
__host__ __device__ inline size_t make_plan(int n, int d, int hd, int hc,
                                            int cn_smem, int tb, bool drop,
                                            bool l2) {
  const int pad = 16 / tb;
  size_t off = 0;
  if (cn_smem) off += (drop ? 3 : 2) * align128((size_t)n * (d + pad) * tb);
  off += align128((size_t)n * 4);
  const size_t mlp = 2 * align128((size_t)n * (hc + 4) * 4) +
                     align128((size_t)n * (hc + pad) * tb);
  size_t attn = align128((size_t)n * (imax(hd, n) + 4) * 4) +
                align128((size_t)n * (n + 4) * 4) +
                align128((size_t)n * (n + pad) * tb) +
                4 * align128((size_t)n * (hd + pad) * tb);
  if (drop) attn += align128((size_t)n * 4 * 4);
  if (l2) attn += 5 * align128((size_t)n * 4);
  size_t m = mlp > attn ? mlp : attn;
  const size_t abar = align128((size_t)n * (d + 4) * 4);
  if (abar > m) m = abar;
  return off + m;
}

// ---- the bf16 instance: vfb_rows_bf16 ----
// Replaces the bf16 instances of PR 3's vfb_rows template, whose products
// (vf::mm, WMMA) loaded every weight fragment from device memory one
// k-step ahead, stored each f32 result in shared memory for a separate
// rounding pass and summed m_bar in an f32 [B n_pad, D] buffer in device
// memory (4.56 ms a launch at the CIFAR shape, 3 % of the tensor cores'
// peak).
//
// The chain and its rounding points are the top of the file's.
// Every product runs on mac::gemm_b16 (split_tf32.cuh): mma.sync m16n8k16
// register tiles, fragments from shared memory by ldmatrix, the weights
// W1, W2, Wqkv and Wout staged by 16-byte cp.async through a ring of K
// slices of 32 (two to four slots), each slice once for the 12 warps.
// Epilogues run on the accumulators: the rounding, GELU and GELU', the
// mask_h bits (one Philox call a lane pair: each lane draws one of the
// pair's two rows and hands half the words across), and the stores of h,
// h1_bar, ctx and [q_bar k_bar v_bar] go from registers; only what a
// later product or row pass of the CTA reads goes to shared memory, in
// bf16 where the chain rounds it (q, k, v, cb, p, s_bar, h1_bar) and in
// f32 where it does not (the scores and p_bar for the row passes: the
// softmax, sum(p_bar p), L2's sums).
//
// Order. The attention backward head by head first (it writes q_bar,
// k_bar, v_bar to their scratch), then the MLP backward over dh in
// chunks, then a_bar = [q_bar k_bar v_bar] Wqkv^T with both operands
// staged, whose epilogue meets m_bar: it takes the four norm partials'
// column sums in registers (reduced over the lanes of a column in a fixed
// order, then over the warps' row groups through shared memory in a fixed
// order) and leaves c_bar = a_bar gamma_a + m_bar gamma_m for the row
// pass of x_bar.
//
// m_bar on chip: f32 [n_pad, D + 4] in shared memory, each chunk's
// product added by its epilogue, each element by the thread that holds
// it. Keeping each warp's tile of it in registers across the chunks (40
// floats a thread at the CIFAR shape) was tried first: beside the MLP's
// two register tiles it pushed three of the four instances past the 168
// registers that 384 threads get, into spills.
//
// Plan (vfb_plan_bf16; kernels/vector_field_bwd.py::bf16_bwd_plan repeats
// it): cn and gd resident in shared memory where they fit (else staged
// from their scratch, where the kernel writes them anyway), four ring
// slots, the MLP chunk (64 first:
// its two products h1 and h_bar, one dual call of 1 x 4 tiles, then take
// 10 of the 12 warps at n_pad = 80), and the widest column block of the
// staged weights that fits 227 KB. The products the forward also takes
// (qkv, h1, the scores, ctx) walk K as vf::mm does, in k-steps of 16 in
// increasing order on the same m16n8k16 instruction.
struct PlanB16 {
  size_t l2, mean, cna, gda, q, k, v, cb, st, st2, pb, pbits, ring_a;
  size_t mbar, cnm, gd, hb, ring_m, part, ring_e, total;
  int ld_cn, ld_hd, ld_s, ld_p, ld_hb, ld_mb;
  int slot_a, slot_m, slot_e, groups_e;
};

constexpr int kChunksB16[] = {64, 32, 16};
constexpr int kStagesB16 = 4;  // the most slots of the ring
constexpr int kBlocksB16[] = {192, 128, 96, 64, 32, 16};

// the row groups of a_bar's tiles: the most over its column blocks
__host__ __device__ constexpr int abar_groups(int n, int d, int nb) {
  int g = mac::tiling_b16(n / 16, imin(nb, d) / 8, 3, 4).groups;
  if (d > nb && d % nb)
    g = imax(g, mac::tiling_b16(n / 16, (d % nb) / 8, 3, 4).groups);
  return g;
}

// Byte offsets of one CTA's shared memory: L2's five vectors and the row
// means, then a region laid out three times: for the attention (cn_a and
// gda where resident, q, k, v, cb, the f32 scores / p, p or s_bar in
// bf16, the keep bits, then the ring or, from its product to the row
// pass, p_bar in f32), for the MLP (m_bar in f32, cn_m and gd where
// resident, the h1_bar chunk, the ring) and for a_bar (c_bar in m_bar's
// place, the norm partials of each
// row group, the ring). Row strides of bf16 operands are their width + 8
// elements (ldmatrix reads 32 banks), of f32 ones width + 4.
__host__ __device__ constexpr PlanB16 make_plan_b16(int n, int d, int hd,
                                                    int hc, int nb,
                                                    int cn_smem, int stages,
                                                    bool drop, bool l2) {
  using mac::kGA;
  using mac::kGB;
  using mac::kGBT;
  using mac::kSA;
  using mac::slot_b16;
  PlanB16 p{};
  const int ka = cn_smem ? kSA : kGA;
  p.ld_cn = d + 8;
  p.ld_hd = hd + 8;
  p.ld_s = n + 4;
  p.ld_p = n + 8;
  p.ld_hb = hc + 8;
  p.ld_mb = d + 4;
  p.slot_a = imax(slot_b16(n, imin(nb, 3 * hd), ka, kGB),
                  slot_b16(n, imin(nb, hd), ka, kGBT));
  p.slot_m = imax(slot_b16(n, imin(nb, hc), ka, kGB, kGBT),
                  slot_b16(n, imin(nb, d), kSA, kGBT));
  p.slot_e = slot_b16(n, imin(nb, d), kGA, kGBT);
  p.groups_e = abar_groups(n, d, nb);
  size_t off = 0;
  p.l2 = off;
  if (l2) off += 5 * align128((size_t)n * 4);
  p.mean = off;
  off += align128((size_t)n * 4);
  const size_t cn = align128((size_t)n * p.ld_cn * 2);
  const size_t hds = align128((size_t)n * p.ld_hd * 2);
  const size_t fs = align128((size_t)n * p.ld_s * 4);
  size_t a = off;
  p.cna = a;
  p.gda = a;
  if (cn_smem) {
    p.gda = a + cn;
    a += 2 * cn;
  }
  p.q = a;
  p.k = a + hds;
  p.v = a + 2 * hds;
  p.cb = a + 3 * hds;
  a += 4 * hds;
  p.st = a;
  a += fs;
  p.pb = a;
  a += align128((size_t)n * p.ld_p * 2);
  p.pbits = a;
  if (drop) a += align128((size_t)n * 4 * 4);
  // p_bar lives from its product to the row pass, when the ring is idle
  p.ring_a = a;
  p.st2 = a;
  const size_t ring = (size_t)stages * p.slot_a * 2;
  a += ring > fs ? ring : fs;
  const size_t mb = align128((size_t)n * p.ld_mb * 4);
  p.mbar = off;
  size_t m = off + mb;
  p.cnm = m;
  p.gd = m;
  if (cn_smem) {
    p.gd = m + cn;
    m += 2 * cn;
  }
  p.hb = m;
  m += align128((size_t)n * p.ld_hb * 2);
  p.ring_m = m;
  m += (size_t)stages * p.slot_m * 2;
  size_t e = off + mb;
  p.part = e;
  e += align128((size_t)p.groups_e * 4 * d * 4);
  p.ring_e = e;
  e += (size_t)stages * p.slot_e * 2;
  p.total = a > m ? a : m;
  if (e > p.total) p.total = e;
  return p;
}

// vfb_rows_bf16's plan for a shape: cn and gd resident and the most ring
// slots, in that order of preference, then the MLP chunk and the widest
// column block that fit. Returns false when none fits.
inline bool plan_b16(int n, int d, int hd, int dh, bool drop, bool l2,
                     int* cn_smem, int* hc, int* nb, int* stages,
                     PlanB16* out) {
  for (int cs = 1; cs >= 0; --cs)
    for (int st = kStagesB16; st >= 2; --st)
      for (int c : kChunksB16) {
        if (dh % c) continue;
        for (int bl : kBlocksB16) {
          const PlanB16 p = make_plan_b16(n, d, hd, c, bl, cs, st, drop, l2);
          if (p.total <= (size_t)kMaxSmem) {
            *cn_smem = cs;
            *hc = c;
            *nb = bl;
            *stages = st;
            *out = p;
            return true;
          }
        }
      }
  return false;
}

// The CIFAR training shape (80 rows, D=192, 3 heads, chunks of 64) takes
// the first plan in every instance: cn and gd resident, four slots. The
// widest register tiles (3 x 4 m16n8 tiles, 48 floats; the MLP's two of 1
// x 4, 32) leave 120 registers a thread of the 168 that 384 threads get.
constexpr int kRegsB16 = 65536 / kThreads / 8 * 8;
static_assert(make_plan_b16(80, 192, 64, 64, 192, 1, 4, true, false)
                      .total <= kMaxSmem &&
                  make_plan_b16(80, 192, 64, 64, 192, 1, 4, false, true)
                          .total <= kMaxSmem,
              "the CIFAR plan fits 227 KB in every instance");
static_assert(3 * 4 * 4 + 120 <= kRegsB16,
              "a product's register tiles leave 120 registers a thread");
static_assert(mac::kSliceB % 16 == 0 && mac::kLdSlice * 2 % 16 == 0,
              "a staged slice is whole k-steps and 16-byte rows");

// The kept values of mask_h at columns col, col + 1 (col even) of rows r
// and r + 8 (m[0], m[1]): the lanes of a pair (tq and tq ^ 1 hold the four
// columns of one Philox call) each draw one of the two rows and hand the
// other lane the two words it needs. Padded rows keep nothing.
__device__ __forceinline__ void keep_pair(unsigned key, unsigned img, int r,
                                          int col, int n_real, unsigned th,
                                          float sc, float (&m)[2][2]) {
  const bool odd = threadIdx.x & 1;
  const int rr = r + (odd ? 8 : 0);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (rr < n_real) w = philox(key, img, rr, col >> 2);
  const unsigned s0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned s1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const unsigned o0 = odd ? w.z : w.x, o1 = odd ? w.w : w.y;
  const unsigned u[2][2] = {{odd ? s0 : o0, odd ? s1 : o1},
                            {odd ? o0 : s0, odd ? o1 : s1}};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) m[h][e] = u[h][e] >= th ? sc : 0.0f;
}

// The rows r < n of an [n, w] bf16 block from shared memory (stride lds)
// to device memory (stride ldd), 16 bytes at a time; row r by warp r % 12,
// the warp that wrote it (center_norm).
__device__ __forceinline__ void rows_out(const bf16* src, int lds, bf16* dst,
                                         int ldd, int n, int w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncwarp();
  for (int r = warp; r < n; r += kWarps)
    for (int c = lane * 8; c < w; c += 256)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
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
template <bool kDrop, bool kL2, bool kResid>
__global__ void __launch_bounds__(kThreads, 1) vfb_rows_bf16(Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  using mac::each_pair;
  using mac::gemm_b16;
  using mac::kGA;
  using mac::kGB;
  using mac::kGBT;
  using mac::kSA;
  using mac::kSAT;
  using mac::kSB;
  using mac::kSBT;
  using mac::op16;
  using mac::Op16;
  using mac::put2;
  using mac::put_b2;
  using mac::TileB16;
  typedef float Acc[3][4][4];
  typedef float Acc1[1][4][4];
  // The sizes are made opaque at the top of each phase, head and chunk
  // (VFB16_FRESH), and the plan's offsets and every pointer are derived
  // again after it (VFB16_PHASE), so that nothing but the accumulators
  // lives in registers across the products (as in vfb_rows_f32).
  int n = args.n_pad, n_real = args.n_real, d = args.d;
  int hd = d / args.heads, nb = args.nb;
  const int heads = args.heads, dh = args.dh, hc = args.hc;
  const int cn_smem = args.cn_smem, stages = args.stages;
  const Drop& dr = args.drop;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x;
  const float tau = args.qk_scale;
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(smem + off); };
  auto atf = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
#define VFB16_FRESH \
  asm volatile("" : "+r"(n), "+r"(n_real), "+r"(d), "+r"(hd), "+r"(nb))
#define VFB16_PHASE                                                         \
  VFB16_FRESH;                                                              \
  const PlanB16 pl =                                                        \
      make_plan_b16(n, d, hd, hc, nb, cn_smem, stages, kDrop, kL2);         \
  const size_t row0 = (size_t)b * n;                                        \
  const bf16* x = static_cast<const bf16*>(args.x) + row0 * d;             \
  const bf16* wqkv = static_cast<const bf16*>(args.wqkv);                  \
  bf16* gd_g = static_cast<bf16*>(args.gd) + row0 * d;                     \
  /* the attention's operand: gd, or with dropout gd2 */                   \
  bf16* gda_g = kDrop ? static_cast<bf16*>(args.gd2) + row0 * d : gd_g;    \
  bf16* qkvb_g = static_cast<bf16*>(args.qkvb) + row0 * 3 * d;             \
  float* mean = atf(pl.mean);                                               \
  const float scale = (float)((double)d / (d - 1.0));                      \
  const int lcn = cn_smem ? pl.ld_cn : d;                                   \
  bf16* gda = cn_smem ? at(pl.gda) : gda_g

  // gd = round(g * scaler (* mask_mo)) and, with dropout, gd2 =
  // round(g * scaler * mask_ao) to their scratch, the attention's (gd or
  // gd2) also to shared memory where it stays; rows >= n_real are zeros;
  // then cn_a and the row means
  {
    VFB16_PHASE;
    const bf16* g = static_cast<const bf16*>(args.g) + row0 * d;
    if (kDrop) {
      // 4 columns a lane: one Philox call per site
      const unsigned kmo = site_key(dr.seed, kSiteMlpOut);
      const unsigned kao = site_key(dr.seed, kSiteAttnOut);
      for (int r = warp; r < n; r += kWarps)
        for (int gg = lane; 4 * gg < d; gg += 32) {
          float mo[4] = {1.0f, 1.0f, 1.0f, 1.0f}, ma[4] = {1.0f, 1.0f, 1.0f,
                                                           1.0f};
          if (r < n_real && dr.th_m)
            keep4(kmo, b, r, gg, d, dr.th_m, dr.sc_m, mo);
          if (r < n_real && dr.th_ao)
            keep4(kao, b, r, gg, d, dr.th_ao, dr.sc_ao, ma);
          uint2 gv = make_uint2(0u, 0u);
          if (r < n_real)
            gv = *reinterpret_cast<const uint2*>(g + (size_t)r * d + 4 * gg);
          const bf16* gi = reinterpret_cast<const bf16*>(&gv);
          __align__(8) bf16 vm[4], va[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = to_f(gi[j]) * args.scaler;
            vm[j] = from_f<bf16>(v * mo[j]);
            va[j] = from_f<bf16>(v * ma[j]);
          }
          const size_t o = (size_t)r * d + 4 * gg;
          *reinterpret_cast<uint2*>(gd_g + o) = *reinterpret_cast<uint2*>(vm);
          *reinterpret_cast<uint2*>(gda_g + o) = *reinterpret_cast<uint2*>(va);
          if (cn_smem)
            *reinterpret_cast<uint2*>(gda + r * lcn + 4 * gg) =
                *reinterpret_cast<uint2*>(va);
        }
    } else {
      // 8 columns a lane, 16 bytes at a time
      for (int r = warp; r < n; r += kWarps)
        for (int c = 8 * lane; c < d; c += 256) {
          uint4 gv = make_uint4(0u, 0u, 0u, 0u);
          if (r < n_real)
            gv = *reinterpret_cast<const uint4*>(g + (size_t)r * d + c);
          const bf16* gi = reinterpret_cast<const bf16*>(&gv);
          __align__(16) bf16 o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o[j] = from_f<bf16>(to_f(gi[j]) * args.scaler);
          *reinterpret_cast<uint4*>(gd_g + (size_t)r * d + c) =
              *reinterpret_cast<uint4*>(o);
          if (cn_smem)
            *reinterpret_cast<uint4*>(gda + r * lcn + c) =
                *reinterpret_cast<uint4*>(o);
        }
    }

    bf16* cna_g = static_cast<bf16*>(args.cna) + row0 * d;
    bf16* cna = cn_smem ? at(pl.cna) : cna_g;
    center_norm(x, args.ga, args.ba, cna, lcn, n, d, n_real, mean);
    if (cn_smem) rows_out(cna, lcn, cna_g, d, n, d);
  }

  // ---- attention backward, head by head ----
  Acc acc;
#pragma unroll 1
  for (int hh = 0; hh < heads; ++hh) {
    VFB16_PHASE;
    bf16* cna = cn_smem ? at(pl.cna)
                        : static_cast<bf16*>(args.cna) + row0 * d;
    const bf16* wout = static_cast<const bf16*>(args.wout);
    bf16* ctx_g = static_cast<bf16*>(args.ctx) + row0 * d;
    bf16 *q = at(pl.q), *k = at(pl.k), *v = at(pl.v), *cb = at(pl.cb);
    float* st = atf(pl.st);    // the scores, then the f32 p (L2: e) in place
    float* st2 = atf(pl.st2);  // p_bar (L2: then d2b)
    bf16* pb = at(pl.pb);      // p, then s_bar (L2: round(d2b))
    unsigned* pbits = reinterpret_cast<unsigned*>(smem + pl.pbits);
    // kL2: q2, k2, esum, then the rows' and the columns' sums of d2b
    const size_t nv = align128((size_t)n * 4) / 4;
    float* q2 = atf(pl.l2);
    float *k2 = q2 + nv, *esum = q2 + 2 * nv, *rsum = q2 + 3 * nv,
          *csum = q2 + 4 * nv;
    bf16* ring_a = at(pl.ring_a);
    const int lh = pl.ld_hd, ls = pl.ld_s, lp = pl.ld_p;
    const Op16 o_cn = op16(cna, lcn), o_gda = op16(gda, lcn);
    if (kResid) {
      // q, k and v of the head from rqkv; padded rows read as zeros
      const bf16* rq = static_cast<const bf16*>(args.rqkv) + row0 * 3 * d +
                       hh * hd;
      __syncthreads();  // the last head's products have read q, k and v
      const int per = hd / 8;
      for (int i = threadIdx.x; i < 3 * n * per; i += kThreads) {
        const int j = i / (n * per), r = i % (n * per) / per,
                  c = i % per * 8;
        cp_async16((j == 0 ? q : j == 1 ? k : v) + r * lh + c,
                   rq + (size_t)r * 3 * d + j * d + c, r < n_real);
      }
      cp_async_commit();
      cp_async_wait<0>();  // the scores' product syncs first
    } else {
      // q | k | v = round(cn_a Wqkv[:, head] (+ bias)) in one product;
      // padded value rows are zeroed so that 0 * NaN cannot reach p @ v
      auto epi = [&](const TileB16& t, Acc& c, Acc&) {
        each_pair(t, c, [&](int r, int col, float v0, float v1) {
          const int j = col / hd, cc = col % hd;
          if (kL2) {
            const float* bias = args.qkv_bias + j * d + hh * hd + cc;
            v0 += bias[0];
            v1 += bias[1];
          }
          if (j == 2 && r >= n_real) v0 = v1 = 0.0f;
          put_b2((j == 0 ? q : j == 1 ? k : v) + r * lh + cc, v0, v1);
        });
      };
      const Op16 ob = op16(wqkv + hh * hd, 3 * d, hd, d);
      if (cn_smem)
        gemm_b16<3, 4, kSA, kGB>(ring_a, pl.slot_a, stages, n, 3 * hd, d, nb,
                                 o_cn, ob, o_cn, ob, acc, acc, true, epi);
      else
        gemm_b16<3, 4, kGA, kGB>(ring_a, pl.slot_a, stages, n, 3 * hd, d, nb,
                                 o_cn, ob, o_cn, ob, acc, acc, true, epi);
    }
    if (kL2) {
      __syncthreads();
      sq_rows(q, lh, n, hd, q2);
      sq_rows(k, lh, n, hd, k2);
    }
    // the scores q k^T in f32
    auto to_st = [&](float* dst) {
      return [=](const TileB16& t, Acc& c, Acc&) {
        each_pair(t, c, [&](int r, int col, float v0, float v1) {
          put2(dst + r * ls + col, v0, v1);
        });
      };
    };
    gemm_b16<3, 4, kSA, kSBT>(nullptr, 0, stages, n, n, hd, n, op16(q, lh),
                              op16(k, lh), op16(q, lh), op16(k, lh), acc, acc,
                              true, to_st(st));
    __syncthreads();
    // p (softmax; L2: e / esum, with e in place of the scores for s_bar)
    if (kL2)
      l2_rows(st, ls, q2, k2, pb, lp, n, n_real, tau, st, ls, esum);
    else
      softmax_rows(st, ls, pb, lp, n, n_real, tau, st, ls);
    if (kDrop && dr.th_p) {
      // pb = round(pb * mask_p) by the warp that wrote the row; the keep
      // bits stay for p_bar
      __syncwarp();
      const unsigned kp = site_key(dr.seed, kSiteP + hh);
#pragma unroll 1
      for (int r = warp; r < n; r += kWarps) {
        unsigned* words = pbits + 4 * r;
        if (r < n_real)
          keep_bits_row(kp, b, r, n, n_real, dr.th_p, words);
        else if (lane < 4)
          words[lane] = 0;
        __syncwarp();
#pragma unroll 1
        for (int c = lane; c < n; c += 32)
          pb[r * lp + c] = from_f<bf16>(
              to_f(pb[r * lp + c]) * (kept(words, c) ? dr.sc_p : 0.0f));
      }
    }
    // ctx = round(p v) for Wout_bar (q is rounded to q tau below, once the
    // scores have read it: softmax; L2's k_bar takes q as it is)
    if (!kL2) {
#pragma unroll 1
      for (int i = threadIdx.x; i < n * hd; i += kThreads) {
        bf16* e = q + (i / hd) * lh + i % hd;
        *e = from_f<bf16>(to_f(*e) * tau);
      }
    }
    gemm_b16<3, 4, kSA, kSB>(
        nullptr, 0, stages, n, hd, n, hd, op16(pb, lp), op16(v, lh),
        op16(pb, lp), op16(v, lh), acc, acc, true,
        [&](const TileB16& t, Acc& c, Acc&) {
          each_pair(t, c, [&](int r, int col, float v0, float v1) {
            put_b2(ctx_g + (size_t)r * d + hh * hd + col, v0, v1);
          });
        });
    // cb = round(gda Wout[h*hd:(h+1)*hd, :]^T)
    {
      auto epi = [&](const TileB16& t, Acc& c, Acc&) {
        each_pair(t, c, [&](int r, int col, float v0, float v1) {
          put_b2(cb + r * lh + col, v0, v1);
        });
      };
      const Op16 ob = op16(wout + (size_t)hh * hd * d, d);
      if (cn_smem)
        gemm_b16<3, 4, kSA, kGBT>(ring_a, pl.slot_a, stages, n, hd, d, nb,
                                  o_gda, ob, o_gda, ob, acc, acc, true, epi);
      else
        gemm_b16<3, 4, kGA, kGBT>(ring_a, pl.slot_a, stages, n, hd, d, nb,
                                  o_gda, ob, o_gda, ob, acc, acc, true, epi);
    }
    // v_bar = round(p^T cb)
    gemm_b16<3, 4, kSAT, kSB>(
        nullptr, 0, stages, n, hd, n, hd, op16(pb, lp), op16(cb, lh),
        op16(pb, lp), op16(cb, lh), acc, acc, true,
        [&](const TileB16& t, Acc& c, Acc&) {
          each_pair(t, c, [&](int r, int col, float v0, float v1) {
            put_b2(qkvb_g + (size_t)r * 3 * d + 2 * d + hh * hd + col, v0,
                   v1);
          });
        });
    // p_bar = cb v^T in f32
    gemm_b16<3, 4, kSA, kSBT>(nullptr, 0, stages, n, n, hd, n, op16(cb, lh),
                              op16(v, lh), op16(cb, lh), op16(v, lh), acc,
                              acc, true, to_st(st2));
    __syncthreads();
    // (+ JaSMin) then s_bar (softmax) or round(d2b) (L2) into pb
    const size_t bh = (size_t)b * heads + hh;
#pragma unroll 1
    for (int r = warp; r < n; r += kWarps) {
      float* prow = st2 + r * ls;
      const float* frow = st + r * ls;
      if (r >= n_real) {
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          pb[r * lp + c] = from_f<bf16>(0.0f);
          if (kL2) prow[c] = 0.0f;
        }
        if (kL2 && lane == 0) rsum[r] = 0.0f;
        continue;
      }
      // the f32 p of column c
      const float es = kL2 ? esum[r] : 1.0f;
      auto p_of = [&](int c) { return kL2 ? frow[c] / es : frow[c]; };
      if (kDrop && dr.th_p) {
#pragma unroll 1
        for (int c = lane; c < n_real; c += 32)
          prow[c] *= kept(pbits + 4 * r, c) ? dr.sc_p : 0.0f;
      }
      if (args.g_jas != nullptr) {
        const float* gj = args.g_jas + bh * 5 * n;
        const int* ji = args.jas_idx + bh * 4 * n;
        const float g4 = gj[4 * n + r];
#pragma unroll 1
        for (int c = lane; c < n_real; c += 32) {
          const float pj = to_f(from_f<bf16>(p_of(c)));  // pre-dropout
          const float lo = ((pj >= 1e-12f) + (pj > 1e-12f)) * 0.5f;
          const float hi = ((pj <= 1.0f) + (pj < 1.0f)) * 0.5f;
          float t = g4 * (lo * hi);
          for (int i = 0; i < 4; ++i)
            if (ji[i * n + r] == c) t += gj[i * n + r];
          prow[c] += t;
        }
      }
      float dot = 0.0f;
#pragma unroll 1
      for (int c = lane; c < n_real; c += 32) dot += prow[c] * p_of(c);
      dot = warp_sum(dot);
      if (kL2) {
        // d2b in f32 stays in st2 for the column sums; pb = round(d2b)
        float sum = 0.0f;
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          const float v2 =
              c < n_real ? -tau * frow[c] * ((prow[c] - dot) / es) : 0.0f;
          prow[c] = v2;
          pb[r * lp + c] = from_f<bf16>(v2);
          sum += v2;
        }
        sum = warp_sum(sum);
        if (lane == 0) rsum[r] = sum;
      } else {
#pragma unroll 1
        for (int c = lane; c < n; c += 32)
          pb[r * lp + c] =
              from_f<bf16>(c < n_real ? frow[c] * (prow[c] - dot) : 0.0f);
      }
    }
    if (kL2) {
      // the columns' sums of d2b, each over the rows in order
      __syncthreads();
#pragma unroll 1
      for (int c = threadIdx.x; c < n; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < n; ++r) sum += st2[r * ls + c];
        csum[c] = sum;
      }
    }
    // softmax: q_bar = round(s_bar k tau), k_bar = round(s_bar^T round(q
    // tau)); L2: q_bar = round(2 q rsum - 2 round(d2b) k), k_bar = round(2
    // k csum - 2 round(d2b)^T q)
    gemm_b16<3, 4, kSA, kSB>(
        nullptr, 0, stages, n, hd, n, hd, op16(pb, lp), op16(k, lh),
        op16(pb, lp), op16(k, lh), acc, acc, true,
        [&](const TileB16& t, Acc& c, Acc&) {
          each_pair(t, c, [&](int r, int col, float v0, float v1) {
            if (kL2) {
              v0 = 2.0f * to_f(q[r * lh + col]) * rsum[r] - 2.0f * v0;
              v1 = 2.0f * to_f(q[r * lh + col + 1]) * rsum[r] - 2.0f * v1;
            } else {
              v0 *= tau;
              v1 *= tau;
            }
            put_b2(qkvb_g + (size_t)r * 3 * d + hh * hd + col, v0, v1);
          });
        });
    gemm_b16<3, 4, kSAT, kSB>(
        nullptr, 0, stages, n, hd, n, hd, op16(pb, lp), op16(q, lh),
        op16(pb, lp), op16(q, lh), acc, acc, true,
        [&](const TileB16& t, Acc& c, Acc&) {
          each_pair(t, c, [&](int r, int col, float v0, float v1) {
            if (kL2) {
              v0 = 2.0f * to_f(k[r * lh + col]) * csum[r] - 2.0f * v0;
              v1 = 2.0f * to_f(k[r * lh + col + 1]) * csum[r] - 2.0f * v1;
            }
            put_b2(qkvb_g + (size_t)r * 3 * d + d + hh * hd + col, v0, v1);
          });
        });
  }

  // ---- MLP backward, over dh in chunks of hc ----
  __syncthreads();  // the last head's products have read their operands
  {
    VFB16_PHASE;
    bf16* cnm_g = static_cast<bf16*>(args.cnm) + row0 * d;
    bf16* cnm = cn_smem ? at(pl.cnm) : cnm_g;
    center_norm(x, args.gm, args.bm, cnm, lcn, n, d, n_real);
    if (cn_smem) {
      bf16* gdm = at(pl.gd);
      rows_out(cnm, lcn, cnm_g, d, n, d);
      for (int i = threadIdx.x; i < n * d / 8; i += kThreads) {
        const int r = i / (d / 8), c = (i % (d / 8)) * 8;
        *reinterpret_cast<uint4*>(gdm + r * lcn + c) =
            *reinterpret_cast<const uint4*>(gd_g + (size_t)r * d + c);
      }
    }
  }
#pragma unroll 1
  for (int c0 = 0; c0 < dh; c0 += hc) {
    VFB16_PHASE;
    const bf16* w1 = static_cast<const bf16*>(args.w1);
    const bf16* w2 = static_cast<const bf16*>(args.w2);
    bf16* h_g = static_cast<bf16*>(args.h) + row0 * dh;
    bf16* h1b_g = static_cast<bf16*>(args.h1b) + row0 * dh;
    bf16* cnm = cn_smem ? at(pl.cnm)
                        : static_cast<bf16*>(args.cnm) + row0 * d;
    bf16* gdm = cn_smem ? at(pl.gd) : gd_g;
    bf16* hb = at(pl.hb);
    float* mbs = atf(pl.mbar);  // m_bar
    bf16* ring_m = at(pl.ring_m);
    const int lhb = pl.ld_hb, lmb = pl.ld_mb;
    const Op16 o_cnm = op16(cnm, lcn), o_gdm = op16(gdm, lcn),
               o_hb = op16(hb, lhb);
    Acc1 a1, a2;
    // h1 = cn_m W1[:, c] (kResid: from rh1) and h_bar = gd W2[c, :]^T on
    // the same tiles; h = round(gelu(h1)) (x mask_h), h1_bar = round(h_bar
    // (x mask_h) gelu'(h1)) from registers to the scratch and to hb
    auto epi = [&](const TileB16& t, Acc1& c1, Acc1& c2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= t.cols) continue;
        const int r = t.r0 + gq, col = t.c0 + j * 8 + 2 * tq;
        float m[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
        if (kDrop && dr.th_m)
          keep_pair(site_key(dr.seed, kSiteH), b, r, c0 + col, n_real,
                    dr.th_m, dr.sc_m, m);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
          float hv[2], gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hbar =
                kResid ? c1[0][j][2 * h + e] : c2[0][j][2 * h + e];
            const float h1 =
                !kResid ? c1[0][j][2 * h + e]
                : rr < n_real
                    ? to_f(static_cast<const bf16*>(args.rh1)[(row0 + rr) * dh +
                                                             c0 + col + e])
                    : 0.0f;
            if (kDrop && dr.th_m) {
              hv[e] = to_f(from_f<bf16>(gelu(h1))) * m[h][e];
              gv[e] = hbar * m[h][e] * gelu_grad(h1);
            } else {
              hv[e] = gelu(h1);
              gv[e] = hbar * gelu_grad(h1);
            }
          }
          put_b2(h_g + (size_t)rr * dh + c0 + col, hv[0], hv[1]);
          put_b2(h1b_g + (size_t)rr * dh + c0 + col, gv[0], gv[1]);
          put_b2(hb + rr * lhb + col, gv[0], gv[1]);
        }
      }
    };
    const Op16 o_w1 = op16(w1 + c0, dh), o_w2 = op16(w2 + (size_t)c0 * d, d);
    if (kResid) {
      if (cn_smem)
        gemm_b16<1, 4, kSA, kGBT>(ring_m, pl.slot_m, stages, n, hc, d, nb,
                                  o_gdm, o_w2, o_gdm, o_w2, a1, a1, true, epi);
      else
        gemm_b16<1, 4, kGA, kGBT>(ring_m, pl.slot_m, stages, n, hc, d, nb,
                                  o_gdm, o_w2, o_gdm, o_w2, a1, a1, true, epi);
    } else {
      if (cn_smem)
        gemm_b16<1, 4, kSA, kGB, kGBT>(ring_m, pl.slot_m, stages, n, hc, d,
                                       nb, o_cnm, o_w1, o_gdm, o_w2, a1, a2,
                                       true, epi);
      else
        gemm_b16<1, 4, kGA, kGB, kGBT>(ring_m, pl.slot_m, stages, n, hc, d,
                                       nb, o_cnm, o_w1, o_gdm, o_w2, a1, a2,
                                       true, epi);
    }
    // m_bar (+)= h1_bar W1[:, c]^T, added in f32 in shared memory
    const bool first = c0 == 0;
    gemm_b16<3, 4, kSA, kGBT>(
        ring_m, pl.slot_m, stages, n, d, hc, nb, o_hb, o_w1, o_hb, o_w1, acc,
        acc, true, [&](const TileB16& t, Acc& c, Acc&) {
          each_pair(t, c, [&](int r, int col, float v0, float v1) {
            float* e = mbs + r * lmb + col;
            if (!first) {
              v0 += e[0];
              v1 += e[1];
            }
            put2(e, v0, v1);
          });
        });
  }

  // ---- a_bar = [q_bar k_bar v_bar] Wqkv^T, one product over 3D ----
  // Its epilogue meets m_bar in shared memory, leaves c_bar = a_bar
  // gamma_a + m_bar gamma_m in its place and sums
  // this tile's columns of the norm partials over its real rows: a_bar
  // cent, a_bar, m_bar cent, m_bar, reduced over the lanes of a column in
  // a fixed order, per row group into `part`.
  VFB16_PHASE;
  float* mbs = atf(pl.mbar);  // m_bar, then c_bar
  const int lmb = pl.ld_mb;
  float* part = atf(pl.part);
  __syncthreads();  // the last chunk's products have read their operands
#pragma unroll 1
  for (int i = threadIdx.x; i < pl.groups_e * 4 * d; i += kThreads)
    part[i] = 0.0f;
  gemm_b16<3, 4, kGA, kGBT>(
      at(pl.ring_e), pl.slot_e, stages, n, d, 3 * d, nb, op16(qkvb_g, 3 * d),
      op16(wqkv, 3 * d), op16(qkvb_g, 3 * d), op16(wqkv, 3 * d), acc, acc,
      true, [&](const TileB16& t, Acc& a, Acc&) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= t.cols) continue;
          const int col = t.c0 + j * 8 + 2 * tq;
          const float ga0 = args.ga[col], ga1 = args.ga[col + 1];
          const float gm0 = args.gm[col], gm1 = args.gm[col + 1];
          float s[4][2] = {};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (i >= t.rows) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = t.r0 + i * 16 + gq + 8 * h;
              float* cr = mbs + r * lmb + col;
              const float av0 = a[i][j][2 * h], av1 = a[i][j][2 * h + 1];
              const float m0 = cr[0], m1 = cr[1];
              if (r < n_real) {
                const float ce0 =
                    (to_f(x[(size_t)r * d + col]) - mean[r]) * scale;
                const float ce1 =
                    (to_f(x[(size_t)r * d + col + 1]) - mean[r]) * scale;
                s[0][0] += av0 * ce0;
                s[0][1] += av1 * ce1;
                s[1][0] += av0;
                s[1][1] += av1;
                s[2][0] += m0 * ce0;
                s[2][1] += m1 * ce1;
                s[3][0] += m0;
                s[3][1] += m1;
              }
              put2(cr, av0 * ga0 + m0 * gm0, av1 * ga1 + m1 * gm1);
            }
          }
#pragma unroll
          for (int qn = 0; qn < 4; ++qn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float u = s[qn][e];
              u += __shfl_xor_sync(0xffffffffu, u, 4);
              u += __shfl_xor_sync(0xffffffffu, u, 8);
              u += __shfl_xor_sync(0xffffffffu, u, 16);
              if (gq == 0) part[((size_t)t.rg * 4 + qn) * d + col + e] = u;
            }
        }
      });
  __syncthreads();

  // norm partials of this image: (ga, ba, gm, bm) sums over real rows,
  // the row groups added in order
  float* np = args.npart + (size_t)b * (kL2 ? 8 : 4) * d;
#pragma unroll 1
  for (int i = threadIdx.x; i < 4 * d; i += kThreads) {
    float sum = 0.0f;
    for (int gg = 0; gg < pl.groups_e; ++gg)
      sum += part[((size_t)gg * 4 + i / d) * d + i % d];
    np[i] = sum;
  }
  if (kL2) {
    // bias partials: qkv_bias_bar over [q_bar k_bar v_bar], out_bias_bar
    // over gd (both written above)
#pragma unroll 1
    for (int c = threadIdx.x; c < 3 * d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r)
        sum += to_f(qkvb_g[(size_t)r * 3 * d + c]);
      np[4 * d + c] = sum;
    }
#pragma unroll 1
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += to_f(gd_g[(size_t)r * d + c]);
      np[7 * d + c] = sum;
    }
  }

  // x_bar = d/(d-1) (c_bar - mean(c_bar)); padded rows are zeros
  bf16* xb = static_cast<bf16*>(args.xbar) + row0 * d;
#pragma unroll 1
  for (int r = warp; r < n; r += kWarps) {
    const float* cr = mbs + r * lmb;
    float sum = 0.0f;
#pragma unroll 1
    for (int c = lane; c < d; c += 32) sum += cr[c];
    const float cm = warp_sum(sum) / d;
#pragma unroll 1
    for (int c = lane; c < d; c += 32)
      xb[(size_t)r * d + c] =
          from_f<bf16>(r < n_real ? scale * (cr[c] - cm) : 0.0f);
  }
}

#undef VFB16_PHASE
#undef VFB16_FRESH

// ---- the f32 instance: vfb_rows_f32 ----
// The rows kernel's chain in f32 with every product on mac::gemm_tf32
// (split_tf32.cuh), as vf_kernel_f32 (vector_field.cu) takes the forward:
// operands in device memory staged by 16-byte cp.async through a ring of
// K slices and split once where they land, register tiles of up to 48 x
// 32 a warp on mma.sync in three passes, epilogues from registers. Each
// weight slice is staged once per CTA for the 12 warps. It writes the same
// scratch operands (cn_m, cn_a, gd, gd2, ctx, h, h1_bar, [q_bar k_bar
// v_bar]) for vfb_wgrad_tf32, in f32 (no rounding beyond the products'),
// and the same per-image norm (and L2 bias) partials.
//
// Where each operand lives. cn_m, cn_a, gd (and gd2) go to their scratch
// in device memory first and are staged from there (they stay in L2);
// the head's q | k | v | cb go to a per-image workspace (n_pad x 4 hd
// floats), with the head's f32 p (L2: e) beside them (n_pad x n_pad),
// read once by the row pass of s_bar. In shared memory: the row means;
// the ring; m_bar, f32 [n_pad, D], summed over the dh chunks (acc_smem;
// else in the workspace); and one region used by the MLP chunk (h1 and
// h_bar in f32, then h1_bar's big and small planes in their place), by
// each head (the scores in f32, the softmax in place, p's planes with
// mask_p; after v_bar, p_bar in f32, then s_bar's planes in its place; the
// keep bits of the head's map; L2's five vectors) and last by a_bar (f32
// [n_pad, D]), which meets m_bar in the norm partials and x_bar. The
// products the forward also takes (qkv, h1, the scores, ctx) run with the
// forward's K order, so they are bit for bit vf_kernel_f32's.
//
// Plan (vfb_plan_f32; kernels/vector_field_bwd.py::f32_bwd_plan repeats
// it): the widest chunk, then the widest column block, m_bar in shared
// memory where that still fits 227 KB (at the CIFAR shape it does not: as
// in vf_kernel_f32, that plan beat those that keep m_bar in shared memory
// on the card). Planes are n_pad + 4 floats a row: a
// fragment row read 4 g + t (p v, s_bar k) hits 32 banks; the transposed
// reads of p^T cb and s_bar^T q (8 g + ... by t) put at most two lanes on
// a bank. Which shapes take one CTA stays vfb_plan's decision.
struct PlanB32 {
  size_t mean, ring, macc, reg, p0, p1, pbig, psmall, pbits, l2, abar, total;
  size_t ws_pf, ws_macc, ws;  // floats of one image's workspace
  int slot, ld_acc, ld_h, ld_p, ld_ws;
};

__host__ __device__ inline PlanB32 make_plan_b32(int n, int d, int hd,
                                                 int hc, int nb, int acc_smem,
                                                 bool drop, bool l2) {
  PlanB32 p;
  p.slot = mac::ring_slot(n, nb);
  p.ld_acc = d + 8;
  p.ld_h = hc + 4;
  p.ld_p = n + 4;
  p.ld_ws = 4 * hd;
  size_t off = 0;
  p.l2 = off;    // first: its address is a constant
  if (l2) off += 5 * align128((size_t)n * 4);
  p.mean = off;  off += align128((size_t)n * 4);
  p.ring = off;  off += align128((size_t)2 * mac::kStages * p.slot * 4);
  p.macc = off;
  if (acc_smem) off += align128((size_t)n * p.ld_acc * 4);
  p.reg = off;
  const size_t fh = align128((size_t)n * p.ld_h * 4);
  const size_t fp = align128((size_t)n * p.ld_p * 4);
  p.p0 = off;
  p.p1 = off + fh;
  p.pbig = off;
  p.psmall = off + fp;
  size_t a = off + 2 * fp;
  p.pbits = a;
  if (drop) a += align128((size_t)n * 4 * 4);
  p.abar = off;
  size_t e = off + 2 * fh;
  if (a > e) e = a;
  const size_t ab = off + align128((size_t)n * p.ld_acc * 4);
  p.total = ab > e ? ab : e;
  p.ws_pf = (size_t)n * p.ld_ws;
  p.ws_macc = p.ws_pf + (size_t)n * n;
  p.ws = p.ws_macc + (acc_smem ? 0 : (size_t)n * d);
  return p;
}


// vfb_rows_f32 runs at the register limit (168 a thread under 384
// threads): the products' register tiles take most of it. Three things
// keep it from spilling. Loops outside the products are not unrolled
// (#pragma unroll 1; unrolled, they hold many loads at once). The sizes
// are made opaque to the optimizer before each product of a head and at
// the top of each chunk (VFB_FRESH_*), so that nothing derived from them
// is hoisted into registers that live across the products. And L2's
// helpers below are vector_field.cu's sq_rows and l2_rows (p in place of
// the scores) with their loops not unrolled; the same arithmetic.
#define VFB_FRESH_MLP                                                    \
  asm volatile("" : "+r"(n), "+r"(n_real), "+r"(d), "+r"(hc), "+r"(dh), \
               "+r"(nb), "+r"(lh))
#define VFB_FRESH_ATT                                                    \
  asm volatile("" : "+r"(n), "+r"(n_real), "+r"(d), "+r"(hd), "+r"(nb), \
               "+r"(lw), "+r"(lp))

__device__ void sq_rows_rolled(const float* a, int lda, int n, int w,
                               float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.0f;
#pragma unroll 1
    for (int c = lane; c < w; c += 32) {
      const float v = a[r * lda + c];
      sum += v * v;
    }
    sum = warp_sum(sum);
    if (lane == 0) out[r] = sum;
  }
}
__device__ void l2_rows_rolled(float* s, int lds, const float* q2,
                               const float* k2, int n, int n_real, float tau,
                               float* ef, int ldef, float* esum) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = warp; r < n; r += kWarps) {
    float* row = s + r * lds;
    const float qr = q2[r];
    auto e_of = [&](int c) {
      return expf(-(qr + k2[c] - 2.0f * row[c]) * tau);
    };
    float sum = 0.0f;
#pragma unroll 1
    for (int c = lane; c < n_real; c += 32) sum += e_of(c);
    sum = warp_sum(sum) + 1e-8f;
    if (lane == 0) esum[r] = sum;
#pragma unroll 1
    for (int c = lane; c < n; c += 32) {
      const float e = c < n_real ? e_of(c) : 0.0f;
      row[c] = e / sum;
      ef[r * ldef + c] = e;
    }
  }
}

template <bool kDrop, bool kL2, bool kResid>
__global__ void __launch_bounds__(kThreads, 1) vfb_rows_f32(Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  using mac::gemm_tf32;
  using mac::kAPlanes;
  using mac::kAPlanesT;
  using mac::kAStaged;
  using mac::op_b;
  using mac::put2;
  int n = args.n_pad, n_real = args.n_real, d = args.d;
  int hd = d / args.heads, dh = args.dh, hc = args.hc, nb = args.nb;
  const int heads = args.heads, acc_smem = args.acc_smem;
  const PlanB32 pl =
      make_plan_b32(n, d, hd, hc, nb, acc_smem, kDrop, kL2);
  const Drop& dr = args.drop;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * n;
  const float tau = args.qk_scale;
  const float* x = static_cast<const float*>(args.x) + row0 * d;
  const float* g = static_cast<const float*>(args.g) + row0 * d;
  const float* wqkv = static_cast<const float*>(args.wqkv);
  const float* wout = static_cast<const float*>(args.wout);
  const float* w1 = static_cast<const float*>(args.w1);
  const float* w2 = static_cast<const float*>(args.w2);
  float* cnm_g = static_cast<float*>(args.cnm) + row0 * d;
  float* cna_g = static_cast<float*>(args.cna) + row0 * d;
  float* gd_g = static_cast<float*>(args.gd) + row0 * d;
  // the attention's operand: gd, or with dropout gd2
  float* gda = kDrop ? static_cast<float*>(args.gd2) + row0 * d : gd_g;
  float* ctx_g = static_cast<float*>(args.ctx) + row0 * d;
  float* h_g = static_cast<float*>(args.h) + row0 * dh;
  float* h1b_g = static_cast<float*>(args.h1b) + row0 * dh;
  float* qkvb_g = static_cast<float*>(args.qkvb) + row0 * 3 * d;
  float* ws = args.ws + (size_t)b * pl.ws;  // q | k | v | cb of the head
  float* pfw = ws + pl.ws_pf;               // its f32 p (L2: e)
  int lw = pl.ld_ws, lh = pl.ld_h, lp = pl.ld_p;
  float* mb = acc_smem ? reinterpret_cast<float*>(smem + pl.macc)
                       : ws + pl.ws_macc;   // m_bar
  const int lm = acc_smem ? pl.ld_acc : d;
  float* mean = reinterpret_cast<float*>(smem + pl.mean);
  const mac::Ring ring{reinterpret_cast<unsigned*>(smem + pl.ring), pl.slot};
  const float scale = (float)((double)d / (d - 1.0));
  auto staged = [](const float* p, int ld) {
    return mac::OpA{p, ld, nullptr, nullptr};
  };

  // gd = g * scaler (x mask_mo), gd2 = g * scaler * mask_ao; rows >=
  // n_real are zeros
  if (kDrop) {
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
          const float gv = r < n_real ? g[(size_t)r * d + c] * args.scaler
                                      : 0.0f;
          gd_g[(size_t)r * d + c] = gv * mo[j];
          gda[(size_t)r * d + c] = gv * ma[j];
        }
      }
  } else {
    for (int r = warp; r < n; r += kWarps)
      for (int c = lane; c < d; c += 32)
        gd_g[(size_t)r * d + c] =
            r < n_real ? g[(size_t)r * d + c] * args.scaler : 0.0f;
  }

  // ---- MLP backward, over dh in chunks of hc ----
  center_norm(x, args.gm, args.bm, cnm_g, d, n, d, n_real, mean);
  float* h1 = reinterpret_cast<float*>(smem + pl.p0);   // then big
  float* hbar = reinterpret_cast<float*>(smem + pl.p1); // then small
  unsigned* hbig = reinterpret_cast<unsigned*>(h1);
  unsigned* hsmall = reinterpret_cast<unsigned*>(hbar);
  const mac::OpA hpl{nullptr, lh, hbig, hsmall};
  for (int c0 = 0; c0 < dh; c0 += hc) {
    VFB_FRESH_MLP;
    if (kResid) {
      // h1 of the chunk from rh1; padded rows read as zeros
      const float* rh1 = static_cast<const float*>(args.rh1) + row0 * dh + c0;
      __syncthreads();  // the last chunk's m_bar product has read its planes
      for (int i = threadIdx.x; i < n * hc; i += kThreads) {
        const int r = i / hc, c = i % hc;
        h1[r * lh + c] = r < n_real ? rh1[(size_t)r * dh + c] : 0.0f;
      }
    } else {
      gemm_tf32<kAStaged, false>(
          ring, n, hc, d, nb, staged(cnm_g, d), op_b(w1 + c0, dh),
          [&](int r, int c, float v0, float v1) {
            h1[r * lh + c] = v0;
            h1[r * lh + c + 1] = v1;
          });
    }
    // h_bar = gd W2[c, :]^T
    gemm_tf32<kAStaged, true>(
        ring, n, hc, d, nb, staged(gd_g, d), op_b(w2 + (size_t)c0 * d, d),
        [&](int r, int c, float v0, float v1) {
          hbar[r * lh + c] = v0;
          hbar[r * lh + c + 1] = v1;
        });
    __syncthreads();
    // h = gelu(h1) (x mask_h) and h1_bar = h_bar (x mask_h) gelu'(h1) to
    // the scratch; h1_bar's planes in place of h1 and h_bar
    if (kDrop && dr.th_m) {
      const unsigned kh = site_key(dr.seed, kSiteH);
      for (int r = warp; r < n; r += kWarps)
        for (int gg = lane; 4 * gg < hc; gg += 32) {
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (r < n_real)
            keep4(kh, b, r, (c0 >> 2) + gg, dh, dr.th_m, dr.sc_m, m);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 4 * gg + j, i = r * lh + c;
            const float hv = h1[i];
            const float v = hbar[i] * m[j] * gelu_grad(hv);
            h_g[(size_t)r * dh + c0 + c] = gelu(hv) * m[j];
            h1b_g[(size_t)r * dh + c0 + c] = v;
            split_bits(v, hbig[i], hsmall[i]);
          }
        }
    } else {
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < hc; c += 32) {
          const int i = r * lh + c;
          const float hv = h1[i];
          const float v = hbar[i] * gelu_grad(hv);
          h_g[(size_t)r * dh + c0 + c] = gelu(hv);
          h1b_g[(size_t)r * dh + c0 + c] = v;
          split_bits(v, hbig[i], hsmall[i]);
        }
    }
    // m_bar (+)= h1_bar W1[:, c]^T
    const bool first = c0 == 0;
    gemm_tf32<kAPlanes, true>(
        ring, n, d, hc, nb, hpl, op_b(w1 + c0, dh),
        [&](int r, int c, float v0, float v1) {
          float* a = mb + r * lm + c;
          if (acc_smem && !first) {
            v0 += a[0];
            v1 += a[1];
          }
          put2(a, v0, v1);
        },
        acc_smem || first ? nullptr : mb, lm);
  }

  // ---- attention backward, head by head ----
  center_norm(x, args.ga, args.ba, cna_g, d, n, d, n_real);
  float* sf = reinterpret_cast<float*>(smem + pl.pbig);  // scores, p, p_bar
  unsigned* pbig = reinterpret_cast<unsigned*>(sf);
  unsigned* psmall = reinterpret_cast<unsigned*>(smem + pl.psmall);
  const mac::OpA ppl{nullptr, lp, pbig, psmall};
  unsigned* pbits = reinterpret_cast<unsigned*>(smem + pl.pbits);
  float* qw = ws;
  float* kw = ws + hd;
  float* vw = ws + 2 * hd;
  float* cbw = ws + 3 * hd;
  for (int hh = 0; hh < heads; ++hh) {
    VFB_FRESH_ATT;
    // kL2: q2, k2, esum, then the rows' and the columns' sums of d2b
    const size_t nv = align128((size_t)n * 4) / 4;
    float* q2 = reinterpret_cast<float*>(smem + pl.l2);
    float *k2 = q2 + nv, *esum = q2 + 2 * nv, *rsum = q2 + 3 * nv,
          *csum = q2 + 4 * nv;
    if (kResid) {
      // q, k and v of the head from rqkv; padded rows read as zeros
      const float* rq =
          static_cast<const float*>(args.rqkv) + row0 * 3 * d + hh * hd;
      __syncthreads();  // the last head's products have read the workspace
      for (int i = threadIdx.x; i < n * hd; i += kThreads) {
        const int r = i / hd, c = i % hd;
        for (int j = 0; j < 3; ++j)
          ws[(size_t)r * lw + j * hd + c] =
              r < n_real ? rq[(size_t)r * 3 * d + j * d + c] : 0.0f;
      }
    } else {
      // q | k | v in one product (padded value rows zeroed so that 0 * NaN
      // cannot reach p @ v)
      VFB_FRESH_ATT;
      gemm_tf32<kAStaged, false>(
          ring, n, 3 * hd, d, nb, staged(cna_g, d),
          op_b(wqkv + hh * hd, 3 * d, 1.0f, hd, d),
          [&](int r, int c, float v0, float v1) {
            const bool zero = c >= 2 * hd && r >= n_real;
            put2(ws + (size_t)r * lw + c, zero ? 0.0f : v0, zero ? 0.0f : v1);
          });
    }
    if (kL2) {
      // + the bias (not on the zeroed value rows), in a pass: in the
      // epilogue its loads spilled registers
      __syncthreads();
      for (int i = threadIdx.x; i < n * 3 * hd; i += kThreads) {
        const int r = i / (3 * hd), c = i % (3 * hd), j = c / hd;
        if (j < 2 || r < n_real)
          ws[(size_t)r * lw + c] += args.qkv_bias[j * d + hh * hd + c % hd];
      }
      __syncthreads();
      sq_rows_rolled(qw, lw, n, hd, q2);
      sq_rows_rolled(kw, lw, n, hd, k2);
    }
    VFB_FRESH_ATT;
    gemm_tf32<kAStaged, true>(
        ring, n, n, hd, nb, staged(qw, lw), op_b(kw, lw),
        [&](int r, int c, float v0, float v1) {
          sf[r * lp + c] = v0;
          sf[r * lp + c + 1] = v1;
        });
    __syncthreads();
    // the f32 p in place (L2: e / esum, and e to the workspace), p (softmax)
    // to the workspace
    if (kL2)
      l2_rows_rolled(sf, lp, q2, k2, n, n_real, tau, pfw, n, esum);
    else
      softmax_rows(sf, lp, sf, lp, n, n_real, tau, pfw, n);
    __syncthreads();
    // p (x mask_p) to its planes in place; the keep bits stay for p_bar
    if (kDrop && dr.th_p) {
      const unsigned kp = site_key(dr.seed, kSiteP + hh);
      for (int r = warp; r < n; r += kWarps) {
        unsigned* words = pbits + 4 * r;
        if (r < n_real)
          keep_bits_row(kp, b, r, n, n_real, dr.th_p, words);
        else if (lane < 4)
          words[lane] = 0;
        __syncwarp();
        for (int c = lane; c < n; c += 32) {
          const int i = r * lp + c;
          split_bits(sf[i] * (kept(words, c) ? dr.sc_p : 0.0f), pbig[i],
                     psmall[i]);
        }
      }
    } else {
      for (int r = warp; r < n; r += kWarps)
        for (int c = lane; c < n; c += 32) {
          const int i = r * lp + c;
          split_bits(sf[i], pbig[i], psmall[i]);
        }
    }
    // ctx = p v (for Wout_bar)
    VFB_FRESH_ATT;
    gemm_tf32<kAPlanes, false>(
        ring, n, hd, n, nb, ppl, op_b(vw, lw),
        [&](int r, int c, float v0, float v1) {
          put2(ctx_g + (size_t)r * d + hh * hd + c, v0, v1);
        });
    // cb = gd Wout[h*hd:(h+1)*hd, :]^T
    VFB_FRESH_ATT;
    gemm_tf32<kAStaged, true>(
        ring, n, hd, d, nb, staged(gda, d), op_b(wout + (size_t)hh * hd * d, d),
        [&](int r, int c, float v0, float v1) {
          put2(cbw + (size_t)r * lw + c, v0, v1);
        });
    // v_bar = p^T cb
    VFB_FRESH_ATT;
    gemm_tf32<kAPlanesT, false>(
        ring, n, hd, n, nb, ppl, op_b(cbw, lw),
        [&](int r, int c, float v0, float v1) {
          put2(qkvb_g + (size_t)r * 3 * d + 2 * d + hh * hd + c, v0, v1);
        });
    // p_bar = cb v^T, in f32 where p's planes were
    VFB_FRESH_ATT;
    gemm_tf32<kAStaged, true>(
        ring, n, n, hd, nb, staged(cbw, lw), op_b(vw, lw),
        [&](int r, int c, float v0, float v1) {
          sf[r * lp + c] = v0;
          sf[r * lp + c + 1] = v1;
        });
    __syncthreads();
    // (+ JaSMin) then s_bar (softmax; its planes in place) or d2b (L2, f32
    // in place for the column sums)
    const size_t bh = (size_t)b * heads + hh;
#pragma unroll 1
    for (int r = warp; r < n; r += kWarps) {
      float* prow = sf + r * lp;
      const float* frow = pfw + (size_t)r * n;
      if (r >= n_real) {
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          pbig[r * lp + c] = 0u;
          psmall[r * lp + c] = 0u;
        }
        if (kL2 && lane == 0) rsum[r] = 0.0f;
        continue;
      }
      // the f32 p of column c
      const float es = kL2 ? esum[r] : 1.0f;
      auto p_of = [&](int c) { return kL2 ? frow[c] / es : frow[c]; };
      if (kDrop && dr.th_p) {
#pragma unroll 1
        for (int c = lane; c < n_real; c += 32)
          prow[c] *= kept(pbits + 4 * r, c) ? dr.sc_p : 0.0f;
      }
      if (args.g_jas != nullptr) {
        const float* gj = args.g_jas + bh * 5 * n;
        const int* ji = args.jas_idx + bh * 4 * n;
        const float g4 = gj[4 * n + r];
#pragma unroll 1
        for (int c = lane; c < n_real; c += 32) {
          const float pj = p_of(c);  // pre-dropout
          const float lo = ((pj >= 1e-12f) + (pj > 1e-12f)) * 0.5f;
          const float hi = ((pj <= 1.0f) + (pj < 1.0f)) * 0.5f;
          float t = g4 * (lo * hi);
#pragma unroll 1
          for (int i = 0; i < 4; ++i)
            if (ji[i * n + r] == c) t += gj[i * n + r];
          prow[c] += t;
        }
      }
      float dot = 0.0f;
#pragma unroll 1
      for (int c = lane; c < n_real; c += 32) dot += prow[c] * p_of(c);
      dot = warp_sum(dot);
      if (kL2) {
        float sum = 0.0f;
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          const float v2 = c < n_real
              ? -tau * frow[c] * ((prow[c] - dot) / es) : 0.0f;
          prow[c] = v2;
          sum += v2;
        }
        sum = warp_sum(sum);
        if (lane == 0) rsum[r] = sum;
      } else {
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          const float v = c < n_real ? frow[c] * (prow[c] - dot) : 0.0f;
          split_bits(v, pbig[r * lp + c], psmall[r * lp + c]);
        }
      }
    }
    __syncthreads();
    if (kL2) {
      // the columns' sums of d2b, each over the rows in order; then d2b's
      // planes in place
#pragma unroll 1
      for (int c = threadIdx.x; c < n; c += kThreads) {
        float sum = 0.0f;
#pragma unroll 1
        for (int r = 0; r < n; ++r) sum += sf[r * lp + c];
        csum[c] = sum;
      }
      __syncthreads();
#pragma unroll 1
      for (int r = warp; r < n; r += kWarps)
#pragma unroll 1
        for (int c = lane; c < n; c += 32) {
          const int i = r * lp + c;
          split_bits(sf[i], pbig[i], psmall[i]);
        }
    }
    // softmax: q_bar = s_bar k tau, k_bar = s_bar^T (q tau); L2 (the
    // products first, then a pass): q_bar = 2 q rsum - 2 d2b k, k_bar =
    // 2 k csum - 2 d2b^T q
    float* qbar = qkvb_g + hh * hd;
    float* kbar = qkvb_g + d + hh * hd;
    VFB_FRESH_ATT;
    gemm_tf32<kAPlanes, false>(
        ring, n, hd, n, nb, ppl, op_b(kw, lw),
        [&](int r, int c, float v0, float v1) {
          const float s = kL2 ? 1.0f : tau;
          put2(qbar + (size_t)r * 3 * d + c, v0 * s, v1 * s);
        });
    VFB_FRESH_ATT;
    gemm_tf32<kAPlanesT, false>(
        ring, n, hd, n, nb, ppl, op_b(qw, lw, kL2 ? 1.0f : tau),
        [&](int r, int c, float v0, float v1) {
          put2(kbar + (size_t)r * 3 * d + c, v0, v1);
        });
    if (kL2) {
      __syncthreads();
#pragma unroll 1
      for (int i = threadIdx.x; i < n * hd; i += kThreads) {
        const int r = i / hd, c = i % hd;
        float* qb = qbar + (size_t)r * 3 * d + c;
        float* kb = kbar + (size_t)r * 3 * d + c;
        *qb = 2.0f * qw[(size_t)r * lw + c] * rsum[r] - 2.0f * *qb;
        *kb = 2.0f * kw[(size_t)r * lw + c] * csum[r] - 2.0f * *kb;
      }
    }
  }

  // a_bar = [q_bar k_bar v_bar] Wqkv^T, one product over 3D
  VFB_FRESH_ATT;
  float* abar = reinterpret_cast<float*>(smem + pl.abar);
  gemm_tf32<kAStaged, true>(
      ring, n, d, 3 * d, nb, staged(qkvb_g, 3 * d), op_b(wqkv, 3 * d),
      [&](int r, int c, float v0, float v1) {
        abar[r * pl.ld_acc + c] = v0;
        abar[r * pl.ld_acc + c + 1] = v1;
      });
  __syncthreads();

  // norm partials of this image: (ga, ba, gm, bm) sums over real rows
  float* np = args.npart + (size_t)b * (kL2 ? 8 : 4) * d;
  if (kL2) {
    // bias partials: qkv_bias_bar over [q_bar k_bar v_bar], out_bias_bar
    // over gd (both written above)
    for (int c = threadIdx.x; c < 3 * d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += qkvb_g[(size_t)r * 3 * d + c];
      np[4 * d + c] = sum;
    }
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < n_real; ++r) sum += gd_g[(size_t)r * d + c];
      np[7 * d + c] = sum;
    }
  }
  const int la = pl.ld_acc;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sa1 = 0.0f, sa0 = 0.0f, sm1 = 0.0f, sm0 = 0.0f;
    for (int r = 0; r < n_real; ++r) {
      const float cent = (x[(size_t)r * d + c] - mean[r]) * scale;
      const float a = abar[r * la + c];
      const float m = mb[r * lm + c];
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
  float* xb = static_cast<float*>(args.xbar) + row0 * d;
  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32)
      sum += abar[r * la + c] * args.ga[c] + mb[r * lm + c] * args.gm[c];
    const float cm = warp_sum(sum) / d;
    for (int c = lane; c < d; c += 32) {
      const float cbar =
          abar[r * la + c] * args.ga[c] + mb[r * lm + c] * args.gm[c];
      xb[(size_t)r * d + c] = r < n_real ? scale * (cbar - cm) : 0.0f;
    }
  }
}

#undef VFB_FRESH_MLP
#undef VFB_FRESH_ATT

// vfb_rows_f32's plan (see PlanB32): the widest MLP chunk, then the
// widest column block, with m_bar in shared memory where it still fits,
// else in the workspace. Returns false when none fits.
inline bool plan_b32(int n, int d, int hd, int dh, bool drop, bool l2,
                     int* acc_smem, int* hc, int* nb, PlanB32* out) {
  for (int c : kChunks) {
    if (dh % c) continue;
    for (int bl : mac::kBlocksF32) {
      if (!mac::block_ok(n, bl)) continue;
      for (int as = 1; as >= 0; --as) {
        const PlanB32 p = make_plan_b32(n, d, hd, c, bl, as, drop, l2);
        if (p.total <= (size_t)kMaxSmem) {
          *acc_smem = as;
          *hc = c;
          *nb = bl;
          *out = p;
          return true;
        }
      }
    }
  }
  return false;
}

// vfb_rows_f32's and vfb_rows_bf16's launches so far (chip_smoke.py
// holds the counts against the route's)
unsigned long long rows_f32_launches = 0, rows_bf16_launches = 0;

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

// ---- the bf16 weight products: vfb_wgrad_wgmma ----
// Replaces the weight accumulation of the TPU kernels: _vf_bwd_kernel's
// (odevit_tpu/kernels/vector_field_bwd.py:214, :223, :323, :334),
// _mlp_bwd_kernel's and _attn_bwd_kernel's (:409, :421, :548, :556) and
// _macaron_bwd_kernel's (odevit_tpu/kernels/macaron.py:278, :285, :336,
// :373), which the TPU sums with += across its sequential grid. Every
// bf16 backward of the port runs it: the one-CTA, tiled, key-tiled and
// split backwards and both Macaron backwards.
//
// Bound. Each product is 2 R M N operations on R (M + N) bf16 operands:
// at the training shapes (R = 13,312 to 163,840 rows, M and N 192 to
// 3,072) 30 to 270 GFLOP a launch against 0.1 to 0.5 GB, operations
// bound on the tensor cores (CIFAR, D=192: bytes bound).
//
// Design. Both operands are MN-major in device memory (A [R, M] and
// G [R, N] are contiguous along M and N, not along K = R), which bf16
// wgmma takes through the transpose bits of its descriptors. Blocks
// (blockIdx.x) are output tiles of a fixed set, chosen per problem for
// the fewer padded elements: 128 x 128 (two consumer warpgroups over M;
// multiples of 128 such as 768, 2,304, 3,072) or 64 x 192 (over N: 128
// and 64 columns; D = 192 and 576). blockIdx.y is a slice of rows; the
// slice's tiles launch next to each other, so its rows of A and G are
// read from L2 while they walk them together. A producer warp keeps a
// ring of kWbStages stages in flight by TMA: four 64 x 64 boxes (128
// bytes wide, 128-byte swizzle) of 64 rows each, zeros past the matrix,
// so ragged M, N and slice ends need no masks. Each consumer warpgroup
// issues one m64n64k16 wgmma per 64-column atom of its tile (the
// descriptors never span two swizzle atoms), keeps one stage in flight
// and frees the one before. The tensor cores do not round their own
// accumulation to nearest, so every kWbChunk stages (512 rows) start a
// fresh accumulator, added to an f32 register total. The tile goes out
// through shared memory, 16 bytes a thread, masked at ragged M and N.
// Each CTA writes its own partial; vfb_reduce adds them in a fixed
// order: two runs give the same bits.
constexpr int kWbRows = 64;        // rows (K) of a stage
constexpr int kWbBox = 64;         // columns of a box: 128 bytes of bf16
constexpr int kWbBoxes = 4;        // boxes of a stage
constexpr int kWbBoxBytes = kWbRows * kWbBox * 2;
constexpr int kWbStageBytes = kWbBoxes * kWbBoxBytes;
constexpr int kWbStages = 6;
constexpr int kWbChunk = 8;        // stages summed on a fresh accumulator
constexpr int kWbConsumers = 256;  // two consumer warpgroups
constexpr int kWbThreads = kWbConsumers + 32;  // and the producer warp
constexpr int kWbLdStage = 136;    // f32 staging row (128 + 8)
constexpr int kWbMinSlice = 512;   // rows of a slice at least
constexpr int kWbSms = 132;
constexpr int kWbSmem =
    kWbStages * kWbStageBytes + 1024 + 2 * kWbStages * 8;  // + align, barriers
static_assert(kWbSmem <= 232448, "one CTA's shared memory fits an SM");
static_assert(2 * 64 * kWbLdStage * 4 <= kWbStages * kWbStageBytes,
              "the staged tiles fit the ring");

// The tile of a problem: 0 for 128 x 128, 1 for 64 x 192, the one whose
// tiles cover it with the fewer padded elements (ties to 0).
inline int wb_kind(int m, int n) {
  const long long a0 =
      (long long)((m + 127) / 128) * ((n + 127) / 128) * 128 * 128;
  const long long a1 =
      (long long)((m + 63) / 64) * ((n + 191) / 192) * 64 * 192;
  return a1 < a0 ? 1 : 0;
}

inline int wb_tiles_n(int n, int kind) {
  return kind ? (n + 191) / 192 : (n + 127) / 128;
}

inline int wb_tiles(int m, int n) {
  const int kind = wb_kind(m, n);
  return (kind ? (m + 63) / 64 : (m + 127) / 128) * wb_tiles_n(n, kind);
}

// rows of each of `splits` slices of `rows`, in whole chunks of `step`
inline int slice_rows(int rows, int splits, int step) {
  const int r = (rows + splits - 1) / splits;
  return (r + step - 1) / step * step;
}

// Slices of `rows`: the fewest whose CTAs (one an SM) fill at least 9/10
// of the waves they take on kWbSms SMs, each slice at least kWbMinSlice
// rows in whole steps of `step` (a stage of vfb_wgrad_wgmma, kWbRows; a
// slice of vfb_wgrad_tf32, kTgRows) and none empty; where none does, the
// fullest. Fixed by the shape, so the order of the sums is;
// kernels/vector_field_bwd.py::weight_splits copies it.
inline int wgrad_splits(int rows, const int* ms, const int* ns, int count,
                        int step) {
  long long all = 0;
  for (int i = 0; i < count; ++i) all += wb_tiles(ms[i], ns[i]);
  const int most = imax(1, rows / kWbMinSlice);
  int best = 1;
  long long best_ctas = 0, best_room = 1;
  for (int s = 1; s <= most; ++s) {
    if ((long long)(s - 1) * slice_rows(rows, s, step) >= rows) continue;
    const long long ctas = all * s;
    const long long room = (ctas + kWbSms - 1) / kWbSms * kWbSms;
    if (10 * ctas >= 9 * room) return s;
    if (ctas * best_room > best_ctas * room) {
      best = s;
      best_ctas = ctas;
      best_room = room;
    }
  }
  return best;
}

struct WbParams {
  CUtensorMap a[4], g[4];  // A [R, M], G [R, N] of each problem
  int m[4], n[4], kind[4], tn[4], tiles[4];  // tiles 0: no problem
  size_t out[4];
  size_t total;
  int rows, rows_per_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at column c0, row c1 of `map` into `dst`, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// The descriptor of an MN-major box (rows of K, 128 bytes of M or N each,
// 128-byte swizzle): 8-row groups 1024 bytes apart. An m64 or n64 operand
// is one swizzle atom wide, so the MN stride is never used; both offset
// fields hold 1024.
__device__ __forceinline__ uint64_t wb_desc(const void* box) {
  const uint64_t a = smem_u32(box);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (+)= a b for a 64 x 64 tile, k = 16, both bf16 operands MN-major from
// shared memory, f32 accumulators: d[4 j + 2 h + e] holds row 16 warp +
// lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e; accumulate = 0
// ignores d.
__device__ __forceinline__ void wgmma_m64n64_mn(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One consumer warpgroup's part of a tile: its A box a_box and NB boxes
// of B from b_box on, over `stages` stages of the ring; then its 64 x 64
// NB output tile, staged in the ring (once both warpgroups are done with
// it) and stored 16 bytes a thread at row0, col0 of the m x n problem.
template <int NB>
__device__ __forceinline__ void wb_consume(
    const unsigned char* ring, uint64_t* full, uint64_t* empty, int stages,
    int a_box, int b_box, float* out, int row0, int col0, int m, int n) {
  float acc[NB][32], tot[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = tot[b][i] = 0.0f;
  int held = -1;  // the slot whose products may still read it
  for (int s = 0; s < stages; ++s) {
    const int slot = s % kWbStages;
    mbar_wait(&full[slot], (s / kWbStages) & 1);
    const unsigned char* st = ring + slot * kWbStageBytes;
    const uint64_t da = wb_desc(st + a_box * kWbBoxBytes);
    const uint64_t db = wb_desc(st + b_box * kWbBoxBytes);
    const int fresh = s % kWbChunk == 0;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWbRows / 16; ++kk) {
      // 16 rows of 128 bytes further on
      const uint64_t k_off = (uint64_t)(kk * 16 * 128) >> 4;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_m64n64_mn(acc[b], da + k_off,
                        db + k_off + (uint64_t)(b * (kWbBoxBytes >> 4)),
                        fresh && kk == 0 ? 0 : 1);
    }
    wg_commit();
    if (s % kWbChunk == kWbChunk - 1 || s == stages - 1) {
      wg_wait_all();
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[b][i])::"memory");
      if (held >= 0) mbar_arrive(&empty[held]);
      mbar_arrive(&empty[slot]);
      held = -1;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[b][i] += acc[b][i];
    } else {
      // the stage before this one is done: free its slot
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (held >= 0) mbar_arrive(&empty[held]);
      held = slot;
    }
  }

  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  float* stage =
      reinterpret_cast<float*>(const_cast<unsigned char*>(ring)) +
      wg * 64 * kWbLdStage;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
        const int c = 64 * b + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(&stage[r * kWbLdStage + c]) =
            make_float2(tot[b][4 * j + 2 * h], tot[b][4 * j + 2 * h + 1]);
      }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  constexpr int kPerRow = 16 * NB;  // float4s of a staged row
  for (int i = threadIdx.x % 128; i < 64 * kPerRow; i += 128) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    if (row0 + r < m && col0 + c < n)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * n + col0 + c) =
          *reinterpret_cast<const float4*>(&stage[r * kWbLdStage + c]);
  }
}

// blockIdx.x: an output tile of one problem; blockIdx.y: a slice of rows.
// Threads 0-255: two consumer warpgroups; 256-287: the producer warp.
__global__ void __launch_bounds__(kWbThreads, 1)
vfb_wgrad_wgmma(const __grid_constant__ WbParams p, float* wpart) {
  extern __shared__ unsigned char wb_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wb_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kWbStages * kWbStageBytes);
  uint64_t* empty = full + kWbStages;
  int t = blockIdx.x, pi = 0;
  while (t >= p.tiles[pi]) {
    t -= p.tiles[pi];
    ++pi;
  }
  const int kind = p.kind[pi];
  const int m0 = (t / p.tn[pi]) * (kind ? 64 : 128);
  const int n0 = (t % p.tn[pi]) * (kind ? 192 : 128);
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = imin(p.rows, r_begin + p.rows_per_split);
  const int stages =
      r_end > r_begin ? (r_end - r_begin + kWbRows - 1) / kWbRows : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWbStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWbConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWbConsumers) {
    // the producer: boxes 0..na-1 of A (columns m0, m0 + 64), the rest of
    // G (n0, n0 + 64, ...), 64 rows from the stage's first
    if (threadIdx.x == kWbConsumers) {
      const int na = kind ? 1 : 2;
      for (int s = 0; s < stages; ++s) {
        const int slot = s % kWbStages;
        if (s >= kWbStages)
          mbar_wait(&empty[slot], ((s / kWbStages) & 1) ^ 1);
        mbar_expect_tx(&full[slot], kWbStageBytes);
        unsigned char* dst = ring + slot * kWbStageBytes;
        const int row = r_begin + s * kWbRows;
        for (int i = 0; i < kWbBoxes; ++i)
          tma_box(dst + i * kWbBoxBytes, i < na ? &p.a[pi] : &p.g[pi],
                  i < na ? m0 + kWbBox * i : n0 + kWbBox * (i - na), row,
                  &full[slot]);
      }
    }
    return;
  }

  // the consumers: 128 x 128 takes boxes A(m0), A(m0 + 64), G(n0),
  // G(n0 + 64), one A box a warpgroup and both of G; 64 x 192 takes A(m0)
  // and G(n0), G(n0 + 64), G(n0 + 128), the first two for warpgroup 0
  const int wg = threadIdx.x / 128;
  float* out = wpart + blockIdx.y * p.total + p.out[pi];
  if (kind == 0)
    wb_consume<2>(ring, full, empty, stages, wg, 2, out, m0 + 64 * wg, n0,
                  p.m[pi], p.n[pi]);
  else if (wg == 0)
    wb_consume<2>(ring, full, empty, stages, 0, 1, out, m0, n0, p.m[pi],
                  p.n[pi]);
  else
    wb_consume<1>(ring, full, empty, stages, 0, 3, out, m0, n0 + 128,
                  p.m[pi], p.n[pi]);
}

// ---- the f32 weight products: vfb_wgrad_tf32 ----
// Replaces, in f32, the weight accumulation vfb_wgrad_wgmma replaces in
// bf16: _vf_bwd_kernel's (odevit_tpu/kernels/vector_field_bwd.py:214,
// :223, :323, :334), _mlp_bwd_kernel's and _attn_bwd_kernel's. Every f32
// ViTODE backward runs it (one CTA, tiled, key-tiled, L2, both split
// halves); the f32 Macaron backwards take macb::mcb_wgrad_f32.
//
// Bound. As split TF32 (split_tf32.cuh: three TF32 passes, about 21
// bits) each product is 6 R M N TF32 operations on R (M + N) f32
// operands: at the 224 px shape (13,312 rows) 94 GFLOP a launch, 283 of
// passes, 0.571 ms at 495 TFLOP/s against 0.09 ms of bytes. Operations
// bound it at every training shape (CIFAR, D=192: 0.44 against 0.30).
//
// Design. vfb_wgrad_wgmma's grid and tiles on vft_gemm_tf32's pipeline.
// blockIdx.x is an output tile of one problem (128 x 128, or 64 x 192
// where it pads less: wb_kind), blockIdx.y a slice of rows; each CTA
// writes its own partial, which vfb_reduce sums in a fixed order. Rows
// come in slices of kTgRows by 16-byte cp.async into kTgLand landing
// slots, zeros past the CTA's rows, M and N, so ragged edges need no
// other masks. TF32 wgmma takes K-major operands only, and A [R, M] and
// G [R, N] are MN-major: each thread reads its A fragments transposed
// from the landed [rows, M] slice (a row of kTgLdA floats puts a
// fragment's 32 loads on 32 banks) and splits them in registers; G is
// split once into big and small swizzled K-major planes, transposed on
// the way (split_kn4), while the tensor cores multiply the previous
// slice from the other pair of planes. Two warpgroups: m64 x n128 each
// over M (128 x 128) or m64 x n96 each over N (64 x 192). Per k8 step
// three wgmma in mm_f32's order (small x big, big x small, big x big).
// Each slice sums into a fresh accumulator set, added to an f32 register
// total by ordinary adds (the tensor cores truncate their own sums, and
// a CTA's rows run to thousands). The total goes out through shared
// memory, 16 bytes a thread, masked at ragged M and N. The split keeps
// NaN: a NaN operand reaches exactly its row (A) or column (G).
constexpr int kTgRows = 32;       // rows (K) of a slice
constexpr int kTgLand = 3;        // landing slots
constexpr int kTgThreads = 256;   // two warpgroups
constexpr int kTgLdA = 136;       // landed A row: 128 + 8 floats
constexpr int kTgLdG = 196;       // landed G row: 192 + 4 floats
constexpr int kTgPlane = 192 * 128;  // one big or small plane, in bytes
constexpr int kTgLandA = kTgRows * kTgLdA * 4;
constexpr int kTgLandSlot = kTgLandA + kTgRows * kTgLdG * 4;  // A, then G
// two pairs of planes, the landing slots, and room to start the planes on
// a 1024-byte boundary; the staged output tile takes their bytes after
// the last product
constexpr int kTgSmem = 2 * 2 * kTgPlane + kTgLand * kTgLandSlot + 1024;
static_assert(kTgSmem <= 232448, "one CTA's shared memory fits an SM");
static_assert(128 * (128 + 8) * 4 <= kTgSmem - 1024 &&
                  64 * (192 + 8) * 4 <= kTgSmem - 1024,
              "the staged tiles fit");

struct TgParams {
  const float* a[4];
  const float* g[4];  // A [R, M], G [R, N] of each problem
  int m[4], n[4], kind[4], tn[4], tiles[4];  // tiles 0: no problem
  size_t out[4];
  size_t total;
  int rows, rows_per_split;
};

// One CTA's tile: rows r_begin .. r_end of A^T G at m0, n0 of the M x N
// problem into `out`, its partial (row-major, N wide). kKind 0: 128 x 128,
// warpgroup wg over rows 64 wg ..; 1: 64 x 192, over columns 96 wg ...
template <int kKind>
__device__ __forceinline__ void tg_tile(const float* A, const float* G,
                                        int M, int N, int m0, int n0,
                                        int r_begin, int r_end, float* out,
                                        unsigned char* smem) {
  constexpr int TM = kKind ? 64 : 128, TN = kKind ? 192 : 128;
  constexpr int WN = kKind ? 96 : 128;   // a warpgroup's columns
  constexpr int NA = WN / 2;             // its accumulators a thread
  constexpr int A4 = TM / 4, G4 = TN / 4;  // float4s of a landed row
  unsigned char* land0 = smem + 2 * 2 * kTgPlane;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const int slices = imax(0, (r_end - r_begin + kTgRows - 1) / kTgRows);

  // slice s into landing slot s % kTgLand, a commit group each, empty
  // past the last slice
  auto load = [&](int s) {
    if (s < slices) {
      const int row0 = r_begin + s * kTgRows;
      float* la =
          reinterpret_cast<float*>(land0 + (s % kTgLand) * kTgLandSlot);
      float* lg = la + kTgLandA / 4;
#pragma unroll
      for (int j = 0; j < kTgRows * A4 / kTgThreads; ++j) {
        const int i = threadIdx.x + j * kTgThreads;
        const int r = i / A4, c = (i % A4) * 4;
        const bool in = row0 + r < r_end && m0 + c < M;
        vf::cp_async16(la + r * kTgLdA + c,
                       in ? A + (size_t)(row0 + r) * M + m0 + c : A, in);
      }
#pragma unroll
      for (int j = 0; j < kTgRows * G4 / kTgThreads; ++j) {
        const int i = threadIdx.x + j * kTgThreads;
        const int r = i / G4, c = (i % G4) * 4;
        const bool in = row0 + r < r_end && n0 + c < N;
        vf::cp_async16(lg + r * kTgLdG + c,
                       in ? G + (size_t)(row0 + r) * N + n0 + c : G, in);
      }
    }
    vf::cp_async_commit();
  };
  // G of slice s from its landing slot into plane pair s % 2
  auto split_g = [&](int s) {
    const float* lg = reinterpret_cast<const float*>(
        land0 + (s % kTgLand) * kTgLandSlot + kTgLandA);
    unsigned char* big = smem + (s & 1) * 2 * kTgPlane;
#pragma unroll
    for (int j = 0; j < kTgRows * G4 / kTgThreads; ++j) {
      const int i = threadIdx.x + j * kTgThreads;
      const int k = i % kTgRows, n4 = (i / kTgRows) * 4;
      vf::split_kn4(lg + k * kTgLdG + n4, k, n4, big, big + kTgPlane);
    }
    vf::fence_async_shared();
  };
  // this thread's A fragments of slice s, raw: A(m, k) is landed row k,
  // column m; element (r, k) of fragment kk at raw[4 kk + 2 (k >= 4) +
  // (r >= 8)], r and k within it
  const int fm = (kKind ? 0 : 64 * wg) + (warp & 3) * 16 + (lane >> 2);
  const int fk = lane & 3;
  auto load_a = [&](int s, float (&raw)[16]) {
    const float* la = reinterpret_cast<const float*>(
                          land0 + (s % kTgLand) * kTgLandSlot) +
                      fk * kTgLdA + fm;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      raw[4 * kk] = la[8 * kk * kTgLdA];
      raw[4 * kk + 1] = la[8 * kk * kTgLdA + 8];
      raw[4 * kk + 2] = la[(8 * kk + 4) * kTgLdA];
      raw[4 * kk + 3] = la[(8 * kk + 4) * kTgLdA + 8];
    }
  };
  auto mma = [](float (&d)[NA], const unsigned (&a)[4], uint64_t b,
                int accumulate) {
    if constexpr (kKind == 0)
      vf::wgmma_tf32_m64n128_rs(d, a, b, accumulate);
    else
      vf::wgmma_tf32_m64n96_rs(d, a, b, accumulate);
  };

  float tot[NA], acc[NA], raw[16];
  unsigned ahi[4][4], alo[4][4];
#pragma unroll
  for (int i = 0; i < NA; ++i) tot[i] = acc[i] = 0.0f;
  if (slices > 0) {
    for (int s = 0; s < kTgLand; ++s) load(s);
    vf::cp_async_wait<kTgLand - 1>();
    __syncthreads();  // slice 0 has landed
    split_g(0);
    load_a(0, raw);
    vf::split_frags(raw, ahi, alo);
    vf::cp_async_wait<kTgLand - 2>();
    __syncthreads();  // its planes are written, slice 1 has landed
  }
  // this warpgroup's B columns start (64 x 192) 96 wg rows into a plane
  const int b_row = kKind ? 96 * wg : 0;
  for (int s = 0; s < slices; ++s) {
    const unsigned char* pl = smem + (s & 1) * 2 * kTgPlane + b_row * 128;
    const uint64_t b_big = vf::wg_desc(pl);
    const uint64_t b_small = vf::wg_desc(pl + kTgPlane);
    vf::wg_pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vf::wg_pin(ahi[kk]);
      vf::wg_pin(alo[kk]);
    }
    vf::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTgRows / 8; ++kk) {
      const uint64_t step = kk * 32 / 16;  // 32 bytes, in 16-byte units
      mma(acc, alo[kk], b_big + step, kk > 0);
      mma(acc, ahi[kk], b_small + step, 1);
      mma(acc, ahi[kk], b_big + step, 1);
    }
    vf::wg_commit();
    // beside the tensor cores' work: slice s + kTgLand into the landing
    // slot slice s left, slice s + 1's planes and raw A fragments
    load(s + kTgLand);
    if (s + 1 < slices) {
      split_g(s + 1);
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
    for (int i = 0; i < NA; ++i) tot[i] += acc[i];
    if (s + 1 < slices) vf::split_frags(raw, ahi, alo);
    vf::cp_async_wait<kTgLand - 2>();
    // slice s + 1's planes are written, plane pair s % 2 and landing slot
    // (s + 1) % kTgLand are free, slice s + 2 has landed
    __syncthreads();
  }

  // the total through shared memory (free once both warpgroups have left
  // the loop), then 16 bytes a thread, masked at ragged M and N
  __syncthreads();
  constexpr int kLd = TN + 8;
  float* tile = reinterpret_cast<float*>(smem);
  const int col = b_row + 2 * fk;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (fm + 8 * h) * kLd + col + 8 * j) =
          make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
  __syncthreads();
  for (int i = threadIdx.x; i < TM * G4; i += kTgThreads) {
    const int r = i / G4, c = (i % G4) * 4;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const float4*>(tile + r * kLd + c);
  }
}

// blockIdx.x: an output tile of one problem; blockIdx.y: a slice of rows.
__global__ void __launch_bounds__(kTgThreads, 1)
vfb_wgrad_tf32(const __grid_constant__ TgParams p, float* wpart) {
  extern __shared__ unsigned char tg_raw[];
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(tg_raw));
  unsigned char* smem = tg_raw + ((1024 - (base & 1023)) & 1023);
  int t = blockIdx.x, pi = 0;
  while (t >= p.tiles[pi]) {
    t -= p.tiles[pi];
    ++pi;
  }
  const int kind = p.kind[pi];
  const int m0 = (t / p.tn[pi]) * (kind ? 64 : 128);
  const int n0 = (t % p.tn[pi]) * (kind ? 192 : 128);
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = imin(p.rows, r_begin + p.rows_per_split);
  float* out = wpart + blockIdx.y * p.total + p.out[pi];
  if (kind == 0)
    tg_tile<0>(p.a[pi], p.g[pi], p.m[pi], p.n[pi], m0, n0, r_begin, r_end,
               out, smem);
  else
    tg_tile<1>(p.a[pi], p.g[pi], p.m[pi], p.n[pi], m0, n0, r_begin, r_end,
               out, smem);
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

// vfb_wgrad_wgmma and vfb_wgrad_tf32 launches so far in this library
// (vfb_wgrad_launches, vfb_wgrad_tf32_launches)
unsigned long long wgrad_launches = 0, wgrad_tf32_launches = 0;

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a [rows, cols] bf16 (elem 2) or f32 (elem 4) operand, rows ld elements
// apart (0: cols), in boxes of 128 bytes by box_rows, 128-byte swizzle,
// zeros outside; false where the driver refuses it
inline bool encode_operand(CUtensorMap* map, const void* ptr, int rows,
                           int cols, int ld = 0, int box_rows = kWbRows,
                           int elem = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : cols) * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map,
            elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight products of ps (its entries with m > 0; ps.rows and ps.total
// set) over `splits` slices of rows into wpart [splits, ps.total], in bf16
// on vfb_wgrad_wgmma; returns the first CUDA error, else 0. M and N must
// be multiples of 16 and the operands 16-byte aligned: anything else
// returns cudaErrorInvalidValue, nothing else runs.
inline int wgrad_bf16(const Problems& ps, float* wpart, int splits,
                      cudaStream_t st) {
  if (splits < 1 || ps.rows < 1) return (int)cudaErrorInvalidValue;
  WbParams p = {};
  int ntiles = 0;
  for (int i = 0; i < 4; ++i) {
    const Problem& q = ps.p[i];
    if (q.m <= 0) continue;
    if (q.m % 16 || q.n % 16 || !encode_operand(&p.a[i], q.a, ps.rows, q.m) ||
        !encode_operand(&p.g[i], q.g, ps.rows, q.n))
      return (int)cudaErrorInvalidValue;
    p.m[i] = q.m;
    p.n[i] = q.n;
    p.kind[i] = wb_kind(q.m, q.n);
    p.tn[i] = wb_tiles_n(q.n, p.kind[i]);
    p.tiles[i] = wb_tiles(q.m, q.n);
    p.out[i] = q.out;
    ntiles += p.tiles[i];
  }
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  p.total = ps.total;
  p.rows = ps.rows;
  p.rows_per_split = slice_rows(ps.rows, splits, kWbRows);
  cudaError_t err = cudaFuncSetAttribute(
      vfb_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kWbSmem);
  if (err != cudaSuccess) return (int)err;
  vfb_wgrad_wgmma<<<dim3(ntiles, splits), kWbThreads, kWbSmem, st>>>(p,
                                                                    wpart);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++wgrad_launches;
  return (int)err;
}

// The same in f32 on vfb_wgrad_tf32 (every f32 ViTODE backward; the
// Macaron backwards take macb::wgrad_f32), with the same checks.
inline int wgrad_tf32(const Problems& ps, float* wpart, int splits,
                      cudaStream_t st) {
  if (splits < 1 || ps.rows < 1) return (int)cudaErrorInvalidValue;
  TgParams p = {};
  int ntiles = 0;
  for (int i = 0; i < 4; ++i) {
    const Problem& q = ps.p[i];
    if (q.m <= 0) continue;
    if (q.m % 16 || q.n % 16 || (reinterpret_cast<uintptr_t>(q.a) & 15) ||
        (reinterpret_cast<uintptr_t>(q.g) & 15))
      return (int)cudaErrorInvalidValue;
    p.a[i] = static_cast<const float*>(q.a);
    p.g[i] = static_cast<const float*>(q.g);
    p.m[i] = q.m;
    p.n[i] = q.n;
    p.kind[i] = wb_kind(q.m, q.n);
    p.tn[i] = wb_tiles_n(q.n, p.kind[i]);
    p.tiles[i] = wb_tiles(q.m, q.n);
    p.out[i] = q.out;
    ntiles += p.tiles[i];
  }
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  p.total = ps.total;
  p.rows = ps.rows;
  p.rows_per_split = slice_rows(ps.rows, splits, kTgRows);
  cudaError_t err = cudaFuncSetAttribute(
      vfb_wgrad_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kTgSmem);
  if (err != cudaSuccess) return (int)err;
  vfb_wgrad_tf32<<<dim3(ntiles, splits), kTgThreads, kTgSmem, st>>>(p,
                                                                   wpart);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++wgrad_tf32_launches;
  return (int)err;
}

template <typename T>
int wgrad(const Problems& ps, float* wpart, int splits, cudaStream_t st) {
  return sizeof(T) == 2 ? wgrad_bf16(ps, wpart, splits, st)
                        : wgrad_tf32(ps, wpart, splits, st);
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
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    // f32: vfb_rows_f32 on its own plan and workspace
    Args a32 = a;
    PlanB32 p;
    if (a.ws == nullptr || !shape_ok(a.n_pad, a.n_real, a.d, a.heads, a.dh) ||
        !plan_b32(a.n_pad, a.d, a.d / a.heads, a.dh, drop, l2, &a32.acc_smem,
                  &a32.hc, &a32.nb, &p))
      return (int)cudaErrorInvalidValue;
    a32.smem = (int)p.total;
    auto rows = l2      ? vfb_rows_f32<false, true, false>
                : drop  ? vfb_rows_f32<true, false, false>
                : resid ? vfb_rows_f32<false, false, true>
                        : vfb_rows_f32<false, false, false>;
    err = cudaFuncSetAttribute(
        rows, cudaFuncAttributeMaxDynamicSharedMemorySize, a32.smem);
    if (err != cudaSuccess) return (int)err;
    rows<<<a.batch, kThreads, a32.smem, st>>>(a32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++rows_f32_launches;
  } else {
    // bf16: vfb_rows_bf16 on its own plan
    Args a16 = a;
    PlanB16 p;
    if (!shape_ok(a.n_pad, a.n_real, a.d, a.heads, a.dh) ||
        !plan_b16(a.n_pad, a.d, a.d / a.heads, a.dh, drop, l2, &a16.cn_smem,
                  &a16.hc, &a16.nb, &a16.stages, &p))
      return (int)cudaErrorInvalidValue;
    a16.smem = (int)p.total;
    auto rows = l2      ? vfb_rows_bf16<false, true, false>
                : drop  ? vfb_rows_bf16<true, false, false>
                : resid ? vfb_rows_bf16<false, false, true>
                        : vfb_rows_bf16<false, false, false>;
    err = cudaFuncSetAttribute(
        rows, cudaFuncAttributeMaxDynamicSharedMemorySize, a16.smem);
    if (err != cudaSuccess) return (int)err;
    rows<<<a.batch, kThreads, a16.smem, st>>>(a16);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++rows_bf16_launches;
  }

  const int d = a.d, dh = a.dh;
  Problems ps = {};
  ps.p[0] = {a.cna, a.qkvb, d, 3 * d, 0};
  // Wout_bar = ctx^T gd of the attention branch: with dropout its gd is
  // gd2 = round(g scaler mask_ao), not the MLP branch's gd
  ps.p[1] = {a.ctx, drop ? a.gd2 : a.gd, d, d, (size_t)3 * d * d};
  ps.p[2] = {a.cnm, a.h1b, d, dh, (size_t)4 * d * d};
  ps.p[3] = {a.h, a.gd, dh, d, (size_t)4 * d * d + (size_t)d * dh};
  ps.total = (size_t)4 * d * d + (size_t)2 * d * dh;
  ps.rows = a.batch * a.n_pad;
  err = (cudaError_t)wgrad<T>(ps, a.wpart, a.splits, st);
  if (err != cudaSuccess) return (int)err;

  const int nlen = (l2 ? 8 : 4) * d;
  const size_t all = ps.total + (size_t)nlen;
  vfb_reduce<<<(unsigned)((all + 255) / 256), 256, 0, st>>>(
      a.wpart, a.splits, ps.total, a.npart, a.batch, nlen, a.out);
  return (int)cudaGetLastError();
}

}  // namespace

// In every library that includes this file: the bf16 and the f32
// weight-product kernels' launches so far.
extern "C" unsigned long long vfb_wgrad_launches() { return wgrad_launches; }
extern "C" unsigned long long vfb_wgrad_tf32_launches() {
  return wgrad_tf32_launches;
}

// vector_field_tiled.cu includes this file with VFB_KERNELS_ONLY for its
// weight products and reduce; it has entry points of its own.
#ifndef VFB_KERNELS_ONLY

// Up to four weight products W_bar[M, N] = A[R, M]^T G[R, N] on their own
// (kernels/wgrad.py), for checks and timing.
struct WgradArgs {
  const void* a[4];
  const void* g[4];
  int m[4], n[4];
  int count, rows, splits;
  float* wpart;  // [splits, sum of M N]
  float* out;    // [sum of M N]: the products in order, row-major
};

extern "C" {

// The route's plan (make_plan): whether one image takes one CTA, with cn
// and gd in shared memory (preferred) or in their global scratch, and the
// MLP chunk width, as PR 3's kernel was laid out; `drop` asks for the
// dropout instance's plan, `l2` for the L2 instance's. The rows kernels
// lay their CTAs out by plans of their own (vfb_plan_bf16,
// vfb_plan_f32). Returns 0 when the shape has a plan, 1 when it has
// none.
int vfb_plan(int tbytes, int n_pad, int n_real, int d, int heads, int dh,
             int drop, int l2, int* cn_smem_out, int* hc_out,
             int* smem_out) {
  if (!shape_ok(n_pad, n_real, d, heads, dh)) return 1;
  for (int cn_smem = 1; cn_smem >= 0; --cn_smem) {
    for (int hc : kChunks) {
      if (dh % hc) continue;
      const size_t total = make_plan(n_pad, d, d / heads, hc, cn_smem,
                                     tbytes, drop != 0, l2 != 0);
      if (total <= (size_t)kMaxSmem) {
        *cn_smem_out = cn_smem;
        *hc_out = hc;
        *smem_out = (int)total;
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

// The products of *w (x's element size `tbytes`: 2 runs vfb_wgrad_wgmma,
// 4 vfb_wgrad_tf32) and the fixed-order reduce of their partials into
// w->out; returns as vfb_launch.
int vfb_weight_bars(int tbytes, const WgradArgs* w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w->count < 1 || w->count > 4 || w->splits < 1 || w->rows < 1)
    return (int)cudaErrorInvalidValue;
  Problems ps = {};
  size_t off = 0;
  for (int i = 0; i < w->count; ++i) {
    ps.p[i] = {w->a[i], w->g[i], w->m[i], w->n[i], off};
    off += (size_t)w->m[i] * w->n[i];
  }
  ps.total = off;
  ps.rows = w->rows;
  const int err = tbytes == 2 ? wgrad<bf16>(ps, w->wpart, w->splits, st)
                              : wgrad<float>(ps, w->wpart, w->splits, st);
  if (err) return err;
  vfb_reduce<<<(unsigned)((off + 255) / 256), 256, 0, st>>>(
      w->wpart, w->splits, off, nullptr, 0, 0, w->out);
  return (int)cudaGetLastError();
}

// wgrad_splits: the slices of `rows` the weight products' launcher would
// be given for the `count` problems (ms[i] x ns[i]) by the Python copy,
// for operands of `tbytes` (2: vfb_wgrad_wgmma, 4: vfb_wgrad_tf32).
int vfb_wgrad_splits(int tbytes, int rows, int count, const int* ms,
                     const int* ns) {
  return wgrad_splits(rows, ms, ns, count, tbytes == 2 ? kWbRows : kTgRows);
}

// vfb_rows_f32's plan for a shape (the dropout instance's with `drop`,
// the L2 one's with `l2`): m_bar in shared memory, the MLP chunk, the
// column block, the shared memory and the workspace's floats per image.
// Returns 0 when the shape has one, 1 when not.
int vfb_plan_f32(int n_pad, int n_real, int d, int heads, int dh, int drop,
                 int l2, int* acc_smem_out, int* hc_out, int* nb_out,
                 int* smem_out, long long* ws_out) {
  PlanB32 p;
  if (!shape_ok(n_pad, n_real, d, heads, dh) ||
      !plan_b32(n_pad, d, d / heads, dh, drop != 0, l2 != 0, acc_smem_out,
                hc_out, nb_out, &p))
    return 1;
  *smem_out = (int)p.total;
  *ws_out = (long long)p.ws;
  return 0;
}

unsigned long long vfb_rows_f32_launches() { return rows_f32_launches; }

// vfb_rows_bf16's plan for a shape (the dropout instance's with `drop`,
// the L2 one's with `l2`): cn and gd resident, the MLP chunk, the column
// block of the staged weights, the ring's slots and the shared memory.
// Returns 0 when the shape has one, 1 when not.
int vfb_plan_bf16(int n_pad, int n_real, int d, int heads, int dh, int drop,
                  int l2, int* cn_smem_out, int* hc_out, int* nb_out,
                  int* stages_out, int* smem_out) {
  PlanB16 p;
  if (!shape_ok(n_pad, n_real, d, heads, dh) ||
      !plan_b16(n_pad, d, d / heads, dh, drop != 0, l2 != 0, cn_smem_out,
                hc_out, nb_out, stages_out, &p))
    return 1;
  *smem_out = (int)p.total;
  return 0;
}

unsigned long long vfb_rows_bf16_launches() { return rows_bf16_launches; }

const char* vfb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // VFB_KERNELS_ONLY
