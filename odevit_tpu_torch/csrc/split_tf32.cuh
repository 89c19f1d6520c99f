// Split-TF32 products: f32 matrix products on the tensor cores, shared by
// the Macaron kernels (macaron.cu, macaron_bwd.cu), the tiled route
// (vector_field_tiled.cu: vft_gemm_tf32 and the f32 attention CTAs) and
// the f32 weight products (vector_field_bwd.cu: vfb_wgrad_tf32).
//
// Each f32 operand v is split into big = tf32(v) (to nearest, ties away
// from zero) and small = v - big cut to TF32; a product is small*big +
// big*small + big*big in that order (the small*small term, ~2^-22 of it,
// is dropped): three TF32 passes that keep about 21 bits, f32 to within
// its last few ulps, where one TF32 pass keeps 10. The tensor cores do
// not round their own accumulation to nearest, so long sums take a fresh
// accumulator per chunk of K, added to a running f32 total by ordinary
// adds.
//
// Here: mm_f32, vf::mm's product on TF32 WMMA fragments (each warp
// splits the fragments it loads), used only by the tiled route's
// whole-row f32 attention CTAs (vector_field_tiled.cu: vft_attn<float>,
// vft_attn_keys<float>, through attn_mm); the split of one value by
// integer operations, the m16n8k8 mma.sync and the cp.async helpers of
// mac::gemm_tf32 (below) and vft_gemm_tf32; and the wgmma pieces of
// vft_gemm_tf32 and vfb_wgrad_tf32: swizzled K-major planes (an operand
// stored [K, N] split into them by split_kn4), their descriptors, A
// fragments split in registers (split_frags) and the m64n128k8 and
// m64n96k8 TF32 wgmma with A from registers. Then, in namespace mac,
// gemm_tf32: the one-CTA f32 product staged through shared memory that the
// Macaron forward and backward (mac_kernel_f32, mcb_rows_f32) and the f32
// ViTODE kernels (vf_kernel_f32, vfb_rows_f32) share. Include after
// vector_field.cu's helpers.

#pragma once

#include <cstdint>

namespace vf {

// ---- the split ----
// tf32(v) by two integer operations, bit for bit cvt.rna.tf32.f32 on
// finite values: half an ulp of the 10-bit mantissa added to the
// magnitude's bits, the 13 bits below it cleared
__device__ __forceinline__ unsigned tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// big = tf32(v); small = v - big (exact) cut to TF32 toward zero, within
// 2^-21 |v| of it. A NaN v makes small NaN, whatever the add made of big
// (it carries the all-ones mantissa of the card's NaN, 0x7FFFFFFF, into
// the sign bit: -0), so a product with a NaN operand comes out NaN.
__device__ __forceinline__ void split_bits(float v, unsigned& big,
                                           unsigned& small) {
  big = tf32_bits(v);
  small = __float_as_uint(v - __uint_as_float(big)) & 0xFFFFE000u;
}

// ---- WMMA: split at fragment load ----
// Fragments load from f32 rows whose stride is a multiple of 4 elements,
// 32-byte aligned; each pass is a TF32 WMMA (16x16x8, f32 accumulators).

template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& big, Frag& small) {
#pragma unroll
  for (int i = 0; i < big.num_elements; ++i) {
    unsigned hi, lo;
    split_bits(big.x[i], hi, lo);
    big.x[i] = __uint_as_float(hi);
    small.x[i] = __uint_as_float(lo);
  }
}

// C[M,N] = A[M,K] @ B[K,N] in f32 (C shared or global), with the layouts
// of vf::mm. M, N multiples of 16, K of 8. Each warp owns a column tile
// (and a group of row tiles when there are fewer column tiles than
// warps); each tile's product is summed over K first, then stored once.
template <bool AT, bool BT>
__device__ void mm_f32(const float* A, int lda, const float* B, int ldb,
                       float* C, int ldc, int M, int N, int K) {
  using ALayout =
      typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLayout =
      typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                               wmma::precision::tf32, ALayout>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                               wmma::precision::tf32, BLayout>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  const int warp = threadIdx.x / 32;
  const int mt = M / 16, nt = N / 16, kt = K / 8;
  const int groups = imin(imax(kWarps / nt, 1), mt);
  const int rg = (mt + groups - 1) / groups;
  for (int task = warp; task < nt * groups; task += kWarps) {
    const int tn = task % nt;
    const int r0 = (task / nt) * rg;
    const int rows = imin(mt - r0, rg);
    const int col = tn * 16;
    const float* bcol = BT ? B + (size_t)col * ldb : B + col;
    const size_t bstep = BT ? 8 : (size_t)8 * ldb;
    FragC c[kMaxRowTiles];
#pragma unroll
    for (int r = 0; r < kMaxRowTiles; ++r)
      if (r < rows) wmma::fill_fragment(c[r], 0.0f);
    for (int kk = 0; kk < kt; ++kk) {
      FragB b_big, b_small;
      wmma::load_matrix_sync(b_big, bcol + kk * bstep, ldb);
      split_tf32(b_big, b_small);
#pragma unroll
      for (int r = 0; r < kMaxRowTiles; ++r) {
        if (r < rows) {
          FragA a_big, a_small;
          const float* ap = AT ? A + (size_t)kk * 8 * lda + (r0 + r) * 16
                               : A + (size_t)(r0 + r) * 16 * lda + kk * 8;
          wmma::load_matrix_sync(a_big, ap, lda);
          split_tf32(a_big, a_small);
          wmma::mma_sync(c[r], a_small, b_big, c[r]);
          wmma::mma_sync(c[r], a_big, b_small, c[r]);
          wmma::mma_sync(c[r], a_big, b_big, c[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRowTiles; ++r) {
      if (r < rows) {
        wmma::store_matrix_sync(C + (size_t)(r0 + r) * 16 * ldc + tn * 16,
                                c[r], ldc, wmma::mem_row_major);
      }
    }
  }
}

// ---- mma.sync and cp.async ----
// c += a b for one m16n8k8 tile (TF32 operands, f32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from device to shared memory, asynchronously (zeros where !in)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed (its own; a barrier shows them to
// others), but for the `pending` groups it committed last
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Splits the float4 at `big` (this thread's own landed copy, times scale)
// in place, its small plane `plane` floats further on.
__device__ __forceinline__ void split4(unsigned* big, int plane,
                                       float scale) {
  const float4 v = *reinterpret_cast<const float4*>(big);
  uint4 hi, lo;
  split_bits(v.x * scale, hi.x, lo.x);
  split_bits(v.y * scale, hi.y, lo.y);
  split_bits(v.z * scale, hi.z, lo.z);
  split_bits(v.w * scale, hi.w, lo.w);
  *reinterpret_cast<uint4*>(big) = hi;
  *reinterpret_cast<uint4*>(big + plane) = lo;
}

// ---- wgmma (sm_90a): TF32 B operands from shared memory ----
// wgmma takes TF32 operands K-major only. A plane holds rows (M or N) of
// 32 f32 values (128 bytes) in the 128-byte swizzle: the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8) of that row, and a plane starts on a
// 1024-byte boundary. A descriptor names 8-row groups 1024 bytes apart;
// the k8 step kk of a 32-wide slice starts 32 kk bytes into the rows.

// the byte offset of element (r, k), k < 32, in a swizzled plane
__host__ __device__ __forceinline__ int swz128(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + (k & 3) * 4;
}

// A thread's raw A fragments of a 32-wide slice of K (element i of the
// four m16n8k8 fragments at raw[i], fragment i / 4) split into big and
// small registers for wgmma_tf32_*_rs
__device__ __forceinline__ void split_frags(const float (&raw)[16],
                                            unsigned (&hi)[4][4],
                                            unsigned (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split_bits(raw[i], hi[i / 4][i % 4], lo[i / 4][i % 4]);
}

// An operand stored [K, N] into the big and small planes of its K-major
// form: the float4 at `src` (row k < 32 of a landed slice, columns n .. n
// + 3) split, each value to column k of its own plane row n + q. A warp
// whose lanes take the 32 k of one n writes 32 banks.
__device__ __forceinline__ void split_kn4(const float* src, int k, int n,
                                          unsigned char* big,
                                          unsigned char* small) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned hi, lo;
    split_bits(e[q], hi, lo);
    const int o = swz128(n + q, k);
    *reinterpret_cast<unsigned*>(big + o) = hi;
    *reinterpret_cast<unsigned*>(small + o) = lo;
  }
}

__device__ __forceinline__ uint64_t wg_desc(const void* plane) {
  const uint64_t a =
      static_cast<uint64_t>(__cvta_generic_to_shared(plane));
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The compiler sees wgmma's accumulators written when it is issued; this
// keeps their reads and writes on the side of a fence or wait it stands
// after.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of this thread made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b for a 64 x 128 tile of one warpgroup, k = 8, TF32 operands:
// a from registers, b from shared memory (descriptor, K-major), f32
// accumulators. a[0..3] hold A(r, k), A(r + 8, k), A(r, k + 4), A(r + 8,
// k + 4), r = 16 warp + lane / 4, k = lane % 4 (mma.sync's m16n8k8 A
// fragment, one per warp of the warpgroup); they must not change until
// the product has completed (wg_wait_all). d[4 j + 2 h + e] holds row 16
// warp + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e of the tile;
// accumulate = 0 ignores d.
__device__ __forceinline__ void wgmma_tf32_m64n128_rs(float (&d)[64],
                                                      const unsigned (&a)[4],
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The same for a 64 x 96 tile: d[4 j + 2 h + e], j < 12, holds row 16
// warp + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_tf32_m64n96_rs(float (&d)[48],
                                                     const unsigned (&a)[4],
                                                     uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
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
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// keeps the A registers of a product alive and unchanged up to this point
__device__ __forceinline__ void wg_pin(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

}  // namespace vf

namespace mac {

using namespace vf;

// ---- split-TF32 products staged through shared memory (gemm_tf32) ----
// The products of the f32 one-CTA kernels run here: the Macaron forward
// and backward (macaron.cu: mac_kernel_f32, macaron_bwd.cu: mcb_rows_f32)
// and the ViTODE forward and backward (vector_field.cu: vf_kernel_f32,
// vector_field_bwd.cu: vfb_rows_f32); mm_f32 is left to the tiled route's
// whole-row f32 attention CTAs. Operands in device memory reach shared memory by
// 16-byte cp.async, K in slices of kSlice through a ring of kStages slots:
// the next slice lands while this one is multiplied. Each element is split
// once, where it lands, into a big and a small TF32 plane (split_tf32's
// split); every warp then reads the planes with no conversion. Operands
// the CTA produced itself may stay in shared memory as planes. Each warp
// owns a register tile of up to kTileRows x kTileCols m16n8k8 tiles (48 x
// 32 of C), fed by mma.sync in three passes per k-step in mm_f32's order
// (small x big, big x small, big x big), the sums in f32 registers. The
// epilogue receives the results from registers, two adjacent columns at a
// time; nothing goes through shared memory unless the epilogue puts it
// there.

constexpr int kSlice = 16;         // K of one staged slice
constexpr int kLdK = kSlice + 4;   // stride of a K-contiguous staged tile
constexpr int kTileRows = 3;       // m16 tiles of a warp's register tile
constexpr int kTileCols = 4;       // n8 tiles of a warp's register tile
constexpr int kStages = 2;         // slots of the staging ring
constexpr int kMaxOwn = 3;         // 16-byte chunks a thread stages: M * 4
                                   // + 4 nb, and M <= 96 or nb <= 128

// The A operand [M, K]: staged from device memory (row m at g + m * ld, K
// contiguous; kAStaged), or planes resident in shared memory, row-major
// (kAPlanes) or stored [K][M] (kAPlanesT), row stride ld.
enum { kAStaged = 0, kAPlanes = 1, kAPlanesT = 2 };
struct OpA {
  const float* g;
  int ld;
  const unsigned* big;
  const unsigned* small;
};

// The B operand [K, N] in device memory: row-major, element (k, n) at g +
// k * ld + col(n) with col(n) = (n / strip) * sstride + n % strip (strips
// gather a head's q, k and v columns), or with kBT stored [N][K] (at g + n
// * ld + k). Staged values are multiplied by `scale` before the split.
struct OpB {
  const float* g;
  int ld;
  float scale;
  int strip, sstride;
};

__device__ inline OpB op_b(const float* g, int ld, float scale = 1.0f,
                           int strip = 1 << 30, int sstride = 0) {
  return OpB{g, ld, scale, strip, sstride};
}

// The staging ring: kStages slots, each a big plane of `slot` floats (the
// A slice [M, kSlice] at stride kLdK, then the B slice: [kSlice, nb + 8]
// or, transposed, [nb, kLdK]) followed by its small plane.
struct Ring {
  unsigned* base;
  int slot;
};

// Floats of one plane of one ring slot for M rows and column blocks of nb.
__host__ __device__ inline int ring_slot(int m, int nb) {
  return m * kLdK + imax(kSlice * (nb + 8), nb * kLdK);
}

// C[M, N] = A[M, K] B[K, N] (or cadd[M, N] + cscale (A B), row stride
// ldc, in device memory, one rounding: fmaf) in f32 by split TF32, N in
// column blocks of nb; epi(r, c, v0, v1) receives C[r, c] and C[r, c + 1]
// from registers. cadd is read before the epilogue runs, all of a warp's
// loads at once. M, N, K
// multiples of 16, nb of 16; staged rows 16-byte aligned. Every thread of
// the CTA calls it. It begins with a barrier (the operands written before
// it are then visible, and the ring free) and ends without one: whoever
// reads what the epilogue wrote in shared memory syncs first.
template <int kA, bool kBT, typename Epi>
__device__ void gemm_tf32(const Ring& ring, int M, int N, int K, int nb,
                          const OpA& A, const OpB& B, Epi epi,
                          const float* cadd = nullptr, int ldc = 0,
                          float cscale = 1.0f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = M / 16, slices = K / kSlice, a_part = M * kLdK;
  for (int nb0 = 0; nb0 < N; nb0 += nb) {
    const int nw = imin(nb, N - nb0), nt = nw / 8;
    const int ldb = kBT ? kLdK : nw + 8;
    // warp tiles: column groups of kTileCols n8 tiles; the rows split into
    // as many groups (each at most kTileRows m16 tiles) as the warps allow
    const int cg = (nt + kTileCols - 1) / kTileCols;
    int groups = (mt + kTileRows - 1) / kTileRows;
    while (groups < mt && (groups + 1) * cg <= kWarps) ++groups;
    const int rpg = (mt + groups - 1) / groups;
    const int tasks = ((mt + rpg - 1) / rpg) * cg;
    // this thread's 16-byte chunks of a slice (kMaxOwn at most), the A
    // slice's first: where each lands in a slot, and
    // where slice 0's comes from. The same ones are copied and then split,
    // so a thread waits only for its own copies.
    const int a_chunks = kA == kAStaged ? M * 4 : 0;
    const int per = nw / 4;  // chunks of a row-major B slice's row
    unsigned off[kMaxOwn];
    const float* src[kMaxOwn];
#pragma unroll
    for (int j = 0; j < kMaxOwn; ++j) {
      const int i = threadIdx.x + j * kThreads, ib = i - a_chunks;
      off[j] = ~0u;
      src[j] = nullptr;
      if (i < a_chunks) {
        const int m = i >> 2, q = (i & 3) * 4;
        off[j] = m * kLdK + q;
        src[j] = A.g + (size_t)m * A.ld + q;
      } else if (kBT && ib < nw * 4) {
        const int nn = ib >> 2, q = (ib & 3) * 4;
        off[j] = a_part + nn * kLdK + q;
        src[j] = B.g + (size_t)(nb0 + nn) * B.ld + q;
      } else if (!kBT && ib < kSlice * per) {
        const int kr = ib / per, q = (ib % per) * 4, col = nb0 + q;
        off[j] = a_part + kr * ldb + q;
        src[j] = B.g + (size_t)kr * B.ld + (col / B.strip) * B.sstride +
                 col % B.strip;
      }
    }
    // slice s of chunk j: a row-major B steps by rows, the others by columns
    auto slice_src = [&](int j, int s) {
      const size_t step = !kBT && off[j] >= (unsigned)a_part ? B.ld : 1;
      return src[j] + (size_t)s * kSlice * step;
    };
    auto stage = [&](int s) {
      unsigned* big = ring.base + (size_t)(s % kStages) * 2 * ring.slot;
#pragma unroll
      for (int j = 0; j < kMaxOwn; ++j)
        if (off[j] != ~0u) cp_async16(big + off[j], slice_src(j, s));
      cp_async_commit();
    };
    auto split = [&](int s) {
      unsigned* big = ring.base + (size_t)(s % kStages) * 2 * ring.slot;
#pragma unroll
      for (int j = 0; j < kMaxOwn; ++j)
        if (off[j] != ~0u)
          split4(big + off[j], ring.slot,
                 off[j] >= (unsigned)a_part ? B.scale : 1.0f);
    };
    for (int task0 = 0; task0 < tasks; task0 += kWarps) {
      const int task = task0 + warp;
      const bool active = task < tasks;
      const int r0 = active ? (task / cg) * rpg : 0;
      const int rows = active ? imin(rpg, mt - r0) : 0;
      const int j0 = active ? (task % cg) * kTileCols : 0;
      const int cols = active ? imin(kTileCols, nt - j0) : 0;
      float acc[kTileRows][kTileCols][4];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int j = 0; j < kTileCols; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
      __syncthreads();
      for (int s = 0; s < kStages - 1 && s < slices; ++s) stage(s);
      for (int s = 0; s < slices; ++s) {
        if (s + kStages - 2 < slices)
          cp_async_wait<kStages - 2>();
        else
          cp_async_wait<0>();
        split(s);
        // slice s is split; the slot of slice s + kStages - 1, last read
        // for slice s - 1, is free
        __syncthreads();
        if (s + kStages - 1 < slices) stage(s + kStages - 1);
        if (!active) continue;
        const unsigned* sb =
            ring.base + (size_t)(s % kStages) * 2 * ring.slot;
        const unsigned* ss = sb + ring.slot;
#pragma unroll 1
        for (int kk = 0; kk < kSlice; kk += 8) {
          unsigned fb[kTileCols][2], fs[kTileCols][2];
#pragma unroll
          for (int j = 0; j < kTileCols; ++j) {
            if (j < cols) {
              const int nn = (j0 + j) * 8 + gq;
              const int i0 = a_part + (kBT ? nn * kLdK + kk + tq
                                           : (kk + tq) * ldb + nn);
              const int i1 = i0 + (kBT ? 4 : 4 * ldb);
              fb[j][0] = sb[i0];
              fb[j][1] = sb[i1];
              fs[j][0] = ss[i0];
              fs[j][1] = ss[i1];
            }
          }
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
            if (r < rows) {
              const int m = (r0 + r) * 16 + gq;
              const unsigned* pb = kA == kAStaged ? sb : A.big;
              const unsigned* ps = kA == kAStaged ? ss : A.small;
              int i0, dr, dk;  // element (m, k), then the steps to m + 8
              if (kA == kAStaged) {   // and to k + 4
                i0 = m * kLdK + kk + tq;
                dr = 8 * kLdK;
                dk = 4;
              } else if (kA == kAPlanes) {
                i0 = m * A.ld + s * kSlice + kk + tq;
                dr = 8 * A.ld;
                dk = 4;
              } else {
                i0 = (s * kSlice + kk + tq) * A.ld + m;
                dr = 8;
                dk = 4 * A.ld;
              }
              const unsigned ab[4] = {pb[i0], pb[i0 + dr], pb[i0 + dk],
                                      pb[i0 + dr + dk]};
              const unsigned as[4] = {ps[i0], ps[i0 + dr], ps[i0 + dk],
                                      ps[i0 + dr + dk]};
#pragma unroll
              for (int j = 0; j < kTileCols; ++j) {
                if (j < cols) {
                  mma_tf32(acc[r][j], as, fb[j]);
                  mma_tf32(acc[r][j], ab, fs[j]);
                  mma_tf32(acc[r][j], ab, fb[j]);
                }
              }
            }
          }
        }
      }
      if (cadd != nullptr) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
#pragma unroll
          for (int j = 0; j < kTileCols; ++j)
            if (r < rows && j < cols) {
              const float* cp = cadd + (size_t)((r0 + r) * 16 + gq) * ldc +
                                nb0 + (j0 + j) * 8 + 2 * tq;
              const float2 u = *reinterpret_cast<const float2*>(cp);
              const float2 w =
                  *reinterpret_cast<const float2*>(cp + (size_t)8 * ldc);
              acc[r][j][0] = fmaf(cscale, acc[r][j][0], u.x);
              acc[r][j][1] = fmaf(cscale, acc[r][j][1], u.y);
              acc[r][j][2] = fmaf(cscale, acc[r][j][2], w.x);
              acc[r][j][3] = fmaf(cscale, acc[r][j][3], w.y);
            }
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int j = 0; j < kTileCols; ++j)
          if (r < rows && j < cols) {
            const int row = (r0 + r) * 16 + gq;
            const int col = nb0 + (j0 + j) * 8 + 2 * tq;
            epi(row, col, acc[r][j][0], acc[r][j][1]);
            epi(row + 8, col, acc[r][j][2], acc[r][j][3]);
          }
    }
  }
}

// ---- the f32 one-CTA ViTODE kernels (vf_kernel_f32, vfb_rows_f32) ----
// Column blocks of their products, widest first, and whether a block of nb
// columns suits n rows: one round of warp tiles (column groups of 32 by
// row groups of up to kTileRows m16 tiles fill at most the 12 warps) and a
// staged slice's 16-byte chunks (4 n of A, 4 nb of B) within kMaxOwn a
// thread. kernels/vector_field.py::f32_plan repeats this in Python.
constexpr int kBlocksF32[] = {192, 128, 96, 64, 32, 16};

__host__ __device__ inline bool block_ok(int n, int nb) {
  return ((nb + 31) / 32) * ((n / 16 + kTileRows - 1) / kTileRows) <=
             kWarps &&
         4 * n + 4 * nb <= kMaxOwn * kThreads;
}

// The largest ring (n_pad = 128 rows, the widest block that suits them)
// beside p's two planes at 128 rows, the forward's attention region.
static_assert(2 * kStages * 4 * (128 * kLdK + 128 * kLdK) +
                      2 * 4 * 128 * (128 + 4) <=
                  232448,
              "the ring and p's planes at 128 rows fit a CTA");

__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---- bf16 products on mma.sync (gemm_b16) ----
// gemm_tf32's bf16 sibling, the products of the bf16 one-CTA backward
// (vector_field_bwd.cu: vfb_rows_bf16): bf16 operands, f32 accumulators,
// one mma.sync m16n8k16 a k-step, fragments read from shared memory by
// ldmatrix (.trans where an operand is read transposed). An operand the
// CTA holds in shared memory is read where it lies (kSA, kSAT; kSB,
// kSBT); one in device memory (kGA; kGB, kGBT: the weights) reaches
// shared memory by 16-byte cp.async, K in slices of kSliceB through a
// ring of 2 to 4 slots, so each slice is staged once for all the warps
// of the CTA while the next ones land. Each warp owns a register tile of
// up to TR x TC m16n8 tiles of C and walks K in k-steps of 16 in
// increasing order (vf::mm's order: a product the forward also takes
// sums in its order). The caller's epilogue receives each tile's
// accumulators in registers; with `zero` false they carry over from the
// last call (the caller keeps them: one column block, one round of
// tasks). A dual call (kB2 >= 0) takes two products of one shape, A B and
// A2 B2, on the same tiles, so an epilogue meets both.

constexpr int kSliceB = 32;            // K of one staged slice
constexpr int kLdSlice = kSliceB + 8;  // stride of a K-contiguous slice

// A [M, K]: in shared memory row-major (kSA) or stored [K][M] (kSAT), or
// in device memory row-major, staged (kGA). B [K, N]: in shared memory
// row-major (kSB) or stored [N][K] (kSBT), or in device memory row-major
// with column strips (kGB) or stored [N][K] (kGBT), staged.
enum { kSA = 0, kSAT = 1, kGA = 2 };
enum { kSB = 0, kSBT = 1, kGB = 2, kGBT = 3 };

// An operand: base, row stride, and (kGB) column n at (n / strip) *
// sstride + n % strip, which gathers a head's q, k and v columns.
struct Op16 {
  const bf16* p;
  int ld;
  int strip, sstride;
};

__device__ inline Op16 op16(const bf16* p, int ld, int strip = 1 << 30,
                            int sstride = 0) {
  return Op16{p, ld, strip, sstride};
}

// The warps' tiles of an [M, N] product in m16 x n8 tiles (mt x nt):
// column groups of tc n8 tiles, the rows in as many groups (each at most
// tr m16 tiles) as the warps allow. Task t is row group t / cg and column
// group t % cg.
struct TilingB16 {
  int cg, rpg, groups, tasks;
};

__host__ __device__ constexpr TilingB16 tiling_b16(int mt, int nt, int tr,
                                                   int tc) {
  TilingB16 t{};
  t.cg = (nt + tc - 1) / tc;
  int groups = (mt + tr - 1) / tr;
  while (groups < mt && (groups + 1) * t.cg <= kWarps) ++groups;
  t.rpg = (mt + groups - 1) / groups;
  t.groups = (mt + t.rpg - 1) / t.rpg;
  t.tasks = t.groups * t.cg;
  return t;
}

// Elements of one ring slot for a product of m rows and column blocks of
// nw: the staged slices of A (kGA), B, and for a dual call A2 and B2.
__host__ __device__ constexpr int slice_b16(int nw, int kb) {
  return kb == kGB ? kSliceB * (nw + 8) : kb == kGBT ? nw * kLdSlice : 0;
}

__host__ __device__ constexpr int slot_b16(int m, int nw, int ka, int kb,
                                           int kb2 = -1) {
  return (ka == kGA ? m * kLdSlice : 0) + slice_b16(nw, kb) +
         (kb2 >= 0 ? (ka == kGA ? m * kLdSlice : 0) + slice_b16(nw, kb2)
                   : 0);
}

// One warp's tile: first row, its m16 tiles, first column, its n8 tiles,
// its row group.
struct TileB16 {
  int r0, rows, c0, cols, rg;
};

__device__ __forceinline__ unsigned sm_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8x8 bf16 matrices from shared memory: lane l gives row l % 8 of matrix
// l / 8 (x2: lanes 0-15); with kTrans each matrix arrives transposed
// (not volatile: the memory clobber keeps them after the shared-memory
// stores and barriers before them, and lets them move ahead of products).
// `a` is a shared-space address.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  if (kTrans)
    asm("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  else
    asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        unsigned a) {
  if (kTrans)
    asm("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r0), "=r"(r1)
        : "r"(a)
        : "memory");
  else
    asm("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r0), "=r"(r1)
        : "r"(a)
        : "memory");
}

// c += a b for one m16n8k16 tile (bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_b16(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset, from its operand's base at k = 0, of the row this lane
// gives ldmatrix for the A fragment of rows m0 .. m0 + 15 (a0 .. a3 of
// mma.sync's layout): row-major at stride ld, or stored [K][M] (kT, read
// transposed). A k-step of 16 adds 32 bytes, or with kT 32 ld.
template <bool kT>
__device__ __forceinline__ unsigned a_lane(int ld, int m0) {
  const int l = threadIdx.x & 31;
  return 2u * (kT ? ((l & 7) + ((l >> 4) << 3)) * ld + m0 +
                        (((l >> 3) & 1) << 3)
                  : (m0 + (l & 15)) * ld + ((l >> 4) << 3));
}

// The same for the B fragments (b0, b1) of columns n0 .. n0 + 7 and of n0 +
// 8 .. n0 + 15 (an x4 load; an x2 takes the first pair): stored [K][N] at
// stride ld (kKN, read transposed; a k-step adds 32 ld bytes) or [N][K]
// (32 bytes).
template <bool kKN>
__device__ __forceinline__ unsigned b_lane(int ld, int n0) {
  const int l = threadIdx.x & 31, i = l >> 3;
  return 2u * (kKN ? ((l & 7) + ((i & 1) << 3)) * ld + n0 + ((i >> 1) << 3)
                   : (n0 + (l & 7) + ((i >> 1) << 3)) * ld + ((i & 1) << 3));
}

// C[M, N] = A[M, K] B[K, N] (and with kB2 >= 0 C2 = A2 B2) into the
// caller's register tiles acc (acc2), N in column blocks of nb; for each
// warp's tile, epi(tile, acc, acc2). M, N, K multiples of 16, nb of 16;
// rows of staged operands 16-byte aligned; `ring` holds `stages` slots of
// `slot` elements (slot_b16). Every thread of the CTA calls it. It begins
// with a barrier (what was written before is then visible and the ring
// free) and ends without one: whoever reads what the epilogue wrote in
// shared memory syncs first.
template <int TR, int TC, int kA, int kB, int kB2 = -1, typename Epi>
__device__ void gemm_b16(bf16* ring, int slot, int stages, int M, int N,
                         int K, int nb, const Op16& A, const Op16& B,
                         const Op16& A2, const Op16& B2,
                         float (&acc)[TR][TC][4], float (&acc2)[TR][TC][4],
                         bool zero, Epi epi) {
  constexpr bool kDual = kB2 >= 0;
  constexpr bool kStaged = kA == kGA || kB >= kGB || kB2 >= kGB;
  const int warp = threadIdx.x / 32;
  const int mt = M / 16, slices = (K + kSliceB - 1) / kSliceB;
  for (int nb0 = 0; nb0 < N; nb0 += nb) {
    const int nw = imin(nb, N - nb0), nt = nw / 8;
    const TilingB16 tl = tiling_b16(mt, nt, TR, TC);
    // where each staged part lies in a slot
    const int a_sz = kA == kGA ? M * kLdSlice : 0;
    const int boff = a_sz, a2off = boff + slice_b16(nw, kB),
              b2off = a2off + (kDual ? a_sz : 0);
    // A K-contiguous part (A, or B stored [N][K]): `rows` rows of kq
    // 16-byte chunks (kSliceB / 8, fewer on a last partial slice: a power
    // of two), row r at src + r ld, landing at stride kLdSlice. No
    // division: chunk i is row i >> lq.
    auto stage_k = [&](bf16* dst, const bf16* src, int ld, int rows,
                       int kq) {
      const int lq = __ffs(kq) - 1;
#pragma unroll 1
      for (int i = threadIdx.x; i < rows * kq; i += kThreads) {
        const int r = i >> lq, q = i & (kq - 1);
        cp_async16(dst + r * kLdSlice + q * 8, src + (size_t)r * ld + q * 8);
      }
    };
    // A row-major B slice: kv rows of per = nw / 8 chunks; a thread's
    // (row, chunk) steps by kThreads chunks without a division, and a
    // column finds its strip by subtraction.
    const int per = nw / 8, dkr = kThreads / per, dq = kThreads % per;
    const int kr0 = threadIdx.x / per, q0 = threadIdx.x % per;
    auto stage_kn = [&](bf16* dst, const Op16& op, int k0, int kv) {
      int kr = kr0, q = q0;
#pragma unroll 1
      while (kr < kv) {
        int col = nb0 + q * 8, st = 0;
        while (col >= op.strip) {
          col -= op.strip;
          st += op.sstride;
        }
        cp_async16(dst + kr * (nw + 8) + q * 8,
                   op.p + (size_t)(k0 + kr) * op.ld + st + col);
        kr += dkr;
        q += dq;
        if (q >= per) {
          q -= per;
          ++kr;
        }
      }
    };
    auto stage_b = [&](bf16* dst, const Op16& op, int kind, int k0, int kv,
                       int kq) {
      if (kind == kGB)
        stage_kn(dst, op, k0, kv);
      else if (kind == kGBT)
        stage_k(dst, op.p + (size_t)nb0 * op.ld + k0, op.ld, nw, kq);
    };
    auto stage = [&](int s) {
      bf16* sl = ring + (size_t)(s % stages) * slot;
      const int k0 = s * kSliceB, kv = imin(kSliceB, K - k0), kq = kv / 8;
      if (kA == kGA) stage_k(sl, A.p + k0, A.ld, M, kq);
      stage_b(sl + boff, B, kB, k0, kv, kq);
      if (kDual) {
        if (kA == kGA) stage_k(sl + a2off, A2.p + k0, A2.ld, M, kq);
        stage_b(sl + b2off, B2, kB2, k0, kv, kq);
      }
      cp_async_commit();
    };
    for (int task0 = 0; task0 < tl.tasks; task0 += kWarps) {
      const int task = task0 + warp;
      const bool active = task < tl.tasks;
      const int rt0 = active ? (task / tl.cg) * tl.rpg : 0;
      const int rows = active ? imin(tl.rpg, mt - rt0) : 0;
      const int j0 = active ? (task % tl.cg) * TC : 0;
      const int cols = active ? imin(TC, nt - j0) : 0;
      if (zero) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] = 0.0f;
              if (kDual) acc2[i][j][e] = 0.0f;
            }
      }
      // this lane's ldmatrix offsets for the task's fragments (bytes from
      // each operand's base at k = 0) and the bytes a k of 1 adds
      constexpr int kP = kDual ? 2 : 1;
      unsigned aoff[kP][TR], boff2[kP][(TC + 1) / 2];
      int aunit[kP], bunit[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int kbk = p ? kB2 : kB;
        const int lda = kA == kGA ? kLdSlice : (p ? A2 : A).ld;
        const int ldb = kbk == kGB ? nw + 8
                        : kbk == kGBT ? kLdSlice : (p ? B2 : B).ld;
        const int nbase = kbk >= kGB ? 0 : nb0;
        aunit[p] = kA == kSAT ? 2 * lda : 2;
        bunit[p] = kbk == kSB || kbk == kGB ? 2 * ldb : 2;
#pragma unroll
        for (int i = 0; i < TR; ++i)
          aoff[p][i] = kA == kSAT ? a_lane<true>(lda, (rt0 + i) * 16)
                                  : a_lane<false>(lda, (rt0 + i) * 16);
#pragma unroll
        for (int j = 0; j < TC; j += 2)
          boff2[p][j / 2] =
              kbk == kSB || kbk == kGB
                  ? b_lane<true>(ldb, nbase + (j0 + j) * 8)
                  : b_lane<false>(ldb, nbase + (j0 + j) * 8);
      }
      const unsigned a_sm[2] = {sm_u32(A.p), sm_u32(A2.p)};
      const unsigned b_sm[2] = {sm_u32(B.p), sm_u32(B2.p)};
      // k-steps [kb, ke) of K; staged operands from the slot at shared
      // address sl, at k - k0
      auto steps = [&](unsigned sl, int k0, int kb, int ke) {
#pragma unroll 1
        for (int k = kb; k < ke; k += 16) {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const int kbk = p ? kB2 : kB;
            const unsigned ab =
                kA == kGA ? sl + 2 * (p ? a2off : 0) + (k - k0) * aunit[p]
                          : a_sm[p] + k * aunit[p];
            const unsigned bb =
                kbk >= kGB ? sl + 2 * (p ? b2off : boff) + (k - k0) * bunit[p]
                           : b_sm[p] + k * bunit[p];
            unsigned bf[(TC + 1) / 2][4];
#pragma unroll
            for (int j = 0; j < TC; j += 2) {
              if (j < cols) {
                const unsigned ad = bb + boff2[p][j / 2];
                const bool kn = kbk == kSB || kbk == kGB;
                if (j + 1 < cols) {
                  if (kn)
                    ldsm_x4<true>(bf[j / 2], ad);
                  else
                    ldsm_x4<false>(bf[j / 2], ad);
                } else {
                  if (kn)
                    ldsm_x2<true>(bf[j / 2][0], bf[j / 2][1], ad);
                  else
                    ldsm_x2<false>(bf[j / 2][0], bf[j / 2][1], ad);
                }
              }
            }
            // every A fragment of the k-step before the products, so that
            // the loads overlap
            unsigned af[TR][4];
#pragma unroll
            for (int i = 0; i < TR; ++i)
              if (i < rows) ldsm_x4<kA == kSAT>(af[i], ab + aoff[p][i]);
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
              for (int j = 0; j < TC; ++j)
                if (i < rows && j < cols) {
                  float(&c)[4] = p ? acc2[i][j] : acc[i][j];
                  mma_b16(c, af[i], bf[j / 2][(j & 1) * 2],
                          bf[j / 2][(j & 1) * 2 + 1]);
                }
          }
        }
      };
      __syncthreads();
      if (kStaged) {
        for (int s = 0; s < stages - 1 && s < slices; ++s) stage(s);
#pragma unroll 1
        for (int s = 0; s < slices; ++s) {
          // this thread's copies of slice s have landed: all but the
          // groups of the slices after it that are in flight
          const int later = imin(stages - 2, slices - 1 - s);
          if (later >= 2)
            cp_async_wait<2>();
          else if (later == 1)
            cp_async_wait<1>();
          else
            cp_async_wait<0>();
          // slice s has landed for every thread; the slot of slice s +
          // stages - 1, last read for slice s - 1, is free
          __syncthreads();
          if (s + stages - 1 < slices) stage(s + stages - 1);
          if (active)
            steps(sm_u32(ring) + 2u * (s % stages) * slot, s * kSliceB,
                  s * kSliceB, imin(K, (s + 1) * kSliceB));
        }
      } else if (active) {
        steps(0u, 0, 0, K);
      }
      if (active)
        epi(TileB16{rt0 * 16, rows, nb0 + j0 * 8, cols, task / tl.cg}, acc,
            acc2);
    }
  }
}

// f(r, c, v0, v1) for each pair of a tile's accumulators: C[r, c] and
// C[r, c + 1].
template <int TR, int TC, typename F>
__device__ __forceinline__ void each_pair(const TileB16& t,
                                          const float (&acc)[TR][TC][4],
                                          F f) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j)
      if (i < t.rows && j < t.cols) {
        const int r = t.r0 + i * 16 + gq, c = t.c0 + j * 8 + 2 * tq;
        f(r, c, acc[i][j][0], acc[i][j][1]);
        f(r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
}

__device__ __forceinline__ void put_b2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace mac
