// The forward's dropout masks as explicit arrays, on Hopper (sm_90a).
//
// Replaces the TPU kernel odevit_tpu/kernels/vector_field.py::
// _mask_gen_kernel (reached through generate_dropout_masks). It draws the
// same bits as the forward and backward kernels, from the Philox helpers of
// vector_field.cu (namespace vf): a keep bit depends on (seed, site, image,
// row, column) only, never on the grid. One launch writes four float32
// masks, cut to the n real tokens:
//
//   mask_h  [B, n, dh]      site 0 (mlp_drop)
//   mask_mo [B, n, D]       site 1 (mlp_drop)
//   mask_ao [B, n, D]       site 2 (proj_drop)
//   mask_p  [B, H, n, n]    site 3 + head (attn_drop); row = query
//
// with 1 / (1 - rate) where kept and 0 where dropped; a site of rate 0 has
// threshold 0 and value 1, so it is all ones.
//
// Bound. At B=1024 and the CIFAR shape (69 tokens, D=192, dh=768, 3 heads)
// the masks are 96 M floats, 384 MB written: 0.115 ms at 3.35 TB/s. Their
// 24.2 M Philox calls (10 rounds of two 32x32 -> 64 products, 40 multiply
// halves for 4 words on the FMA pipe; the xors and compares on the ALU
// pipe) take about 0.058 ms on the busier pipe. Bytes bound it.
//
// Design. One thread per Philox call (4 columns of one row), grid-stride
// over each mask; blockIdx.y picks the mask. Rows of mask_h, mask_mo and
// mask_ao are multiples of 4 wide, so each thread writes one float4; a row
// of mask_p ends in a partial group, written element by element.

#define VF_HELPERS_ONLY
#include "vector_field.cu"

using namespace vf;

namespace {

struct Job {
  float* out;          // [planes, rows, cols]
  int planes_per_img;  // 1, or the heads of mask_p (site = site0 + plane)
  int site0, rows, cols;
  unsigned th;
  float sc;
};

struct Jobs {
  Job j[4];
  int batch, img0;
  unsigned seed;
};

__global__ void __launch_bounds__(256) dm_kernel(Jobs jobs) {
  const Job job = jobs.j[blockIdx.y];
  const int groups = (job.cols + 3) / 4;
  const size_t total =
      (size_t)jobs.batch * job.planes_per_img * job.rows * groups;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int g = (int)(t % groups);
    const size_t pr = t / groups;  // plane * rows + row
    const int row = (int)(pr % job.rows);
    const size_t plane = pr / job.rows;
    const int img = (int)(plane / job.planes_per_img);
    const int site = job.site0 + (int)(plane % job.planes_per_img);
    float m[4];
    keep4(site_key(jobs.seed, site), (unsigned)(jobs.img0 + img), row, g,
          job.cols, job.th, job.sc, m);
    float* o = job.out + pr * job.cols + 4 * g;
    if (job.cols % 4 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
      for (int j = 0; j < 4 && 4 * g + j < job.cols; ++j) o[j] = m[j];
    }
  }
}

}  // namespace

extern "C" {

// Writes the four masks of images img0 .. img0 + batch - 1 on `stream`;
// returns cudaGetLastError() after the launch (0 on success). Outputs are
// contiguous float32 tensors of the shapes above, 16-byte aligned.
int dm_launch(void* mask_h, void* mask_mo, void* mask_ao, void* mask_p,
              int batch, int n, int d, int dh, int heads, int img0,
              const Drop* drop, void* stream) {
  Jobs jobs;
  jobs.j[0] = {static_cast<float*>(mask_h), 1, kSiteH, n, dh, drop->th_m,
               drop->sc_m};
  jobs.j[1] = {static_cast<float*>(mask_mo), 1, kSiteMlpOut, n, d,
               drop->th_m, drop->sc_m};
  jobs.j[2] = {static_cast<float*>(mask_ao), 1, kSiteAttnOut, n, d,
               drop->th_ao, drop->sc_ao};
  jobs.j[3] = {static_cast<float*>(mask_p), heads, kSiteP, n, n, drop->th_p,
               drop->sc_p};
  jobs.batch = batch;
  jobs.img0 = img0;
  jobs.seed = drop->seed;
  // about 8 blocks of 256 threads per SM for the largest mask
  const dim3 grid(132 * 8, 4);
  dm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(jobs);
  return (int)cudaGetLastError();
}

const char* dm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
