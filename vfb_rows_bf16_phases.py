#!/usr/bin/env python3
"""Where the bf16 one-CTA backward (``vfb_rows_bf16``) spends its time.

Run from the repository root on a GPU:  python3 vfb_rows_bf16_phases.py

Copies ``odevit_tpu_torch/csrc`` into ``build/phases/``, inserts clock
reads into the copy (thread 0 of each CTA, after a barrier at each phase
boundary; and inside ``mac::gemm_b16`` around the wait for a staged slice,
the barrier and staging, the slice's k-steps and each epilogue), builds it,
loads it in place of the library and runs the deterministic instance once
at the CIFAR training state (``chip_smoke.rows_bf16_cases``: B=1024, 69
tokens padded to 80, D=192, 3 heads, dh=768). Prints one JSON line: the
cycles of an image and each phase's share, and thread 0's cycles in each
part of the products. The added barriers slow the kernel a little; the
shares, not the times, are the result.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("phase0+cn_a", "qkv", "scores+softmax", "ctx", "cb", "vbar+pbar",
          "rowpass", "qbar+kbar", "mlp dual+epi", "mbar", "abar", "final")
PARTS = ("slice wait", "barrier+stage", "slice k-steps", "epilogues")
# (text in the source, text inserted, before it?): each text must be found
# once, so an edit of the kernel that breaks a clock fails loudly
KERNEL = [
    ("template <bool kDrop, bool kL2, bool kResid>\n__global__ void "
     "__launch_bounds__(kThreads, 1) vfb_rows_bf16(Args args) {",
     "__device__ long long g_vfb_clk[1024 * 16];\n#define VFB_T(k) do { "
     "__syncthreads(); if (threadIdx.x == 0) { long long _t = clock64(); "
     "_clk[k] += _t - _last; _last = _t; } } while (0)\n", True),
    ("  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  using mac::each_pair;",
     "\n  long long _clk[16] = {0}; long long _last = clock64();\n", False),
    ("  if (cn_smem) rows_out(cna, lcn, cna_g, d, n, d);", "\n  VFB_T(0);",
     False),
    ("    if (kL2) {\n      __syncthreads();\n      sq_rows(q, lh, n, hd, q2);",
     "    VFB_T(1);\n", True),
    ("    gemm_b16<3, 4, kSA, kSB>(\n        nullptr, 0, stages, n, hd, n, "
     "hd, op16(pb, lp), op16(v, lh),", "    VFB_T(2);\n", True),
    ("    // cb = round(gda Wout[h*hd:(h+1)*hd, :]^T)", "    VFB_T(3);\n",
     True),
    ("    // v_bar = round(p^T cb)", "    VFB_T(4);\n", True),
    ("    __syncthreads();\n    // (+ JaSMin) then s_bar (softmax) or "
     "round(d2b) (L2) into pb", "    VFB_T(5);\n", True),
    ("    // softmax: q_bar = round(s_bar k tau)", "    VFB_T(6);\n", True),
    ("            put_b2(qkvb_g + (size_t)r * 3 * d + d + hh * hd + col, v0, "
     "v1);\n          });\n        });\n", "    VFB_T(7);\n", False),
    ("    // m_bar (+)= h1_bar W1[:, c]^T, added in f32 in shared memory",
     "    VFB_T(8);\n", True),
    ("\n  }\n\n  // ---- a_bar", "\n    VFB_T(9);", True),
    ("  __syncthreads();\n\n  // norm partials of this image: (ga, ba, gm, "
     "bm) sums over real rows,", "  VFB_T(10);\n", True),
    ("\n}\n\n#undef VFB16_PHASE",
     "\n  VFB_T(11);\n  if (threadIdx.x == 0 && blockIdx.x < 1024)\n    for "
     "(int k = 0; k < 16; ++k) g_vfb_clk[blockIdx.x * 16 + k] = _clk[k];",
     True),
    ("const char* vfb_error_string(int code) {",
     "int vfb_clk_read(long long* out) {\n  return (int)cudaMemcpyFromSymbol("
     "out, g_vfb_clk, sizeof(g_vfb_clk));\n}\n\nint vfb_part_read(long long* "
     "out) {\n  return (int)cudaMemcpyFromSymbol(out, mac::g_vfb_part, "
     "sizeof(mac::g_vfb_part));\n}\n\n", True)]
PRODUCT = [
    ("template <int TR, int TC, int kA, int kB, int kB2 = -1, typename Epi>"
     "\n__device__ void gemm_b16(",
     "__device__ long long g_vfb_part[1024 * 8];\n#define VFB_P0 long long "
     "_p0 = clock64();\n#define VFB_P(k) if (threadIdx.x == 0 && blockIdx.x "
     "< 1024) { long long _p1 = clock64(); g_vfb_part[blockIdx.x * 8 + (k)] "
     "+= _p1 - _p0; _p0 = _p1; }\n", True),
    ("          // this thread's copies of slice s have landed: all but the\n",
     "          VFB_P0;\n", True),
    ("          __syncthreads();\n          if (s + stages - 1 < slices) "
     "stage(s + stages - 1);\n", "          VFB_P(0);\n", True),
    ("          if (s + stages - 1 < slices) stage(s + stages - 1);\n",
     "          VFB_P(1);\n", False),
    ("            steps(sm_u32(ring) + 2u * (s % stages) * slot, s * kSliceB,"
     "\n                  s * kSliceB, imin(K, (s + 1) * kSliceB));\n",
     "          VFB_P(2);\n", False),
    ("      if (active)\n        epi(TileB16{rt0 * 16, rows, nb0 + j0 * 8, "
     "cols, task / tl.cg}, acc,\n            acc2);\n", "      { VFB_P0;\n",
     True),
    ("      if (active)\n        epi(TileB16{rt0 * 16, rows, nb0 + j0 * 8, "
     "cols, task / tl.cg}, acc,\n            acc2);\n", "      VFB_P(3); }\n",
     False)]


def patch(path: Path, edits):
    s = path.read_text()
    for text, add, before in edits:
        if s.count(text) != 1:
            raise SystemExit(f"{path.name}: {text[:60]!r} found "
                             f"{s.count(text)} times")
        s = s.replace(text, add + text if before else text + add)
    path.write_text(s)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    from odevit_tpu_torch.kernels import build
    from odevit_tpu_torch.kernels import vector_field_bwd as vfb
    out_dir = ROOT / "build" / "phases"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(build.CSRC, out_dir)
    patch(out_dir / "vector_field_bwd.cu", KERNEL)
    patch(out_dir / "split_tf32.cuh", PRODUCT)
    lib_path = out_dir / "libphases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "vector_field_bwd.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(lib_path))
    load = build.load
    build.load = lambda name: lib if name == "vector_field_bwd" else load(
        name)
    vfb._lib = None
    vfb._library()
    for fn in (lib.vfb_clk_read, lib.vfb_part_read):
        fn.argtypes = [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (cs.BATCH, 32, 32, 3), dtype=np.uint8)).cuda()
    x, w, gx, kw, extra, _, _ = cs.rows_bf16_cases(images)["det"]
    vfb.vf_bwd(x, w, gx, **kw, **extra)          # warm-up
    torch.cuda.synchronize()
    before = (ctypes.c_longlong * (1024 * 8))()
    after = (ctypes.c_longlong * (1024 * 8))()
    clk = (ctypes.c_longlong * (1024 * 16))()
    lib.vfb_part_read(ctypes.addressof(before))
    vfb.vf_bwd(x, w, gx, **kw, **extra)
    torch.cuda.synchronize()
    lib.vfb_part_read(ctypes.addressof(after))
    lib.vfb_clk_read(ctypes.addressof(clk))
    phases = np.array(clk[:], dtype=np.float64).reshape(1024, 16)[:, :12]
    parts = (np.array(after[:], dtype=np.float64)
             - np.array(before[:], dtype=np.float64)).reshape(1024, 8)
    total = phases.sum(1).mean()
    print(json.dumps({
        "shape": "B=1024 n=69/80 D=192 H=3 dh=768 bf16, deterministic",
        "cycles_per_image": total,
        "phase_share": {n: phases[:, i].mean() / total
                        for i, n in enumerate(PHASES)},
        "thread0_cycles": {n: parts[:, i].mean()
                           for i, n in enumerate(PARTS)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
