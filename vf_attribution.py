#!/usr/bin/env python3
"""Where the fused vector-field kernel spends its time, by knock-out.

Run from the repository root on a GPU:  python3 vf_attribution.py

Builds ``odevit_tpu_torch/csrc/vector_field.cu`` as it is and in variants
that each remove one piece (the MLP branch, the attention branch, the
softmax, the GELU, the tensor-core products together with the fragment
loads that feed them, or the reads of B fragments from device memory,
which then come from shared memory), all in parallel,
and times each at the serving shape (B=1024, 69 tokens padded to 80,
D=192, 3 heads, dh=768, bf16, Euler mode) with CUDA events. A variant
computes wrong values; only its time is used. The difference between the
full kernel and a variant is the time that piece costs on the critical
path. Prints one JSON line per variant and a summary line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

# (variant, [(text in the source, replacement)]): each text must be found,
# so an edit of the kernel that breaks a knock-out fails loudly.
KNOCKOUTS = {
    "no_mlp": [("for (int c0 = 0; c0 < s.dh; c0 += hc) {",
                "for (int c0 = 0; c0 < 0; c0 += hc) {")],
    "no_attention": [("for (int h = 0; h < s.heads; ++h) {",
                      "for (int h = 0; h < 0; ++h) {")],
    "no_softmax": [("    softmax_rows(stage, pl.ld_stage, p, pl.ld_p, n, "
                    "s.n_real, qk_scale);\n", "")],
    "no_gelu": [("from_f<T>(gelu(stage[r * pl.ld_stage + c]))",
                 "from_f<T>(stage[r * pl.ld_stage + c])")],
    "no_mma": [("          wmma::mma_sync(c[r], a, b, c[r]);\n", "")],
    "b_from_shared": [
        ("    const size_t bstep = BT ? 16 : (size_t)16 * ldb;\n", ""),
        ("    FragB b, b_next;",
         "    if (!BT && ldb > lda) {  // weights: read A's tile instead\n"
         "      bcol = A;\n"
         "      ldb = lda;\n"
         "    }\n"
         "    const size_t bstep = BT ? 16 : (size_t)16 * ldb;\n"
         "    FragB b, b_next;")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("vf_attribution: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from odevit_tpu_torch.kernels import build
    from odevit_tpu_torch.kernels import vector_field as vfm
    from odevit_tpu_torch.models.vit_ode import ViTODE

    src = open(os.path.join(root, "odevit_tpu_torch", "csrc",
                            "vector_field.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "attribution")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, edits in {"full": [], **KNOCKOUTS}.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: knock-out text not in source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    for name, (proc, _) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = ViTODE(img_size=32, patch_size=4, embed_dim=192, num_heads=3,
                   mlp_ratio=4.0, num_classes=100, emulate_depth=12.0,
                   time_interval=1.0, register_tokens=4, num_eval_steps=49,
                   solver="euler", dtype=torch.bfloat16, device="cuda",
                   seed=0)
    w = model.vf.kernel_weights(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1024, 80, 192, generator=g, device="cuda")
    x[:, 69:] = 0
    x = x.to(torch.bfloat16)
    kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=69, mode="euler",
              dt=1.0 / 48)
    times = {}
    for name, (_, lib) in jobs.items():
        vfm._lib = vfm._bind(ctypes.CDLL(lib))
        vfm.vf_eval(x, w, **kw)
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                vfm.vf_eval(x, w, **kw)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        times[name] = sorted(runs)[len(runs) // 2]
        print(json.dumps({"variant": name, "ms_median": times[name],
                          "ms_runs": runs}), flush=True)
    vfm._lib = None
    full = times["full"]
    print(smi, flush=True)
    print(json.dumps({"card": smi, "full_ms": full, "cost_ms": {
        name: full - times[name] for name in KNOCKOUTS}}), flush=True)
    return 0


if __name__ == "__main__":
    started = time.perf_counter()
    code = main()
    print(f"vf_attribution: {time.perf_counter() - started:.1f} s",
          file=sys.stderr)
    sys.exit(code)
