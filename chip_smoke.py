#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one GPU and checks them.

Run from the repository root:  python3 chip_smoke.py

Phases:
  1. card: name and power limit; build of every CUDA source (parallel nvcc);
     then ``wgrad_vs_plain``: the weight products of every backward
     alone, bf16 (``vfb_wgrad_wgmma``) at each training cell's shape and
     f32 (``vfb_wgrad_tf32``, split TF32) at the f32 ViTODE backwards',
     against a float64 product, repeats, NaN rows and columns, spills,
     their time beside ``torch.matmul``, the Python split rules against
     the C one; every training phase below checks by the C counters that
     each bf16 backward launched the bf16 kernel once (twice a Macaron
     backward), each f32 ViTODE backward the f32 kernel once, and the f32
     Macaron backwards neither; ``bf16_gemm_vs_plain``: the tiled route's
     bf16 products alone (``vft_gemm_wgmma``) at the 224 px, 384 px and
     ratio-4 shapes against float64 and ``torch.matmul``, every epilogue
     at a ragged shape; every bf16 tiled training and serving phase
     checks by its C counter that the route launched it as many times as
     its wrappers say;
  2. kernel vs plain: ``vf_eval`` against ``vf_eval_plain`` at the serving
     shape (B=64, 69 tokens padded to 80, D=192, 3 heads, dh=768), modes
     plain / euler / base, in bf16 and f32, and with garbage and NaN in
     the padded rows;
  3. main path: ``fast_forward`` of the CIFAR-100 ViTODE (32 px, patch 4,
     D=192, 3 heads, mlp 4, 4 registers, bf16) at B=1024, Euler on 49 grid
     points and rk4 on 13 (48 evaluations each), through the kernel and
     through the plain path; logits compared, both timed with CUDA events;
  4. serving: a ServingEngine with buckets (1, 8, 32, 128) answers 16 uint8
     requests of 1-37 images from 4 threads; each answer is held against a
     direct ``fast_forward`` of the same images;
  5. training kernels vs plain: ``vf_eval_jasmin`` against
     ``vf_eval_jasmin_plain`` and ``vf_bwd`` (with and without the JaSMin
     cotangent) against ``vf_bwd_plain`` at the training shape (B=64), in
     bf16 and f32, with tied keys, with peaked rows (p == 1.0) and with
     garbage and NaN in the padded rows; every statistic's column lies on
     exactly one real key; two backward runs are bit-identical;
  6. training main path: 3 steps of ``make_fast_free_train_step`` (rk4 on
     13 points, JaSMin k=10, AdamW, bf16) at B=1024 through the kernels
     and through the plain path from the same weights; losses and the
     first gradient compared, launches counted, steps timed;
  7. the training kernels alone at B=1024 against their plain versions;
     then the f32 cell cifar100-vitode-train-b1024-f32: phase 6 with an
     f32 model, through the kernels and the plain path, profiled (48
     ``vf_kernel_f32`` and 48 ``vfb_rows_f32`` a step by their C
     counters, none of the CUDA-core f32 instances they replaced), and
     ``train_f32_kernel_timing``: those two kernels alone at its state
     (base, Euler, JaSMin, dropout 0.1; the backward ± the JaSMin
     cotangent) beside split TF32's floor, their registers and spills,
     and the tiled route's f32 forward and backward as a yardstick; every
     kernel-vs-plain phase holds its f32 calls' one-CTA launches against
     the same C counters;
  8. dropout masks: the generator kernel (``generate_dropout_masks``) at
     B=1024 against the plain generator, bit for bit, for three seeds;
     values, keep rates, and masks that change with seed, site, head and
     image but not with the launch;
  9. dropout kernels vs plain: the dropout instances of ``vf_eval``,
     ``vf_eval_jasmin`` and ``vf_bwd`` (with and without the JaSMin
     cotangent) at B=64 in bf16 and f32; repeated backwards bit-identical,
     NaN padding inert, rates of 0 on the deterministic instance;
  10. training with dropout (cell cifar100-vitode-train-drop0.1-b1024-bf16):
     phase 6 at the recipe's dropout 0.1, through the kernels' dropout
     instances and the plain path from the same weights and rng, beside
     phase 6's img/s;
  11. the dropout kernels and the generator alone at B=1024;
  12. distillation kernels vs plain: the tiled route at the TS-Base shape
     (B=4, 207 tokens padded to 208, D=768, 12 heads, dh=768), in bf16 and
     f32: the forward in its plain, JaSMin (k=2) and attention-map modes,
     the backward with the dx cotangent, the JaSMin cotangent and the
     map cotangent, against their plain versions; statistics' columns on
     real keys, repeated backwards bit-identical, NaN padding inert;
  13. distillation main path (cell tsref-distill-b64-bf16): 3 steps of
     ``make_fast_distill_train_step`` (224 px TS-Base student, ViT-B/16
     teacher, Euler on 36 points, JaSMin k=2, L1 attention loss,
     supervised, B=64, bf16) through the kernels and through the plain
     path; losses and the first gradient compared, launches counted, the
     step timed and split, one step profiled;
  14. the tiled kernels alone at B=64 against their plain versions; then
     the f32 cell tsref-distill-b64-f32: phase 13 with an f32 student,
     through the kernels and the plain path, profiled;
  15. distillation dropout kernels vs plain: the tiled route's dropout
     instances at B=4 in bf16 and f32, forward in its three modes and the
     backward with each cotangent, against their plain versions; maps and
     statistics equal to the deterministic ones (pre-dropout p); mixed
     rates; rates of 0 on the deterministic instances; repeats
     bit-identical; NaN padding inert;
  16. distillation with dropout (cell tsref-distill-drop0.1-b64-bf16):
     phase 13 at the recipe's dropout 0.1 with ``rng=0``, through the
     tiled dropout instances and the plain path, beside phase 13's img/s;
  17. the tiled dropout instances alone at B=64;
  18. split backward vs plain: the ratio-4 student's shape (B=4, 197
     tokens padded to 208, D=768, dh=3072) in bf16 and f32: the tiled
     forward's modes at dh=3072, the split backward's MLP and attention
     halves alone and chained through ``vf_bwd``, with each cotangent and
     with and without dropout, against their plain twins; the split route
     against the tiled route's backward (at ratio 1 too); repeats
     bit-identical; NaN padding inert;
  19. distillation at MLP ratio 4 (cell tsbase-r4-distill-b64-bf16): 3
     steps of the student ``bench_distill`` builds (224 px uint8, Euler on
     37 points, JaSMin k=2, supervised, B=64, bf16) through the kernels and
     the plain path; every backward on the split route;
  20. the ratio-4 kernels alone at B=64: the tiled forward at dh=3072, the
     split halves and the pair, and the tiled backward at the same shape;
  21. phases 19 and 20 at dropout 0.1 (cell
     tsbase-r4-distill-drop0.1-b64-bf16, ``rng=0``);
  22. L2 attention at the CIFAR shape (cell
     cifar100-vitode-l2-train-b1024-bf16, JAX's ``l2_b1024``): the L2+bias
     instances against their plain versions at B=4 (bf16 and f32, nonzero
     biases, an underflow case, NaN padding, repeats), the Python L2 plans
     against the CUDA ones, the L2 model served at rk4-13 (B=1024), through
     the engine and by dopri5 (f32, B=8), 3 free-training steps at B=1024
     through the L2 instances and the plain path, and each L2 instance
     alone at B=1024 (it runs after phase 11);
  23. the Macaron family (cells cifar100-macaron-serve-rk4-13-b1024 and
     cifar100-macaron-train-b1024, JAX's ``macaron_b1024``; it runs after
     phase 22): ``macaron_eval`` in its three modes and ``macaron_bwd``
     (16 cotangents) against their plain versions at B=4 in bf16 and f32
     (perturbed weights, NaN padding, in f32 a NaN in a real row
     reaching what it reaches in the plain version, repeats, the Python
     plans against the CUDA ones and their one-CTA backward counts); the
     bf16 model (float32 states by promotion) served at B=1024 by rk4 on
     13 points (48 launches) and Euler on 13 (12), and through the
     engine; 3
     training steps through the kernels and the plain path; each
     instance alone at B=1024 (the f32 backward's kernels by profiler;
     the f32 bounds are split TF32's floor);
  24. the fused steps' map route and emit_masks (after phase 11): the free
     step on a 9-token sequence (CIFAR width at patch 16, k=9, rk4-13,
     B=1024, ± dropout 0.1), JaSMin from the maps, through the kernels
     and the plain path (``map_route``); the emit_masks instance at
     ``benchmarks/tpu_dropout_check.py``'s shape against a PyTorch copy
     of its twin, the generator kernel and autograd (``dropout_check``);
  25. L2 attention past one CTA (after phase 21; cells
     tsbase-l2-train-b64-bf16 and tsbase-l2-serve-euler36-b64-bf16): the
     tiled route's L2 instances against their plain versions at B=4 and
     on the cell's state at B=64 (bf16 and f32; the Python plan rule
     against ``vft_plan``), 3 training steps of the TS-Base student with
     ``l2_attention`` (``evidence_free_base.yaml`` at dropout 0) through
     the kernels and the plain path, the softmax student's step beside
     it, and the student served at euler-36 and through the engine;
  26. the Macaron family past one CTA (after phase 25; cells
     cifar224-macaron-r2-train-b64 and
     cifar224-macaron-r2-serve-euler24-b64: experiment_vit_edo.yaml's
     width as a ViTMacaron, 224 px, D=768, 12 heads, MLP ratio 2, f32,
     197 tokens padded to 208): the tiled route's forward in its three
     modes and its backward (16 cotangents) against the plain versions
     at B=4 in bf16 and f32 (repeats, NaN padding, in f32 a NaN in a real
     row reaching what it reaches in the plain version, the Python tiled
     plan against ``mct_plan``); 3 training steps (Euler on 24 points, B=64,
     32 px resized on the card) through the kernels and the plain path;
     each instance alone at B=64 (the f32 forward's and backward's kernels
     per launch); the model served at euler-24 and rk4-7 and through the
     engine; before them ``tf32_gemm_vs_plain``: ``vft_gemm_tf32``, the
     route's f32 product kernel, alone at the cell's 8 products (13,312
     rows) against a float64 product and timed beside ``torch.matmul`` in
     full f32, every epilogue at a ragged shape, NaNs with every
     mantissa bit set, its spills;
  27. residual stashing (after phase 21; the stash arms of cells
     cifar100-vitode-train-b1024-bf16, tsref-distill-b64-bf16 and
     tsbase-r4-distill-b64-bf16): ``stash_kernels_vs_plain`` (B=4 on the
     one-CTA, tiled and split routes, bf16 and f32: f(x) bit-identical to
     the non-stash instances', rqkv, rh1 and the cotangents against the
     plain stash versions and the resid backward against the recompute
     backward, repeats, NaN padding, launches), ``stash_train`` (each
     cell's stash arm through the kernels and the plain path over 3
     steps; then the stash and recompute arms on the kernels from the same
     weights, their first steps compared, alternated steps timed, peak
     memory, one profiled backward each in ``stash_train_profile``) and
     ``stash_kernel_timing`` (each stash instance at its cell's state);
  then the serving slice at 224 px (``serve_224``,
  ``serve_224_kernel_timing``, ``chain_vs_per_step``, ``serving_224``);
  28. sequences past 256 padded tokens (after the serving slice; cells
     tsbase384-free-train-drop0.1-b64-bf16 and
     tsbase384-serve-euler36-b64-bf16: evidence_free_base.yaml's student
     at 384 px, 587 tokens padded to 592): ``long_kernels_vs_plain``
     (every key-tiled instance of the tiled route, its split backward and
     the Macaron tiled route against the plain versions at B=2, 261/272
     and 587/592 tokens, bf16 and f32; repeats, NaN padding, the emitted
     masks against the generator, the plans up to 1,024 padded tokens;
     the bf16 backward's ``vft_attn_kt_bwd`` / ``vft_attn_keys_kt2`` also
     at head widths 16, 192 and 288, and their registers and spills from
     ``-Xptxas -v``), ``long_train`` (3 steps at B=8 through the kernels
     and the plain path, then 3 kernel steps at B=64: img/s, split, peak
     memory, busy share, launches), ``long_serving`` (Euler-36 at B=64
     against the plain path, timed; the engine as
     ``long_serving_engine``) and ``long_kernel_timing`` (each key-tiled
     instance alone at B=64; the bf16 backwards' key-tiled CTAs by the
     libraries' launch counts (PR 16's pair, no old CTA), their kernels
     per launch with the attention pair's own bound; the ratio-4 MLP half
     at 592 tokens;
     ``scaled_dot_product_attention`` forward + backward as a yardstick);
  last, the kernels line (launch counts of the main paths, times, bounds)
  and the result line.

Exits non-zero, printing no result line, when a phase fails or when there
is no CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

# The card's published peaks (NVIDIA H100 SXM data sheet, dense bf16 and
# TF32).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer instructions outside the tensor cores issue on two pipes
# of 64 lanes per SM each: multiplies (IMAD, IMAD.HI) on the FMA pipe,
# additions, logic and compares (IADD3, LOP3, ISETP) on the ALU pipe; 132
# SMs x 64 x 1.98 GHz per pipe. One Philox4x32-10 call (4 words) takes per
# round two 32x32 -> 64 products, a low and a high half each: 40 on the FMA
# pipe. The ALU pipe takes fewer: two three-way xors per round (20) and the
# 4 keep compares. The key schedule depends on the site's seed only, so it
# is per launch, not per call. The FMA pipe bounds the masks.
PEAK_INT32_PIPE_OPS = 16.7e12
PHILOX_FMA_PIPE_OPS = 40

# Tolerances, as max|kernel - plain| / max|plain|.
#  f32: the same arithmetic with sums in another order and erff for erf;
#       float32 noise is ~1e-6 of the scale.
#  bf16: five intermediates (cn, gelu(h), qkv, p, ctx) round to bf16; where
#       the two versions sum in another order one of them can round to the
#       neighbouring bf16 value (2^-8 relative) and carry that on.
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# Logits after 48 bf16 evaluations: the per-evaluation differences above
# compound through the integration.
TOL_LOGITS = 5e-2
MIN_TOP1_AGREEMENT = 0.95
# Training through the kernels vs the plain path, bf16, B=1024: the loss
# of each of 3 steps, and the direction of the first gradient.
TOL_TRAIN_LOSS = 1e-2
MIN_GRAD_COSINE = 0.99
TRAIN_STEPS = 3
JASMIN_K = 10
# Dropout (configs/classification/evidence_free_cifar.yaml:53-55): attn,
# proj and mlp rates; the step's rng; the generator's seeds (int32 edges
# among them).
DROP_RATES = (0.1, 0.1, 0.1)
DROP_RNG = 0
DROP_SEEDS = (-2 ** 31, -1, 1234567)
MIN_KEEP, MAX_KEEP = 0.898, 0.902

BATCH = 1024
SHAPE = dict(img_size=32, patch_size=4, embed_dim=192, num_heads=3,
             mlp_ratio=4.0, num_classes=100, emulate_depth=12.0,
             time_interval=1.0, register_tokens=4,
             pos_embed_register_tokens=False)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_err(got, want, mask=None):
    import torch
    g, w = got.float(), want.float()
    if mask is not None:
        g, w = g[:, mask], w[:, mask]
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def vf_bound(b: int, n_real: int, d: int, dh: int, itemsize: int,
             states: int = 2, evals: int = 1):
    """(bound_ms, bound_by) of ``evals`` evaluations in one launch:
    operations at the real token count over the bf16 peak, against the
    ``states`` state tensors read or written once (x in and out; the stage
    advance also reads its base) plus the weights over the memory rate."""
    flops = evals * b * (n_real * (8 * d * d + 4 * d * dh)
                         + 4 * n_real * n_real * d)
    nbytes = ((states * b * n_real * d + 4 * d * d + 2 * d * dh) * itemsize
              + 16 * d)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from odevit_tpu_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.build_logs.items()}
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(seconds, 2), libraries=sorted(libs),
         ptxas=ptxas)
    return smi


def phase_kernel_vs_plain(model):
    import torch
    from odevit_tpu_torch.kernels.vector_field import vf_eval
    b, n_real, n_pad, d = 64, model.patch_embed.seq_len, 80, 192
    check(n_real == 69, f"slice shape has 69 tokens, got {n_real}")
    g = torch.Generator(device="cuda").manual_seed(1)
    results = []
    tally = F32Tally()
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        tally.start(dtype)
        w = model.vf.kernel_weights(dtype)
        x = torch.randn(b, n_pad, d, generator=g, device="cuda")
        x[:, n_real:] = 0
        x = x.to(dtype)
        base = torch.randn(b, n_pad, d, generator=g, device="cuda").to(dtype)
        kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real)
        for mode, extra in (("plain", {}), ("euler", {"dt": 1.0 / 48}),
                            ("base", {"dt": 1.0 / 16, "base": base})):
            got = vf_eval(x, w, mode=mode, **kw, **extra)
            want = vf_eval(x, w, mode=mode, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            err = rel_err(got[:, :n_real], want[:, :n_real])
            results.append({"dtype": str(dtype), "mode": mode,
                            "rel_err": err, "tol": tol})
            check(err <= tol, f"{dtype} {mode}: rel err {err} > {tol}")
        # padded rows full of garbage and NaN must not reach a real row
        dirty = x.clone()
        dirty[:, n_real:n_real + 5] = float("nan")
        dirty[:, n_real + 5:] = 1e30
        clean = vf_eval(x, w, mode="euler", dt=1.0 / 48, **kw)
        got = vf_eval(dirty, w, mode="euler", dt=1.0 / 48, **kw)
        torch.cuda.synchronize()
        real = got[:, :n_real]
        check(bool(torch.isfinite(real).all()),
              f"{dtype}: NaN padding reached a real row")
        same = bool(torch.equal(real, clean[:, :n_real]))
        check(same, f"{dtype}: padded rows changed real rows")
        results.append({"dtype": str(dtype), "mode": "euler, NaN padding",
                        "real_rows_unchanged": same})
        tally.stop(dtype)
    # a second, small shape (D=64, 2 heads, dh=128, 19 tokens padded to
    # 32), where the kernel takes its other plan (q|k|v in one product)
    from odevit_tpu_torch.kernels.vector_field import VFWeights, kernel_plan
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        tally.start(dtype)

        def r(*shape, scale=0.2, shift=0.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale
                    + shift)
        w = VFWeights(r(64, shift=1.0), r(64), r(64, shift=1.0), r(64),
                      *(r(*s).to(dtype) for s in ((64, 192), (64, 64),
                                                  (64, 128), (128, 64))))
        x = r(8, 32, 64, scale=1.0).to(dtype)
        base = r(8, 32, 64, scale=1.0).to(dtype)
        kw = dict(num_heads=2, scaler=4.0, n_real=19)
        for mode, extra in (("plain", {}), ("euler", {"dt": 0.25}),
                            ("base", {"dt": 0.125, "base": base})):
            got = vf_eval(x, w, mode=mode, **kw, **extra)
            want = vf_eval(x, w, mode=mode, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            err = rel_err(got[:, :19], want[:, :19])
            results.append({"dtype": str(dtype), "mode": mode,
                            "shape": "B=8 n=19/32 D=64 H=2 dh=128",
                            "plan": kernel_plan(dtype, 32, 19, 64, 2, 128),
                            "rel_err": err, "tol": tol})
            check(err <= tol, f"small {dtype} {mode}: rel err {err} > {tol}")
        tally.stop(dtype)
    results.append(tally.check("kernel_vs_plain"))
    # a shape without a one-image-per-CTA plan (the 224 px TS-Base
    # evaluation: 207 tokens, D=768, 12 heads) takes the tiled route's
    # Euler and stage-advance modes
    results += tiled_advance_vs_plain(g)
    emit("kernel_vs_plain", results=results)


def tiled_advance_vs_plain(g):
    """The tiled route's Euler and stage-advance modes at B=4, 207/208
    tokens, D=768, 12 heads, dh=768 (random weights of the spectral
    scale), in bf16 and f32, against ``vf_eval_plain``; NaN and garbage in
    the padded rows stay there; each launch lands on its counter."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import VFWeights, vf_eval
    b, n_real, n_pad, d = 4, 207, 208, 768
    kw = dict(num_heads=12, scaler=12.0, n_real=n_real)
    results = []
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        def r(*shape, scale=d ** -0.5, shift=0.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale
                    + shift)
        w = VFWeights(r(d, shift=1.0), r(d), r(d, shift=1.0), r(d),
                      *(r(*s).to(dtype) for s in ((d, 3 * d), (d, d), (d, d),
                                                  (d, d))))
        x = r(b, n_pad, d, scale=1.0)
        x[:, n_real:] = 0
        x = x.to(dtype)
        base = r(b, n_pad, d, scale=1.0).to(dtype)
        for mode, extra in (("euler", {"dt": 1.0 / 24}),
                            ("base", {"dt": 1.0 / 18, "base": base})):
            counts = dict(launch_counts)
            got = vf_eval(x, w, mode=mode, **kw, **extra)
            torch.cuda.synchronize()
            routed = {k: launch_counts[k] - counts[k] for k in counts
                      if launch_counts[k] != counts[k]}
            check(routed == {f"vf_eval_{mode}_tiled": 1},
                  f"tiled {mode} {dtype} launched {routed}")
            want = vf_eval(x, w, mode=mode, plain=True, **kw, **extra)
            err = rel_err(got[:, :n_real], want[:, :n_real])
            results.append({"dtype": str(dtype), "mode": mode,
                            "route": "tiled", "launched": routed,
                            "shape": "B=4 n=207/208 D=768 H=12 dh=768",
                            "rel_err": err, "tol": tol})
            check(err <= tol, f"tiled {dtype} {mode}: rel err {err} > {tol}")
            # padded rows full of garbage and NaN (in x and in the base)
            # must not reach a real row
            dirty, dbase = x.clone(), base.clone()
            for t in (dirty, dbase):
                t[:, n_real:] = float("nan")
            dextra = {**extra, "base": dbase} if mode == "base" else extra
            got_d = vf_eval(dirty, w, mode=mode, **kw, **dextra)
            torch.cuda.synchronize()
            same = bool(torch.equal(got_d[:, :n_real], got[:, :n_real]))
            results.append({"dtype": str(dtype), "mode": f"{mode}, NaN "
                            f"padding", "real_rows_unchanged": same})
            check(same, f"tiled {dtype} {mode}: padded rows reached a "
                  f"real row")
    return results


def phase_main_path(models, images_u8):
    import torch
    from odevit_tpu_torch.core.integrators import nfe
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    preprocess = make_preprocess(dtype=torch.bfloat16)
    x = preprocess(images_u8)
    report = {}
    for name, model in models.items():
        evals = nfe(model.solver, model.num_eval_steps)
        reset_launch_counts()
        got = fast_forward(model, x)["logits"]
        torch.cuda.synchronize()
        launches = launch_counts["vf_eval"]
        check(launches == evals,
              f"{name}: {launches} kernel launches, expected {evals}")
        want = fast_forward(model, x, plain=True)["logits"]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
        check(tuple(got.shape) == (BATCH, 100), f"{name}: shape {got.shape}")
        err = rel_err(got, want)
        top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        ms = cuda_ms(lambda: fast_forward(model, x), iters=5)
        plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True),
                           iters=2)
        report[name] = {
            "launches": launches, "nfe": evals,
            "max_abs_dlogit": (got - want).abs().max().item(),
            "rel_err": err, "tol": TOL_LOGITS, "top1_agreement": top1,
            "ms_per_forward": ms, "img_per_s": BATCH / ms * 1e3,
            "ms_per_eval": ms / evals, "plain_ms_per_forward": plain_ms,
            "plain_img_per_s": BATCH / plain_ms * 1e3}
        check(err <= TOL_LOGITS, f"{name}: logits rel err {err}")
        check(top1 >= MIN_TOP1_AGREEMENT, f"{name}: top-1 agreement {top1}")
    emit("main_path", batch=BATCH, results=report)
    return x, report


def phase_vf_timing(model, x):
    """The kernel alone at the main path's shape: its first Euler step on
    the B=1024 tokens, against the plain version on the same inputs."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import pad_tokens, vf_eval
    with torch.inference_mode():
        tokens = model.patch_embed(x)
        n_real = tokens.shape[1]
        tokens = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real))
        w = model.vf.kernel_weights(torch.bfloat16)
        kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real,
                  mode="euler", dt=1.0 / 48)
        before = launch_counts["vf_eval"]
        got = vf_eval(tokens, w, **kw)
        want = vf_eval(tokens, w, plain=True, **kw)
        torch.cuda.synchronize()
        err = (got[:, :n_real].float() - want[:, :n_real].float()).abs()
        ms = cuda_ms(lambda: vf_eval(tokens, w, **kw), iters=20)
        plain_ms = cuda_ms(lambda: vf_eval(tokens, w, plain=True, **kw),
                           iters=3)
        launch_counts["vf_eval"] = before      # comparisons do not count
    bound_ms, bound_by = vf_bound(BATCH, n_real, 192, 768, 2)
    check(rel_err(got, want, slice(0, n_real)) <= TOL_BF16,
          "B=1024 euler step disagrees with the plain version")
    return {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_serving(model, rng, counter="vf_eval", name="serving"):
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    from odevit_tpu_torch.serve.engine import ServingEngine
    preprocess = make_preprocess(dtype=torch.bfloat16)
    sizes = [int(s) for s in rng.integers(1, 38, 16)]
    requests = [rng.integers(0, 256, (s, 32, 32, 3), dtype=np.uint8)
                for s in sizes]
    answers = [None] * len(requests)
    with ServingEngine(model, batch_buckets=(1, 8, 32, 128),
                       preprocess=preprocess, max_delay_ms=2.0,
                       device="cuda") as engine:
        reset_launch_counts()

        def client(k):
            futs = [(i, engine.submit(requests[i]))
                    for i in range(k, len(requests), 4)]
            for i, fut in futs:
                answers[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "serving hung")
        launches = launch_counts[counter]
        stats = engine.stats()
    evals = 48
    check(launches == evals * stats["runs"],
          f"serving: {launches} launches for {stats['runs']} runs")
    worst, identical = 0.0, 0
    for req, got in zip(requests, answers):
        check(got is not None and got.shape == (len(req), 100),
              "serving: missing or misshapen answer")
        x = preprocess(torch.from_numpy(req).cuda())
        want = fast_forward(model, x)["logits"].cpu().numpy()
        identical += int(np.array_equal(got, want))
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    emit(name, requests=len(requests), sizes=sizes,
         identical_answers=identical, worst_rel_err=worst, tol=TOL_LOGITS,
         launches=launches, stats=stats)
    check(worst <= TOL_LOGITS, f"serving answers differ: {worst}")
    return launches


def bwd_bound(b: int, n_real: int, d: int, dh: int, heads: int,
              itemsize: int, map_cotangent: bool = False):
    """(bound_ms, bound_by) of one backward: the recomputed forward
    products (h1, qkv, q k^T, p v) and two products for each product of
    the forward, at the real token count, over the bf16 peak; against x
    and g in, x_bar out, the weights in and the 8 float32 cotangents out,
    plus the JaSMin cotangent and columns (and with ``map_cotangent`` the
    maps' cotangent), over the memory rate."""
    flops = b * (n_real * (10 * d * dh + 22 * d * d)
                 + 12 * n_real * n_real * d)
    weights = 4 * d * d + 2 * d * dh
    nbytes = ((3 * b * n_real * d + weights) * itemsize
              + (weights + 4 * d) * 4 + b * heads * n_real * (5 + 4) * 4)
    if map_cotangent:
        nbytes += b * heads * n_real * n_real * itemsize
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def jasmin_bound(b: int, n_real: int, d: int, dh: int, heads: int,
                 itemsize: int, kk: int):
    """(bound_ms, bound_by) of one JaSMin-mode evaluation: the forward's
    products plus kk compare passes over each real attention row (counted
    at the bf16 rate, a lower bound), against the forward's bytes plus the
    statistics and columns written."""
    flops = (b * (n_real * (8 * d * d + 4 * d * dh) + 4 * n_real * n_real * d)
             + b * heads * n_real * n_real * kk)
    nbytes = ((2 * b * n_real * d + 4 * d * d + 2 * d * dh) * itemsize
              + 16 * d + b * heads * n_real * (5 + 4) * 4)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def train_case(model, b, dtype, kind, g):
    """Inputs of one training evaluation at the slice shape: weights (the
    model's, or with q/k columns scaled so that rows saturate), a padded
    state, its cotangent and a JaSMin cotangent (zero on padded rows)."""
    import torch
    n_real, n_pad, d, heads = model.patch_embed.seq_len, 80, 192, 3
    w = model.vf.kernel_weights(dtype)
    if kind == "peaked":
        wqkv = w.wqkv.float().clone()
        wqkv[:, :2 * d] *= 8.0
        w = w._replace(wqkv=wqkv.to(dtype).contiguous())
    x = torch.randn(b, n_pad, d, generator=g, device="cuda")
    if kind == "ties":
        x[:, 5:11] = x[:, 5:6]
    x[:, n_real:] = 0
    gx = torch.randn(b, n_pad, d, generator=g, device="cuda") * 1e-2
    gx[:, n_real:] = 0
    gj = torch.randn(b, heads, 5, n_pad, generator=g, device="cuda") * 1e-2
    gj[..., n_real:] = 0
    return w, x.to(dtype), gx.to(dtype), gj


def phase_train_kernels_vs_plain(model):
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (vf_eval_jasmin,
                                                       vf_eval_jasmin_plain)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd, vf_bwd_plain
    names = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
             "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
    b, n_real = 64, model.patch_embed.seq_len
    kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real)
    g = torch.Generator(device="cuda").manual_seed(2)
    before = dict(launch_counts)
    results = []
    tally = F32Tally()
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        tally.start(dtype)
        kinds = ("random", "ties", "peaked") if dtype == torch.bfloat16 \
            else ("random", "ties")
        for kind in kinds:
            w, x, gx, gj = train_case(model, b, dtype, kind, g)
            r = {"dtype": str(dtype), "case": kind, "tol": tol,
                 "shape": f"B={b} n={n_real}/80 D=192 H=3 dh=768"}
            dx, st, idx = vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw)
            pdx, pst, pidx = vf_eval_jasmin_plain(x, w, jas_k=JASMIN_K, **kw)
            torch.cuda.synchronize()
            r["jasmin_fwd"] = {
                "dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                "stats": rel_err(st[..., :n_real], pst[..., :n_real]),
                "idx_agreement": (idx[..., :n_real] == pidx[..., :n_real])
                .float().mean().item(),
                "rows_at_1.0": int((st[:, :, 0, :n_real] == 1.0).sum())}
            check(r["jasmin_fwd"]["dx"] <= tol and
                  r["jasmin_fwd"]["stats"] <= tol,
                  f"jasmin fwd {dtype} {kind}: {r['jasmin_fwd']}")
            # every statistic's cotangent lands on exactly one column: each
            # (row, rank) column is a real key, distinct from the row's
            # other ranks' columns (k=10: ranks 1, 2, 10, 11 differ)
            cols = idx[..., :n_real].long()
            real = (cols >= 0) & (cols < n_real)
            distinct = torch.stack([
                torch.stack([cols[:, :, i] != cols[:, :, j]
                             for j in range(4) if j != i]).all(0)
                for i in range(4)], dim=2)
            hit = real & distinct
            r["scatter"] = {"entries": cols.numel(),
                            "hit_once": int(hit.sum())}
            check(r["scatter"]["hit_once"] == r["scatter"]["entries"],
                  f"jasmin columns {dtype} {kind}: {r['scatter']}")
            if kind == "peaked" and dtype == torch.bfloat16:
                check(r["jasmin_fwd"]["rows_at_1.0"] > 0,
                      "the peaked case has no row at 1.0")
            for jas in (False, True):
                extra = dict(g_jas=gj, jas_idx=idx) if jas else {}
                got = vf_bwd(x, w, gx, **kw, **extra)
                want = vf_bwd_plain(x, w, gx, **kw, **extra)
                again = vf_bwd(x, w, gx, **kw, **extra)
                torch.cuda.synchronize()
                errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                    b_[:, :n_real] if nm == "x" else b_)
                        for nm, a, b_ in zip(names, got, want)}
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                r["bwd_jas" if jas else "bwd"] = errs
                r["repeat_bit_identical" + ("_jas" if jas else "")] = same
                check(max(errs.values()) <= tol,
                      f"bwd {dtype} {kind} jas={jas}: {errs}")
                check(same, f"bwd {dtype} {kind} jas={jas} not repeatable")
            if kind == "random":
                # garbage and NaN in the padded rows change no real row
                dirty = x.clone()
                dirty[:, n_real:n_real + 5] = float("nan")
                dirty[:, n_real + 5:] = 1e30
                gdirty = gx.clone()
                gdirty[:, n_real:] = 7.0
                ddx, dst, didx = vf_eval_jasmin(dirty, w, jas_k=JASMIN_K,
                                                **kw)
                dbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx, **kw)
                cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, **kw)
                torch.cuda.synchronize()
                same = (torch.equal(ddx[:, :n_real], dx[:, :n_real])
                        and torch.equal(dst, st) and torch.equal(didx, idx)
                        and all(torch.equal(a, c)
                                for a, c in zip(dbars, cbars)))
                r["nan_padding_unchanged"] = same
                check(same, f"{dtype}: padded rows reached a real row")
            results.append(r)
        tally.stop(dtype)
    results.append(tally.check("train_kernels_vs_plain"))
    launch_counts.update(before)           # comparisons do not count
    emit("train_kernels_vs_plain", results=results)


def grad_vector(model):
    import torch
    return torch.cat([p.grad.float().reshape(-1)
                      for p in model.parameters()])


def profile_step(step, state, batch, top: int = 12):
    """One more training step under torch.profiler: device time by kernel
    (the largest ``top``; device events only, as host operators also carry
    the time of the kernels they launch) and the device's busy share of
    the step's wall time (kernel time over the step's host-clock time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    gone = (OLD_WGRADS + OLD_F32_CTA + OLD_BF16_CTA + OLD_KT_BF16
            + (OLD_GEMM_BF16,))
    old = [k for k, _, _ in rows if any(o in k for o in gone)]
    check(not old, f"profiled step ran {gone}: {old}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:top]]}


def train_runs(images_u8, labels, drops=None, l2=False, model_fn=None,
               pre=None, jasmin_k=JASMIN_K, stash=False):
    """3 steps through the kernels and through the plain path from the same
    weights and batch (with ``drops``, the model's dropout rates, and the
    same rng; with ``l2``, of the L2-attention model); then one more step
    of each timed by CUDA events around its parts, and one profiled step of
    the kernel path. The model is the CIFAR rk4-13 ViTODE unless
    ``model_fn(rates)`` (rates: the dropout keywords) gives another, fed
    through ``pre`` (default: the CIFAR preprocess); ``stash`` is the
    step's. Returns (runs, profile, first-gradient cosine, loss
    differences, launches per step)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.vit_ode import ViTODE
    from odevit_tpu_torch.train.fast_steps import (draw_step_seeds,
                                                   fast_free_forward,
                                                   make_fast_free_train_step)
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    pre = pre or make_preprocess(dtype=torch.bfloat16)
    batch = {"pixel_values": images_u8, "labels": labels}
    rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), drops or ()))
    rng = DROP_RNG if drops else None
    nb = images_u8.shape[0]
    runs = {}
    for path in ("kernels", "plain"):
        model = (model_fn(rates) if model_fn is not None else ViTODE(
            **SHAPE, num_eval_steps=13, solver="rk4", dtype=torch.bfloat16,
            device="cuda", seed=0, l2_attention=l2, **rates))
        state = create_train_state(model, make_optimizer(1e-4))
        step = make_fast_free_train_step(model, jasmin_k=jasmin_k,
                                         preprocess_fn=pre,
                                         plain=path == "plain", stash=stash)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "kernels":
            reset_launch_counts()
            wgrad0 = wgrad_launches()
            gemm0 = gemm_launches()
            cta0 = f32_cta_launches()
            rows0 = rows_bf16_launches()
        losses, ms, metrics, first_grad = [], [], None, None
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng=rng)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            if i == 0:
                first_grad = grad_vector(model)
        launches = dict(launch_counts) if path == "kernels" else None
        wgrad = wgrad_since(wgrad0) if path == "kernels" else None
        gemm = (gemm_launches() - gemm0 if path == "kernels"
                else None)
        cta = f32_cta_since(cta0) if path == "kernels" else None
        rows = (rows_bf16_launches() - rows0 if path == "kernels"
                else None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one more step, timed by CUDA events around its parts
        seeds = (draw_step_seeds(rng, state.step, model.num_eval_steps - 1)
                 if drops else None)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = fast_free_forward(model, pre(images_u8), labels,
                                    jasmin_k=jasmin_k, step_seeds=seeds,
                                    plain=path == "plain", stash=stash)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        if path == "kernels":
            profile = profile_step(lambda s, b: step(s, b, rng=rng), state,
                                   batch)
        runs[path] = {
            "loss": losses, "ms_per_step": ms,
            "img_per_s": nb / min(ms) * 1e3,
            "img_per_s_best_of_2_3": nb / min(ms[1:]) * 1e3,
            "jasmin_loss_last": metrics["jasmin_loss"].item(),
            "grad_norm_last": metrics["grad_norm"].item(),
            "acc_last": metrics["acc"].item(), "peak_mem_gb": peak,
            "split_ms": {"forward": ev[0].elapsed_time(ev[1]),
                         "backward": ev[1].elapsed_time(ev[2]),
                         "optimizer": ev[2].elapsed_time(ev[3])},
            "launches": launches, "wgrad_launches": wgrad,
            "gemm_launches": gemm,
            "f32_cta_launches": cta, "rows_bf16_launches": rows,
            "first_grad": first_grad}
        del model, state, step
    k, p = runs["kernels"], runs["plain"]
    cos = torch.nn.functional.cosine_similarity(
        k.pop("first_grad"), p.pop("first_grad"), dim=0).item()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])]
    per_step = {n: c / TRAIN_STEPS for n, c in k["launches"].items()}
    return runs, profile, cos, loss_rel, per_step


def wgrad_launches() -> dict:
    """The weight-product kernels' launches so far, by the C counters of
    every library that compiles them (``kernels/wgrad.py``): {"bf16":
    ``vfb_wgrad_wgmma``'s, "f32": ``vfb_wgrad_tf32``'s}."""
    import torch
    from odevit_tpu_torch.kernels.wgrad import wgrad_launches as count
    return {"bf16": count(torch.bfloat16), "f32": count(torch.float32)}


# The wrappers' counters of the one-image-per-CTA forward and backward
# (every instance): on f32 inputs each launch is one vf_kernel_f32 or one
# vfb_rows_f32
CTA_FWD = ("vf_eval", "vf_eval_jasmin", "vf_eval_drop", "vf_eval_jasmin_drop",
           "vf_eval_l2", "vf_eval_jasmin_l2", "vf_eval_stash",
           "vf_eval_jasmin_stash", "vf_euler_chain")
CTA_BWD = ("vf_bwd", "vf_bwd_drop", "vf_bwd_l2", "vf_bwd_resid")


def f32_cta_launches() -> dict:
    """The f32 one-CTA ViTODE kernels' launches so far, by their
    libraries' C counters: {"fwd": ``vf_kernel_f32``'s, "bwd":
    ``vfb_rows_f32``'s}."""
    from odevit_tpu_torch.kernels.vector_field import f32_launches
    from odevit_tpu_torch.kernels.vector_field_bwd import rows_f32_launches
    return {"fwd": f32_launches(), "bwd": rows_f32_launches()}


def rows_bf16_launches() -> int:
    """``vfb_rows_bf16``'s launches so far (its library's C counter)."""
    from odevit_tpu_torch.kernels.vector_field_bwd import rows_bf16_launches
    return rows_bf16_launches()


def f32_cta_since(before: dict) -> dict:
    now = f32_cta_launches()
    return {k: now[k] - before[k] for k in now}


def f32_cta_expected(launches: dict) -> dict:
    """The one-CTA launches among the wrappers' counts ``launches``: what
    the f32 kernels' C counters should show for f32 calls."""
    return {"fwd": sum(launches.get(n, 0) for n in CTA_FWD),
            "bwd": sum(launches.get(n, 0) for n in CTA_BWD)}


class F32Tally:
    """The f32 calls of a kernel-vs-plain phase: the one-CTA launches the
    wrappers counted for them (what the route says) against the f32
    kernels' C counters, summed over the spans between ``start`` and
    ``stop`` (both no-ops for another dtype)."""

    def __init__(self):
        self.route = {"fwd": 0, "bwd": 0}
        self.kernels = {"fwd": 0, "bwd": 0}

    def start(self, dtype):
        import torch
        from odevit_tpu_torch.kernels import launch_counts
        if dtype == torch.float32:
            self._at = (f32_cta_expected(launch_counts), f32_cta_launches())

    def stop(self, dtype):
        import torch
        from odevit_tpu_torch.kernels import launch_counts
        if dtype == torch.float32:
            route, kernels = (f32_cta_expected(launch_counts),
                              f32_cta_launches())
            for k in self.route:
                self.route[k] += route[k] - self._at[0][k]
                self.kernels[k] += kernels[k] - self._at[1][k]

    def check(self, what) -> dict:
        check(self.kernels == self.route,
              f"{what}: the f32 one-CTA kernels launched {self.kernels}, "
              f"the route says {self.route}")
        return {"f32_cta_launches": self.kernels}


def wgrad_since(before: dict) -> dict:
    """The launches of each weight-product kernel since ``before`` (a
    :func:`wgrad_launches`)."""
    now = wgrad_launches()
    return {k: now[k] - before[k] for k in now}


def wgrad_expected(launches: dict) -> int:
    """Launches of the weight-product kernel that the backward launches in
    ``launches`` make: one per backward (each split half is a
    backward of its own; ``vf_bwd_split`` counts the pairs), two per
    Macaron backward (the attention's products, then the shared FFN's
    over both halves)."""
    n = 0
    for name, count in launches.items():
        if name.startswith("vf_bwd") and not name.startswith("vf_bwd_split"):
            n += count
        elif name.startswith("macaron_bwd"):
            n += 2 * count
    return n


def gemm_launches() -> int:
    """``vft_gemm_wgmma``'s launches so far, by the C counters of every
    library that compiles it (``kernels/bf16_gemm.py``)."""
    from odevit_tpu_torch.kernels.bf16_gemm import wgmma_launches
    return wgmma_launches()


# The bf16 products (vft_gemm_wgmma launches) of one launch of each tiled
# wrapper (csrc/vector_field_tiled.cu, vector_field_bwd_split.cu): the
# forward's qkv, h and output products, with dropout at the MLP or
# projection sites the output in two (attn_o, then the masked sum); the
# backward's h1, qkv, h1_bar, cb, a_bar and m_bar, with the stash's
# residuals no h1 or qkv; the split halves' m_bar and qkv, cb, a_bar (the
# stash: no qkv); a tiled Macaron evaluation's six and backward's 25
# launches' eleven are f32 in every cell (0 here). The same past 256
# padded tokens (``_kt``). The cells' dropout rates are all nonzero.
GEMMS_PER_LAUNCH = {
    "vf_eval_tiled": 3, "vf_eval_jasmin_tiled": 3, "vf_eval_attn": 3,
    "vf_eval_euler_tiled": 3, "vf_eval_base_tiled": 3,
    "vf_eval_l2_tiled": 3, "vf_eval_jasmin_l2_tiled": 3,
    "vf_eval_stash_tiled": 3, "vf_eval_jasmin_stash_tiled": 3,
    "vf_eval_tiled_drop": 4, "vf_eval_jasmin_tiled_drop": 4,
    "vf_eval_attn_drop": 4, "vf_eval_masks": 4,
    "vf_bwd_tiled": 6, "vf_bwd_tiled_drop": 6, "vf_bwd_l2_tiled": 6,
    "vf_bwd_resid_tiled": 4,
    "vf_bwd_mlp": 1, "vf_bwd_mlp_drop": 1, "vf_bwd_mlp_resid": 1,
    "vf_bwd_attn": 3, "vf_bwd_attn_drop": 3, "vf_bwd_attn_resid": 2}
GEMMS_PER_LAUNCH.update({k + "_kt": v for k, v in GEMMS_PER_LAUNCH.items()})


def gemm_expected(launches: dict) -> int:
    """The ``vft_gemm_wgmma`` launches that the bf16 wrappers' launches
    ``launches`` make (``GEMMS_PER_LAUNCH``)."""
    return sum(GEMMS_PER_LAUNCH.get(name, 0) * count
               for name, count in launches.items())


def check_gemm_route(what: str, launches: dict, got: int, bf16: bool = True):
    """The route's bf16 products: ``vft_gemm_wgmma`` launched ``got``
    times by its C counter, as ``launches`` say for a bf16 run, not at all
    for an f32 one."""
    want = gemm_expected(launches) if bf16 else 0
    check(got == want, f"{what}: {got} vft_gemm_wgmma launches, want "
          f"{want}")
    return got


def check_train(name, runs, cos, loss_rel, per_step, want, wgrad="bf16",
                rows_bf16=None):
    """The kernel path against the plain path (losses, first gradient),
    its launches per step against ``want``, and the route of its weight
    products: one launch per backward (``wgrad_expected``) of the
    weight-product kernel of ``wgrad`` ("bf16": ``vfb_wgrad_wgmma``,
    "f32": ``vfb_wgrad_tf32``) and none of the other; ``wgrad=None`` (the
    f32 Macaron backwards, on ``mcb_wgrad_f32``): none of either. With
    ``wgrad="f32"`` the f32 one-CTA kernels' C counters (``vf_kernel_f32``,
    ``vfb_rows_f32``) equal the step's one-CTA launches; otherwise 0."""
    import numpy as np
    k, p = runs["kernels"], runs["plain"]
    check(all(np.isfinite(v) for v in k["loss"] + p["loss"]),
          f"{name}: non-finite training loss")
    check(max(loss_rel) <= TOL_TRAIN_LOSS, f"{name} losses: {loss_rel}")
    check(cos >= MIN_GRAD_COSINE, f"{name}: first gradient cosine {cos}")
    want = {**{n: 0 for n in per_step}, **want}
    check(per_step == want, f"{name}: launches per step {per_step}, "
          f"want {want}")
    want_w = {kind: wgrad_expected(k["launches"]) if kind == wgrad else 0
              for kind in ("bf16", "f32")}
    check(k["wgrad_launches"] == want_w, f"{name}: {k['wgrad_launches']} "
          f"weight-product launches, want {want_w}")
    # an f32 ViTODE step launches vf_kernel_f32 / vfb_rows_f32 once per
    # one-CTA forward / backward (the C counters); any other step neither
    # the tiled route's bf16 products: vft_gemm_wgmma by its C counter
    check_gemm_route(name, k["launches"], k["gemm_launches"],
                     wgrad == "bf16")
    want_c = (f32_cta_expected(k["launches"]) if wgrad == "f32"
              else {"fwd": 0, "bwd": 0})
    check(k["f32_cta_launches"] == want_c, f"{name}: the f32 one-CTA "
          f"kernels launched {k['f32_cta_launches']}, want {want_c}")
    # a bf16 step launches vfb_rows_bf16 once per one-CTA backward (its C
    # counter; ``rows_bf16``: the cell's count over its 3 steps), any
    # other step never
    want_r = (sum(k["launches"].get(n, 0) for n in CTA_BWD)
              if wgrad == "bf16" else 0)
    check(k["rows_bf16_launches"] == want_r
          and rows_bf16 in (None, want_r),
          f"{name}: {ROWS_BF16} launched {k['rows_bf16_launches']} times, "
          f"the route says {want_r}, the cell {rows_bf16}")


def phase_train(images_u8, labels):
    """Cell cifar100-vitode-train-b1024-bf16: the deterministic step."""
    runs, profile, cos, loss_rel, per_step = train_runs(images_u8, labels)
    emit("train_profile", **profile)
    emit("train", batch=BATCH, steps=TRAIN_STEPS, solver="rk4-13",
         jasmin_k=JASMIN_K, first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         launches_per_step=per_step, results=runs)
    # the CIFAR shape keeps the one-image-per-CTA kernels: the tiled
    # route's counters stay at 0
    check_train("train", runs, cos, loss_rel, per_step,
                {"vf_eval": 36, "vf_eval_jasmin": 12, "vf_bwd": 48},
                rows_bf16=ROWS_BF16_CIFAR)
    return runs["kernels"]["launches"], runs


# The f32 ViTODE training cells: the recipes train in f32 (the JAX CLI's
# default dtype; no recipe under configs/ sets inputs.dtype)
F32_TRAIN_CELL = "cifar100-vitode-train-b1024-f32"
F32_DISTILL_CELL = "tsref-distill-b64-f32"


def phase_train_f32(images_u8, labels):
    """Cell cifar100-vitode-train-b1024-f32: phase_train's deterministic
    step (rk4-13, JaSMin k=10, AdamW, B=1024, dropout 0) with an f32
    model and f32 preprocess, through the kernels and the plain path."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.models.vit_ode import ViTODE
    runs, profile, cos, loss_rel, per_step = train_runs(
        images_u8, labels, pre=make_preprocess(dtype=torch.float32),
        model_fn=lambda rates: ViTODE(
            **SHAPE, num_eval_steps=13, solver="rk4", dtype=torch.float32,
            device="cuda", seed=0))
    k, p = runs["kernels"], runs["plain"]
    emit("train_f32_profile", **profile)
    emit("train_f32", cell=F32_TRAIN_CELL, batch=BATCH, steps=TRAIN_STEPS,
         solver="rk4-13", jasmin_k=JASMIN_K, dtype="float32",
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         device_ms=profile["device_ms"], busy_share=profile["busy_share"],
         first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         launches_per_step=per_step, results=runs)
    check_train("train_f32", runs, cos, loss_rel, per_step,
                {"vf_eval": 36, "vf_eval_jasmin": 12, "vf_bwd": 48},
                wgrad="f32")
    # the profiled step ran the f32 one-CTA kernels (and, by
    # profile_step, none of the CUDA-core instances they replaced)
    ran = " ".join(t["kernel"] for t in profile["top"])
    check("vf_kernel_f32" in ran and "vfb_rows_f32" in ran,
          f"train_f32's profile lacks the f32 one-CTA kernels: {ran}")
    return runs


def f32_bound(flops: float, t_mem: float):
    """(bound_ms, bound_by) of an f32 kernel: split TF32's floor (three
    TF32 passes of its products over the TF32 peak) against its bytes'
    time ``t_mem``."""
    t_ops = tf32_floor_ms(flops)
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_train_f32_kernel_timing(images_u8):
    """The f32 one-CTA kernels alone at the f32 cell's state (B=1024, f32:
    the embedded batch, the first state of the JaSMin window) against
    their plain versions: ``vf_kernel_f32`` in the base (stage-advance)
    and Euler modes, JaSMin (k=10) and the dropout instance at 0.1, and
    the backward (``vfb_rows_f32`` and the weight products and reduce
    beside it, ``parts`` by profiler) with and without the JaSMin
    cotangent. Each: ms a launch, split TF32's floor (``tf32_floor_ms``)
    and the TF32-pass rate, the plain version's ms, registers and spills
    from ``-Xptxas -v``; the tiled route's f32 forward and backward at the
    same state as a yardstick (the port's other route for the same
    function). The C counters hold every launch against the route."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.tiled import tiled_backward, tiled_forward
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import (_split_bars,
                                                           vf_bwd,
                                                           weight_splits)
    from odevit_tpu_torch.models.vit_ode import ViTODE
    before = dict(launch_counts)
    tally = F32Tally()
    tally.start(torch.float32)
    model = ViTODE(**SHAPE, num_eval_steps=13, solver="rk4",
                   dtype=torch.float32, device="cuda", seed=0)
    b, d, dh, heads = BATCH, 192, 768, 3
    with torch.no_grad():
        tokens = model.patch_embed(make_preprocess(
            dtype=torch.float32)(images_u8))
        n_real = tokens.shape[1]
        n_pad = pad_tokens(n_real)
        x = torch.nn.functional.pad(
            tokens, (0, 0, 0, n_pad - n_real)).contiguous()
        check(x.dtype == torch.float32, f"f32 state is {x.dtype}")
        w = model.vf.kernel_weights(torch.float32)
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        g = torch.Generator(device="cuda").manual_seed(31)
        gx = torch.randn(x.shape, generator=g, device="cuda") * 1e-3
        gx[:, n_real:] = 0
        base = x + 1e-2 * torch.randn(x.shape, generator=g, device="cuda")
        dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
        _, st, idx = vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw)
        gj = torch.randn(st.shape, generator=g, device="cuda") * 1e-3
        gj[..., n_real:] = 0
        fwd_flops = b * (n_real * (8 * d * d + 4 * d * dh)
                         + 4 * n_real * n_real * d)
        bwd_flops = b * (n_real * (10 * d * dh + 22 * d * d)
                         + 12 * n_real * n_real * d)
        # vfb_rows_f32's own products: the backward's less the weight
        # products, which vfb_wgrad_tf32 takes over all padded rows
        rows_flops = bwd_flops - b * n_pad * (8 * d * d + 4 * d * dh)
        wbytes = (4 * d * d + 2 * d * dh) * 4
        cut = lambda t: t[:, :n_real]
        fwd_cases = {
            "base": (lambda plain=False: vf_eval(
                x, w, mode="base", dt=1.0 / 12, base=base, plain=plain, **kw),
                3),
            "euler": (lambda plain=False: vf_eval(
                x, w, mode="euler", dt=1.0 / 12, plain=plain, **kw), 2),
            "jasmin": (lambda plain=False: vf_eval_jasmin(
                x, w, jas_k=JASMIN_K, plain=plain, **kw)[0], 2),
            "dropout_0.1": (lambda plain=False: vf_eval(
                x, w, plain=plain, **kw, **dkw), 2)}
        out = {}
        res = kernel_resources("vector_field", ["vf_kernel_f32"])
        for name, (fn, states) in fwd_cases.items():
            got, want = fn(), fn(plain=True)
            torch.cuda.synchronize()
            err = rel_err(cut(got), cut(want))
            check(err <= TOL_F32, f"f32 {name} at B={b}: {err}")
            ms = cuda_ms(fn, iters=10)
            t_mem = (states * b * n_pad * d * 4 + wbytes) / PEAK_BYTES_PER_S \
                * 1e3
            out[name] = {
                "max_abs_err": (cut(got) - cut(want)).abs().max().item(),
                "rel_err": err, "ms": ms,
                "plain_ms": cuda_ms(lambda: fn(plain=True), iters=2),
                "tf32_floor_ms": tf32_floor_ms(fwd_flops),
                "tf32_pass_tflops": 3 * fwd_flops / ms / 1e9,
                **dict(zip(("bound_ms", "bound_by"),
                           f32_bound(fwd_flops, t_mem)))}
        out["forward_resources"] = res
        for name, extra in (("bwd", {}),
                            ("bwd_jas", dict(g_jas=gj, jas_idx=idx))):
            got = vf_bwd(x, w, gx, **kw, **extra)
            want = vf_bwd(x, w, gx, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            errs = [rel_err(cut(got[0]), cut(want[0]))] + [
                rel_err(a, c) for a, c in zip(got[1:], want[1:])]
            check(max(errs) <= TOL_F32, f"f32 {name} at B={b}: {errs}")
            fn = lambda: vf_bwd(x, w, gx, **kw, **extra)
            ms = cuda_ms(fn, iters=5)
            parts = kernel_parts(fn)
            rows = [v for k, v in parts.items() if "vfb_rows_f32" in k]
            check(len(rows) == 1, f"{name}: parts {list(parts)}")
            rows_ms = rows[0]["ms_per_launch"]
            t_mem = ((3 * b * n_pad * d + 4 * d * d + 2 * d * dh) * 4
                     + wbytes) / PEAK_BYTES_PER_S * 1e3
            out[name] = {
                "max_abs_err": max((a - c).abs().max().item()
                                   for a, c in zip(got[1:], want[1:])),
                "max_abs_err_x": (cut(got[0]) - cut(want[0])).abs().max()
                .item(), "rel_errs": errs, "ms": ms,
                "plain_ms": cuda_ms(lambda: vf_bwd(
                    x, w, gx, plain=True, **kw, **extra), iters=2),
                "tf32_floor_ms": tf32_floor_ms(bwd_flops),
                **dict(zip(("bound_ms", "bound_by"),
                           f32_bound(bwd_flops, t_mem))),
                "vfb_rows_f32_ms": rows_ms,
                "vfb_rows_f32_tf32_floor_ms": tf32_floor_ms(rows_flops),
                "vfb_rows_f32_tf32_pass_tflops": 3 * rows_flops / rows_ms
                / 1e9, "parts": parts}
        out["backward_resources"] = kernel_resources("vector_field_bwd",
                                                     ["vfb_rows_f32"])
        spills = [r for part in ("forward_resources", "backward_resources")
                  for r in out[part].values()
                  if r["spill_stores"] or r["spill_loads"]]
        check(not spills, f"the f32 one-CTA kernels spill: {spills}")
        # the tiled route at the same state: the port's other route for
        # the same function, as a yardstick
        splits = weight_splits(b * n_pad, d, dh, dtype=torch.float32)
        tf = lambda: tiled_forward(x, w, mode="base", dt=1.0 / 12,
                                   base=base, **kw)[0]
        tb = lambda: tiled_backward(x, w, gx, splits=splits, g_jas=gj,
                                    jas_idx=idx, **kw)
        terr = rel_err(cut(tf()), cut(fwd_cases["base"][0](plain=True)))
        tbars = _split_bars(*tb(), d, dh)
        pbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, plain=True, **kw)
        torch.cuda.synchronize()
        tberr = max([rel_err(cut(tbars[0]), cut(pbars[0]))]
                    + [rel_err(a, c) for a, c in zip(tbars[1:], pbars[1:])])
        check(max(terr, tberr) <= TOL_F32, f"tiled f32 yardstick: "
              f"{terr}, {tberr}")
        out["tiled_yardstick"] = {
            "forward_base_ms": cuda_ms(tf, iters=5),
            "backward_jas_ms": cuda_ms(tb, iters=5),
            "rel_err_fwd": terr, "rel_err_bwd": tberr}
    tally.stop(torch.float32)
    out.update(tally.check("train_f32_kernel_timing"))
    launch_counts.update(before)           # comparisons do not count
    emit("train_f32_kernel_timing", cell=F32_TRAIN_CELL,
         shape=f"B={b} n={n_real}/{n_pad} D={d} H={heads} dh={dh} f32",
         results=out)
    del model
    return out


def phase_distill_f32(teacher, images_u8, labels):
    """Cell tsref-distill-b64-f32: phase_distill's step (Euler-36, JaSMin
    k=2, L1 maps, B=64, 32 px resized on the card, the random ViT-B/16
    teacher) with an f32 student and f32 preprocess, through the kernels
    and the plain path."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    runs, profile, cos, loss_rel, per_step = distill_runs(
        teacher, images_u8, labels, dtype=torch.float32,
        student_fn=lambda drops: ViTODE.base_224(
            num_classes=100, dtype=torch.float32, device="cuda", seed=0))
    k, p = runs["kernels"], runs["plain"]
    emit("distill_f32_profile", **profile)
    emit("distill_f32", cell=F32_DISTILL_CELL, batch=DISTILL_BATCH,
         input="uint8 32x32 resized to 224", steps=TRAIN_STEPS,
         solver="euler-36", jasmin_k=DISTILL_K, dtype="float32",
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s"], plain_img_per_s=p["img_per_s"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         device_ms=profile["device_ms"], busy_share=profile["busy_share"],
         first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         launches_per_step=per_step, results=runs)
    check_train("distill_f32", runs, cos, loss_rel, per_step,
                DISTILL_LAUNCHES, wgrad="f32")
    return runs


ROWS_BF16 = "vfb_rows_bf16"
# its launches in 3 training steps: the CIFAR bf16 cells (48 one-CTA
# backwards a step, ± dropout, L2, the stash arm) and the map route (36)
ROWS_BF16_CIFAR = 144
ROWS_BF16_MAP = 108


def rows_bf16_bound(b: int, n_pad: int, d: int, dh: int, resid=False,
                    drop=False):
    """(bound_ms, bound_by, flops) of the bf16 one-CTA backward's rows
    kernel alone (``vfb_rows_bf16``) on ``b`` images of ``n_pad`` rows:
    its products, the backward's less the weight products (recomputed qkv
    and h1 unless ``resid``; the two head products; h_bar, m_bar, cb,
    v_bar, p_bar, q_bar, k_bar, a_bar) over the bf16 peak, against x and
    g read and the scratch operands (cn_m, cn_a, gd (, gd2), ctx, h,
    h1_bar, [q_bar k_bar v_bar]) and x_bar written in bf16, the weights
    read once (with ``resid`` also rqkv and rh1 read)."""
    flops = b * (n_pad * (14 * d * d + 6 * d * dh) + 12 * n_pad * n_pad * d)
    if resid:
        flops -= b * n_pad * (6 * d * d + 2 * d * dh)
    rows = b * n_pad * ((11 if drop else 10) * d + 2 * dh
                        + (3 * d + dh if resid else 0))
    nbytes = 2 * (rows + 4 * d * d + 2 * d * dh)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")) \
        + (flops,)


def rows_bf16_report(x, w, gx, kw, extra, resid=False, drop=False):
    """The bf16 one-CTA backward's rows kernel alone on one state: its
    device time a launch under the profiler (the part of ``vf_bwd`` whose
    name holds ``vfb_rows``: ``vfb_rows_bf16``, or the old ``vfb_rows<``
    on a tree that still has it), its bound and rate, and the tiled
    route's backward on the same inputs as the yardstick: its time by CUDA
    events, and less its weight products and reduce (their device time a
    launch, each once a call)."""
    import torch
    from odevit_tpu_torch.kernels.dropout import drop_spec
    from odevit_tpu_torch.kernels.tiled import tiled_backward
    from odevit_tpu_torch.kernels.vector_field_bwd import (vf_bwd,
                                                           weight_splits)
    b, n_pad, d = x.shape
    dh = w.w1.shape[1]
    fn = lambda: vf_bwd(x, w, gx, **kw, **extra)
    # the profiler records no device event now and then (PERF.md §7): a
    # few tries, else the kernel's time is not measured in this run
    for _ in range(3):
        parts = kernel_parts(fn)
        rows = {k: v for k, v in parts.items() if "vfb_rows" in k}
        if parts:
            break
    check(len(rows) == 1 or not parts,
          f"vf_bwd's rows kernel among {list(parts)}")
    name, part = next(iter(rows.items())) if rows else (None, None)
    ms = part["ms_per_launch"] if part else None
    bound_ms, bound_by, flops = rows_bf16_bound(b, n_pad, d, dh, resid, drop)
    tkw = dict(num_heads=kw["num_heads"], scaler=kw["scaler"],
               n_real=kw["n_real"],
               splits=weight_splits(b * n_pad, d, dh, dtype=x.dtype),
               g_jas=extra.get("g_jas"), jas_idx=extra.get("jas_idx"),
               drop=drop_spec(extra.get("seed"), extra.get("drops",
                                                           (0.0,) * 3)),
               rqkv=extra.get("resid_qkv"), rh1=extra.get("resid_h1"))
    tb = lambda: tiled_backward(x, w, gx, **tkw)
    tiled_ms = cuda_ms(tb, iters=5)
    tparts = kernel_parts(tb)
    wr = (sum(v["ms_per_launch"] for k, v in tparts.items()
              if "vfb_wgrad" in k or "vfb_reduce" in k) if tparts else None)
    return {"kernel": name, "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / ms / 1e9 if ms else None,
            "vf_bwd_ms": cuda_ms(fn, iters=5),
            "tiled_yardstick": {
                "backward_ms": tiled_ms,
                "less_weight_products_ms": (tiled_ms - wr if wr is not None
                                            else None),
                "weight_products_ms": wr}}


def rows_bf16_cases(images_u8) -> dict:
    """The bf16 one-CTA backward's instances on the CIFAR training state
    (B=1024: the first state of one batch, its cotangent N(0, 1e-3), the
    JaSMin cotangent and columns of the forward at that state): name ->
    (x, w, gx, keywords, the instance's keywords, resid, drop). The
    deterministic instance ± the JaSMin cotangent, dropout at the
    recipe's rates, L2 (the L2 model's weights and state), resid (the
    stash forward's residuals)."""
    import torch
    from odevit_tpu_torch.kernels.vector_field import vf_eval_jasmin
    from odevit_tpu_torch.models.vit_ode import ViTODE
    out = {}
    for fam, model in (("softmax", ViTODE(
            **SHAPE, num_eval_steps=13, solver="rk4", dtype=torch.bfloat16,
            device="cuda", seed=0)), ("l2", l2_model())):
        with torch.no_grad():
            x, w, kw = first_state(model, images_u8)
            g = torch.Generator(device="cuda").manual_seed(3)
            gx = (torch.randn(x.shape, generator=g, device="cuda")
                  * 1e-3).to(torch.bfloat16)
            _, st, idx, (rq, rh) = (
                vf_eval_jasmin(x, w, jas_k=JASMIN_K, stash=True, **kw)
                if fam == "softmax" else
                (*vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw), (None, None)))
            gj = torch.randn(st.shape, generator=g, device="cuda") * 1e-3
            gj[..., kw["n_real"]:] = 0
            jas = dict(g_jas=gj, jas_idx=idx)
            if fam == "l2":
                out["l2"] = (x, w, gx, kw, jas, False, False)
                continue
            out["det"] = (x, w, gx, kw, {}, False, False)
            out["jas"] = (x, w, gx, kw, jas, False, False)
            out["drop"] = (x, w, gx, kw, dict(
                seed=DROP_SEEDS[2], drops=DROP_RATES, **jas), False, True)
            out["resid"] = (x, w, gx, kw, dict(
                resid_qkv=rq, resid_h1=rh, **jas), True, False)
        del model
    return out


def recompute_matches_stash(x, w, gx, kw, extra, rq, rh) -> bool:
    """Whether the one-CTA backward's recomputed q, k and v are bit for bit
    the forward's (its stash, ``rq``): then every attention-side cotangent
    (the attention norm's two, Wqkv's, Wout's) of the recompute instance
    equals the resid instance's; the MLP side differs by design (the
    resid instance reads h1 rounded)."""
    import torch
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    a = vf_bwd(x, w, gx, **kw, **extra)
    b = vf_bwd(x, w, gx, resid_qkv=rq, resid_h1=rh, **kw, **extra)
    torch.cuda.synchronize()
    return all(torch.equal(a[i], b[i]) for i in (1, 2, 5, 6))


def phase_rows_bf16_only(images_u8):
    """``python3 chip_smoke.py --rows``: the bf16 one-CTA backward's rows
    kernel alone at the CIFAR training state in every instance, beside the
    tiled route's backward (``rows_bf16_report``); on this tree or, copied
    into it, on an older one whose kernel is ``vfb_rows<``."""
    cases = rows_bf16_cases(images_u8)
    out = {name: rows_bf16_report(x, w, gx, kw, extra, resid, drop)
           for name, (x, w, gx, kw, extra, resid, drop) in cases.items()}
    x, w, gx, kw, extra = cases["resid"][:5]
    jas = {k: extra[k] for k in ("g_jas", "jas_idx")}
    out["recomputed_qkv_bit_identical"] = recompute_matches_stash(
        x, w, gx, kw, jas, extra["resid_qkv"], extra["resid_h1"])
    emit("rows_bf16_only", shape=f"B={BATCH} n=69/80 D=192 H=3 dh=768 "
         f"bf16", results=out)
    return out


# vfb_rows_bf16's plans that the CIFAR shape (cn and gd resident, chunks
# of 64, blocks of 192, four slots) does not take: (n_real, n_pad, D,
# heads, dh) -> the deterministic instance's (cn_smem, chunk, block, slots)
BF16_BWD_PLANS = (
    ((29, 32, 64, 2, 64), (1, 64, 192, 4)),         # D=64, dh=64, 32 rows
    ((125, 128, 64, 2, 64), (0, 64, 192, 4)),       # 128 rows: cn staged
    ((69, 80, 32, 2, 32), (1, 32, 192, 4)),         # chunks of 32
    ((29, 32, 48, 3, 48), (1, 16, 192, 4)),         # chunks of 16, hd 16
    ((9, 16, 256, 4, 256), (1, 64, 192, 4)),        # blocks of 192 and 64
    ((61, 64, 384, 6, 384), (1, 64, 32, 4)),        # blocks of 32
    ((109, 112, 320, 5, 320), (0, 64, 32, 3)),      # three slots
    ((110, 112, 384, 6, 384), (0, 32, 128, 2)))     # two slots
BF16_BWD_INSTANCES = ("det", "jas", "drop", "l2", "resid")
BF16_CHECK_DROPS = (0.2, 0.1, 0.3)


def bf16_bwd_plans_vs_plain():
    """``vfb_rows_bf16`` at B=4 on each plan of ``BF16_BWD_PLANS``, in
    every instance (deterministic ± the JaSMin cotangent, dropout at mixed
    rates, L2 with nonzero biases, resid with random residuals) against
    ``vf_bwd_plain``: every cotangent within ``TOL_BF16`` of max|plain|,
    finite, repeats bit-identical, NaN and garbage in the padded rows of
    x, g and the residuals inert, one launch of the C counter a call; with
    dropout the zeros of the h, gd and gd2 operands (``scratch``) exactly
    those of the generator's mask_h, mask_mo and mask_ao on the real
    rows."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import masks_plain
    from odevit_tpu_torch.kernels.vector_field_bwd import (bf16_bwd_plan,
                                                           vf_bwd)
    before = dict(launch_counts)
    g = torch.Generator(device="cuda").manual_seed(29)
    r = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    results = []
    for (n_real, n_pad, d, heads, dh), want_plan in BF16_BWD_PLANS:
        b = 4
        plan = bf16_bwd_plan(n_pad, n_real, d, heads, dh)
        check(plan is not None and plan[:4] == want_plan,
              f"bf16 backward plan at {n_pad} {d} {heads} {dh}: {plan}")
        w = stash_weights(torch.bfloat16, d, heads, dh, g)
        x = r(b, n_pad, d)
        x[:, n_real:] = 0
        gx = r(b, n_pad, d) * 1e-2
        gx[:, n_real:] = 0
        x, gx = x.to(torch.bfloat16), gx.to(torch.bfloat16)
        dirty, gdirty = x.clone(), gx.clone()
        dirty[:, n_real::2] = float("nan")
        dirty[:, n_real + 1::2] = 1e30
        gdirty[:, n_real:] = 7.0
        gj = r(b, heads, 5, n_pad) * 1e-2
        gj[..., n_real:] = 0
        idx = torch.randint(0, n_real, (b, heads, 4, n_pad), generator=g,
                            device="cuda", dtype=torch.int32)
        rq = r(b * n_pad, 3 * d).to(torch.bfloat16)
        rh = r(b * n_pad, dh).to(torch.bfloat16)
        rq.view(b, n_pad, -1)[:, n_real:] = 0
        rh.view(b, n_pad, -1)[:, n_real:] = 0
        rqd, rhd = rq.clone(), rh.clone()
        rqd.view(b, n_pad, -1)[:, n_real:] = float("nan")
        rhd.view(b, n_pad, -1)[:, n_real:] = float("nan")
        res = {"shape": f"B={b} n={n_real}/{n_pad} D={d} H={heads} dh={dh}",
               "plan": plan}
        kw = dict(num_heads=heads, scaler=0.7, n_real=n_real)
        for inst in BF16_BWD_INSTANCES:
            wi, extra, dextra = w, {}, {}
            if inst == "jas":
                extra = dict(g_jas=gj, jas_idx=idx)
            elif inst == "drop":
                extra = dict(seed=DROP_SEEDS[1], drops=BF16_CHECK_DROPS,
                             g_jas=gj, jas_idx=idx)
            elif inst == "l2":
                wi = w._replace(qkv_bias=L2_BIAS_SCALE * r(3 * d),
                                out_bias=L2_BIAS_SCALE * r(d))
                extra = dict(g_jas=gj, jas_idx=idx)
            elif inst == "resid":
                extra = dict(resid_qkv=rq, resid_h1=rh)
                dextra = dict(resid_qkv=rqd, resid_h1=rhd)
            at = rows_bf16_launches()
            scratch = {}
            got = vf_bwd(x, wi, gx, scratch=scratch, **kw, **extra)
            again = vf_bwd(x, wi, gx, **kw, **extra)
            padded = vf_bwd(dirty, wi, gdirty, **kw, **{**extra, **dextra})
            want = vf_bwd(x, wi, gx, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            errs = [rel_err(a[:, :n_real] if i == 0 else a,
                            c[:, :n_real] if i == 0 else c)
                    for i, (a, c) in enumerate(zip(got, want))]
            ri = {"max_rel_err": max(errs),
                  "launches": rows_bf16_launches() - at}
            what = f"bf16 backward {res['shape']} {inst}"
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  f"{what}: non-finite cotangent")
            check(ri["max_rel_err"] <= TOL_BF16, f"{what}: {errs}")
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"{what} not repeatable")
            check(all(torch.equal(a, c) for a, c in zip(got, padded)),
                  f"{what}: padded rows reached a cotangent")
            check(ri["launches"] == 3, f"{what}: {ROWS_BF16} launched "
                  f"{ri['launches']} times for 3 calls")
            if inst == "drop":
                mh, mmo, mao, _ = masks_plain(
                    b, n_real, d, dh, heads, DROP_SEEDS[1], BF16_CHECK_DROPS,
                    device="cuda", n_pad=n_pad)
                ri["mask_zeros_differ"] = {
                    name: int(((scratch[name].view(b, n_pad, -1)[:, :n_real]
                                != 0) != (m[:, :n_real] != 0)).sum())
                    for name, m in (("h", mh), ("gd", mmo), ("gd2", mao))}
                check(not any(ri["mask_zeros_differ"].values()),
                      f"{what}: masks {ri['mask_zeros_differ']}")
            res[inst] = ri
        results.append(res)
    launch_counts.update(before)           # comparisons do not count
    emit("bf16_bwd_plans_vs_plain", tol=TOL_BF16, drops=BF16_CHECK_DROPS,
         results=results)
    return results


def rows_bf16_resources() -> dict:
    """Registers and spills of each ``vfb_rows_bf16`` instance (none may
    spill)."""
    res = kernel_resources("vector_field_bwd", [ROWS_BF16])
    spills = [k for k, r in res.items()
              if r["spill_stores"] or r["spill_loads"]]
    check(not spills, f"{ROWS_BF16} spills: {spills}")
    return res


def phase_train_kernel_timing(model, images_u8):
    """Each training kernel alone on the main path's inputs (the first
    JaSMin-window state of one image batch) against its plain version."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import pad_tokens, vf_eval_jasmin
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    from odevit_tpu_torch.data.pipeline import make_preprocess
    before = dict(launch_counts)
    with torch.no_grad():
        tokens = model.patch_embed(make_preprocess(
            dtype=torch.bfloat16)(images_u8))
        n_real = tokens.shape[1]
        x = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        w = model.vf.kernel_weights(torch.bfloat16)
        kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real)
        g = torch.Generator(device="cuda").manual_seed(3)
        gx = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        dx, st, idx = vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw)
        pdx, pst, _ = vf_eval_jasmin(x, w, jas_k=JASMIN_K, plain=True, **kw)
        gj = torch.randn(st.shape, generator=g, device="cuda") * 1e-3
        gj[..., n_real:] = 0
        bars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, **kw)
        pbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, plain=True, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(a[:, :n_real], b[:, :n_real])
                for a, b in zip((dx, st), (pdx, pst))]
        berrs = [rel_err(a[:, :n_real] if i == 0 else a,
                         b[:, :n_real] if i == 0 else b)
                 for i, (a, b) in enumerate(zip(bars, pbars))]
        check(max(errs) <= TOL_BF16, f"B=1024 jasmin fwd: {errs}")
        check(max(berrs) <= TOL_BF16, f"B=1024 bwd: {berrs}")
        out = {
            "vf_eval_jasmin": {
                "max_abs_err": (dx[:, :n_real].float()
                                - pdx[:, :n_real].float()).abs().max().item(),
                "ms": cuda_ms(lambda: vf_eval_jasmin(
                    x, w, jas_k=JASMIN_K, **kw), iters=10),
                "plain_ms": cuda_ms(lambda: vf_eval_jasmin(
                    x, w, jas_k=JASMIN_K, plain=True, **kw), iters=2),
                **dict(zip(("bound_ms", "bound_by"), jasmin_bound(
                    BATCH, n_real, 192, 768, 3, 2, JASMIN_K + 1)))},
            "vf_bwd": {
                "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(bars[1:], pbars[1:])),
                "max_abs_err_x": (bars[0][:, :n_real].float()
                                  - pbars[0][:, :n_real].float()
                                  ).abs().max().item(),
                "rel_errs": berrs,
                "ms": cuda_ms(lambda: vf_bwd(
                    x, w, gx, g_jas=gj, jas_idx=idx, **kw), iters=10),
                "plain_ms": cuda_ms(lambda: vf_bwd(
                    x, w, gx, g_jas=gj, jas_idx=idx, plain=True, **kw),
                    iters=2),
                **dict(zip(("bound_ms", "bound_by"), bwd_bound(
                    BATCH, n_real, 192, 768, 3, 2)))}}
        # the rows kernel alone, ± the JaSMin cotangent, beside the tiled
        # route's backward
        out["vf_bwd"][ROWS_BF16] = rows_bf16_report(
            x, w, gx, kw, dict(g_jas=gj, jas_idx=idx))
        out["vf_bwd"][ROWS_BF16 + "_no_jas"] = rows_bf16_report(
            x, w, gx, kw, {})
        out["vf_bwd"][ROWS_BF16]["resources"] = rows_bf16_resources()
    launch_counts.update(before)           # comparisons do not count
    emit("train_kernel_timing", shape=f"B={BATCH} n={n_real}/80 D=192 H=3 "
         f"dh=768 bf16", results=out)
    return out

# --- dropout slice: the fused free step at the recipe's drop 0.1 --------

def dropout_calls(b: int, n_real: int, d: int, dh: int, heads: int) -> int:
    """Philox calls that one evaluation's masks need (real rows and keys,
    4 columns per call): gelu(h), mlp_o, attn_o and the maps. The backward
    draws the same masks once more."""
    c4 = lambda w: -(-w // 4)
    return b * n_real * (c4(dh) + 2 * c4(d) + heads * c4(n_real))


def with_masks(bound, calls: int):
    """(bound_ms, bound_by, bound_unit) of a kernel that also draws
    ``calls`` Philox calls: the masks' busiest pipe runs beside the tensor
    cores and the memory, so the bound is the larger of its time and the
    kernel's own bound."""
    t_int = calls * PHILOX_FMA_PIPE_OPS / PEAK_INT32_PIPE_OPS * 1e3
    bound_ms, bound_by = bound
    if t_int > bound_ms:
        return t_int, "operations", "integer"
    return bound_ms, bound_by, "tensor" if bound_by == "operations" \
        else "bytes"


def phase_dropout_masks(model):
    """The generator kernel at the CIFAR shape, B=1024, against the plain
    generator, bit for bit, for three seeds (int32 min and -1 among them);
    values, keep rates, and masks that change with seed, site, head and
    image but not with the launch."""
    import numpy as np
    import torch
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
    n = model.patch_embed.seq_len
    rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), DROP_RATES))

    def gen(seed, b=BATCH, img0=0, plain=False):
        return generate_dropout_masks(b, n, 192, 768, 3, seed, img0=img0,
                                      device="cuda", plain=plain, **rates)

    names = ("mask_h", "mask_mo", "mask_ao", "mask_p")
    scale = float(np.float32(1.0 / (1.0 - DROP_RATES[0])))
    reset_launch_counts()
    got = {seed: gen(seed) for seed in DROP_SEEDS}
    torch.cuda.synchronize()
    launches = launch_counts["dropout_masks"]
    check(launches == len(DROP_SEEDS)
          and sum(launch_counts.values()) == launches,
          f"generator launches {dict(launch_counts)}")
    results = {}
    for seed, masks in got.items():
        r = {}
        for name, a, b in zip(names, masks, gen(seed, plain=True)):
            values = torch.unique(a).tolist()
            keep = (a > 0).float().mean().item()
            r[name] = {"bit_identical": torch.equal(a, b),
                       "values": values, "keep_rate": keep}
            check(r[name]["bit_identical"],
                  f"seed {seed} {name}: the kernel's mask differs")
            check(values == [0.0, scale], f"seed {seed} {name}: {values}")
            check(MIN_KEEP <= keep <= MAX_KEEP,
                  f"seed {seed} {name}: keep rate {keep}")
        results[str(seed)] = r
    a, b = got[DROP_SEEDS[0]], got[DROP_SEEDS[1]]
    part = gen(DROP_SEEDS[2], b=200, img0=100)
    checks = {
        "seed_changes_mask": all(not torch.equal(x, y) for x, y in zip(a, b)),
        "site_changes_mask": not torch.equal(a[1], a[2]),
        "head_changes_mask": not torch.equal(a[3][:, 0], a[3][:, 1])
        and not torch.equal(a[3][:, 1], a[3][:, 2]),
        "image_changes_mask": all(not torch.equal(m[0], m[1]) for m in a),
        "same_seed_same_mask": all(torch.equal(x, y)
                                   for x, y in zip(a, gen(DROP_SEEDS[0]))),
        "images_100_300_alone_equal_the_slice": all(
            torch.equal(x, y[100:300])
            for x, y in zip(part, got[DROP_SEEDS[2]]))}
    emit("dropout_masks", shape=f"B={BATCH} n={n} D=192 dh=768 H=3",
         rates=DROP_RATES, seeds=DROP_SEEDS, launches=launches,
         results=results, checks=checks)
    check(all(checks.values()), f"dropout masks: {checks}")
    return launches


def phase_dropout_kernels_vs_plain(model):
    """The dropout instances at B=64 against their plain versions, in bf16
    and f32 (where a mask bit that differs would show far above the
    tolerance)."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import vf_eval, vf_eval_jasmin
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    names = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
             "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
    b, n_real = 64, model.patch_embed.seq_len
    kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real)
    dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
    g = torch.Generator(device="cuda").manual_seed(6)
    before = dict(launch_counts)
    results = []
    tally = F32Tally()
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        tally.start(dtype)
        w, x, gx, gj = train_case(model, b, dtype, "random", g)
        r = {"dtype": str(dtype), "tol": tol, "drops": DROP_RATES,
             "shape": f"B={b} n={n_real}/80 D=192 H=3 dh=768"}
        counts = dict(launch_counts)
        dx = vf_eval(x, w, **kw, **dkw)
        pdx = vf_eval(x, w, plain=True, **kw, **dkw)
        jdx, st, idx = vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw, **dkw)
        pjdx, pst, _ = vf_eval_jasmin(x, w, jas_k=JASMIN_K, plain=True, **kw,
                                      **dkw)
        torch.cuda.synchronize()
        routed = {k: launch_counts[k] - counts[k] for k in counts}
        check(routed == {**{k: 0 for k in routed}, "vf_eval_drop": 1,
                         "vf_eval_jasmin_drop": 1},
              f"the dropout forward did not take its instance: {routed}")
        det = vf_eval(x, w, **kw)
        r["fwd"] = {"dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                    "jasmin_dx": rel_err(jdx[:, :n_real], pjdx[:, :n_real]),
                    "stats": rel_err(st[..., :n_real], pst[..., :n_real])}
        r["vs_deterministic"] = rel_err(dx[:, :n_real], det[:, :n_real])
        check(max(r["fwd"].values()) <= tol,
              f"dropout fwd {dtype}: {r['fwd']}")
        check(r["vs_deterministic"] > 10 * tol,
              f"dropout fwd {dtype} equals the deterministic one")
        cols = idx[..., :n_real].long()
        real = (cols >= 0) & (cols < n_real)
        distinct = torch.stack([
            torch.stack([cols[:, :, i] != cols[:, :, j]
                         for j in range(4) if j != i]).all(0)
            for i in range(4)], dim=2)
        r["scatter"] = {"entries": cols.numel(),
                        "hit_once": int((real & distinct).sum())}
        check(r["scatter"]["hit_once"] == r["scatter"]["entries"],
              f"dropout jasmin columns {dtype}: {r['scatter']}")
        for jas in (False, True):
            extra = dict(g_jas=gj, jas_idx=idx) if jas else {}
            counts = dict(launch_counts)
            got = vf_bwd(x, w, gx, **kw, **dkw, **extra)
            again = vf_bwd(x, w, gx, **kw, **dkw, **extra)
            want = vf_bwd(x, w, gx, plain=True, **kw, **dkw, **extra)
            torch.cuda.synchronize()
            check(launch_counts["vf_bwd_drop"] - counts["vf_bwd_drop"] == 2
                  and launch_counts["vf_bwd"] == counts["vf_bwd"],
                  "the dropout backward did not take its instance")
            errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                b_[:, :n_real] if nm == "x" else b_)
                    for nm, a, b_ in zip(names, got, want)}
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            r["bwd_jas" if jas else "bwd"] = errs
            r["repeat_bit_identical" + ("_jas" if jas else "")] = same
            check(max(errs.values()) <= tol,
                  f"dropout bwd {dtype} jas={jas}: {errs}")
            check(same, f"dropout bwd {dtype} jas={jas} not repeatable")
        # garbage and NaN in the padded rows change no real row
        dirty = x.clone()
        dirty[:, n_real:n_real + 5] = float("nan")
        dirty[:, n_real + 5:] = 1e30
        gdirty = gx.clone()
        gdirty[:, n_real:] = 7.0
        ddx = vf_eval(dirty, w, **kw, **dkw)
        djdx, dst, didx = vf_eval_jasmin(dirty, w, jas_k=JASMIN_K, **kw,
                                         **dkw)
        dbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx, **kw, **dkw)
        cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, **kw, **dkw)
        torch.cuda.synchronize()
        same = (torch.equal(ddx[:, :n_real], dx[:, :n_real])
                and torch.equal(djdx[:, :n_real], jdx[:, :n_real])
                and torch.equal(dst, st) and torch.equal(didx, idx)
                and all(torch.equal(a, c) for a, c in zip(dbars, cbars)))
        r["nan_padding_unchanged"] = same
        check(same, f"dropout {dtype}: padded rows reached a real row")
        results.append(r)
    # sites of rate 0 beside sites with dropout (f32: exact masks)
    tally.start(x.dtype)
    for drops in ((0.0, 0.3, 0.0), (0.2, 0.0, 0.1)):
        mixed = dict(seed=DROP_SEEDS[0], drops=drops)
        errs = [rel_err(a[:, :n_real], b_[:, :n_real]) for a, b_ in zip(
            (vf_eval(x, w, **kw, **mixed),
             vf_bwd(x, w, gx, **kw, **mixed)[0]),
            (vf_eval(x, w, plain=True, **kw, **mixed),
             vf_bwd(x, w, gx, plain=True, **kw, **mixed)[0]))]
        results.append({"dtype": str(x.dtype), "drops": drops,
                        "fwd_and_xbar": errs})
        check(max(errs) <= TOL_F32, f"dropout {drops}: {errs}")
    # rates of 0 with a seed take the deterministic instance
    counts = dict(launch_counts)
    zero = vf_eval(x, w, seed=5, drops=(0.0, 0.0, 0.0), **kw)
    torch.cuda.synchronize()
    routed = {k: launch_counts[k] - counts[k] for k in counts}
    ok = (routed == {**{k: 0 for k in routed}, "vf_eval": 1}
          and torch.equal(zero, vf_eval(x, w, **kw)))
    results.append({"rates_0_with_seed": routed, "deterministic": ok})
    check(ok, f"rates of 0 did not take the deterministic instance: {routed}")
    tally.stop(x.dtype)
    results.append(tally.check("dropout_kernels_vs_plain"))
    launch_counts.update(before)           # comparisons do not count
    emit("dropout_kernels_vs_plain", results=results)


def phase_train_dropout(images_u8, labels, det):
    """Cell cifar100-vitode-train-drop0.1-b1024-bf16: the free step with
    the recipe's dropout, through the kernels' dropout instances and
    through the plain path, from the same weights and rng; beside the
    deterministic step's img/s of this run (``det``)."""
    runs, profile, cos, loss_rel, per_step = train_runs(images_u8, labels,
                                                        DROP_RATES)
    k, p = runs["kernels"], runs["plain"]
    emit("train_dropout_profile", **profile)
    emit("train_dropout", cell="cifar100-vitode-train-drop0.1-b1024-bf16",
         batch=BATCH, steps=TRAIN_STEPS, solver="rk4-13", jasmin_k=JASMIN_K,
         drops=DROP_RATES, rng=DROP_RNG,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         deterministic_img_per_s=det["kernels"]["img_per_s_best_of_2_3"],
         split_ms=k["split_ms"], busy_share=profile["busy_share"],
         first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         launches_per_step=per_step, results=runs)
    check_train("train_dropout", runs, cos, loss_rel, per_step,
                {"vf_eval_drop": 36, "vf_eval_jasmin_drop": 12,
                 "vf_bwd_drop": 48}, rows_bf16=ROWS_BF16_CIFAR)
    return k["launches"]


def phase_dropout_kernel_timing(model, images_u8):
    """Each dropout kernel alone at B=1024 on the main path's first state,
    against its plain version; the generator also against torch's
    ``bernoulli_`` over as many elements (the same distribution, other
    bits)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    before = dict(launch_counts)
    d, dh, heads = 192, 768, 3
    with torch.no_grad():
        tokens = model.patch_embed(make_preprocess(
            dtype=torch.bfloat16)(images_u8))
        n_real = tokens.shape[1]
        x = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        w = model.vf.kernel_weights(torch.bfloat16)
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
        rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), DROP_RATES))
        g = torch.Generator(device="cuda").manual_seed(7)
        gx = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        _, st, idx = vf_eval_jasmin(x, w, jas_k=JASMIN_K, **kw, **dkw)
        gj = torch.randn(st.shape, generator=g, device="cuda") * 1e-3
        gj[..., n_real:] = 0
        calls = dropout_calls(BATCH, n_real, d, dh, heads)
        elements = BATCH * n_real * (dh + 2 * d + heads * n_real)
        jobs = {
            "vf_eval_drop": (
                lambda pl: vf_eval(x, w, plain=pl, **kw, **dkw),
                with_masks(vf_bound(BATCH, n_real, d, dh, 2), calls)),
            "vf_eval_jasmin_drop": (
                lambda pl: vf_eval_jasmin(x, w, jas_k=JASMIN_K, plain=pl,
                                          **kw, **dkw),
                with_masks(jasmin_bound(BATCH, n_real, d, dh, heads, 2,
                                        JASMIN_K + 1), calls)),
            "vf_bwd_drop": (
                lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, plain=pl,
                                  **kw, **dkw),
                with_masks(bwd_bound(BATCH, n_real, d, dh, heads, 2), calls)),
            "dropout_masks": (
                lambda pl: generate_dropout_masks(
                    BATCH, n_real, d, dh, heads, DROP_SEEDS[2],
                    device="cuda", plain=pl, **rates),
                with_masks((elements * 4 / PEAK_BYTES_PER_S * 1e3, "bytes"),
                           calls))}
        out = {}
        for name, (fn, (bound_ms, bound_by, unit)) in jobs.items():
            got, want = fn(False), fn(True)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs, abs_err = [], 0.0
            for a, b_ in zip(got, want):
                if a.dtype == torch.int32:
                    continue
                real = a[:, :n_real] if a.dim() == 3 and name != \
                    "dropout_masks" else a
                ref = b_[:, :n_real] if b_.dim() == 3 and name != \
                    "dropout_masks" else b_
                errs.append(rel_err(real, ref))
                abs_err = max(abs_err, (real.float() - ref.float()).abs()
                              .max().item())
            check(max(errs) <= TOL_BF16, f"B={BATCH} {name}: {errs}")
            out[name] = {"max_abs_err": abs_err, "rel_errs": errs,
                         "ms": cuda_ms(lambda: fn(False), iters=10),
                         "plain_ms": cuda_ms(lambda: fn(True), iters=2),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_unit": unit, "library_ms": None}
        check(out["dropout_masks"]["max_abs_err"] == 0.0,
              "the generator is not bit-identical at B=1024")
        out["vf_bwd_drop"][ROWS_BF16] = rows_bf16_report(
            x, w, gx, kw, dict(g_jas=gj, jas_idx=idx, **dkw), drop=True)
        gen = torch.Generator(device="cuda").manual_seed(8)
        flat = torch.empty(elements, device="cuda")
        out["dropout_masks"]["library_ms"] = cuda_ms(
            lambda: flat.bernoulli_(1.0 - DROP_RATES[0], generator=gen),
            iters=10)
    launch_counts.update(before)           # comparisons do not count
    emit("dropout_kernel_timing", shape=f"B={BATCH} n={n_real}/80 D=192 "
         f"H=3 dh=768 bf16", drops=DROP_RATES, philox_calls=calls,
         results=out)
    return out

# --- distillation slice: the tiled route at the TS-Base shape -----------

DISTILL_BATCH = 64
DISTILL_K = 2                      # the recipe's jasmin_k
DISTILL_RECIPE = dict(lambda_param=0.5, jasmin_k=DISTILL_K, temperature=3.0,
                      use_kl_loss=False, mse_full_path=True)
# the tiled route's counters on the distillation main path, per step:
# 5 plain evaluations before the JaSMin window, 29 in it, the final
# evaluation with its maps, and 35 backwards
DISTILL_LAUNCHES = {"vf_eval_tiled": 5, "vf_eval_jasmin_tiled": 29,
                    "vf_eval_attn": 1, "vf_bwd_tiled": 35}


def attn_bound(b: int, n_real: int, d: int, dh: int, heads: int,
               itemsize: int):
    """(bound_ms, bound_by) of one attention-map evaluation: the forward's
    operations, against its bytes plus the maps written."""
    t_ops, _ = vf_bound(b, n_real, d, dh, itemsize)
    nbytes = ((2 * b * n_real * d + 4 * d * d + 2 * d * dh
               + b * heads * n_real * n_real) * itemsize + 16 * d)
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def distill_case(b, dtype, kind, g, n_real=207):
    """Inputs of one TS-Base evaluation (``n_real`` tokens padded to 208):
    a padded state (with "ties", six tokens copied from one), its
    cotangent, a JaSMin cotangent and a map cotangent, zero on padded
    rows."""
    import torch
    n_pad, d, heads = 208, 768, 12
    x = torch.randn(b, n_pad, d, generator=g, device="cuda")
    if kind == "ties":
        x[:, 5:11] = x[:, 5:6]
    x[:, n_real:] = 0
    gx = torch.randn(b, n_pad, d, generator=g, device="cuda") * 1e-2
    gx[:, n_real:] = 0
    gj = torch.randn(b, heads, 5, n_pad, generator=g, device="cuda") * 1e-2
    gj[..., n_real:] = 0
    ga = torch.randn(b, heads, n_pad, n_pad, generator=g, device="cuda")
    ga = ga * 1e-2
    ga[:, :, n_real:] = 0
    ga[..., n_real:] = 0
    return x.to(dtype), gx.to(dtype), gj, ga.to(dtype)


def phase_distill_kernels_vs_plain(model):
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    from odevit_tpu_torch.kernels.tiled import tiled_plan
    names = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
             "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
    b, n_real, n_pad = 4, model.patch_embed.seq_len, 208
    check(n_real == 207, f"TS-Base has 207 tokens, got {n_real}")
    kw = dict(num_heads=12, scaler=model.vf.scaler, n_real=n_real)
    kk = DISTILL_K + 1
    ranks = (0, 1, kk - 2, kk - 1)
    g = torch.Generator(device="cuda").manual_seed(4)
    before = dict(launch_counts)
    results = []
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        w = model.vf.kernel_weights(dtype)
        for kind in ("random", "ties"):
            x, gx, gj, ga = distill_case(b, dtype, kind, g)
            r = {"dtype": str(dtype), "case": kind, "tol": tol,
                 "shape": f"B={b} n={n_real}/{n_pad} D=768 H=12 dh=768",
                 "plan": tiled_plan(dtype, n_pad, n_real, 768, 12, 768)}
            counts = dict(launch_counts)
            dx = vf_eval(x, w, **kw)
            jdx, st, idx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw)
            adx, amap = vf_eval_attn(x, w, **kw)
            pdx = vf_eval(x, w, plain=True, **kw)
            _, pst, _ = vf_eval_jasmin(x, w, jas_k=DISTILL_K, plain=True,
                                       **kw)
            _, pmap = vf_eval_attn(x, w, plain=True, **kw)
            torch.cuda.synchronize()
            routed = {k: launch_counts[k] - counts[k] for k in counts}
            check(routed["vf_eval_tiled"] == 1
                  and routed["vf_eval_jasmin_tiled"] == 1
                  and routed["vf_eval_attn"] == 1
                  and routed["vf_eval"] == routed["vf_eval_jasmin"] == 0,
                  f"the forward did not take the tiled route: {routed}")
            r["route"] = "tiled"
            r["fwd"] = {
                "plain_dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                "jasmin_dx": rel_err(jdx[:, :n_real], pdx[:, :n_real]),
                "jasmin_stats": rel_err(st[..., :n_real], pst[..., :n_real]),
                "attn_dx": rel_err(adx[:, :n_real], pdx[:, :n_real]),
                "attn_map": rel_err(amap, pmap)}
            check(max(r["fwd"].values()) <= tol,
                  f"tiled fwd {dtype} {kind}: {r['fwd']}")
            check(not amap[:, :, n_real:].any() and not amap[..., n_real:]
                  .any(), "the map is not zero on padded rows and keys")
            # each statistic's column is a real key; the columns of
            # different ranks differ, those of one rank agree
            cols = idx[..., :n_real].long()
            ok = (cols >= 0) & (cols < n_real)
            for i in range(4):
                for j in range(4):
                    if i != j:
                        same = cols[:, :, i] == cols[:, :, j]
                        ok[:, :, i] &= same if ranks[i] == ranks[j] \
                            else ~same
            r["scatter"] = {"entries": cols.numel(),
                            "hit_once": int(ok.sum())}
            check(r["scatter"]["hit_once"] == r["scatter"]["entries"],
                  f"tiled jasmin columns {dtype} {kind}: {r['scatter']}")
            for case, extra in (("g", {}),
                                ("g_jas", dict(g_jas=gj, jas_idx=idx)),
                                ("g_attn", dict(g_attn=ga))):
                counts = dict(launch_counts)
                got = vf_bwd(x, w, gx, **kw, **extra)
                again = vf_bwd(x, w, gx, **kw, **extra)
                want = vf_bwd(x, w, gx, plain=True, **kw, **extra)
                torch.cuda.synchronize()
                check(launch_counts["vf_bwd_tiled"] - counts["vf_bwd_tiled"]
                      == 2 and launch_counts["vf_bwd"] == counts["vf_bwd"],
                      f"the backward ({case}) did not take the tiled route")
                errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                    b_[:, :n_real] if nm == "x" else b_)
                        for nm, a, b_ in zip(names, got, want)}
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                r["bwd_" + case] = errs
                r["repeat_bit_identical_" + case] = same
                check(max(errs.values()) <= tol,
                      f"tiled bwd {dtype} {kind} {case}: {errs}")
                check(same, f"tiled bwd {dtype} {kind} {case} not "
                      f"repeatable")
            if kind == "random":
                # NaN and garbage in padded rows (and in the padded rows
                # and keys of the map cotangent) change no real row
                dirty = x.clone()
                dirty[:, n_real:] = float("nan")
                gdirty = gx.clone()
                gdirty[:, n_real:] = 1e30
                adirty = ga.clone()
                adirty[:, :, n_real:] = float("nan")
                adirty[..., n_real:] = 7.0
                ddx, dmap = vf_eval_attn(dirty, w, **kw)
                _, dst, didx = vf_eval_jasmin(dirty, w, jas_k=DISTILL_K, **kw)
                dbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx,
                               g_attn=adirty, **kw)
                cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, g_attn=ga,
                               **kw)
                torch.cuda.synchronize()
                same = (torch.equal(ddx[:, :n_real], adx[:, :n_real])
                        and torch.equal(dmap, amap) and torch.equal(dst, st)
                        and torch.equal(didx, idx)
                        and all(torch.equal(a, c)
                                for a, c in zip(dbars, cbars)))
                r["nan_padding_unchanged"] = same
                check(same, f"{dtype}: padded rows reached a real row on "
                      f"the tiled route")
            results.append(r)
    launch_counts.update(before)           # comparisons do not count
    emit("distill_kernels_vs_plain", results=results)


def distill_student(drops=None):
    """The recipe's TS-Base student (224 px, patch 16, D=768, 12 heads,
    mlp 1.0, 10 registers, Euler on 36 points), bf16, from seed 0; with
    ``drops``, at those attn/proj/mlp dropout rates."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), drops or ()))
    return ViTODE.base_224(num_classes=100, dtype=torch.bfloat16,
                           device="cuda", seed=0, **rates)


def distill_runs(teacher, images_u8, labels, drops=None,
                 student_fn=None, recipe=None, stash=False, dtype=None):
    """3 steps through the kernels and through the plain path from the same
    student weights, teacher and batch (with ``drops``, the student's
    dropout rates, and the same rng); then one more step of each split by
    CUDA events into teacher, student forward, backward and optimizer, and
    one profiled step of the kernel path. The student is ``student_fn``'s
    (default the recipe's), the step's settings ``recipe`` (default
    ``DISTILL_RECIPE``) and ``stash``, its images preprocessed to
    ``dtype`` (default bf16). Returns (runs, profile, first-gradient
    cosine, loss differences, launches per step)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.train.fast_steps import (
        draw_step_seeds, fast_distill_forward, make_fast_distill_train_step)
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    # the recipe's CIFAR images are resized to 224 on the device, as the
    # CLI does (odevit_tpu/cli/classification_ode_distillation.py:73-74)
    pre = make_preprocess(image_size=224, dtype=dtype or torch.bfloat16)
    batch = {"pixel_values": images_u8, "labels": labels}
    recipe = recipe or DISTILL_RECIPE
    student_fn = student_fn or distill_student
    rng = DROP_RNG if drops else None
    runs = {}
    for path in ("kernels", "plain"):
        model = student_fn(drops)
        state = create_train_state(model, make_optimizer(1e-4))
        step = make_fast_distill_train_step(model, teacher,
                                            preprocess_fn=pre,
                                            plain=path == "plain",
                                            stash=stash, **recipe)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "kernels":
            reset_launch_counts()
            wgrad0 = wgrad_launches()
            gemm0 = gemm_launches()
            cta0 = f32_cta_launches()
            rows0 = rows_bf16_launches()
        losses, ms, metrics, first_grad = [], [], None, None
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng=rng, supervise=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            if i == 0:
                first_grad = grad_vector(model)
        launches = dict(launch_counts) if path == "kernels" else None
        wgrad = wgrad_since(wgrad0) if path == "kernels" else None
        gemm = (gemm_launches() - gemm0 if path == "kernels"
                else None)
        cta = f32_cta_since(cta0) if path == "kernels" else None
        rows = (rows_bf16_launches() - rows0 if path == "kernels"
                else None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        seeds = (draw_step_seeds(rng, state.step, model.num_eval_steps - 1)
                 if drops else None)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        x = pre(images_u8)
        with torch.no_grad():
            t_out = teacher(x)
        ev[1].record()
        loss, _ = fast_distill_forward(
            model, x, labels, t_out["hidden_states"][1:],
            t_out["attentions"][-1], supervise=True, step_seeds=seeds,
            plain=path == "plain", stash=stash, **recipe)
        ev[2].record()
        loss.backward()
        ev[3].record()
        state.apply_gradients()
        ev[4].record()
        torch.cuda.synchronize()
        if path == "kernels":
            profile = profile_step(
                lambda s, b: step(s, b, rng=rng, supervise=True), state,
                batch)
        runs[path] = {
            "loss": losses, "ms_per_step": ms,
            "img_per_s": DISTILL_BATCH / min(ms[1:]) * 1e3,
            "metrics_last": {k: v.item() for k, v in metrics.items()
                             if not k.startswith("mse_loss_t@")},
            "peak_mem_gb": peak,
            "split_ms": {"teacher": ev[0].elapsed_time(ev[1]),
                         "forward": ev[1].elapsed_time(ev[2]),
                         "backward": ev[2].elapsed_time(ev[3]),
                         "optimizer": ev[3].elapsed_time(ev[4])},
            "launches": launches, "wgrad_launches": wgrad,
            "gemm_launches": gemm,
            "f32_cta_launches": cta, "rows_bf16_launches": rows,
            "first_grad": first_grad}
        del model, state, step
    k, p = runs["kernels"], runs["plain"]
    cos = torch.nn.functional.cosine_similarity(
        k.pop("first_grad"), p.pop("first_grad"), dim=0).item()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])]
    per_step = {n: c / TRAIN_STEPS for n, c in k["launches"].items()}
    return runs, profile, cos, loss_rel, per_step


def step_ms_at_224(teacher, labels, rng):
    """The kernel path's distillation step (drop 0) fed 224 px uint8, no
    resize: best of steps 2-3 by the host clock."""
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.train.fast_steps import make_fast_distill_train_step
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    images = torch.from_numpy(rng.integers(
        0, 256, (DISTILL_BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    model = distill_student()
    state = create_train_state(model, make_optimizer(1e-4))
    step = make_fast_distill_train_step(
        model, teacher, preprocess_fn=make_preprocess(
            image_size=224, dtype=torch.bfloat16), **DISTILL_RECIPE)
    batch = {"pixel_values": images, "labels": labels}
    ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch, supervise=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms[1:])


def phase_distill(teacher, images_u8, labels, rng):
    """Cell tsref-distill-b64-bf16: the deterministic step (drop 0), the
    same-call reference of the dropout cell, on 32 px images resized on
    the device; beside it one step time fed 224 px images."""
    runs, profile, cos, loss_rel, per_step = distill_runs(teacher, images_u8,
                                                          labels)
    k, p = runs["kernels"], runs["plain"]
    ms_224 = step_ms_at_224(teacher, labels, rng)
    emit("distill_profile", **profile)
    emit("distill", cell="tsref-distill-b64-bf16", batch=DISTILL_BATCH,
         input="uint8 32x32 resized to 224", steps=TRAIN_STEPS,
         solver="euler-36", jasmin_k=DISTILL_K,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         ms_per_step_224px_input=ms_224,
         img_per_s=k["img_per_s"], plain_img_per_s=p["img_per_s"],
         first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         launches_per_step=per_step, results=runs)
    check_train("distill", runs, cos, loss_rel, per_step, DISTILL_LAUNCHES)
    return k["launches"], runs


def time_jobs(jobs, n_real: int, sfx: str = ""):
    """Each job (name -> (fn(plain) -> outputs, (bound_ms, bound_by), the
    Philox calls its masks take)) through the kernels against its plain
    version (bf16 tolerance; rows >= n_real of [B, n, D] outputs cut),
    then timed by CUDA events: 10 kernel runs, 2 plain runs. Returns the
    kernels line's fields by name + ``sfx``."""
    import torch
    out = {}
    for name, (fn, bound, calls) in jobs.items():
        bound_ms, bound_by, unit = with_masks(bound, calls)
        got, want = fn(False), fn(True)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs, abs_err = [], 0.0
        for a, b_ in zip(got, want):
            if a.dtype == torch.int32:
                continue
            real = a[:, :n_real] if a.dim() == 3 else a
            ref = b_[:, :n_real] if b_.dim() == 3 else b_
            errs.append(rel_err(real, ref))
            abs_err = max(abs_err, (real.float() - ref.float()).abs()
                          .max().item())
        check(max(errs) <= TOL_BF16, f"{name}{sfx}: {errs}")
        out[name + sfx] = {
            "max_abs_err": abs_err, "rel_errs": errs,
            "ms": cuda_ms(lambda: fn(False), iters=10),
            "plain_ms": cuda_ms(lambda: fn(True), iters=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_unit": unit, "library_ms": None}
    return out


def phase_distill_kernel_timing(model, images_u8, drops=None):
    """Each tiled kernel alone at B=64 on the distillation path's first
    state (the patch-embedded images), against its plain version; with
    ``drops``, each dropout instance, its bound counting the masks' Philox
    work (``with_masks``)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    before = dict(launch_counts)
    b, d, dh, heads = DISTILL_BATCH, 768, 768, 12
    with torch.no_grad():
        tokens = model.patch_embed(make_preprocess(
            image_size=224, dtype=torch.bfloat16)(images_u8))
        n_real = tokens.shape[1]
        x = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        w = model.vf.kernel_weights(torch.bfloat16)
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        if drops:
            kw.update(seed=DROP_SEEDS[2], drops=drops)
        g = torch.Generator(device="cuda").manual_seed(5)
        gx = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        _, _, idx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw)
        gj = torch.randn(b, heads, 5, x.shape[1], generator=g,
                         device="cuda") * 1e-3
        gj[..., n_real:] = 0
        _, amap = vf_eval_attn(x, w, **kw)
        ga = (torch.randn(amap.shape, generator=g, device="cuda")
              * 1e-3).to(torch.bfloat16)
        calls = dropout_calls(b, n_real, d, dh, heads) if drops else 0
        sfx = "_drop" if drops else ""
        jobs = {
            "vf_eval_tiled": (lambda pl: vf_eval(x, w, plain=pl, **kw),
                              vf_bound(b, n_real, d, dh, 2)),
            "vf_eval_jasmin_tiled": (
                lambda pl: vf_eval_jasmin(x, w, jas_k=DISTILL_K, plain=pl,
                                          **kw),
                jasmin_bound(b, n_real, d, dh, heads, 2, DISTILL_K + 1)),
            "vf_eval_attn": (lambda pl: vf_eval_attn(x, w, plain=pl, **kw),
                             attn_bound(b, n_real, d, dh, heads, 2)),
            "vf_bwd_tiled": (
                lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx,
                                  g_attn=ga, plain=pl, **kw),
                bwd_bound(b, n_real, d, dh, heads, 2,
                          map_cotangent=True))}
        out = time_jobs({name: (fn, bound, calls)
                         for name, (fn, bound) in jobs.items()}, n_real, sfx)
        if drops:
            # the map mode writing its four masks (emit_masks): the
            # dropout check's instance at the cell's state
            out.update(time_jobs({"vf_eval_masks": (
                lambda pl: (lambda f, p, m: (f, p, *m))(*vf_eval_attn(
                    x, w, plain=pl, emit_masks=True, **kw)),
                masks_bound(b, n_real, d, dh, heads, 2), calls)}, n_real))
    launch_counts.update(before)           # comparisons do not count
    emit("distill_dropout_kernel_timing" if drops else
         "distill_kernel_timing", shape=f"B={b} n={n_real}/{x.shape[1]} "
         f"D=768 H=12 dh=768 bf16", drops=drops, philox_calls=calls,
         results=out)
    return out


# --- distillation with dropout: the tiled route's dropout instances -----

# the tiled route's dropout counters on the distillation main path at
# dropout 0.1, per step (none on its deterministic counters)
DISTILL_DROP_LAUNCHES = {"vf_eval_tiled_drop": 5,
                         "vf_eval_jasmin_tiled_drop": 29,
                         "vf_eval_attn_drop": 1, "vf_bwd_tiled_drop": 35}


def phase_distill_dropout_kernels_vs_plain(model):
    """The tiled route's dropout instances at B=4, 207/208 tokens, against
    their plain versions in bf16 and f32: the plain, JaSMin and map
    forwards, the backward with g, g_jas and g_attn; the maps and
    statistics equal to the deterministic instances' (pre-dropout p);
    repeated backwards bit-identical; NaN padding inert; mixed rates (f32);
    rates of 0 on the deterministic instances."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    names = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
             "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
    b, n_real = 4, model.patch_embed.seq_len
    kw = dict(num_heads=12, scaler=model.vf.scaler, n_real=n_real)
    dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
    g = torch.Generator(device="cuda").manual_seed(9)
    before = dict(launch_counts)
    results = []

    def routed(counts):
        return {k: launch_counts[k] - counts[k] for k in counts
                if launch_counts[k] != counts[k]}

    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        w = model.vf.kernel_weights(dtype)
        x, gx, gj, ga = distill_case(b, dtype, "random", g)
        r = {"dtype": str(dtype), "tol": tol, "drops": DROP_RATES,
             "shape": f"B={b} n={n_real}/208 D=768 H=12 dh=768"}
        counts = dict(launch_counts)
        dx = vf_eval(x, w, **kw, **dkw)
        jdx, st, idx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw, **dkw)
        adx, amap = vf_eval_attn(x, w, **kw, **dkw)
        torch.cuda.synchronize()
        got = routed(counts)
        check(got == {"vf_eval_tiled_drop": 1, "vf_eval_jasmin_tiled_drop": 1,
                      "vf_eval_attn_drop": 1},
              f"the dropout forward did not take its tiled instances: {got}")
        pdx = vf_eval(x, w, plain=True, **kw, **dkw)
        pjdx, pst, _ = vf_eval_jasmin(x, w, jas_k=DISTILL_K, plain=True,
                                      **kw, **dkw)
        padx, pmap = vf_eval_attn(x, w, plain=True, **kw, **dkw)
        _, dst, didx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw)
        ddx, dmap = vf_eval_attn(x, w, **kw)
        torch.cuda.synchronize()
        r["fwd"] = {"plain_dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                    "jasmin_dx": rel_err(jdx[:, :n_real], pjdx[:, :n_real]),
                    "jasmin_stats": rel_err(st[..., :n_real],
                                            pst[..., :n_real]),
                    "attn_dx": rel_err(adx[:, :n_real], padx[:, :n_real]),
                    "attn_map": rel_err(amap, pmap)}
        check(max(r["fwd"].values()) <= tol,
              f"tiled dropout fwd {dtype}: {r['fwd']}")
        # one mask stream: the three modes draw the same masks
        r["modes_agree"] = bool(torch.equal(dx, jdx) and torch.equal(dx, adx))
        check(r["modes_agree"], f"{dtype}: the modes' dropout differs")
        # the map and the statistics are those of the pre-dropout p
        r["pre_dropout_map_and_stats"] = bool(
            torch.equal(amap, dmap) and torch.equal(st, dst)
            and torch.equal(idx, didx))
        check(r["pre_dropout_map_and_stats"],
              f"{dtype}: the map or the statistics saw the mask")
        r["vs_deterministic"] = rel_err(dx[:, :n_real], ddx[:, :n_real])
        check(r["vs_deterministic"] > 10 * tol,
              f"tiled dropout fwd {dtype} equals the deterministic one")
        for case, extra in (("g", {}), ("g_jas", dict(g_jas=gj, jas_idx=idx)),
                            ("g_attn", dict(g_attn=ga))):
            counts = dict(launch_counts)
            got = vf_bwd(x, w, gx, **kw, **dkw, **extra)
            again = vf_bwd(x, w, gx, **kw, **dkw, **extra)
            torch.cuda.synchronize()
            routes = routed(counts)
            check(routes == {"vf_bwd_tiled_drop": 2},
                  f"the dropout backward ({case}) took {routes}")
            want = vf_bwd(x, w, gx, plain=True, **kw, **dkw, **extra)
            torch.cuda.synchronize()
            errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                b_[:, :n_real] if nm == "x" else b_)
                    for nm, a, b_ in zip(names, got, want)}
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            r["bwd_" + case] = errs
            r["repeat_bit_identical_" + case] = same
            check(max(errs.values()) <= tol,
                  f"tiled dropout bwd {dtype} {case}: {errs}")
            check(same, f"tiled dropout bwd {dtype} {case} not repeatable")
        # NaN and garbage in padded rows (and in the padded rows and keys
        # of the map cotangent) change no real row
        dirty = x.clone()
        dirty[:, n_real:] = float("nan")
        gdirty = gx.clone()
        gdirty[:, n_real:] = 1e30
        adirty = ga.clone()
        adirty[:, :, n_real:] = float("nan")
        adirty[..., n_real:] = 7.0
        ndx, nmap = vf_eval_attn(dirty, w, **kw, **dkw)
        nbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx,
                       g_attn=adirty, **kw, **dkw)
        cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, g_attn=ga, **kw,
                       **dkw)
        torch.cuda.synchronize()
        same = (torch.equal(ndx[:, :n_real], adx[:, :n_real])
                and torch.equal(nmap, amap)
                and all(torch.equal(a, c) for a, c in zip(nbars, cbars)))
        r["nan_padding_unchanged"] = same
        check(same, f"tiled dropout {dtype}: padded rows reached a real row")
        results.append(r)
    # sites of rate 0 beside sites with dropout (f32: exact masks)
    for drops in ((0.0, 0.3, 0.0), (0.2, 0.0, 0.1)):
        mixed = dict(seed=DROP_SEEDS[0], drops=drops)
        got = (vf_eval_attn(x, w, **kw, **mixed)[0],
               vf_bwd(x, w, gx, g_attn=ga, **kw, **mixed)[0])
        want = (vf_eval_attn(x, w, plain=True, **kw, **mixed)[0],
                vf_bwd(x, w, gx, g_attn=ga, plain=True, **kw, **mixed)[0])
        errs = [rel_err(a[:, :n_real], b_[:, :n_real])
                for a, b_ in zip(got, want)]
        results.append({"dtype": str(x.dtype), "drops": drops,
                        "attn_dx_and_xbar": errs})
        check(max(errs) <= TOL_F32, f"tiled dropout {drops}: {errs}")
    # rates of 0 with a seed take the deterministic instances
    counts = dict(launch_counts)
    zero = dict(seed=5, drops=(0.0, 0.0, 0.0))
    za = vf_eval_attn(x, w, **kw, **zero)
    zb = vf_bwd(x, w, gx, g_attn=ga, **kw, **zero)
    torch.cuda.synchronize()
    got = routed(counts)
    ok = (got == {"vf_eval_attn": 1, "vf_bwd_tiled": 1}
          and all(torch.equal(a, c) for a, c in zip(
              za + zb, vf_eval_attn(x, w, **kw) + vf_bwd(x, w, gx, g_attn=ga,
                                                          **kw))))
    results.append({"rates_0_with_seed": got, "deterministic": ok})
    check(ok, f"rates of 0 did not take the deterministic instances: {got}")
    launch_counts.update(before)           # comparisons do not count
    emit("distill_dropout_kernels_vs_plain", results=results)


def phase_distill_dropout(teacher, images_u8, labels, det):
    """Cell tsref-distill-drop0.1-b64-bf16: the distillation step at the
    recipe's dropout 0.1, through the tiled route's dropout instances and
    through the plain path, from the same weights and rng; beside the
    drop-0 cell's img/s of this run (``det``)."""
    runs, profile, cos, loss_rel, per_step = distill_runs(
        teacher, images_u8, labels, DROP_RATES)
    k, p = runs["kernels"], runs["plain"]
    emit("distill_dropout_profile", **profile)
    emit("distill_dropout", cell="tsref-distill-drop0.1-b64-bf16",
         batch=DISTILL_BATCH, input="uint8 32x32 resized to 224",
         steps=TRAIN_STEPS, solver="euler-36",
         jasmin_k=DISTILL_K, drops=DROP_RATES, rng=DROP_RNG,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s"], plain_img_per_s=p["img_per_s"],
         drop0_img_per_s=det["kernels"]["img_per_s"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train("distill_dropout", runs, cos, loss_rel, per_step,
                DISTILL_DROP_LAUNCHES)
    return k["launches"]

# --- the ratio-4 student: the split backward ----------------------------

# JAX's headline distillation cell (benchmarks/train_speed.py:100-161,
# tsbase_b64): the student at MLP ratio 4 (dh=3072), no registers (197
# tokens padded to 208), Euler on 37 points; JaSMin k=2, lambda 0.5, the
# full-path MSE, supervised, the step's default temperature; 224 px uint8
# fed as it is
R4_RECIPE = dict(lambda_param=0.5, jasmin_k=DISTILL_K, temperature=30.0,
                 use_kl_loss=False, mse_full_path=True)
# per step: 5 plain evaluations, 30 in the JaSMin window, the final one
# with its maps, and 36 backwards on the split route (one launch of each
# half per backward)
R4_LAUNCHES = {"vf_eval_tiled": 5, "vf_eval_jasmin_tiled": 30,
               "vf_eval_attn": 1, "vf_bwd_split": 36, "vf_bwd_mlp": 36,
               "vf_bwd_attn": 36}
R4_DROP_LAUNCHES = {f"{k}_drop": v for k, v in R4_LAUNCHES.items()}
BWD_NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
             "norm_mlp_bias", "wqkv", "wout", "w1", "w2")


def r4_student(drops=None):
    """The ratio-4 TS-Base student as ``bench_distill`` builds it, bf16,
    from seed 0; with ``drops``, at those attn/proj/mlp dropout rates."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), drops or ()))
    return ViTODE(img_size=224, patch_size=16, embed_dim=768, num_heads=12,
                  mlp_ratio=4.0, num_classes=100, emulate_depth=12.0,
                  time_interval=1.0, num_eval_steps=37, solver="euler",
                  register_tokens=0, dtype=torch.bfloat16, device="cuda",
                  seed=0, **rates)


def mlp_bwd_bound(b: int, n_real: int, d: int, dh: int, itemsize: int):
    """(bound_ms, bound_by) of the MLP half: h1 recomputed, h_bar, m_bar
    and the two weight products (10 R D dh at the real token count) over
    the bf16 peak, against x and g in, x_bar_m (f32) out, W1 and W2 in and
    their f32 cotangents out, over the memory rate."""
    flops = 10 * b * n_real * d * dh
    nbytes = ((2 * b * n_real * d + 2 * d * dh) * itemsize
              + (b * n_real * d + 2 * d * dh + 2 * d) * 4)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def attn_bwd_bound(b: int, n_real: int, d: int, heads: int, itemsize: int,
                   map_cotangent: bool = False):
    """(bound_ms, bound_by) of the attention half: qkv recomputed, cb,
    a_bar and the two weight products (22 R D^2) and the six attention
    products (12 n^2 D an image) over the bf16 peak, against x, g and
    x_bar_m (f32) in, x_bar out, Wqkv and Wout in and their f32
    cotangents out, the JaSMin cotangent and columns (with
    ``map_cotangent`` also the maps'), over the memory rate."""
    flops = b * (22 * n_real * d * d + 12 * n_real * n_real * d)
    nbytes = ((3 * b * n_real * d + 4 * d * d) * itemsize
              + (b * n_real * d + 4 * d * d + 2 * d) * 4
              + b * heads * n_real * (5 + 4) * 4)
    if map_cotangent:
        nbytes += b * heads * n_real * n_real * itemsize
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_split_kernels_vs_plain(model, ratio1):
    """The ratio-4 shape at B=4 (197 tokens padded to 208, D=768, 12
    heads, dh=3072) in bf16 and f32: the tiled forward in its plain, JaSMin
    and map modes, each with and without dropout, against their plain
    versions; the split backward's halves, each alone (the attention half
    fed the plain MLP half's x_bar_m), and the pair through ``vf_bwd``,
    with g, g_jas and g_attn, with and without dropout, against their
    plain twins; the split route against the tiled route's backward on the
    same inputs; repeats bit-identical; NaN padding inert. At ratio 1
    (``ratio1``, 207 tokens) the split functions, called directly, against
    the tiled route that ``vf_bwd`` takes there."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import drop_spec
    from odevit_tpu_torch.kernels.tiled import tiled_backward
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import (_split_bars,
                                                           vf_bwd,
                                                           weight_splits)
    from odevit_tpu_torch.kernels.vector_field_bwd_split import (
        split_route, vf_bwd_attn, vf_bwd_mlp, vf_bwd_split)
    b, n_real, n_pad, d, dh = 4, model.patch_embed.seq_len, 208, 768, 3072
    check(n_real == 197 and split_route(d, dh) and not split_route(d, d),
          f"the ratio-4 student has 197 tokens and takes the split route")
    kw = dict(num_heads=12, scaler=model.vf.scaler, n_real=n_real)
    mkw = dict(scaler=model.vf.scaler, n_real=n_real)
    dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
    g = torch.Generator(device="cuda").manual_seed(11)
    before = dict(launch_counts)
    results = []

    def routed(counts):
        return {k: launch_counts[k] - counts[k] for k in counts
                if launch_counts[k] != counts[k]}

    def errs_of(names, got, want, n):
        return {nm: rel_err(a[:, :n] if a.dim() == 3 else a,
                            b_[:, :n] if b_.dim() == 3 else b_)
                for nm, a, b_ in zip(names, got, want)}

    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        w = model.vf.kernel_weights(dtype)
        x, gx, gj, ga = distill_case(b, dtype, "random", g, n_real=n_real)
        r = {"dtype": str(dtype), "tol": tol,
             "shape": f"B={b} n={n_real}/{n_pad} D=768 H=12 dh={dh}"}
        idx = None
        for dname, drop in (("det", {}), ("drop", dkw)):
            sfx = "" if not drop else "_drop"
            counts = dict(launch_counts)
            dx = vf_eval(x, w, **kw, **drop)
            jdx, st, jidx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw, **drop)
            adx, amap = vf_eval_attn(x, w, **kw, **drop)
            torch.cuda.synchronize()
            got = routed(counts)
            check(got == {"vf_eval_tiled" + sfx: 1,
                          "vf_eval_jasmin_tiled" + sfx: 1,
                          "vf_eval_attn" + sfx: 1},
                  f"the dh=3072 forward ({dname}) took {got}")
            pdx = vf_eval(x, w, plain=True, **kw, **drop)
            pjdx, pst, _ = vf_eval_jasmin(x, w, jas_k=DISTILL_K, plain=True,
                                          **kw, **drop)
            _, pmap = vf_eval_attn(x, w, plain=True, **kw, **drop)
            r["fwd_" + dname] = {
                "plain_dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                "jasmin_dx": rel_err(jdx[:, :n_real], pjdx[:, :n_real]),
                "jasmin_stats": rel_err(st[..., :n_real], pst[..., :n_real]),
                "attn_dx": rel_err(adx[:, :n_real], pdx[:, :n_real]),
                "attn_map": rel_err(amap, pmap)}
            check(max(r["fwd_" + dname].values()) <= tol,
                  f"dh=3072 fwd {dtype} {dname}: {r['fwd_' + dname]}")
            idx = jidx if idx is None else idx
            # the MLP half alone, once: it is the same for every cotangent
            counts = dict(launch_counts)
            m = vf_bwd_mlp(x, w, gx, **mkw, **drop)
            m2 = vf_bwd_mlp(x, w, gx, **mkw, **drop)
            pm = vf_bwd_mlp(x, w, gx, plain=True, **mkw, **drop)
            torch.cuda.synchronize()
            check(routed(counts) == {"vf_bwd_mlp" + sfx: 2},
                  f"the MLP half ({dname}) took {routed(counts)}")
            r["mlp_" + dname] = errs_of(
                ("xbar_m", "w1", "w2", "norm_mlp_scale", "norm_mlp_bias"),
                m, pm, n_real)
            r["mlp_repeat_bit_identical_" + dname] = all(
                torch.equal(a, c) for a, c in zip(m, m2))
            check(max(r["mlp_" + dname].values()) <= tol,
                  f"split MLP half {dtype} {dname}: {r['mlp_' + dname]}")
            check(r["mlp_repeat_bit_identical_" + dname],
                  f"split MLP half {dtype} {dname} not repeatable")
            for case, extra in (("g", {}),
                                ("g_jas", dict(g_jas=gj, jas_idx=idx)),
                                ("g_attn", dict(g_attn=ga))):
                key = f"{case}_{dname}"
                counts = dict(launch_counts)
                a = vf_bwd_attn(x, w, gx, pm[0], **kw, **drop, **extra)
                pa = vf_bwd_attn(x, w, gx, pm[0], plain=True, **kw, **drop,
                                 **extra)
                got = vf_bwd(x, w, gx, **kw, **drop, **extra)
                again = vf_bwd(x, w, gx, **kw, **drop, **extra)
                torch.cuda.synchronize()
                routes = routed(counts)
                check(routes == {"vf_bwd_attn" + sfx: 3,
                                 "vf_bwd_mlp" + sfx: 2,
                                 "vf_bwd_split" + sfx: 2},
                      f"the split backward ({key}) took {routes}")
                want = vf_bwd(x, w, gx, plain=True, **kw, **drop, **extra)
                xbar, wbars = tiled_backward(
                    x, w, gx,
                    splits=weight_splits(b * n_pad, d, dh, dtype=dtype),
                    drop=drop_spec(drop.get("seed"),
                                   drop.get("drops", (0.0, 0.0, 0.0))),
                    g_jas=extra.get("g_jas"), jas_idx=extra.get("jas_idx"),
                    g_attn=extra.get("g_attn"), **kw)
                tiled = _split_bars(xbar, wbars, d, dh)
                torch.cuda.synchronize()
                r["attn_" + key] = errs_of(
                    ("x", "norm_attn_scale", "norm_attn_bias", "wqkv",
                     "wout"), a, pa, n_real)
                r["pair_" + key] = errs_of(BWD_NAMES, got, want, n_real)
                r["split_vs_tiled_" + key] = errs_of(BWD_NAMES, got, tiled,
                                                      n_real)
                same = all(torch.equal(p, q) for p, q in zip(got, again))
                r["repeat_bit_identical_" + key] = same
                for part in ("attn_", "pair_", "split_vs_tiled_"):
                    check(max(r[part + key].values()) <= tol,
                          f"split {part}{dtype} {key}: {r[part + key]}")
                check(same, f"split backward {dtype} {key} not repeatable")
        # NaN and garbage in padded rows (and in the padded rows and keys
        # of the map cotangent) change no real row
        dirty = x.clone()
        dirty[:, n_real:] = float("nan")
        gdirty = gx.clone()
        gdirty[:, n_real:] = 1e30
        adirty = ga.clone()
        adirty[:, :, n_real:] = float("nan")
        adirty[..., n_real:] = 7.0
        for drop in ({}, dkw):
            nbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx,
                           g_attn=adirty, **kw, **drop)
            cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, g_attn=ga, **kw,
                           **drop)
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(nbars, cbars))
            r["nan_padding_unchanged" + ("_drop" if drop else "")] = same
            check(same, f"split {dtype}: padded rows reached a real row")
        # ratio 1 (207 tokens): the split functions against the tiled route
        w_r1 = ratio1.vf.kernel_weights(dtype)
        n1 = ratio1.patch_embed.seq_len
        x1, gx1, gj1, ga1 = distill_case(b, dtype, "random", g, n_real=n1)
        k1 = dict(kw, n_real=n1)
        _, _, idx1 = vf_eval_jasmin(x1, w_r1, jas_k=DISTILL_K, **k1)
        for drop in ({}, dkw):
            extra = dict(g_jas=gj1, jas_idx=idx1, g_attn=ga1)
            counts = dict(launch_counts)
            tiled = vf_bwd(x1, w_r1, gx1, **k1, **drop, **extra)
            split = vf_bwd_split(x1, w_r1, gx1, **k1, **drop, **extra)
            torch.cuda.synchronize()
            sfx = "_drop" if drop else ""
            check(routed(counts).get("vf_bwd_tiled" + sfx) == 1,
                  f"ratio 1 did not take the tiled route: {routed(counts)}")
            key = "ratio1_split_vs_tiled" + sfx
            r[key] = errs_of(BWD_NAMES, split, tiled, n1)
            check(max(r[key].values()) <= tol, f"{key} {dtype}: {r[key]}")
        results.append(r)
    launch_counts.update(before)           # comparisons do not count
    emit("split_kernels_vs_plain", results=results)


def phase_distill_r4(teacher, images_u8, labels, drops=None, det=None):
    """Cell tsbase-r4-distill-b64-bf16 (with ``drops``:
    tsbase-r4-distill-drop0.1-b64-bf16, ``rng=0``, beside the drop-0
    cell's img/s ``det``): 3 steps of the ratio-4 student through the
    kernels and through the plain path from the same weights, on 224 px
    uint8 images fed as they are; every backward on the split route."""
    runs, profile, cos, loss_rel, per_step = distill_runs(
        teacher, images_u8, labels, drops, student_fn=r4_student,
        recipe=R4_RECIPE)
    k, p = runs["kernels"], runs["plain"]
    name = "distill_r4_dropout" if drops else "distill_r4"
    emit(name + "_profile", **profile)
    emit(name, cell=("tsbase-r4-distill-drop0.1-b64-bf16" if drops
                     else "tsbase-r4-distill-b64-bf16"),
         batch=DISTILL_BATCH, input="uint8 224x224", steps=TRAIN_STEPS,
         solver="euler-37", jasmin_k=DISTILL_K, drops=drops,
         rng=DROP_RNG if drops else None,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s"], plain_img_per_s=p["img_per_s"],
         drop0_img_per_s=det["kernels"]["img_per_s"] if det else None,
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train(name, runs, cos, loss_rel, per_step,
                R4_DROP_LAUNCHES if drops else R4_LAUNCHES)
    return k["launches"], runs


def phase_distill_r4_kernel_timing(model, images_u8, drops=None):
    """At B=64 on the ratio-4 path's first state: the tiled forward's
    modes at dh=3072, the split backward's halves and the pair, and the
    tiled route's backward at the same shape (the TPU's split-or-combined
    trade-off, measured on this card), each against its plain version;
    with ``drops``, the dropout instances, bounds counting the masks."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import drop_spec
    from odevit_tpu_torch.kernels.tiled import tiled_backward
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import (_split_bars,
                                                           vf_bwd,
                                                           vf_bwd_plain,
                                                           weight_splits)
    from odevit_tpu_torch.kernels.vector_field_bwd_split import (vf_bwd_attn,
                                                                 vf_bwd_mlp)
    before = dict(launch_counts)
    b, d, dh, heads = DISTILL_BATCH, 768, 3072, 12
    with torch.no_grad():
        tokens = model.patch_embed(make_preprocess(
            image_size=224, dtype=torch.bfloat16)(images_u8))
        n_real = tokens.shape[1]
        n_pad = pad_tokens(n_real)
        x = torch.nn.functional.pad(
            tokens, (0, 0, 0, n_pad - n_real)).contiguous()
        w = model.vf.kernel_weights(torch.bfloat16)
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        dkw = dict(seed=DROP_SEEDS[2], drops=drops) if drops else {}
        mkw = dict(scaler=model.vf.scaler, n_real=n_real, **dkw)
        g = torch.Generator(device="cuda").manual_seed(12)
        gx = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        _, _, idx = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw)
        gj = torch.randn(b, heads, 5, n_pad, generator=g,
                         device="cuda") * 1e-3
        gj[..., n_real:] = 0
        _, amap = vf_eval_attn(x, w, **kw)
        ga = (torch.randn(amap.shape, generator=g, device="cuda")
              * 1e-3).to(torch.bfloat16)
        cot = dict(g_jas=gj, jas_idx=idx, g_attn=ga)
        xbar_m = vf_bwd_mlp(x, w, gx, **mkw)[0]
        c4 = lambda v: -(-v // 4)
        calls_mlp = b * n_real * (c4(dh) + c4(d)) if drops else 0
        calls_attn = (b * n_real * (c4(d) + heads * c4(n_real))
                      if drops else 0)
        splits = weight_splits(b * n_pad, d, dh, dtype=torch.bfloat16)

        def tiled(pl):
            if pl:
                return vf_bwd_plain(x, w, gx, **kw, **dkw, **cot)
            xbar, wbars = tiled_backward(
                x, w, gx, splits=splits, drop=drop_spec(
                    dkw.get("seed"), drops or (0.0, 0.0, 0.0)), **kw, **cot)
            return _split_bars(xbar, wbars, d, dh)

        jobs = {
            "vf_eval_tiled": (lambda pl: vf_eval(x, w, plain=pl, **kw, **dkw),
                              vf_bound(b, n_real, d, dh, 2),
                              calls_mlp + calls_attn),
            "vf_eval_jasmin_tiled": (
                lambda pl: vf_eval_jasmin(x, w, jas_k=DISTILL_K, plain=pl,
                                          **kw, **dkw),
                jasmin_bound(b, n_real, d, dh, heads, 2, DISTILL_K + 1),
                calls_mlp + calls_attn),
            "vf_eval_attn": (
                lambda pl: vf_eval_attn(x, w, plain=pl, **kw, **dkw),
                attn_bound(b, n_real, d, dh, heads, 2),
                calls_mlp + calls_attn),
            "vf_bwd_mlp": (lambda pl: vf_bwd_mlp(x, w, gx, plain=pl, **mkw),
                           mlp_bwd_bound(b, n_real, d, dh, 2), calls_mlp),
            "vf_bwd_attn": (
                lambda pl: vf_bwd_attn(x, w, gx, xbar_m, plain=pl, **kw,
                                       **dkw, **cot),
                attn_bwd_bound(b, n_real, d, heads, 2, map_cotangent=True),
                calls_attn),
            "vf_bwd_split": (
                lambda pl: vf_bwd(x, w, gx, plain=pl, **kw, **dkw, **cot),
                bwd_bound(b, n_real, d, dh, heads, 2, map_cotangent=True),
                calls_mlp + calls_attn),
            "vf_bwd_tiled": (tiled, bwd_bound(b, n_real, d, dh, heads, 2,
                                              map_cotangent=True),
                             calls_mlp + calls_attn)}
        out = time_jobs(jobs, n_real, "_drop" if drops else "")
    launch_counts.update(before)           # comparisons do not count
    emit("distill_r4_dropout_kernel_timing" if drops else
         "distill_r4_kernel_timing", shape=f"B={b} n={n_real}/{n_pad} "
         f"D=768 H=12 dh={dh} bf16", drops=drops, results=out)
    return out


# --- residual stashing: the stash forwards and resid backwards -----------

# (n_real, n_pad, D, heads, dh) of the three routes the stash reaches: one
# CTA per image (CIFAR), the tiled route (TS-Base, ratio 1), the split
# backward (ratio 4)
STASH_SHAPES = {"cifar": (69, 80, 192, 3, 768),
                "tsbase": (207, 208, 768, 12, 768),
                "r4": (197, 208, 768, 12, 3072)}
# the counters one stash forward (plain, JaSMin) and one resid backward
# add on each route
STASH_ROUTES = {
    "cifar": ("vf_eval_stash", "vf_eval_jasmin_stash", {"vf_bwd_resid": 1}),
    "tsbase": ("vf_eval_stash_tiled", "vf_eval_jasmin_stash_tiled",
               {"vf_bwd_resid_tiled": 1}),
    "r4": ("vf_eval_stash_tiled", "vf_eval_jasmin_stash_tiled",
           {"vf_bwd_split": 1, "vf_bwd_mlp_resid": 1,
            "vf_bwd_attn_resid": 1})}
# per step of the stash arms: every plain and JaSMin evaluation stashes and
# its backward reads the residuals; the final map evaluation (distillation)
# and its backward do not
STASH_LAUNCHES = {
    "cifar100-vitode-train-stash-b1024-bf16": {
        "vf_eval_stash": 36, "vf_eval_jasmin_stash": 12,
        "vf_bwd_resid": 48},
    "tsref-distill-stash-b64-bf16": {
        "vf_eval_stash_tiled": 5, "vf_eval_jasmin_stash_tiled": 29,
        "vf_eval_attn": 1, "vf_bwd_resid_tiled": 34, "vf_bwd_tiled": 1},
    "tsbase-r4-distill-stash-b64-bf16": {
        "vf_eval_stash_tiled": 5, "vf_eval_jasmin_stash_tiled": 30,
        "vf_eval_attn": 1, "vf_bwd_split": 36, "vf_bwd_mlp_resid": 35,
        "vf_bwd_attn_resid": 35, "vf_bwd_mlp": 1, "vf_bwd_attn": 1}}
STASH_AB_ROUNDS = 3


def stash_weights(dtype, d: int, heads: int, dh: int, g):
    """Random VFWeights at one shape: norms 1 + N(0, 0.1) and N(0, 0.1),
    matrices N(0, 1 / fan_in)."""
    import torch
    from odevit_tpu_torch.kernels.vector_field import VFWeights
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    mat = lambda i, o: (r(i, o) * i ** -0.5).to(dtype).contiguous()
    return VFWeights(1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d),
                     mat(d, 3 * d), mat(d, d), mat(d, dh), mat(dh, d))


def resid_rows(resid, b: int, n_pad: int, n_real: int):
    """The stash residuals' rows of real tokens, [B, n_real, width]."""
    return tuple(t.reshape(b, n_pad, -1)[:, :n_real] for t in resid)


def phase_stash_kernels_vs_plain():
    """The stash instances at B=4 on the three routes, bf16 and f32: each
    stash forward's f(x) bit-identical to the non-stash instance's (the
    JaSMin mode's statistics and columns too); rqkv, rh1 and f(x) against
    the plain stash version; the resid backward (± the JaSMin cotangent)
    against the plain version with the same residuals and against the
    recompute backward; repeats bit-identical; NaN in the padded rows of
    x, rqkv and rh1 inert; launches exactly as the route says."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import vf_eval, vf_eval_jasmin
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    b = 4
    g = torch.Generator(device="cuda").manual_seed(13)
    before = dict(launch_counts)
    results = []
    tally = F32Tally()
    for shape, (n_real, n_pad, d, heads, dh) in STASH_SHAPES.items():
        fwd_c, jas_c, bwd_c = STASH_ROUTES[shape]
        for dtype, tol in ((torch.bfloat16, TOL_BF16),
                           (torch.float32, TOL_F32)):
            tally.start(dtype)
            w = stash_weights(dtype, d, heads, dh, g)
            kw = dict(num_heads=heads, scaler=0.25, n_real=n_real)
            x = torch.randn(b, n_pad, d, generator=g, device="cuda")
            x[:, n_real:] = 0
            gx = torch.randn(b, n_pad, d, generator=g, device="cuda") * 1e-2
            gx[:, n_real:] = 0
            gj = torch.randn(b, heads, 5, n_pad, generator=g,
                             device="cuda") * 1e-2
            gj[..., n_real:] = 0
            x, gx = x.to(dtype), gx.to(dtype)
            r = {"shape": f"{shape}: B={b} n={n_real}/{n_pad} D={d} "
                 f"H={heads} dh={dh}", "dtype": str(dtype), "tol": tol}
            counts = dict(launch_counts)
            dx, resid = vf_eval(x, w, stash=True, **kw)
            jdx, st, idx, jresid = vf_eval_jasmin(x, w, jas_k=DISTILL_K,
                                                  stash=True, **kw)
            torch.cuda.synchronize()
            routed = {k: v - counts[k] for k, v in launch_counts.items()
                      if v != counts[k]}
            check(routed == {fwd_c: 1, jas_c: 1},
                  f"stash forwards {shape} {dtype}: {routed}")
            ref = vf_eval(x, w, **kw)
            jref = vf_eval_jasmin(x, w, jas_k=DISTILL_K, **kw)
            pdx, presid = vf_eval(x, w, stash=True, plain=True, **kw)
            torch.cuda.synchronize()
            r["dx_bit_identical"] = (torch.equal(dx, ref)
                                     and torch.equal(jdx, jref[0])
                                     and torch.equal(st, jref[1])
                                     and torch.equal(idx, jref[2]))
            check(r["dx_bit_identical"], f"stash forward {shape} {dtype}: "
                  f"f(x) differs from the non-stash instance's")
            r["fwd"] = {"dx": rel_err(dx[:, :n_real], pdx[:, :n_real])}
            for mode, res in (("plain", resid), ("jasmin", jresid)):
                for name, a, p_ in zip(("rqkv", "rh1"),
                                       resid_rows(res, b, n_pad, n_real),
                                       resid_rows(presid, b, n_pad, n_real)):
                    r["fwd"][f"{mode}_{name}"] = rel_err(a, p_)
            check(max(r["fwd"].values()) <= tol,
                  f"stash forward {shape} {dtype}: {r['fwd']}")
            rq, rh = resid
            for case, extra in (("g", {}),
                                ("g_jas", dict(g_jas=gj, jas_idx=idx))):
                counts = dict(launch_counts)
                got = vf_bwd(x, w, gx, resid_qkv=rq, resid_h1=rh, **kw,
                             **extra)
                again = vf_bwd(x, w, gx, resid_qkv=rq, resid_h1=rh, **kw,
                               **extra)
                torch.cuda.synchronize()
                routed = {k: v - counts[k] for k, v in launch_counts.items()
                          if v != counts[k]}
                check(routed == {k: 2 * v for k, v in bwd_c.items()},
                      f"resid backward {shape} {dtype} {case}: {routed}")
                want = vf_bwd(x, w, gx, resid_qkv=rq, resid_h1=rh,
                              plain=True, **kw, **extra)
                rec = vf_bwd(x, w, gx, **kw, **extra)
                torch.cuda.synchronize()
                cut = lambda nm, a: a[:, :n_real] if nm == "x" else a
                for key, ref_bars in (("vs_plain", want),
                                      ("vs_recompute", rec)):
                    errs = {nm: rel_err(cut(nm, a), cut(nm, c))
                            for nm, a, c in zip(BWD_NAMES, got, ref_bars)}
                    r[f"bwd_{case}_{key}"] = errs
                    check(max(errs.values()) <= tol,
                          f"resid backward {shape} {dtype} {case} {key}: "
                          f"{errs}")
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                r[f"repeat_bit_identical_{case}"] = same
                check(same, f"resid backward {shape} {dtype} {case} not "
                      f"repeatable")
            # NaN in the padded rows of x, rqkv and rh1, garbage in g's:
            # the stash forward's real rows and the backward unchanged
            dirty = x.clone()
            dirty[:, n_real:] = float("nan")
            gdirty = gx.clone()
            gdirty[:, n_real:] = 1e30
            rdirty = []
            for t in resid:
                t = t.clone()
                t.view(b, n_pad, -1)[:, n_real:] = float("nan")
                rdirty.append(t)
            ddx, _ = vf_eval(dirty, w, stash=True, **kw)
            dbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx,
                           resid_qkv=rdirty[0], resid_h1=rdirty[1], **kw)
            cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, resid_qkv=rq,
                           resid_h1=rh, **kw)
            torch.cuda.synchronize()
            r["nan_padding_unchanged"] = (
                torch.equal(ddx[:, :n_real], dx[:, :n_real])
                and all(torch.equal(a, c) for a, c in zip(dbars, cbars)))
            check(r["nan_padding_unchanged"],
                  f"stash {shape} {dtype}: padded rows reached a real row")
            results.append(r)
            tally.stop(dtype)
    results.append(tally.check("stash_kernels_vs_plain"))
    launch_counts.update(before)           # comparisons do not count
    emit("stash_kernels_vs_plain", results=results)


def backward_profile(loss_fn, top: int = 12):
    """Device time of one backward by kernel under torch.profiler (the
    forward, ``loss_fn()``, runs outside it): total, and the largest
    ``top`` kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    loss = loss_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "top": [{"kernel": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:top]]}


def kernel_parts(fn, calls: int = 3):
    """Device time of each kernel that ``calls`` calls of ``fn`` launch,
    under torch.profiler (after one call outside it): {kernel name without
    its arguments: {"ms_per_launch", "launches" the profiler recorded}},
    largest first. Per launch, not per call: the profiler does not record
    every launch of a window (seen on the H100)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    def name(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0][:60]

    rows = [(name(e.key),
             {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
              "launches": e.count})
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1]["ms_per_launch"] * r[1]["launches"])
    return dict(rows)


def kernel_resources(source: str, names) -> dict:
    """Registers, stack frame and spills of each kernel of ``source``
    whose mangled name holds one of ``names``, as ``-Xptxas -v`` printed
    them when this process built the library (empty if it did not)."""
    from odevit_tpu_torch.kernels import build
    lines = build.build_logs.get(source, "").splitlines()
    out = {}
    for i, ln in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", ln)
        if not m or not any(n in m.group(1) for n in names):
            continue
        props = " ".join(lines[i + 1:i + 3])

        def num(pattern):
            found = re.search(pattern, props)
            return int(found.group(1)) if found else None

        out[m.group(1)] = {"registers": num(r"Used (\d+) registers"),
                           "stack": num(r"(\d+) bytes stack frame"),
                           "spill_stores": num(r"(\d+) bytes spill stores"),
                           "spill_loads": num(r"(\d+) bytes spill loads")}
    return out


def stash_ab(make_model, make_step, loss_fn, batch, nb: int):
    """The stash and recompute arms of one cell on the kernels, from the
    same weights and batch: their first steps compared (loss and
    gradient), then ``STASH_AB_ROUNDS`` rounds of one step each, the order
    alternating (recompute, stash, stash, recompute, ...), timed by the
    host clock after a synchronise; each arm's peak memory over its steps
    and what its step adds to the memory held before it; one profiled
    backward of each. ``make_step(model, stash)`` -> step(state, batch);
    ``loss_fn(model, stash)`` -> the step's loss, for the profile."""
    import torch
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    arms, first = {}, {}
    for arm in ("recompute", "stash"):
        model = make_model()
        state = create_train_state(model, make_optimizer(1e-4))
        arms[arm] = {"model": model, "state": state,
                     "step": make_step(model, arm == "stash"), "ms": [],
                     "peak_gb": 0.0, "step_gb": 0.0}
    order = []
    for i in range(STASH_AB_ROUNDS + 1):
        pair = ("recompute", "stash") if i % 2 == 0 else ("stash",
                                                          "recompute")
        order += pair
    for i, arm in enumerate(order):
        a = arms[arm]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a["state"], met = a["step"](a["state"], batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        a["peak_gb"] = max(a["peak_gb"], peak / 1e9)
        a["step_gb"] = max(a["step_gb"], (peak - held) / 1e9)
        if arm not in first:
            # the first step of each arm: the same weights and batch
            first[arm] = (met["loss"].item(), grad_vector(a["model"]))
        else:
            a["ms"].append(ms)
    (lr, gr), (ls, gs) = first["recompute"], first["stash"]
    agreement = {
        "loss_rel_diff": abs(ls - lr) / abs(lr),
        "grad_cosine": torch.nn.functional.cosine_similarity(
            gs, gr, dim=0).item(),
        "grad_rel_diff": ((gs - gr).abs().max() / gr.abs().max()).item()}
    out = {"agreement": agreement, "order": order}
    for arm, a in arms.items():
        prof = backward_profile(lambda: loss_fn(a["model"], arm == "stash"))
        out[arm] = {"ms_per_step": a["ms"],
                    "img_per_s": nb / min(a["ms"]) * 1e3,
                    "peak_mem_gb": a["peak_gb"], "step_mem_gb": a["step_gb"],
                    "backward_profile": prof}
    rec, st = out["recompute"], out["stash"]
    out["stash_speedup"] = min(rec["ms_per_step"]) / min(st["ms_per_step"])
    bwd_r = rec["backward_profile"]["device_ms"]
    bwd_s = st["backward_profile"]["device_ms"]
    out["backward_device_ms"] = {
        "recompute": bwd_r, "stash": bwd_s,
        "recompute_share": (bwd_r - bwd_s) / bwd_r if bwd_r else None}
    for a in arms.values():
        a["model"].zero_grad(set_to_none=True)
    del arms
    return out


def check_stash_ab(name, ab):
    agree = ab["agreement"]
    check(agree["loss_rel_diff"] <= TOL_TRAIN_LOSS
          and agree["grad_cosine"] >= MIN_GRAD_COSINE,
          f"{name}: stash against recompute {agree}")


def phase_stash_train(images_u8, labels, teacher, images_d, labels_d,
                      images_r4):
    """The stash arm of three cells: 3 steps through the kernels and the
    plain path with ``stash=True`` (losses, first gradient, launches),
    then the A/B against the recompute arm on the kernels
    (``stash_ab``)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.models.vit_ode import ViTODE
    from odevit_tpu_torch.train.fast_steps import (
        fast_distill_forward, fast_free_forward, make_fast_distill_train_step,
        make_fast_free_train_step)
    launches = {}
    cells = list(STASH_LAUNCHES)
    # CIFAR: the free step, rk4 on 13 points, B=1024
    pre = make_preprocess(dtype=torch.bfloat16)
    cifar = lambda: ViTODE(**SHAPE, num_eval_steps=13, solver="rk4",
                           dtype=torch.bfloat16, device="cuda", seed=0)
    runs, profile, cos, loss_rel, per_step = train_runs(images_u8, labels,
                                                        stash=True)
    check_train(cells[0], runs, cos, loss_rel, per_step,
                STASH_LAUNCHES[cells[0]], rows_bf16=ROWS_BF16_CIFAR)
    ab = stash_ab(
        cifar, lambda m, s: make_fast_free_train_step(
            m, jasmin_k=JASMIN_K, preprocess_fn=pre, stash=s),
        lambda m, s: fast_free_forward(m, pre(images_u8), labels,
                                       jasmin_k=JASMIN_K, stash=s)[0],
        {"pixel_values": images_u8, "labels": labels}, BATCH)
    check_stash_ab(cells[0], ab)
    report = [(cells[0], runs, profile, cos, loss_rel, per_step, ab)]
    launches[cells[0]] = runs["kernels"]["launches"]
    # TS-Base at ratio 1 and 4: the distillation step, B=64
    pre224 = make_preprocess(image_size=224, dtype=torch.bfloat16)
    for cell, fn, recipe, imgs in (
            (cells[1], distill_student, DISTILL_RECIPE, images_d),
            (cells[2], r4_student, R4_RECIPE, images_r4)):
        runs, profile, cos, loss_rel, per_step = distill_runs(
            teacher, imgs, labels_d, student_fn=fn, recipe=recipe,
            stash=True)
        check_train(cell, runs, cos, loss_rel, per_step,
                    STASH_LAUNCHES[cell])

        def loss_fn(m, s, imgs=imgs, recipe=recipe):
            x = pre224(imgs)
            with torch.no_grad():
                t_out = teacher(x)
            return fast_distill_forward(
                m, x, labels_d, t_out["hidden_states"][1:],
                t_out["attentions"][-1], supervise=True, stash=s,
                **recipe)[0]

        ab = stash_ab(
            fn, lambda m, s, recipe=recipe: (
                lambda step: lambda st, bt: step(st, bt, supervise=True))(
                make_fast_distill_train_step(m, teacher,
                                             preprocess_fn=pre224, stash=s,
                                             **recipe)),
            loss_fn, {"pixel_values": imgs, "labels": labels_d},
            DISTILL_BATCH)
        check_stash_ab(cell, ab)
        report.append((cell, runs, profile, cos, loss_rel, per_step, ab))
        launches[cell] = runs["kernels"]["launches"]
    for cell, runs, profile, cos, loss_rel, per_step, ab in report:
        k, p = runs["kernels"], runs["plain"]
        emit("stash_train_profile", cell=cell, stash_step=profile,
             backward_recompute=ab["recompute"]["backward_profile"],
             backward_stash=ab["stash"]["backward_profile"],
             backward_device_ms=ab["backward_device_ms"])
        emit("stash_train", cell=cell, steps=TRAIN_STEPS,
             img_per_s=k["img_per_s"], plain_img_per_s=p["img_per_s"],
             first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
             loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
             launches_per_step=per_step, peak_mem_gb=k["peak_mem_gb"],
             split_ms=k["split_ms"],
             stash_vs_recompute=ab["agreement"],
             stash_img_per_s=ab["stash"]["img_per_s"],
             recompute_img_per_s=ab["recompute"]["img_per_s"],
             stash_speedup=ab["stash_speedup"],
             stash_peak_mem_gb=ab["stash"]["peak_mem_gb"],
             recompute_peak_mem_gb=ab["recompute"]["peak_mem_gb"],
             stash_step_mem_gb=ab["stash"]["step_mem_gb"],
             recompute_step_mem_gb=ab["recompute"]["step_mem_gb"],
             ab_ms={arm: ab[arm]["ms_per_step"]
                    for arm in ("recompute", "stash")}, ab_order=ab["order"],
             results=runs)
    return launches


def _bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def stash_bounds(b: int, n_real: int, d: int, dh: int, heads: int,
                 itemsize: int, kk: int):
    """(bound_ms, bound_by) of each stash instance: the operations and
    bytes of its non-stash counterpart (``vf_bound``, ``jasmin_bound``,
    ``bwd_bound``, ``mlp_bwd_bound``, ``attn_bwd_bound``), the resid
    backwards less the products they skip (2 n D (3D + dh) an image: qkv
    and h1; each half its own), every one plus the residual bytes of the
    real rows it writes or reads."""
    rows = b * n_real
    weights = 4 * d * d + 2 * d * dh
    fwd = b * (n_real * (8 * d * d + 4 * d * dh) + 4 * n_real * n_real * d)
    fwd_bytes = (2 * rows * d + weights) * itemsize + 16 * d
    stats = b * heads * n_real * (5 + 4) * 4
    bwd = b * (n_real * (10 * d * dh + 22 * d * d)
               + 12 * n_real * n_real * d)
    bwd_bytes = (3 * rows * d + weights) * itemsize + (weights + 4 * d) * 4
    mlp = 10 * rows * d * dh
    mlp_bytes = ((2 * rows * d + 2 * d * dh) * itemsize
                 + (rows * d + 2 * d * dh + 2 * d) * 4)
    attn = b * (22 * n_real * d * d + 12 * n_real * n_real * d)
    attn_bytes = ((3 * rows * d + 4 * d * d) * itemsize
                  + (rows * d + 4 * d * d + 2 * d) * 4 + stats)
    rq, rh = rows * 3 * d * itemsize, rows * dh * itemsize
    return {
        "fwd": _bound(fwd, fwd_bytes + rq + rh),
        "jasmin": _bound(fwd + b * heads * n_real * n_real * kk,
                         fwd_bytes + stats + rq + rh),
        "bwd": _bound(bwd - rows * (6 * d * d + 2 * d * dh),
                      bwd_bytes + stats + rq + rh),
        "mlp": _bound(mlp - 2 * rows * d * dh, mlp_bytes + rh),
        "attn": _bound(attn - 6 * rows * d * d, attn_bytes + rq)}


def first_state(model, images_u8, image_size=None):
    """The padded tokens of a batch (the first state of the path), the
    weights and the evaluation's keywords, bf16."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels.vector_field import pad_tokens
    tokens = model.patch_embed(make_preprocess(
        image_size=image_size, dtype=torch.bfloat16)(images_u8))
    n_real = tokens.shape[1]
    x = torch.nn.functional.pad(
        tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
    kw = dict(num_heads=model.num_heads, scaler=model.vf.scaler,
              n_real=n_real)
    return x, model.vf.kernel_weights(torch.bfloat16), kw


def phase_stash_kernel_timing(images_u8, images_d, images_r4):
    """Each stash instance alone on its cell's first state, against its
    plain version: the one-CTA forwards and resid backward at B=1024 on
    the CIFAR shape, the tiled ones at B=64 on the TS-Base student's, the
    split halves' resid instances at B=64 on the ratio-4 student's."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.models.vit_ode import ViTODE
    from odevit_tpu_torch.kernels.vector_field import vf_eval, vf_eval_jasmin
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    from odevit_tpu_torch.kernels.vector_field_bwd_split import (vf_bwd_attn,
                                                                 vf_bwd_mlp)
    before = dict(launch_counts)
    flat = lambda out: (*out[:-1], *out[-1])
    out, shapes = {}, {}
    cases = (("", lambda: ViTODE(**SHAPE, num_eval_steps=13, solver="rk4",
                                 dtype=torch.bfloat16, device="cuda",
                                 seed=0), images_u8, None, JASMIN_K),
             ("_tiled", distill_student, images_d, 224, DISTILL_K),
             ("_r4", r4_student, images_r4, 224, DISTILL_K))
    for sfx, make, imgs, size, k in cases:
        model = make()
        with torch.no_grad():
            x, w, kw = first_state(model, imgs, size)
            b, n_pad, d = x.shape
            n_real, heads, dh = kw["n_real"], kw["num_heads"], w.w1.shape[1]
            g = torch.Generator(device="cuda").manual_seed(14)
            gx = (torch.randn(x.shape, generator=g, device="cuda")
                  * 1e-3).to(torch.bfloat16)
            _, _, idx, (rq, rh) = vf_eval_jasmin(x, w, jas_k=k, stash=True,
                                                 **kw)
            gj = torch.randn(b, heads, 5, n_pad, generator=g,
                             device="cuda") * 1e-3
            gj[..., n_real:] = 0
            bounds = stash_bounds(b, n_real, d, dh, heads, 2, k + 1)
            res = dict(resid_qkv=rq, resid_h1=rh)
            shapes[sfx or "_cta"] = (f"B={b} n={n_real}/{n_pad} D={d} "
                                     f"H={heads} dh={dh} bf16")
            if sfx == "_r4":
                mkw = dict(scaler=kw["scaler"], n_real=n_real)
                xbar_m = vf_bwd_mlp(x, w, gx, resid_h1=rh, **mkw)[0]
                jobs = {
                    "vf_bwd_mlp_resid": (
                        lambda pl: vf_bwd_mlp(x, w, gx, resid_h1=rh,
                                              plain=pl, **mkw),
                        bounds["mlp"], 0),
                    "vf_bwd_attn_resid": (
                        lambda pl: vf_bwd_attn(x, w, gx, xbar_m, g_jas=gj,
                                               jas_idx=idx, resid_qkv=rq,
                                               plain=pl, **kw),
                        bounds["attn"], 0)}
            else:
                jobs = {
                    "vf_eval_stash" + sfx: (
                        lambda pl: flat(vf_eval(x, w, stash=True, plain=pl,
                                                **kw)),
                        bounds["fwd"], 0),
                    "vf_eval_jasmin_stash" + sfx: (
                        lambda pl: flat(vf_eval_jasmin(
                            x, w, jas_k=k, stash=True, plain=pl, **kw)),
                        bounds["jasmin"], 0),
                    "vf_bwd_resid" + sfx: (
                        lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx,
                                          plain=pl, **res, **kw),
                        bounds["bwd"], 0)}
            out.update(time_jobs(jobs, n_real))
            if not sfx:
                out["vf_bwd_resid"][ROWS_BF16] = rows_bf16_report(
                    x, w, gx, kw, dict(g_jas=gj, jas_idx=idx, **res),
                    resid=True)
                out["vf_bwd_resid"]["recomputed_qkv_bit_identical"] = \
                    recompute_matches_stash(x, w, gx, kw, dict(
                        g_jas=gj, jas_idx=idx), rq, rh)
        del model
    launch_counts.update(before)           # comparisons do not count
    emit("stash_kernel_timing", shapes=shapes, results=out)
    return out


# --- serving slice: the 224 px student, the chained Euler kernel ---------

SERVE224_BATCH = 64
# the serving cells at 224 px (bench.py:298-303 drives euler-25 at B=64):
# (solver, grid points) and the launches of one forward; 24 evaluations
# each
SERVE224_CELLS = {
    "tsbase-serve-euler25-b64-bf16": ("euler", 25,
                                      {"vf_eval_euler_tiled": 24}),
    "tsbase-serve-rk4-7-b64-bf16": ("rk4", 7, {"vf_eval_euler_tiled": 6,
                                              "vf_eval_base_tiled": 18})}
# ODEVIT_EULER_CHAIN values at the CIFAR shape (48 Euler steps)
CHAINS = (4, 12)
DOPRI5_BATCH = 8


def serve_student(solver, steps, dtype="bfloat16"):
    """The TS-Base student (``ViTODE.base_224``: 224 px, patch 16, D=768,
    12 heads, mlp 1.0, 10 registers, 100 classes) on ``steps`` grid points
    of ``solver``, from seed 0."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    return ViTODE.base_224(num_classes=100, solver=solver,
                           num_eval_steps=steps,
                           dtype=getattr(torch, dtype) if dtype else None,
                           device="cuda", seed=0)


def phase_serve_224(rng):
    """Cells tsbase-serve-euler25-b64-bf16 and tsbase-serve-rk4-7-b64-bf16:
    ``fast_forward`` of the 224 px student at B=64 on uint8 CIFAR-size
    images (32 px, the recipe's data) resized on the device by
    ``make_preprocess(image_size=224)``, through the tiled route's Euler
    and stage-advance modes and through the plain path; launches counted,
    img/s by CUDA events after a warm-up, peak memory; then one dopri5
    forward at B=8 against the plain path (f32: see the docstring of
    ``dopri5_check``)."""
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    b = SERVE224_BATCH
    pre = make_preprocess(image_size=224, dtype=torch.bfloat16)
    images = torch.from_numpy(rng.integers(0, 256, (b, 32, 32, 3),
                                           dtype=np.uint8)).cuda()
    x = pre(images)
    check(tuple(x.shape) == (b, 224, 224, 3), f"resized to {x.shape}")
    pre_ms = cuda_ms(lambda: pre(images), iters=10)
    report, students = {}, {}
    for cell, (solver, steps, want_launches) in SERVE224_CELLS.items():
        model = serve_student(solver, steps)
        reset_launch_counts()
        gemm0 = gemm_launches()
        got = fast_forward(model, x)["logits"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts.items() if v}
        check(launches == want_launches,
              f"{cell}: launches {launches}, want {want_launches}")
        gemms = check_gemm_route(cell, launches, gemm_launches() - gemm0)
        want = fast_forward(model, x, plain=True)["logits"]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{cell}: non-finite logits")
        check(tuple(got.shape) == (b, 100), f"{cell}: shape {got.shape}")
        err = rel_err(got, want)
        top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fast_forward(model, x), iters=5)
        peak = torch.cuda.max_memory_allocated()
        plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True),
                           iters=2)
        evals = sum(want_launches.values())
        report[cell] = {
            "solver": f"{solver}-{steps}", "launches": launches,
            "gemm_launches": gemms,
            "max_abs_dlogit": (got - want).abs().max().item(),
            "rel_err": err, "tol": TOL_LOGITS, "top1_agreement": top1,
            "ms_per_forward": ms, "img_per_s": b / ms * 1e3,
            "ms_per_eval": ms / evals, "plain_ms_per_forward": plain_ms,
            "plain_img_per_s": b / plain_ms * 1e3,
            "peak_mem_gb": peak / 1e9,
            "scratch_gb": (peak - before) / 1e9}
        check(err <= TOL_LOGITS, f"{cell}: logits rel err {err}")
        check(top1 >= MIN_TOP1_AGREEMENT, f"{cell}: top-1 agreement {top1}")
        students[cell] = model
    dopri5 = dopri5_check(images[:DOPRI5_BATCH])
    emit("serve_224", batch=b, input="uint8 32x32 resized to 224",
         preprocess_ms=pre_ms, results=report, dopri5=dopri5)
    return x, report, students


def dopri5_check(images_u8):
    """One dopri5 forward (``fast_forward``: one segment [0, 1], rtol
    1e-5, atol 1e-6) of the TS-Base student at B=8 through the tiled route
    and through the plain path. In float32: in bf16 the error estimate sits
    at the state's rounding (2^-8 relative, 400x rtol), so every step is
    rejected and the segment stops at the cap short of t=1. The launches
    of the kernel path are its evaluations (nfe)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    model = serve_student("dopri5", 25, dtype=None)
    x = make_preprocess(image_size=224)(images_u8)
    reset_launch_counts()
    t0 = time.perf_counter()
    got = fast_forward(model, x)["logits"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in launch_counts.items() if v}
    nfe = launches.get("vf_eval_tiled", 0)
    check(set(launches) == {"vf_eval_tiled"} and 7 <= nfe <= 385,
          f"dopri5: launches {launches}")
    t0 = time.perf_counter()
    want = fast_forward(model, x, plain=True)["logits"]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and err <= TOL_LOGITS
          and top1 >= MIN_TOP1_AGREEMENT,
          f"dopri5: logits rel err {err}, top-1 agreement {top1}")
    return {"batch": len(images_u8), "dtype": "float32", "nfe": nfe,
            "max_steps_hit": nfe >= 1 + 6 * 64, "rel_err": err,
            "tol": TOL_LOGITS, "top1_agreement": top1, "ms_host": ms,
            "plain_ms_host": plain_ms}


def phase_serve_224_kernel_timing(model, x):
    """The tiled Euler and stage-advance modes alone at B=64 on the
    euler-25 cell's first state (the patch-embedded images) against their
    plain versions."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import pad_tokens, vf_eval
    before = dict(launch_counts)
    b, d, dh = SERVE224_BATCH, 768, 768
    with torch.inference_mode():
        tokens = model.patch_embed(x)
        n_real = tokens.shape[1]
        tokens = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        w = model.vf.kernel_weights(torch.bfloat16)
        g = torch.Generator(device="cuda").manual_seed(10)
        base = (tokens.float() + torch.randn(tokens.shape, generator=g,
                                             device="cuda") * 1e-2).to(
            torch.bfloat16)
        kw = dict(num_heads=12, scaler=model.vf.scaler, n_real=n_real)
        jobs = {"vf_eval_euler_tiled": (dict(mode="euler", dt=1.0 / 24), 2),
                "vf_eval_base_tiled": (dict(mode="base", dt=1.0 / 18,
                                            base=base), 3)}
        out = {}
        for name, (extra, states) in jobs.items():
            got = vf_eval(tokens, w, **kw, **extra)
            want = vf_eval(tokens, w, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            err = rel_err(got[:, :n_real], want[:, :n_real])
            check(err <= TOL_BF16, f"B={b} {name}: rel err {err}")
            bound_ms, bound_by = vf_bound(b, n_real, d, dh, 2, states=states)
            out[name] = {
                "max_abs_err": (got[:, :n_real].float()
                                - want[:, :n_real].float()).abs().max()
                .item(), "rel_err": err,
                "ms": cuda_ms(lambda: vf_eval(tokens, w, **kw, **extra),
                              iters=10),
                "plain_ms": cuda_ms(lambda: vf_eval(tokens, w, plain=True,
                                                    **kw, **extra), iters=2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
        # the plain mode beside them, in the same call
        plain_mode_ms = cuda_ms(lambda: vf_eval(tokens, w, **kw), iters=10)
    launch_counts.update(before)           # comparisons do not count
    emit("serve_224_kernel_timing", shape=f"B={b} n={n_real}/208 D=768 "
         f"H=12 dh=768 bf16", plain_mode_ms=plain_mode_ms, results=out)
    return out


def phase_chain_vs_per_step(model, x, student, x224):
    """``ODEVIT_EULER_CHAIN`` at the CIFAR shape (euler-49, B=1024): chains
    of 4 and 12 steps per launch against the per-step route, logits bit
    for bit, launches counted, each timed beside the per-step route in this
    call (per-step, chains, per-step); the chained kernel alone against
    per-step launches (bit for bit) and its plain version, in bf16 at
    B=1024 and in f32 at B=64; at TS-Base a chain of 4 on euler-25 runs the
    tiled Euler mode once per step, with the per-step route's logits."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_euler_chain)
    from odevit_tpu_torch.models.fast_forward import fast_forward
    saved = os.environ.pop("ODEVIT_EULER_CHAIN", None)
    report, chain_launches = {}, None
    try:
        per_step = fast_forward(model, x)["logits"]
        per_ms = [cuda_ms(lambda: fast_forward(model, x), iters=5)]
        for chain in CHAINS:
            os.environ["ODEVIT_EULER_CHAIN"] = str(chain)
            reset_launch_counts()
            got = fast_forward(model, x)["logits"]
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts.items() if v}
            check(launches == {"vf_euler_chain": 48 // chain},
                  f"chain {chain}: launches {launches}")
            same = bool(torch.equal(got, per_step))
            check(same, f"chain {chain}: logits differ from per-step")
            ms = cuda_ms(lambda: fast_forward(model, x), iters=5)
            report[f"chain_{chain}"] = {
                "launches": launches, "logits_bit_identical": same,
                "ms_per_forward": ms, "img_per_s": BATCH / ms * 1e3}
            if chain == CHAINS[0]:
                chain_launches = launches["vf_euler_chain"]
        del os.environ["ODEVIT_EULER_CHAIN"]
        per_ms.append(cuda_ms(lambda: fast_forward(model, x), iters=5))
        report["per_step"] = {"ms_per_forward": per_ms,
                              "img_per_s": BATCH / min(per_ms) * 1e3}
        # TS-Base: the chain runs the tiled Euler mode once per step
        want224 = fast_forward(student, x224)["logits"]
        os.environ["ODEVIT_EULER_CHAIN"] = str(CHAINS[0])
        reset_launch_counts()
        got224 = fast_forward(student, x224)["logits"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts.items() if v}
        del os.environ["ODEVIT_EULER_CHAIN"]
        same = bool(torch.equal(got224, want224))
        report["tsbase_euler25_chain_4"] = {"launches": launches,
                                            "logits_bit_identical": same}
        check(launches == {"vf_eval_euler_tiled": 24},
              f"TS-Base chain: launches {launches}")
        check(same, "TS-Base chain: logits differ from per-step")
    finally:
        os.environ.pop("ODEVIT_EULER_CHAIN", None)
        if saved is not None:
            os.environ["ODEVIT_EULER_CHAIN"] = saved
    # the kernel alone: one chain of 4 against 4 per-step launches and the
    # plain chain, bf16 at the main path's first state, f32 at B=64
    before = dict(launch_counts)
    chain, dt = CHAINS[0], 1.0 / 48
    with torch.inference_mode():
        tokens = model.patch_embed(x)
        n_real = tokens.shape[1]
        tokens = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        kw = dict(num_heads=3, scaler=model.vf.scaler, n_real=n_real, dt=dt)
        alone = {}
        for dtype, tol, b in ((torch.bfloat16, TOL_BF16, BATCH),
                              (torch.float32, TOL_F32, 64)):
            xs = tokens[:b].to(dtype).contiguous()
            w = model.vf.kernel_weights(dtype)
            got = vf_euler_chain(xs, w, chain=chain, **kw)
            step = xs
            for _ in range(chain):
                step = vf_eval(step, w, mode="euler", **kw)
            want = vf_euler_chain(xs, w, chain=chain, plain=True, **kw)
            torch.cuda.synchronize()
            same = bool(torch.equal(got[:, :n_real], step[:, :n_real]))
            err = rel_err(got[:, :n_real], want[:, :n_real])
            alone[str(dtype)] = {"batch": b, "per_step_bit_identical": same,
                                 "rel_err_vs_plain": err, "tol": tol}
            check(same, f"chain kernel {dtype}: differs from per-step")
            check(err <= tol, f"chain kernel {dtype}: rel err {err}")
            if dtype == torch.bfloat16:
                timing = {
                    "max_abs_err": (got[:, :n_real].float()
                                    - want[:, :n_real].float()).abs().max()
                    .item(),
                    "ms": cuda_ms(lambda: vf_euler_chain(
                        xs, w, chain=chain, **kw), iters=10),
                    "plain_ms": cuda_ms(lambda: vf_euler_chain(
                        xs, w, chain=chain, plain=True, **kw), iters=2),
                    "per_step_ms": cuda_ms(lambda: [
                        vf_eval(xs, w, mode="euler", **kw)
                        for _ in range(chain)], iters=10),
                    **dict(zip(("bound_ms", "bound_by"), vf_bound(
                        BATCH, n_real, 192, 768, 2, evals=chain))),
                    "library_ms": None}
    launch_counts.update(before)           # comparisons do not count
    emit("chain_vs_per_step", chains=CHAINS, results=report,
         kernel_alone=alone, kernel_timing={"chain": chain, **timing})
    return chain_launches, timing


def phase_serving_224(model, rng, counter="vf_eval_euler_tiled", evals=24,
                      name="serving_224", dtype="bfloat16", image_size=224):
    """A ServingEngine over the euler-25 student (or another model of
    ``image_size`` px, whose forward launches ``evals`` of ``counter``),
    buckets (1, 8, 64), its preprocess ``make_preprocess(image_size)``
    (the engine takes the model's size, as JAX's does, so the resize is
    the identity), answers 16 uint8 requests of 1-20 images from 4
    threads; each answer is held against a direct ``fast_forward``; the
    mean latency and the B=1 forward time. ``dtype``: the preprocess's
    output dtype."""
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    from odevit_tpu_torch.serve.engine import ServingEngine
    pre = make_preprocess(image_size=image_size, dtype=getattr(torch, dtype))
    sizes = [int(s) for s in rng.integers(1, 21, 16)]
    requests = [rng.integers(0, 256, (s, image_size, image_size, 3),
                             dtype=np.uint8) for s in sizes]
    answers = [None] * len(requests)
    with ServingEngine(model, batch_buckets=(1, 8, 64), preprocess=pre,
                       max_delay_ms=2.0, device="cuda") as engine:
        reset_launch_counts()

        def client(k):
            futs = [(i, engine.submit(requests[i]))
                    for i in range(k, len(requests), 4)]
            for i, fut in futs:
                answers[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), f"{name} hung")
        launches = {k: v for k, v in launch_counts.items() if v}
        stats = engine.stats()
    check(launches == {counter: evals * stats["runs"]},
          f"{name}: {launches} for {stats['runs']} runs")
    worst, identical = 0.0, 0
    for req, got in zip(requests, answers):
        check(got is not None and got.shape == (len(req), 100),
              f"{name}: missing or misshapen answer")
        x = pre(torch.from_numpy(req).cuda())
        want = fast_forward(model, x)["logits"].cpu().numpy()
        identical += int(np.array_equal(got, want))
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    x1 = pre(torch.from_numpy(requests[0][:1]).cuda())
    b1_ms = cuda_ms(lambda: fast_forward(model, x1), iters=10)
    emit(name, requests=len(requests), sizes=sizes,
         buckets=(1, 8, 64), identical_answers=identical, worst_rel_err=worst,
         tol=TOL_LOGITS, launches=launches, stats=stats,
         b1_ms_per_forward=b1_ms, b1_ms_per_eval=b1_ms / evals)
    check(worst <= TOL_LOGITS, f"{name} answers differ: {worst}")
    return launches


# --- L2 attention: the L2+bias instances of the one-CTA kernels --------

L2_CELL = "cifar100-vitode-l2-train-b1024-bf16"
L2_NAMES = BWD_NAMES + ("qkv_bias", "out_bias")
L2_BIAS_SCALE = 0.1


def l2_model(solver="rk4", steps=13, dtype="bfloat16", seed=0,
             tsbase=False):
    """The CIFAR ViTODE with L2 attention (``model.l2_attention``, JAX's
    ``l2_b1024``), or with ``tsbase`` the TS-Base student of
    ``evidence_free_base.yaml`` with it (Euler on 36 points unless
    ``solver``/``steps`` say otherwise), its four attention biases drawn
    nonzero from ``seed`` (normal, 0.1), so that the bias paths carry
    data."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    kw = dict(num_eval_steps=steps, solver=solver,
              dtype=getattr(torch, dtype) if dtype else None,
              l2_attention=True, device="cuda", seed=seed)
    model = (ViTODE.base_224(num_classes=100, **kw) if tsbase
             else ViTODE(**SHAPE, **kw))
    g = torch.Generator().manual_seed(seed + 1)
    a = model.vf.attn
    with torch.no_grad():
        for lin in (a.q, a.k, a.v, a.out):
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g)
                           * L2_BIAS_SCALE)
    return model


def l2_plans_agree():
    """The Python plans that route L2 on either device (``l2_plan``,
    ``l2_bwd_plan``) against the CUDA sources' ``vf_plan``/``vfb_plan``
    over a sweep of shapes: the same plan, or none on both sides. On the
    same sweep, the Python copies of the other instances' route plans
    (``cta_plan``, ``cta_bwd_plan``: deterministic and dropout) and of
    the f32 kernels' layouts (``f32_plan``, ``f32_bwd_plan``: each
    instance) against ``vf_plan``/``vfb_plan`` and ``vf_plan_f32``/
    ``vfb_plan_f32``, and of the bf16 backward's layout
    (``bf16_bwd_plan``: each instance) against ``vfb_plan_bf16``."""
    import torch
    from odevit_tpu_torch.kernels.vector_field import (cta_plan, f32_plan,
                                                       kernel_plan,
                                                       kernel_plan_f32,
                                                       l2_plan)
    from odevit_tpu_torch.kernels.vector_field_bwd import (
        bf16_bwd_plan, bwd_plan, cta_bwd_plan, f32_bwd_plan,
        kernel_bwd_plan_bf16, kernel_bwd_plan_f32, l2_bwd_plan)

    def c_plan(fn, *args, l2=True, **kw):
        try:
            return tuple(fn(*args, l2=l2, **kw))
        except ValueError:
            return None

    def other_plans_agree(dtype, *shape):
        for drop in (False, True):
            for py, c in ((cta_plan, kernel_plan), (cta_bwd_plan, bwd_plan)):
                got = py(dtype, *shape, drop=drop)
                want = c_plan(c, dtype, *shape, drop, l2=False)
                check(got == want, f"{py.__name__} {dtype} {shape} "
                      f"drop={drop}: python {got}, CUDA {want}")
        if dtype == torch.bfloat16:
            for drop, l2 in ((False, False), (True, False), (False, True)):
                got = bf16_bwd_plan(*shape, drop=drop, l2=l2)
                want = c_plan(kernel_bwd_plan_bf16, *shape, drop=drop, l2=l2)
                check(got == want, f"bf16_bwd_plan {shape} drop={drop} "
                      f"l2={l2}: python {got}, CUDA {want}")
            return
        for drop, l2 in ((False, False), (True, False), (False, True)):
            for py, c in ((f32_plan, kernel_plan_f32),
                          (f32_bwd_plan, kernel_bwd_plan_f32)):
                got = py(*shape, drop=drop, l2=l2)
                want = c_plan(c, *shape, drop=drop, l2=l2)
                check(got == want, f"{py.__name__} {shape} drop={drop} "
                      f"l2={l2}: python {got}, CUDA {want}")
    shapes = 0
    for dtype in (torch.bfloat16, torch.float32):
        for n_pad in (16, 32, 64, 80, 96, 112, 128, 144):
            for d, heads in ((64, 2), (64, 4), (128, 2), (192, 3), (256, 4),
                             (384, 6)):
                for dh in (d, 2 * d, 4 * d):
                    args = (dtype, n_pad, n_pad - 3, d, heads, dh)
                    want_f = c_plan(kernel_plan, *args[:6], False)
                    want_b = c_plan(bwd_plan, *args[:6], False)
                    got_f, got_b = l2_plan(*args), l2_bwd_plan(*args)
                    check(got_f == want_f, f"L2 plan {args}: python {got_f}, "
                          f"vf_plan {want_f}")
                    check(got_b == want_b, f"L2 bwd plan {args}: python "
                          f"{got_b}, vfb_plan {want_b}")
                    other_plans_agree(*args)
                    shapes += 1
    return shapes


def phase_l2_kernels_vs_plain(tsbase=False):
    """Both L2 forward instances and the L2 backward (with and without the
    JaSMin cotangent) against their plain versions at B=4, the CIFAR shape
    (with ``tsbase`` the TS-Base shape, 207/208 tokens, D=768: the tiled
    route's L2 instances), random nonzero biases, in bf16 and f32; repeated
    backwards bit-identical; NaN and garbage in the padded rows inert; a
    "far" case (q/k weights x8) where whole rows underflow to p = 0 and the
    output stays finite and equal to the plain version's; each call lands
    on its L2 counter; the Python plans agree with the CUDA sources'."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (vf_eval,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    before = dict(launch_counts)
    model = l2_model(tsbase=tsbase)
    b, n_real, n_pad, d, heads = ((4, 207, 208, 768, 12) if tsbase
                                  else (4, 69, 80, 192, 3))
    jas_k = TSL2_K if tsbase else JASMIN_K
    sfx = "_tiled" if tsbase else ""
    kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
    g = torch.Generator(device="cuda").manual_seed(11)

    def routed(fn, want):
        counts = dict(launch_counts)
        out = fn()
        torch.cuda.synchronize()
        got = {k: launch_counts[k] - counts[k] for k in counts
               if launch_counts[k] != counts[k]}
        check(got == {want: 1}, f"L2 launched {got}, want {want}")
        return out

    results = []
    tally = F32Tally()
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        tally.start(dtype)
        for kind in ("random", "far"):
            w = model.vf.kernel_weights(dtype)
            if kind == "far":
                # q and k weights x8: distances of hundreds, so nearly
                # every row's exponentials all underflow (p = 0)
                wqkv = w.wqkv.float().clone()
                wqkv[:, :2 * d] *= 8.0
                w = w._replace(wqkv=wqkv.to(dtype).contiguous())
            x = torch.randn(b, n_pad, d, generator=g, device="cuda")
            x[:, n_real:] = 0
            x = x.to(dtype)
            gx = torch.randn(b, n_pad, d, generator=g, device="cuda") * 1e-2
            gx[:, n_real:] = 0
            gx = gx.to(dtype)
            gj = torch.randn(b, heads, 5, n_pad, generator=g,
                             device="cuda") * 1e-2
            gj[..., n_real:] = 0
            r = {"dtype": str(dtype), "case": kind, "tol": tol,
                 "shape": f"B={b} n={n_real}/{n_pad} D={d} H={heads} "
                          f"dh={model.vf.mlp.fc1.weight.shape[0]}"}
            f = routed(lambda: vf_eval(x, w, **kw), "vf_eval_l2" + sfx)
            pf = vf_eval(x, w, plain=True, **kw)
            dx, st, idx = routed(lambda: vf_eval_jasmin(x, w, jas_k=jas_k,
                                                        **kw),
                                 "vf_eval_jasmin_l2" + sfx)
            pdx, pst, pidx = vf_eval_jasmin(x, w, jas_k=jas_k, plain=True,
                                            **kw)
            torch.cuda.synchronize()
            r["fwd"] = rel_err(f[:, :n_real], pf[:, :n_real])
            r["jasmin_fwd"] = {
                "dx": rel_err(dx[:, :n_real], pdx[:, :n_real]),
                "stats": rel_err(st[..., :n_real], pst[..., :n_real]),
                "idx_agreement": (idx[..., :n_real] == pidx[..., :n_real])
                .float().mean().item()}
            r["rows_p_zero"] = int((st[:, :, 0, :n_real] == 0).sum())
            r["finite"] = bool(torch.isfinite(f[:, :n_real]).all()
                               and torch.isfinite(dx[:, :n_real]).all())
            check(r["finite"], f"L2 {dtype} {kind}: non-finite output")
            check(max(r["fwd"], r["jasmin_fwd"]["dx"],
                      r["jasmin_fwd"]["stats"]) <= tol,
                  f"L2 fwd {dtype} {kind}: {r}")
            if kind == "far":
                check(r["rows_p_zero"] > 0, f"L2 far {dtype}: no row "
                      f"underflowed")
            for jas in (False, True):
                extra = dict(g_jas=gj, jas_idx=idx) if jas else {}
                got = routed(lambda: vf_bwd(x, w, gx, **kw, **extra),
                             "vf_bwd_l2" + sfx)
                want = vf_bwd(x, w, gx, plain=True, **kw, **extra)
                again = vf_bwd(x, w, gx, **kw, **extra)
                torch.cuda.synchronize()
                check(len(got) == 11, f"L2 bwd gave {len(got)} cotangents")
                errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                    b_[:, :n_real] if nm == "x" else b_)
                        for nm, a, b_ in zip(L2_NAMES, got, want)}
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                fin = all(bool(torch.isfinite(a).all()) for a in got)
                r["bwd_jas" if jas else "bwd"] = errs
                r["repeat_bit_identical" + ("_jas" if jas else "")] = same
                check(fin, f"L2 bwd {dtype} {kind} jas={jas}: non-finite")
                check(max(errs.values()) <= tol,
                      f"L2 bwd {dtype} {kind} jas={jas}: {errs}")
                check(same, f"L2 bwd {dtype} {kind} jas={jas} not "
                      f"repeatable")
            if kind == "random":
                dirty = x.clone()
                dirty[:, n_real:n_real + 5] = float("nan")
                dirty[:, n_real + 5:] = 1e30
                gdirty = gx.clone()
                gdirty[:, n_real:] = 7.0
                ddx, dst, didx = vf_eval_jasmin(dirty, w, jas_k=jas_k,
                                                **kw)
                df = vf_eval(dirty, w, **kw)
                dbars = vf_bwd(dirty, w, gdirty, g_jas=gj, jas_idx=idx, **kw)
                cbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, **kw)
                torch.cuda.synchronize()
                same = (torch.equal(ddx[:, :n_real], dx[:, :n_real])
                        and torch.equal(df[:, :n_real], f[:, :n_real])
                        and torch.equal(dst, st) and torch.equal(didx, idx)
                        and all(torch.equal(a, c)
                                for a, c in zip(dbars, cbars)))
                r["nan_padding_unchanged"] = same
                check(same, f"L2 {dtype}: padded rows reached a real row")
            results.append(r)
        tally.stop(dtype)
    results.append(tally.check("l2_kernels_vs_plain"))
    shapes = tiled_plans_agree() if tsbase else l2_plans_agree()
    launch_counts.update(before)           # comparisons do not count
    emit("l2_tiled_kernels_vs_plain" if tsbase else "l2_kernels_vs_plain",
         bias_scale=L2_BIAS_SCALE, plans_agree_over_shapes=shapes,
         results=results)


def phase_l2_serving(images_u8, softmax_report, rng):
    """The L2 model served through ``fast_forward`` at B=1024, rk4 on 13
    points, on the generic route (48 plain L2 launches), against the plain
    path, beside the softmax rk4-13 figure of this run; the engine over it;
    one dopri5 forward in f32 at B=8."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    model = l2_model()
    x = make_preprocess(dtype=torch.bfloat16)(images_u8)
    reset_launch_counts()
    got = fast_forward(model, x)["logits"]
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    check(launches == {"vf_eval_l2": 48}, f"L2 rk4-13: launches {launches}")
    want = fast_forward(model, x, plain=True)["logits"]
    torch.cuda.synchronize()
    err = rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (BATCH, 100),
          f"L2 rk4-13: logits {got.shape}")
    check(err <= TOL_LOGITS, f"L2 rk4-13: logits rel err {err}")
    check(top1 >= MIN_TOP1_AGREEMENT, f"L2 rk4-13: top-1 agreement {top1}")
    ms = cuda_ms(lambda: fast_forward(model, x), iters=5)
    plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True), iters=2)
    engine = phase_serving(model, rng, counter="vf_eval_l2",
                           name="l2_serving_engine")
    # dopri5 in f32 at B=8 (in bf16 the error estimate sits at the state's
    # rounding, see dopri5_check)
    d5 = l2_model(solver="dopri5", dtype=None)
    x8 = make_preprocess()(images_u8[:8])
    reset_launch_counts()
    got5 = fast_forward(d5, x8)["logits"]
    torch.cuda.synchronize()
    l5 = {k: v for k, v in launch_counts.items() if v}
    nfe = l5.get("vf_eval_l2", 0)
    check(set(l5) == {"vf_eval_l2"} and 7 <= nfe <= 385,
          f"L2 dopri5: launches {l5}")
    want5 = fast_forward(d5, x8, plain=True)["logits"]
    err5 = rel_err(got5, want5)
    check(bool(torch.isfinite(got5).all()) and err5 <= TOL_LOGITS,
          f"L2 dopri5: logits rel err {err5}")
    emit("l2_serving", solver="rk4-13", batch=BATCH, launches=launches,
         rel_err=err, tol=TOL_LOGITS, top1_agreement=top1,
         ms_per_forward=ms, img_per_s=BATCH / ms * 1e3,
         plain_img_per_s=BATCH / plain_ms * 1e3,
         softmax_rk4_13_img_per_s=softmax_report["rk4-13"]["img_per_s"],
         engine_launches=engine,
         dopri5={"batch": 8, "dtype": "float32", "nfe": nfe,
                 "rel_err": err5})
    return launches


def phase_l2_train(images_u8, labels, det):
    """Cell cifar100-vitode-l2-train-b1024-bf16 (JAX's ``l2_b1024``): the
    free step of the L2 model, through its L2 instances and through the
    plain path from the same weights; beside the softmax step's img/s of
    this run (``det``)."""
    runs, profile, cos, loss_rel, per_step = train_runs(images_u8, labels,
                                                        l2=True)
    k, p = runs["kernels"], runs["plain"]
    emit("l2_train_profile", **profile)
    emit("l2_train", cell=L2_CELL, batch=BATCH, steps=TRAIN_STEPS,
         solver="rk4-13", jasmin_k=JASMIN_K,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         softmax_img_per_s=det["kernels"]["img_per_s_best_of_2_3"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train("l2_train", runs, cos, loss_rel, per_step,
                {"vf_eval_l2": 36, "vf_eval_jasmin_l2": 12, "vf_bwd_l2": 48},
                rows_bf16=ROWS_BF16_CIFAR)
    return k["launches"]


def phase_l2_kernel_timing(images_u8, tsbase=False):
    """Each L2 instance alone on the main path's inputs (the first state of
    one image batch: B=1024 at the CIFAR shape, or with ``tsbase`` B=64 at
    the TS-Base shape, the tiled route's instances) against its plain
    version, with its bound: the softmax instance's (the norms' extra work
    is under 1 %). With ``tsbase`` the f32 instances are held against
    their plain versions on the same state too (TOL_F32)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    before = dict(launch_counts)
    model = l2_model(tsbase=tsbase)
    d, dh, heads = (768, 768, 12) if tsbase else (192, 768, 3)
    jas_k = TSL2_K if tsbase else JASMIN_K
    sfx = "_tiled" if tsbase else ""
    pre = make_preprocess(image_size=224 if tsbase else None,
                          dtype=torch.bfloat16)
    b = images_u8.shape[0]
    out, f32_errs = {}, {}
    with torch.no_grad():
        tokens = model.patch_embed(pre(images_u8))
        n_real = tokens.shape[1]
        state = torch.nn.functional.pad(
            tokens, (0, 0, 0, pad_tokens(n_real) - n_real)).contiguous()
        g = torch.Generator(device="cuda").manual_seed(12)
        gx32 = torch.randn(state.shape, generator=g, device="cuda") * 1e-3
        for dtype in ((torch.bfloat16, torch.float32) if tsbase
                      else (torch.bfloat16,)):
            x, gx = state.to(dtype), gx32.to(dtype)
            w = model.vf.kernel_weights(dtype)
            kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
            f = vf_eval(x, w, **kw)
            pf = vf_eval(x, w, plain=True, **kw)
            dx, st, idx = vf_eval_jasmin(x, w, jas_k=jas_k, **kw)
            pdx, pst, _ = vf_eval_jasmin(x, w, jas_k=jas_k, plain=True, **kw)
            gj = torch.randn(st.shape, generator=g, device="cuda") * 1e-3
            gj[..., n_real:] = 0
            bars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, **kw)
            pbars = vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, plain=True, **kw)
            torch.cuda.synchronize()
            ferr = rel_err(f[:, :n_real], pf[:, :n_real])
            errs = [rel_err(a[:, :n_real], b_[:, :n_real])
                    for a, b_ in zip((dx, st), (pdx, pst))]
            berrs = [rel_err(a[:, :n_real] if i == 0 else a,
                             b_[:, :n_real] if i == 0 else b_)
                     for i, (a, b_) in enumerate(zip(bars, pbars))]
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
            check(max([ferr] + errs) <= tol,
                  f"B={b} L2 fwd {dtype}: {ferr} {errs}")
            check(max(berrs) <= tol, f"B={b} L2 bwd {dtype}: {berrs}")
            if dtype == torch.float32:
                f32_errs = {"fwd": ferr, "jasmin": errs,
                            "bwd": dict(zip(L2_NAMES, berrs))}
                continue
            amax = lambda a, b_: (a[:, :n_real].float()
                                  - b_[:, :n_real].float()).abs().max().item()
            out = {
                "vf_eval_l2" + sfx: {
                    "max_abs_err": amax(f, pf), "rel_err": ferr,
                    "ms": cuda_ms(lambda: vf_eval(x, w, **kw), iters=10),
                    "plain_ms": cuda_ms(lambda: vf_eval(x, w, plain=True,
                                                        **kw), iters=2),
                    **dict(zip(("bound_ms", "bound_by"),
                               vf_bound(b, n_real, d, dh, 2)))},
                "vf_eval_jasmin_l2" + sfx: {
                    "max_abs_err": amax(dx, pdx), "rel_errs": errs,
                    "ms": cuda_ms(lambda: vf_eval_jasmin(
                        x, w, jas_k=jas_k, **kw), iters=10),
                    "plain_ms": cuda_ms(lambda: vf_eval_jasmin(
                        x, w, jas_k=jas_k, plain=True, **kw), iters=2),
                    **dict(zip(("bound_ms", "bound_by"), jasmin_bound(
                        b, n_real, d, dh, heads, 2, jas_k + 1)))},
                "vf_bwd_l2" + sfx: {
                    "max_abs_err": max(
                        (a.float() - b_.float()).abs().max().item()
                        for a, b_ in zip(bars[1:], pbars[1:])),
                    "max_abs_err_x": amax(bars[0], pbars[0]),
                    "rel_errs": dict(zip(L2_NAMES, berrs)),
                    "ms": cuda_ms(lambda: vf_bwd(
                        x, w, gx, g_jas=gj, jas_idx=idx, **kw), iters=10),
                    "plain_ms": cuda_ms(lambda: vf_bwd(
                        x, w, gx, g_jas=gj, jas_idx=idx, plain=True, **kw),
                        iters=2),
                    **dict(zip(("bound_ms", "bound_by"), bwd_bound(
                        b, n_real, d, dh, heads, 2)))}}
            if not tsbase:
                out["vf_bwd_l2"][ROWS_BF16] = rows_bf16_report(
                    x, w, gx, kw, dict(g_jas=gj, jas_idx=idx))
    launch_counts.update(before)           # comparisons do not count
    emit("tsbase_l2_kernel_timing" if tsbase else "l2_kernel_timing",
         shape=f"B={b} n={n_real}/{state.shape[1]} D={d} H={heads} "
         f"dh={dh} bf16", f32_rel_errs=f32_errs or None, results=out)
    return out


# ---- the Macaron family at the CIFAR shape (JAX's macaron_b1024) ----

MACARON_SHAPE = dict(img_size=32, patch_size=4, embed_dim=192, num_heads=3,
                     mlp_ratio=4.0, num_classes=100, emulate_depth=12.0,
                     time_interval=12.0, num_eval_steps=13, solver="rk4")
MACARON_TRAIN_CELL = "cifar100-macaron-train-b1024"
MACARON_SERVE_CELL = "cifar100-macaron-serve-rk4-13-b1024"


def macaron_model(solver="rk4", steps=13, seed=0):
    """``benchmarks/train_speed.py::bench_macaron``'s model: dtype bf16 with
    float32 parameters, so its tokens and states are float32."""
    import torch
    from odevit_tpu_torch.models.macaron import ViTMacaron
    return ViTMacaron(**{**MACARON_SHAPE, "solver": solver,
                         "num_eval_steps": steps}, dtype=torch.bfloat16,
                      device="cuda", seed=seed)


def macaron_flops(b: int, n_real: int, d: int, dh: int,
                  backward: bool = False) -> float:
    """Operations of one Macaron evaluation (``backward``: its backward,
    3x) at the real token count."""
    flops = b * (n_real * (8 * d * dh + 8 * d * d) + 4 * n_real * n_real * d)
    return 3 * flops if backward else flops


def tf32_floor_ms(flops: float) -> float:
    """The f32 kernels' own floor: their products as split TF32 take three
    TF32 passes each, over the TF32 tensor peak."""
    return 3 * flops / PEAK_TF32_FLOPS * 1e3


def macaron_bound(b: int, n_real: int, d: int, dh: int, itemsize: int,
                  backward: bool = False):
    """(bound_ms, bound_by) of one Macaron evaluation (``backward``: its
    backward): two FFN halves, the q|k|v and output projections and the
    attention at the real token count (99.1 MFLOP per image at 65 tokens,
    ``analysis/flops.py::macaron_fwd_flops``); the backward recomputes them
    and does two products for each, 3x. Over the bf16 tensor peak for the
    bf16 instance and, for the float32 one, split TF32's floor
    (``tf32_floor_ms``: three TF32 passes on the tensor cores, which take
    float32 work faster than the float32 peak outside them), against the
    state in and out (and g, x_bar), the weights and, for the backward,
    their float32 cotangents over the memory rate."""
    flops = macaron_flops(b, n_real, d, dh, backward)
    weights = 4 * d * d + 2 * d * dh
    states = 3 if backward else 2
    nbytes = (states * b * n_real * d + weights) * itemsize + 12 * d * 4
    if backward:
        nbytes += (weights + 11 * d + dh + 1) * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3 if itemsize == 2 \
        else tf32_floor_ms(flops)
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def macaron_plans_agree():
    """The Python plans that route Macaron on either device
    (``macaron_plan``, ``macaron_bwd_plan``) against the CUDA sources'
    ``mac_plan``/``mcb_plan`` over a sweep of shapes, and the f32
    forward's own layout (``macaron_plan_f32``) against ``mac_plan_f32``;
    the one-CTA backward has a plan at 114 of them in bf16 and 93 in f32,
    the forward at 102 and 96, each of the 96 with an f32 plan."""
    import torch
    from odevit_tpu_torch.kernels.macaron import (kernel_plan,
                                                  kernel_plan_f32,
                                                  macaron_plan,
                                                  macaron_plan_f32)
    from odevit_tpu_torch.kernels.macaron_bwd import (kernel_bwd_plan,
                                                      macaron_bwd_plan)
    shapes = 0
    cta_bwd = {torch.bfloat16: 0, torch.float32: 0}
    cta_fwd = {torch.bfloat16: 0, torch.float32: 0}
    for dtype in (torch.bfloat16, torch.float32):
        for n_pad in (16, 32, 64, 80, 96, 128, 144):
            for d, heads in ((32, 2), (64, 2), (128, 2), (192, 3), (256, 4),
                             (384, 6), (192, 12)):
                for dh in (d, 2 * d, 4 * d):
                    args = (dtype, n_pad, n_pad - 3, d, heads, dh)
                    check(macaron_plan(*args) == kernel_plan(*args),
                          f"Macaron plan {args}: python "
                          f"{macaron_plan(*args)}, mac_plan "
                          f"{kernel_plan(*args)}")
                    check(macaron_bwd_plan(*args) == kernel_bwd_plan(*args),
                          f"Macaron bwd plan {args}: python "
                          f"{macaron_bwd_plan(*args)}, mcb_plan "
                          f"{kernel_bwd_plan(*args)}")
                    cta_bwd[dtype] += macaron_bwd_plan(*args) is not None
                    cta_fwd[dtype] += macaron_plan(*args) is not None
                    if dtype == torch.float32:
                        plan = macaron_plan_f32(*args[1:])
                        check(plan == kernel_plan_f32(*args[1:]),
                              f"Macaron f32 plan {args}: python {plan}, "
                              f"mac_plan_f32 {kernel_plan_f32(*args[1:])}")
                        check(macaron_plan(*args) is None
                              or plan is not None,
                              f"one-CTA f32 Macaron shape {args} has no "
                              f"f32 plan")
                    shapes += 1
    # the one-CTA shapes: as many as before the f32 redesigns
    check(cta_bwd == {torch.bfloat16: 114, torch.float32: 93},
          f"one-CTA Macaron backward plans: {cta_bwd}")
    check(cta_fwd == {torch.bfloat16: 102, torch.float32: 96},
          f"one-CTA Macaron forward plans: {cta_fwd}")
    return shapes


def macaron_vs_plain(name, model, b, n_real, n_pad, counters, plans):
    """``macaron_eval`` (plain, euler, base) and ``macaron_bwd`` (16
    cotangents) of ``model``'s field against their plain versions at B=b,
    n_real tokens padded to n_pad, in bf16 and f32, with every parameter
    perturbed by normal(0, 0.1) (the FFN's 1e-3 init would compare
    near-zeros); each launch counted once as ``counters`` (the forward's,
    the backward's) say; repeats bit-identical; NaN and garbage in the
    padded rows inert; ``plans()`` holds the Python plans against the
    CUDA ones and returns the number of shapes. Returns the launches it
    made, by counter. In f32, the card's NaN in a real row reaches the
    outputs it reaches in the plain version, and ``mac_kernel_f32``'s C
    counter moves once per one-CTA evaluation (not at all on the tiled
    route)."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.macaron import f32_launches, macaron_eval
    from odevit_tpu_torch.kernels.macaron_bwd import BAR_NAMES, macaron_bwd
    before = dict(launch_counts)
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for p in model.vf.parameters():
            p.add_(torch.randn(p.shape, generator=gen).cuda() * 0.1)
    d, heads = model.embed_dim, model.num_heads
    dh = model.vf.kernel_weights(torch.float32).w1.shape[1]
    kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
    g = torch.Generator(device="cuda").manual_seed(22)

    def routed(fn, want):
        counts = dict(launch_counts)
        out = fn()
        torch.cuda.synchronize()
        got = {k: launch_counts[k] - counts[k] for k in counts
               if launch_counts[k] != counts[k]}
        check(got == {want: 1}, f"Macaron launched {got}, want {want}")
        return out

    results = []
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        w = model.vf.kernel_weights(dtype)
        x = torch.randn(b, n_pad, d, generator=g, device="cuda")
        x[:, n_real:] = 0
        x = x.to(dtype)
        base = torch.randn(b, n_pad, d, generator=g, device="cuda").to(dtype)
        gx = torch.randn(b, n_pad, d, generator=g, device="cuda")
        gx[:, n_real:] = 0
        gx = gx.to(dtype)
        r = {"dtype": str(dtype), "tol": tol,
             "shape": f"B={b} n={n_real}/{n_pad} D={d} H={heads} dh={dh}"}
        at = (f32_launches(), launch_counts["macaron_eval"])
        modes = {"plain": {}, "euler": dict(dt=0.25),
                 "base": dict(dt=0.25, base=base)}
        for mode, extra in modes.items():
            got = routed(lambda: macaron_eval(x, w, mode=mode, **kw, **extra),
                         counters[0])
            want = macaron_eval(x, w, mode=mode, plain=True, **kw, **extra)
            again = macaron_eval(x, w, mode=mode, **kw, **extra)
            torch.cuda.synchronize()
            r[mode] = rel_err(got[:, :n_real], want[:, :n_real])
            check(bool(torch.isfinite(got[:, :n_real]).all()),
                  f"Macaron {dtype} {mode}: non-finite output")
            check(r[mode] <= tol, f"Macaron fwd {dtype} {mode}: {r[mode]}")
            check(torch.equal(got, again), f"Macaron fwd {dtype} {mode} "
                  f"not repeatable")
        got = routed(lambda: macaron_bwd(x, w, gx, **kw), counters[1])
        want = macaron_bwd(x, w, gx, plain=True, **kw)
        again = macaron_bwd(x, w, gx, **kw)
        torch.cuda.synchronize()
        check(len(got) == 16 and got[-1].shape == (1,),
              f"Macaron bwd gave {len(got)} cotangents")
        errs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                            c[:, :n_real] if nm == "x" else c)
                for nm, a, c in zip(BAR_NAMES, got, want)}
        r["bwd"] = errs
        r["bwd_repeat_bit_identical"] = all(
            torch.equal(a, c) for a, c in zip(got, again))
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"Macaron bwd {dtype}: non-finite cotangent")
        check(max(errs.values()) <= tol, f"Macaron bwd {dtype}: {errs}")
        check(r["bwd_repeat_bit_identical"], f"Macaron bwd {dtype} not "
              f"repeatable")
        dirty = x.clone()
        dirty[:, n_real:n_real + 5] = float("nan")
        dirty[:, n_real + 5:] = 1e30 if dtype == torch.float32 else 3e38
        gdirty = gx.clone()
        gdirty[:, n_real:] = 7.0
        same = all(torch.equal(macaron_eval(dirty, w, mode=m, **kw, **e)
                               [:, :n_real],
                               macaron_eval(x, w, mode=m, **kw, **e)
                               [:, :n_real]) for m, e in modes.items())
        same = same and all(torch.equal(a, c) for a, c in zip(
            macaron_bwd(dirty, w, gdirty, **kw), got))
        r["nan_padding_unchanged"] = same
        check(same, f"Macaron {dtype}: padded rows reached a real row")
        if dtype == torch.float32:
            # the NaN the card makes (0x7FFFFFFF) in one real row reaches
            # the outputs it reaches in the plain version: the split-TF32
            # products let it through
            sick = x.clone()
            sick.view(torch.int32)[0, 1] = 0x7FFFFFFF
            real = lambda nm, t: t[:, :n_real] if nm == "x" else t
            pairs = [(real("x", macaron_eval(sick, w, **kw)),
                      real("x", macaron_eval(sick, w, plain=True, **kw)))]
            pairs += [(real(nm, a), real(nm, c)) for nm, a, c in zip(
                BAR_NAMES, macaron_bwd(sick, w, gx, **kw),
                macaron_bwd(sick, w, gx, plain=True, **kw))]
            r["nan_real_row_as_plain"] = all(
                torch.equal(torch.isnan(a), torch.isnan(c))
                and bool(torch.isnan(c).any()) for a, c in pairs)
            check(r["nan_real_row_as_plain"], f"Macaron {dtype}: a NaN in "
                  f"a real row reached other outputs than in the plain "
                  f"version")
        # every one-CTA evaluation of this dtype ran mac_kernel_f32 in f32
        # and mac_kernel<bf16> in bf16
        cta = launch_counts["macaron_eval"] - at[1]
        r["mac_kernel_f32_launches"] = f32_launches() - at[0]
        check(r["mac_kernel_f32_launches"]
              == (cta if dtype == torch.float32 else 0),
              f"Macaron {dtype}: mac_kernel_f32 launched "
              f"{r['mac_kernel_f32_launches']} times for {cta} one-CTA "
              f"evaluations")
        results.append(r)
    shapes = plans()
    made = {k: v - before[k] for k, v in launch_counts.items()
            if v != before[k]}
    launch_counts.update(before)           # comparisons do not count
    emit(name, weight_noise=0.1, plans_agree_over_shapes=shapes,
         results=results)
    return made


# mac_kernel_f32's plans that the CIFAR cell does not take, at shapes the
# route sends to one CTA: (n_real, n_pad, embed_dim, heads, mlp_ratio) and
# the plan's (FFN chunk, column block)
MAC_F32_PLANS = (((65, 80, 128, 2, 4.0), (128, 192)),
                 ((65, 80, 64, 1, 1.0), (64, 192)),
                 ((29, 32, 32, 2, 1.0), (32, 192)),
                 ((122, 128, 32, 2, 4.0), (128, 128)))


def mac_f32_plans_vs_plain():
    """``mac_kernel_f32`` at B=4 on each plan of ``MAC_F32_PLANS``: plain,
    Euler and base against the plain version (parameters perturbed by
    normal(0, 0.1), as in ``macaron_vs_plain``) within ``TOL_F32``,
    finite, repeats bit-identical, NaN and garbage in the padded rows
    inert, each evaluation one launch of its C counter."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.macaron import (f32_launches, macaron_eval,
                                                  macaron_plan_f32)
    from odevit_tpu_torch.models.macaron import ViTMacaron
    before = dict(launch_counts)
    gen = torch.Generator().manual_seed(27)
    results = []
    for (n_real, n_pad, d, heads, ratio), want_plan in MAC_F32_PLANS:
        model = ViTMacaron(**{**MACARON_SHAPE, "embed_dim": d,
                              "num_heads": heads, "mlp_ratio": ratio},
                           dtype=torch.bfloat16, device="cuda", seed=0)
        with torch.no_grad():
            for p in model.vf.parameters():
                p.add_(torch.randn(p.shape, generator=gen).cuda() * 0.1)
        w = model.vf.kernel_weights(torch.float32)
        dh = w.w1.shape[1]
        plan = macaron_plan_f32(n_pad, n_real, d, heads, dh)
        check(plan is not None and plan[:2] == want_plan,
              f"Macaron f32 plan at {n_pad} {d} {heads} {dh}: {plan}")
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        x = torch.randn(4, n_pad, d, generator=gen)
        x[:, n_real:] = 0
        base = torch.randn(4, n_pad, d, generator=gen).cuda()
        dirty = x.clone()
        dirty[:, n_real::2] = float("nan")
        dirty[:, n_real + 1::2] = 1e30
        x, dirty = x.cuda(), dirty.cuda()
        r = {"shape": f"B=4 n={n_real}/{n_pad} D={d} H={heads} dh={dh}",
             "plan": plan}
        at = f32_launches()
        for mode, extra in {"plain": {}, "euler": dict(dt=0.25),
                            "base": dict(dt=0.25, base=base)}.items():
            got = macaron_eval(x, w, mode=mode, **kw, **extra)
            again = macaron_eval(x, w, mode=mode, **kw, **extra)
            padded = macaron_eval(dirty, w, mode=mode, **kw, **extra)
            want = macaron_eval(x, w, mode=mode, plain=True, **kw, **extra)
            torch.cuda.synchronize()
            r[mode] = rel_err(got[:, :n_real], want[:, :n_real])
            check(bool(torch.isfinite(got[:, :n_real]).all()),
                  f"Macaron f32 {r['shape']} {mode}: non-finite output")
            check(r[mode] <= TOL_F32,
                  f"Macaron f32 {r['shape']} {mode}: {r[mode]}")
            check(torch.equal(got, again),
                  f"Macaron f32 {r['shape']} {mode} not repeatable")
            check(torch.equal(got[:, :n_real], padded[:, :n_real]),
                  f"Macaron f32 {r['shape']} {mode}: padded rows reached "
                  f"a real row")
        r["mac_kernel_f32_launches"] = f32_launches() - at
        check(r["mac_kernel_f32_launches"] == 9,
              f"Macaron f32 {r['shape']}: mac_kernel_f32 launched "
              f"{r['mac_kernel_f32_launches']} times for 9 evaluations")
        results.append(r)
        del model
    launch_counts.update(before)           # comparisons do not count
    emit("macaron_f32_plans_vs_plain", weight_noise=0.1, tol=TOL_F32,
         results=results)


def phase_macaron_kernels_vs_plain():
    """The one-CTA kernels at B=4 and the cell's shape (65 tokens padded
    to 80, D=192, 3 heads, dh=768); the Python plans against
    ``mac_plan``/``mcb_plan``/``mac_plan_f32``; ``mac_kernel_f32`` on
    the plans of other shapes."""
    macaron_vs_plain("macaron_kernels_vs_plain", macaron_model(), 4, 65, 80,
                     ("macaron_eval", "macaron_bwd"), macaron_plans_agree)
    mac_f32_plans_vs_plain()


def phase_macaron_serving(images_u8, rng):
    """Cell cifar100-macaron-serve-rk4-13-b1024: the Macaron model served by
    ``fast_forward`` at B=1024, rk4 on 13 points on the fused stage-advance
    route (48 launches: one euler-mode and three base-mode per step, f32
    states), against the plain path; Euler on 13 points (12 euler-mode
    launches) beside it; the engine over the rk4 model. Each launch is one
    ``mac_kernel_f32`` (its C counter)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.kernels.macaron import f32_launches
    from odevit_tpu_torch.models.fast_forward import fast_forward
    x = make_preprocess(dtype=torch.bfloat16)(images_u8)
    report = {}
    models = {"rk4-13": macaron_model(), "euler-13": macaron_model("euler")}
    for name, model in models.items():
        evals = 48 if name == "rk4-13" else 12
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        f32_0 = f32_launches()
        got = fast_forward(model, x)["logits"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts.items() if v}
        kernel_launches = f32_launches() - f32_0
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(launches == {"macaron_eval": evals},
              f"Macaron {name}: launches {launches}")
        check(kernel_launches == evals, f"Macaron {name}: mac_kernel_f32 "
              f"launched {kernel_launches} times, want {evals}")
        want = fast_forward(model, x, plain=True)["logits"]
        torch.cuda.synchronize()
        err = rel_err(got, want)
        top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        check(bool(torch.isfinite(got).all())
              and tuple(got.shape) == (BATCH, 100),
              f"Macaron {name}: logits {got.shape}")
        check(err <= TOL_LOGITS, f"Macaron {name}: logits rel err {err}")
        check(top1 >= MIN_TOP1_AGREEMENT,
              f"Macaron {name}: top-1 agreement {top1}")
        ms = cuda_ms(lambda: fast_forward(model, x), iters=3)
        plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True),
                           iters=2)
        report[name] = {
            "launches": launches, "mac_kernel_f32_launches": kernel_launches,
            "rel_err": err, "tol": TOL_LOGITS,
            "top1_agreement": top1, "logit_scale": want.abs().max().item(),
            "ms_per_forward": ms, "img_per_s": BATCH / ms * 1e3,
            "ms_per_eval": ms / evals, "plain_ms_per_forward": plain_ms,
            "plain_img_per_s": BATCH / plain_ms * 1e3, "peak_mem_gb": peak}
    engine = phase_serving(models["rk4-13"], rng, counter="macaron_eval",
                           name="macaron_serving_engine")
    emit("macaron_serving", cell=MACARON_SERVE_CELL, batch=BATCH,
         state_dtype="float32", results=report, engine_launches=engine)
    return report


def macaron_train_runs(images_u8, labels, model_fn=None, pre=None):
    """3 steps of ``make_fast_macaron_train_step`` through the kernels and
    through the plain path from the same weights and batch; then one more
    step of each timed by CUDA events around its parts, and one profiled
    step of the kernel path. ``model_fn`` (default ``macaron_model``) makes
    the model, ``pre`` (default the 32 px bf16 preprocess) the input."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.kernels.macaron import f32_launches
    from odevit_tpu_torch.train.fast_steps import (
        fast_macaron_forward, make_fast_macaron_train_step)
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    pre = pre or make_preprocess(dtype=torch.bfloat16)
    model_fn = model_fn or macaron_model
    batch = {"pixel_values": images_u8, "labels": labels}
    b = images_u8.shape[0]
    runs = {}
    for path in ("kernels", "plain"):
        model = model_fn()
        state = create_train_state(model, make_optimizer(1e-4))
        step = make_fast_macaron_train_step(model, preprocess_fn=pre,
                                            plain=path == "plain")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "kernels":
            reset_launch_counts()
            wgrad0 = wgrad_launches()
            gemm0 = gemm_launches()
            cta0 = f32_cta_launches()
            rows0 = rows_bf16_launches()
            mac0 = f32_launches()
        losses, ms, metrics, first_grad = [], [], None, None
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            if i == 0:
                first_grad = grad_vector(model)
        launches = dict(launch_counts) if path == "kernels" else None
        wgrad = wgrad_since(wgrad0) if path == "kernels" else None
        gemm = (gemm_launches() - gemm0 if path == "kernels"
                else None)
        cta = f32_cta_since(cta0) if path == "kernels" else None
        rows = (rows_bf16_launches() - rows0 if path == "kernels"
                else None)
        mac = f32_launches() - mac0 if path == "kernels" else None
        peak = torch.cuda.max_memory_allocated() / 1e9
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = fast_macaron_forward(model, pre(images_u8), labels,
                                       plain=path == "plain")
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        if path == "kernels":
            profile = profile_step(step, state, batch)
        runs[path] = {
            "loss": losses, "ms_per_step": ms,
            "img_per_s_best_of_2_3": b / min(ms[1:]) * 1e3,
            "grad_norm_last": metrics["grad_norm"].item(),
            "acc_last": metrics["acc"].item(), "peak_mem_gb": peak,
            "split_ms": {"forward": ev[0].elapsed_time(ev[1]),
                         "backward": ev[1].elapsed_time(ev[2]),
                         "optimizer": ev[2].elapsed_time(ev[3])},
            "launches": launches, "wgrad_launches": wgrad,
            "gemm_launches": gemm,
            "f32_cta_launches": cta, "rows_bf16_launches": rows,
            "mac_kernel_f32_launches": mac,
            "first_grad": first_grad}
        del model, state, step
    k, p = runs["kernels"], runs["plain"]
    # each one-CTA evaluation of the f32 steps is one mac_kernel_f32
    check(k["mac_kernel_f32_launches"] == k["launches"].get("macaron_eval",
                                                            0),
          f"mac_kernel_f32 launched {k['mac_kernel_f32_launches']} times "
          f"for {k['launches']}")
    cos = torch.nn.functional.cosine_similarity(
        k.pop("first_grad"), p.pop("first_grad"), dim=0).item()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])]
    per_step = {n: c / TRAIN_STEPS for n, c in k["launches"].items()}
    return runs, profile, cos, loss_rel, per_step


def phase_macaron_train(images_u8, labels):
    """Cell cifar100-macaron-train-b1024 (JAX's ``macaron_b1024``): the
    fused Macaron step (rk4-13, CE, AdamW at 1e-4 after the clip), 48
    ``macaron_eval`` and 48 ``macaron_bwd`` per step in f32."""
    runs, profile, cos, loss_rel, per_step = macaron_train_runs(images_u8,
                                                                labels)
    k, p = runs["kernels"], runs["plain"]
    emit("macaron_train_profile", **profile)
    emit("macaron_train", cell=MACARON_TRAIN_CELL, batch=BATCH,
         steps=TRAIN_STEPS, solver="rk4-13", state_dtype="float32",
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train("macaron_train", runs, cos, loss_rel, per_step,
                {"macaron_eval": 48, "macaron_bwd": 48}, wgrad=None)
    check(k["mac_kernel_f32_launches"] == 48 * TRAIN_STEPS,
          f"macaron_train: mac_kernel_f32 launched "
          f"{k['mac_kernel_f32_launches']} times in {TRAIN_STEPS} steps")
    ran = " ".join(t["kernel"] for t in profile["top"])
    check("mac_kernel_f32" in ran,
          f"macaron_train's profile lacks mac_kernel_f32: {ran}")
    return k


def macaron_timing(model, x_in, b, iters=(5, 2), slow_iters=3):
    """Each Macaron instance alone on the main path's inputs (the first
    state of ``x_in``, preprocessed images: float32, as the cells run it;
    the bf16 instance on the same state rounded) against its plain
    version, with its bound; ``iters``: CUDA-event iterations of the
    kernel and of the plain version (``slow_iters`` for the f32
    backward). Returns {dtype: {counter: numbers}}, keyed by the counters
    the shape's route launches."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.macaron import macaron_eval, macaron_route
    from odevit_tpu_torch.kernels.macaron_bwd import BAR_NAMES, macaron_bwd
    from odevit_tpu_torch.models.fast_forward import pad_to_kernel
    before = dict(launch_counts)
    out = {}
    d, heads = model.embed_dim, model.num_heads
    with torch.no_grad():
        tokens, n_real = pad_to_kernel(model.embed(x_in, fused=True))
        check(tokens.dtype == torch.float32, f"Macaron tokens {tokens.dtype}")
        kw = dict(num_heads=heads, scaler=model.vf.scaler, n_real=n_real)
        g = torch.Generator(device="cuda").manual_seed(23)
        gx = torch.randn(tokens.shape, generator=g, device="cuda") * 1e-3
        gx[:, n_real:] = 0
        for dtype, tol in ((torch.float32, TOL_F32),
                           (torch.bfloat16, TOL_BF16)):
            x = tokens.to(dtype).contiguous()
            gd = gx.to(dtype)
            w = model.vf.kernel_weights(dtype)
            dh = w.w1.shape[1]
            sfx = {"cta": "", "tiled": "_tiled"}
            names = [name + sfx[macaron_route(dtype, x.shape[1], n_real, d,
                                              heads, dh, bwd)]
                     for name, bwd in (("macaron_eval", False),
                                       ("macaron_bwd", True))]
            isz = x.element_size()
            f = macaron_eval(x, w, **kw)
            pf = macaron_eval(x, w, plain=True, **kw)
            bars = macaron_bwd(x, w, gd, **kw)
            pbars = macaron_bwd(x, w, gd, plain=True, **kw)
            torch.cuda.synchronize()
            ferr = rel_err(f[:, :n_real], pf[:, :n_real])
            berrs = {nm: rel_err(a[:, :n_real] if nm == "x" else a,
                                 c[:, :n_real] if nm == "x" else c)
                     for nm, a, c in zip(BAR_NAMES, bars, pbars)}
            check(ferr <= tol, f"B={b} Macaron fwd {dtype}: {ferr}")
            check(max(berrs.values()) <= tol,
                  f"B={b} Macaron bwd {dtype}: {berrs}")
            slow = dtype == torch.float32
            out[str(dtype)] = {
                names[0]: {
                    "max_abs_err": (f[:, :n_real].float()
                                    - pf[:, :n_real].float()).abs().max()
                    .item(), "rel_err": ferr,
                    "ms": cuda_ms(lambda: macaron_eval(x, w, **kw),
                                  iters=iters[0]),
                    "plain_ms": cuda_ms(lambda: macaron_eval(
                        x, w, plain=True, **kw), iters=iters[1]),
                    **dict(zip(("bound_ms", "bound_by"), macaron_bound(
                        b, n_real, d, dh, isz))),
                    # f32: each kernel's device time per launch
                    **({"parts": kernel_parts(
                        lambda: macaron_eval(x, w, **kw))} if slow else {})},
                names[1]: {
                    "max_abs_err": max((a.float() - c.float()).abs().max()
                                       .item() for a, c in zip(bars[1:],
                                                               pbars[1:])),
                    "max_abs_err_x": (bars[0][:, :n_real].float()
                                      - pbars[0][:, :n_real].float()).abs()
                    .max().item(), "rel_errs": berrs,
                    "ms": cuda_ms(lambda: macaron_bwd(x, w, gd, **kw),
                                  iters=slow_iters if slow else iters[0]),
                    "plain_ms": cuda_ms(lambda: macaron_bwd(
                        x, w, gd, plain=True, **kw), iters=iters[1]),
                    **dict(zip(("bound_ms", "bound_by"), macaron_bound(
                        b, n_real, d, dh, isz, backward=True))),
                    # f32: the split-TF32 floor, and each kernel's device
                    # time per launch
                    **({"tf32_floor_ms": tf32_floor_ms(macaron_flops(
                        b, n_real, d, dh, backward=True)),
                        "parts": kernel_parts(
                            lambda: macaron_bwd(x, w, gd, **kw))}
                       if slow else {})}}
            if slow and names[0] == "macaron_eval":
                out[str(dtype)][names[0]].update(mac_f32_modes(
                    x, w, kw, b, n_real, d, dh, iters))
    launch_counts.update(before)           # comparisons do not count
    return out, n_real, x.shape[1], dh


def mac_f32_modes(x, w, kw, b, n_real, d, dh, iters):
    """``mac_kernel_f32`` in each mode at the timing state: ms, the rate of
    TF32 passes (three per product) against split TF32's floor, the plain
    version's ms and, as a yardstick, the tiled route's on the same inputs
    (checked against the plain version too); its registers and spills
    (``-Xptxas -v``, where this process built the library), which must
    show none."""
    import torch
    from odevit_tpu_torch.kernels import build
    from odevit_tpu_torch.kernels.macaron import macaron_eval
    from odevit_tpu_torch.kernels.macaron_tiled import tiled_eval
    g = torch.Generator(device="cuda").manual_seed(26)
    base = torch.randn(x.shape, generator=g, device="cuda")
    flops = macaron_flops(b, n_real, d, dh)
    modes = {}
    for mode, extra in {"plain": {}, "euler": dict(dt=0.25),
                        "base": dict(dt=0.25, base=base)}.items():
        want = macaron_eval(x, w, mode=mode, plain=True, **kw, **extra)
        tiled = tiled_eval(x, w, mode=mode, **kw, **extra)
        torch.cuda.synchronize()
        err = rel_err(tiled[:, :n_real], want[:, :n_real])
        check(err <= TOL_F32, f"tiled Macaron {mode} at B={b}: {err}")
        ms = cuda_ms(lambda: macaron_eval(x, w, mode=mode, **kw, **extra),
                     iters=iters[0])
        modes[mode] = {
            "ms": ms, "tf32_pass_tflops": 3 * flops / ms / 1e9,
            "plain_ms": cuda_ms(lambda: macaron_eval(
                x, w, mode=mode, plain=True, **kw, **extra), iters=iters[1]),
            "tiled_ms": cuda_ms(lambda: tiled_eval(x, w, mode=mode, **kw,
                                                   **extra), iters=iters[0]),
            "tiled_rel_err": err}
    res = kernel_resources("macaron", ["mac_kernel_f32"])
    check("macaron" not in build.build_logs
          or (bool(res) and all(v["spill_stores"] == 0
                                and v["spill_loads"] == 0
                                for v in res.values())),
          f"mac_kernel_f32's registers and spills: {res}")
    return {"modes": modes, "tf32_floor_ms": tf32_floor_ms(flops),
            "resources": res}


def phase_macaron_kernel_timing(images_u8):
    """Each Macaron instance alone at B=1024 on the main path's inputs; the
    f32 backward's kernels per launch (``parts``) and its split-TF32
    floor (``tf32_floor_ms``) beside its bound."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    out, n_real, n_pad, dh = macaron_timing(
        macaron_model(), make_preprocess(dtype=torch.bfloat16)(images_u8),
        BATCH)
    emit("macaron_kernel_timing", shape=f"B={BATCH} n={n_real}/{n_pad} "
         f"D=192 H=3 dh={dh}", results=out)
    return out


# ---- slice 11: the Macaron family past one CTA ----------------------------

# configs/classification/experiment_vit_edo.yaml's model width as a
# ViTMacaron (the CLI builds one from any recipe's inputs with
# modeling.type: macaron): 224 px, patch 16, D=768, 12 heads, MLP ratio 2,
# Euler on 24 points over [0, 1]; 197 tokens padded to 208; model dtype
# float32 (the CLI's default), so the tiled route's f32 instances run.
# reduced: dropout 0 (the recipe has 0.3; JAX's fused Macaron step is
# deterministic-only)
MACARON224_SHAPE = dict(img_size=224, patch_size=16, embed_dim=768,
                        num_heads=12, mlp_ratio=2.0, num_classes=100,
                        emulate_depth=12.0, time_interval=1.0,
                        num_eval_steps=24, solver="euler")
MAC224_TRAIN_CELL = "cifar224-macaron-r2-train-b64"
MAC224_SERVE_CELL = "cifar224-macaron-r2-serve-euler24-b64"
MAC224_REDUCED = ("dropout 0 (the recipe's 0.3; JAX's fused Macaron step is "
                  "deterministic-only)")
# per step: 23 plain-mode evaluations and their 23 backwards
MAC224_LAUNCHES = {"macaron_eval_tiled": 23, "macaron_bwd_tiled": 23}


def macaron224_model(solver="euler", steps=24, seed=0):
    import torch
    from odevit_tpu_torch.models.macaron import ViTMacaron
    return ViTMacaron(**{**MACARON224_SHAPE, "solver": solver,
                         "num_eval_steps": steps}, dtype=torch.float32,
                      device="cuda", seed=seed)


def macaron_tiled_plans_agree():
    """``tiled_macaron_plan`` (Python, which routes on either device)
    against ``mct_plan`` of ``csrc/macaron_tiled.cu`` over a sweep of
    shapes: the same plan, or none on both sides."""
    import torch
    from odevit_tpu_torch.kernels.macaron_tiled import (kernel_tiled_plan,
                                                        tiled_macaron_plan)
    shapes = 0
    for dtype in (torch.bfloat16, torch.float32):
        for n_pad in (16, 80, 128, 144, 160, 208, 256, 272):
            for d, heads in ((32, 2), (32, 4), (192, 3), (384, 6),
                             (768, 12), (1024, 16)):
                for dh in (d, 2 * d, 4 * d):
                    args = (dtype, n_pad, n_pad - 11, d, heads, dh)
                    got, want = tiled_macaron_plan(*args), \
                        kernel_tiled_plan(*args)
                    check(got == want, f"Macaron tiled plan {args}: python "
                          f"{got}, mct_plan {want}")
                    shapes += 1
    return shapes


# vft_gemm_tf32 alone (csrc/vector_field_tiled.cu, kernels/tf32_gemm.py):
# the f32 products of cell cifar224-macaron-r2-train-b64's evaluation and
# backward at B=64 x 208 padded rows, (label, N, K, B stored [N, K],
# epilogue, the outputs the route has it write); then every epilogue at a
# ragged shape
TF32_ROWS = 64 * 208
TF32_CELL_PRODUCTS = (
    ("z W1", 1536, 768, False, "gelu", ("out",)),
    ("h W2", 768, 1536, False, "mac_resid", ("out32",)),
    ("z Wqkv", 2304, 768, False, "round", ("out",)),
    ("ctx Wout", 768, 768, False, "mac_resid", ("out32",)),
    ("ob W2^T", 1536, 768, True, "gelu_grad", ("out",)),
    ("h1_bar W1^T", 768, 1536, True, "f32", ("out32",)),
    ("aod Wout^T", 768, 768, True, "round", ("out",)),
    ("qkv_bar Wqkv^T", 768, 2304, True, "f32", ("out32",)))
# M and N not multiples of the 128 x 128 tile, K ending in half a slice;
# rows of 208 padded to 197 real for the padded-row epilogues
TF32_RAGGED = dict(m=3 * 208, n=400, k=(80, 48), n_pad=208, n_real=197)
TOL_TF32_GEMM = 1e-5
MIN_TF32_RATE = 150e12          # TF32 passes a second at the z W1 product


def tf32_gemm_case(m, n, ks, bt, epi, g, n_pad=208, n_real=197,
                   outputs=None):
    """One ``tf32_gemm`` call's arguments on random f32 operands: ``ks``
    the pairs' K, every input an epilogue may read, and the ``outputs``
    (default all six; zeros, so that what an epilogue leaves alone
    compares equal)."""
    import torch
    from odevit_tpu_torch.kernels.dropout import (DROP_SITE_ATTN_OUT,
                                                  DROP_SITE_H,
                                                  DROP_SITE_MLP_OUT)
    from odevit_tpu_torch.kernels.tf32_gemm import OUTPUTS
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    pairs = [(r(m, k), r(n, k) if bt else r(k, n)) for k in ks]
    drops = {"gelu_drop": ((DROP_SITE_H, 0.1),),
             "gelu_grad_drop": ((DROP_SITE_H, 0.1),),
             "out_drop": ((DROP_SITE_MLP_OUT, 0.1),
                          (DROP_SITE_ATTN_OUT, 0.2))}.get(epi, ())
    kw = dict(bias=r(n), aux=r(m, n), res=r(m, n), rs=r(1), scale=0.37,
              dt=0.05, alpha=0.5, seed=1234567, drops=drops, n_pad=n_pad,
              n_real=n_real, bt=bt)
    outs = {k: torch.zeros(m, n, device="cuda")
            if outputs is None or k in outputs else None for k in OUTPUTS}
    return pairs, kw, outs


def tf32_gemm_check(pairs, epi, kw, outs):
    """Runs ``tf32_gemm`` twice and the float64 plain version once:
    (max |kernel - float64| / max|float64| over the outputs, repeats
    bit-identical, the masks equal to the plain generator's)."""
    import torch
    from odevit_tpu_torch.kernels.tf32_gemm import tf32_gemm
    tf32_gemm(pairs, epi, outs, **kw)
    given = [k for k, v in outs.items() if v is not None]
    first = {k: outs[k].clone() for k in given}
    tf32_gemm(pairs, epi, outs, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(first[k], outs[k]) for k in given)
    d64 = lambda t: None if t is None else t.double()
    ref = {k: torch.zeros_like(outs[k], dtype=torch.float64) for k in given}
    tf32_gemm([(d64(a), d64(b)) for a, b in pairs], epi, ref, plain=True,
              **{k: d64(v) if torch.is_tensor(v) else v
                 for k, v in kw.items()})
    err = max(((outs[k].double() - ref[k]).abs().max()
               / ref[k].abs().max().clamp_min(1e-30)).item()
              for k in given if not k.startswith("mask"))
    masks = all(torch.equal(outs[k].double(), ref[k])
                for k in given if k.startswith("mask"))
    return err, same, masks


def phase_tf32_gemm_vs_plain():
    """``vft_gemm_tf32`` alone: the f32 products of the 224 px Macaron cell
    at B=64 x 208 rows against a float64 product of the same operands
    (within 1e-5 of max|ref|), repeats bit-identical, timed beside
    ``torch.matmul`` in full f32 on the same operands (its library call),
    with the rate of its three TF32 passes against the 495 TFLOP/s peak;
    every epilogue (the dropout ones with their masks) in both layouts
    with one and two pairs at a ragged shape; NaNs with every mantissa
    bit set reaching their rows and columns; registers and spills of
    every instance from ``-Xptxas -v``."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.tf32_gemm import EPILOGUES, tf32_gemm
    before = dict(launch_counts)
    g = torch.Generator(device="cuda").manual_seed(29)
    cell, ragged, gates = {}, {}, []
    for label, n, k, bt, epi, written in TF32_CELL_PRODUCTS:
        pairs, kw, outs = tf32_gemm_case(TF32_ROWS, n, (k,), bt, epi, g,
                                         outputs=written)
        err, same, _ = tf32_gemm_check(pairs, epi, kw, outs)
        gates += [(err <= TOL_TF32_GEMM, f"tf32 gemm {label}: rel err {err}"),
                  (same, f"tf32 gemm {label}: repeats differ")]
        a, b = pairs[0]
        ms = cuda_ms(lambda: tf32_gemm(pairs, epi, outs, **kw), iters=20)
        lib_ms = cuda_ms(lambda: torch.matmul(a, b.T if bt else b),
                         iters=20)
        flops = 2.0 * TF32_ROWS * n * k
        cell[label] = {
            "m": TF32_ROWS, "n": n, "k": k, "bt": bt, "epilogue": epi,
            "outputs": written,
            "rel_err": err, "ms": ms, "library_ms": lib_ms,
            "tf32_pass_tflops": 3 * flops / ms / 1e9,
            "f32_work_tflops": flops / ms / 1e9,
            "tf32_floor_ms": tf32_floor_ms(flops),
            "bound_ms": max(tf32_floor_ms(flops),
                            4.0 * (TF32_ROWS * k + k * n + TF32_ROWS * n)
                            / PEAK_BYTES_PER_S * 1e3)}
    rate = cell["z W1"]["tf32_pass_tflops"] * 1e12
    gates.append((rate >= MIN_TF32_RATE, f"tf32 gemm z W1: "
                  f"{rate / 1e12:.1f} TFLOP/s of TF32 passes"))
    rg = TF32_RAGGED
    for epi in EPILOGUES:
        for bt in (False, True):
            for ks in (rg["k"][:1], rg["k"]):
                pairs, kw, outs = tf32_gemm_case(rg["m"], rg["n"], ks, bt,
                                                 epi, g, rg["n_pad"],
                                                 rg["n_real"])
                err, same, masks = tf32_gemm_check(pairs, epi, kw, outs)
                what = f"tf32 gemm {epi} bt={bt} pairs={len(ks)}"
                gates += [(err <= TOL_TF32_GEMM, f"{what}: rel err {err}"),
                          (same, f"{what}: repeats differ"),
                          (masks, f"{what}: masks differ from the "
                                  f"generator's")]
                ragged[f"{epi} bt={int(bt)} pairs={len(ks)}"] = err
    # the card's NaN (0x7FFFFFFF) in a row of A and its negative
    # (0xFFFFFFFF) in a column of B: exactly that row and column of C are
    # NaN
    nan_ok = {}
    for bt in (False, True):
        pairs, kw, outs = tf32_gemm_case(rg["m"], rg["n"], rg["k"][:1], bt,
                                         "f32", g, outputs=("out32",))
        a, b = pairs[0]
        a.view(torch.int32)[5] = 0x7FFFFFFF
        (b[7] if bt else b[:, 7]).view(torch.int32).fill_(-1)
        tf32_gemm(pairs, "f32", outs, **kw)
        want = torch.zeros(rg["m"], rg["n"], dtype=torch.bool, device="cuda")
        want[5] = want[:, 7] = True
        nan_ok[f"bt={int(bt)}"] = torch.equal(torch.isnan(outs["out32"]),
                                              want)
        gates.append((nan_ok[f"bt={int(bt)}"], f"tf32 gemm bt={bt}: NaN "
                      f"in A's row 5 and B's column 7 gave other NaNs"))
    # -Xptxas -v of every instance, where this process built the library
    from odevit_tpu_torch.kernels import build
    resources = {lib: kernel_resources(lib, ("vft_gemm_tf32",))
                 for lib in ("vector_field_tiled", "vector_field_bwd_split",
                             "macaron_tiled") if lib in build.build_logs}
    for lib, found in resources.items():
        gates.append((bool(found),
                      f"{lib}: no -Xptxas -v lines for vft_gemm_tf32"))
        gates += [(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                   f"{lib} {name}: spills {r}") for name, r in found.items()]
    launch_counts.update(before)           # comparisons do not count
    emit("tf32_gemm_vs_plain", tol=TOL_TF32_GEMM,
         min_tf32_pass_rate=MIN_TF32_RATE,
         peak_tf32_flops=PEAK_TF32_FLOPS, cell=cell,
         ragged_shape=f"M={rg['m']} N={rg['n']} K={rg['k']}",
         ragged_rel_errs=ragged, max_ragged_rel_err=max(ragged.values()),
         nan_reaches_its_row_and_column=nan_ok,
         resources=resources)
    for ok, what in gates:
        check(ok, what)
    return cell


# vft_gemm_wgmma alone (csrc/vector_field_tiled.cu, kernels/bf16_gemm.py):
# the bf16 products of the tiled route at three cells' shapes, (rows, D,
# dh): 224 px B=64 x 208 padded rows (tsref-distill-b64-bf16, the 224 px
# serving and L2 cells), 384 px B=64 x 592 (the tsbase384 cells), ratio 4
# (tsbase-r4-distill-b64-bf16)
BF16_GEMM_CELLS = {"224px": (64 * 208, 768, 768),
                   "384px": (64 * 592, 768, 768),
                   "r4": (64 * 208, 768, 3072)}
# the cells whose main path the kernels line reads each shape's launches
# from
BF16_GEMM_PATHS = {"224px": "tsref-distill-b64-bf16",
                   "384px": "tsbase384-free-train-drop0.1-b64-bf16",
                   "r4": "tsbase-r4-distill-b64-bf16"}


def bf16_gemm_products(d: int, dh: int):
    """The route's products at width d, hidden dh: (label, N, the pairs'
    K, B stored [N, K], epilogue, the outputs the route has it write) of
    the forward (qkv, h, the two-pair output with its Euler epilogue) and
    the backward (h1_bar, cb, a_bar, m_bar)."""
    return (("qkv", 3 * d, (d,), False, "round", ("out",)),
            ("h", dh, (d,), False, "gelu", ("out",)),
            ("out", d, (d, dh), False, "advance", ("out",)),
            ("h1_bar", dh, (d,), True, "gelu_grad", ("out",)),
            ("cb", d, (d,), True, "round", ("out",)),
            ("a_bar", d, (3 * d,), True, "f32", ("out32",)),
            ("m_bar", d, (dh,), True, "f32", ("out32",)))


# M and N not multiples of the tiles, K ending inside a stage; rows of 208
# padded to 197 real for the padded-row epilogues
BF16_RAGGED = dict(m=3 * 208, n=400, k=(80, 48), n_pad=208, n_real=197)
# Against a float64 product of the same bf16 operands, relative to
# max|ref|: outputs rounded to bf16 err by half a bf16 ulp (2^-9 of the
# value, below 2e-3 of the scale; gelu_drop rounds twice); the f32 ones by
# the tensor cores' sums over K <= 3,840 in one accumulator, sound runs
# below 1e-5 (one 64-deep stage dropped would read ~1e-2).
TOL_BF16_GEMM_ROUNDED = 8e-3
TOL_BF16_GEMM_F32 = 1e-4
# Speed floors against regressions, below what the kernel reads on an
# H100 at 700 W (PERF.md §6): the 384 px qkv product's rate (457-477
# TFLOP/s there), and each product's time over torch.matmul's on the same
# operands (1.2-2.6 there: the epilogue, not the products, holds the
# kernel back; PERF.md §7)
MIN_BF16_QKV_RATE = 430e12
MAX_BF16_VS_MATMUL = 3.0


def bf16_gemm_case(m, n, ks, bt, epi, g, n_pad=208, n_real=197,
                   outputs=None):
    """One ``bf16_gemm`` call's arguments on random operands: bf16 pairs
    with ``ks`` the pairs' K, every input an epilogue may read (f32 bias,
    aux, rs; bf16 res), and the ``outputs`` (default all six; zeros, so
    that what an epilogue leaves alone compares equal)."""
    import torch
    from odevit_tpu_torch.kernels.bf16_gemm import DTYPES
    from odevit_tpu_torch.kernels.dropout import (DROP_SITE_ATTN_OUT,
                                                  DROP_SITE_H,
                                                  DROP_SITE_MLP_OUT)
    from odevit_tpu_torch.kernels.tf32_gemm import OUTPUTS
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf = lambda *s: r(*s).to(torch.bfloat16)
    pairs = [(bf(m, k), bf(n, k) if bt else bf(k, n)) for k in ks]
    drops = {"gelu_drop": ((DROP_SITE_H, 0.1),),
             "gelu_grad_drop": ((DROP_SITE_H, 0.1),),
             "out_drop": ((DROP_SITE_MLP_OUT, 0.1),
                          (DROP_SITE_ATTN_OUT, 0.2))}.get(epi, ())
    kw = dict(bias=r(n), aux=r(m, n), res=bf(m, n), rs=r(1), scale=0.37,
              dt=0.05, alpha=0.5, seed=1234567, drops=drops, n_pad=n_pad,
              n_real=n_real, bt=bt)
    outs = {k: torch.zeros(m, n, device="cuda", dtype=DTYPES[k])
            if outputs is None or k in outputs else None for k in OUTPUTS}
    return pairs, kw, outs


def bf16_gemm_check(pairs, epi, kw, outs):
    """Runs ``bf16_gemm`` twice and the float64 plain version once:
    (max |kernel - float64| / max|float64| over the bf16 outputs, the same
    over the f32 ones (masks aside), repeats bit-identical, the masks equal
    to the plain generator's, max |kernel - float64| over the outputs)."""
    import torch
    from odevit_tpu_torch.kernels.bf16_gemm import bf16_gemm
    bf16_gemm(pairs, epi, outs, **kw)
    given = [k for k, v in outs.items() if v is not None]
    first = {k: outs[k].clone() for k in given}
    bf16_gemm(pairs, epi, outs, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(first[k], outs[k]) for k in given)
    d64 = lambda t: None if t is None else t.double()
    ref = {k: torch.zeros_like(outs[k], dtype=torch.float64) for k in given}
    bf16_gemm([(d64(a), d64(b)) for a, b in pairs], epi, ref, plain=True,
              **{k: d64(v) if torch.is_tensor(v) else v
                 for k, v in kw.items()})
    errs = {True: 0.0, False: 0.0}        # bf16 outputs, f32 ones
    max_abs = 0.0
    for k in given:
        if k.startswith("mask"):
            continue
        diff = (outs[k].double() - ref[k]).abs().max()
        e = (diff / ref[k].abs().max().clamp_min(1e-30)).item()
        rounded = outs[k].dtype == torch.bfloat16
        errs[rounded] = max(errs[rounded], e)
        max_abs = max(max_abs, diff.item())
    masks = all(torch.equal(outs[k].double(), ref[k])
                for k in given if k.startswith("mask"))
    return errs[True], errs[False], same, masks, max_abs


def gemm_bytes(m, n, ks, epi, written) -> float:
    """Bytes the product must move: its bf16 operands once, the epilogue's
    inputs once (aux f32, res bf16, bias f32) and its outputs once (bf16
    out and out2, f32 out32, fout and masks)."""
    nbytes = sum(2.0 * (m * k + k * n) for k in ks)
    reads = {"gelu_grad": 4, "gelu_grad_drop": 4, "out_drop": 4,
             "advance": 2, "gelu_grad_resid": 2, "mac_resid": 4,
             "mac_out": 4}
    nbytes += reads.get(epi, 0) * m * n
    sizes = {"out": 2, "out2": 2, "out32": 4, "fout": 4, "mask0": 4,
             "mask1": 4}
    return nbytes + sum(sizes[k] for k in written) * m * n


def phase_bf16_gemm_vs_plain():
    """``vft_gemm_wgmma`` alone: the route's seven bf16 products at each
    of ``BF16_GEMM_CELLS`` against a float64 product of the same bf16
    operands (rounded outputs within 8e-3, f32 ones within 1e-4 of
    max|ref|), repeats bit-identical, timed by CUDA events beside
    ``torch.matmul`` on the same
    bf16 operands (the bare product, two pairs as one product of the
    concatenated operands: the library call), with their TFLOP/s against
    989 and their bound; the 384 px qkv product at least
    ``MIN_BF16_QKV_RATE`` and every product within ``MAX_BF16_VS_MATMUL``
    of ``torch.matmul``; every epilogue, both
    layouts, one and two pairs at a ragged shape, the masks
    against the generator; the card's NaN in a row of A and a column of B
    reaching exactly that row and column; the C counter once a call;
    registers and spills of every instance from ``-Xptxas -v``. Returns
    {cell: {product: report}}."""
    import torch
    from odevit_tpu_torch.kernels import build, launch_counts
    from odevit_tpu_torch.kernels.bf16_gemm import (LIBRARIES, bf16_gemm,
                                                    wgmma_launches)
    from odevit_tpu_torch.kernels.tf32_gemm import EPILOGUES
    before = dict(launch_counts)
    g = torch.Generator(device="cuda").manual_seed(37)
    cells, ragged, gates, calls = {}, {}, [], 0
    counted = wgmma_launches()
    for cell, (rows, d, dh) in BF16_GEMM_CELLS.items():
        cells[cell] = {}
        for label, n, ks, bt, epi, written in bf16_gemm_products(d, dh):
            pairs, kw, outs = bf16_gemm_case(rows, n, ks, bt, epi, g,
                                             outputs=written)
            e16, e32, same, _, max_abs = bf16_gemm_check(pairs, epi, kw,
                                                         outs)
            calls += 2
            what = f"bf16 gemm {cell} {label}"
            gates += [(e16 <= TOL_BF16_GEMM_ROUNDED,
                       f"{what}: rel err {e16} (bf16 outputs)"),
                      (e32 <= TOL_BF16_GEMM_F32,
                       f"{what}: rel err {e32} (f32 outputs)"),
                      (same, f"{what}: repeats differ")]
            ms = cuda_ms(lambda: bf16_gemm(pairs, epi, outs, **kw), iters=20)
            calls += 21
            a_cat = torch.cat([a for a, _ in pairs], 1)
            b_cat = torch.cat([b for _, b in pairs], 1 if bt else 0)
            lib_ms = cuda_ms(lambda: torch.matmul(
                a_cat, b_cat.T if bt else b_cat), iters=20)
            del a_cat, b_cat
            plain_ms = cuda_ms(lambda: bf16_gemm(pairs, epi, outs,
                                                 plain=True, **kw), iters=3)
            flops = 2.0 * rows * n * sum(ks)
            bound_ms, bound_by = _bound(flops, gemm_bytes(rows, n, ks, epi,
                                                          written))
            cells[cell][label] = {
                "m": rows, "n": n, "k": list(ks), "bt": bt, "epilogue": epi,
                "outputs": written, "rel_err_bf16": e16,
                "rel_err_f32": e32, "max_abs_err": max_abs,
                "flops": flops, "bytes": gemm_bytes(rows, n, ks, epi,
                                                    written),
                "ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                "tflops": flops / ms / 1e9,
                "library_tflops": flops / lib_ms / 1e9,
                "vs_library": ms / lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "peak_share": bound_ms / ms}
            gates.append((ms <= MAX_BF16_VS_MATMUL * lib_ms,
                          f"{what}: {ms:.4f} ms against torch.matmul's "
                          f"{lib_ms:.4f}"))
            del pairs, kw, outs
            torch.cuda.empty_cache()
    rate = cells["384px"]["qkv"]["tflops"] * 1e12
    gates.append((rate >= MIN_BF16_QKV_RATE, f"bf16 gemm 384px qkv: "
                  f"{rate / 1e12:.1f} TFLOP/s"))
    rg = BF16_RAGGED
    for epi in EPILOGUES:
        for bt in (False, True):
            for ks in (rg["k"][:1], rg["k"]):
                pairs, kw, outs = bf16_gemm_case(rg["m"], rg["n"], ks, bt,
                                                 epi, g, rg["n_pad"],
                                                 rg["n_real"])
                e16, e32, same, masks, _ = bf16_gemm_check(pairs, epi, kw,
                                                           outs)
                calls += 2
                what = f"bf16 gemm {epi} bt={bt} pairs={len(ks)}"
                gates += [(e16 <= TOL_BF16_GEMM_ROUNDED,
                           f"{what}: rel err {e16} (bf16 outputs)"),
                          (e32 <= TOL_BF16_GEMM_F32,
                           f"{what}: rel err {e32} (f32 outputs)"),
                          (same, f"{what}: repeats differ"),
                          (masks, f"{what}: masks differ from the "
                                  f"generator's")]
                ragged[f"{epi} bt={int(bt)} pairs={len(ks)}"] = [e16, e32]
    # the card's NaN (0x7FFF) in a row of A and its negative (0xFFFF) in a
    # column of B: exactly that row and column of C are NaN
    nan_ok = {}
    for bt in (False, True):
        pairs, kw, outs = bf16_gemm_case(rg["m"], rg["n"], rg["k"][:1], bt,
                                         "f32", g, outputs=("out32",))
        a, b = pairs[0]
        a.view(torch.int16)[5] = 0x7FFF
        (b[7] if bt else b[:, 7]).view(torch.int16).fill_(-1)
        bf16_gemm(pairs, "f32", outs, **kw)
        calls += 1
        want = torch.zeros(rg["m"], rg["n"], dtype=torch.bool, device="cuda")
        want[5] = want[:, 7] = True
        nan_ok[f"bt={int(bt)}"] = torch.equal(torch.isnan(outs["out32"]),
                                              want)
        gates.append((nan_ok[f"bt={int(bt)}"], f"bf16 gemm bt={bt}: NaN in "
                      f"A's row 5 and B's column 7 gave other NaNs"))
    counted = wgmma_launches() - counted
    gates.append((counted == calls, f"bf16 gemm: the C counter saw "
                  f"{counted} launches of {calls} calls"))
    resources = {lib: kernel_resources(lib, (BF16_GEMM_KERNEL,
                                             OLD_GEMM_BF16))
                 for lib in LIBRARIES if lib in build.build_logs}
    for lib, found in resources.items():
        gates.append((any(BF16_GEMM_KERNEL in k for k in found),
                      f"{lib}: no -Xptxas -v lines for {BF16_GEMM_KERNEL}"))
        gates += [(OLD_GEMM_BF16 not in name, f"{lib}: {name} is built")
                  for name in found]
        gates += [(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                   f"{lib} {name}: spills {r}") for name, r in found.items()]
    launch_counts.update(before)           # comparisons do not count
    emit("bf16_gemm_vs_plain", tol_rounded=TOL_BF16_GEMM_ROUNDED,
         tol_f32=TOL_BF16_GEMM_F32, min_qkv_rate=MIN_BF16_QKV_RATE,
         max_vs_library=MAX_BF16_VS_MATMUL, peak_bf16_flops=PEAK_BF16_FLOPS,
         library="torch.matmul on the same bf16 operands (two pairs: "
                 "their concatenation), no epilogue",
         cells=cells, ragged_shape=f"M={rg['m']} N={rg['n']} K={rg['k']}",
         ragged_rel_errs=ragged,
         max_ragged_rel_err_bf16=max(v[0] for v in ragged.values()),
         max_ragged_rel_err_f32=max(v[1] for v in ragged.values()),
         nan_reaches_its_row_and_column=nan_ok, launches=counted,
         resources=resources)
    for ok, what in gates:
        check(ok, what)
    return cells


def bf16_gemm_entry(cell, products, launches) -> dict:
    """The kernels line's entry of ``vft_gemm_wgmma`` at one cell's shape:
    its seven products once each (``bf16_gemm_products``), summed, with
    each product's numbers beside; ``launches`` on the cell's main path
    (``BF16_GEMM_PATHS``)."""
    total = lambda key: sum(v[key] for v in products.values())
    bound_ms, bound_by = _bound(total("flops"), total("bytes"))
    return {
        "name": f"{BF16_GEMM_KERNEL}_{cell}", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field_tiled.cu",
        "replaces": "odevit_tpu/kernels/vector_field.py:262",
        "launches": launches, "launches_of": BF16_GEMM_PATHS[cell],
        "max_abs_err": max(v["max_abs_err"] for v in products.values()),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total("library_ms"),
        "products": {k: {f: v[f] for f in (
            "m", "n", "k", "bt", "epilogue", "ms", "library_ms", "tflops", "vs_library", "bound_ms", "bound_by",
            "rel_err_bf16", "rel_err_f32")} for k, v in products.items()}}


# The bf16 weight products of the training cells' backwards, W_bar = A^T G
# (A [R, M], G [R, N]): R and the (M, N) of each launch's problems. CIFAR
# and its Macaron at B=1024 x 80 rows (the Macaron backward's second pass
# runs the shared FFN over both halves, 2R rows); TS-Base at B=64 x 208
# (224 px; the ratio-4 student's split halves) and x 592 (384 px).
WGRAD_SHAPES = {
    "cifar": (BATCH * 80, ((192, 576), (192, 192), (192, 768), (768, 192))),
    "tsbase224": (64 * 208, ((768, 2304), (768, 768), (768, 768),
                             (768, 768))),
    "r4_attn": (64 * 208, ((768, 2304), (768, 768))),
    "r4_mlp": (64 * 208, ((768, 3072), (3072, 768))),
    "tsbase384": (64 * 592, ((768, 2304), (768, 768), (768, 768),
                             (768, 768))),
    "macaron_attn": (BATCH * 80, ((192, 576), (192, 192))),
    "macaron_ffn": (2 * BATCH * 80, ((192, 768), (768, 192))),
}
# Ragged shapes, checked but neither timed against a gate nor in the
# kernels line: rows that end inside a stage (one image of the CIFAR
# cell, 80 rows; 1,100 rows in two slices, the second ending mid-stage),
# M and N below, between and past the tiles' edges, so the TMA zero fill,
# boxes wholly out of range and the masked epilogue all run
WGRAD_RAGGED = {
    "ragged_r80": (80, ((192, 576), (192, 192), (192, 768), (768, 192))),
    "ragged_r1100": (1100, ((48, 80), (16, 48), (208, 336), (64, 192))),
}
# The f32 ViTODE backwards' weight products (vfb_wgrad_tf32; the f32
# Macaron backwards take mcb_wgrad_f32): the same shapes in f32.
WGRAD_F32_SHAPES = ("cifar", "tsbase224", "r4_attn", "r4_mlp", "tsbase384")
WGRAD_KERNEL = "vfb_wgrad_wgmma"
TF32_WGRAD_KERNEL = "vfb_wgrad_tf32"
# the kernels they replaced: bf16 WMMA tiles, and f32 on the CUDA cores
OLD_WGRADS = ("vfb_wgrad_bf16", "vfb_wgrad_f32")
# the one-CTA kernels' old f32 instances, which vf_kernel_f32,
# vfb_rows_f32 and mac_kernel_f32 replaced: no step may launch them
OLD_F32_CTA = ("vf_kernel<float", "vfb_rows<float", "mac_kernel<float")
# the bf16 one-CTA backward's old kernel, replaced by vfb_rows_bf16: no
# profiled step may launch it
OLD_BF16_CTA = ("vfb_rows<__nv_bfloat16",)
# the first key-tiled CTA's bf16 softmax instances (forward and backward),
# which vft_attn_kt_fwd and vft_attn_kt_bwd replaced
OLD_KT_BF16 = ("vft_attn_kt<__nv_bfloat16, false",)
# the route's bf16 product kernel, and the WMMA one it replaced
BF16_GEMM_KERNEL = "vft_gemm_wgmma"
OLD_GEMM_BF16 = "vft_gemm_bf16"
# bf16 products are exact in f32: only the f32 sums over up to 163,840
# rows err (fresh accumulators every 512 rows); sound runs read below
# 1e-6 of max|ref|, and one 64-row stage dropped at the CIFAR shape
# (64 / 81,920 of the sum) would read about 8e-4. Split TF32 keeps about
# 21 bits of each f32 product (fresh accumulators every 32 rows); a
# dropped 32-row slice would read about 4e-4 at the CIFAR shape.
TOL_WGRAD = 1e-5
MIN_WGRAD_RATE = 150e12
# f32: TF32 passes (three a product) a second, at least; the CUDA-core
# kernel it replaced ran 1.9e12
MIN_TF32_WGRAD_RATE = 100e12
WGRAD_RATE_SHAPES = ("tsbase224", "tsbase384")


def wgrad_operands(rows, shapes, g, dtype):
    """Seeded (A, G) pairs: N(0.5, 1) and N(0.25, 1), so that the sums
    over rows drift as the backward's do (GELU outputs are biased)."""
    import torch
    return [((torch.randn(rows, m, generator=g, device="cuda") + 0.5)
             .to(dtype),
             (torch.randn(rows, n, generator=g, device="cuda") + 0.25)
             .to(dtype)) for m, n in shapes]


def wgrad_case(label, rows, shapes, pairs, splits, dtype_tol):
    """One shape's weight products through ``weight_bars``: against a
    float64 product (relative to max|ref|) and the plain version, twice
    (bit-identical?), with the card's NaN in one row of each operand, and
    timed: the call, its kernels per launch by profiler, the plain
    version and ``torch.matmul`` per product (its library call). The
    report's ``launches`` is the C counter's count of the operands'
    kernel over the checked calls (two, and the NaN run); f32 also gives
    the rate of TF32 passes. Returns (report, gates)."""
    import torch
    from odevit_tpu_torch.kernels.wgrad import weight_bars, weight_bars_plain
    run = lambda: weight_bars(pairs, splits)
    kind = "bf16" if pairs[0][0].dtype == torch.bfloat16 else "f32"
    counted = wgrad_launches()
    got, again = run(), run()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    max_abs = max((x - y).abs().max().item()
                  for x, y in zip(got, weight_bars_plain(pairs)))
    rel = 0.0
    for (a, b), x in zip(pairs, got):
        ref = a.double().T @ b.double()
        rel = max(rel, ((x.double() - ref).abs().max()
                        / ref.abs().max()).item())
    del got, again, ref
    # the card's NaN (every mantissa bit set) at A[ra, 7] and G[rg, 11]:
    # exactly row 7 and column 11 of each W_bar
    ra, rg = rows // 3, rows - 1
    nan_bits = 0x7FFF if pairs[0][0].dtype == torch.bfloat16 else 0x7FFFFFFF
    kept = [(a[ra, 7].clone(), b[rg, 11].clone()) for a, b in pairs]
    ints = torch.int16 if nan_bits == 0x7FFF else torch.int32
    for a, b in pairs:
        a.view(ints)[ra, 7] = nan_bits
        b.view(ints)[rg, 11] = nan_bits
    nan_ok = True
    for x in run():
        want = torch.zeros(x.shape, dtype=torch.bool, device="cuda")
        want[7] = want[:, 11] = True
        nan_ok = nan_ok and torch.equal(torch.isnan(x), want)
    for (a, b), (va, vb) in zip(pairs, kept):
        a[ra, 7], b[rg, 11] = va, vb
    counted = wgrad_since(counted)
    ms = cuda_ms(run, iters=10)
    parts = kernel_parts(run)
    kname = next((k for k in parts if "vfb_reduce" not in k), None)
    kernel_ms = parts[kname]["ms_per_launch"] if kname else None
    reduce_ms = next((v["ms_per_launch"] for k, v in parts.items()
                      if "vfb_reduce" in k), None)
    lib_ms = cuda_ms(lambda: [torch.matmul(a.T, b) for a, b in pairs],
                     iters=10)
    plain_ms = cuda_ms(lambda: weight_bars_plain(pairs), iters=3)
    flops = sum(2.0 * rows * m * n for m, n in shapes)
    size = pairs[0][0].element_size()
    nbytes = sum(size * rows * (m + n) + 4.0 * m * n for m, n in shapes)
    if size == 2:
        bound_ms, bound_by = _bound(flops, nbytes)
    else:
        t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((tf32_floor_ms(flops), "operations"),
                                 (t_mem, "bytes"))
    report = {
        "rows": rows, "problems": [list(mn) for mn in shapes],
        "splits": splits, "launches": counted[kind],
        "launches_by_kernel": counted, "rel_err": rel,
        "max_abs_err": max_abs,
        "repeats_identical": same, "nan_in_its_row_and_column": nan_ok,
        "kernel": kname, "kernel_ms": kernel_ms, "reduce_ms": reduce_ms,
        "ms": ms, "gflop": flops / 1e9,
        "tflops": flops / (kernel_ms or ms) / 1e9,
        **({} if size == 2 else
           {"tf32_pass_tflops": 3 * flops / (kernel_ms or ms) / 1e9}),
        "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": plain_ms,
        "library_ms": lib_ms,
        "library": "torch.matmul(a.T, g) per product (bf16 out)"
                   if size == 2 else "torch.matmul(a.T, g) per product, "
                                     "full f32"}
    gates = [(rel <= dtype_tol, f"wgrad {label}: rel err {rel}"),
             (counted[kind] == 3 and sum(counted.values()) == 3,
              f"wgrad {label}: launches {counted}, want 3 of {kind}"),
             (same, f"wgrad {label}: repeats differ"),
             (nan_ok, f"wgrad {label}: NaN in A's column 7 and G's column "
                      f"11 gave other NaNs")]
    return report, gates


def wgrad_splits_agree() -> dict:
    """``weight_splits`` of each dtype against the C rule it copies
    (``vfb_wgrad_splits``) over rows, widths and the problem sets of the
    combined backward and of the split halves: 432 shapes a dtype."""
    import ctypes
    import torch
    from odevit_tpu_torch.kernels import build
    from odevit_tpu_torch.kernels.vector_field_bwd import weight_splits
    fn = build.load("vector_field_bwd").vfb_wgrad_splits
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip]
    fn.restype = ctypes.c_int
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        differ, n = [], 0
        tbytes = torch.empty((), dtype=dtype).element_size()
        for rows in (300, 512, 1100, 4096, 13312, 37888, 81920, 163840):
            for d in (64, 192, 384, 512, 768, 1024):
                for dh in (d, 2 * d, 4 * d):
                    for shapes in (((d, 3 * d), (d, d), (d, dh), (dh, d)),
                                   ((d, dh), (dh, d)),
                                   ((d, 3 * d), (d, d))):
                        ms = (ctypes.c_int * 4)(*[m for m, _ in shapes])
                        ns = (ctypes.c_int * 4)(*[k for _, k in shapes])
                        want = weight_splits(rows, d, dh, shapes,
                                             dtype=dtype)
                        got = fn(tbytes, rows, len(shapes), ms, ns)
                        n += 1
                        if got != want:
                            differ.append((rows, shapes, want, got))
        out[str(dtype)] = {"shapes": n, "differ": differ}
    return out


def phase_wgrad_vs_plain():
    """The weight products of every backward alone through
    ``kernels/wgrad.py``: ``vfb_wgrad_wgmma`` in bf16 at each training
    cell's shape (``WGRAD_SHAPES``, the main paths' splits) and
    ``vfb_wgrad_tf32`` in f32 at the f32 ViTODE backwards'
    (``WGRAD_F32_SHAPES``), each also at the ragged shapes
    (``WGRAD_RAGGED``): within ``TOL_WGRAD`` of max|ref| of a float64
    product, repeats bit-identical, the card's NaN reaching exactly its row
    and column, timed per launch beside ``torch.matmul`` on the same
    operands; at the TS-Base shapes at least 150 TFLOP/s in bf16 and 100
    TFLOP/s of TF32 passes in f32; no spills; the Python split rules
    against the C rule. Returns the cells' cases of each dtype ({"bf16":
    ..., "f32": ...})."""
    import torch
    from odevit_tpu_torch.kernels import build, launch_counts
    from odevit_tpu_torch.kernels.macaron_bwd import wgrad_splits
    from odevit_tpu_torch.kernels.vector_field_bwd import weight_splits
    from odevit_tpu_torch.kernels.wgrad import LIBRARIES
    before = dict(launch_counts)
    g = torch.Generator(device="cuda").manual_seed(31)
    mac_splits = wgrad_splits(torch.bfloat16, BATCH * 80, 192, 768)
    cases, ragged, gates = {}, {}, []
    for kind, dtype, labels in (("bf16", torch.bfloat16, WGRAD_SHAPES),
                                ("f32", torch.float32, WGRAD_F32_SHAPES)):
        cases[kind], ragged[kind] = {}, {}
        for label in (*labels, *WGRAD_RAGGED):
            rows, shapes = {**WGRAD_SHAPES, **WGRAD_RAGGED}[label]
            pairs = wgrad_operands(rows, shapes, g, dtype)
            splits = (mac_splits if label.startswith("macaron")
                      else weight_splits(rows, 0, 0, shapes, dtype=dtype))
            into = ragged[kind] if label in WGRAD_RAGGED else cases[kind]
            into[label], found = wgrad_case(f"{kind} {label}", rows,
                                            shapes, pairs, splits,
                                            TOL_WGRAD)
            gates += found
            del pairs
            torch.cuda.empty_cache()
    for label in WGRAD_RATE_SHAPES:
        rate = cases["bf16"][label]["tflops"] * 1e12
        gates.append((rate >= MIN_WGRAD_RATE,
                      f"wgrad bf16 {label}: {rate / 1e12:.1f} TFLOP/s"))
        rate = cases["f32"][label]["tf32_pass_tflops"] * 1e12
        gates.append((rate >= MIN_TF32_WGRAD_RATE,
                      f"wgrad f32 {label}: {rate / 1e12:.1f} TFLOP/s of "
                      f"TF32 passes"))
    splits_agree = wgrad_splits_agree()
    for dtype, agree in splits_agree.items():
        gates.append((not agree["differ"], f"wgrad splits {dtype}: Python "
                      f"and C differ at {agree['differ'][:5]}"))
    resources = {lib: kernel_resources(
        lib, (WGRAD_KERNEL, TF32_WGRAD_KERNEL, *OLD_WGRADS))
        for lib in LIBRARIES if lib in build.build_logs}
    for lib, res in resources.items():
        for want in (WGRAD_KERNEL, TF32_WGRAD_KERNEL):
            gates.append((any(want in name for name in res),
                          f"{lib}: no -Xptxas -v lines for {want}"))
        gates += [(not any(old in name for old in OLD_WGRADS),
                   f"{lib}: {name} is built") for name in res]
        gates += [(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                   f"{lib} {name}: spills {r}") for name, r in res.items()]
    launch_counts.update(before)           # comparisons do not count
    emit("wgrad_vs_plain", tol=TOL_WGRAD, min_rate=MIN_WGRAD_RATE,
         min_tf32_pass_rate=MIN_TF32_WGRAD_RATE,
         rate_shapes=WGRAD_RATE_SHAPES, peak_bf16_flops=PEAK_BF16_FLOPS,
         peak_tf32_flops=PEAK_TF32_FLOPS,
         operands="A ~ N(0.5, 1), G ~ N(0.25, 1), bf16 and f32",
         cases=cases, ragged=ragged, splits_agree=splits_agree,
         resources=resources)
    for ok, what in gates:
        check(ok, what)
    return cases


def wgrad_entry(kind, label, case, path, launches) -> dict:
    """The kernels line's entry of one weight-product case of
    ``phase_wgrad_vs_plain`` (``kind`` "bf16" or "f32"), with its
    launches on ``path``."""
    return {
        "name": (WGRAD_KERNEL if kind == "bf16" else TF32_WGRAD_KERNEL)
        + f"_{label}", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field_bwd.cu",
        "replaces": ("odevit_tpu/kernels/macaron.py:278"
                     if label.startswith("macaron") else
                     "odevit_tpu/kernels/vector_field_bwd.py:409"
                     if label == "r4_mlp" else
                     "odevit_tpu/kernels/vector_field_bwd.py:548"
                     if label == "r4_attn" else
                     "odevit_tpu/kernels/vector_field_bwd.py:214"),
        "launches": launches, "launches_of": path,
        "max_abs_err": case["max_abs_err"], "rel_err": case["rel_err"],
        "ms": case["kernel_ms"] or case["ms"],
        "call_ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "tflops": case["tflops"],
        **({"tf32_pass_tflops": case["tf32_pass_tflops"]}
           if kind == "f32" else {}),
        "library_ms": case["library_ms"]}


def phase_macaron224_kernels_vs_plain():
    """The tiled route at B=4 and the cells' shape (197 tokens padded to
    208, D=768, 12 heads, dh=1536): each mode and the 16 cotangents
    against the plain versions in bf16 and f32, repeats, NaN padding; the
    Python tiled plan against ``mct_plan``."""
    macaron_vs_plain("macaron224_kernels_vs_plain", macaron224_model(), 4,
                     197, 208, ("macaron_eval_tiled", "macaron_bwd_tiled"),
                     macaron_tiled_plans_agree)


def phase_macaron224_train(images_u8, labels):
    """Cell cifar224-macaron-r2-train-b64: 3 steps of the fused Macaron
    step (Euler on 24 points, CE, AdamW at 1e-4 after the clip at 1.0;
    32 px uint8 resized to 224 on the card, f32) through the tiled
    kernels and the plain path: 23 ``macaron_eval_tiled`` and 23
    ``macaron_bwd_tiled`` per step."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    pre = make_preprocess(image_size=224, dtype=torch.float32)
    runs, profile, cos, loss_rel, per_step = macaron_train_runs(
        images_u8, labels, model_fn=macaron224_model, pre=pre)
    k, p = runs["kernels"], runs["plain"]
    emit("macaron224_train_profile", **profile)
    emit("macaron224_train", cell=MAC224_TRAIN_CELL,
         batch=images_u8.shape[0], input="uint8 32x32 resized to 224",
         steps=TRAIN_STEPS, solver="euler-24", state_dtype="float32",
         reduced=MAC224_REDUCED,
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train("macaron224_train", runs, cos, loss_rel, per_step,
                MAC224_LAUNCHES, wgrad=None)
    return k["launches"]


def phase_macaron224_kernel_timing(images_u8):
    """Each tiled instance alone at B=64 on the training cell's first
    state (f32; the bf16 instance on it rounded)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    b = images_u8.shape[0]
    out, n_real, n_pad, dh = macaron_timing(
        macaron224_model(),
        make_preprocess(image_size=224, dtype=torch.float32)(images_u8), b,
        iters=(3, 2), slow_iters=2)
    emit("macaron224_kernel_timing", shape=f"B={b} n={n_real}/{n_pad} "
         f"D=768 H=12 dh={dh}", results=out)
    return out


def phase_macaron224_serving(images_u8, rng):
    """Cell cifar224-macaron-r2-serve-euler24-b64: the model served by
    ``fast_forward`` at B=64 (32 px uint8 resized to 224 on the card,
    f32): Euler on 24 points (23 euler-mode tiled launches), and rk4 on 7
    (6 euler-mode and 18 base-mode) beside it, against the plain path;
    then the engine over the Euler model (16 requests)."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    x = make_preprocess(image_size=224, dtype=torch.float32)(images_u8)
    b = x.shape[0]
    report = {}
    models = {"euler-24": macaron224_model(),
              "rk4-7": macaron224_model("rk4", 7)}
    for name, model in models.items():
        evals = 23 if name == "euler-24" else 24
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        gemm0 = gemm_launches()
        got = fast_forward(model, x)["logits"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts.items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(launches == {"macaron_eval_tiled": evals},
              f"Macaron 224 {name}: launches {launches}")
        # f32 states: the route's products run vft_gemm_tf32
        check_gemm_route(f"Macaron 224 {name}", launches,
                         gemm_launches() - gemm0, bf16=False)
        want = fast_forward(model, x, plain=True)["logits"]
        torch.cuda.synchronize()
        err = rel_err(got, want)
        top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        check(bool(torch.isfinite(got).all())
              and tuple(got.shape) == (b, 100),
              f"Macaron 224 {name}: logits {got.shape}")
        check(err <= TOL_LOGITS, f"Macaron 224 {name}: logits rel err {err}")
        check(top1 >= MIN_TOP1_AGREEMENT,
              f"Macaron 224 {name}: top-1 agreement {top1}")
        ms = cuda_ms(lambda: fast_forward(model, x), iters=2)
        plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True),
                           iters=2)
        report[name] = {
            "launches": launches, "rel_err": err, "tol": TOL_LOGITS,
            "top1_agreement": top1, "logit_scale": want.abs().max().item(),
            "ms_per_forward": ms, "img_per_s": b / ms * 1e3,
            "ms_per_eval": ms / evals, "plain_ms_per_forward": plain_ms,
            "plain_img_per_s": b / plain_ms * 1e3, "peak_mem_gb": peak}
    engine = phase_serving_224(models["euler-24"], rng,
                               counter="macaron_eval_tiled", evals=23,
                               name="macaron224_serving_engine",
                               dtype="float32")
    emit("macaron224_serving", cell=MAC224_SERVE_CELL, batch=b,
         input="uint8 32x32 resized to 224", state_dtype="float32",
         reduced=MAC224_REDUCED, results=report, engine_launches=engine)
    return report


# ---- slice 10: L2 past one CTA, the map route, emit_masks ------------------

# evidence_free_base.yaml's model with l2_attention (dropout 0: JAX's fused
# L2 path is deterministic only)
TSL2_TRAIN_CELL = "tsbase-l2-train-b64-bf16"
TSL2_SERVE_CELL = "tsbase-l2-serve-euler36-b64-bf16"
TSL2_K = 2                                 # the recipe's jasmin
# per step: jasmin_window(36, "euler") = (5, 30) plain and JaSMin
# evaluations, and their 35 backwards
TSL2_LAUNCHES = {"vf_eval_l2_tiled": 5, "vf_eval_jasmin_l2_tiled": 30,
                 "vf_bwd_l2_tiled": 35}
# the map route: CIFAR width at patch 16 (9 tokens, padded to 16), rk4 on
# 13 points: 9 head steps of plain evaluations, 3 tail steps of map
# evaluations, per step. k=9: more extraction passes (k+1) than tokens,
# and the largest k JAX's map route takes (its _g_pair indexes the k-th
# order statistic of a row of 9)
MAP_ROUTE_CELL = "cifar100-vitode-p16-maproute-b1024-bf16"
MAP_ROUTE_K = 9
MAP_LAUNCHES = {"vf_eval": 36, "vf_eval_attn": 12, "vf_bwd": 36,
                "vf_bwd_tiled": 12}
MAP_DROP_LAUNCHES = {"vf_eval_drop": 36, "vf_eval_attn_drop": 12,
                     "vf_bwd_drop": 36, "vf_bwd_tiled_drop": 12}
# benchmarks/tpu_dropout_check.py's shape and rates (attn, proj, mlp)
CHECK_SHAPE = dict(b=16, n=21, d=64, heads=2, dh=128)
CHECK_DROPS = (0.2, 0.1, 0.3)
CHECK_SCALER, CHECK_SEED = 12.0, 12345


def tiled_plans_agree():
    """``tiled_plan_rule`` (Python, which routes L2 on either device)
    against ``vft_plan`` of the CUDA source over a sweep of shapes, with
    and without dropout and L2: the same plan, or none on both sides."""
    import torch
    from odevit_tpu_torch.kernels.tiled import tiled_plan, tiled_plan_rule
    shapes = 0
    for dtype in (torch.bfloat16, torch.float32):
        for n_pad in (16, 32, 80, 128, 144, 160, 208, 256, 272):
            for d, heads in ((32, 2), (64, 2), (192, 3), (384, 6),
                             (768, 12), (1024, 16)):
                for dh in (d, 4 * d):
                    for drop in (False, True):
                        for l2 in (False, True):
                            args = (dtype, n_pad, n_pad - 1, d, heads, dh,
                                    drop, l2)
                            try:
                                want = tiled_plan(*args)
                            except ValueError:
                                want = None
                            got = tiled_plan_rule(*args)
                            check(got == want, f"tiled plan {args}: python "
                                  f"{got}, vft_plan {want}")
                            shapes += 1
    return shapes


def free_step_ms(model, images_u8, labels, pre, jasmin_k):
    """The fused free step of ``model`` through the kernels: best of
    steps 2-3 by the host clock."""
    import torch
    from odevit_tpu_torch.train.fast_steps import make_fast_free_train_step
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    state = create_train_state(model, make_optimizer(1e-4))
    step = make_fast_free_train_step(model, jasmin_k=jasmin_k,
                                     preprocess_fn=pre)
    batch = {"pixel_values": images_u8, "labels": labels}
    ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms[1:])


def phase_tsbase_l2_train(images_u8, labels):
    """Cell tsbase-l2-train-b64-bf16: the free step of the TS-Base student
    with L2 attention (evidence_free_base.yaml at dropout 0; 32 px uint8
    resized to 224 on the card), through the tiled route's L2 instances
    and through the plain path from the same weights; beside it the
    softmax student's step at the same shape (the existing tiled kernels),
    a reference number only."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    pre = make_preprocess(image_size=224, dtype=torch.bfloat16)
    runs, profile, cos, loss_rel, per_step = train_runs(
        images_u8, labels, model_fn=lambda rates: l2_model(
            solver="euler", steps=36, tsbase=True),
        pre=pre, jasmin_k=TSL2_K)
    k, p = runs["kernels"], runs["plain"]
    softmax_ms = free_step_ms(distill_student(), images_u8, labels, pre,
                              TSL2_K)
    b = images_u8.shape[0]
    emit("tsbase_l2_train_profile", **profile)
    emit("tsbase_l2_train", cell=TSL2_TRAIN_CELL, batch=b,
         input="uint8 32x32 resized to 224", steps=TRAIN_STEPS,
         solver="euler-36", jasmin_k=TSL2_K,
         reduced="dropout 0 (JAX's L2 is deterministic-only)",
         ms_per_step_best_of_2_3=min(k["ms_per_step"][1:]),
         img_per_s=k["img_per_s_best_of_2_3"],
         plain_img_per_s=p["img_per_s_best_of_2_3"],
         softmax_ms_per_step=softmax_ms,
         softmax_img_per_s=b / softmax_ms * 1e3,
         split_ms=k["split_ms"], peak_mem_gb=k["peak_mem_gb"],
         busy_share=profile["busy_share"], first_grad_cosine=cos,
         min_cosine=MIN_GRAD_COSINE, loss_rel_diff=loss_rel,
         tol_loss=TOL_TRAIN_LOSS, launches_per_step=per_step, results=runs)
    check_train("tsbase_l2_train", runs, cos, loss_rel, per_step,
                TSL2_LAUNCHES)
    return k["launches"]


def phase_tsbase_l2_serving(images_224, rng):
    """Cell tsbase-l2-serve-euler36-b64-bf16: the L2 student served by
    ``fast_forward`` at its own grid (Euler on 36 points, the generic
    route as JAX routes L2: 35 tiled L2 launches per forward) at B=64 on
    224 px uint8, against the plain path; then the engine over it."""
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    model = l2_model(solver="euler", steps=36, tsbase=True)
    x = make_preprocess(image_size=224, dtype=torch.bfloat16)(images_224)
    b = x.shape[0]
    reset_launch_counts()
    gemm0 = gemm_launches()
    got = fast_forward(model, x)["logits"]
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    check(launches == {"vf_eval_l2_tiled": 35},
          f"{TSL2_SERVE_CELL}: launches {launches}")
    gemms = check_gemm_route(TSL2_SERVE_CELL, launches,
                             gemm_launches() - gemm0)
    want = fast_forward(model, x, plain=True)["logits"]
    torch.cuda.synchronize()
    err = rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (b, 100),
          f"{TSL2_SERVE_CELL}: logits {got.shape}")
    check(err <= TOL_LOGITS, f"{TSL2_SERVE_CELL}: logits rel err {err}")
    check(top1 >= MIN_TOP1_AGREEMENT,
          f"{TSL2_SERVE_CELL}: top-1 agreement {top1}")
    ms = cuda_ms(lambda: fast_forward(model, x), iters=5)
    plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True), iters=2)
    engine = phase_serving_224(model, rng, counter="vf_eval_l2_tiled",
                               evals=35, name="tsbase_l2_serving_engine")
    emit("tsbase_l2_serving", cell=TSL2_SERVE_CELL, solver="euler-36",
         batch=b, launches=launches, gemm_launches=gemms, rel_err=err,
         tol=TOL_LOGITS,
         top1_agreement=top1, ms_per_forward=ms, img_per_s=b / ms * 1e3,
         plain_img_per_s=b / plain_ms * 1e3, engine_launches=engine)
    return launches


def phase_map_route(images_u8, labels):
    """The fused free step on JAX's map route: CIFAR width at patch 16 (9
    tokens padded to 16), JaSMin k=9 (more extraction passes than
    tokens), rk4 on 13 points, B=1024, bf16, deterministic and at dropout
    0.1; 3 steps through the kernels and the plain path each. The tail's
    evaluations launch the attention-map mode and their backwards the
    tiled route with the maps' cotangent."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    shape = dict(SHAPE, patch_size=16)

    def model_fn(rates):
        return ViTODE(**shape, num_eval_steps=13, solver="rk4",
                      dtype=torch.bfloat16, device="cuda", seed=0, **rates)

    out, launches = {}, {}
    for drops, want in ((None, MAP_LAUNCHES), (DROP_RATES, MAP_DROP_LAUNCHES)):
        runs, _, cos, loss_rel, per_step = train_runs(
            images_u8, labels, drops=drops, model_fn=model_fn,
            jasmin_k=MAP_ROUTE_K)
        name = "drop0.1" if drops else "deterministic"
        check_train(f"map_route {name}", runs, cos, loss_rel, per_step, want,
                    rows_bf16=ROWS_BF16_MAP)
        k = runs["kernels"]
        out[name] = {"img_per_s": k["img_per_s_best_of_2_3"],
                     "plain_img_per_s": runs["plain"]["img_per_s_best_of_2_3"],
                     "first_grad_cosine": cos, "loss_rel_diff": loss_rel,
                     "jasmin_loss_last": k["jasmin_loss_last"],
                     "launches_per_step": per_step}
        launches.update({n: c for n, c in k["launches"].items() if c})
    emit("map_route", cell=MAP_ROUTE_CELL, batch=images_u8.shape[0],
         tokens="9/16", solver="rk4-13", jasmin_k=MAP_ROUTE_K,
         min_cosine=MIN_GRAD_COSINE, tol_loss=TOL_TRAIN_LOSS, results=out)
    return launches


def twin_with_masks(x, ga, ba, gm, bm, wqkv, wout, w1, w2, masks, *,
                    num_heads, scaler, n_real):
    """``benchmarks/tpu_dropout_check.py::xla_twin_with_masks`` in
    PyTorch: the kernel's math in f32 with the emitted masks (JAX's
    layouts); (f(x), the pre-dropout p)."""
    import torch
    mask_h, mask_mo, mask_ao, mask_p = masks
    b, n, d = x.shape
    hd = d // num_heads
    cent = (x - x.mean(-1, keepdim=True)) * (d / (d - 1.0))
    cn_a, cn_m = cent * ga + ba, cent * gm + bm
    h = torch.nn.functional.gelu(cn_m @ w1) * mask_h.reshape(b, n, -1)
    mlp_o = (h @ w2) * mask_mo.reshape(b, n, d)
    q, k, v = (cn_a @ wqkv).split(d, -1)
    heads = lambda t: t.reshape(b, n, num_heads, hd).transpose(1, 2)
    s = (heads(q) * hd ** -0.5) @ heads(k).transpose(-1, -2)
    key = torch.arange(n, device=x.device) < n_real
    p = torch.softmax(s.masked_fill(~key, -1e30), -1)
    ctx = ((p * mask_p) @ heads(v)).transpose(1, 2).reshape(b, n, d)
    return (mlp_o + (ctx @ wout) * mask_ao.reshape(b, n, d)) * scaler, p


def phase_dropout_check():
    """The port's counterpart of ``tpu_dropout_check.run_checks`` at its
    shape (b=16, n=21, D=64, 2 heads, dh=128, rates 0.2/0.1/0.3, f32), on
    the emit_masks instance: the forward against the twin fed the emitted
    masks (f(x) within 1e-4, maps within 1e-5); the masks' values and keep
    rates; the masks bit-identical to ``generate_dropout_masks`` on the
    card and equal across the plain and map modes and a repeat; the
    backward (maps' cotangent, the tiled dropout instance) against
    autograd of the twin (1e-4 of each cotangent's scale)."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.kernels.autograd import fused_vf_attn
    from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
    from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval,
                                                       vf_eval_attn)
    b, n, d, heads, dh = (CHECK_SHAPE[k] for k in ("b", "n", "d", "heads",
                                                   "dh"))
    n_pad = 32
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda") * 0.2
    x = torch.zeros(b, n_pad, d, device="cuda")
    x[:, :n] = mk(b, n, d)
    ws = [mk(d), mk(d), mk(d), mk(d), mk(d, 3 * d), mk(d, d), mk(d, dh),
          mk(dh, d)]
    w = VFWeights(*ws)
    kw = dict(num_heads=heads, scaler=CHECK_SCALER, n_real=n,
              seed=CHECK_SEED, drops=CHECK_DROPS)
    reset_launch_counts()
    f, p, masks = vf_eval_attn(x, w, emit_masks=True, **kw)
    f2, masks2 = vf_eval(x, w, emit_masks=True, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    check(launches == {"vf_eval_masks": 2}, f"dropout_check: {launches}")
    before = dict(launch_counts)
    r = {}
    # 1. forward vs twin
    dx_t, p_t = twin_with_masks(x, *ws, masks, num_heads=heads,
                                scaler=CHECK_SCALER, n_real=n)
    r["fwd_max_abs_err"] = (f[:, :n] - dx_t[:, :n]).abs().max().item()
    r["attn_max_abs_err"] = (p[:, :, :n, :n] - p_t[:, :, :n, :n]).abs() \
        .max().item()
    check(r["fwd_max_abs_err"] < 1e-4, f"dropout_check fwd: {r}")
    check(r["attn_max_abs_err"] < 1e-5, f"dropout_check maps: {r}")
    # 2. values and keep rates, over the real rows and keys
    real = [m.reshape(b, n_pad, -1)[:, :n] for m in masks[:3]] + [
        masks[3][:, :, :n, :n]]
    for name, m, rate in (("h", real[0], CHECK_DROPS[2]),
                          ("mlp_out", real[1], CHECK_DROPS[2]),
                          ("attn_out", real[2], CHECK_DROPS[1]),
                          ("p", real[3], CHECK_DROPS[0])):
        vals = torch.unique(m).tolist()
        check(len(vals) == 2 and vals[0] == 0.0
              and abs(vals[1] - 1.0 / (1.0 - rate)) < 1e-5,
              f"dropout_check mask {name}: values {vals}")
        keep = (m > 0).float().mean().item()
        r[f"keep_rate_{name}"] = keep
        check(abs(keep - (1.0 - rate)) < 0.02,
              f"dropout_check mask {name}: keep rate {keep}")
    # 3. the generator kernel's masks, bit for bit; zeros on padding; the
    # same masks from both modes and from a repeat
    gen = generate_dropout_masks(b, n, d, dh, heads, CHECK_SEED,
                                 attn_drop=CHECK_DROPS[0],
                                 proj_drop=CHECK_DROPS[1],
                                 mlp_drop=CHECK_DROPS[2], device="cuda")
    _, _, masks3 = vf_eval_attn(x, w, emit_masks=True, **kw)
    torch.cuda.synchronize()
    pad_zero = (not any(m.reshape(b, n_pad, -1)[:, n:].any()
                        for m in masks[:3])
                and not masks[3][:, :, n:].any()
                and not masks[3][..., n:].any())
    r["masks_equal_generator"] = all(torch.equal(a, c)
                                     for a, c in zip(real, gen))
    r["masks_equal_across_modes_and_repeat"] = all(
        torch.equal(a, c) and torch.equal(a, e)
        for a, c, e in zip(masks, masks2, masks3))
    r["padding_zero"] = pad_zero
    check(r["masks_equal_generator"] and pad_zero,
          "dropout_check: the emitted masks differ from the generator's")
    check(r["masks_equal_across_modes_and_repeat"] and torch.equal(f, f2),
          "dropout_check: emitted masks differ between calls")
    # 4. the backward against autograd of the twin
    names = ("x",) + BWD_NAMES[1:]
    xk = x.clone().requires_grad_()
    pk = [t.clone().requires_grad_() for t in ws]
    dx, maps = fused_vf_attn(xk, VFWeights(*[t.detach() for t in pk]), pk,
                             **kw)
    loss = (dx[:, :n] ** 2).sum() + maps[:, :, 0, :n].sum()
    gk = torch.autograd.grad(loss, [xk, *pk])
    xt = x.clone().requires_grad_()
    pt = [t.clone().requires_grad_() for t in ws]
    dx_t, p_t = twin_with_masks(xt, *pt, masks, num_heads=heads,
                                scaler=CHECK_SCALER, n_real=n)
    loss_t = (dx_t[:, :n] ** 2).sum() + p_t[:, :, 0, :n].sum()
    gt = torch.autograd.grad(loss_t, [xt, *pt])
    errs = {nm: rel_err(a[:, :n] if nm == "x" else a,
                        c[:, :n] if nm == "x" else c)
            for nm, a, c in zip(names, gk, gt)}
    r["bwd_rel_err"] = errs
    check(max(errs.values()) < 1e-4, f"dropout_check bwd: {errs}")
    launch_counts.update(before)           # comparisons do not count
    emit("dropout_check", shape=CHECK_SHAPE, n_pad=n_pad, drops=CHECK_DROPS,
         launches=launches, results=r)
    return launches["vf_eval_masks"]


def masks_bound(b: int, n_real: int, d: int, dh: int, heads: int,
                itemsize: int):
    """(bound_ms, bound_by) of one map-mode evaluation that also writes
    its four f32 masks: the forward's operations, against its bytes, the
    maps and the masks written."""
    t_ops, _ = vf_bound(b, n_real, d, dh, itemsize)
    nbytes = ((2 * b * n_real * d + 4 * d * d + 2 * d * dh
               + b * heads * n_real * n_real) * itemsize + 16 * d
              + 4 * (b * n_real * (dh + 2 * d) + b * heads * n_real * n_real))
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")



# --- sequences past 256 padded tokens: the key-tiled attention ----------

LONG_TRAIN_CELL = "tsbase384-free-train-drop0.1-b64-bf16"
LONG_SERVE_CELL = "tsbase384-serve-euler36-b64-bf16"
LONG_SHAPES = ((272, 261), (592, 587))   # (n_pad, n_real) of phase 28a
LONG_K = 2                               # the recipe's jasmin_k
LONG_CHECK_BATCH = 8                     # kernels vs plain, 3 steps
LONG_BATCH = 64
# the free step at 384 px and dropout 0.1, per step: jasmin_window(36,
# "euler") = (5, 30) plain and JaSMin evaluations, and their 35 backwards,
# all on the key-tiled instances
LONG_LAUNCHES = {"vf_eval_tiled_drop_kt": 5,
                 "vf_eval_jasmin_tiled_drop_kt": 30,
                 "vf_bwd_tiled_drop_kt": 35}


def long_student(drops=None, solver="euler", steps=36):
    """The TS-Base student of evidence_free_base.yaml at 384 px: patch 16,
    D=768, 12 heads, MLP ratio 1, 10 registers, 587 tokens padded to 592,
    bf16, from seed 0; with ``drops``, at those attn/proj/mlp rates."""
    import torch
    from odevit_tpu_torch.models.vit_ode import ViTODE
    rates = dict(zip(("attn_drop", "proj_drop", "mlp_drop"), drops or ()))
    return ViTODE(img_size=384, patch_size=16, embed_dim=768, num_heads=12,
                  mlp_ratio=1.0, num_classes=100, emulate_depth=12,
                  time_interval=1.0, register_tokens=10,
                  pos_embed_register_tokens=False, solver=solver,
                  num_eval_steps=steps, dtype=torch.bfloat16, device="cuda",
                  seed=0, **rates)


def long_weights(d, heads, dh, g):
    """A field's weights at width d (scales of the model's
    initialisation; norms and L2 biases normal(0, 0.1) around 1 and 0), as
    {dtype: (softmax weights, L2 weights)} in bf16 and f32."""
    import torch
    from odevit_tpu_torch.kernels.vector_field import VFWeights
    r = lambda *s, sc: torch.randn(*s, generator=g, device="cuda") * sc
    norms = (1 + r(d, sc=0.1), r(d, sc=0.1), 1 + r(d, sc=0.1), r(d, sc=0.1))
    mats = (r(d, 3 * d, sc=d ** -0.5), r(d, d, sc=d ** -0.5),
            r(d, dh, sc=d ** -0.5), r(dh, d, sc=dh ** -0.5))
    bias = dict(qkv_bias=r(3 * d, sc=0.1), out_bias=r(d, sc=0.1))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        w = VFWeights(*norms, *(m.to(dtype).contiguous() for m in mats))
        out[dtype] = (w, w._replace(**bias))
    return out


def long_plans_agree():
    """``tiled_plan_rule`` and ``tiled_macaron_plan`` (Python, which route
    on either device) against ``vft_plan`` and ``mct_plan`` over shapes up
    to 1,024 padded tokens, whole-row and key-tiled: the same plan, or
    none on both sides."""
    import torch
    from odevit_tpu_torch.kernels.macaron_tiled import (kernel_tiled_plan,
                                                        tiled_macaron_plan)
    from odevit_tpu_torch.kernels.tiled import tiled_plan, tiled_plan_rule
    shapes = 0
    for dtype in (torch.bfloat16, torch.float32):
        for n_pad in (256, 272, 288, 400, 592, 600, 608, 1024):
            for d, heads in ((32, 2), (64, 2), (192, 3), (384, 6), (768, 12),
                             (1024, 16), (768, 4)):
                for dh in (d, 4 * d):
                    for drop, l2 in ((False, False), (True, False),
                                     (False, True)):
                        args = (dtype, n_pad, n_pad - 5, d, heads, dh, drop,
                                l2)
                        try:
                            want = tiled_plan(*args)
                        except ValueError:
                            want = None
                        got = tiled_plan_rule(*args)
                        check(got == want, f"tiled plan {args}: python "
                              f"{got}, vft_plan {want}")
                        shapes += 1
                    args = (dtype, n_pad, n_pad - 5, d, heads, dh)
                    got, want = tiled_macaron_plan(*args), \
                        kernel_tiled_plan(*args)
                    check(got == want, f"Macaron tiled plan {args}: python "
                          f"{got}, mct_plan {want}")
                    shapes += 1
    return shapes


def phase_long_kernels_vs_plain():
    """Phase 28a: every key-tiled instance against its plain version at
    B=2, 261 tokens padded to 272 and 587 padded to 592 (the last key tile
    partial), D=768, 12 heads, bf16 and f32: the forward's plain, Euler,
    stage-advance, JaSMin (k=2, k=10), map, dropout (± emit_masks, the
    masks bit-identical to ``generate_dropout_masks``), stash and L2
    instances; the backward with the dx, JaSMin and map cotangents, ±
    dropout, resid and L2; the split pair at dh=3072; the Macaron tiled
    route (3 modes, 16 cotangents). Statistics' columns on real keys,
    repeats bit-identical, NaN in padded rows inert, each launch counted
    once under its ``_kt`` counter and each forward's attention CTA by
    the C counter (``vft_attn_kt_fwd`` for bf16 softmax, the ViTODE and
    the Macaron forwards, the old ``vft_attn_kt`` for f32 and L2); the
    forwards also at head widths 16, 192 and 288; the Python plans
    against the CUDA ones up to 1,024 padded tokens; the outputs of the
    kernels that share code with ``vft_attn_kt_fwd`` or stay as they were
    against ``LONG_KT_SHA256``."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.macaron import macaron_eval
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    from odevit_tpu_torch.kernels.tiled import tiled_plan
    before = dict(launch_counts)
    checked, ctas = {}, {}
    b, d, heads, dh = 2, 768, 12, 768
    g = torch.Generator(device="cuda").manual_seed(28)
    weights = long_weights(d, heads, dh, g)
    w4s = long_weights(d, heads, 4 * d, g)
    seed, drops = DROP_SEEDS[2], DROP_RATES
    dkw = dict(seed=seed, drops=drops)

    def routed(fn, want, cta=(0, 0)):
        # cta: the forward attention CTAs the call launches by the C
        # counter, (vft_attn_kt_fwd, the old vft_attn_kt forward)
        counts = dict(launch_counts)
        at = kt_fwd_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: launch_counts[k] - counts[k] for k in counts
               if launch_counts[k] != counts[k]}
        check(got == want, f"launched {got}, want {want}")
        took = tuple(a - c for a, c in zip(kt_fwd_launches(), at))
        check(took == tuple(cta), f"{want}: forward attention CTAs "
              f"(vft_attn_kt_fwd, vft_attn_kt) {took}, want {cta}")
        for k, v in got.items():
            checked[k] = checked.get(k, 0) + v
            ctas[k] = [a + c for a, c in zip(ctas.get(k, (0, 0)), took)]
        return out

    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        return [t for o in out for t in (flat(o) if isinstance(o, tuple)
                                         else (o,))]

    def bit_same(a, c):
        return all(torch.equal(u, v) for u, v in zip(flat(a), flat(c)))

    def cta_of(dtype, n_pad, l2=False):
        # the forward attention CTAs one evaluation past 256 padded tokens
        # launches by the C counter, (vft_attn_kt_fwd, vft_attn_kt), as
        # vft::attn routes: the new CTA for bf16 softmax, else PR 14's
        assert n_pad > 256
        return (1, 0) if dtype == torch.bfloat16 and not l2 else (0, 1)

    results = []
    for n_pad, n_real in LONG_SHAPES:
        kw = dict(num_heads=heads, scaler=4.0, n_real=n_real)
        for dtype, tol in ((torch.bfloat16, TOL_BF16),
                           (torch.float32, TOL_F32)):
            w, wl2 = weights[dtype]
            w4 = w4s[dtype][0]
            x = torch.randn(b, n_pad, d, generator=g, device="cuda")
            x[:, 5:11] = x[:, 5:6]            # tied keys
            x[:, n_real:] = 0
            x = x.to(dtype)
            xb = torch.randn(b, n_pad, d, generator=g,
                             device="cuda").to(dtype)
            gx = torch.randn(b, n_pad, d, generator=g, device="cuda") * 1e-2
            gx[:, n_real:] = 0
            gx = gx.to(dtype)
            gj = torch.randn(b, heads, 5, n_pad, generator=g,
                             device="cuda") * 1e-2
            gj[..., n_real:] = 0
            ga = torch.randn(b, heads, n_pad, n_pad, generator=g,
                             device="cuda") * 1e-2
            ga[:, :, n_real:] = 0
            ga[..., n_real:] = 0
            ga = ga.to(dtype)
            r = {"dtype": str(dtype), "tol": tol,
                 "shape": f"B={b} n={n_real}/{n_pad} D={d} H={heads} dh={dh}",
                 "plan": tiled_plan(dtype, n_pad, n_real, d, heads, dh)}
            cta, cta_l2 = cta_of(dtype, n_pad), cta_of(dtype, n_pad, True)
            fwd_repeats = {}

            def fwd_repeat(name, got, fn):
                fwd_repeats[name] = bit_same(got, fn())
            errs = {}
            real = lambda a: a[:, :n_real]

            def cmp(name, got, want):
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                e = 0.0
                for a, c in zip(got, want):
                    if a.dtype == torch.int32:
                        continue
                    big = a.dim() == 3 and a.shape[1] == n_pad
                    e = max(e, rel_err(real(a) if big else a,
                                       real(c) if big else c))
                errs[name] = e

            fwd = {
                "plain": ({}, "vf_eval_tiled_kt"),
                "euler": (dict(mode="euler", dt=0.1),
                          "vf_eval_euler_tiled_kt"),
                "base": (dict(mode="base", dt=0.1, base=xb),
                         "vf_eval_base_tiled_kt"),
                "drop": (dkw, "vf_eval_tiled_drop_kt")}
            for name, (extra, counter) in fwd.items():
                got = routed(lambda: vf_eval(x, w, **kw, **extra),
                             {counter: 1}, cta)
                cmp(name, got, vf_eval(x, w, plain=True, **kw, **extra))
                fwd_repeat(name, got, lambda: vf_eval(x, w, **kw, **extra))
            jas = {}
            for k in (LONG_K, JASMIN_K):
                got = routed(lambda: vf_eval_jasmin(x, w, jas_k=k, **kw),
                             {"vf_eval_jasmin_tiled_kt": 1}, cta)
                fwd_repeat(f"jasmin_k{k}", got,
                      lambda: vf_eval_jasmin(x, w, jas_k=k, **kw))
                cmp(f"jasmin_k{k}", got,
                    vf_eval_jasmin(x, w, jas_k=k, plain=True, **kw))
                jas[k] = got
                # each statistic's column is a real key; the columns of
                # different ranks differ, those of one rank agree
                kk = k + 1
                ranks = (0, 1, kk - 2, kk - 1)
                cols = got[2][..., :n_real].long()
                ok = (cols >= 0) & (cols < n_real)
                for i in range(4):
                    for j in range(4):
                        if i != j:
                            same = cols[:, :, i] == cols[:, :, j]
                            ok[:, :, i] &= same if ranks[i] == ranks[j] \
                                else ~same
                check(bool(ok.all()), f"long jasmin k={k} {dtype} n={n_pad}: "
                      f"statistics' columns")
                check(not got[1][..., n_real:].any(),
                      "statistics not zero on padded rows")
            djas = routed(lambda: vf_eval_jasmin(x, w, jas_k=LONG_K, **kw,
                                                 **dkw),
                          {"vf_eval_jasmin_tiled_drop_kt": 1}, cta)
            fwd_repeat("drop_jasmin", djas, lambda: vf_eval_jasmin(
                x, w, jas_k=LONG_K, **kw, **dkw))
            cmp("drop_jasmin", djas,
                vf_eval_jasmin(x, w, jas_k=LONG_K, plain=True, **kw, **dkw))
            check(torch.equal(djas[1], jas[LONG_K][1])
                  and torch.equal(djas[2], jas[LONG_K][2]),
                  "dropout changed the JaSMin statistics")
            amap = routed(lambda: vf_eval_attn(x, w, **kw),
                          {"vf_eval_attn_kt": 1}, cta)
            fwd_repeat("map", amap, lambda: vf_eval_attn(x, w, **kw))
            cmp("map", amap, vf_eval_attn(x, w, plain=True, **kw))
            check(not amap[1][:, :, n_real:].any()
                  and not amap[1][..., n_real:].any(),
                  "the map is not zero on padded rows and keys")
            dmap = routed(lambda: vf_eval_attn(x, w, **kw, **dkw),
                          {"vf_eval_attn_drop_kt": 1}, cta)
            fwd_repeat("drop_map", dmap,
                       lambda: vf_eval_attn(x, w, **kw, **dkw))
            cmp("drop_map", dmap, vf_eval_attn(x, w, plain=True, **kw, **dkw))
            check(torch.equal(dmap[1], amap[1]), "dropout changed the map")
            out, masks = routed(
                lambda: vf_eval(x, w, emit_masks=True, **kw, **dkw),
                {"vf_eval_masks_kt": 1}, cta)
            fwd_repeat("masks", (out, masks), lambda: vf_eval(
                x, w, emit_masks=True, **kw, **dkw))
            cmp("masks_out", out, vf_eval(x, w, plain=True, **kw, **dkw))
            gen = generate_dropout_masks(
                b, n_real, d, dh, heads, seed, attn_drop=drops[0],
                proj_drop=drops[1], mlp_drop=drops[2], device="cuda")
            cut = [m.reshape(b, n_pad, -1)[:, :n_real] for m in masks[:3]] \
                + [masks[3][:, :, :n_real, :n_real]]
            r["masks_equal_generator"] = all(
                torch.equal(a, c) for a, c in zip(cut, gen))
            check(r["masks_equal_generator"], "emitted masks differ from "
                  "generate_dropout_masks")
            check(not masks[3][:, :, n_real:].any()
                  and not masks[3][..., n_real:].any(),
                  "mask_p not zero on padding")
            sout = routed(lambda: vf_eval(x, w, stash=True, **kw),
                          {"vf_eval_stash_tiled_kt": 1}, cta)
            rows = lambda o: (o[0], *resid_rows(o[1], b, n_pad, n_real))
            cmp("stash", rows(sout),
                rows(vf_eval(x, w, stash=True, plain=True, **kw)))
            check(torch.equal(sout[0], vf_eval(x, w, **kw)),
                  "the stash forward's f(x) differs")
            sjas = routed(lambda: vf_eval_jasmin(x, w, jas_k=LONG_K,
                                                 stash=True, **kw),
                          {"vf_eval_jasmin_stash_tiled_kt": 1}, cta)
            cmp("stash_jasmin", sjas[:3], vf_eval_jasmin(
                x, w, jas_k=LONG_K, stash=True, plain=True, **kw)[:3])
            cmp("l2", routed(lambda: vf_eval(x, wl2, **kw),
                             {"vf_eval_l2_tiled_kt": 1}, cta_l2),
                vf_eval(x, wl2, plain=True, **kw))
            ljas = routed(lambda: vf_eval_jasmin(x, wl2, jas_k=LONG_K, **kw),
                          {"vf_eval_jasmin_l2_tiled_kt": 1}, cta_l2)
            cmp("l2_jasmin", ljas,
                vf_eval_jasmin(x, wl2, jas_k=LONG_K, plain=True, **kw))
            # the backwards
            idx = jas[LONG_K][2]
            bwd = {
                "bwd_g": (w, {}, {"vf_bwd_tiled_kt": 1}),
                "bwd_g_jas": (w, dict(g_jas=gj, jas_idx=idx),
                              {"vf_bwd_tiled_kt": 1}),
                "bwd_g_attn": (w, dict(g_attn=ga, g_jas=gj, jas_idx=idx),
                               {"vf_bwd_tiled_kt": 1}),
                "bwd_drop_g_jas": (w, dict(g_jas=gj, jas_idx=idx, **dkw),
                                   {"vf_bwd_tiled_drop_kt": 1}),
                "bwd_drop_g_attn": (w, dict(g_attn=ga, **dkw),
                                    {"vf_bwd_tiled_drop_kt": 1}),
                "bwd_resid": (w, dict(g_jas=gj, jas_idx=idx,
                                      resid_qkv=sjas[3][0],
                                      resid_h1=sjas[3][1]),
                              {"vf_bwd_resid_tiled_kt": 1}),
                "bwd_l2": (wl2, dict(g_jas=gj, jas_idx=ljas[2]),
                           {"vf_bwd_l2_tiled_kt": 1}),
                "bwd_split": (w4, dict(g_jas=gj, jas_idx=idx),
                              {"vf_bwd_mlp": 1, "vf_bwd_attn_kt": 1,
                               "vf_bwd_split": 1}),
                "bwd_split_drop": (w4, dict(g_attn=ga, **dkw),
                                   {"vf_bwd_mlp_drop": 1,
                                    "vf_bwd_attn_drop_kt": 1,
                                    "vf_bwd_split_drop": 1})}
            repeats = {}
            for name, (wb, extra, counters) in bwd.items():
                got = routed(lambda: vf_bwd(x, wb, gx, **kw, **extra),
                             counters)
                cmp(name, got, vf_bwd(x, wb, gx, plain=True, **kw, **extra))
                if name in ("bwd_g_attn", "bwd_drop_g_jas", "bwd_l2",
                            "bwd_split"):
                    again = routed(lambda: vf_bwd(x, wb, gx, **kw, **extra),
                                   counters)
                    repeats[name] = all(torch.equal(a, c)
                                        for a, c in zip(got, again))
                if name == "bwd_g_attn":
                    clean = got
            r["repeat_bit_identical"] = repeats
            r["fwd_repeat_bit_identical"] = fwd_repeats
            check(all(repeats.values()), f"long bwd not repeatable: "
                  f"{repeats}")
            check(all(fwd_repeats.values()), f"long fwd not repeatable: "
                  f"{fwd_repeats}")
            # NaN and garbage in the padded rows change no real row
            dirty = x.clone()
            dirty[:, n_real:] = float("nan")
            gdirty = gx.clone()
            gdirty[:, n_real:] = 1e30 if dtype == torch.float32 else 3e38
            ddx, dst, didx = vf_eval_jasmin(dirty, w, jas_k=LONG_K, **kw)
            dout, dpmap = vf_eval_attn(dirty, w, **kw, **dkw)
            dbars = vf_bwd(dirty, w, gdirty, g_attn=ga, g_jas=gj,
                           jas_idx=idx, **kw)
            torch.cuda.synchronize()
            r["nan_padding_unchanged"] = (
                torch.equal(real(ddx), real(jas[LONG_K][0]))
                and torch.equal(dst, jas[LONG_K][1])
                and torch.equal(didx, jas[LONG_K][2])
                and torch.equal(real(dout), real(dmap[0]))
                and torch.equal(dpmap, dmap[1])
                and all(torch.equal(a, c) for a, c in zip(dbars, clean)))
            check(r["nan_padding_unchanged"], f"{dtype} n={n_pad}: padded "
                  f"rows reached a real row")
            r["rel_err"] = errs
            check(max(errs.values()) <= tol, f"long {dtype} n={n_pad}: "
                  f"{errs}")
            results.append(r)
    # the bf16 softmax backward's CTAs at head widths other than 64 (Q and
    # cb read from shared memory): 16, 192 (ctx and q_bar in 64-column
    # chunks) and 288 (one K/V slot)
    wide = {}
    n_pad, n_real = LONG_SHAPES[1]
    for wd, wheads in ((32, 2), (768, 4), (1152, 4)):
        ww = long_weights(wd, wheads, wd, g)[torch.bfloat16][0]
        wkw = dict(num_heads=wheads, scaler=4.0, n_real=n_real)
        x = torch.randn(b, n_pad, wd, generator=g, device="cuda")
        x[:, n_real:] = 0
        x = x.to(torch.bfloat16)
        gx = torch.randn(b, n_pad, wd, generator=g, device="cuda") * 1e-2
        gx[:, n_real:] = 0
        gx = gx.to(torch.bfloat16)
        gj = torch.randn(b, wheads, 5, n_pad, generator=g,
                         device="cuda") * 1e-2
        gj[..., n_real:] = 0
        ga = torch.randn(b, wheads, n_pad, n_pad, generator=g,
                         device="cuda") * 1e-2
        ga[:, :, n_real:] = 0
        ga[..., n_real:] = 0
        ga = ga.to(torch.bfloat16)
        # the forward's modes on vft_attn_kt_fwd at this width
        fwd_wide = {
            "plain": (lambda pl: vf_eval(x, ww, plain=pl, **wkw),
                      "vf_eval_tiled_kt"),
            "jasmin": (lambda pl: vf_eval_jasmin(x, ww, jas_k=JASMIN_K,
                                                 plain=pl, **wkw),
                       "vf_eval_jasmin_tiled_kt"),
            "drop_map": (lambda pl: vf_eval_attn(x, ww, plain=pl, **wkw,
                                                 **dkw),
                         "vf_eval_attn_drop_kt")}
        for name, (fn, counter) in fwd_wide.items():
            got = routed(lambda: fn(False), {counter: 1},
                         cta_of(torch.bfloat16, n_pad))
            want = fn(True)
            err = max(rel_err(a[:, :n_real] if a.dim() == 3 else a,
                              c[:, :n_real] if c.dim() == 3 else c)
                      for a, c in zip(flat(got), flat(want))
                      if a.dtype != torch.int32)
            rep_ok = bit_same(got, fn(False))
            wide[f"hd{wd // wheads}_fwd_{name}"] = {
                "rel_err": err, "repeat_bit_identical": rep_ok}
            check(err <= TOL_BF16 and rep_ok, f"long fwd at hd="
                  f"{wd // wheads} {name}: {err}, repeat {rep_ok}")
        idx = vf_eval_jasmin(x, ww, jas_k=LONG_K, **wkw)[2]
        for name, extra, counter in (
                ("g_jas", dict(g_jas=gj, jas_idx=idx), "vf_bwd_tiled_kt"),
                ("drop_all", dict(g_attn=ga, g_jas=gj, jas_idx=idx, **dkw),
                 "vf_bwd_tiled_drop_kt")):
            got = routed(lambda: vf_bwd(x, ww, gx, **wkw, **extra),
                         {counter: 1})
            want = vf_bwd(x, ww, gx, plain=True, **wkw, **extra)
            again = vf_bwd(x, ww, gx, **wkw, **extra)
            err = max(rel_err(a[:, :n_real] if a.dim() == 3 else a,
                              c[:, :n_real] if c.dim() == 3 else c)
                      for a, c in zip(got, want))
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            wide[f"hd{wd // wheads}_{name}"] = {"rel_err": err,
                                               "repeat_bit_identical": same}
            check(err <= TOL_BF16 and same, f"long bwd at hd="
                  f"{wd // wheads} {name}: {err}, repeat {same}")
    resources = {f"{src}:{k}": v
                 for src in ("vector_field_tiled", "vector_field_bwd_split",
                             "macaron_tiled")
                 for k, v in kernel_resources(
                     src, ("vft_attn_kt_bwd", "vft_attn_keys_kt2",
                           "vft_attn_kt_fwd")).items()}
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for v in resources.values()),
          f"the bf16 key-tiled register kernels spill: {resources}")
    for n_pad, n_real in LONG_SHAPES:
        made = macaron_vs_plain(
            f"long_macaron_kernels_vs_plain_{n_pad}", macaron224_model(), b,
            n_real, n_pad, ("macaron_eval_tiled_kt", "macaron_bwd_tiled_kt"),
            lambda: 0)
        for k, v in made.items():
            checked[k] = checked.get(k, 0) + v
    # the Macaron tiled forward's attention CTA: vft_attn_kt_fwd in bf16,
    # the old one in f32, once an evaluation in every mode
    mac = macaron224_model()
    with torch.no_grad():                  # as macaron_vs_plain perturbs it
        for p in mac.vf.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
    n_pad, n_real = LONG_SHAPES[1]
    mkw = dict(num_heads=mac.num_heads, scaler=mac.vf.scaler, n_real=n_real)
    mac_ctas = {}
    for dtype in (torch.bfloat16, torch.float32):
        mcta = cta_of(dtype, n_pad)
        mw = mac.vf.kernel_weights(dtype)
        xm = torch.randn(b, n_pad, mac.embed_dim, generator=g,
                         device="cuda")
        xm[:, n_real:] = 0
        xm = xm.to(dtype)
        for mode, extra in (("plain", {}), ("euler", dict(dt=0.25)),
                            ("base", dict(dt=0.25, base=xm))):
            got = routed(lambda: macaron_eval(xm, mw, mode=mode, **mkw,
                                              **extra),
                         {"macaron_eval_tiled_kt": 1}, mcta)
            err = rel_err(got[:, :n_real], macaron_eval(
                xm, mw, mode=mode, plain=True, **mkw, **extra)[:, :n_real])
            mac_ctas[f"{dtype}_{mode}"] = {"cta": mcta, "rel_err": err}
            check(err <= (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32),
                  f"long Macaron {dtype} {mode}: {err}")
    shapes = long_plans_agree()
    digests = long_kt_digests()
    launch_counts.update(before)           # comparisons do not count
    emit("long_kernels_vs_plain", plans_agree_over_shapes=shapes,
         launches_checked=checked, results=results, other_head_widths=wide,
         macaron_forward_ctas=mac_ctas, register_kernel_resources=resources,
         unchanged_sha256=digests, want_sha256=LONG_KT_SHA256)
    bad = {k: v for k, v in digests.items() if LONG_KT_SHA256.get(k) != v}
    check(not bad, f"outputs changed against LONG_KT_SHA256: {sorted(bad)}")
    return checked, ctas


SDPA_YARDSTICK = ("torch.nn.functional.scaled_dot_product_attention "
                  "forward + backward, B=64, 12 heads, 592 tokens, hd=64, "
                  "bf16, no dropout: not the same function (no JaSMin or "
                  "map cotangent, other dropout bits); a yardstick only, "
                  "never called by the port")


def pair_bound(b: int, n_real: int, n_pad: int, d: int, heads: int):
    """The bf16 key-tiled backward's attention pair (vft_attn_kt_bwd,
    vft_attn_keys_kt2): six head products at the real token count (QK^T,
    P V, cb V^T, s_bar K, s_bar^T q, p^T cb) over the bf16 peak, against
    q, k, v and cb in, ctx and the three cotangents out (bf16) over the
    memory rate; beside it the floor of this design's [B, H, n_pad, n_pad]
    p and s_bar scratch, written once and read once."""
    flops = 6 * 2 * b * n_real * n_real * d
    nbytes = 8 * b * n_real * d * 2
    scratch = 2 * 2 * b * heads * n_pad * n_pad * 2
    bound_ms, bound_by = _bound(flops, nbytes)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "scratch_gb": scratch / 1e9,
            "scratch_floor_ms": scratch / PEAK_BYTES_PER_S * 1e3}


def kt_bwd_launches() -> list:
    """``vft_kt_bwd_launches`` summed over the libraries that launch the
    key-tiled backward attention CTAs: launches so far of [PR 16's
    ``vft_attn_kt_bwd``, ``vft_attn_keys_kt2``, the old ``vft_attn_kt``
    backward, ``vft_attn_keys_kt``]."""
    import ctypes
    from odevit_tpu_torch.kernels.tiled import _library as tiled_library
    from odevit_tpu_torch.kernels.vector_field_bwd_split import \
        _library as split_library
    total = [0] * 4
    for lib in (tiled_library(), split_library()):
        fn = lib.vft_kt_bwd_launches
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        fn.restype = None
        got = (ctypes.c_ulonglong * 4)()
        fn(got)
        total = [a + c for a, c in zip(total, got)]
    return total


def sdpa_fwd_bwd_ms(b: int, heads: int, n: int, hd: int) -> float:
    """``SDPA_YARDSTICK``: one forward and backward of PyTorch's fused
    attention on random bf16 q, k, v, timed by CUDA events."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, go = (torch.randn(b, heads, n, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def run():
        F.scaled_dot_product_attention(q, k, v).backward(go)

    with torch.enable_grad():
        return cuda_ms(run, iters=5)


SDPA_FWD_YARDSTICK = ("torch.nn.functional.scaled_dot_product_attention "
                      "forward, B=64, 12 heads, the 587 real tokens, hd=64, "
                      "bf16, no dropout: the plain mode's attention over "
                      "the real tokens up to p's rounding; a yardstick "
                      "only, never called by the port")


def sdpa_fwd_ms(b: int, heads: int, n: int, hd: int) -> float:
    """``SDPA_FWD_YARDSTICK``: one forward of PyTorch's fused attention on
    random bf16 q, k, v, timed by CUDA events."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(b, heads, n, hd, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       iters=10)


def kt_fwd_launches() -> list:
    """``vft_kt_fwd_launches`` summed over the libraries that launch the
    tiled forwards (the ViTODE and the Macaron routes): launches so far of
    [``vft_attn_kt_fwd``, the old ``vft_attn_kt`` forward]."""
    import ctypes
    from odevit_tpu_torch.kernels.macaron_tiled import \
        _library as mac_library
    from odevit_tpu_torch.kernels.tiled import _library as tiled_library
    total = [0] * 2
    for lib in (tiled_library(), mac_library()):
        fn = lib.vft_kt_fwd_launches
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        fn.restype = None
        got = (ctypes.c_ulonglong * 2)()
        fn(got)
        total = [a + c for a, c in zip(total, got)]
    return total


def attn_only(qkv, heads: int, n_real: int, *, kt: bool, mode="plain",
              jas_kk: int = 0, drop=None, masks: bool = False, mt: int = 64):
    """The bf16 softmax forward's attention launch alone
    (``vft_attn_fwd_only``) on ``qkv`` [B, n_pad, 3D]: with ``kt``
    ``vft_attn_kt_fwd`` whatever n_pad, else the CTA the route takes
    (``mt``: its plan's query-tile rows); ``drop`` a ``dropout.Drop``,
    with ``masks`` also writing mask_p. Returns ctx [B, n_pad, D] and, by
    ``mode``, the statistics and columns or the map, then mask_p."""
    import ctypes
    import torch
    from odevit_tpu_torch.kernels.dropout import Drop
    from odevit_tpu_torch.kernels.tiled import MODES, _Args, _library
    lib = _library()
    fn = lib.vft_attn_fwd_only
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, n, d3 = qkv.shape
    d = d3 // 3
    ctx = torch.empty(b, n, d, device="cuda", dtype=torch.bfloat16)
    extra = {}
    if mode == "jasmin":
        extra = {"stats": torch.empty(b, heads, 5, n, device="cuda"),
                 "idx": torch.empty(b, heads, 4, n, device="cuda",
                                    dtype=torch.int32)}
    elif mode == "attn":
        extra = {"pmap": torch.empty(b, heads, n, n, device="cuda",
                                     dtype=torch.bfloat16)}
    if masks:
        extra["mask_p"] = torch.empty(b, heads, n, n, device="cuda")
    args = _Args(qkv=qkv.data_ptr(), ctx=ctx.data_ptr(),
                 **{k: v.data_ptr() for k, v in extra.items()},
                 batch=b, n_pad=n, n_real=n_real, d=d, heads=heads,
                 mode=MODES[mode], jas_kk=jas_kk, mt=mt,
                 qk_scale=(d // heads) ** -0.5, drop=drop or Drop())
    err = fn(int(kt), ctypes.byref(args),
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"vft_attn_fwd_only: error {err}")
    return (ctx, *extra.values())


def kt_fwd_bound(b: int, n_real: int, d: int, heads: int, mode="plain",
                 kk: int = 0, calls: int = 0, masks: bool = False):
    """(bound_ms, bound_by, bound_unit) of one forward attention launch
    past 256 padded tokens: the function's two head products at the real
    token count (QK^T and P V, as ``vf_bound`` counts the attention; the
    kernel's second QK^T is its own cost, not the function's) over the
    bf16 peak, with ``kk`` JaSMin compare passes over each real row as
    ``jasmin_bound`` counts them, against q, k, v in and ctx out (bf16)
    plus the map (bf16), the statistics or mask_p (f32) over the memory
    rate; beside ``calls`` Philox calls (``with_masks``)."""
    flops = 2 * 2 * b * n_real * n_real * d + b * heads * n_real ** 2 * kk
    nbytes = 4 * b * n_real * d * 2
    if mode == "attn":
        nbytes += b * heads * n_real * n_real * 2
    if mode == "jasmin":
        nbytes += b * heads * n_real * (5 + 4) * 4
    if masks:
        nbytes += b * heads * n_real * n_real * 4
    return with_masks(_bound(flops, nbytes), calls)


# SHA-256 of long_kt_digests()'s outputs, taken on the tree before
# vft_attn_kt_fwd (NVIDIA H100 80GB HBM3): the f32 key-tiled forwards,
# whose attention CTAs (vft_attn_kt) and products (vft_gemm_tf32) neither
# that change nor the bf16 products' redesign (vft_gemm_wgmma) touched,
# must give the same bits. The bf16 outputs it pinned before (the bf16
# backward pair, the split attention half, the L2 forwards) run on the
# bf16 products and changed with them; phase 28a's kernel-vs-plain gates
# hold those. The next change to the f32 key-tiled CTAs deletes it with
# long_kt_digests and pins nothing anew.
LONG_KT_SHA256 = {
    "f32_plain":
        "181fa2f061fdd53fae4b24382d9fb64221580e1d2b547271ce980ee1380ef0af",
    "f32_jasmin":
        "0052e49a6fd559b82a023037ab6ab777242a81a95794ef34023f9bc6a295eca4",
    "f32_map_drop":
        "c5c68622f813199e8f5049ee7a1f804c7a8ff1ca5b33be5704a96ef9092888ab"}


def long_kt_digests() -> dict:
    """SHA-256 of the outputs of the f32 key-tiled forwards (plain, JaSMin
    k=2, map with dropout) at B=2, 587 tokens padded to 592, D=768, 12
    heads, from seed 29."""
    import hashlib
    import torch
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    n_pad, n_real = LONG_SHAPES[1]
    b, d, heads, dh = 2, 768, 12, 768
    g = torch.Generator(device="cuda").manual_seed(29)
    weights = long_weights(d, heads, dh, g)
    # the ratio-4 weights the pin's first version also drew: x is drawn
    # after them, as when the digests were taken
    long_weights(d, heads, 4 * d, g)
    x = torch.randn(b, n_pad, d, generator=g, device="cuda")
    x[:, n_real:] = 0
    kw = dict(num_heads=heads, scaler=4.0, n_real=n_real)
    dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
    w32 = weights[torch.float32][0]
    x32 = x.contiguous()
    cases = {
        "f32_plain": lambda: vf_eval(x32, w32, **kw),
        "f32_jasmin": lambda: vf_eval_jasmin(x32, w32, jas_k=LONG_K, **kw),
        "f32_map_drop": lambda: vf_eval_attn(x32, w32, **kw, **dkw)}
    out = {}
    for name, fn in cases.items():
        got = fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (got if isinstance(got, tuple) else (got,)):
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        out[name] = h.hexdigest()
    return out


def long_kernel_steps(model, images_u8, labels, pre, rng):
    """Three free steps of ``model`` through the kernels alone (the plain
    path is too slow at this batch): ms per step, img/s (best of steps
    2-3), launches per step, the forward attention CTAs of those steps by
    the C counter (``kt_fwd_launches``) and peak memory; then one step
    split by CUDA events into forward, backward and optimizer, and one
    profiled."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.train.fast_steps import (draw_step_seeds,
                                                   fast_free_forward,
                                                   make_fast_free_train_step)
    from odevit_tpu_torch.train.state import (create_train_state,
                                              make_optimizer)
    nb = images_u8.shape[0]
    batch = {"pixel_values": images_u8, "labels": labels}
    state = create_train_state(model, make_optimizer(1e-4))
    step = make_fast_free_train_step(model, jasmin_k=LONG_K,
                                     preprocess_fn=pre)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, losses = [], []
    at = kt_fwd_launches()
    gemm0 = gemm_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, rng=rng)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    ctas = [a - c for a, c in zip(kt_fwd_launches(), at)]
    gemms = gemm_launches() - gemm0
    launches = {k: v for k, v in launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    seeds = draw_step_seeds(rng, state.step, model.num_eval_steps - 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = fast_free_forward(model, pre(images_u8), labels,
                                jasmin_k=LONG_K, step_seeds=seeds)
    ev[1].record()
    loss.backward()
    ev[2].record()
    state.apply_gradients()
    ev[3].record()
    torch.cuda.synchronize()
    profile = profile_step(lambda s, bt: step(s, bt, rng=rng), state, batch)
    return {"ms_per_step": ms, "loss": losses,
            "img_per_s_best_of_2_3": nb / min(ms[1:]) * 1e3,
            "peak_mem_gb": peak, "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in launches.items()},
            "kt_fwd_launches": ctas, "gemm_launches": gemms,
            "split_ms": {"forward": ev[0].elapsed_time(ev[1]),
                         "backward": ev[1].elapsed_time(ev[2]),
                         "optimizer": ev[2].elapsed_time(ev[3])},
            "profile": profile}


def phase_long_train(images_u8, labels):
    """Phase 28b, cell tsbase384-free-train-drop0.1-b64-bf16: the free
    step of the 384 px TS-Base student at dropout 0.1 (``rng=0``; 32 px
    uint8 resized to 384 on the card): 3 steps at B=8 through the kernels
    and through the plain path from the same weights and rng, then 3
    kernel steps at B=64."""
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    pre = make_preprocess(image_size=384, dtype=torch.bfloat16)
    nb = LONG_CHECK_BATCH
    runs, profile, cos, loss_rel, per_step = train_runs(
        images_u8[:nb], labels[:nb], drops=DROP_RATES,
        model_fn=lambda rates: long_student(DROP_RATES), pre=pre,
        jasmin_k=LONG_K)
    check_train("long_train", runs, cos, loss_rel, per_step, LONG_LAUNCHES)
    full = long_kernel_steps(long_student(DROP_RATES), images_u8, labels,
                             pre, DROP_RNG)
    check(all(np.isfinite(v) for v in full["loss"]),
          "long_train: non-finite loss at B=64")
    want = {**{k: 0 for k in full["launches_per_step"]}, **LONG_LAUNCHES}
    check(full["launches_per_step"] == want, f"long_train B=64: launches "
          f"{full['launches_per_step']}")
    check_gemm_route("long_train B=64", full["launches"],
                     full["gemm_launches"])
    # every forward evaluation of the 3 steps launched vft_attn_kt_fwd once
    # and the old forward CTA never, by the C counter; the profiled step
    # ran it (and, by profile_step, no old bf16 softmax vft_attn_kt)
    fwd = TRAIN_STEPS * sum(v for k, v in LONG_LAUNCHES.items()
                            if k.startswith("vf_eval"))
    check(full["kt_fwd_launches"] == [fwd, 0], f"long_train B=64: forward "
          f"attention CTAs (vft_attn_kt_fwd, vft_attn_kt) "
          f"{full['kt_fwd_launches']}, want [{fwd}, 0]")
    ran = " ".join(t["kernel"] for t in full["profile"]["top"])
    check("vft_attn_kt_fwd" in ran,
          f"long_train's profile lacks vft_attn_kt_fwd: {ran}")
    b = images_u8.shape[0]
    emit("long_train_profile", **full.pop("profile"))
    emit("long_train", cell=LONG_TRAIN_CELL, batch=b,
         input="uint8 32x32 resized to 384", tokens="587/592",
         solver="euler-36", jasmin_k=LONG_K, drops=DROP_RATES,
         check_batch=nb, first_grad_cosine=cos, min_cosine=MIN_GRAD_COSINE,
         loss_rel_diff=loss_rel, tol_loss=TOL_TRAIN_LOSS,
         check_launches_per_step=per_step, check_results=runs,
         check_profile=profile, img_per_s=full["img_per_s_best_of_2_3"],
         **full)
    return (full["launches"], runs["kernels"]["wgrad_launches"]["bf16"],
            full["kt_fwd_launches"], full["gemm_launches"])


def phase_long_serving(rng):
    """Phase 28c, cell tsbase384-serve-euler36-b64-bf16: ``fast_forward``
    of the 384 px student at Euler on 36 points (35 key-tiled Euler
    launches per forward) at B=64 on 384 px uint8, against the plain path,
    timed, with its peak memory and its forward attention CTAs by the C
    counter (35 ``vft_attn_kt_fwd``, no old ``vft_attn_kt``); then 16
    engine requests against direct forwards and the B=1 latency."""
    import numpy as np
    import torch
    from odevit_tpu_torch.data.pipeline import make_preprocess
    from odevit_tpu_torch.kernels import launch_counts, reset_launch_counts
    from odevit_tpu_torch.models.fast_forward import fast_forward
    model = long_student()
    images = torch.from_numpy(rng.integers(
        0, 256, (LONG_BATCH, 384, 384, 3), dtype=np.uint8)).cuda()
    x = make_preprocess(image_size=384, dtype=torch.bfloat16)(images)
    b = x.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    at = kt_fwd_launches()
    gemm0 = gemm_launches()
    got = fast_forward(model, x)["logits"]
    torch.cuda.synchronize()
    ctas = [a - c for a, c in zip(kt_fwd_launches(), at)]
    gemms = gemm_launches() - gemm0
    launches = {k: v for k, v in launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == {"vf_eval_euler_tiled_kt": 35},
          f"{LONG_SERVE_CELL}: launches {launches}")
    check_gemm_route(LONG_SERVE_CELL, launches, gemms)
    check(ctas == [35, 0], f"{LONG_SERVE_CELL}: forward attention CTAs "
          f"(vft_attn_kt_fwd, vft_attn_kt) {ctas}, want [35, 0]")
    want = fast_forward(model, x, plain=True)["logits"]
    torch.cuda.synchronize()
    err = rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (b, 100),
          f"{LONG_SERVE_CELL}: logits {got.shape}")
    check(err <= TOL_LOGITS, f"{LONG_SERVE_CELL}: logits rel err {err}")
    check(top1 >= MIN_TOP1_AGREEMENT,
          f"{LONG_SERVE_CELL}: top-1 agreement {top1}")
    ms = cuda_ms(lambda: fast_forward(model, x), iters=3)
    plain_ms = cuda_ms(lambda: fast_forward(model, x, plain=True), iters=1)
    engine = phase_serving_224(model, rng, counter="vf_eval_euler_tiled_kt",
                               evals=35, name="long_serving_engine",
                               image_size=384)
    emit("long_serving", cell=LONG_SERVE_CELL, solver="euler-36",
         tokens="587/592", batch=b, launches=launches, rel_err=err,
         tol=TOL_LOGITS, top1_agreement=top1, ms_per_forward=ms,
         img_per_s=b / ms * 1e3, plain_ms_per_forward=plain_ms,
         plain_img_per_s=b / plain_ms * 1e3, peak_mem_gb=peak,
         kt_fwd_launches=ctas, gemm_launches=gemms,
         engine_launches=engine)
    return launches, model, ctas


def phase_long_kernel_timing(model, images_u8):
    """Phase 28d: each key-tiled instance alone at B=64 on the 384 px
    student's first state (587 tokens padded to 592), against its plain
    version; the dropout instances at the cell's rates, their bounds
    counting the masks' Philox work; the split attention half at dh=3072
    and the Macaron route (f32, D=768, dh=1536) on random states of the
    same shape."""
    import torch
    from odevit_tpu_torch.kernels import launch_counts
    from odevit_tpu_torch.kernels.dropout import drop_spec
    from odevit_tpu_torch.kernels.macaron import macaron_eval
    from odevit_tpu_torch.kernels.macaron_bwd import macaron_bwd
    from odevit_tpu_torch.kernels.vector_field import (vf_eval, vf_eval_attn,
                                                       vf_eval_jasmin)
    from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
    from odevit_tpu_torch.kernels.vector_field_bwd_split import (vf_bwd_attn,
                                                                 vf_bwd_mlp)
    before = dict(launch_counts)
    b, d, dh, heads = LONG_BATCH, 768, 768, 12
    out = {}
    with torch.no_grad():
        x, w, kw = first_state(model, images_u8, image_size=384)
        n_real, n_pad = kw["n_real"], x.shape[1]
        g = torch.Generator(device="cuda").manual_seed(6)
        wl2 = long_weights(d, heads, dh, g)[torch.bfloat16][1]
        w4 = long_weights(d, heads, 4 * d, g)[torch.bfloat16][0]
        dkw = dict(seed=DROP_SEEDS[2], drops=DROP_RATES)
        gx = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        gx[:, n_real:] = 0
        _, _, idx = vf_eval_jasmin(x, w, jas_k=LONG_K, **kw)
        _, _, lidx = vf_eval_jasmin(x, wl2, jas_k=LONG_K, **kw)
        gj = torch.randn(b, heads, 5, n_pad, generator=g,
                         device="cuda") * 1e-3
        gj[..., n_real:] = 0
        ga = (torch.randn(b, heads, n_pad, n_pad, generator=g,
                          device="cuda") * 1e-3).to(torch.bfloat16)
        _, (rqkv, rh1) = vf_eval(x, w, stash=True, **kw)
        xm = torch.zeros(b, n_pad, 768, device="cuda").normal_(
            generator=g).float()
        xbar_m = torch.randn(x.shape, generator=g, device="cuda") * 1e-3
        kk = LONG_K + 1
        calls = dropout_calls(b, n_real, d, dh, heads)
        stb = stash_bounds(b, n_real, d, dh, heads, 2, kk)
        jobs = {
            # the main paths: the training step's and serving's
            "vf_eval_tiled_drop_kt": (
                lambda pl: vf_eval(x, w, plain=pl, **kw, **dkw),
                vf_bound(b, n_real, d, dh, 2), calls),
            "vf_eval_jasmin_tiled_drop_kt": (
                lambda pl: vf_eval_jasmin(x, w, jas_k=LONG_K, plain=pl, **kw,
                                          **dkw),
                jasmin_bound(b, n_real, d, dh, heads, 2, kk), calls),
            "vf_bwd_tiled_drop_kt": (
                lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx, plain=pl,
                                  **kw, **dkw),
                bwd_bound(b, n_real, d, dh, heads, 2), calls),
            "vf_eval_euler_tiled_kt": (
                lambda pl: vf_eval(x, w, mode="euler", dt=1 / 35, plain=pl,
                                   **kw),
                vf_bound(b, n_real, d, dh, 2), 0),
            # the other key-tiled instances
            "vf_eval_tiled_kt": (lambda pl: vf_eval(x, w, plain=pl, **kw),
                                 vf_bound(b, n_real, d, dh, 2), 0),
            "vf_eval_base_tiled_kt": (
                lambda pl: vf_eval(x, w, mode="base", dt=0.5, base=x,
                                   plain=pl, **kw),
                vf_bound(b, n_real, d, dh, 2, states=3), 0),
            "vf_eval_jasmin_tiled_kt": (
                lambda pl: vf_eval_jasmin(x, w, jas_k=LONG_K, plain=pl, **kw),
                jasmin_bound(b, n_real, d, dh, heads, 2, kk), 0),
            "vf_eval_attn_kt": (lambda pl: vf_eval_attn(x, w, plain=pl, **kw),
                                attn_bound(b, n_real, d, dh, heads, 2), 0),
            "vf_eval_attn_drop_kt": (
                lambda pl: vf_eval_attn(x, w, plain=pl, **kw, **dkw),
                attn_bound(b, n_real, d, dh, heads, 2), calls),
            "vf_eval_masks_kt": (
                lambda pl: (lambda f, m: (f, *m))(*vf_eval(
                    x, w, plain=pl, emit_masks=True, **kw, **dkw)),
                masks_bound(b, n_real, d, dh, heads, 2), calls),
            "vf_bwd_tiled_kt": (
                lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx,
                                  g_attn=ga, plain=pl, **kw),
                bwd_bound(b, n_real, d, dh, heads, 2, map_cotangent=True), 0),
            "vf_eval_stash_tiled_kt": (
                lambda pl: (lambda f, r: (f, *resid_rows(r, b, n_pad,
                                                         n_real)))(
                    *vf_eval(x, w, stash=True, plain=pl, **kw)),
                stb["fwd"], 0),
            "vf_eval_jasmin_stash_tiled_kt": (
                lambda pl: (lambda f, s, i, r: (
                    f, s, i, *resid_rows(r, b, n_pad, n_real)))(
                    *vf_eval_jasmin(x, w, jas_k=LONG_K, stash=True, plain=pl,
                                    **kw)),
                stb["jasmin"], 0),
            "vf_bwd_resid_tiled_kt": (
                lambda pl: vf_bwd(x, w, gx, g_jas=gj, jas_idx=idx,
                                  resid_qkv=rqkv, resid_h1=rh1, plain=pl,
                                  **kw), stb["bwd"], 0),
            "vf_eval_l2_tiled_kt": (lambda pl: vf_eval(x, wl2, plain=pl, **kw),
                                    vf_bound(b, n_real, d, dh, 2), 0),
            "vf_eval_jasmin_l2_tiled_kt": (
                lambda pl: vf_eval_jasmin(x, wl2, jas_k=LONG_K, plain=pl,
                                          **kw),
                jasmin_bound(b, n_real, d, dh, heads, 2, kk), 0),
            "vf_bwd_l2_tiled_kt": (
                lambda pl: vf_bwd(x, wl2, gx, g_jas=gj, jas_idx=lidx,
                                  plain=pl, **kw),
                bwd_bound(b, n_real, d, dh, heads, 2), 0),
            "vf_bwd_attn_kt": (
                lambda pl: vf_bwd_attn(x, w4, gx, xbar_m, g_jas=gj,
                                       jas_idx=idx, plain=pl, **kw),
                attn_bwd_bound(b, n_real, d, heads, 2), 0),
            # the split backward's MLP half at this length (it tiles rows:
            # no key-tiled instance)
            "vf_bwd_mlp_592": (
                lambda pl: vf_bwd_mlp(x, w4, gx, plain=pl,
                                      scaler=kw["scaler"], n_real=n_real),
                mlp_bwd_bound(b, n_real, d, 4 * d, 2), 0)}
        out.update(time_jobs(jobs, n_real))
        # the forwards' attention CTA (vft_attn_kt_fwd): one launch an
        # evaluation by the C counter; alone on the state's own qkv (the
        # stash forward's) by CUDA events, beside its bound (the attention
        # site's Philox calls with dropout) and, in the plain mode,
        # PyTorch's fused attention forward
        calls_p = b * heads * n_real * -(-n_real // 4)
        qkv3 = rqkv.view(b, n_pad, 3 * d)
        drop = drop_spec(dkw["seed"], dkw["drops"])
        sdpa_fwd = sdpa_fwd_ms(b, heads, n_real, d // heads)
        fwd_ctas = {
            "vf_eval_tiled_drop_kt": ("plain", 0, calls_p, False),
            "vf_eval_jasmin_tiled_drop_kt": ("jasmin", kk, calls_p, False),
            "vf_eval_euler_tiled_kt": ("plain", 0, 0, False),
            "vf_eval_tiled_kt": ("plain", 0, 0, False),
            "vf_eval_base_tiled_kt": ("plain", 0, 0, False),
            "vf_eval_jasmin_tiled_kt": ("jasmin", kk, 0, False),
            "vf_eval_attn_kt": ("attn", 0, 0, False),
            "vf_eval_attn_drop_kt": ("attn", 0, calls_p, False),
            "vf_eval_masks_kt": ("plain", 0, calls_p, True),
            "vf_eval_stash_tiled_kt": ("plain", 0, 0, False),
            "vf_eval_jasmin_stash_tiled_kt": ("jasmin", kk, 0, False)}
        for name, (mode, k_, calls_, masks) in fwd_ctas.items():
            at = kt_fwd_launches()
            jobs[name][0](False)
            torch.cuda.synchronize()
            took = [a - c for a, c in zip(kt_fwd_launches(), at)]
            check(took == [1, 0], f"{name}: forward attention CTAs "
                  f"(vft_attn_kt_fwd, vft_attn_kt) {took}")
            bound_ms, bound_by, unit = kt_fwd_bound(
                b, n_real, d, heads, mode, k_, calls_, masks)
            out[name]["cta"] = {
                "kernel": "vft_attn_kt_fwd",
                "ms": cuda_ms(lambda: attn_only(
                    qkv3, heads, n_real, kt=True, mode=mode,
                    jas_kk=k_, drop=drop if calls_ else None,
                    masks=masks), iters=10),
                "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_unit": unit,
                "library_ms": sdpa_fwd if name == "vf_eval_tiled_kt"
                else None,
                "library_call": SDPA_FWD_YARDSTICK
                if name == "vf_eval_tiled_kt" else None}
        # the bf16 softmax backwards' kernels, each launch's device time;
        # for the attention pair (vft_attn_kt_bwd, vft_attn_keys_kt2) its
        # own bound and the floor of its p and s_bar scratch
        yardstick = sdpa_fwd_bwd_ms(b, heads, n_pad, d // heads)
        for name in ("vf_bwd_tiled_drop_kt", "vf_bwd_tiled_kt",
                     "vf_bwd_resid_tiled_kt", "vf_bwd_attn_kt"):
            # which key-tiled CTAs one backward launched, by the libraries'
            # own counts: PR 16's pair, and no old CTA
            kt0 = kt_bwd_launches()
            jobs[name][0](False)
            torch.cuda.synchronize()
            took = [a - c for a, c in zip(kt_bwd_launches(), kt0)]
            check(took[0] > 0 and took[1] > 0 and took[2] == took[3] == 0,
                  f"{name}: key-tiled backward CTAs launched (pair, its "
                  f"key CTA, old, old key CTA): {took}")
            # the profiler may drop a kernel's events from a window: the
            # kernels of up to 8 windows, each with its first window's time
            parts = {}
            for _ in range(8):
                for k, v in kernel_parts(lambda: jobs[name][0](False)).items():
                    parts.setdefault(k, v)
                new = [k for k in parts
                       if "vft_attn_kt_bwd" in k or "vft_attn_keys_kt2" in k]
                if len(new) == 2:
                    break
            out[name]["kt_bwd_launches"] = took
            out[name]["parts"] = parts
            out[name]["pair"] = {
                "kernels": new,
                # null where the profiler dropped one of the pair's events
                # from every window
                "ms": sum(parts[k]["ms_per_launch"] for k in new)
                if len(new) == 2 else None,
                **pair_bound(b, n_real, n_pad, d, heads),
                "library_ms": yardstick,
                "library_call": SDPA_YARDSTICK}
        mw = macaron224_model().vf.kernel_weights(torch.float32)
        mkw = dict(num_heads=heads, scaler=1.0, n_real=n_real)
        xm[:, n_real:] = 0
        gm = (xm * 1e-2).contiguous()
        mjobs = {
            "macaron_eval_tiled_kt": (
                lambda pl: macaron_eval(xm, mw, plain=pl, **mkw),
                macaron_bound(b, n_real, d, 1536, 4), 0),
            "macaron_bwd_tiled_kt": (
                lambda pl: macaron_bwd(xm, mw, gm, plain=pl, **mkw),
                macaron_bound(b, n_real, d, 1536, 4, backward=True), 0)}
        for name, (fn, bound, calls_) in mjobs.items():
            got, want = fn(False), fn(True)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [rel_err(a[:, :n_real] if a.dim() == 3 else a,
                            c[:, :n_real] if c.dim() == 3 else c)
                    for a, c in zip(got, want)]
            check(max(errs) <= TOL_F32, f"{name}: {errs}")
            out[name] = {
                "max_abs_err": max((a.float() - c.float()).abs().max().item()
                                   for a, c in zip(got, want)),
                "rel_errs": errs, "ms": cuda_ms(lambda: fn(False), iters=3),
                "plain_ms": cuda_ms(lambda: fn(True), iters=1),
                "bound_ms": bound[0], "bound_by": bound[1],
                "bound_unit": "f32", "library_ms": None}
    probe = kt_fwd_whole_row_probe()
    launch_counts.update(before)           # comparisons do not count
    emit("long_kernel_timing", shape=f"B={b} n={n_real}/{n_pad} D=768 H=12 "
         f"dh=768 bf16 (split half dh=3072; Macaron f32 dh=1536)",
         drops=DROP_RATES, philox_calls=calls, results=out)
    emit("kt_fwd_whole_row_probe", **probe)
    return out


def kt_fwd_whole_row_probe():
    """``vft_attn_kt_fwd`` at the 224 px whole-row shape (B=64, 207
    tokens padded to 208, D=768, 12 heads, bf16), where the route takes
    ``vft_attn``: both launched alone (``attn_only``) on the same random
    qkv, plain and JaSMin (k=2) modes, timed by CUDA events and held
    against each other (ctx, statistics within 2e-2 of max|vft_attn|).
    For the next redesign; no path launches the new CTA here."""
    import torch
    from odevit_tpu_torch.kernels.tiled import tiled_plan
    b, n_pad, n_real, d, heads = 64, 208, 207, 768, 12
    g = torch.Generator(device="cuda").manual_seed(31)
    qkv = torch.randn(b, n_pad, 3 * d, generator=g, device="cuda").to(
        torch.bfloat16)
    mt = tiled_plan(torch.bfloat16, n_pad, n_real, d, heads, d)[0]
    out = {"shape": f"B={b} n={n_real}/{n_pad} D={d} H={heads} bf16",
           "whole_row_mt": mt}
    for mode, kk in (("plain", 0), ("jasmin", LONG_K + 1)):
        run = lambda kt: attn_only(qkv, heads, n_real, kt=kt, mode=mode,
                                   jas_kk=kk, mt=mt)
        row, new = run(False), run(True)
        torch.cuda.synchronize()
        errs = [rel_err(a[:, :n_real] if a.dim() == 3 else a,
                        c[:, :n_real] if c.dim() == 3 else c)
                for a, c in zip(new, row) if a.dtype != torch.int32]
        check(max(errs) <= TOL_BF16, f"whole-row probe {mode}: {errs}")
        out[mode] = {"vft_attn_ms": cuda_ms(lambda: run(False), iters=10),
                     "vft_attn_kt_fwd_ms": cuda_ms(lambda: run(True),
                                                   iters=10),
                     "rel_errs": errs}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from odevit_tpu_torch.models.vit_ode import ViTODE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--rows"]:
        # the rows kernel alone (phase_rows_bf16_only), and nothing else
        rng = np.random.default_rng(0)
        phase_rows_bf16_only(torch.from_numpy(rng.integers(
            0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)).cuda())
        return 0

    smi = phase_card()
    wgrad = phase_wgrad_vs_plain()
    bf16_gemm = phase_bf16_gemm_vs_plain()
    models = {
        "euler-49": ViTODE(**SHAPE, num_eval_steps=49, solver="euler",
                           dtype=torch.bfloat16, device="cuda", seed=0),
        "rk4-13": ViTODE(**SHAPE, num_eval_steps=13, solver="rk4",
                         dtype=torch.bfloat16, device="cuda", seed=0),
    }
    phase_kernel_vs_plain(models["euler-49"])
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)).cuda()
    x, report = phase_main_path(models, images)
    timing = phase_vf_timing(models["euler-49"], x)
    phase_serving(models["euler-49"], rng)
    phase_train_kernels_vs_plain(models["rk4-13"])
    bf16_bwd_plans_vs_plain()
    labels = torch.from_numpy(rng.integers(0, 100, BATCH)).cuda()
    train_launches, train = phase_train(images, labels)
    train_timing = phase_train_kernel_timing(models["rk4-13"], images)
    train_f32 = phase_train_f32(images, labels)
    f32_timing = phase_train_f32_kernel_timing(images)
    # the dropout slice at the CIFAR shape
    mask_launches = phase_dropout_masks(models["rk4-13"])
    phase_dropout_kernels_vs_plain(models["rk4-13"])
    drop_launches = phase_train_dropout(images, labels, train)
    drop_timing = phase_dropout_kernel_timing(models["rk4-13"], images)
    # the fused steps' map route (short sequences), and the emit_masks
    # instance at tpu_dropout_check.py's shape
    map_launches = phase_map_route(images, labels)
    masks_check_launches = phase_dropout_check()
    # L2 attention at the CIFAR shape: kernels, serving, the l2_b1024 step
    phase_l2_kernels_vs_plain()
    l2_serve_launches = phase_l2_serving(images, report, rng)
    l2_launches = phase_l2_train(images, labels, train)
    l2_timing = phase_l2_kernel_timing(images)
    # the Macaron family at the CIFAR shape: serving and the macaron_b1024
    # step, on the kernels' float32 instances
    phase_macaron_kernels_vs_plain()
    mac_serve = phase_macaron_serving(images, rng)
    mac_train = phase_macaron_train(images, labels)
    mac_timing = phase_macaron_kernel_timing(images)
    cifar_euler = models["euler-49"]
    del models
    # the distillation slice at the TS-Base shape
    from odevit_tpu_torch.teacher.vit import ViTTeacher
    student = distill_student()
    phase_distill_kernels_vs_plain(student)
    rng_d = np.random.default_rng(0)
    # the recipe's data: 32 px CIFAR-100 images, resized to 224 on the card
    images_d = torch.from_numpy(rng_d.integers(
        0, 256, (DISTILL_BATCH, 32, 32, 3), dtype=np.uint8)).cuda()
    labels_d = torch.from_numpy(rng_d.integers(0, 100, DISTILL_BATCH)).cuda()
    teacher = ViTTeacher.dino_b16(device="cuda", seed=1)
    distill_launches, distill = phase_distill(teacher, images_d, labels_d,
                                              rng_d)
    distill_timing = phase_distill_kernel_timing(student, images_d)
    distill_f32 = phase_distill_f32(teacher, images_d, labels_d)
    # the distillation step at the recipe's dropout, beside drop 0
    phase_distill_dropout_kernels_vs_plain(student)
    ddrop_launches = phase_distill_dropout(teacher, images_d, labels_d,
                                           distill)
    ddrop_timing = phase_distill_kernel_timing(student, images_d,
                                               DROP_RATES)
    # JAX's headline distillation cell: the ratio-4 student, whose
    # backward takes the split route, fed 224 px images
    r4 = r4_student()
    phase_split_kernels_vs_plain(r4, student)
    images_r4 = torch.from_numpy(rng_d.integers(
        0, 256, (DISTILL_BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    r4_launches, r4_runs = phase_distill_r4(teacher, images_r4, labels_d)
    r4_timing = phase_distill_r4_kernel_timing(r4, images_r4)
    r4_drop_launches, _ = phase_distill_r4(teacher, images_r4, labels_d,
                                           DROP_RATES, r4_runs)
    r4_drop_timing = phase_distill_r4_kernel_timing(r4, images_r4,
                                                    DROP_RATES)
    # residual stashing on the three routes: the stash arms of the CIFAR
    # free step and of both TS-Base distillation steps
    del student, r4
    phase_stash_kernels_vs_plain()
    stash_launches = phase_stash_train(images, labels, teacher, images_d,
                                       labels_d, images_r4)
    stash_timing = phase_stash_kernel_timing(images, images_d, images_r4)
    del teacher
    # L2 attention past one CTA: the TS-Base student with l2_attention,
    # trained (32 px resized on the card) and served (224 px)
    phase_l2_kernels_vs_plain(tsbase=True)
    tsl2_launches = phase_tsbase_l2_train(images_d, labels_d)
    tsl2_timing = phase_l2_kernel_timing(images_d, tsbase=True)
    tsl2_serve = phase_tsbase_l2_serving(images_r4, rng_d)
    # the Macaron family past one CTA: experiment_vit_edo.yaml's width as
    # a ViTMacaron, trained and served at 224 px (32 px resized on the card)
    phase_tf32_gemm_vs_plain()
    phase_macaron224_kernels_vs_plain()
    mac224_launches = phase_macaron224_train(images_d, labels_d)
    mac224_timing = phase_macaron224_kernel_timing(images_d)
    mac224_serve = phase_macaron224_serving(images_d, rng_d)
    # the serving slice at 224 px, and the chained Euler kernel
    rng_s = np.random.default_rng(2)
    x224, serve224, students = phase_serve_224(rng_s)
    euler25 = students["tsbase-serve-euler25-b64-bf16"]
    serve224_timing = phase_serve_224_kernel_timing(euler25, x224)
    chain_launches, chain_timing = phase_chain_vs_per_step(
        cifar_euler, x, euler25, x224)
    phase_serving_224(euler25, rng_s)
    # phase 28: sequences past 256 padded tokens (the key-tiled attention),
    # the TS-Base student at 384 px trained (32 px resized on the card) and
    # served
    del euler25, students
    long_checked, long_checked_ctas = phase_long_kernels_vs_plain()
    long_train, long_train_wgrad, long_train_ctas, long_train_gemms = \
        phase_long_train(images_d, labels_d)
    long_serve, long_model, long_serve_ctas = phase_long_serving(
        np.random.default_rng(3))
    long_timing = phase_long_kernel_timing(long_model, images_d)
    del long_model

    kernels = [{
        "name": "vf_eval", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field.cu",
        "replaces": "odevit_tpu/kernels/vector_field.py:196",
        "launches": report["euler-49"]["launches"],
        "launches_train": train_launches["vf_eval"],
        **timing, "library_ms": None}, {
        "name": "vf_eval_jasmin", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field.cu",
        "replaces": "odevit_tpu/kernels/vector_field.py:196",
        "launches": train_launches["vf_eval_jasmin"],
        **train_timing["vf_eval_jasmin"], "library_ms": None}, {
        "name": "vf_bwd", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field_bwd.cu",
        "replaces": "odevit_tpu/kernels/vector_field_bwd.py:117",
        "launches": train_launches["vf_bwd"],
        **{k: v for k, v in train_timing["vf_bwd"].items()
           if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", ROWS_BF16, ROWS_BF16 + "_no_jas")},
        "rows_bf16_launches": train["kernels"]["rows_bf16_launches"],
        "library_ms": None}]
    # the f32 one-CTA kernels on the f32 cell's path (its 3 kernel steps;
    # vf_kernel_f32 and vfb_rows_f32 by their C counters beside), timed at
    # its state
    f32_path = train_f32["kernels"]
    for name, case, counter, source, replaces, kernel in (
            ("vf_eval_f32", "base", "vf_eval", "vector_field.cu",
             "vector_field.py:196", "vf_kernel_f32"),
            ("vf_eval_jasmin_f32", "jasmin", "vf_eval_jasmin",
             "vector_field.cu", "vector_field.py:196", "vf_kernel_f32"),
            ("vf_bwd_f32", "bwd_jas", "vf_bwd", "vector_field_bwd.cu",
             "vector_field_bwd.py:117", "vfb_rows_f32")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"odevit_tpu_torch/csrc/{source}",
            "replaces": f"odevit_tpu/kernels/{replaces}", "kernel": kernel,
            "launches": f32_path["launches"][counter],
            "launches_of": F32_TRAIN_CELL,
            "kernel_launches": f32_path["f32_cta_launches"][
                "bwd" if kernel == "vfb_rows_f32" else "fwd"],
            **{k: v for k, v in f32_timing[case].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "tf32_floor_ms", "tf32_pass_tflops",
                        "vfb_rows_f32_ms", "vfb_rows_f32_tf32_floor_ms",
                        "vfb_rows_f32_tf32_pass_tflops")},
            "library_ms": None})
    tiled_timing = {**distill_timing, **ddrop_timing}
    for name in (*DISTILL_LAUNCHES, *DISTILL_DROP_LAUNCHES):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "odevit_tpu_torch/csrc/vector_field_tiled.cu",
            "replaces": ("odevit_tpu/kernels/vector_field_bwd.py:117"
                         if name.startswith("vf_bwd")
                         else "odevit_tpu/kernels/vector_field.py:196"),
            "launches": (distill_launches if name in DISTILL_LAUNCHES
                         else ddrop_launches)[name],
            **{k: v for k, v in tiled_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_unit", "library_ms")}})
    for name, source, replaces in (
            ("vf_eval_drop", "vector_field.cu", "vector_field.py:196"),
            ("vf_eval_jasmin_drop", "vector_field.cu", "vector_field.py:196"),
            ("vf_bwd_drop", "vector_field_bwd.cu", "vector_field_bwd.py:117"),
            ("dropout_masks", "dropout_masks.cu", "vector_field.py:121")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"odevit_tpu_torch/csrc/{source}",
            "replaces": f"odevit_tpu/kernels/{replaces}",
            # the generator's path is generate_dropout_masks (the
            # dropout_masks phase); the others', the dropout train step
            "launches": (mask_launches if name == "dropout_masks"
                         else drop_launches[name]),
            **{k: v for k, v in drop_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_unit", "library_ms",
                        ROWS_BF16)}})
    for name, cell in (
            ("vf_eval_euler_tiled", "tsbase-serve-euler25-b64-bf16"),
            ("vf_eval_base_tiled", "tsbase-serve-rk4-7-b64-bf16")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "odevit_tpu_torch/csrc/vector_field_tiled.cu",
            "replaces": "odevit_tpu/kernels/vector_field.py:196",
            "launches": serve224[cell]["launches"][name],
            **{k: v for k, v in serve224_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}})
    kernels.append({
        "name": "vf_euler_chain", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field.cu",
        "replaces": "odevit_tpu/kernels/vector_field.py:741",
        "launches": chain_launches,
        **{k: v for k, v in chain_timing.items()
           if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
    split_timing = {**r4_timing, **r4_drop_timing}
    for name, line in (("vf_bwd_mlp", 350), ("vf_bwd_attn", 432)):
        for sfx, launches in (("", r4_launches), ("_drop", r4_drop_launches)):
            kernels.append({
                "name": name + sfx, "route": "cuda",
                "source": "odevit_tpu_torch/csrc/vector_field_bwd_split.cu",
                "replaces": f"odevit_tpu/kernels/vector_field_bwd.py:{line}",
                "launches": launches[name + sfx],
                **{k: v for k, v in split_timing[name + sfx].items()
                   if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "bound_unit", "library_ms")}})
    for name in ("vf_eval_l2", "vf_eval_jasmin_l2", "vf_bwd_l2"):
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("odevit_tpu_torch/csrc/vector_field_bwd.cu"
                       if name.startswith("vf_bwd")
                       else "odevit_tpu_torch/csrc/vector_field.cu"),
            "replaces": ("odevit_tpu/kernels/vector_field_bwd.py:117"
                         if name.startswith("vf_bwd")
                         else "odevit_tpu/kernels/vector_field.py:196"),
            # the L2 cell's 3 training steps; serving's forward beside it
            "launches": l2_launches[name],
            **({"launches_serve": l2_serve_launches[name]}
               if name == "vf_eval_l2" else {}),
            **{k: v for k, v in l2_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", ROWS_BF16)},
            "library_ms": None})
    for name, source, line in (("macaron_eval", "macaron.cu", 45),
                               ("macaron_bwd", "macaron_bwd.cu", 218)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"odevit_tpu_torch/csrc/{source}",
            "replaces": f"odevit_tpu/kernels/macaron.py:{line}",
            # the Macaron train cell's 3 steps (float32 instance); serving's
            # rk4-13 forward beside it, and the bf16 instance's numbers; the
            # forward's f32 kernel by its C counter, each mode's times
            "launches": mac_train["launches"][name],
            **({"launches_serve": mac_serve["rk4-13"]["launches"][name],
                "kernel": "mac_kernel_f32",
                "kernel_launches": mac_train["mac_kernel_f32_launches"],
                "kernel_launches_serve":
                    mac_serve["rk4-13"]["mac_kernel_f32_launches"]}
               if name == "macaron_eval" else {}),
            **{k: v for k, v in mac_timing["torch.float32"][name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "tf32_floor_ms", "parts", "modes",
                        "resources")},
            "library_ms": None,
            "bf16": {k: v for k, v in mac_timing["torch.bfloat16"][name]
                     .items() if k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")}})
    for name in ("vf_eval_l2_tiled", "vf_eval_jasmin_l2_tiled",
                 "vf_bwd_l2_tiled"):
        bwd = name.startswith("vf_bwd")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "odevit_tpu_torch/csrc/vector_field_tiled.cu",
            "replaces": ("odevit_tpu/kernels/vector_field_bwd.py:117" if bwd
                         else "odevit_tpu/kernels/vector_field.py:196"),
            # the TS-Base L2 cell's 3 training steps; serving's forward
            # beside it
            "launches": tsl2_launches[name],
            **({"launches_serve": tsl2_serve[name]}
               if name == "vf_eval_l2_tiled" else {}),
            **{k: v for k, v in tsl2_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")},
            "library_ms": None})
    for name, line in (("macaron_eval_tiled", 45),
                       ("macaron_bwd_tiled", 218)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "odevit_tpu_torch/csrc/macaron_tiled.cu",
            "replaces": f"odevit_tpu/kernels/macaron.py:{line}",
            # the 224 px Macaron train cell's 3 steps (f32 instance);
            # serving's euler-24 forward beside it, and the bf16 numbers
            "launches": mac224_launches[name],
            **({"launches_serve": mac224_serve["euler-24"]["launches"][name]}
               if name == "macaron_eval_tiled" else {}),
            **{k: v for k, v in mac224_timing["torch.float32"][name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")},
            "library_ms": None,
            "bf16": {k: v for k, v in mac224_timing["torch.bfloat16"][name]
                     .items() if k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")}})
    kernels.append({
        "name": "vf_eval_masks", "route": "cuda",
        "source": "odevit_tpu_torch/csrc/vector_field_tiled.cu",
        "replaces": "odevit_tpu/kernels/vector_field.py:221",
        # the dropout check's run; timed at the TS-Base dropout cell's
        # state (B=64)
        "launches": masks_check_launches,
        **{k: v for k, v in ddrop_timing["vf_eval_masks"].items()
           if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_unit", "library_ms")}})
    stash_cells = list(STASH_LAUNCHES)
    for name, source, replaces, cell in (
            ("vf_eval_stash", "vector_field.cu", "vector_field.py:196", 0),
            ("vf_eval_jasmin_stash", "vector_field.cu",
             "vector_field.py:196", 0),
            ("vf_bwd_resid", "vector_field_bwd.cu", "vector_field_bwd.py:117",
             0),
            ("vf_eval_stash_tiled", "vector_field_tiled.cu",
             "vector_field.py:196", 1),
            ("vf_eval_jasmin_stash_tiled", "vector_field_tiled.cu",
             "vector_field.py:196", 1),
            ("vf_bwd_resid_tiled", "vector_field_tiled.cu",
             "vector_field_bwd.py:117", 1),
            ("vf_bwd_mlp_resid", "vector_field_bwd_split.cu",
             "vector_field_bwd.py:350", 2),
            ("vf_bwd_attn_resid", "vector_field_bwd_split.cu",
             "vector_field_bwd.py:432", 2)):
        entry = {
            "name": name, "route": "cuda",
            "source": f"odevit_tpu_torch/csrc/{source}",
            "replaces": f"odevit_tpu/kernels/{replaces}",
            # the stash arm's 3 steps of its cell (stash_train)
            "launches": stash_launches[stash_cells[cell]][name],
            **{k: v for k, v in stash_timing[name].items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", ROWS_BF16)}}
        if name.startswith("vf_eval") and cell == 1:
            # the ratio-4 cell's stash forwards, timed at its state
            entry["launches_r4"] = stash_launches[stash_cells[2]][name]
        kernels.append(entry)
    for entry in kernels:
        # the map route's launches (3 steps each, ± dropout) beside the
        # distillation cells'
        if entry["name"] in map_launches:
            entry["launches_map_route"] = map_launches[entry["name"]]
    for name, entry in long_timing.items():
        # the key-tiled instances: launches on the slice's main paths (the
        # 384 px cells), else those held against the plain versions in
        # phase 28a
        path, launches = (
            (LONG_TRAIN_CELL, long_train[name]) if name in long_train else
            (LONG_SERVE_CELL, long_serve[name]) if name in long_serve else
            ("long_kernels_vs_plain",
             long_checked[name.removesuffix("_592")]))
        source, replaces = (
            ("vector_field_bwd_split.cu", "vector_field_bwd.py:350")
            if name.startswith("vf_bwd_mlp") else
            ("macaron_tiled.cu", "macaron.py:218") if name.startswith(
                "macaron_bwd") else
            ("macaron_tiled.cu", "macaron.py:45") if name.startswith(
                "macaron") else
            ("vector_field_bwd_split.cu", "vector_field_bwd.py:432")
            if name.startswith("vf_bwd_attn") else
            ("vector_field_tiled.cu", "vector_field_bwd.py:117")
            if name.startswith("vf_bwd") else
            ("vector_field_tiled.cu", "vector_field.py:221")
            if name.startswith("vf_eval_masks") else
            ("vector_field_tiled.cu", "vector_field.py:196"))
        if "cta" in entry:
            # the forward attention CTAs (vft_attn_kt_fwd, the old
            # vft_attn_kt) by the C counter on that same path (phase 28a:
            # its calls that counted this name, bf16 and f32)
            entry["cta"]["kt_fwd_launches"] = (
                long_train_ctas if path == LONG_TRAIN_CELL else
                long_serve_ctas if path == LONG_SERVE_CELL else
                long_checked_ctas[name])
            entry["cta"]["kt_fwd_launches_of"] = path
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"odevit_tpu_torch/csrc/{source}",
            "replaces": f"odevit_tpu/kernels/{replaces}",
            "launches": launches, "launches_of": path,
            **{k: v for k, v in entry.items()
               if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bound_unit", "library_ms", "parts",
                        "pair", "cta")}})
    # the weight products at each cell's shape: launches on that cell's
    # training path (3 kernel steps, the C counter), else in this phase
    wgrad_paths = {
        ("bf16", "cifar"): ("cifar100-vitode-train-b1024-bf16", train),
        ("bf16", "tsbase224"): ("tsref-distill-b64-bf16", distill),
        ("bf16", "r4_attn"): ("tsbase-r4-distill-b64-bf16", r4_runs),
        ("bf16", "r4_mlp"): ("tsbase-r4-distill-b64-bf16", r4_runs),
        ("f32", "cifar"): (F32_TRAIN_CELL, train_f32),
        ("f32", "tsbase224"): (F32_DISTILL_CELL, distill_f32)}
    for kind, cells in wgrad.items():
        for label, case in cells.items():
            # the ratio-4 cell's backwards are split halves, one launch
            # each; the bf16 Macaron backward is on no training path (the
            # Macaron cells run f32 states), nor are the f32 ratio-4 and
            # 384 px backwards: the launches over the phase's checked calls
            if (kind, label) in wgrad_paths:
                path, runs = wgrad_paths[kind, label]
                launches = runs["kernels"]["wgrad_launches"][kind]
                if label.startswith("r4"):
                    launches //= 2
            elif (kind, label) == ("bf16", "tsbase384"):
                path, launches = LONG_TRAIN_CELL + " (B=8)", long_train_wgrad
            else:
                path, launches = "wgrad_vs_plain", case["launches"]
            kernels.append(wgrad_entry(kind, label, case, path, launches))
    # the route's bf16 products at each cell's shape: launches on that
    # cell's main path (its 3 kernel steps, the C counter)
    gemm_paths = {"224px": distill["kernels"]["gemm_launches"],
                  "384px": long_train_gemms,
                  "r4": r4_runs["kernels"]["gemm_launches"]}
    for cell, products in bf16_gemm.items():
        kernels.append(bf16_gemm_entry(cell, products, gemm_paths[cell]))
    check(len(kernels) == 44 + len(long_timing) + len(WGRAD_SHAPES)
          + len(WGRAD_F32_SHAPES) + len(BF16_GEMM_CELLS),
          f"{len(kernels)} kernels in the line")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
