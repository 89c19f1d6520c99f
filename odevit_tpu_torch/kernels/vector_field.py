"""One fused evaluation of the ODE-ViT vector field.

``vf_eval`` launches the CUDA kernel of ``csrc/vector_field.cu`` (the
counterpart of the TPU kernel ``odevit_tpu/kernels/vector_field.py::
_vf_kernel``) on a CUDA tensor, and runs its plain PyTorch version
``vf_eval_plain`` on a CPU tensor. Three modes:

  * ``"plain"``: ``f(x)``;
  * ``"euler"``: ``x + dt * f(x)``, with ``f`` not rounded first;
  * ``"base"``: ``base + dt * f(x)`` (the Kutta-3/8 stage advance).

``vf_eval_jasmin`` (plain version ``vf_eval_jasmin_plain``) is the same
kernel in its JaSMin-statistics mode, the counterpart of
``fused_vf_jasmin``: ``f(x)`` and the ``[B, H, 5, n_pad]`` order
statistics of the attention rows, with the columns they came from.
``vf_eval_attn`` (plain version ``vf_eval_attn_plain``) is its
attention-map mode, the counterpart of ``fused_vf_attn``: ``f(x)`` and the
maps ``[B, H, n_pad, n_pad]`` in the compute dtype, zeros on padded query
rows and padded keys.

``vf_euler_chain`` (plain version ``vf_euler_chain_plain``) runs
``chain`` Euler steps, the counterpart of ``fused_euler_chain_from_params``
(``_vf_euler_chain_kernel``): one launch of the kernel's chained instance
where one image fits one CTA, else the tiled Euler mode once per step.

Routes. Where one image fits one CTA (``kernel_plan``), every mode but the
attention map launches the one-image-per-CTA kernel of
``csrc/vector_field.cu``. Elsewhere (the 224 px TS-Base shape: 207 tokens,
D=768) the plain, Euler, stage-advance and JaSMin modes launch the tiled
route, ``csrc/vector_field_tiled.cu`` (``kernels/tiled.py``), which also
carries the attention-map mode at every shape (down to 16 padded tokens:
the fused steps' map route on short sequences). Each route counts its
launches under its own name: ``vf_eval`` (every mode of ``vf_eval`` on
one CTA per image), ``vf_eval_tiled``, ``vf_eval_euler_tiled``,
``vf_eval_base_tiled``, ``vf_eval_jasmin`` and so on.

``x`` is the padded token tensor ``[B, n_pad, D]`` (``n_pad`` a multiple of
:data:`TOKEN_PAD`); tokens ``>= n_real`` are padding: they receive no
attention, and whatever they hold never reaches a real token.

L2 attention. Weights with biases (``VFWeights.qkv_bias`` and
``out_bias``, the counterparts of ``fused_vf_l2`` and
``fused_vf_l2_jasmin``) make the attention ``p = e / (sum(e) + 1e-8)``
with ``e = exp(-(q2 + k2 - 2 q.k) / sqrt(hd))`` over the real keys, no
max-subtraction, and add the biases to qkv (before it is rounded) and to
attn_o. As in the TPU kernel, only the plain and JaSMin modes exist for
it, without dropout or maps. Where one image fits one CTA (:func:`l2_plan`)
they launch the one-image-per-CTA kernel's L2 instance (``vf_eval_l2``,
``vf_eval_jasmin_l2``), elsewhere the tiled route's
(``vf_eval_l2_tiled``, ``vf_eval_jasmin_l2_tiled``; the 224 px TS-Base
student, and past 256 padded tokens the tiled route's key-tiled
instances). :func:`l2_route` decides, by the same rule on either device;
a shape with neither plan (sizes that are not multiples of 16) raises.

Dropout. ``vf_eval`` and ``vf_eval_jasmin`` take ``seed`` and ``drops`` =
(attn_drop, proj_drop, mlp_drop), the counterparts of ``fused_vf_dropout``
and ``fused_vf_jasmin_dropout``: inverted dropout on gelu(h), mlp_o,
attn_o and the attention probabilities, with the masks of
``kernels/dropout.py`` (the JaSMin statistics stay those of the
pre-dropout p). ``vf_eval_attn`` takes them too, the counterpart of
``fused_vf_attn_dropout``: its maps are the pre-dropout p. Rates of 0 take
the deterministic route whatever the seed; nonzero rates without a seed
raise. On the GPU they launch the kernels' dropout instances, counted as
``vf_eval_drop`` and ``vf_eval_jasmin_drop`` (one image per CTA) and
``vf_eval_tiled_drop``, ``vf_eval_jasmin_tiled_drop`` and
``vf_eval_attn_drop`` (the tiled route). The Euler and stage-advance
modes have no dropout instance, as in the TPU kernel: with a nonzero rate
they raise.

Residual stash. ``vf_eval`` and ``vf_eval_jasmin`` with ``stash=True``
(the TPU kernel's ``emit_resid``, behind ``fused_vf_stash`` and
``fused_vf_jasmin_stash``; plain and JaSMin modes, softmax, no dropout)
also return ``(rqkv, rh1)``, in JAX's padded 2-D row layout and the
compute dtype: rqkv [B * n_pad, 3D] the qkv the heads are sliced from,
rounded after the product (exactly what the backward's recompute rounds),
and rh1 [B * n_pad, dh] the pre-GELU hidden cn_m W1 rounded once (the
stash backward takes h = round(gelu(f32(rh1)))). f(x) is that of
``stash=False``. Padded rows hold what the forward computes there (the
tiled route reads padded rows of x as zeros). On the GPU the kernels'
stash instances run, counted as ``vf_eval_stash`` and
``vf_eval_jasmin_stash`` (one image per CTA) or ``vf_eval_stash_tiled``
and ``vf_eval_jasmin_stash_tiled``; the route is that of ``stash=False``.

``emit_masks`` (``vf_eval`` and ``vf_eval_attn`` with dropout, the TPU
kernel's ``emit_masks``) also returns the four keep masks the evaluation
applied, in JAX's layouts: mask_h [B * n_pad, dh], mask_mo and mask_ao
[B * n_pad, D], mask_p [B, H, n_pad, n_pad], f32, 1 / (1 - rate) where
kept, else 0 (0 on padded rows and keys; all ones at a site of rate 0).
It runs the tiled route's dropout instance at every shape (the port's map
mode lives there, and the dropout check asks for maps and masks
together), counted as ``vf_eval_masks``; the masks equal
``generate_dropout_masks`` bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from odevit_tpu_torch.kernels import count_launch, count_tiled
from odevit_tpu_torch.kernels.dropout import drop_spec, masks_plain
from odevit_tpu_torch.kernels.tiled import (align128, shape_rule,
                                            tiled_forward, tiled_plan_rule)
from odevit_tpu_torch.losses.jasmin import jasmin_order_stats
from odevit_tpu_torch.ops.dot import dot32

# Token-axis padding granularity (the TPU package pads to the same 16).
TOKEN_PAD = 16

MODES = {"plain": 0, "euler": 1, "base": 2}
# the tiled route's counters of the deterministic modes
_TILED_COUNTERS = {"plain": "vf_eval_tiled", "euler": "vf_eval_euler_tiled",
                   "base": "vf_eval_base_tiled"}


class VFWeights(NamedTuple):
    """A ParallelVectorField's weights as the kernel takes them: norms in
    float32, matrices ``[in, out]`` in the compute dtype."""
    norm_attn_scale: torch.Tensor   # [D] f32
    norm_attn_bias: torch.Tensor    # [D] f32
    norm_mlp_scale: torch.Tensor    # [D] f32
    norm_mlp_bias: torch.Tensor     # [D] f32
    wqkv: torch.Tensor              # [D, 3D]
    wout: torch.Tensor              # [D, D]
    w1: torch.Tensor                # [D, dh]
    w2: torch.Tensor                # [dh, D]
    # L2 attention only: [bq | bk | bv] [3D] and the output bias [D], f32
    qkv_bias: Optional[torch.Tensor] = None
    out_bias: Optional[torch.Tensor] = None

    @property
    def l2(self) -> bool:
        """Whether these are an L2-attention field's weights."""
        return self.qkv_bias is not None


def pad_tokens(n: int) -> int:
    return -(-n // TOKEN_PAD) * TOKEN_PAD


def _check(x, w: VFWeights, num_heads, n_real, mode, base):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, n_pad, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    if n % TOKEN_PAD:
        raise ValueError(f"token axis {n} is not padded to {TOKEN_PAD}")
    if not 0 < n_real <= n:
        raise ValueError(f"n_real {n_real} outside (0, {n}]")
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by {num_heads} heads")
    dh = w.w1.shape[1]
    shapes = {"norm_attn_scale": (d,), "norm_attn_bias": (d,),
              "norm_mlp_scale": (d,), "norm_mlp_bias": (d,),
              "wqkv": (d, 3 * d), "wout": (d, d), "w1": (d, dh),
              "w2": (dh, d)}
    if (w.qkv_bias is None) != (w.out_bias is None):
        raise ValueError("qkv_bias and out_bias come together")
    if w.l2:
        shapes.update(qkv_bias=(3 * d,), out_bias=(d,))
        if mode != "plain":
            raise ValueError(f"L2 attention has no {mode!r} mode (nor has "
                             f"the TPU kernel): it serves through the "
                             f"plain mode")
        l2_route(x.dtype, n, n_real, d, num_heads, w.w1.shape[1])
    for name, shape in shapes.items():
        t = getattr(w, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if (mode == "base") != (base is not None):
        raise ValueError("base is given exactly when mode == 'base'")
    if base is not None and base.shape != x.shape:
        raise ValueError(f"base {tuple(base.shape)} != x {tuple(x.shape)}")


def _field_plain(x, w: VFWeights, num_heads: int, scaler: float,
                 n_real: int, seed=None, drops=(0.0, 0.0, 0.0),
                 resid: bool = False):
    """(f(x) in float32, p [B, H, n, n] in the compute dtype), rounding
    where the kernel rounds (qkv is rounded before the heads are
    sliced). With dropout, the kernels' masks (``dropout.masks_plain``)
    apply where the XLA twin applies them; ``p`` is the pre-dropout map.
    With ``resid``, (f, p, (rqkv, rh1)): the stash (module docstring)."""
    b, n, d = x.shape
    hd = d // num_heads
    dtype = x.dtype
    mask_h, mask_mo, mask_ao, mask_p = masks_plain(
        b, n_real, d, w.w1.shape[1], num_heads, seed, drops,
        device=x.device, n_pad=n) or (None,) * 4
    xf = x.float()
    cent = (xf - xf.mean(-1, keepdim=True)) * (d / (d - 1.0))
    cn_a = (cent * w.norm_attn_scale + w.norm_attn_bias).to(dtype)
    cn_m = (cent * w.norm_mlp_scale + w.norm_mlp_bias).to(dtype)

    h1 = dot32(cn_m, w.w1)
    h = torch.nn.functional.gelu(h1).to(dtype)
    if mask_h is not None:
        h = (h.float() * mask_h).to(dtype)
    mlp_o = dot32(h, w.w2)
    if mask_mo is not None:
        mlp_o = mlp_o * mask_mo

    qkv = dot32(cn_a, w.wqkv)
    if w.l2:
        qkv = qkv + w.qkv_bias
    q, k, v = qkv.to(dtype).reshape(b, n, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4)
    key = torch.arange(n, device=x.device) < n_real
    if w.l2:
        p = l2_probs(q, k, key)[0].to(dtype)
    else:
        s = (q.float() * hd ** -0.5) @ k.float().transpose(-1, -2)
        s = s.masked_fill(~key, float("-inf"))      # select, never 0 * x
        p = torch.softmax(s, dim=-1).to(dtype)
    v = torch.where(key[:, None], v, torch.zeros((), dtype=dtype,
                                                 device=x.device))
    p_used = p if mask_p is None else (p.float() * mask_p).to(dtype)
    ctx = dot32(p_used, v).to(dtype).transpose(1, 2).reshape(b, n, d)
    attn_o = dot32(ctx, w.wout)
    if w.l2:
        attn_o = attn_o + w.out_bias
    if mask_ao is not None:
        attn_o = attn_o * mask_ao
    if resid:
        return (mlp_o + attn_o) * scaler, p, (
            qkv.to(dtype).reshape(b * n, 3 * d),
            h1.to(dtype).reshape(b * n, -1))
    return (mlp_o + attn_o) * scaler, p


def l2_probs(q, k, key):
    """(p f32, e, row sum + 1e-8) of L2 attention over the keys where
    ``key`` holds, from the rounded q and k [B, H, n, hd]: e = exp(-(q2 +
    k2 - 2 q.k) / sqrt(hd)), selected to 0 on padded keys, and p = e /
    (sum(e) + 1e-8), with q2, k2 and q.k in float32, as the TPU kernel
    takes them. No max is subtracted: a row whose exponentials all
    underflow gives p = 0."""
    qf, kf = q.float(), k.float()
    q2 = (qf * qf).sum(-1, keepdim=True)
    k2 = (kf * kf).sum(-1)[..., None, :]
    dist2 = q2 + k2 - 2.0 * (qf @ kf.transpose(-1, -2))
    e = torch.where(key, torch.exp(-dist2 * q.shape[-1] ** -0.5),
                    torch.zeros((), device=q.device))
    esum = e.sum(-1, keepdim=True) + 1e-8
    return e / esum, e, esum


# Shared memory of one CTA (csrc/vector_field.cu: kMaxSmem, kChunks)
_MAX_SMEM = 232448
_CHUNKS = (128, 64, 32, 16)


def cta_shape_ok(n_pad: int, n_real: int, d: int, num_heads: int,
                 dh: int) -> bool:
    """The one-image-per-CTA kernels' shape rule (``shape_ok`` in
    ``csrc/vector_field.cu`` and ``csrc/vector_field_bwd.cu``)."""
    return shape_rule(n_pad, n_real, d, num_heads, dh, 128)


def cta_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
             dh: int, drop: bool = False, l2: bool = False):
    """(fused q|k|v product, MLP chunk width, shared-memory bytes) of one
    CTA (of the dropout instance with ``drop``, of the L2 instance with
    ``l2``), or None where one image does not fit one CTA: ``vf_plan`` of
    ``csrc/vector_field.cu`` (its ``make_plan``) in Python, so that a CPU
    run routes as the card does. It decides the route in either dtype;
    the f32 kernel then lays its CTA out by :func:`f32_plan`.
    ``chip_smoke.py`` holds it against ``vf_plan`` on the card."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    tb = torch.empty((), dtype=dtype).element_size()
    hd, pad = d // num_heads, 16 // tb
    for fused in (1, 0):
        for hc in _CHUNKS:
            if dh % hc:
                continue
            rows = [(d + pad) * tb,                         # cn
                    (max(hc, 3 * hd if fused else hd, n_pad,
                         d if drop and tb == 2 else 0) + 4) * 4,
                    (max(hc, hd) + pad) * tb,               # hbuf
                    *[(hd + pad) * tb] * 3,                 # q, k, v
                    (n_pad + pad) * tb,                     # p
                    *([(d + 4) * 4] if tb == 2 else []),    # acc
                    *([4 * ((d + 127) // 128) * 4] if drop else []),
                    *([4, 4] if l2 else [])]                # q2, k2
            total = sum(align128(n_pad * r) for r in rows)
            if total <= _MAX_SMEM:
                return fused, hc, total
    return None


def l2_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
            dh: int):
    """:func:`cta_plan` of the L2 instance."""
    return cta_plan(dtype, n_pad, n_real, d, num_heads, dh, l2=True)


# csrc/split_tf32.cuh: mac::gemm_tf32's ring (kSlice, kStages, kTileRows,
# kMaxOwn; 12 warps of 32 threads) and the f32 one-CTA kernels' column
# blocks (kBlocksF32)
_SLICE, _STAGES, _TILE_ROWS, _MAX_OWN = 16, 2, 3, 3
F32_BLOCKS = (192, 128, 96, 64, 32, 16)


def ring_slot(n: int, nb: int) -> int:
    """Floats of one plane of one slot of gemm_tf32's ring for n rows and
    column blocks of nb (``mac::ring_slot``)."""
    return n * (_SLICE + 4) + max(_SLICE * (nb + 8), nb * (_SLICE + 4))


def block_ok(n: int, nb: int) -> bool:
    """``mac::block_ok``: one round of warp tiles, and a staged slice's
    16-byte chunks within kMaxOwn a thread."""
    return (-(-nb // 32) * -(-(n // 16) // _TILE_ROWS) <= 12
            and 4 * n + 4 * nb <= _MAX_OWN * 384)


def f32_layout(n_pad: int, d: int, num_heads: int, hc: int, nb: int,
               acc_smem: int, drop: bool = False, l2: bool = False) -> dict:
    """``make_plan_f32`` of csrc/vector_field.cu: byte offsets of the f32
    forward's CTA, its row strides (floats) and its workspace (floats per
    image)."""
    n, hd = n_pad, d // num_heads
    lay = {"slot": ring_slot(n, nb), "ld_acc": d + 8, "ld_h": hc + 4,
           "ld_p": n + 4, "ld_bits": 4 * ((d + 127) // 128),
           "ld_qkv": 3 * hd}
    off = 0
    lay["ring"] = off
    off += align128(2 * _STAGES * lay["slot"] * 4)
    lay["acc"] = off
    if acc_smem:
        off += align128(n * lay["ld_acc"] * 4)
    fh, fp = align128(n * lay["ld_h"] * 4), align128(n * lay["ld_p"] * 4)
    lay.update(hbig=off, hsmall=off + fh, pbig=off, psmall=off + fp)
    off += 2 * max(fh, fp)
    lay["bits"] = off
    if drop:
        off += align128(n * lay["ld_bits"] * 4)
    lay["norms"] = off
    if l2:
        off += 2 * align128(n * 4)
    lay["total"] = off
    lay["ws_qkv"] = n * d
    lay["ws_acc"] = lay["ws_qkv"] + n * lay["ld_qkv"]
    lay["ws"] = lay["ws_acc"] + (0 if acc_smem else n * d)
    return lay


def f32_search(layout, n_pad: int, n_real: int, d: int, num_heads: int,
               dh: int, drop: bool = False, l2: bool = False):
    """The f32 one-CTA kernels' plan rule (``plan_f32`` and ``plan_b32`` of
    the CUDA sources): the widest MLP chunk, then the widest column block,
    the accumulator in shared memory where it still fits. (accumulator in
    shared memory, chunk, block, shared-memory bytes, workspace floats per
    image) of the first ``layout`` within 227 KB, or None."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    for hc in _CHUNKS:
        if dh % hc:
            continue
        for nb in F32_BLOCKS:
            if not block_ok(n_pad, nb):
                continue
            for acc_smem in (1, 0):
                lay = layout(n_pad, d, num_heads, hc, nb, acc_smem, drop, l2)
                if lay["total"] <= _MAX_SMEM:
                    return acc_smem, hc, nb, lay["total"], lay["ws"]
    return None


def f32_plan(n_pad: int, n_real: int, d: int, num_heads: int, dh: int,
             drop: bool = False, l2: bool = False):
    """:func:`f32_search` over ``vf_kernel_f32``'s layouts: ``vf_plan_f32``
    of csrc/vector_field.cu in Python. ``chip_smoke.py`` holds it against
    ``vf_plan_f32``."""
    return f32_search(f32_layout, n_pad, n_real, d, num_heads, dh, drop, l2)


def l2_route(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
             dh: int, bwd: bool = False) -> str:
    """"cta" where the one-image-per-CTA L2 instance has a plan (of the
    backward with ``bwd``), else "tiled" where the tiled route's has one
    (key-tiled past 256 padded tokens); raises where neither has one
    (sizes that are not multiples of 16). The same rule on either
    device."""
    if bwd:
        from odevit_tpu_torch.kernels.vector_field_bwd import l2_bwd_plan
        cta = l2_bwd_plan(dtype, n_pad, n_real, d, num_heads, dh)
    else:
        cta = l2_plan(dtype, n_pad, n_real, d, num_heads, dh)
    if cta is not None:
        return "cta"
    if tiled_plan_rule(dtype, n_pad, n_real, d, num_heads, dh, l2=True):
        return "tiled"
    raise ValueError(
        f"no L2 plan for n_pad={n_pad}, D={d}, {num_heads} heads, dh={dh} "
        f"in {dtype}: the tiled kernels need multiples of 16")


def _check_l2_drop(w: VFWeights, drops):
    if w.l2 and any(drops):
        raise ValueError("L2 attention has no dropout instance (nor has the "
                         "TPU kernel: JAX's fused L2 path is "
                         "deterministic-only)")


def masks_emitted_plain(x, dh: int, num_heads: int, n_real: int, seed,
                        drops):
    """The four masks ``emit_masks`` returns (see the module docstring),
    from ``dropout.masks_plain``."""
    b, n, d = x.shape
    got = masks_plain(b, n_real, d, dh, num_heads, seed, drops,
                      device=x.device, n_pad=n)
    shapes = ((b * n, dh), (b * n, d), (b * n, d), (b, num_heads, n, n))
    return tuple(torch.ones(s, device=x.device) if m is None
                 else m.reshape(s) for m, s in zip(got, shapes))


def _check_stash(w: VFWeights, mode: str, drops, emit_masks: bool = False):
    if w.l2 or mode != "plain" or any(drops) or emit_masks:
        raise ValueError("the residual stash exists for the deterministic "
                         "softmax plain and JaSMin modes only (as the TPU "
                         "kernel's emit_resid)")


def _check_emit_masks(mode: str, seed, drops):
    if drop_spec(seed, drops) is None or mode != "plain":
        raise ValueError("emit_masks returns the dropout masks of a "
                         "plain-mode evaluation: give a seed and nonzero "
                         "rates")


def vf_eval_plain(x, w: VFWeights, *, num_heads: int, scaler: float,
                  n_real: int, mode: str = "plain", dt: float = 0.0,
                  base=None, seed=None, drops=(0.0, 0.0, 0.0),
                  emit_masks: bool = False, stash: bool = False):
    """The kernel's arithmetic in plain PyTorch; with ``emit_masks``,
    (f(x), masks); with ``stash``, (f(x), (rqkv, rh1))."""
    _check(x, w, num_heads, n_real, mode, base)
    _check_l2_drop(w, drops)
    if emit_masks:
        _check_emit_masks(mode, seed, drops)
    if stash:
        _check_stash(w, mode, drops, emit_masks)
        f, _, resid = _field_plain(x, w, num_heads, scaler, n_real,
                                   resid=True)
        return f.to(x.dtype), resid
    f, _ = _field_plain(x, w, num_heads, scaler, n_real, seed, drops)
    if mode == "euler":
        f = x.float() + dt * f
    elif mode == "base":
        f = base.float() + dt * f
    if emit_masks:
        return f.to(x.dtype), masks_emitted_plain(
            x, w.w1.shape[1], num_heads, n_real, seed, drops)
    return f.to(x.dtype)


def _check_no_l2_map(w: VFWeights):
    if w.l2:
        raise NotImplementedError(
            "the attention-map mode has no L2 instance (JAX's fused L2 path "
            "takes JaSMin from the statistics, never from the maps)")


def _check_jasmin(n_real: int, jas_k: int):
    kk = max(jas_k, 1) + 1
    if n_real < kk:
        raise ValueError(f"JaSMin statistics for k={jas_k} need at least "
                         f"{kk} real tokens, got {n_real}")
    return kk


def vf_eval_attn_plain(x, w: VFWeights, *, num_heads: int, scaler: float,
                       n_real: int, seed=None, drops=(0.0, 0.0, 0.0),
                       emit_masks: bool = False):
    """(f(x), p): the attention-map mode in plain PyTorch. ``p`` [B, H,
    n_pad, n_pad] in x's dtype holds zeros on padded query rows (and, by
    the key mask, on padded keys). With dropout ``p`` is the pre-dropout
    map; with ``emit_masks``, (f(x), p, masks)."""
    _check(x, w, num_heads, n_real, "plain", None)
    _check_no_l2_map(w)
    if emit_masks:
        _check_emit_masks("plain", seed, drops)
    f, p = _field_plain(x, w, num_heads, scaler, n_real, seed, drops)
    query = (torch.arange(x.shape[1], device=x.device) < n_real)[:, None]
    p = torch.where(query, p, torch.zeros((), dtype=p.dtype,
                                          device=x.device))
    if emit_masks:
        return f.to(x.dtype), p, masks_emitted_plain(
            x, w.w1.shape[1], num_heads, n_real, seed, drops)
    return f.to(x.dtype), p


def vf_eval_jasmin_plain(x, w: VFWeights, *, num_heads: int, scaler: float,
                         n_real: int, jas_k: int, seed=None,
                         drops=(0.0, 0.0, 0.0), stash: bool = False):
    """(f(x), stats, idx): the kernel's JaSMin-statistics mode in plain
    PyTorch. ``stats`` [B, H, 5, n_pad] f32 holds, per query row (last
    axis), the 1st, 2nd, k-th and (k+1)-th largest p of the real keys and
    the row sum of clip(p, 1e-12, 1); ``idx`` [B, H, 4, n_pad] int32 the
    columns of the first four (first occurrence among ties). Padded query
    rows hold zeros. With dropout the statistics are those of the
    pre-dropout p. With ``stash``, (f(x), stats, idx, (rqkv, rh1))."""
    _check(x, w, num_heads, n_real, "plain", None)
    _check_jasmin(n_real, jas_k)
    _check_l2_drop(w, drops)
    if stash:
        _check_stash(w, "plain", drops)
    f, p, *resid = _field_plain(x, w, num_heads, scaler, n_real, seed, drops,
                                resid=stash)
    stats, idx = jasmin_order_stats(p[..., :n_real], jas_k,
                                    return_indices=True)
    query = torch.arange(x.shape[1], device=x.device) < n_real
    stats = torch.where(query, stats, torch.zeros((), device=x.device))
    idx = torch.where(query, idx, torch.zeros((), dtype=idx.dtype,
                                              device=x.device))
    return (f.to(x.dtype), stats.contiguous(), idx.contiguous(), *resid)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.vf_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
    lib.vf_plan.restype = i
    lib.vf_launch.argtypes = ([i] + [p] * 14 + [i] * 9
                              + [f, f, f, i, p, p, i, p, p, i, p, p, p])
    lib.vf_launch.restype = i
    lib.vf_error_string.argtypes = [i]
    lib.vf_error_string.restype = ctypes.c_char_p
    lib.vf_plan_f32.argtypes = ([i] * 7 + [ctypes.POINTER(i)] * 4
                                + [ctypes.POINTER(ctypes.c_longlong)])
    lib.vf_plan_f32.restype = i
    lib.vf_f32_launches.argtypes = []
    lib.vf_f32_launches.restype = ctypes.c_ulonglong
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        _lib = _bind(build.load("vector_field"))
    return _lib


def has_cta_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                 dh: int, drop: bool = False) -> bool:
    """Whether the one-image-per-CTA kernel (its dropout instance with
    ``drop``) takes this shape (else the tiled route runs)."""
    try:
        kernel_plan(dtype, n_pad, n_real, d, num_heads, dh, drop)
    except ValueError:
        return False
    return True


def kernel_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                dh: int, drop: bool = False, l2: bool = False):
    """(fused q|k|v product, MLP chunk width, shared-memory bytes) of one
    CTA (of the dropout instance with ``drop``, of the L2 instance with
    ``l2``); raises if the shape has no plan (it does not fit one image
    per CTA)."""
    fused, hc, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().vf_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                          int(drop), int(l2), ctypes.byref(fused),
                          ctypes.byref(hc), ctypes.byref(smem)):
        raise ValueError(
            f"no one-image-per-CTA plan for n_pad={n_pad}, D={d}, "
            f"{num_heads} heads, dh={dh} in {dtype}: the fused kernel "
            f"needs n_pad <= 128, multiples of 16 and <= 227 KB of shared "
            f"memory")
    return fused.value, hc.value, smem.value


def kernel_plan_f32(n_pad: int, n_real: int, d: int, num_heads: int,
                    dh: int, drop: bool = False, l2: bool = False):
    """``vf_plan_f32`` of the CUDA source: (accumulator in shared memory,
    MLP chunk width, column block, shared-memory bytes, workspace floats
    per image) of ``vf_kernel_f32``; raises if the shape has none."""
    outs = [ctypes.c_int() for _ in range(4)]
    ws = ctypes.c_longlong()
    if _library().vf_plan_f32(n_pad, n_real, d, num_heads, dh, int(drop),
                              int(l2), *map(ctypes.byref, outs),
                              ctypes.byref(ws)):
        raise ValueError(f"no f32 plan for n_pad={n_pad}, D={d}, "
                         f"{num_heads} heads, dh={dh}")
    return (*(o.value for o in outs), ws.value)


def f32_launches() -> int:
    """``vf_kernel_f32``'s launches so far (the library's C counter)."""
    return _library().vf_f32_launches()


def _check_launch(x, w: VFWeights, base=None):
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA or CPU, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, not {x.dtype}")
    tensors = {"x": x, **w._asdict()}
    if base is not None:
        tensors["base"] = base
    for name, t in tensors.items():
        if t is None:
            continue
        want = (torch.float32 if name.startswith("norm")
                or name.endswith("_bias") else x.dtype)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} is not 32-byte aligned")


def _launch(x, w: VFWeights, *, num_heads, scaler, n_real, mode, dt, base,
            jas_kk=0, drop=None, chain=1, stash=False):
    b, n, d = x.shape
    dh = w.w1.shape[1]
    plan = kernel_plan(x.dtype, n, n_real, d, num_heads, dh, drop is not None,
                       w.l2)
    out = torch.empty_like(x)
    # f32: vf_kernel_f32's workspace (cn, the head's q | k | v, and the
    # accumulator where its plan keeps it out of shared memory)
    acc = None
    if x.dtype == torch.float32:
        ws = kernel_plan_f32(n, n_real, d, num_heads, dh, drop is not None,
                             w.l2)[4]
        acc_buf = torch.empty(b * ws, device=x.device)
        acc = acc_buf.data_ptr()
    stats = idx = None
    if jas_kk:
        stats = torch.empty(b, num_heads, 5, n, device=x.device)
        idx = torch.empty(b, num_heads, 4, n, device=x.device,
                          dtype=torch.int32)
    resid = ((torch.empty(b * n, 3 * d, device=x.device, dtype=x.dtype),
              torch.empty(b * n, dh, device=x.device, dtype=x.dtype))
             if stash else (None, None))
    err = _library().vf_launch(
        x.element_size(), x.data_ptr(),
        base.data_ptr() if base is not None else None, out.data_ptr(), acc,
        *(t.data_ptr() if t is not None else None for t in w), b, n,
        n_real, d, num_heads, dh, *plan,
        scaler, dt, (d // num_heads) ** -0.5, MODES[mode],
        stats.data_ptr() if jas_kk else None,
        idx.data_ptr() if jas_kk else None, jas_kk,
        ctypes.byref(drop) if drop is not None else None,
        None, chain,
        *(t.data_ptr() if t is not None else None for t in resid),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("vector-field kernel launch failed: "
                           + _library().vf_error_string(err).decode())
    return out, stats, idx, resid


def vf_eval(x, w: VFWeights, *, num_heads: int, scaler: float, n_real: int,
            mode: str = "plain", dt: float = 0.0, base=None, seed=None,
            drops=(0.0, 0.0, 0.0), plain: bool = False,
            emit_masks: bool = False, stash: bool = False):
    """One vector-field evaluation (see the module docstring); with
    ``emit_masks``, (f(x), masks); with ``stash``, (f(x), (rqkv, rh1)).

    A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`vf_eval_plain`. ``plain=True`` runs the plain version on the
    GPU too: it exists for comparisons, and the main path never sets it.
    """
    if mode != "plain" and any(drops):
        raise ValueError(f"mode {mode!r} has no dropout instance (nor has "
                         f"the TPU kernel)")
    if plain or x.device.type == "cpu":
        return vf_eval_plain(x, w, num_heads=num_heads, scaler=scaler,
                             n_real=n_real, mode=mode, dt=dt, base=base,
                             seed=seed, drops=drops, emit_masks=emit_masks,
                             stash=stash)
    _check(x, w, num_heads, n_real, mode, base)
    _check_l2_drop(w, drops)
    _check_launch(x, w, base)
    drop = drop_spec(seed, drops)
    if stash:
        _check_stash(w, mode, drops, emit_masks)
        if not _cta_route(x, w, num_heads, n_real):
            out, resid = tiled_forward(x, w, num_heads=num_heads,
                                       scaler=scaler, n_real=n_real,
                                       stash=True)
            count_tiled("vf_eval_stash_tiled", x.shape[1])
            return out, resid
        out, _, _, resid = _launch(x, w, num_heads=num_heads, scaler=scaler,
                                   n_real=n_real, mode=mode, dt=dt,
                                   base=base, stash=True)
        count_launch("vf_eval_stash")
        return out, resid
    if emit_masks:
        _check_emit_masks(mode, seed, drops)
        out, masks = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                                   n_real=n_real, drop=drop, emit_masks=True)
        count_tiled("vf_eval_masks", x.shape[1])
        return out, masks
    if w.l2:
        if _l2_tiled(x, w, num_heads, n_real):
            (out,) = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                                   n_real=n_real)
            count_tiled("vf_eval_l2_tiled", x.shape[1])
            return out
        out = _launch(x, w, num_heads=num_heads, scaler=scaler,
                      n_real=n_real, mode=mode, dt=dt, base=base)[0]
        count_launch("vf_eval_l2")
        return out
    if not _cta_route(x, w, num_heads, n_real, drop):
        (out,) = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                               n_real=n_real, mode=mode, drop=drop, dt=dt,
                               base=base)
        count_tiled(_TILED_COUNTERS[mode] if drop is None
                    else "vf_eval_tiled_drop", x.shape[1])
        return out
    out = _launch(x, w, num_heads=num_heads, scaler=scaler, n_real=n_real,
                  mode=mode, dt=dt, base=base, drop=drop)[0]
    count_launch("vf_eval" if drop is None else "vf_eval_drop")
    return out


def vf_euler_chain_plain(x, w: VFWeights, *, num_heads: int, scaler: float,
                         n_real: int, dt: float, chain: int):
    """``chain`` Euler steps in plain PyTorch: ``vf_eval_plain`` in its
    Euler mode, the state rounded to x's dtype after each step."""
    for _ in range(chain):
        x = vf_eval_plain(x, w, num_heads=num_heads, scaler=scaler,
                          n_real=n_real, mode="euler", dt=dt)
    return x


def vf_euler_chain(x, w: VFWeights, *, num_heads: int, scaler: float,
                   n_real: int, dt: float, chain: int, plain: bool = False):
    """``chain`` Euler steps y <- round(y + dt f(y)), the counterpart of
    ``fused_euler_chain_from_params``. Where one image fits one CTA, one
    launch of the kernel's chained instance runs them all, each CTA
    holding its image's state between steps (counted as
    ``vf_euler_chain``); the state is rounded to its dtype between steps,
    so the result is bit for bit that of ``chain`` per-step launches.
    Elsewhere (the tiled route) a chain in one launch would need a barrier
    across the grid between the route's kernels, so the chain runs the
    tiled Euler mode once per step (``vf_eval_euler_tiled``): the same bits,
    as JAX's chain equals its per-step route by construction. A CPU tensor,
    or ``plain=True``, runs :func:`vf_euler_chain_plain`."""
    if chain < 1:
        raise ValueError(f"chain {chain} < 1")
    kw = dict(num_heads=num_heads, scaler=scaler, n_real=n_real)
    if plain or x.device.type == "cpu":
        return vf_euler_chain_plain(x, w, dt=dt, chain=chain, **kw)
    _check(x, w, num_heads, n_real, "euler", None)
    _check_launch(x, w)
    if chain == 1 or not _cta_route(x, w, num_heads, n_real):
        for _ in range(chain):
            x = vf_eval(x, w, mode="euler", dt=dt, **kw)
        return x
    out = _launch(x, w, mode="euler", dt=dt, base=None, chain=chain, **kw)[0]
    count_launch("vf_euler_chain")
    return out


def vf_eval_jasmin(x, w: VFWeights, *, num_heads: int, scaler: float,
                   n_real: int, jas_k: int, seed=None,
                   drops=(0.0, 0.0, 0.0), plain: bool = False,
                   stash: bool = False):
    """(f(x), stats, idx) in one launch of the kernel's JaSMin-statistics
    mode (see :func:`vf_eval_jasmin_plain` for the layout), and with
    ``stash`` last (rqkv, rh1). A CPU tensor, or ``plain=True``, runs the
    plain version."""
    if plain or x.device.type == "cpu":
        return vf_eval_jasmin_plain(x, w, num_heads=num_heads, scaler=scaler,
                                    n_real=n_real, jas_k=jas_k, seed=seed,
                                    drops=drops, stash=stash)
    _check(x, w, num_heads, n_real, "plain", None)
    kk = _check_jasmin(n_real, jas_k)
    _check_l2_drop(w, drops)
    _check_launch(x, w)
    drop = drop_spec(seed, drops)
    if stash:
        _check_stash(w, "plain", drops)
        if not _cta_route(x, w, num_heads, n_real):
            out = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                                n_real=n_real, mode="jasmin", jas_kk=kk,
                                stash=True)
            count_tiled("vf_eval_jasmin_stash_tiled", x.shape[1])
            return out
        out = _launch(x, w, num_heads=num_heads, scaler=scaler,
                      n_real=n_real, mode="plain", dt=0.0, base=None,
                      jas_kk=kk, stash=True)
        count_launch("vf_eval_jasmin_stash")
        return out
    if w.l2:
        if _l2_tiled(x, w, num_heads, n_real):
            out = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                                n_real=n_real, mode="jasmin", jas_kk=kk)
            count_tiled("vf_eval_jasmin_l2_tiled", x.shape[1])
            return out
        out = _launch(x, w, num_heads=num_heads, scaler=scaler,
                      n_real=n_real, mode="plain", dt=0.0, base=None,
                      jas_kk=kk)[:3]
        count_launch("vf_eval_jasmin_l2")
        return out
    if not _cta_route(x, w, num_heads, n_real, drop):
        out = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                            n_real=n_real, mode="jasmin", jas_kk=kk,
                            drop=drop)
        count_tiled("vf_eval_jasmin_tiled" if drop is None
                    else "vf_eval_jasmin_tiled_drop", x.shape[1])
        return out
    out = _launch(x, w, num_heads=num_heads, scaler=scaler, n_real=n_real,
                  mode="plain", dt=0.0, base=None, jas_kk=kk, drop=drop)[:3]
    count_launch("vf_eval_jasmin" if drop is None else "vf_eval_jasmin_drop")
    return out


def vf_eval_attn(x, w: VFWeights, *, num_heads: int, scaler: float,
                 n_real: int, seed=None, drops=(0.0, 0.0, 0.0),
                 plain: bool = False, emit_masks: bool = False):
    """(f(x), p) in one launch of the tiled route's attention-map mode (see
    :func:`vf_eval_attn_plain` for the layout); the one-image-per-CTA
    kernel has no map mode. A CPU tensor, or ``plain=True``, runs the plain
    version. With dropout the dropout instance runs; the maps stay those
    of the pre-dropout p. With ``emit_masks`` (dropout only), (f(x), p,
    masks), counted as ``vf_eval_masks``."""
    if plain or x.device.type == "cpu":
        return vf_eval_attn_plain(x, w, num_heads=num_heads, scaler=scaler,
                                  n_real=n_real, seed=seed, drops=drops,
                                  emit_masks=emit_masks)
    _check(x, w, num_heads, n_real, "plain", None)
    _check_no_l2_map(w)
    _check_launch(x, w)
    if emit_masks:
        _check_emit_masks("plain", seed, drops)
    drop = drop_spec(seed, drops)
    out = tiled_forward(x, w, num_heads=num_heads, scaler=scaler,
                        n_real=n_real, mode="attn", drop=drop,
                        emit_masks=emit_masks)
    count_tiled("vf_eval_masks" if emit_masks
                else "vf_eval_attn" if drop is None else "vf_eval_attn_drop",
                x.shape[1])
    return out


def _l2_tiled(x, w: VFWeights, num_heads: int, n_real: int) -> bool:
    b, n, d = x.shape
    return l2_route(x.dtype, n, n_real, d, num_heads,
                    w.w1.shape[1]) == "tiled"


def _cta_route(x, w: VFWeights, num_heads: int, n_real: int,
               drop=None) -> bool:
    b, n, d = x.shape
    return has_cta_plan(x.dtype, n, n_real, d, num_heads, w.w1.shape[1],
                        drop is not None)
