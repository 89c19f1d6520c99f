"""Differentiable fused evaluations: the kernels' forward and backward as
``torch.autograd.Function``s.

``FusedVF`` is the counterpart of ``odevit_tpu/kernels/vector_field.py::
fused_vf`` (and, with L2 weights, of ``fused_vf_l2``), ``FusedVFJasmin`` of
``fused_vf_jasmin`` (``fused_vf_l2_jasmin``) and ``FusedVFAttn`` of
``fused_vf_attn`` (no L2 instance: it raises): the forward runs
``vf_eval`` / ``vf_eval_jasmin`` / ``vf_eval_attn`` and the backward
``vf_bwd`` (with the maps' cotangent for ``FusedVFAttn``). On a CPU
tensor both run the plain versions; on a CUDA tensor they launch the
kernels or raise.

Both take the evaluation's float32 parameters (``params``: the two norms'
scales and biases, then Wqkv, Wout, W1, W2 as ``[in, out]`` views, and an
L2 field's two biases; ``vf_params``) and the same weights already cast
for the kernel (``w``, a ``VFWeights`` made once per step). The cast
happens outside the graph, but the gradients flow to ``params``, so they
arrive in float32 as they do in JAX. Each Function saves x (and the
statistics' columns) and recomputes the rest in the backward.

``FusedVFStash`` and ``FusedVFJasminStash`` are the counterparts of
``fused_vf_stash`` and ``fused_vf_jasmin_stash`` (residual stashing;
softmax, no dropout): the forward runs ``vf_eval(stash=True)`` /
``vf_eval_jasmin(stash=True)`` and saves, beside x (and the statistics'
columns), the compute-dtype rqkv [B * n_pad, 3D] and rh1 [B * n_pad, dh]
it wrote; the backward hands them to ``vf_bwd`` (``resid_qkv``,
``resid_h1``), which reads them instead of recomputing the qkv and fc1
products. The route is the one the same evaluation takes without the
stash.

``MacaronFunction`` is the counterpart of
``odevit_tpu/kernels/macaron.py::fused_macaron``: the forward runs
``macaron_eval`` in its plain mode and the backward ``macaron_bwd``, over
the 15 float32 parameters of ``MacaronVectorField.kernel_params`` and their
cast copies (``MacaronWeights``).

The first three also carry dropout (``seed``, ``drops`` = (attn, proj, mlp)),
the counterparts of ``fused_vf_dropout``, ``fused_vf_jasmin_dropout`` and
``fused_vf_attn_dropout``: they keep the seed, never a mask, and the
backward draws the masks again.
"""

from __future__ import annotations

import torch

from odevit_tpu_torch.kernels.macaron import MacaronWeights, macaron_eval
from odevit_tpu_torch.kernels.macaron_bwd import macaron_bwd
from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval,
                                                   vf_eval_attn,
                                                   vf_eval_jasmin)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd


class FusedVF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: VFWeights, kw: dict, *params):
        # kw: num_heads, scaler, n_real, seed, drops, plain
        ctx.save_for_backward(x)
        ctx.w, ctx.kw = w, kw
        return vf_eval(x, w, **kw)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        bars = vf_bwd(x, ctx.w, g.contiguous(), **ctx.kw)
        return (bars[0], None, None, *bars[1:])


class FusedVFJasmin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: VFWeights, kw: dict, jas_k: int, *params):
        dx, stats, idx = vf_eval_jasmin(x, w, jas_k=jas_k, **kw)
        ctx.save_for_backward(x, idx)
        ctx.w, ctx.kw = w, kw
        return dx, stats

    @staticmethod
    def backward(ctx, g, g_stats):
        # autograd hands zeros for an output that took no part in the loss
        x, idx = ctx.saved_tensors
        bars = vf_bwd(x, ctx.w, g.contiguous(), g_jas=g_stats.contiguous(),
                      jas_idx=idx, **ctx.kw)
        return (bars[0], None, None, None, *bars[1:])


class FusedVFAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: VFWeights, kw: dict, *params):
        dx, p = vf_eval_attn(x, w, **kw)
        ctx.save_for_backward(x)
        ctx.w, ctx.kw = w, kw
        return dx, p

    @staticmethod
    def backward(ctx, g, g_attn):
        (x,) = ctx.saved_tensors
        bars = vf_bwd(x, ctx.w, g.contiguous(),
                      g_attn=g_attn.to(x.dtype).contiguous(), **ctx.kw)
        return (bars[0], None, None, *bars[1:])


class FusedVFStash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: VFWeights, kw: dict, *params):
        dx, (rqkv, rh1) = vf_eval(x, w, stash=True, **kw)
        ctx.save_for_backward(x, rqkv, rh1)
        ctx.w, ctx.kw = w, kw
        return dx

    @staticmethod
    def backward(ctx, g):
        x, rqkv, rh1 = ctx.saved_tensors
        bars = vf_bwd(x, ctx.w, g.contiguous(), resid_qkv=rqkv,
                      resid_h1=rh1, **ctx.kw)
        return (bars[0], None, None, *bars[1:])


class FusedVFJasminStash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: VFWeights, kw: dict, jas_k: int, *params):
        dx, stats, idx, (rqkv, rh1) = vf_eval_jasmin(x, w, jas_k=jas_k,
                                                     stash=True, **kw)
        ctx.save_for_backward(x, idx, rqkv, rh1)
        ctx.w, ctx.kw = w, kw
        return dx, stats

    @staticmethod
    def backward(ctx, g, g_stats):
        x, idx, rqkv, rh1 = ctx.saved_tensors
        bars = vf_bwd(x, ctx.w, g.contiguous(), g_jas=g_stats.contiguous(),
                      jas_idx=idx, resid_qkv=rqkv, resid_h1=rh1, **ctx.kw)
        return (bars[0], None, None, None, *bars[1:])


def vf_params(vf) -> tuple:
    """A ``ParallelVectorField``'s float32 parameters in the order the
    Functions take them (matrices as ``[in, out]`` views). With L2
    attention, Wqkv is ``[Wq | Wk | Wv]`` and the biases ``[bq | bk | bv]``
    and ``b_out`` follow W2, as ``fused_vf_l2_from_params`` concatenates
    them; autograd carries their gradients back to the four projections."""
    a = vf.attn
    norms = (vf.norm_attn.weight, vf.norm_attn.bias, vf.norm_mlp.weight,
             vf.norm_mlp.bias)
    mlp = (vf.mlp.fc1.weight.T, vf.mlp.fc2.weight.T)
    if not vf.l2_attention:
        return (*norms, a.qkv.weight.T, a.proj.weight.T, *mlp)
    return (*norms, torch.cat([a.q.weight.T, a.k.weight.T, a.v.weight.T], 1),
            a.out.weight.T, *mlp, torch.cat([a.q.bias, a.k.bias, a.v.bias]),
            a.out.bias)


def fused_vf(x, w: VFWeights, params, *, num_heads: int, scaler: float,
             n_real: int, seed=None, drops=(0.0, 0.0, 0.0),
             plain: bool = False, stash: bool = False):
    """f(x) (with dropout where ``drops`` and ``seed`` ask for it),
    differentiable in x and ``params``; ``stash`` runs ``FusedVFStash``
    (no dropout)."""
    kw = dict(num_heads=num_heads, scaler=scaler, n_real=n_real, seed=seed,
              drops=drops, plain=plain)
    return (FusedVFStash if stash else FusedVF).apply(x, w, kw, *params)


def fused_vf_jasmin(x, w: VFWeights, params, *, num_heads: int,
                    scaler: float, n_real: int, jas_k: int, seed=None,
                    drops=(0.0, 0.0, 0.0), plain: bool = False,
                    stash: bool = False):
    """(f(x), JaSMin statistics [B, H, 5, n_pad] of the pre-dropout p),
    differentiable in x and ``params``; ``stash`` runs
    ``FusedVFJasminStash`` (no dropout)."""
    kw = dict(num_heads=num_heads, scaler=scaler, n_real=n_real, seed=seed,
              drops=drops, plain=plain)
    fn = FusedVFJasminStash if stash else FusedVFJasmin
    return fn.apply(x, w, kw, jas_k, *params)


def fused_vf_attn(x, w: VFWeights, params, *, num_heads: int, scaler: float,
                  n_real: int, seed=None, drops=(0.0, 0.0, 0.0),
                  plain: bool = False):
    """(f(x), attention maps [B, H, n_pad, n_pad] of the pre-dropout p),
    differentiable in x and ``params``."""
    kw = dict(num_heads=num_heads, scaler=scaler, n_real=n_real, seed=seed,
              drops=drops, plain=plain)
    return FusedVFAttn.apply(x, w, kw, *params)


class MacaronFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w: MacaronWeights, kw: dict, *params):
        # kw: num_heads, scaler, n_real, plain
        ctx.save_for_backward(x)
        ctx.w, ctx.kw = w, kw
        return macaron_eval(x, w, **kw)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        bars = macaron_bwd(x, ctx.w, g.contiguous(), **ctx.kw)
        return (bars[0], None, None, *bars[1:])


def fused_macaron(x, w: MacaronWeights, params, *, num_heads: int,
                  scaler: float, n_real: int, plain: bool = False):
    """f(x) of the Macaron field, differentiable in x and ``params``."""
    kw = dict(num_heads=num_heads, scaler=scaler, n_real=n_real, plain=plain)
    return MacaronFunction.apply(x, w, kw, *params)
