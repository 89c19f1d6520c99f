"""JaSMin attention-entropy regularization.

Counterpart of ``odevit_tpu/losses/jasmin.py``:
``g_k(P) = x_(k) * (1 - x_(k) + x_(k+1))`` where ``x_(k)`` is the k-th
largest entry of an attention row; the loss is ``log g_1`` (k=0) or
``log(g_1 / g_k)`` (k>0), maxed over query rows, meaned over heads and
batch.

Two points keep the values and the gradients equal to JAX's:

  * order statistics come from repeated ``argmax`` (which returns the
    first maximum), removing one column per pass, so ties resolve to the
    leftmost column as JAX's extraction does; ``torch.topk`` and
    ``torch.sort`` do not promise an order among ties;
  * ``jnp.clip`` passes half the gradient at either bound and ``jnp.max``
    splits it evenly among tied maxima; :func:`_clip` and ``torch.amax``
    do the same (``torch.clamp`` passes all of it at a bound, and
    ``torch.max(dim=)`` all of it to one index).
"""

from __future__ import annotations

import torch

_EPS = 1e-12

JAS_ROWS = 5     # x1, x2, xk, xk+1, clipped row sum (per query row)


class _ClipFn(torch.autograd.Function):
    """clip(x, lo, hi) with JAX's subgradient: 1 strictly inside, 0.5 at
    either bound, 0 outside."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo = ((x >= ctx.lo).to(g.dtype) + (x > ctx.lo).to(g.dtype)) * 0.5
        hi = ((x <= ctx.hi).to(g.dtype) + (x < ctx.hi).to(g.dtype)) * 0.5
        return g * lo * hi, None, None


def _clip(x, lo: float, hi: float):
    return _ClipFn.apply(x, lo, hi)


def _top_values(p, kk: int):
    """The first ``kk`` order statistics of each row of ``p`` by repeated
    first-occurrence argmax; returns (values, indices), each a list of
    ``kk`` tensors of shape ``p.shape[:-1]``."""
    cur = p
    tops, ids = [], []
    for _ in range(kk):
        idx = cur.argmax(-1, keepdim=True)
        tops.append(cur.gather(-1, idx)[..., 0])
        ids.append(idx[..., 0])
        cur = cur.scatter(-1, idx, float("-inf"))
    return tops, ids


def _g_pair(p, k: int):
    n = p.shape[-1]
    kk = min(k + 1, n)
    top, _ = _top_values(p, kk)
    x1 = top[0]
    x2 = top[1] if n > 1 else torch.zeros_like(x1)
    g1 = x1 * (1.0 - x1 + x2)
    if k <= 1:
        return g1, g1
    xk = top[k - 1]
    xk1 = top[k] if k < n else torch.zeros_like(xk)
    return g1, xk * (1.0 - xk + xk1)


def jasmin_map_loss(attn, k: int = 0):
    """JaSMin scalar for one attention map ``[B, H, N, N]``; rows are
    clipped to [1e-12, 1] and renormalized first."""
    p = _clip(attn.float(), _EPS, 1.0)
    p = p / (p.sum(-1, keepdim=True) + _EPS)
    g1, gk = _g_pair(p, max(k, 1))
    if k == 0:
        loss = torch.log(g1 + _EPS)
    else:
        loss = torch.log(g1 / (gk + _EPS) + _EPS)
    return torch.amax(loss, dim=-1).mean()


def jasmin_order_stats(attn, k: int, return_indices: bool = False):
    """``[B, H, JAS_ROWS, N]`` order statistics of the maps ``[B, H, N, N]``
    (query rows on the LAST axis): rows 0..3 the 1st, 2nd, k-th and
    (k+1)-th largest entries of each attention row, row 4 the clipped row
    sum. With ``return_indices`` also the ``[B, H, 4, N]`` int32 columns
    the first four rows were taken from."""
    p = attn.float()
    kk = max(k, 1) + 1
    if p.shape[-1] < kk:
        raise ValueError(f"need n >= {kk} keys for k={k}")
    tops, ids = _top_values(p, kk)
    s = _clip(p, _EPS, 1.0).sum(-1)
    ranks = (0, 1, kk - 2, kk - 1)
    stats = torch.stack([tops[r] for r in ranks] + [s], dim=-2)
    if not return_indices:
        return stats
    return stats, torch.stack([ids[r] for r in ranks], dim=-2).int()


def jasmin_from_stats(stats, k: int):
    """JaSMin scalar from ``jasmin_order_stats``-layout statistics
    (``[..., JAS_ROWS, N]``); equals ``jasmin_map_loss`` on the maps."""
    x = _clip(stats[..., :4, :], _EPS, 1.0) / (stats[..., 4:5, :] + _EPS)
    x1, x2, xk, xk1 = (x[..., i, :] for i in range(4))
    g1 = x1 * (1.0 - x1 + x2)
    gk = g1 if k <= 1 else xk * (1.0 - xk + xk1)
    if k == 0:
        loss = torch.log(g1 + _EPS)
    else:
        loss = torch.log(g1 / (gk + _EPS) + _EPS)
    return torch.amax(loss, dim=-1).mean()


def jasmin_trajectory_window(per_eval_losses, num_eval_steps: int):
    """Mean of the last ``int(0.85 * num_eval_steps)`` per-evaluation
    scalars (the window counts grid points although the list is per
    evaluation, as in the reference)."""
    flat = per_eval_losses.reshape(-1)
    window = max(1, min(int(0.85 * num_eval_steps), flat.shape[0]))
    return flat[-window:].mean()
