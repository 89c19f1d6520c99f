"""The fused free-training step: CE + JaSMin through the fused kernels.

Counterpart of ``odevit_tpu/train/fast_steps.py::fast_free_forward`` and
``make_fast_free_train_step`` in their deterministic softmax route:

  * patch embed, tokens padded once to a multiple of ``TOKEN_PAD``;
  * the solver grid's head (all but the JaSMin window) runs plain-mode
    evaluations through ``FusedVF``; the tail, the last
    ``ceil(int(0.85 T) / stages)`` steps, runs JaSMin-statistics
    evaluations through ``FusedVFJasmin`` with ``jasmin_from_stats`` per
    evaluation; ``jasmin_trajectory_window`` keeps the last
    ``int(0.85 T)`` of them;
  * the head on the final CLS state in float32, CE with label smoothing
    0.05; loss = CE + JaSMin;
  * the backward of every evaluation is ``vf_bwd``; no remat (at B=1024
    the 48 saved inputs take about 1.5 GB);
  * AdamW after the global-norm clip (``train/state.py``).

On the GPU every evaluation and its backward launch the kernels;
``plain=True`` runs the same route through their plain versions, for
comparisons. Not ported yet, and raising: dropout, residual stashing, the
mesh (data-parallel) step and the attention-map route for sequences
shorter than ``jasmin_k + 1`` tokens (the distillation slice); L2
attention and time conditioning raise when the model is built.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from odevit_tpu_torch.core.integrators import make_step, num_stages
from odevit_tpu_torch.kernels.autograd import (fused_vf, fused_vf_jasmin,
                                               vf_params)
from odevit_tpu_torch.kernels.vector_field import pad_tokens
from odevit_tpu_torch.losses.classification import accuracy, cross_entropy
from odevit_tpu_torch.losses.jasmin import (jasmin_from_stats,
                                            jasmin_trajectory_window)
from odevit_tpu_torch.train.state import TrainState


def _check_route(model, jasmin_k: int, n: int):
    drops = [float(getattr(model, a, 0.0))
             for a in ("attn_drop", "proj_drop", "mlp_drop")]
    if any(drops):
        raise NotImplementedError("dropout in the fused step is not ported "
                                  "yet (the dropout slice)")
    if n < max(jasmin_k, 1) + 1:
        raise NotImplementedError(
            f"{n} tokens are too few for the in-kernel JaSMin statistics "
            f"(k={jasmin_k}); the attention-map route comes with the "
            f"distillation slice")


def jasmin_window(num_eval_steps: int, solver: str):
    """(head steps, tail steps) of the grid: the tail holds the JaSMin
    window of ``int(0.85 T)`` evaluations, rounded up to whole steps."""
    stages = num_stages(solver)
    num_steps = num_eval_steps - 1
    window = max(1, min(int(0.85 * num_eval_steps), num_steps * stages))
    tail = max(1, -(-window // stages))
    return num_steps - tail, tail


def fast_free_forward(model, pixels, labels, *, jasmin_k: int,
                      plain: bool = False):
    """(loss, {"logits", "ce", "jasmin_loss"}), differentiable in the
    model's parameters (see the module docstring)."""
    tokens = model.patch_embed(pixels)
    b, n, d = tokens.shape
    _check_route(model, jasmin_k, n)
    n_pad = pad_tokens(n)
    if n_pad != n:
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, n_pad - n))
    w = model.vf.kernel_weights(tokens.dtype)
    params = vf_params(model.vf)
    kw = dict(num_heads=model.num_heads, scaler=model.vf.scaler, n_real=n,
              plain=plain)

    def f_plain(t, y):
        return fused_vf(y, w, params, **kw)

    def f_jas(t, y):
        dx, stats = fused_vf_jasmin(y, w, params, jas_k=jasmin_k, **kw)
        return dx, jasmin_from_stats(stats[..., :n], jasmin_k)

    # the grid in float32, steps as JAX's scan forms them
    ts = np.linspace(0.0, model.time_interval,
                     model.num_eval_steps).astype(np.float32)
    t_all, dt_all = ts[:-1], ts[1:] - ts[:-1]
    head, _ = jasmin_window(model.num_eval_steps, model.solver)
    step_plain = make_step(model.solver)
    step_jas = make_step(model.solver, has_aux=True)
    y = tokens
    jas = []
    for i, (t, dt) in enumerate(zip(t_all, dt_all)):
        if i < head:
            y = step_plain(f_plain, y, float(t), float(dt))
        else:
            y, aux = step_jas(f_jas, y, float(t), float(dt))
            jas.append(aux)

    logits = model.head(y[:, 0].float())
    ce = cross_entropy(logits, labels, label_smoothing=0.05)
    jas_loss = jasmin_trajectory_window(torch.cat(jas),
                                        model.num_eval_steps)
    return ce + jas_loss, {"logits": logits, "ce": ce,
                           "jasmin_loss": jas_loss}


def make_fast_free_train_step(model, *, jasmin_k: int = 10,
                              preprocess_fn: Optional[Callable] = None,
                              plain: bool = False, mesh=None,
                              stash: bool = False):
    """``step(state, batch) -> (state, metrics)`` for a ``TrainState``
    made by ``create_train_state(model, tx)`` (the state carries the
    optimizer). ``batch`` holds
    ``pixel_values`` [B, H, W, C] and ``labels`` [B] on the model's
    device. Metrics: ``loss`` (CE + JaSMin), ``jasmin_loss``, ``acc`` and
    ``grad_norm`` (before the clip), as tensors on the device."""
    if mesh is not None:
        raise NotImplementedError("the data-parallel (mesh) step is not "
                                  "ported yet (the host-side slice)")
    if stash:
        raise NotImplementedError("residual stashing is not ported yet "
                                  "(its own slice, to be measured again)")

    def step(state: TrainState, batch) -> tuple:
        if state.model is not model:
            raise ValueError("the state was made for another model")
        pixels = batch["pixel_values"]
        if preprocess_fn is not None:
            pixels = preprocess_fn(pixels)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = fast_free_forward(model, pixels, batch["labels"],
                                      jasmin_k=jasmin_k, plain=plain)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "jasmin_loss": aux["jasmin_loss"].detach(),
            "acc": accuracy(aux["logits"].detach(), batch["labels"]),
            "grad_norm": grad_norm}
        return state, metrics

    return step
