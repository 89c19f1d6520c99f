"""The fused training steps: free training (CE + JaSMin) and
teacher-student trajectory distillation, through the fused kernels.

Free training, the counterpart of
``odevit_tpu/train/fast_steps.py::fast_free_forward`` and
``make_fast_free_train_step`` in their deterministic route, softmax or L2
attention:

  * patch embed, tokens padded once to a multiple of ``TOKEN_PAD``;
  * the solver grid's head (all but the JaSMin window) runs plain-mode
    evaluations through ``FusedVF``; the tail, the last
    ``ceil(int(0.85 T) / stages)`` steps, runs JaSMin-statistics
    evaluations through ``FusedVFJasmin`` with ``jasmin_from_stats`` per
    evaluation; ``jasmin_trajectory_window`` keeps the last
    ``int(0.85 T)`` of them;
  * a sequence shorter than ``max(jasmin_k, 1) + 1`` tokens cannot hold
    the statistics' extraction passes: there the tail takes JAX's map
    route, attention-map evaluations through ``FusedVFAttn`` (their maps'
    cotangent in the backward) with ``jasmin_map_loss`` on the maps cut to
    the real tokens;
  * the head on the final CLS state in float32, CE with label smoothing
    0.05; loss = CE + JaSMin;
  * the backward of every evaluation is ``vf_bwd``; no remat (at B=1024
    the 48 saved inputs take about 1.5 GB);
  * AdamW after the global-norm clip (``train/state.py``).

With L2 attention the same route runs the kernels' L2 instances
(``fused_vf``/``fused_vf_jasmin`` with the field's biases in ``params``),
as JAX runs ``fused_vf_l2`` and ``fused_vf_l2_jasmin`` (one CTA per image
where it fits, else the tiled route: the 224 px TS-Base student). As in
JAX, it is deterministic only (dropout raises) and needs ``jasmin_k + 1``
tokens (fewer raise: JAX's L2 path has no map route), and the
distillation step rejects it.

With nonzero dropout rates (the model's ``attn_drop``, ``proj_drop``,
``mlp_drop``) the free step takes JAX's dropout route: the step's ``rng``
(an int) with the step count folded in seeds a CPU ``torch.Generator``
that draws one int32 seed per solver step; stage ``s`` of a step evaluates
with ``step_seed + 0x9E3779B9 * (s + 1)``. The evaluations run the fused
kernels' dropout instances (``FusedVF``/``FusedVFJasmin`` with a seed; the
JaSMin window split as above; the map route's ``FusedVFAttn`` with a seed
on a short sequence), and Euler and Kutta-3/8 rk4 stages are
combined as JAX's ``step_drop`` combines them, with the same casts to the
state's dtype.

Distillation, the counterpart of ``fast_distill_forward`` and
``make_fast_distill_train_step`` (Euler):

  * the step range is cut at the JaSMin window's start and at the
    teacher-layer control points; plain evaluations before the window,
    JaSMin-statistics evaluations in it; the control points' CLS states
    are kept;
  * the final evaluation runs apart, through ``FusedVFAttn``, and its map
    feeds the attention loss (and ``jasmin_map_loss`` when it lies in the
    window); the map is cut to the real tokens before the registers are
    stripped; on a sequence shorter than ``max(jasmin_k, 1) + 1`` tokens
    every evaluation of the window takes that map route, as JAX's;
  * loss = (trajectory MSE + L1 or KL attention loss) * lambda + JaSMin
    (+ CE with label smoothing 0.05 when supervised); the teacher runs
    under ``torch.no_grad()``, without dropout.

With nonzero dropout rates the distillation step takes JAX's seeds: the
step's ``rng`` (an int, required then) with the step count folded in
draws one int32 seed per Euler step (:func:`draw_step_seeds`), and step
``i`` evaluates with ``step_seeds[i]`` itself, without the free step's
per-stage fold; the final evaluation, with its maps, is step
``num_steps - 1``. Every evaluation runs a dropout instance; the JaSMin
statistics and the maps are those of the pre-dropout p (JAX, at D=768,
draws its masks outside the kernels and takes JaSMin from the maps,
``_xla_dropout_eval``; the statistics computed in the kernels are the same
function of the same p).

Macaron free training, the counterpart of ``make_fast_macaron_train_step``:
the embed as ``fast_forward_macaron`` computes it, tokens padded once, the
model's fixed-grid solver over plain-mode evaluations through
``MacaronFunction`` (whose backward is ``macaron_bwd``), the float32 head,
CE without label smoothing; AdamW after the clip. Deterministic only: a
nonzero dropout rate raises, as JAX's assert does.

Residual stashing (``stash=True`` of both steps, JAX's rule): the free
step stashes where ``stash and not l2 and not dropout``, the distillation
step where ``stash and not dropout``. Then the plain and JaSMin-statistics
evaluations run ``FusedVFStash`` / ``FusedVFJasminStash``: each forward
also writes its compute-dtype qkv and pre-GELU hidden, and its backward
reads them instead of recomputing two products. The map-route
evaluations and the distillation step's final map evaluation do not
stash, as in JAX; where JAX ignores the flag (dropout, L2, the map
route) it is ignored here too.

On the GPU every evaluation and its backward launch the kernels (at the
224 px TS-Base shape, the tiled route); ``plain=True`` runs the same route
through their plain versions, for comparisons. Not ported yet, and
raising: the mesh (data-parallel) step and the teacher cache; time
conditioning raises when the model is built.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from odevit_tpu_torch.core.integrators import (_lc, make_step, num_stages,
                                               odeint)
from odevit_tpu_torch.kernels.autograd import (fused_macaron, fused_vf,
                                               fused_vf_attn,
                                               fused_vf_jasmin, vf_params)
from odevit_tpu_torch.kernels.dropout import (check_rates, fold_seed,
                                              philox4x32_plain)
from odevit_tpu_torch.losses.classification import accuracy, cross_entropy
from odevit_tpu_torch.losses.attention_distill import (kl_attention_loss,
                                                       l1_attention_loss)
from odevit_tpu_torch.losses.control_points import \
    proportional_control_points
from odevit_tpu_torch.losses.jasmin import (jasmin_from_stats,
                                            jasmin_map_loss,
                                            jasmin_trajectory_window)
from odevit_tpu_torch.losses.trajectory import trajectory_mse
from odevit_tpu_torch.models.fast_forward import pad_to_kernel
from odevit_tpu_torch.train.state import TrainState


def drop_rates(model):
    """(attn_drop, proj_drop, mlp_drop) of the model."""
    return check_rates([model.attn_drop, model.proj_drop, model.mlp_drop])


def stats_ok(jasmin_k: int, n: int, l2: bool = False) -> bool:
    """Whether the JaSMin window takes the in-kernel statistics (else the
    map route); an L2 model has no map route, as JAX's, and raises."""
    ok = n >= max(jasmin_k, 1) + 1
    if l2 and not ok:
        raise ValueError(f"the fused L2 path needs at least "
                         f"{max(jasmin_k, 1) + 1} tokens for k={jasmin_k} "
                         f"(JAX's has no map route either); got {n}")
    return ok


def jasmin_window(num_eval_steps: int, solver: str):
    """(head steps, tail steps) of the grid: the tail holds the JaSMin
    window of ``int(0.85 T)`` evaluations, rounded up to whole steps."""
    stages = num_stages(solver)
    num_steps = num_eval_steps - 1
    window = max(1, min(int(0.85 * num_eval_steps), num_steps * stages))
    tail = max(1, -(-window // stages))
    return num_steps - tail, tail


def _pad_and_weights(model, pixels, plain: bool):
    tokens, n = pad_to_kernel(model.patch_embed(pixels))
    kw = dict(num_heads=model.num_heads, scaler=model.vf.scaler, n_real=n,
              plain=plain)
    return tokens, model.vf.kernel_weights(tokens.dtype), \
        vf_params(model.vf), kw


def draw_step_seeds(rng: int, step: int, count: int):
    """``count`` int32 step seeds for training step ``step`` of a run
    seeded with ``rng``, uniform in [-2^31, 2^31 - 1) as JAX's ``randint``
    draws them, from a CPU ``torch.Generator``. Its seed folds the step
    into rng, as JAX folds the step into its key: one Philox word of
    counter (step) under key (rng), since the generator keeps 32 bits of
    its seed."""
    lo = lambda v, s=0: (int(v) >> s) & 0xFFFFFFFF
    mix = philox4x32_plain(lo(step), lo(step, 32), 0, 0, lo(rng),
                           lo(rng, 32))[0]
    g = torch.Generator().manual_seed(int(mix))
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (count,), generator=g,
                         dtype=torch.int64).tolist()


def _comb(y, dt: float, terms):
    """``(y + dt * (c_1 k_1 + c_2 k_2 + ...)).astype(y.dtype)`` as JAX's
    ``step_drop`` forms it: the inner sum in the stage slopes' dtype (each
    coefficient rounded to it, as a Python float meeting a bf16 array is),
    the rest in float32."""
    inner = None
    for c, k in terms:
        t = k * torch.tensor(c, dtype=k.dtype, device=k.device)
        inner = t if inner is None else inner + t
    return (y.float() + float(np.float32(dt)) * inner.float()).to(y.dtype)


def _step_drop(solver: str, f, y, dt: float, step_seed: int):
    """One Euler or Kutta-3/8 rk4 step whose stage ``s`` evaluates
    ``f(y_s, seed)`` with seed ``fold_seed(step_seed, s)``; the stage
    states and the update are formed as JAX's ``step_drop`` forms them.
    Returns (y_next, [aux of each stage])."""
    es = lambda s: fold_seed(step_seed, s)
    if solver == "euler":
        k1, a1 = f(y, es(0))
        return _lc(y, dt, [(1.0, k1)]), [a1]
    third = 1.0 / 3.0
    k1, a1 = f(y, es(0))
    k2, a2 = f(_lc(y, dt, [(third, k1)]), es(1))
    k3, a3 = f(_comb(y, dt, [(-third, k1), (1.0, k2)]), es(2))
    k4, a4 = f(_comb(y, dt, [(1.0, k1), (-1.0, k2), (1.0, k3)]), es(3))
    y_next = _comb(y, dt, [(0.125, k1), (0.375, k2), (0.375, k3),
                           (0.125, k4)])
    return y_next, [a1, a2, a3, a4]


def _check_seeds(step_seeds, num_steps: int):
    if step_seeds is None:
        raise ValueError("the model has dropout; pass step_seeds= (the "
                         "train step draws them from its rng)")
    if len(step_seeds) != num_steps:
        raise ValueError(f"{len(step_seeds)} step seeds for "
                         f"{num_steps} solver steps")


def fast_free_forward(model, pixels, labels, *, jasmin_k: int,
                      step_seeds=None, plain: bool = False,
                      stash: bool = False):
    """(loss, {"logits", "ce", "jasmin_loss"}), differentiable in the
    model's parameters (see the module docstring). A model with dropout
    takes ``step_seeds``, one int32 seed per solver step (the train step
    draws them with :func:`draw_step_seeds`). ``stash`` stashes the
    residuals where JAX's rule allows it (module docstring)."""
    drops = drop_rates(model)
    if any(drops) and model.l2_attention:
        raise ValueError("the fused L2 path is deterministic only (as "
                         "JAX's): the model has dropout")
    if any(drops):
        _check_seeds(step_seeds, model.num_eval_steps - 1)
        if model.solver not in ("euler", "rk4"):
            raise ValueError(f"the dropout route stages euler and rk4, not "
                             f"{model.solver!r}")
    tokens, w, params, kw = _pad_and_weights(model, pixels, plain)
    n = kw["n_real"]
    use_stats = stats_ok(jasmin_k, n, model.l2_attention)
    # residual stashing: deterministic softmax evaluations only, as JAX's
    use_stash = stash and not model.l2_attention and not any(drops)

    def jas_eval(y, **drop_kw):
        # the statistics route, or JAX's map route on a short sequence
        if use_stats:
            dx, stats = fused_vf_jasmin(y, w, params, jas_k=jasmin_k,
                                        stash=use_stash, **drop_kw, **kw)
            return dx, jasmin_from_stats(stats[..., :n], jasmin_k)
        dx, maps = fused_vf_attn(y, w, params, **drop_kw, **kw)
        return dx, jasmin_map_loss(maps[:, :, :n, :n], k=jasmin_k)

    def f_plain(t, y):
        return fused_vf(y, w, params, stash=use_stash, **kw)

    def f_jas(t, y):
        return jas_eval(y)

    def f_drop_plain(y, seed):
        return fused_vf(y, w, params, seed=seed, drops=drops, **kw), None

    def f_drop_jas(y, seed):
        return jas_eval(y, seed=seed, drops=drops)

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
        if any(drops):
            y, aux = _step_drop(model.solver,
                                f_drop_plain if i < head else f_drop_jas,
                                y, float(dt), step_seeds[i])
            if i >= head:
                jas.append(torch.stack(aux))
        elif i < head:
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
    """``step(state, batch, rng=None) -> (state, metrics)`` for a
    ``TrainState`` made by ``create_train_state(model, tx)`` (the state
    carries the optimizer). ``batch`` holds ``pixel_values`` [B, H, W, C]
    and ``labels`` [B] on the model's device; ``rng``, an int, seeds the
    dropout of a model with nonzero rates (required then; the step count
    is folded in, so every step draws new masks). ``stash``: residual
    stashing where JAX's rule allows it (module docstring). Metrics:
    ``loss`` (CE + JaSMin), ``jasmin_loss``, ``acc`` and ``grad_norm``
    (before the clip), as tensors on the device."""
    if mesh is not None:
        raise NotImplementedError("the data-parallel (mesh) step is not "
                                  "ported yet (the host-side slice)")

    has_drop = any(drop_rates(model))

    def step(state: TrainState, batch, rng=None) -> tuple:
        if state.model is not model:
            raise ValueError("the state was made for another model")
        step_seeds = None
        if has_drop:
            if rng is None:
                raise ValueError("the model has dropout; pass rng= (an int "
                                 "seed) to the step")
            step_seeds = draw_step_seeds(rng, state.step,
                                         model.num_eval_steps - 1)
        pixels = batch["pixel_values"]
        if preprocess_fn is not None:
            pixels = preprocess_fn(pixels)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = fast_free_forward(model, pixels, batch["labels"],
                                      jasmin_k=jasmin_k,
                                      step_seeds=step_seeds, plain=plain,
                                      stash=stash)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "jasmin_loss": aux["jasmin_loss"].detach(),
            "acc": accuracy(aux["logits"].detach(), batch["labels"]),
            "grad_norm": grad_norm}
        return state, metrics

    return step


def fast_macaron_forward(model, pixels, labels, *, plain: bool = False):
    """(CE loss, logits) of a ``ViTMacaron``, differentiable in its
    parameters: ``fast_forward_macaron(differentiable=True)`` and JAX's
    ``cross_entropy``."""
    tokens, n = pad_to_kernel(model.embed(pixels, fused=True))
    vf = model.vf
    w = vf.kernel_weights(tokens.dtype)
    params = vf.kernel_params()

    def f(t, y):
        return fused_macaron(y, w, params, num_heads=model.num_heads,
                             scaler=vf.scaler, n_real=n, plain=plain)

    y = odeint(f, tokens, model.make_time_grid(), method=model.solver,
               return_states=False)
    logits = model.head_logits(y, fused=True)["logits"]
    return cross_entropy(logits, labels), logits


def make_fast_macaron_train_step(model, *,
                                 preprocess_fn: Optional[Callable] = None,
                                 plain: bool = False, mesh=None):
    """``step(state, batch, rng=None) -> (state, metrics)`` for a
    ``ViTMacaron``'s ``TrainState`` (see the module docstring). Metrics:
    ``loss`` (CE), ``jasmin_loss`` (0: the Macaron family has no JaSMin),
    ``acc`` and ``grad_norm`` (before the clip), as tensors on the device.
    ``rng`` is accepted and unused: the step is deterministic."""
    if mesh is not None:
        raise NotImplementedError("the data-parallel (mesh) step is not "
                                  "ported yet (the host-side slice)")
    if any(drop_rates(model)):
        raise ValueError("the fused Macaron step is deterministic only (as "
                         "JAX's): the model has dropout")

    def step(state: TrainState, batch, rng=None) -> tuple:
        if state.model is not model:
            raise ValueError("the state was made for another model")
        pixels = batch["pixel_values"]
        if preprocess_fn is not None:
            pixels = preprocess_fn(pixels)
        state.optimizer.zero_grad(set_to_none=True)
        loss, logits = fast_macaron_forward(model, pixels, batch["labels"],
                                            plain=plain)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(),
            "jasmin_loss": torch.zeros((), device=loss.device),
            "acc": accuracy(logits.detach(), batch["labels"]),
            "grad_norm": grad_norm}
        return state, metrics

    return step


def fast_distill_forward(model, pixels, labels, t_states, t_attn_last, *,
                         jasmin_k: int, temperature: float,
                         lambda_param: float, mse_full_path: bool = True,
                         use_distillation: bool = True,
                         use_kl_loss: bool = False, supervise: bool = False,
                         step_seeds=None, plain: bool = False,
                         stash: bool = False):
    """(loss, {"metrics", "logits"}) of the distillation student,
    differentiable in the model's parameters (see the module docstring).
    ``t_states``: the teacher's hidden states [L, B, N_t, D] (layers
    1..L); ``t_attn_last``: its last layer's maps [B, H, N_t, N_t]. A
    model with dropout takes ``step_seeds``, one int32 seed per Euler step
    (the train step draws them with :func:`draw_step_seeds`). ``stash``
    stashes the residuals where JAX's rule allows it (module
    docstring)."""
    if model.solver != "euler":
        raise ValueError("the fused distillation step integrates the "
                         f"reference's Euler grid, not {model.solver!r}")
    if model.l2_attention:
        raise ValueError("the fused distillation step takes a softmax "
                         "student, as JAX's does")
    T = model.num_eval_steps
    num_steps = T - 1
    drops = drop_rates(model)
    if any(drops):
        _check_seeds(step_seeds, num_steps)
    tokens, w, params, kw = _pad_and_weights(model, pixels, plain)
    n = kw["n_real"]
    use_stats = stats_ok(jasmin_k, n)
    # residual stashing: deterministic evaluations only, as JAX's
    use_stash = stash and not any(drops)
    reg = model.patch_embed.num_registers
    dt = float(model.time_interval) / num_steps

    def drop_kw(i: int):
        # Euler step i evaluates with step_seeds[i] itself
        return dict(seed=step_seeds[i], drops=drops) if any(drops) else {}

    # the static plan: control-point boundaries and the JaSMin tail
    cps = proportional_control_points(T, temperature)
    window = max(1, min(int(0.85 * T), num_steps))
    tail_start = num_steps - window          # steps >= tail_start score
    cp_set = set(int(i) for i in cps)
    breaks = sorted({0, num_steps, tail_start}
                    | {i for i in cp_set if 0 < i <= num_steps})

    def advance(y, dx):
        return (y + dt * dx).to(y.dtype)

    y = tokens
    state_at = {0: tokens}
    jas = []
    for a, b_ in zip(breaks[:-1], breaks[1:]):
        is_last = b_ == num_steps
        for i in range(a, b_ - (1 if is_last else 0)):
            if a >= tail_start and use_stats:
                dx, stats = fused_vf_jasmin(y, w, params, jas_k=jasmin_k,
                                            stash=use_stash, **kw,
                                            **drop_kw(i))
                jas.append(jasmin_from_stats(stats[..., :n], jasmin_k))
            elif a >= tail_start:
                # JAX's map route on a short sequence
                dx, maps = fused_vf_attn(y, w, params, **kw, **drop_kw(i))
                jas.append(jasmin_map_loss(maps[:, :, :n, :n], k=jasmin_k))
            else:
                dx = fused_vf(y, w, params, stash=use_stash, **kw,
                              **drop_kw(i))
            y = advance(y, dx)
        if is_last:
            # the final evaluation emits its maps for the attention loss;
            # padded rows are cut before the registers are stripped
            dx, maps = fused_vf_attn(y, w, params, **kw,
                                     **drop_kw(num_steps - 1))
            last_attn = maps[:, :, :n, :n]
            if num_steps - 1 >= tail_start:
                jas.append(jasmin_map_loss(last_attn, k=jasmin_k))
            y = advance(y, dx)
        if b_ in cp_set:
            state_at[b_] = y
    state_at[num_steps] = y

    cls_points = torch.stack([state_at[int(i)][:, 0] for i in cps])
    jasmin = jasmin_trajectory_window(torch.stack(jas), T)
    logits = model.head(y[:, 0].float())

    mse, mse_parts = trajectory_mse(cls_points[:, :, None, :],
                                    t_states[:, :, :1],
                                    full_path=mse_full_path)
    rep = mse
    metrics = {"mse_loss": mse, **mse_parts}
    if use_distillation:
        s_attn = last_attn[:, :, :n - reg, :n - reg] if reg else last_attn
        if use_kl_loss:
            kl = kl_attention_loss(s_attn, t_attn_last,
                                   lambda_param=lambda_param,
                                   temperature=temperature)
        else:
            kl = l1_attention_loss(s_attn, t_attn_last,
                                   lambda_param=lambda_param)
        ok = torch.isfinite(kl)
        rep = rep + torch.where(ok, kl, torch.zeros_like(kl))
        metrics["kl_loss"] = kl
        metrics["kl_nonfinite"] = 1.0 - ok.float()
    rep = rep * lambda_param
    loss = rep + jasmin
    ce = cross_entropy(logits, labels, label_smoothing=0.05)
    if supervise:
        loss = loss + ce
    metrics.update({"jasmin_loss": jasmin, "supervision_loss": ce,
                    "loss": loss})
    return loss, {"metrics": metrics, "logits": logits}


def make_fast_distill_train_step(student, teacher, *, lambda_param: float,
                                 jasmin_k: int = 10,
                                 mse_full_path: bool = True,
                                 use_distillation: bool = True,
                                 use_kl_loss: bool = False,
                                 temperature: float = 30.0,
                                 preprocess_fn: Optional[Callable] = None,
                                 plain: bool = False, mesh=None,
                                 teacher_cache: bool = False,
                                 stash: bool = False):
    """``step(state, batch, rng=None, supervise=False) -> (state,
    metrics)`` for a ``TrainState`` of ``student``; ``teacher`` is a
    ``ViTTeacher`` whose forward runs without gradients. ``batch`` holds
    ``pixel_values`` [B, H, W, C] and ``labels`` [B] on the model's device;
    ``rng``, an int, seeds the dropout of a student with nonzero rates
    (required then; the step count is folded in). Metrics, as
    tensors on the device: ``loss``, ``mse_loss``, ``mse_loss_t@i``,
    ``kl_loss``, ``kl_nonfinite``, ``jasmin_loss``, ``supervision_loss``,
    ``acc``, ``grad_norm`` (before the clip) and ``nonfinite``.
    ``stash``: residual stashing where JAX's rule allows it (module
    docstring)."""
    if mesh is not None:
        raise NotImplementedError("the data-parallel (mesh) step is not "
                                  "ported yet (the host-side slice)")
    if teacher_cache:
        raise NotImplementedError("the teacher cache is not ported yet "
                                  "(ROADMAP.md §1)")

    has_drop = any(drop_rates(student))

    def step(state: TrainState, batch, rng=None,
             supervise: bool = False) -> tuple:
        if state.model is not student:
            raise ValueError("the state was made for another model")
        step_seeds = None
        if has_drop:
            if rng is None:
                raise ValueError("the student has dropout; pass rng= (an "
                                 "int seed) to the step")
            step_seeds = draw_step_seeds(rng, state.step,
                                         student.num_eval_steps - 1)
        pixels = batch["pixel_values"]
        if preprocess_fn is not None:
            pixels = preprocess_fn(pixels)
        with torch.no_grad():
            t_out = teacher(pixels)
        t_states = t_out["hidden_states"][1:]
        t_attn_last = t_out["attentions"][-1]
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = fast_distill_forward(
            student, pixels, batch["labels"], t_states, t_attn_last,
            jasmin_k=jasmin_k, temperature=temperature,
            lambda_param=lambda_param, mse_full_path=mse_full_path,
            use_distillation=use_distillation, use_kl_loss=use_kl_loss,
            supervise=supervise, step_seeds=step_seeds, plain=plain,
            stash=stash)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics: Dict[str, torch.Tensor] = {
            k: v.detach() for k, v in aux["metrics"].items()}
        metrics["acc"] = accuracy(aux["logits"].detach(), batch["labels"])
        metrics["grad_norm"] = grad_norm
        metrics["nonfinite"] = 1.0 - torch.isfinite(metrics["loss"]).float()
        return state, metrics

    return step
