"""Inference path: ViTODE and ViTMacaron forwards through the fused
vector-field kernels.

Counterpart of ``odevit_tpu/models/fast_forward.py::fast_forward`` (a
``ViTMacaron`` takes :func:`fast_forward_macaron`, as JAX's
``fast_forward`` dispatches it):

  * tokens are padded to a multiple of ``TOKEN_PAD`` once before the
    integration and sliced once after; padded tokens get no attention
    and never reach a real token;
  * only the final state is kept (no trajectory);
  * the integration takes one of four routes: dopri5 integrates
    adaptively (``core/adaptive.py``) over one segment ``[ts[0], ts[-1]]``
    with the model's ``solver_rtol``/``solver_atol``, each evaluation a
    plain-f launch; on a uniform grid, Euler runs each step as one kernel
    launch that writes ``y + dt*f(y)``, and rk4 (Kutta 3/8) runs each
    stage as one launch that writes ``base + c*dt*f(y)``; any other grid
    or fixed-grid solver calls the kernel in plain-f mode through the
    generic integrator;
  * L2 attention takes JAX's route for it: the generic integrator on
    every fixed grid and dopri5 for dopri5, each evaluation a plain-f
    launch of the kernel's L2 instance (one CTA per image, or the tiled
    route's past 128 padded tokens); never the Euler, stage-advance or
    chained routes (``ODEVIT_EULER_CHAIN`` is ignored, as JAX ignores it);
  * ``ODEVIT_EULER_CHAIN=c`` opts the Euler route into chains of ``c``
    steps per launch (``vf_euler_chain``) where JAX chains: ``c`` above 1
    and dividing the step count. At shapes on the tiled route a chain runs
    the tiled Euler mode once per step. Elsewhere the variable is ignored,
    as JAX ignores it;
  * the CLS head runs in float32.

On the GPU every evaluation launches a kernel; ``plain=True`` runs the
same routes through the kernels' plain PyTorch versions instead, for
comparisons. A model that is neither a ``ViTODE`` nor a ``ViTMacaron``
raises; time conditioning raises when the model is built.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from odevit_tpu_torch.core.adaptive import odeint_dopri5
from odevit_tpu_torch.core.integrators import odeint
from odevit_tpu_torch.kernels.macaron import macaron_eval
from odevit_tpu_torch.kernels.vector_field import (pad_tokens, vf_eval,
                                                   vf_euler_chain)
from odevit_tpu_torch.models.macaron import ViTMacaron
from odevit_tpu_torch.models.vit_ode import ViTODE


@torch.inference_mode()
def fast_forward(model, images, *, t_grid=None,
                 plain: bool = False) -> Dict[str, torch.Tensor]:
    """logits = head(odeint(fused_vf, patch_embed(images)))[CLS].

    Args:
      model: a ``ViTODE`` or a ``ViTMacaron``.
      images: [B, H, W, C] preprocessed floats on the model's device.
      t_grid: optional time grid (default ``model.make_time_grid()``).
      plain: run the kernel's plain PyTorch version on the GPU as well.
    Returns {"logits": [B, num_classes] f32[, "logits_dist"]}.
    """
    if isinstance(model, ViTMacaron):
        return fast_forward_macaron(model, images, t_grid=t_grid,
                                    plain=plain)
    if not isinstance(model, ViTODE):
        raise NotImplementedError(
            f"fast_forward takes a ViTODE or a ViTMacaron, not "
            f"{type(model).__name__}")
    ts = model.make_time_grid() if t_grid is None else np.asarray(t_grid)
    uniform = uniform_grid(ts)
    tokens, n = pad_to_kernel(model.patch_embed(images))
    weights = model.vf.kernel_weights(tokens.dtype)

    def vf(y, mode="plain", dt=0.0, base=None):
        return vf_eval(y, weights, num_heads=model.num_heads,
                       scaler=model.vf.scaler, n_real=n, mode=mode, dt=dt,
                       base=base, plain=plain)

    if model.solver == "dopri5":
        # adaptive inference: error-controlled NFE instead of a fixed grid
        states, _ = odeint_dopri5(lambda t, y: vf(y), tokens,
                                  [ts[0], ts[-1]], rtol=model.solver_rtol,
                                  atol=model.solver_atol)
        y = states[-1]
    elif model.solver == "euler" and uniform and not model.l2_attention:
        dt = float(ts[1] - ts[0])
        steps = len(ts) - 1
        # ODEVIT_EULER_CHAIN=c chains c Euler steps per launch where c > 1
        # divides the step count; any other value runs per-step Euler
        chain = int(os.environ.get("ODEVIT_EULER_CHAIN", "1"))
        chain = chain if chain > 1 and steps % chain == 0 else 1
        y = tokens
        if chain > 1:
            for _ in range(steps // chain):
                y = vf_euler_chain(y, weights, num_heads=model.num_heads,
                                   scaler=model.vf.scaler, n_real=n, dt=dt,
                                   chain=chain, plain=plain)
        else:
            for _ in range(steps):
                y = vf(y, "euler", dt)
    elif model.solver == "rk4" and uniform and not model.l2_attention:
        dt = float(ts[1] - ts[0])
        y = tokens
        for _ in range(len(ts) - 1):
            y = _rk4_step(vf, y, dt)
    else:
        y = odeint(lambda t, y: vf(y), tokens, ts, method=model.solver,
                   return_states=False)

    out = {"logits": model.head(y[:, 0].float())}
    if model.dist_head is not None:
        out["logits_dist"] = model.dist_head(y[:, 1].float())
    return out


def pad_to_kernel(tokens):
    """Tokens padded once to a multiple of ``TOKEN_PAD``, and the real
    token count."""
    n = tokens.shape[1]
    n_pad = pad_tokens(n)
    if n_pad != n:
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, n_pad - n))
    return tokens, n


def uniform_grid(ts) -> bool:
    return len(ts) < 3 or bool(np.allclose(np.diff(ts), ts[1] - ts[0]))


@torch.inference_mode()
def fast_forward_macaron(model, images, *, t_grid=None,
                         plain: bool = False) -> Dict[str, torch.Tensor]:
    """A ``ViTMacaron`` through the Macaron kernel, the counterpart of
    ``fast_forward_macaron`` in its serving routes: the embed as that
    function computes it (kernels cast to the compute dtype), tokens padded
    once; on a uniform grid Euler runs each step as one euler-mode launch
    and rk4 (Kutta 3/8) as one euler-mode launch with dt/3 and three
    base-mode launches, the stage bases combined in float32; any other grid
    or solver runs plain-mode launches through the generic integrator. The
    head takes the two-pass float32 LayerNorm."""
    ts = model.make_time_grid() if t_grid is None else np.asarray(t_grid)
    tokens, n = pad_to_kernel(model.embed(images, fused=True))
    weights = model.vf.kernel_weights(tokens.dtype)

    def vf(y, mode="plain", dt=0.0, base=None):
        return macaron_eval(y, weights, num_heads=model.num_heads,
                            scaler=model.vf.scaler, n_real=n, mode=mode,
                            dt=dt, base=base, plain=plain)

    uniform = uniform_grid(ts)
    if model.solver in ("euler", "rk4") and uniform:
        dt = float(ts[1] - ts[0])
        y = tokens
        for _ in range(len(ts) - 1):
            y = vf(y, "euler", dt) if model.solver == "euler" \
                else _rk4_step(vf, y, dt)
    else:
        y = odeint(lambda t, y: vf(y), tokens, ts, method=model.solver,
                   return_states=False)
    return model.head_logits(y, fused=True)


def _rk4_step(vf, y, dt: float):
    """One Kutta-3/8 step with every stage advance inside the kernel:

        y2     = y + dt/3 * k1
        y3     = (2y - y2)                  + dt   * k2
        y4     = (2y2 - y3)                 + dt   * k3
        y_next = (-y/8 + 3/4*y3 + 3/8*y4)   + dt/8 * k4

    The bases are combined in float32 and rounded to the state's dtype.
    """
    def comb(*terms):
        return sum(c * t.float() for c, t in terms).to(y.dtype)

    y2 = vf(y, "euler", dt / 3.0)
    y3 = vf(y2, "base", dt, comb((2.0, y), (-1.0, y2)))
    y4 = vf(y3, "base", dt, comb((2.0, y2), (-1.0, y3)))
    return vf(y4, "base", dt / 8.0,
              comb((-0.125, y), (0.75, y3), (0.375, y4)))
