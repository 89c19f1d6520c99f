"""Fixed-grid ODE integrators as Python loops.

Counterpart of ``odevit_tpu/core/integrators.py``. Methods and
vector-field evaluations (NFE) per step:
  * ``euler``          — 1
  * ``midpoint``       — 2
  * ``heun``           — 2
  * ``rk4``            — 4, Kutta's 3/8 rule (torchdiffeq's "rk4")
  * ``rk4_classical``  — 4, the classical tableau

``f(t, y)`` returns ``dy``. State updates are computed in float32 and
rounded back to the state's dtype, so a bfloat16 state stays bfloat16 and
is rounded once per update, as in the JAX package.

With ``has_aux=True`` the vector field returns ``(dy, aux)``; aux outputs
are collected per *evaluation* and stacked per step (leading axis: the
stage), as ``odevit_tpu/core/integrators.py`` does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

METHOD_STAGES = {
    "euler": 1,
    "midpoint": 2,
    "heun": 2,
    "rk4": 4,
    "rk4_classical": 4,
}


def num_stages(method: str) -> int:
    try:
        return METHOD_STAGES[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; options: {sorted(METHOD_STAGES)}")


def nfe(method: str, num_grid_points: int) -> int:
    """Total vector-field evaluations for a T-point grid."""
    return num_stages(method) * (num_grid_points - 1)


def _lc(y, dt, terms):
    """y + dt * sum(c_i * k_i), accumulated in float32 and rounded to
    y's dtype. Each coefficient ``dt * c_i`` is formed in float32."""
    acc = y.float()
    for c, k in terms:
        acc = acc + float(np.float32(dt) * np.float32(c)) * k.float()
    return acc.to(y.dtype)


def make_step(method: str, has_aux: bool = False) -> Callable:
    """Build ``step(f, y, t, dt) -> y_next``, or with ``has_aux``
    ``step(f, y, t, dt) -> (y_next, aux)`` where ``aux`` stacks the
    evaluations' aux tensors along a new leading stage axis."""
    third = 1.0 / 3.0

    def call(f, t, y):
        out = f(t, y)
        return out if has_aux else (out, None)

    def done(y_next, auxes):
        if not has_aux:
            return y_next
        return y_next, torch.stack(auxes, dim=0)

    if method == "euler":
        def step(f, y, t, dt):
            k1, a1 = call(f, t, y)
            return done(_lc(y, dt, [(1.0, k1)]), [a1])
    elif method == "midpoint":
        def step(f, y, t, dt):
            k1, a1 = call(f, t, y)
            k2, a2 = call(f, t + dt * 0.5, _lc(y, dt, [(0.5, k1)]))
            return done(_lc(y, dt, [(1.0, k2)]), [a1, a2])
    elif method == "heun":
        def step(f, y, t, dt):
            k1, a1 = call(f, t, y)
            k2, a2 = call(f, t + dt, _lc(y, dt, [(1.0, k1)]))
            return done(_lc(y, dt, [(0.5, k1), (0.5, k2)]), [a1, a2])
    elif method == "rk4":
        # Kutta 3/8 rule (torchdiffeq's "rk4")
        def step(f, y, t, dt):
            k1, a1 = call(f, t, y)
            k2, a2 = call(f, t + dt * third, _lc(y, dt, [(third, k1)]))
            k3, a3 = call(f, t + dt * 2.0 * third,
                          _lc(y, dt, [(-third, k1), (1.0, k2)]))
            k4, a4 = call(f, t + dt,
                          _lc(y, dt, [(1.0, k1), (-1.0, k2), (1.0, k3)]))
            return done(_lc(y, dt, [(0.125, k1), (0.375, k2), (0.375, k3),
                                    (0.125, k4)]), [a1, a2, a3, a4])
    elif method == "rk4_classical":
        def step(f, y, t, dt):
            k1, a1 = call(f, t, y)
            k2, a2 = call(f, t + dt * 0.5, _lc(y, dt, [(0.5, k1)]))
            k3, a3 = call(f, t + dt * 0.5, _lc(y, dt, [(0.5, k2)]))
            k4, a4 = call(f, t + dt, _lc(y, dt, [(1.0, k3)]))
            sixth = 1.0 / 6.0
            return done(_lc(y, dt, [(sixth, k1), (2 * sixth, k2),
                                    (2 * sixth, k3), (sixth, k4)]),
                        [a1, a2, a3, a4])
    else:
        raise ValueError(
            f"unknown method {method!r}; options: {sorted(METHOD_STAGES)}")
    return step


def odeint(f: Callable, y0: torch.Tensor, ts, method: str = "rk4", *,
           return_states: bool = True) -> torch.Tensor:
    """Integrate ``dy/dt = f(t, y)`` over the grid ``ts``.

    Returns the states ``[len(ts), ...]`` with ``states[0] == y0``, or only
    the final state when ``return_states=False``.
    """
    step = make_step(method)
    ts = np.asarray(ts, np.float64)
    t32 = ts[:-1].astype(np.float32)
    dt32 = (ts[1:] - ts[:-1]).astype(np.float32)
    y = y0
    states = [y0]
    for t, dt in zip(t32, dt32):
        y = step(f, y, float(t), float(dt))
        if return_states:
            states.append(y)
    return torch.stack(states, dim=0) if return_states else y
