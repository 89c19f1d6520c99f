"""Adaptive Dormand-Prince (dopri5) integration.

Counterpart of ``odevit_tpu/core/adaptive.py::odeint_dopri5``: embedded
RK5(4) with FSAL, the same step-size controller, and at most
``max_steps_per_segment`` attempted steps per grid segment (beyond that a
segment stops refining; ``nfe`` and ``max_steps_hit`` report it). Steps are
clamped to the segment's end, so states come out exactly at the grid
points.

Time, step sizes and the controller run in float32 on the host, as JAX's
traced scalars do: with float64 time the clamped last step and the
``t < t_end - 1e-9`` test can decide otherwise. The error ratio is
computed on the state's device and read once per attempted step: on the
GPU each step synchronizes the host with the device once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Dormand-Prince 5(4) tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                11 / 84, 0.0])
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])

SAFETY, MIN_FACTOR, MAX_FACTOR, ORDER = 0.9, 0.2, 10.0, 5.0

f32 = np.float32


def _error_ratio(err, y0, y1, rtol: float, atol: float) -> float:
    """RMS of err / (atol + rtol max(|y0|, |y1|)), in float32."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs()).float()
    r = err.float() / scale
    return torch.sqrt((r * r).sum() / r.numel()).item()


def _lc(y, dt, coeffs, ks):
    """y + dt * sum(c_i k_i), accumulated in float32 (each ``dt * c_i``
    formed in float32) and rounded to y's dtype."""
    acc = y.float()
    for c, k in zip(coeffs, ks):
        acc = acc + float(dt * f32(c)) * k.float()
    return acc.to(y.dtype)


def _dopri_step(f, t, y, f0, dt):
    """One embedded step. Returns (y5, f_new (FSAL), err estimate)."""
    ks = [f0]
    for i in range(1, 7):
        yi = _lc(y, dt, _A[i], ks[:len(_A[i])])
        ks.append(f(float(t + dt * f32(_C[i])), yi))
    y5 = _lc(y, dt, _B5, ks)
    err = sum(float(dt * f32(b5 - b4)) * k.float()
              for b5, b4, k in zip(_B5, _B4, ks))
    return y5, ks[6], err       # ks[6] = f(t+dt, y5): FSAL


def odeint_dopri5(f: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-5,
                  atol: float = 1e-6, max_steps_per_segment: int = 64,
                  first_step: float = None):
    """Integrate dy/dt = f(t, y) adaptively, reporting states at ``ts``.

    Returns (states [T, ...], info) where info = {"nfe": int,
    "max_steps_hit": bool}.
    """
    ts = np.asarray(ts, np.float32)
    dt = f32(first_step) if first_step is not None else \
        f32(ts[1] - ts[0]) / f32(8.0)
    y, f0 = y0, f(float(ts[0]), y0)
    nfe, hit = 1, False
    states = [y0]
    for t_start, t_end in zip(ts[:-1], ts[1:]):
        t, steps = t_start, 0
        while t < t_end - f32(1e-9) and steps < max_steps_per_segment:
            dt_c = min(dt, t_end - t)
            y5, f_new, err = _dopri_step(f, t, y, f0, dt_c)
            ratio = f32(_error_ratio(err, y, y5, rtol, atol))
            factor = np.clip(f32(SAFETY) * (ratio + f32(1e-12))
                             ** f32(-1.0 / ORDER), f32(MIN_FACTOR),
                             f32(MAX_FACTOR))
            if ratio <= 1.0:
                t, y, f0 = t + dt_c, y5, f_new
            dt = dt_c * factor
            steps += 1
            nfe += 6
        hit = hit or steps >= max_steps_per_segment
        states.append(y)
    return torch.stack(states, dim=0), {"nfe": nfe, "max_steps_hit": hit}
