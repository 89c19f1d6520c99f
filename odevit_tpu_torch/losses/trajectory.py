"""Trajectory distillation losses: teacher layer states against the
student's ODE control points.

Counterpart of ``odevit_tpu/losses/trajectory.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def trajectory_mse(student_points, teacher_states, *, full_path=True,
                   normalize=False):
    """CLS-token MSE between aligned student and teacher trajectories.

    ``student_points`` [Q, B, N_s, D] and ``teacher_states`` [Q, B, N_t, D]
    (layers 1..L). ``full_path``: the per-control-point CLS MSE summed over
    Q (each term also reported); otherwise the final state's only.
    Returns (total, {name: value}).
    """
    t = teacher_states.float()
    s = student_points.float()
    if normalize:
        t, s = _l2_normalize(t), _l2_normalize(s)
    if full_path:
        per_point = ((t[:, :, 0] - s[:, :, 0]) ** 2).mean(dim=(1, 2))
        parts = {f"mse_loss_t@{i}": per_point[i]
                 for i in range(per_point.shape[0])}
        return per_point.sum(), parts
    q = t.shape[0] - 1
    last = ((t[-1, :, 0] - s[-1, :, 0]) ** 2).mean()
    return last, {f"mse_loss_t@{q}": last}


def uniform_checkpoints(num_states: int, num_targets: int) -> np.ndarray:
    """Uniform indices over the trajectory when no control points are
    given: the cumulative sum of the constant ratio T/num_targets, the
    last index decremented."""
    ratio = num_states / num_targets
    idx = np.cumsum(np.full(num_targets, ratio)).astype(np.int64)
    idx[-1] -= 1
    return np.clip(idx, 0, num_states - 1)


def weighted_full_path_mse(student_cls, teacher_cls):
    """Linearly decayed full-path CLS MSE, sum_i (Q - i) mse_i / Q, of
    ``student_cls`` and ``teacher_cls`` [Q, B, D]. Returns (total,
    {name: value})."""
    q = student_cls.shape[0]
    per_point = ((teacher_cls.float() - student_cls.float()) ** 2).mean(
        dim=(1, 2))
    weights = torch.arange(q, 0, -1, dtype=torch.float32,
                           device=per_point.device)
    total = (weights * per_point).sum() / q
    parts = {f"mse_loss_t@{i}": per_point[i] for i in range(q)}
    return total, parts
