"""Control-point selection: the 12 teacher layers mapped onto the T-step
student trajectory.

Counterpart of ``odevit_tpu/losses/control_points.py`` (numpy only, kept
here as the port's own copy): the teacher's per-layer CLS displacement
magnitudes (measured on DINO ViT-B/16) are softmaxed at a temperature,
scaled by T, rounded and summed cumulatively into trajectory indices; the
last index is clamped to T-1. Temperature and T are configuration, so the
indices are plain integers known before the step runs.
"""

from __future__ import annotations

import numpy as np

# Mean L2 displacement between consecutive hidden states of a trained
# DINO ViT-B/16, per layer.
VIT_LAYER_DISPLACEMENTS = np.array(
    [19.99450625, 12.949505, 5.35348687, 4.86699219, 4.81463781, 4.52093875,
     5.21054063, 5.69734125, 6.1311925, 6.05176188, 6.4614325, 53.514895],
    dtype=np.float32)

# The same measurement for the Macaron variant's teacher.
MACARON_LAYER_DISPLACEMENTS = np.array(
    [19.9335, 12.61485625, 13.10309922, 14.70024375, 15.15418125,
     17.1821, 14.34054062, 18.23386562, 23.4014875, 14.24714063,
     29.36258125, 171.6232875],
    dtype=np.float32)


def proportional_control_points(
    num_eval_steps: int,
    temperature: float,
    displacements: np.ndarray = VIT_LAYER_DISPLACEMENTS,
    clamp_last: bool = True,
) -> np.ndarray:
    """Trajectory indices of the teacher-layer control points.

    softmax(displacements / temperature) * T, rounded half to even,
    summed cumulatively; with ``clamp_last`` the final index is T-1. All
    indices are clipped into [0, T-1].
    """
    x = displacements.astype(np.float32) / np.float32(temperature)
    e = np.exp(x - np.max(x))
    probs = e / e.sum()
    steps = np.round(probs * num_eval_steps)
    idx = np.cumsum(steps).astype(np.int64)
    if clamp_last:
        idx[-1] = num_eval_steps - 1
    return np.clip(idx, 0, num_eval_steps - 1)
