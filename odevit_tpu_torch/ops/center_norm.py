"""CenterNorm: mean-centering normalization without variance division.

``y = gamma * (d/(d-1)) * (x - mean(x)) + beta`` over the last axis. The
mean is taken in float32 whatever the compute dtype; the affine part runs
in the compute dtype (counterpart of ``odevit_tpu/ops/center_norm.py``).
"""

from __future__ import annotations

import torch
from torch import nn


def center_norm(x, weight, bias, *, dtype=None):
    """Functional CenterNorm over the last axis.

    Args:
      x: [..., D] input.
      weight: [D] scale.
      bias: [D] shift.
      dtype: optional compute dtype for the affine part (mean stays f32).
    """
    d = x.shape[-1]
    xf = x.float()
    centered = (xf - xf.mean(-1, keepdim=True)) * (d / (d - 1.0))
    out_dtype = dtype or x.dtype
    centered = centered.to(out_dtype)
    return weight.to(out_dtype) * centered + bias.to(out_dtype)


class CenterNorm(nn.Module):
    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return center_norm(x, self.weight, self.bias, dtype=self.dtype)
