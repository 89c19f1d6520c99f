"""Bias-free GELU MLP of the ODE-ViT vector field.

Counterpart of ``Mlp`` in ``odevit_tpu/ops/mlp.py``: Linear (no bias) ->
exact-erf GELU -> Linear (no bias), matmuls accumulated in float32. The
Macaron FFN is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import spectral_linear


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.fc1 = spectral_linear(dim, hidden_dim, generator)
        self.fc2 = spectral_linear(hidden_dim, dim, generator)

    def forward(self, x):
        dtype = self.dtype or x.dtype
        h = dot32(x.to(dtype), self.fc1.weight.T.to(dtype))
        h = nn.functional.gelu(h)
        return dot32(h.to(dtype), self.fc2.weight.T.to(dtype)).to(dtype)
