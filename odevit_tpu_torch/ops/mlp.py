"""Feed-forward blocks of the ODE-ViT vector fields.

Counterparts of ``odevit_tpu/ops/mlp.py``:

* ``Mlp``: the bias-free GELU MLP of the parallel field, Linear (no bias)
  -> exact-erf GELU -> Linear (no bias), matmuls accumulated in float32;
* ``MacaronFFN``: the biased FFN shared by both half steps of the Macaron
  field, trunc-normal(1e-3) weights and zero biases. As flax's
  ``nn.Dense(dtype=...)`` computes it, each layer takes its input, weight
  and bias in the compute dtype and rounds its output there (then GELU).
  The dropout rate is carried for the fused step, which rejects nonzero
  rates as JAX's does; ``forward`` evaluates without dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import spectral_linear, truncated_normal


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


class MacaronFFN(nn.Module):
    """dim -> hidden -> dim, biased, GELU between."""

    def __init__(self, dim: int, hidden_dim: int, drop: float = 0.0,
                 dtype=None, *, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.drop = drop
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        with torch.no_grad():
            for lin in (self.fc1, self.fc2):
                lin.weight.copy_(truncated_normal(
                    lin.weight.shape, generator, std=1e-3))
                lin.bias.zero_()

    def forward(self, x):
        dtype = self.dtype or x.dtype

        def dense(lin, y):
            out = dot32(y.to(dtype), lin.weight.T.to(dtype)).to(dtype)
            return out + lin.bias.to(dtype)

        h = nn.functional.gelu(dense(self.fc1, x))
        return dense(self.fc2, h)
