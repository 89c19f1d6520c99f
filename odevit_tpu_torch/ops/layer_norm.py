"""LayerNorm in float32, with flax's default eps of 1e-6 (not torch's 1e-5).

Two counterparts, as the JAX package has two:

* :func:`layer_norm` is ``odevit_tpu/models/fast_forward.py::_layer_norm``
  and the Macaron kernels' norm: the mean, then the centred variance,
  ``(x - mean) * rsqrt(var + eps) * scale + bias``;
* :class:`LayerNorm` is flax's ``nn.LayerNorm()`` as the Macaron modules
  hold it (``odevit_tpu/models/vector_field.py::MacaronVectorField``,
  ``odevit_tpu/models/macaron.py``'s ``norm_head`` and ``norm_dist``): the
  variance as ``mean(x^2) - mean(x)^2`` clipped at 0, and
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

Both compute in float32 whatever the input's dtype and return float32.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-6


def layer_norm(x, scale, bias, eps: float = LN_EPS):
    """Two-pass LayerNorm over the last axis; float32 output."""
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: scale (``weight``) initialised to ones,
    bias to zeros; float32 output."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias
