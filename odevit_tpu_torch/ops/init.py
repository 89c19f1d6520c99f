"""Spectral initialization: Xavier-normal rescaled to unit top singular value.

Every linear map of the vector field starts with sigma_1 = 1 (Lipschitz
<= 1), as in ``odevit_tpu/ops/init.py``. Singular values do not depend on
transposition, so an ``[in, out]`` kernel and an ``nn.Linear`` weight
``[out, in]`` get the same scale.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def spectral_xavier_normal(shape, generator: torch.Generator,
                           dtype=torch.float32):
    """Xavier-normal draw of a 2-D ``shape`` divided by its sigma_1.

    Drawn on the CPU from ``generator`` so a seed gives the same weights
    on every device; move the result where it is needed.
    """
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    w = torch.randn(shape, generator=generator, dtype=torch.float64) * std
    sigma1 = torch.linalg.svdvals(w)[0]
    return (w / sigma1).to(dtype)


def spectral_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                    bias: bool = False) -> nn.Linear:
    """``nn.Linear`` whose weight (``[out, in]``) has sigma_1 = 1 and whose
    bias, if any, is zero."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(spectral_xavier_normal((fan_in, fan_out),
                                                generator).T)
        if bias:
            lin.bias.zero_()
    return lin


def xavier_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                  bias: bool = False) -> nn.Linear:
    """``nn.Linear`` with a Xavier-normal weight (std sqrt(2 / (fan_in +
    fan_out))) and a zero bias, if any: flax's ``xavier_normal``, the
    initialisation of the Macaron field's attention."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        lin.weight.copy_(torch.randn((fan_out, fan_in), generator=generator)
                         * std)
        if bias:
            lin.bias.zero_()
    return lin


def lecun_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                 bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with a LeCun-normal weight (std 1 / sqrt(fan_in),
    truncated at two standard deviations) and a zero bias: flax's default
    ``nn.Dense`` initialisation."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(truncated_normal((fan_out, fan_in), generator,
                                          std=fan_in ** -0.5))
        if bias:
            lin.bias.zero_()
    return lin


def truncated_normal(shape, generator: torch.Generator, std: float = 0.02):
    """Normal(0, std) truncated at two standard deviations."""
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=generator)
    return w
