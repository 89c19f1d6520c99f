"""Weight initialisers: flax's variance-scaling draws, and spectral
initialisation, Xavier-normal rescaled to unit top singular value.

Every linear map of the vector field starts with sigma_1 = 1 (Lipschitz
<= 1), as in ``odevit_tpu/ops/init.py``. Singular values do not depend on
transposition, so an ``[in, out]`` kernel and an ``nn.Linear`` weight
``[out, in]`` get the same scale.

``lecun_normal`` and ``xavier_normal`` follow flax's
``variance_scaling(1, mode, "truncated_normal")``: a standard normal
truncated to [-2, 2], scaled by sqrt(1 / fan) / 0.87962566..., the std of
that truncated normal, so that the weights' std is sqrt(1 / fan) and
their bound 2.27 of it. ``truncated_normal`` is flax's
``truncated_normal(stddev)``, which does not correct: its std is 0.88
stddev.
"""

from __future__ import annotations

import math

import torch
from torch import nn


# the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(shape, fan: float, generator: torch.Generator,
                      dtype=torch.float32):
    w = torch.empty(shape, dtype=torch.float64)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * (math.sqrt(1.0 / fan) / _TRUNC_STD)).to(dtype)


def lecun_normal(shape, fan_in: int, generator: torch.Generator,
                 dtype=torch.float32):
    """flax's ``lecun_normal``: std sqrt(1 / fan_in), truncated at 2.27
    std (fan_in of a conv: in_chans * kh * kw)."""
    return _variance_scaling(shape, fan_in, generator, dtype)


def xavier_normal(shape, fan_in: int, fan_out: int,
                  generator: torch.Generator, dtype=torch.float32):
    """flax's ``xavier_normal``: std sqrt(2 / (fan_in + fan_out)),
    truncated at 2.27 std."""
    return _variance_scaling(shape, (fan_in + fan_out) / 2.0, generator,
                             dtype)


def spectral_xavier_normal(shape, generator: torch.Generator,
                           dtype=torch.float32):
    """``xavier_normal`` draw of a 2-D ``shape`` divided by its sigma_1.

    Drawn on the CPU from ``generator`` so a seed gives the same weights
    on every device; move the result where it is needed.
    """
    fan_in, fan_out = shape[-2], shape[-1]
    w = xavier_normal(shape, fan_in, fan_out, generator, torch.float64)
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
    """``nn.Linear`` with an ``xavier_normal`` weight and a zero bias, if
    any: the initialisation of the Macaron field's attention."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(xavier_normal((fan_out, fan_in), fan_in, fan_out,
                                       generator))
        if bias:
            lin.bias.zero_()
    return lin


def lecun_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                 bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with a ``lecun_normal`` weight and a zero bias:
    flax's default ``nn.Dense`` initialisation."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(lecun_normal((fan_out, fan_in), fan_in, generator))
        if bias:
            lin.bias.zero_()
    return lin


def truncated_normal(shape, generator: torch.Generator, std: float = 0.02):
    """Normal(0, std) truncated at two standard deviations (flax's
    ``truncated_normal(stddev)``, uncorrected)."""
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=generator)
    return w
