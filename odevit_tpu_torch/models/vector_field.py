"""The ODE vector field: one transformer block integrated over time.

Counterpart of ``ParallelVectorField`` in
``odevit_tpu/models/vector_field.py``:
``dx/dt = (MLP(CN_m(x)) + Attn(CN_a(x))) * scaler`` — parallel sublayers,
pre-CenterNorm, no residual (the solver adds it). Time conditioning, L2
attention and the Macaron field are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.kernels.vector_field import VFWeights
from odevit_tpu_torch.ops.attention import SoftmaxSelfAttention
from odevit_tpu_torch.ops.center_norm import CenterNorm
from odevit_tpu_torch.ops.mlp import Mlp


def drift_scaler(emulate_depth: float, time_interval: float) -> float:
    """emulate_depth when integrating over [0, 1], else 1.0."""
    return float(emulate_depth) if time_interval == 1.0 else 1.0


class ParallelVectorField(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 emulate_depth: float = 12.0, time_interval: float = 12.0,
                 l2_attention: bool = False, time_conditioning: bool = False,
                 dtype=None, *, generator: torch.Generator):
        super().__init__()
        if l2_attention:
            raise NotImplementedError("L2 attention is not ported yet")
        if time_conditioning:
            raise NotImplementedError("time conditioning is not ported yet")
        self.num_heads = num_heads
        self.scaler = drift_scaler(emulate_depth, time_interval)
        self.norm_attn = CenterNorm(dim, dtype=dtype)
        self.norm_mlp = CenterNorm(dim, dtype=dtype)
        self.attn = SoftmaxSelfAttention(dim, num_heads, dtype=dtype,
                                         generator=generator)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       generator=generator)

    def forward(self, x, t=None):
        """[B, N, D] -> (dx [B, N, D], attention maps [B, H, N, N])."""
        g, maps = self.attn(self.norm_attn(x))
        f = self.mlp(self.norm_mlp(x))
        return (f + g) * self.scaler, maps

    def kernel_weights(self, dtype) -> VFWeights:
        """The weights as the fused kernel takes them: ``[in, out]``
        matrices in ``dtype``, norms in float32."""
        def mat(lin):
            return lin.weight.detach().T.to(dtype).contiguous()
        return VFWeights(
            self.norm_attn.weight.detach().float().contiguous(),
            self.norm_attn.bias.detach().float().contiguous(),
            self.norm_mlp.weight.detach().float().contiguous(),
            self.norm_mlp.bias.detach().float().contiguous(),
            mat(self.attn.qkv), mat(self.attn.proj),
            mat(self.mlp.fc1), mat(self.mlp.fc2))
