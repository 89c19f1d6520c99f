"""The ODE vector field: one transformer block integrated over time.

Counterpart of ``ParallelVectorField`` in
``odevit_tpu/models/vector_field.py``:
``dx/dt = (MLP(CN_m(x)) + Attn(CN_a(x))) * scaler`` — parallel sublayers,
pre-CenterNorm, no residual (the solver adds it). The attention is softmax,
or with ``l2_attention`` the L2-distance variant with biased projections.
Time conditioning and the Macaron field are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.kernels.vector_field import VFWeights
from odevit_tpu_torch.ops.attention import (L2SelfAttention,
                                            SoftmaxSelfAttention)
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
        if time_conditioning:
            raise NotImplementedError("time conditioning is not ported yet")
        self.num_heads = num_heads
        self.l2_attention = l2_attention
        self.scaler = drift_scaler(emulate_depth, time_interval)
        self.norm_attn = CenterNorm(dim, dtype=dtype)
        self.norm_mlp = CenterNorm(dim, dtype=dtype)
        attn = L2SelfAttention if l2_attention else SoftmaxSelfAttention
        self.attn = attn(dim, num_heads, dtype=dtype, generator=generator)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       generator=generator)

    def forward(self, x, t=None):
        """[B, N, D] -> (dx [B, N, D], attention maps [B, H, N, N])."""
        g, maps = self.attn(self.norm_attn(x))
        f = self.mlp(self.norm_mlp(x))
        return (f + g) * self.scaler, maps

    def kernel_weights(self, dtype) -> VFWeights:
        """The weights as the fused kernel takes them: ``[in, out]``
        matrices in ``dtype``, norms in float32. L2 attention's
        ``wqkv`` is ``[Wq | Wk | Wv]``, and its biases come in float32 as
        ``qkv_bias = [bq | bk | bv]`` and ``out_bias``."""
        def f32(t):
            return t.detach().float().contiguous()

        def mat(*lins):
            return torch.cat([lin.weight.detach().T for lin in lins],
                             1).to(dtype).contiguous()
        a = self.attn
        norms = (f32(self.norm_attn.weight), f32(self.norm_attn.bias),
                 f32(self.norm_mlp.weight), f32(self.norm_mlp.bias))
        mlp = (mat(self.mlp.fc1), mat(self.mlp.fc2))
        if not self.l2_attention:
            return VFWeights(*norms, mat(a.qkv), mat(a.proj), *mlp)
        return VFWeights(*norms, mat(a.q, a.k, a.v), mat(a.out), *mlp,
                         qkv_bias=f32(torch.cat([a.q.bias, a.k.bias,
                                                 a.v.bias])),
                         out_bias=f32(a.out.bias))
