"""The ODE vector fields: one transformer block integrated over time.

Counterparts of ``odevit_tpu/models/vector_field.py``:

* ``ParallelVectorField``: ``dx/dt = (MLP(CN_m(x)) + Attn(CN_a(x))) *
  scaler`` — parallel sublayers, pre-CenterNorm, no residual (the solver
  adds it). The attention is softmax, or with ``l2_attention`` the
  L2-distance variant with biased projections.
* ``MacaronVectorField``: the sequential Macaron drift, half-FFN ->
  attention -> half-FFN with LayerNorms, one FFN shared by both halves and
  a learnable ``res_scale`` (shape (1,), initialised to ones):
  ``x1 = x + rs/2 FFN(LN1 x)``, ``x2 = x1 + rs Attn(LN2 x1)``,
  ``x3 = x2 + rs/2 FFN(LN3 x2)``, ``dx = x3 * scaler``.

Time conditioning is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.kernels.macaron import MacaronWeights
from odevit_tpu_torch.kernels.vector_field import VFWeights
from odevit_tpu_torch.ops.attention import (L2SelfAttention,
                                            SoftmaxSelfAttention)
from odevit_tpu_torch.ops.center_norm import CenterNorm
from odevit_tpu_torch.ops.layer_norm import LayerNorm
from odevit_tpu_torch.ops.mlp import MacaronFFN, Mlp


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


class MacaronVectorField(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 mlp_drop: float = 0.0, emulate_depth: float = 12.0,
                 time_interval: float = 12.0, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.scaler = drift_scaler(emulate_depth, time_interval)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.attn = SoftmaxSelfAttention(dim, num_heads, dtype=dtype,
                                         use_bias=True, spectral_init=False,
                                         generator=generator)
        self.ffn = MacaronFFN(dim, int(dim * mlp_ratio), drop=mlp_drop,
                              dtype=dtype, generator=generator)
        self.res_scale = nn.Parameter(torch.ones(1))

    def forward(self, x, t=None):
        """[B, N, D] -> (dx [B, N, D], attention maps [B, H, N, N])."""
        rs = self.res_scale
        x1 = x + 0.5 * rs * self.ffn(self.norm1(x))
        delta, maps = self.attn(self.norm2(x1))
        x2 = x1 + rs * delta
        x3 = x2 + 0.5 * rs * self.ffn(self.norm3(x2))
        return x3 * self.scaler, maps

    def kernel_params(self) -> tuple:
        """The float32 parameters in the order the Macaron kernels take
        them (matrices as ``[in, out]`` views), for the autograd Function:
        the gradients flow back to the modules' parameters."""
        a, f = self.attn, self.ffn
        return (self.norm1.weight, self.norm1.bias, self.norm2.weight,
                self.norm2.bias, self.norm3.weight, self.norm3.bias,
                a.qkv.weight.T, a.qkv.bias, a.proj.weight.T, a.proj.bias,
                f.fc1.weight.T, f.fc1.bias, f.fc2.weight.T, f.fc2.bias,
                self.res_scale)

    def kernel_weights(self, dtype) -> MacaronWeights:
        """The weights as the fused kernels take them: ``[in, out]``
        matrices in ``dtype``, everything else in float32."""
        mats = {6, 8, 10, 12}
        return MacaronWeights(*(
            t.detach().to(dtype if i in mats else torch.float32).contiguous()
            for i, t in enumerate(self.kernel_params())))
