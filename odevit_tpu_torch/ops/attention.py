"""Self-attention of the ODE-ViT vector field.

Counterparts of ``odevit_tpu/ops/attention.py``:

* ``SoftmaxSelfAttention``: one fused QKV projection, per-head scaled
  dot-product softmax; the returned maps are post-softmax. Bias-free, or
  with ``use_bias`` (the Macaron field's) a ``qkv_bias`` added to the
  float32 qkv and an ``out_bias`` added to the float32 output before it is
  rounded; its weights then start Xavier-normal (``spectral_init=False``)
  instead of spectral.
* ``L2SelfAttention``: the Lipschitz-controlled variant. Separate biased
  q, k, v and out projections; weights ``exp(-||q_i - k_j||^2 / sqrt(hd))``
  divided by (row sum + 1e-8), with the distance in the expanded form
  ``q2 + k2 - 2 q.k`` and no max-subtraction, as JAX computes it (rows
  whose exponentials all underflow give p = 0).

Matmuls accumulate in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import spectral_linear, xavier_linear


def _split_heads(x, num_heads: int):
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


class SoftmaxSelfAttention(nn.Module):
    """Fused-QKV softmax multi-head self-attention (bias-free unless
    ``use_bias``)."""

    def __init__(self, dim: int, num_heads: int, dtype=None, *,
                 use_bias: bool = False, spectral_init: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_bias = use_bias
        linear = spectral_linear if spectral_init else xavier_linear
        self.qkv = linear(dim, 3 * dim, generator, bias=use_bias)
        self.proj = linear(dim, dim, generator, bias=use_bias)

    def forward(self, x):
        """[B, N, D] -> (out [B, N, D], maps [B, H, N, N])."""
        dtype = self.dtype or x.dtype
        qkv = dot32(x.to(dtype), self.qkv.weight.T.to(dtype))
        if self.use_bias:
            qkv = qkv + self.qkv.bias.float()
        q, k, v = qkv.chunk(3, dim=-1)
        head_dim = self.dim // self.num_heads
        q = _split_heads(q, self.num_heads) * head_dim ** -0.5
        k = _split_heads(k, self.num_heads)
        v = _split_heads(v, self.num_heads)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = dot32(attn.to(dtype), v.to(dtype))
        out = _merge_heads(out).to(dtype)
        out = dot32(out, self.proj.weight.T.to(dtype))
        if self.use_bias:
            out = out + self.proj.bias.float()
        return out.to(dtype), attn.to(dtype)


class L2SelfAttention(nn.Module):
    """L2-distance multi-head self-attention with biased projections."""

    def __init__(self, dim: int, num_heads: int, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = spectral_linear(dim, dim, generator, bias=True)
        self.k = spectral_linear(dim, dim, generator, bias=True)
        self.v = spectral_linear(dim, dim, generator, bias=True)
        self.out = spectral_linear(dim, dim, generator, bias=True)

    def forward(self, x):
        """[B, N, D] -> (out [B, N, D], maps [B, H, N, N])."""
        dtype = self.dtype or x.dtype

        def proj(lin, y):
            return (dot32(y.to(dtype), lin.weight.T.to(dtype))
                    + lin.bias.float())

        q = _split_heads(proj(self.q, x), self.num_heads)
        k = _split_heads(proj(self.k, x), self.num_heads)
        v = _split_heads(proj(self.v, x), self.num_heads)
        scale = (self.dim // self.num_heads) ** -0.5
        q2 = (q * q).sum(-1, keepdim=True)
        k2 = (k * k).sum(-1)[:, :, None, :]
        dist2 = q2 + k2 - 2.0 * (q @ k.transpose(-1, -2))
        attn = torch.exp(-dist2 * scale)
        attn = attn / (attn.sum(-1, keepdim=True) + 1e-8)
        out = _merge_heads(dot32(attn.to(dtype), v.to(dtype))).to(dtype)
        out = (dot32(out, self.out.weight.T.to(dtype))
               + self.out.bias.float()).to(dtype)
        return out, attn.to(dtype)
