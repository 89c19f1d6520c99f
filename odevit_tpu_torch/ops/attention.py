"""Softmax self-attention of the ODE-ViT vector field.

Counterpart of ``SoftmaxSelfAttention`` in ``odevit_tpu/ops/attention.py``:
one fused QKV projection, no bias, per-head scaled dot-product softmax.
Matmuls accumulate in float32; the returned maps are post-softmax. The
L2-distance variant is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import spectral_linear


def _split_heads(x, num_heads: int):
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


class SoftmaxSelfAttention(nn.Module):
    """Fused-QKV softmax multi-head self-attention (bias-free)."""

    def __init__(self, dim: int, num_heads: int, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = spectral_linear(dim, 3 * dim, generator)
        self.proj = spectral_linear(dim, dim, generator)

    def forward(self, x):
        """[B, N, D] -> (out [B, N, D], maps [B, H, N, N])."""
        dtype = self.dtype or x.dtype
        qkv = dot32(x.to(dtype), self.qkv.weight.T.to(dtype))
        q, k, v = qkv.chunk(3, dim=-1)
        head_dim = self.dim // self.num_heads
        q = _split_heads(q, self.num_heads) * head_dim ** -0.5
        k = _split_heads(k, self.num_heads)
        v = _split_heads(v, self.num_heads)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = dot32(attn.to(dtype), v.to(dtype))
        out = _merge_heads(out).to(dtype)
        out = dot32(out, self.proj.weight.T.to(dtype)).to(dtype)
        return out, attn.to(dtype)
