"""Frozen discrete ViT teacher (the DINO ViT-B/16 architecture).

Counterpart of ``odevit_tpu/teacher/vit.py``: pre-LN encoder blocks
(LayerNorm eps 1e-12), biased query/key/value projections, exact GELU,
a final LayerNorm and an optional classifier on the final CLS state. The
attention maps are float32 softmax rows, so the block computes them
explicitly (no fused attention call). ``hidden_states`` holds the
embedding output and the L layer outputs (before the final LayerNorm),
stacked as one ``[L+1, B, N, D]`` tensor; ``attentions`` is
``[L, B, H, N, N]``.

It is plain PyTorch: the JAX teacher is XLA, not a Pallas kernel, so its
products go to ``torch.matmul``. Weights are drawn from a
``torch.Generator`` seeded with ``seed`` (the DINO checkpoint is not in
the repository); ``from_jax_params`` loads a JAX teacher tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from odevit_tpu_torch.device import resolve_device
from odevit_tpu_torch.ops.init import lecun_linear
from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.patch_embed import patchify


def _dense(fan_in: int, fan_out: int, g: torch.Generator) -> nn.Linear:
    """``lecun_normal`` weight (flax's default), zero bias."""
    return lecun_linear(fan_in, fan_out, g)


def _linear(lin: nn.Linear, x, dtype):
    """flax ``Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(norm: nn.LayerNorm, x):
    """LayerNorm in float32 (flax promotes the input to the parameters'
    float32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class ViTEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 layer_norm_eps: float = 1e-12, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        d, g = hidden_size, generator
        self.num_heads = num_heads
        self.dtype = dtype
        self.layernorm_before = nn.LayerNorm(d, eps=layer_norm_eps)
        self.query = _dense(d, d, g)
        self.key = _dense(d, d, g)
        self.value = _dense(d, d, g)
        self.attn_output = _dense(d, d, g)
        self.layernorm_after = nn.LayerNorm(d, eps=layer_norm_eps)
        self.intermediate = _dense(d, mlp_dim, g)
        self.output = _dense(mlp_dim, d, g)

    def forward(self, x):
        """[B, N, D] -> (x, attention maps [B, H, N, N] in float32)."""
        dtype = self.dtype or x.dtype
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        y = _layer_norm(self.layernorm_before, x)

        def heads(t):
            return t.reshape(b, n, h, hd).transpose(1, 2)

        q = heads(_linear(self.query, y, dtype)) * hd ** -0.5
        k = heads(_linear(self.key, y, dtype))
        v = heads(_linear(self.value, y, dtype))
        attn = torch.softmax(dot32(q, k.transpose(-1, -2)), dim=-1)
        ctx = dot32(attn.to(dtype), v).transpose(1, 2).reshape(b, n, d)
        x = x + _linear(self.attn_output, ctx.to(dtype), dtype)
        y = _layer_norm(self.layernorm_after, x)
        y = F.gelu(_linear(self.intermediate, y, dtype))
        x = x + _linear(self.output, y, dtype)
        return x, attn


class ViTTeacher(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 0, layer_norm_eps: float = 1e-12,
                 dtype=None, in_chans: int = 3, *, device=None,
                 seed: int = 0):
        """``dtype`` is the compute dtype (parameters stay float32; None
        means the images' dtype); ``device=None`` means the GPU (see
        ``resolve_device``). ``num_classes=0``: no classifier."""
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        d = hidden_size
        self.patch_size = patch_size
        self.dtype = dtype
        num_patches = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(
            torch.randn(1, num_patches + 1, d, generator=g) * 0.02)
        fan_in = in_chans * patch_size * patch_size
        bound = math.sqrt(6.0 / (fan_in + d))          # xavier-uniform
        self.patch_kernel = nn.Parameter(
            (torch.rand(fan_in, d, generator=g) * 2.0 - 1.0) * bound)
        self.patch_bias = nn.Parameter(torch.zeros(d))
        self.layers = nn.ModuleList(
            ViTEncoderLayer(d, num_heads, mlp_dim, layer_norm_eps, dtype,
                            generator=g) for _ in range(num_layers))
        self.layernorm = nn.LayerNorm(d, eps=layer_norm_eps)
        self.classifier = (_dense(d, num_classes, g) if num_classes > 0
                           else None)
        self.to(device)

    def forward(self, pixel_values, *, output_hidden_states: bool = True,
                output_attentions: bool = True) -> Dict[str, Any]:
        """[B, H, W, C] images -> {"last_hidden_state", "hidden_states",
        "attentions"[, "logits"]}."""
        dtype = self.dtype or pixel_values.dtype
        patches = patchify(pixel_values.to(dtype), self.patch_size)
        tokens = (dot32(patches, self.patch_kernel.to(dtype))
                  + self.patch_bias).to(dtype)
        b, _, d = tokens.shape
        x = torch.cat([self.cls_token.to(dtype).expand(b, 1, d), tokens], 1)
        x = x + self.position_embeddings.to(dtype)
        hidden_states, attentions = [x], []
        for layer in self.layers:
            x, attn = layer(x)
            hidden_states.append(x)
            attentions.append(attn)
        sequence_output = _layer_norm(self.layernorm, x)
        out: Dict[str, Any] = {"last_hidden_state": sequence_output}
        if output_hidden_states:
            out["hidden_states"] = torch.stack(hidden_states)
        if output_attentions:
            out["attentions"] = torch.stack(attentions)
        if self.classifier is not None:
            out["logits"] = self.classifier(sequence_output[:, 0].float())
        return out

    @classmethod
    def dino_b16(cls, num_classes=0, **kw):
        return cls(image_size=224, patch_size=16, hidden_size=768,
                   num_layers=12, num_heads=12, mlp_dim=3072,
                   num_classes=num_classes, **kw)
