"""Patch embedding with CLS and register tokens.

Counterpart of ``odevit_tpu/ops/patch_embed.py``. Images are NHWC, as in
the JAX package. The stride-p convolution is a space-to-depth reshape and
one ``[B*N, p*p*C] x [p*p*C, D]`` matmul, with each patch flattened in
channel-major (C, ph, pw) order. Token order: CLS, [dist], patches,
registers. With ``pos_embed_register_tokens=False`` the positional table
covers only the first ``num_patches + 1`` tokens.
"""

from __future__ import annotations

import torch
from torch import nn

from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import spectral_xavier_normal, truncated_normal


def patchify(images, patch_size: int):
    """[B, H, W, C] -> [B, (H/p)*(W/p), C*p*p], channel-major per patch."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4)          # [B, gh, gw, C, p, p]
    return x.reshape(b, gh * gw, c * p * p)


class PatchEmbed(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4,
                 in_chans: int = 3, embed_dim: int = 192,
                 add_distillation_token: bool = False,
                 register_tokens: int = 4,
                 pos_embed_register_tokens: bool = True, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.add_distillation_token = add_distillation_token
        self.num_registers = register_tokens
        self.dtype = dtype
        d = embed_dim
        self.proj_kernel = nn.Parameter(spectral_xavier_normal(
            (in_chans * patch_size * patch_size, d), generator))
        self.proj_bias = nn.Parameter(torch.zeros(d))
        self.cls_token = nn.Parameter(truncated_normal((1, 1, d), generator))
        self.register_tokens = (
            nn.Parameter(truncated_normal((register_tokens, d), generator))
            if register_tokens > 0 else None)
        self.dist_token = (
            nn.Parameter(truncated_normal((1, 1, d), generator))
            if add_distillation_token else None)
        pos_len = self.num_patches + 1
        if pos_embed_register_tokens:
            pos_len += register_tokens
        self.pos_embed = nn.Parameter(
            truncated_normal((1, pos_len, d), generator))

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        prefix = 2 if self.add_distillation_token else 1
        return prefix + self.num_patches + self.num_registers

    def forward(self, images):
        """[B, H, W, C] -> [B, seq_len, D] tokens in the compute dtype."""
        dtype = self.dtype or images.dtype
        d = self.embed_dim
        patches = patchify(images.to(dtype), self.patch_size)
        tokens = (dot32(patches, self.proj_kernel.to(dtype))
                  + self.proj_bias).to(dtype)
        b = tokens.shape[0]
        parts = [self.cls_token.to(dtype).expand(b, 1, d)]
        if self.dist_token is not None:
            parts.append(self.dist_token.to(dtype).expand(b, 1, d))
        parts.append(tokens)
        if self.register_tokens is not None:
            parts.append(self.register_tokens.to(dtype)[None].expand(
                b, self.num_registers, d))
        x = torch.cat(parts, dim=1)
        n_pos = self.pos_embed.shape[1]
        head = x[:, :n_pos] + self.pos_embed.to(dtype)
        return torch.cat([head, x[:, n_pos:]], dim=1)
