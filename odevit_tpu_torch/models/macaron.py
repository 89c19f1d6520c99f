"""ViTMacaron: the Macaron continuous-depth ViT.

Counterpart of ``odevit_tpu/models/macaron.py``: a biased patch projection
(``patch_proj``), a CLS token (optionally seeded by a learned initial-value
problem: a 5x5 VALID convolution, GELU, spatial mean, and a Dense over
[CLS | ivp] with GELU), an optional distillation token and learned
positions -> fixed-grid integration of the Macaron vector field
(half-FFN -> attention -> half-FFN, LayerNorms, a shared FFN, a learnable
``res_scale``) -> float32 LayerNorm (``norm_head``) and linear head on the
final CLS state (``norm_dist``/``dist_head`` on the distillation token).
No register tokens. The module carries the configuration and the
parameters; ``forward`` is the plain PyTorch path on a fixed grid, as the
flax module computes it. The fused path is
:func:`odevit_tpu_torch.models.fast_forward.fast_forward`.

Dtypes, as in JAX: ``dtype`` is the compute dtype and the parameters stay
float32. The patch projection's float32 bias promotes the tokens, so at
``dtype=bfloat16`` the tokens and every state are float32 (the fused path
runs the kernels' float32 instance). The dropout rates are read by the
fused training step only, which rejects nonzero rates as JAX's does.
Labels, hidden states and control points are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from odevit_tpu_torch.core.integrators import odeint
from odevit_tpu_torch.device import resolve_device
from odevit_tpu_torch.models.vector_field import MacaronVectorField
from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.init import (lecun_linear, lecun_normal,
                                       truncated_normal)
from odevit_tpu_torch.ops.layer_norm import LayerNorm, layer_norm
from odevit_tpu_torch.ops.patch_embed import patchify


class ViTMacaron(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4,
                 in_chans: int = 3, num_classes: int = 100,
                 embed_dim: int = 192, num_heads: int = 3,
                 mlp_ratio: float = 4.0, emulate_depth: float = 12.0,
                 time_interval: float = 12.0, num_eval_steps: int = 48,
                 solver: str = "rk4", add_distillation_token: bool = False,
                 learn_ivp: bool = False, dtype=None, *,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 mlp_drop: float = 0.0, device=None, seed: int = 0):
        """``device=None`` means the GPU (see ``resolve_device``). Weights
        are drawn on the CPU from a ``torch.Generator`` seeded with
        ``seed``: the patch projection, the IVP layers and the heads
        LeCun-normal (flax's Dense and Conv default), the tokens
        trunc-normal(0.02), the attention Xavier-normal, the FFN
        trunc-normal(1e-3); biases zero."""
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch_size {patch_size}")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.emulate_depth = emulate_depth
        self.time_interval = time_interval
        self.num_eval_steps = num_eval_steps
        self.solver = solver
        self.add_distillation_token = add_distillation_token
        self.learn_ivp = learn_ivp
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.mlp_drop = mlp_drop
        self.dtype = dtype
        d = embed_dim
        patch_dim = in_chans * patch_size * patch_size
        self.patch_proj = lecun_linear(patch_dim, d, g)
        self.cls_token = nn.Parameter(truncated_normal((1, 1, d), g))
        self.dist_token = (nn.Parameter(truncated_normal((1, 1, d), g))
                           if add_distillation_token else None)
        extra = 2 if add_distillation_token else 1
        self.pos_embed = nn.Parameter(truncated_normal(
            (1, extra + self.num_patches, d), g))
        self.init_ivp = self.ivp_projector = None
        if learn_ivp:
            self.init_ivp = nn.Conv2d(in_chans, d, 5)
            with torch.no_grad():
                self.init_ivp.weight.copy_(lecun_normal(
                    self.init_ivp.weight.shape, in_chans * 25, g))
                self.init_ivp.bias.zero_()
            self.ivp_projector = lecun_linear(2 * d, d, g)
        self.vf = MacaronVectorField(
            d, num_heads, mlp_ratio, mlp_drop, emulate_depth, time_interval,
            dtype=dtype, generator=g)
        self.norm_head = LayerNorm(d)
        self.head = lecun_linear(d, num_classes, g)
        self.norm_dist = self.dist_head = None
        if add_distillation_token:
            self.norm_dist = LayerNorm(d)
            self.dist_head = lecun_linear(d, num_classes, g)
        self.to(device)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return (2 if self.add_distillation_token else 1) + self.num_patches

    def make_time_grid(self) -> np.ndarray:
        return np.linspace(0.0, self.time_interval, self.num_eval_steps)

    def embed(self, images, fused: bool = False):
        """[B, H, W, C] images -> [B, seq_len, D] tokens (float32 whenever
        the parameters are). ``fused=False`` computes as the flax module
        does (each layer in the promoted dtype: float32 weights on the
        rounded images); ``fused=True`` as ``fast_forward_macaron`` does
        (the patch projection and the IVP convolution with their kernels
        cast to the compute dtype, their products rounded there)."""
        dtype = self.dtype or images.dtype
        d = self.embed_dim
        wdt = dtype if fused else torch.promote_types(dtype, torch.float32)
        patches = patchify(images.to(dtype), self.patch_size)
        x = (patches.to(wdt) @ self.patch_proj.weight.T.to(wdt)
             + self.patch_proj.bias)
        b = x.shape[0]
        cls = self.cls_token.to(dtype).expand(b, 1, d)
        if self.learn_ivp:
            img = images.to(dtype).permute(0, 3, 1, 2).to(wdt)
            ivp = nn.functional.conv2d(img, self.init_ivp.weight.to(wdt))
            ivp = nn.functional.gelu(ivp + self.init_ivp.bias[:, None, None])
            ivp = ivp.mean((2, 3))
            ivp = torch.cat([cls[:, 0].to(ivp.dtype), ivp], -1)
            proj = self.ivp_projector
            cls = nn.functional.gelu(
                dot32(ivp, proj.weight.T.to(wdt)) + proj.bias)[:, None]
        parts = [cls]
        if self.dist_token is not None:
            parts.append(self.dist_token.to(dtype).expand(b, 1, d))
        parts.append(x)
        out_dtype = parts[0].dtype
        for t in parts[1:]:
            out_dtype = torch.promote_types(out_dtype, t.dtype)
        tokens = torch.cat([t.to(out_dtype) for t in parts], 1)
        return tokens + self.pos_embed.to(dtype)

    def head_logits(self, final, fused: bool = False):
        """{"logits"[, "logits_dist"]} from the final state: the float32
        LayerNorm of CLS (and of the distillation token), then the head.
        ``fused=True`` takes ``fast_forward_macaron``'s two-pass norm, else
        flax's ``nn.LayerNorm``."""
        def norm(module, t):
            t = t.float()
            return (layer_norm(t, module.weight, module.bias) if fused
                    else module(t))
        out = {"logits": self.head(norm(self.norm_head, final[:, 0]))}
        if self.dist_head is not None:
            out["logits_dist"] = self.dist_head(
                norm(self.norm_dist, final[:, 1]))
        return out

    def forward(self, pixel_values, labels=None, *,
                output_hidden_states: bool = False,
                output_control_points: bool = False,
                t_grid=None) -> Dict[str, torch.Tensor]:
        """[B, H, W, C] images -> {"logits"[, "logits_dist"]}."""
        wanted = {"labels": labels is not None,
                  "output_hidden_states": output_hidden_states,
                  "output_control_points": output_control_points}
        asked = [k for k, v in wanted.items() if v]
        if asked:
            raise NotImplementedError(f"{asked} are not ported yet")
        tokens = self.embed(pixel_values)
        ts = self.make_time_grid() if t_grid is None else np.asarray(t_grid)
        final = odeint(lambda t, y: self.vf(y, t)[0], tokens, ts,
                       method=self.solver, return_states=False)
        return self.head_logits(final)
