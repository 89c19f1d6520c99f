"""ViTODE: the continuous-depth Vision Transformer.

Counterpart of ``odevit_tpu/models/vit_ode.py``: patch embed (CLS,
registers, learned positions) -> fixed-grid ODE integration of one
parallel attention+MLP vector field -> linear head on the final CLS state.
The module carries the configuration and the parameters; its ``forward``
is the plain PyTorch path that returns the logits. The serving path with
the fused kernel is :func:`odevit_tpu_torch.models.fast_forward.fast_forward`.
The dropout rates (``attn_drop``, ``proj_drop``, ``mlp_drop``) are read by
the fused training step only; ``forward`` and ``fast_forward`` evaluate
without dropout, as JAX's ``models/fast_forward.py`` does. dopri5 runs
in ``fast_forward`` only, as in JAX. With ``l2_attention`` the vector
field's attention is the L2-distance variant (``ops/attention.py``).
Attention outputs, JaSMin, control points, stability bounds and the loss
are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from odevit_tpu_torch.core.integrators import odeint
from odevit_tpu_torch.device import resolve_device
from odevit_tpu_torch.models.vector_field import ParallelVectorField
from odevit_tpu_torch.ops.init import spectral_linear
from odevit_tpu_torch.ops.patch_embed import PatchEmbed


class ViTODE(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4,
                 in_chans: int = 3, num_classes: int = 100,
                 embed_dim: int = 192, num_heads: int = 3,
                 mlp_ratio: float = 4.0, emulate_depth: float = 12.0,
                 time_interval: float = 12.0, num_eval_steps: int = 24,
                 solver: str = "rk4", add_distillation_token: bool = False,
                 l2_attention: bool = False, register_tokens: int = 4,
                 pos_embed_register_tokens: bool = False,
                 time_conditioning: bool = False, dtype=None, *,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 mlp_drop: float = 0.0, solver_rtol: float = 1e-5,
                 solver_atol: float = 1e-6, device=None, seed: int = 0):
        """``dtype`` is the compute dtype (parameters stay float32);
        ``device=None`` means the GPU (see ``resolve_device``). Weights are
        drawn on the CPU from a ``torch.Generator`` seeded with ``seed``.
        ``solver_rtol``/``solver_atol`` control dopri5's error in
        ``fast_forward``; the fixed-grid solvers ignore them."""
        super().__init__()
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
        self.solver_rtol = solver_rtol
        self.solver_atol = solver_atol
        self.l2_attention = l2_attention
        self.add_distillation_token = add_distillation_token
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.mlp_drop = mlp_drop
        self.dtype = dtype
        self.patch_embed = PatchEmbed(
            img_size, patch_size, in_chans, embed_dim,
            add_distillation_token=add_distillation_token,
            register_tokens=register_tokens,
            pos_embed_register_tokens=pos_embed_register_tokens,
            dtype=dtype, generator=g)
        self.vf = ParallelVectorField(
            embed_dim, num_heads, mlp_ratio, emulate_depth, time_interval,
            l2_attention=l2_attention, time_conditioning=time_conditioning,
            dtype=dtype, generator=g)
        self.head = spectral_linear(embed_dim, num_classes, g, bias=True)
        self.dist_head = (spectral_linear(embed_dim, num_classes, g,
                                          bias=True)
                          if add_distillation_token else None)
        self.to(device)

    def make_time_grid(self) -> np.ndarray:
        return np.linspace(0.0, self.time_interval, self.num_eval_steps)

    def forward(self, pixel_values, labels=None, *,
                output_hidden_states: bool = False,
                output_control_points: bool = False,
                output_attentions: bool = False,
                output_attention_trajectory: bool = False,
                output_stability_bounds: bool = False,
                t_grid=None) -> Dict[str, torch.Tensor]:
        """[B, H, W, C] images -> {"logits"[, "logits_dist"]}."""
        wanted = {"labels": labels is not None,
                  "output_hidden_states": output_hidden_states,
                  "output_control_points": output_control_points,
                  "output_attentions": output_attentions,
                  "output_attention_trajectory": output_attention_trajectory,
                  "output_stability_bounds": output_stability_bounds}
        asked = [k for k, v in wanted.items() if v]
        if asked:
            raise NotImplementedError(f"{asked} are not ported yet")
        if self.solver == "dopri5":
            # as the flax model, whose ODEBlock integrates fixed grids only
            raise NotImplementedError(
                "forward integrates fixed grids; dopri5 runs in fast_forward")
        tokens = self.patch_embed(pixel_values)
        ts = self.make_time_grid() if t_grid is None else np.asarray(t_grid)
        final = odeint(lambda t, y: self.vf(y, t)[0], tokens, ts,
                       method=self.solver, return_states=False)
        out = {"logits": self.head(final[:, 0].float())}
        if self.dist_head is not None:
            out["logits_dist"] = self.dist_head(final[:, 1].float())
        return out

    # --- convenience configs -------------------------------------------

    @classmethod
    def tiny_cifar(cls, num_classes=10, **kw):
        """The small free-training CIFAR config."""
        kw.setdefault("solver", "rk4")
        return cls(img_size=32, patch_size=4, embed_dim=192, num_heads=3,
                   mlp_ratio=4.0, num_classes=num_classes, emulate_depth=12,
                   time_interval=1.0, num_eval_steps=12, register_tokens=4,
                   **kw)

    @classmethod
    def base_224(cls, num_classes=100, **kw):
        """The TS-Base distillation student (Euler on 36 points unless
        ``solver``/``num_eval_steps`` say otherwise: served on 25)."""
        kw.setdefault("solver", "euler")
        kw.setdefault("num_eval_steps", 36)
        return cls(img_size=224, patch_size=16, embed_dim=768, num_heads=12,
                   mlp_ratio=1.0, num_classes=num_classes, emulate_depth=12,
                   time_interval=1.0, register_tokens=10,
                   pos_embed_register_tokens=False, **kw)
