"""Loads parameters saved by the JAX package into the port's modules."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ViTODE (or ``ViTMacaron``, or ``ViTTeacher``) params pytree of the
    JAX package -> the port's state dict.

    ``tree`` is ``params`` (not ``{"params": ...}``) as nested dicts of
    numpy arrays; the caller moves it to the host first. Matrices handed to
    ``nn.Linear`` are transposed to ``[out, in]``; the patch projection
    stays a ``[p*p*C, D]`` matmul kernel. The result is on the CPU in
    float32: ``model.load_state_dict`` copies it to the model's device.
    """
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if "patch_kernel" in tree:
        return _teacher_params(tree, t)
    if "patch_proj" in tree and "res_scale" in tree.get("vf", {}):
        return _macaron_params(tree, t)
    pe, vf = tree["patch_embed"], tree["vf"]
    sd = {
        "patch_embed.proj_kernel": t(pe["proj_kernel"]),
        "patch_embed.proj_bias": t(pe["proj_bias"]),
        "patch_embed.cls_token": t(pe["cls_token"]),
        "patch_embed.pos_embed": t(pe["pos_embed"]),
        "vf.norm_attn.weight": t(vf["norm_attn"]["scale"]),
        "vf.norm_attn.bias": t(vf["norm_attn"]["bias"]),
        "vf.norm_mlp.weight": t(vf["norm_mlp"]["scale"]),
        "vf.norm_mlp.bias": t(vf["norm_mlp"]["bias"]),
        "vf.mlp.fc1.weight": t(vf["mlp"]["fc1_kernel"]).T.contiguous(),
        "vf.mlp.fc2.weight": t(vf["mlp"]["fc2_kernel"]).T.contiguous(),
        "head.weight": t(tree["head"]["kernel"]).T.contiguous(),
        "head.bias": t(tree["head"]["bias"]),
    }
    attn = vf["attn"]
    if "q_kernel" in attn:
        # L2 attention: four biased projections
        for name in ("q", "k", "v", "out"):
            sd[f"vf.attn.{name}.weight"] = t(
                attn[f"{name}_kernel"]).T.contiguous()
            sd[f"vf.attn.{name}.bias"] = t(attn[f"{name}_bias"])
    else:
        sd["vf.attn.qkv.weight"] = t(attn["qkv_kernel"]).T.contiguous()
        sd["vf.attn.proj.weight"] = t(attn["out_kernel"]).T.contiguous()
    if "register_tokens" in pe:
        sd["patch_embed.register_tokens"] = t(pe["register_tokens"])
    if "dist_token" in pe:
        sd["patch_embed.dist_token"] = t(pe["dist_token"])
    if "dist_head" in tree:
        sd["dist_head.weight"] = t(tree["dist_head"]["kernel"]).T.contiguous()
        sd["dist_head.bias"] = t(tree["dist_head"]["bias"])
    return sd


def _teacher_params(tree, t) -> Dict[str, torch.Tensor]:
    """The teacher tree (``layer_i/{query, key, value, attn_output,
    intermediate, output}``, the layer norms, ``cls_token``,
    ``position_embeddings``, ``patch_kernel/bias``, ``classifier``)."""
    def dense(prefix, node):
        return {f"{prefix}.weight": t(node["kernel"]).T.contiguous(),
                f"{prefix}.bias": t(node["bias"])}

    def norm(prefix, node):
        return {f"{prefix}.weight": t(node["scale"]),
                f"{prefix}.bias": t(node["bias"])}

    sd = {"cls_token": t(tree["cls_token"]),
          "position_embeddings": t(tree["position_embeddings"]),
          "patch_kernel": t(tree["patch_kernel"]),
          "patch_bias": t(tree["patch_bias"]),
          **norm("layernorm", tree["layernorm"])}
    i = 0
    while f"layer_{i}" in tree:
        layer = tree[f"layer_{i}"]
        for name in ("query", "key", "value", "attn_output", "intermediate",
                     "output"):
            sd.update(dense(f"layers.{i}.{name}", layer[name]))
        for name in ("layernorm_before", "layernorm_after"):
            sd.update(norm(f"layers.{i}.{name}", layer[name]))
        i += 1
    if "classifier" in tree:
        sd.update(dense("classifier", tree["classifier"]))
    return sd


def _macaron_params(tree, t) -> Dict[str, torch.Tensor]:
    """The ViTMacaron tree: ``patch_proj``, ``cls_token``, ``pos_embed``,
    ``vf/{norm1,norm2,norm3}``, ``vf/attn/{qkv,out}_{kernel,bias}``,
    ``vf/ffn/{fc1,fc2}``, ``vf/res_scale``, ``norm_head``, ``head``, and
    optionally ``dist_token``, ``norm_dist``, ``dist_head``, ``init_ivp``
    (an HWIO convolution kernel, made OIHW) and ``ivp_projector``."""
    def dense(prefix, node):
        return {f"{prefix}.weight": t(node["kernel"]).T.contiguous(),
                f"{prefix}.bias": t(node["bias"])}

    def norm(prefix, node):
        return {f"{prefix}.weight": t(node["scale"]),
                f"{prefix}.bias": t(node["bias"])}

    vf, attn = tree["vf"], tree["vf"]["attn"]
    sd = {"cls_token": t(tree["cls_token"]),
          "pos_embed": t(tree["pos_embed"]),
          "vf.attn.qkv.weight": t(attn["qkv_kernel"]).T.contiguous(),
          "vf.attn.qkv.bias": t(attn["qkv_bias"]),
          "vf.attn.proj.weight": t(attn["out_kernel"]).T.contiguous(),
          "vf.attn.proj.bias": t(attn["out_bias"]),
          "vf.res_scale": t(vf["res_scale"]),
          **dense("patch_proj", tree["patch_proj"]),
          **dense("vf.ffn.fc1", vf["ffn"]["fc1"]),
          **dense("vf.ffn.fc2", vf["ffn"]["fc2"]),
          **dense("head", tree["head"]),
          **norm("norm_head", tree["norm_head"])}
    for i in (1, 2, 3):
        sd.update(norm(f"vf.norm{i}", vf[f"norm{i}"]))
    if "dist_token" in tree:
        sd["dist_token"] = t(tree["dist_token"])
        sd.update(norm("norm_dist", tree["norm_dist"]))
        sd.update(dense("dist_head", tree["dist_head"]))
    if "init_ivp" in tree:
        sd["init_ivp.weight"] = t(tree["init_ivp"]["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        sd["init_ivp.bias"] = t(tree["init_ivp"]["bias"])
        sd.update(dense("ivp_projector", tree["ivp_projector"]))
    return sd
