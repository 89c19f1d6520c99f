"""Hand-written CUDA kernels and their plain PyTorch versions.

Every kernel wrapper adds one to its entry in :data:`launch_counts` each
time it launches its kernel, and nowhere else, so a run can show that its
path went through the kernels. The tiled route's wrappers whose launch
runs attention kernels count past :data:`KEY_TILED_FROM` padded tokens
under ``<name>_kt`` (:func:`count_tiled`): there the route's attention
runs its key-tiled instances.
"""

from __future__ import annotations

import threading
from typing import Dict

launch_counts: Dict[str, int] = {
    "vf_eval": 0, "vf_eval_jasmin": 0, "vf_bwd": 0,
    # the dropout instances of the same kernels, and the mask generator
    "vf_eval_drop": 0, "vf_eval_jasmin_drop": 0, "vf_bwd_drop": 0,
    "dropout_masks": 0,
    # the tiled route (csrc/vector_field_tiled.cu)
    "vf_eval_tiled": 0, "vf_eval_jasmin_tiled": 0, "vf_eval_attn": 0,
    "vf_bwd_tiled": 0,
    # and its dropout instances
    "vf_eval_tiled_drop": 0, "vf_eval_jasmin_tiled_drop": 0,
    "vf_eval_attn_drop": 0, "vf_bwd_tiled_drop": 0,
    # serving: the tiled route's Euler and stage-advance modes, and the
    # chained Euler instance of csrc/vector_field.cu
    "vf_eval_euler_tiled": 0, "vf_eval_base_tiled": 0, "vf_euler_chain": 0,
    # the split backward (csrc/vector_field_bwd_split.cu): its two halves,
    # and the route's chained backwards, each with its dropout instance
    "vf_bwd_mlp": 0, "vf_bwd_attn": 0, "vf_bwd_split": 0,
    "vf_bwd_mlp_drop": 0, "vf_bwd_attn_drop": 0, "vf_bwd_split_drop": 0,
    # L2 attention: the L2+bias instances of the one-CTA kernels
    "vf_eval_l2": 0, "vf_eval_jasmin_l2": 0, "vf_bwd_l2": 0,
    # and of the tiled route (csrc/vector_field_tiled.cu)
    "vf_eval_l2_tiled": 0, "vf_eval_jasmin_l2_tiled": 0,
    "vf_bwd_l2_tiled": 0,
    # the tiled route's dropout instance writing its masks (emit_masks)
    "vf_eval_masks": 0,
    # the Macaron field (csrc/macaron.cu: every mode; csrc/macaron_bwd.cu)
    "macaron_eval": 0, "macaron_bwd": 0,
    # and its tiled route (csrc/macaron_tiled.cu: every mode; backward)
    "macaron_eval_tiled": 0, "macaron_bwd_tiled": 0,
    # the residual stash: the forwards writing rqkv and rh1, one CTA per
    # image and tiled, and the backwards reading them (one CTA, tiled, the
    # split route's halves)
    "vf_eval_stash": 0, "vf_eval_jasmin_stash": 0,
    "vf_eval_stash_tiled": 0, "vf_eval_jasmin_stash_tiled": 0,
    "vf_bwd_resid": 0, "vf_bwd_resid_tiled": 0,
    "vf_bwd_mlp_resid": 0, "vf_bwd_attn_resid": 0,
    # one f32 product of the tiled route alone (csrc/vector_field_tiled.cu:
    # vft_gemm_tf32, launched by kernels/tf32_gemm.py for checks)
    "vft_gemm_tf32": 0,
    # and one bf16 product (vft_gemm_wgmma, launched by kernels/bf16_gemm.py
    # for checks)
    "vft_gemm_wgmma": 0,
    # the backwards' weight products alone (csrc/vector_field_bwd.cu,
    # launched by kernels/wgrad.py for checks): bf16 and f32
    "vfb_wgrad_wgmma": 0, "vfb_wgrad_tf32": 0}

# csrc/vector_field_tiled.cu's kMaxCols: whole-row attention CTAs up to it,
# key-tiled ones past it
KEY_TILED_FROM = 256
KEY_TILED_COUNTERS = (
    "vf_eval_tiled", "vf_eval_jasmin_tiled", "vf_eval_attn", "vf_bwd_tiled",
    "vf_eval_tiled_drop", "vf_eval_jasmin_tiled_drop", "vf_eval_attn_drop",
    "vf_bwd_tiled_drop", "vf_eval_euler_tiled", "vf_eval_base_tiled",
    "vf_bwd_attn", "vf_bwd_attn_drop", "vf_eval_l2_tiled",
    "vf_eval_jasmin_l2_tiled", "vf_bwd_l2_tiled", "vf_eval_masks",
    "macaron_eval_tiled", "macaron_bwd_tiled", "vf_eval_stash_tiled",
    "vf_eval_jasmin_stash_tiled", "vf_bwd_resid_tiled", "vf_bwd_attn_resid")
launch_counts.update({name + "_kt": 0 for name in KEY_TILED_COUNTERS})
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def key_tiled(n_pad: int) -> bool:
    """Whether the tiled route's attention runs its key-tiled instances
    (past :data:`KEY_TILED_FROM` padded tokens) rather than its whole-row
    ones."""
    return n_pad > KEY_TILED_FROM


def count_tiled(name: str, n_pad: int) -> None:
    """``count_launch`` of a tiled-route wrapper: ``<name>_kt`` where
    :func:`key_tiled`."""
    count_launch(name + "_kt" if key_tiled(n_pad) else name)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0
