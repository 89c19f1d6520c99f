"""Attention-map distillation: DINO-style thresholded attention mass, L1
and symmetrized-KL variants.

Counterpart of ``odevit_tpu/losses/attention_distill.py``. The sort is
``torch.argsort(stable=True)``, as ``jnp.argsort`` is stable, so tied
attention values keep their order and the mask lands where JAX puts it.
The Gaussian blur is torchvision's ``gaussian_blur(kernel_size=(3, 3),
sigma=0.5)``: a separable kernel with reflect padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.linspace(-(ksize - 1) / 2.0, (ksize - 1) / 2.0, ksize)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur_2d(x, ksize=3, sigma=0.5):
    """Blur the trailing two axes of ``[..., h, w]`` with reflect padding."""
    k1 = _gaussian_kernel1d(ksize, sigma)
    kernel = torch.from_numpy(np.outer(k1, k1)[None, None]).to(x.device)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    flat = x.reshape(-1, 1, h, w).float()
    pad = ksize // 2
    flat = F.pad(flat, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(flat, kernel).reshape(*lead, h, w)


def extract_mass(attn_rows, threshold=0.8, *, smooth=True, scale_factor=40,
                 return_mask=False):
    """Thresholded attention mass over CLS->patch rows ``[B, H, N]`` (N a
    perfect square). Returns (mean over heads [B, h, w], filtered
    [B, H, h, w], mask or None)."""
    b, nh, n = attn_rows.shape
    side = int(n ** 0.5 + 0.5)
    a = attn_rows.float()

    idx = torch.argsort(a, dim=-1, stable=True)           # ascending
    val = a.gather(-1, idx)
    val = val / (val.sum(-1, keepdim=True) + 1e-8)
    cumval = val.cumsum(-1)
    if smooth:
        mask_sorted = torch.sigmoid((cumval - (1.0 - threshold))
                                    * scale_factor)
    else:
        mask_sorted = (cumval > (1.0 - threshold)).float()
    inv = torch.argsort(idx, dim=-1, stable=True)
    th_attn = mask_sorted.gather(-1, inv).reshape(b, nh, side, side)

    filtered = a.reshape(b, nh, side, side) * th_attn
    if smooth:
        filtered = gaussian_blur_2d(filtered, 3, 0.5)
    mean_over_heads = filtered.mean(1)
    mask = th_attn.mean(1) if return_mask else None
    return mean_over_heads, filtered, mask


def _cls_rows(attn):
    return attn[:, :, 0, 1:] if attn.dim() == 4 else attn


def l1_attention_loss(student_attn, teacher_attn, *, lambda_param,
                      conjugate=False, student_threshold=0.5,
                      teacher_threshold=0.7):
    """L1 between the extracted attention masses of the student's last
    evaluation (``[B, H, N, N]``, registers stripped) and the teacher's
    last layer (``[B, H, M, M]`` or its ``[B, H, M-1]`` CLS->patch rows),
    summed over the batch."""
    s_mean, _, _ = extract_mass(_cls_rows(student_attn),
                                threshold=student_threshold)
    t_mean, _, _ = extract_mass(_cls_rows(teacher_attn),
                                threshold=teacher_threshold)
    if conjugate:
        max_val = t_mean.reshape(t_mean.shape[0], -1).amax(-1)
        t_mean = max_val[:, None, None] - t_mean
    return (s_mean - t_mean).abs().sum() * lambda_param


def kl_attention_loss(student_attn, teacher_attn, *, lambda_param,
                      temperature=1.0, per_head=True, eps=1e-8,
                      student_threshold=0.5, teacher_threshold=0.7):
    """Symmetrized temperature-scaled KL on log-mass distributions; the
    teacher mass is conjugated (max - mass), as in the JAX package."""
    s_mean, s_filt, _ = extract_mass(_cls_rows(student_attn),
                                     threshold=student_threshold)
    t_mean, t_filt, _ = extract_mass(_cls_rows(teacher_attn),
                                     threshold=teacher_threshold)
    t_filt = 1.0 - t_filt
    max_val = t_mean.reshape(t_mean.shape[0], -1).amax(-1)
    t_mean = max_val[:, None, None] - t_mean

    def sym_kl(log_s_input, log_t_input, dim):
        ls = F.log_softmax(log_s_input / temperature, dim=dim)
        lt = F.log_softmax(log_t_input / temperature, dim=dim)
        t_prob, s_prob = lt.exp(), ls.exp()
        kl_st = (t_prob * (lt - ls)).sum(dim)
        kl_ts = (s_prob * (ls - lt)).sum(dim)
        return 0.5 * (kl_st + kl_ts) * temperature ** 2

    if per_head:
        b, h = s_filt.shape[:2]
        log_s = torch.log(s_filt + eps).sum(3).reshape(b, h, -1)
        log_t = torch.log(t_filt + eps).sum(3).reshape(b, h, -1)
        kl = sym_kl(log_s, log_t, 2).mean()
    else:
        s_m = s_mean.clamp_min(eps)
        t_m = t_mean.clamp_min(eps)
        log_s = torch.log(s_m + eps).sum(1)
        log_t = torch.log(t_m + eps).sum(1)
        kl = sym_kl(log_s, log_t, -1).mean()
    return kl * lambda_param
