"""Device-side preprocessing of uint8 images.

Counterpart of ``make_preprocess`` in ``odevit_tpu/data/pipeline.py``:
images cross to the device as uint8 and are rescaled, resized and
normalized there, in that order and in float32. The resize is JAX's
``jax.image.resize(method="bilinear")``: half-pixel centres, a triangle
kernel that widens with the scale when shrinking (antialiasing), weights
renormalized at the borders. ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`` computes the same function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# DINO ViT-B/16 processor statistics (ImageNet mean and std)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, h, w, C] float32 -> [B, size, size, C], as ``jax.image.resize(x,
    (B, size, size, C), method="bilinear")``."""
    x = x.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def make_preprocess(image_size: Optional[int] = None, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD, dtype=torch.float32):
    """uint8 [B, h, w, 3] -> normalized [B, H, W, 3] in ``dtype``, on the
    images' device: x / 255, a bilinear resize to ``image_size`` where the
    images have another size, then (x - mean) / std, all in float32, and
    one cast at the end.

    ``image_size=None`` keeps the native resolution (the CIFAR path).
    """
    mean = torch.as_tensor(np.asarray(mean, np.float32))
    std = torch.as_tensor(np.asarray(std, np.float32))

    def preprocess(images):
        x = images.float() / 255.0
        if image_size is not None and x.shape[1] != image_size:
            x = resize_bilinear(x, image_size)
        x = (x - mean.to(x.device)) / std.to(x.device)
        return x.to(dtype).contiguous()

    return preprocess
