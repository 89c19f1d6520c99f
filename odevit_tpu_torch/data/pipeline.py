"""Device-side preprocessing of uint8 images.

Counterpart of ``make_preprocess`` in ``odevit_tpu/data/pipeline.py``:
images cross to the device as uint8 and are rescaled and normalized there.
The bilinear resize (the 224 px path) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# DINO ViT-B/16 processor statistics (ImageNet mean and std)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_preprocess(image_size: Optional[int] = None, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD, dtype=torch.float32):
    """uint8 [B, h, w, 3] -> normalized [B, h, w, 3] in ``dtype``, on the
    images' device: x / 255, then (x - mean) / std, in float32.

    ``image_size=None`` keeps the native resolution; a size that would need
    a resize raises until the bilinear resize is ported.
    """
    mean = torch.as_tensor(np.asarray(mean, np.float32))
    std = torch.as_tensor(np.asarray(std, np.float32))

    def preprocess(images):
        if image_size is not None and images.shape[1] != image_size:
            raise NotImplementedError(
                f"resizing {images.shape[1]} px to {image_size} px is not "
                f"ported yet")
        x = images.float() / 255.0
        x = (x - mean.to(x.device)) / std.to(x.device)
        return x.to(dtype)

    return preprocess
