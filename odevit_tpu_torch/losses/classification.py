"""Classification loss and accuracy.

Counterpart of ``odevit_tpu/losses/classification.py::cross_entropy``:
CE over float32 logits with optional label smoothing (the reference uses
0.05), meaned over the batch.
"""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, label_smoothing: float = 0.0):
    logits = logits.float()
    num_classes = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0.0:
        onehot = (onehot * (1.0 - label_smoothing)
                  + label_smoothing / num_classes)
    logp = torch.log_softmax(logits, dim=-1)
    return -(onehot * logp).sum(-1).mean()


def accuracy(logits, labels):
    """Top-1 accuracy over the batch, as a float32 scalar tensor."""
    return (logits.argmax(-1) == labels).float().mean()
