"""Train state and optimizer.

Counterpart of ``odevit_tpu/train/state.py`` for the free-training step:
AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 5e-2) after a clip of the
global gradient norm to 1.0, every parameter trainable. As in optax's
``adamw`` with ``mask=all_trainable``, weight decay applies to every
parameter, biases and norms included. The clip follows optax's rule,
``g * min(1, c / ||g||)`` with no epsilon added to the norm; the update
works in place on the model's parameters.

Not ported yet: frozen parameters (``trainable_mask``), gradient
accumulation, per-group learning-rate scales and learning-rate schedules
(they come with the flax-style step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns: the optimizer's settings, bound to
    a model's parameters by :func:`create_train_state`."""
    learning_rate: float
    weight_decay: float = 5e-2
    clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def make_optimizer(learning_rate: float, *, weight_decay: float = 5e-2,
                   clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> OptimizerSpec:
    if callable(learning_rate):
        raise NotImplementedError("learning-rate schedules are not ported "
                                  "yet (they come with the flax-style step)")
    return OptimizerSpec(float(learning_rate), weight_decay, clip_norm, b1,
                         b2, eps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum() \
        .sqrt()


class TrainState:
    """The model (its parameters), AdamW's state and the step count."""

    def __init__(self, model: torch.nn.Module, tx: OptimizerSpec):
        self.model = model
        self.tx = tx
        self.params = [p for p in model.parameters()]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=tx.learning_rate, betas=(tx.b1, tx.b2),
            eps=tx.eps, weight_decay=tx.weight_decay)
        self.step = 0

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients the parameters hold, take one AdamW step and
        return the global norm before the clip. A parameter that took no
        part in the loss (the head of an unsupervised distillation step)
        gets a zero gradient, as JAX gives it, so AdamW still decays it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.tx.clip_norm is not None:
            scale = (self.tx.clip_norm / norm).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
        self.optimizer.step()
        self.step += 1
        return norm


def create_train_state(model: torch.nn.Module,
                       tx: OptimizerSpec) -> TrainState:
    return TrainState(model, tx)
