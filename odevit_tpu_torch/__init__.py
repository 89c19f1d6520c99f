"""ODE-ViT in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``odevit_tpu``: the same models, the same
parameter layout and the same numerics, checked against the JAX package
on shared weights and inputs. Entry points run on the GPU unless the
caller passes ``device="cpu"`` (see :func:`resolve_device`); on the CPU
every kernel runs as its plain PyTorch version.
"""

from odevit_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
