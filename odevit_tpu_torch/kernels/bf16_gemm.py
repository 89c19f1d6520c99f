"""One bf16 product of the tiled route: ``vft_gemm_wgmma`` on its own.

``csrc/vector_field_tiled.cu`` runs every bf16 product of the tiled route
(``vft::gemm<bf16, ...>``: the tiled ViTODE evaluation and backward, the
key-tiled route's products, the split backward's products, the tiled bf16
Macaron route) on ``vft_gemm_wgmma``: a persistent CTA an SM whose two
warpgroups take turns on ``wgmma`` (bf16, f32 accumulators), operands
brought by TMA from a producer warpgroup, and the route's epilogues
writing 16 bytes a thread. The route launches it from
C++; :func:`bf16_gemm` launches one product alone, so that
``chip_smoke.py`` can hold it, in every layout, pair count and epilogue,
against a float64 product of the same operands, and time it beside
``torch.matmul``. It replaces no TPU kernel of its own: it is the product
layer of the kernels that replace ``_vf_kernel``, ``_vf_bwd_kernel``,
``_mlp_bwd_kernel``, ``_attn_bwd_kernel``, ``_macaron_kernel`` and
``_macaron_bwd_kernel`` on the tiled route.

C and the epilogues are those of ``kernels/tf32_gemm.py`` (its module
docstring), on bf16 operands: C is summed in f32, every epilogue runs on
the f32 value, and ``out`` and ``out2`` (and ``res``) are bf16, rounded
once where written (``gelu_drop``: round(round(gelu(C)) mask0)); ``out32``,
``fout``, the masks, ``aux``, ``bias`` and ``rs`` are f32.

What the kernel takes, and so what :func:`bf16_gemm` takes on either
device: M, N and every K multiples of 16, contiguous tensors (rows of a
multiple of 16 bytes) from 16-byte-aligned bases. Anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import count_launch
from odevit_tpu_torch.kernels.tf32_gemm import (DROP_EPILOGUES, OUTPUTS,
                                                _GemmArgs, check_call,
                                                gemm_args, gemm_plain,
                                                raise_on)

# the dtype of each output, and of each epilogue input
DTYPES = {"out": torch.bfloat16, "out2": torch.bfloat16,
          "out32": torch.float32, "fout": torch.float32,
          "mask0": torch.float32, "mask1": torch.float32,
          "bias": torch.float32, "aux": torch.float32,
          "res": torch.bfloat16, "rs": torch.float32}
# every library that compiles vector_field_tiled.cu, and so the kernel
LIBRARIES = ("vector_field_tiled", "vector_field_bwd_split", "macaron_tiled")

_p, _i = ctypes.c_void_p, ctypes.c_int
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels.tiled import _library as tiled_library
        lib = tiled_library()
        lib.vft_bf16_gemm.argtypes = [_i, _i, ctypes.POINTER(_GemmArgs), _p]
        lib.vft_bf16_gemm.restype = _i
        _lib = lib
    return _lib


def wgmma_launches() -> int:
    """``vft_gemm_wgmma``'s launches so far, summed over the libraries
    that compile it (each keeps its own count in C; loading one builds
    it)."""
    from odevit_tpu_torch.kernels import build
    total = 0
    for name in LIBRARIES:
        fn = build.load(name).vft_gemm_wgmma_launches
        fn.argtypes = []
        fn.restype = ctypes.c_ulonglong
        total += fn()
    return total


def _check(pairs, outs: dict, inputs: dict) -> None:
    """What the kernel takes: bf16 operands, the dtypes of :data:`DTYPES`,
    one device, contiguous tensors from 16-byte-aligned bases, M, N and
    every K multiples of 16."""
    a0 = pairs[0][0]
    named = [(f"pair {i}", t) for i, ab in enumerate(pairs) for t in ab]
    named += [(k, t) for k, t in (*inputs.items(), *outs.items())
              if t is not None]
    for name, t in named:
        want = DTYPES.get(name, torch.bfloat16)
        if t.dtype != want or t.device != a0.device:
            raise ValueError(f"bf16_gemm: {name} must be {want} on "
                             f"{a0.device}, not {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bf16_gemm: {name} must be contiguous from a "
                             f"16-byte-aligned base")
    sizes = [a0.shape[0], pairs[0][1].shape[0], pairs[0][1].shape[1]]
    sizes += [a.shape[1] for a, _ in pairs]
    if any(s <= 0 or s % 16 for s in sizes):
        raise ValueError(f"bf16_gemm: M, N and every K must be positive "
                         f"multiples of 16, not {sizes}")


def bf16_gemm(pairs, epi: str, outs: dict, *, bt: bool = False, bias=None,
              aux=None, res=None, rs=None, scale: float = 1.0,
              dt: float = 0.0, alpha: float = 0.0, seed: int = 0, drops=(),
              n_pad: int = 0, n_real: int = 0, plain: bool = False):
    """C = sum over ``pairs`` of A B (bf16, summed in f32) and the
    epilogue ``epi`` (the module docstring), written into ``outs`` ({name
    in ``OUTPUTS``: [M, N] tensor of its :data:`DTYPES` dtype, or None}).
    ``drops``: up to two (site, rate) of the dropout epilogues.

    A CUDA tensor launches ``vft_gemm_wgmma`` (counted as
    ``vft_gemm_wgmma``) or raises; a CPU tensor runs
    :func:`odevit_tpu_torch.kernels.tf32_gemm.gemm_plain`. ``plain=True``
    runs the plain version on any dtype without the kernel's checks (the
    float64 reference)."""
    kw = dict(bt=bt, bias=bias, aux=aux, res=res, rs=rs, scale=scale, dt=dt,
              alpha=alpha, seed=seed, drops=drops, n_pad=n_pad,
              n_real=n_real)
    check_call(pairs, epi, drops, bt)
    if unknown := set(outs) - set(OUTPUTS):
        raise ValueError(f"bf16_gemm: unknown outputs {sorted(unknown)}")
    if not plain:
        _check(pairs, outs, dict(bias=bias, aux=aux, res=res, rs=rs))
    a0 = pairs[0][0]
    if plain or a0.device.type == "cpu":
        return gemm_plain(pairs, epi, outs, **kw)
    g = gemm_args(pairs, epi, outs, **kw)
    err = _library().vft_bf16_gemm(
        int(bt), int(epi in DROP_EPILOGUES), ctypes.byref(g),
        torch.cuda.current_stream(a0.device).cuda_stream)
    raise_on(err, "vft_gemm_wgmma")
    count_launch("vft_gemm_wgmma")
