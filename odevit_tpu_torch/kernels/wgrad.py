"""The weight products of the backwards on their own.

Every bf16 backward of the port (one CTA per image, tiled, key-tiled, the
split halves, both Macaron backwards) hands its weight cotangents to one
kernel of ``csrc/vector_field_bwd.cu``, ``vfb_wgrad_wgmma``, and every f32
ViTODE backward (the same routes but Macaron's) to its split-TF32 twin,
``vfb_wgrad_tf32``: W_bar[M, N] = A[R, M]^T G[R, N] over all B n_pad rows
of the backward, up to four products a launch, each CTA summing one
output tile over one fixed slice of rows into its own partial, then
``vfb_reduce`` adding the partials in a fixed order, so two runs give the
same bits. The backwards launch them from C++; :func:`weight_bars`
launches them alone, so that ``chip_smoke.py`` can hold each against a
float64 product of the same operands and time it beside ``torch.matmul``.

It replaces no TPU kernel of its own: it is the weight accumulation of
``_vf_bwd_kernel``, ``_mlp_bwd_kernel`` and ``_attn_bwd_kernel``
(``odevit_tpu/kernels/vector_field_bwd.py``) and of
``_macaron_bwd_kernel`` (``odevit_tpu/kernels/macaron.py``), which the
TPU sums with ``+=`` across its sequential grid.
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import count_launch
from odevit_tpu_torch.kernels.vector_field_bwd import weight_splits

_p, _i = ctypes.c_void_p, ctypes.c_int

# every library that compiles vector_field_bwd.cu, and so the kernel
LIBRARIES = ("vector_field_bwd", "vector_field_tiled",
             "vector_field_bwd_split", "macaron_bwd", "macaron_tiled")


class _WgradArgs(ctypes.Structure):
    """``WgradArgs`` of csrc/vector_field_bwd.cu."""
    _fields_ = [("a", _p * 4), ("g", _p * 4), ("m", _i * 4), ("n", _i * 4),
                ("count", _i), ("rows", _i), ("splits", _i),
                ("wpart", _p), ("out", _p)]


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels.vector_field_bwd import \
            _library as bwd_library
        lib = bwd_library()
        lib.vfb_weight_bars.argtypes = [_i, ctypes.POINTER(_WgradArgs), _p]
        lib.vfb_weight_bars.restype = _i
        _lib = lib
    return _lib


def wgrad_launches(dtype: torch.dtype) -> int:
    """Launches so far of the weight-product kernel of ``dtype`` operands
    (bf16: ``vfb_wgrad_wgmma``, f32: ``vfb_wgrad_tf32``), summed over the
    libraries that compile it (each keeps its own count in C; loading one
    builds it)."""
    from odevit_tpu_torch.kernels import build
    total = 0
    for name in LIBRARIES:
        lib = build.load(name)
        fn = (lib.vfb_wgrad_launches if dtype == torch.bfloat16
              else lib.vfb_wgrad_tf32_launches)
        fn.argtypes = []
        fn.restype = ctypes.c_ulonglong
        total += fn()
    return total


def weight_bars_plain(pairs):
    """[A^T G in float32 for each (A [R, M], G [R, N]) of ``pairs``]."""
    return [a.float().T @ g.float() for a, g in pairs]


def _check(pairs):
    """Raises unless ``pairs`` are one to four (A [R, M], G [R, N]) of
    contiguous bf16 or f32 tensors of one dtype on one device, with one R
    and every M and N a multiple of 16 (what the kernel takes)."""
    if not 1 <= len(pairs) <= 4:
        raise ValueError(f"one to four pairs, got {len(pairs)}")
    a0 = pairs[0][0]
    if a0.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the weight products take bf16 or f32, got "
                        f"{a0.dtype}")
    rows = a0.shape[0] if a0.dim() == 2 else -1
    for a, g in pairs:
        for t in (a, g):
            if (t.dtype != a0.dtype or t.device != a0.device or t.dim() != 2
                    or not t.is_contiguous()):
                raise ValueError("the weight products take contiguous 2-D "
                                 "tensors of one dtype on one device")
        if a.shape[0] != rows or g.shape[0] != rows:
            raise ValueError(f"pair of {a.shape[0]} and {g.shape[0]} rows, "
                             f"want {rows}")
        if a.shape[1] % 16 or g.shape[1] % 16:
            raise ValueError(f"M={a.shape[1]}, N={g.shape[1]}: not multiples "
                             f"of 16")


def weight_bars(pairs, splits: int | None = None):
    """[A^T G, float32 [M, N], for each (A [R, M], G [R, N]) of ``pairs``]:
    one to four pairs of contiguous bf16 (or f32) tensors on one device
    with the same R, every M and N a multiple of 16 (else it raises, on
    either device). ``splits``: slices of rows (default the backwards'
    rule, ``weight_splits`` of the pairs' shapes).

    A CUDA tensor launches the kernel and ``vfb_reduce`` (counted as
    ``vfb_wgrad_wgmma``, or ``vfb_wgrad_tf32`` in f32); a CPU tensor runs
    :func:`weight_bars_plain`."""
    _check(pairs)
    a0 = pairs[0][0]
    if a0.device.type == "cpu":
        return weight_bars_plain(pairs)
    rows = a0.shape[0]
    shapes = [(a.shape[1], g.shape[1]) for a, g in pairs]
    if splits is None:
        splits = weight_splits(rows, 0, 0, shapes, dtype=a0.dtype)
    total = sum(m * n for m, n in shapes)
    wpart = torch.empty(splits, total, device=a0.device)
    out = torch.empty(total, device=a0.device)
    w = _WgradArgs(count=len(pairs), rows=rows, splits=splits,
                   wpart=wpart.data_ptr(), out=out.data_ptr())
    for i, (a, g) in enumerate(pairs):
        w.a[i], w.g[i] = a.data_ptr(), g.data_ptr()
        w.m[i], w.n[i] = shapes[i]
    lib = _library()
    err = lib.vfb_weight_bars(a0.element_size(), ctypes.byref(w),
                              torch.cuda.current_stream(a0.device).cuda_stream)
    if err:
        raise RuntimeError("weight-product launch failed: "
                           + lib.vfb_error_string(err).decode())
    count_launch("vfb_wgrad_wgmma" if a0.dtype == torch.bfloat16
                 else "vfb_wgrad_tf32")
    return [t.view(m, n) for t, (m, n) in
            zip(torch.split(out, [m * n for m, n in shapes]), shapes)]
