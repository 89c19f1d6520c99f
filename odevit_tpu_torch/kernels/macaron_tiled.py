"""The tiled route of the Macaron field's evaluation and backward.

``csrc/macaron_tiled.cu`` runs one evaluation, or one backward, as a
sequence of kernels over all rows of the batch (LayerNorm rows, the tiled
route's 128x128 products with the Macaron residual epilogues, its softmax
attention kernels, per-image backward steps, the weight products and
their fixed-order reduce), for shapes whose image does not fit one CTA of
``csrc/macaron.cu`` / ``csrc/macaron_bwd.cu`` (a 224 px ViTMacaron at
patch 16: 197 tokens padded to 208, D=768, 12 heads). It replaces the same
TPU kernels, ``_macaron_kernel`` (plain, Euler and stage-advance modes)
and ``_macaron_bwd_kernel``, with the same arithmetic: the rounding of
``kernels/macaron.py::chain_plain``, so ``macaron_eval_plain`` and
``macaron_bwd_plain`` are the plain versions of both routes.
``kernels/macaron.py::macaron_route`` chooses the route; this module binds
the library and allocates the scratch the kernels use.

Plans: :func:`kernel_tiled_plan` asks the CUDA library (``mct_plan``);
:func:`tiled_macaron_plan` is the same rule in Python, so that a CPU run
routes as the card does (``chip_smoke.py`` holds the two against each
other). The route's attention kernels are the ViTODE tiled route's, so
its plan is ``tiled_plan_rule``'s for the deterministic softmax instances.
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels.macaron import MODES, MacaronWeights
from odevit_tpu_torch.kernels.tiled import tiled_plan_rule

# MctArgs' buffers (csrc/macaron_tiled.cu), after x, base, g and the weights
_BUFS = ("out", "z", "z2", "h", "h1", "h1b", "ob", "qkv", "ctx", "aod", "cb",
         "qkvb", "pg", "sbar", "x1", "x2", "f1", "f3", "ao", "xb", "zb",
         "npart", "rsp", "wpart", "wbars")


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "base", "g", *MacaronWeights._fields, *_BUFS)]
        + [(name, ctypes.c_int) for name in (
            "batch", "n_pad", "n_real", "d", "heads", "dh", "mode", "mt",
            "splits")]
        + [(name, ctypes.c_float) for name in ("scaler", "qk_scale", "dt")])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("macaron_tiled")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.mct_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 4
        lib.mct_plan.restype = i
        for fn in (lib.mct_forward, lib.mct_backward):
            fn.argtypes = [i, ctypes.POINTER(_Args), p]
            fn.restype = i
        lib.mct_error_string.argtypes = [i]
        lib.mct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tiled_macaron_plan(dtype, n_pad: int, n_real: int, d: int,
                       num_heads: int, dh: int):
    """``mct_plan``'s answer in Python: (query-tile rows, shared-memory
    bytes of the forward, backward and key-tile attention CTAs; past 256
    padded tokens those of the key-tiled instances), or None where a size
    is not a multiple of 16."""
    return tiled_plan_rule(dtype, n_pad, n_real, d, num_heads, dh)


def kernel_tiled_plan(dtype, n_pad: int, n_real: int, d: int,
                      num_heads: int, dh: int):
    """``mct_plan`` of ``csrc/macaron_tiled.cu``, or None where the shape
    has no plan."""
    out = [ctypes.c_int() for _ in range(4)]
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().mct_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                           *(ctypes.byref(o) for o in out)):
        return None
    return tuple(o.value for o in out)


def _launch(fn_name: str, x, w, bufs, *, num_heads: int, scaler: float,
            n_real: int, base=None, g=None, mode: str = "plain",
            dt: float = 0.0, splits: int = 0):
    b, n, d = x.shape
    dh = w.w1.shape[1]
    mt = kernel_tiled_plan(x.dtype, n, n_real, d, num_heads, dh)[0]
    ptr = lambda t: t.data_ptr() if t is not None else None
    args = _Args(x=ptr(x), base=ptr(base), g=ptr(g),
                 **{k: ptr(v) for k, v in w._asdict().items()},
                 **{k: ptr(v) for k, v in bufs.items()},
                 batch=b, n_pad=n, n_real=n_real, d=d, heads=num_heads,
                 dh=dh, mode=MODES[mode], mt=mt, splits=splits,
                 scaler=scaler, qk_scale=(d // num_heads) ** -0.5, dt=dt)
    lib = _library()
    err = getattr(lib, fn_name)(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled Macaron kernel launch failed ({fn_name}): "
                           + lib.mct_error_string(err).decode())


def tiled_eval(x, w, *, num_heads: int, scaler: float, n_real: int,
               mode: str = "plain", dt: float = 0.0, base=None):
    """One evaluation on the tiled route (see ``kernels/macaron.py``). The
    caller has checked the arguments."""
    b, n, d = x.shape
    dh = w.w1.shape[1]
    e = lambda width, dtype=x.dtype: torch.empty(b * n, width,
                                                 device=x.device, dtype=dtype)
    bufs = {"out": torch.empty_like(x), "z": e(d), "h": e(dh),
            "qkv": e(3 * d), "ctx": e(d), "x1": e(d, torch.float32)}
    _launch("mct_forward", x, w, bufs, num_heads=num_heads, scaler=scaler,
            n_real=n_real, base=base, mode=mode, dt=dt)
    return bufs["out"]


def tiled_bwd(x, w, g, *, num_heads: int, scaler: float, n_real: int,
              splits: int, nlen: int):
    """x_bar and the flat [Wqkv, Wout, W1, W2, then the per-image
    partials' sums] buffer of one backward on the tiled route
    (``macaron_bwd.split_bars`` takes them apart). The caller has checked
    the arguments."""
    b, n, d = x.shape
    dh = w.w1.shape[1]
    rows = b * n

    def e(width, halves=1, dtype=x.dtype):
        return torch.empty(halves * rows, width, device=x.device,
                           dtype=dtype)

    f32 = torch.float32
    wtotal = 4 * d * d + 2 * d * dh
    bufs = {"out": torch.empty_like(x), "z": e(d, 2), "z2": e(d),
            "h": e(dh, 2), "h1": e(dh, 2, f32), "h1b": e(dh, 2),
            "ob": e(d, 2), "qkv": e(3 * d), "ctx": e(d), "aod": e(d),
            "cb": e(d), "qkvb": e(3 * d),
            "pg": torch.empty(b, num_heads, n, n, device=x.device,
                              dtype=x.dtype),
            "sbar": torch.empty(b, num_heads, n, n, device=x.device,
                                dtype=x.dtype),
            **{k: e(d, 1, f32) for k in ("x1", "x2", "f1", "f3", "ao",
                                         "xb", "zb")},
            "npart": torch.empty(b, nlen, device=x.device),
            "rsp": torch.empty(b, 3, device=x.device),
            "wpart": torch.empty(splits, wtotal, device=x.device),
            "wbars": torch.empty(wtotal + nlen, device=x.device)}
    _launch("mct_backward", x, w, bufs, num_heads=num_heads, scaler=scaler,
            n_real=n_real, g=g, splits=splits)
    return bufs["out"], bufs["wbars"]
