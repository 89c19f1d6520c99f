"""One f32 product of the tiled route: ``vft_gemm_tf32`` on its own.

``csrc/vector_field_tiled.cu`` runs every f32 product of the tiled route
(``vft::gemm<float, ...>``: the tiled ViTODE evaluation and backward, the
split backward's products, the tiled Macaron route) on ``vft_gemm_tf32``,
split TF32 in three passes on ``wgmma`` with the route's epilogues. The
route launches it from C++; :func:`tf32_gemm` launches one product alone,
so that ``chip_smoke.py`` can hold it, in every layout, pair count and
epilogue, against a float64 product of the same operands, and time it.
It replaces no TPU kernel of its own: it is the product layer of the
kernels that replace ``_vf_kernel``, ``_vf_bwd_kernel``, ``_mlp_bwd_kernel``,
``_attn_bwd_kernel``, ``_macaron_kernel`` and ``_macaron_bwd_kernel`` on
the tiled route.

C = sum over ``pairs`` of A B (A [M, K] row-major, B [K, N] row-major or,
with ``bt``, stored [N, K]), then the epilogue ``epi`` (:data:`EPILOGUES`),
which writes the buffers it names (all [M, N], f32, row-major) from C, the
f32 ``bias`` [N], ``aux`` and ``res`` [M, N] and the scalars:

- ``round``: out = C (+ bias);  ``scale``: out = (C (+ bias)) scale;
- ``gelu``: h1 = C (+ bias); out = gelu(h1), out32 = out2 = h1 (each
  optional);  ``gelu_grad``: out = C gelu'(aux);
- ``gelu_grad_resid``: h1 = res (0 on padded rows); out = C gelu'(h1)
  and out2 = gelu(h1) (both needed);
- ``f32``: out32 = C;  ``advance``: out = res + dt (C scale);
- ``mac_resid``: f = C + bias; fout = f and out32 = aux + alpha rs f (each
  optional);  ``mac_out``: out = (aux + alpha rs (C + bias)) scale, or
  res + dt times that where res is given;
- ``gelu_drop``: out = gelu(C) mask0, out32 = C (optional);
  ``gelu_grad_drop``: out = C mask0 gelu'(aux);  ``out_drop``: out = (C
  mask0 + aux mask1) scale; the masks are the keep masks of ``drops``
  (site, rate) under ``seed`` (``kernels/dropout.py``'s stream; output row
  m is row m % n_pad of image m / n_pad, 0 from n_real on), written to
  mask0 / mask1 where given.

Padded rows are the caller's: only ``gelu_grad_resid`` and the dropout
epilogues read ``n_pad`` and ``n_real``.
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import count_launch
from odevit_tpu_torch.kernels.dropout import (fold_seed, keep_mask_plain,
                                              keep_scale, threshold)
from odevit_tpu_torch.kernels.vector_field_bwd import _gelu_grad

EPILOGUES = ("round", "gelu", "scale", "gelu_grad", "f32", "gelu_drop",
             "gelu_grad_drop", "out_drop", "advance", "mac_resid", "mac_out",
             "gelu_grad_resid")
DROP_EPILOGUES = ("gelu_drop", "gelu_grad_drop", "out_drop")
OUTPUTS = ("out", "out32", "out2", "fout", "mask0", "mask1")

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32


class _GemmArgs(ctypes.Structure):
    """``vft::GemmArgs`` of csrc/vector_field_tiled.cu."""
    _fields_ = [("a", _p * 2), ("b", _p * 2), ("lda", _i * 2),
                ("ldb", _i * 2), ("k", _i * 2), ("pairs", _i), ("m", _i),
                ("n", _i), ("epi", _i), ("out", _p), ("ldo", _i),
                ("out32", _p), ("ld32", _i), ("out2", _p), ("aux", _p),
                ("ldaux", _i), ("scale", _f), ("res", _p), ("dt", _f),
                ("key", _u * 2), ("th", _u * 2), ("sc", _f * 2),
                ("n_pad", _i), ("n_real", _i), ("bias", _p), ("mask", _p * 2),
                ("rs", _p), ("alpha", _f), ("fout", _p)]


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels.tiled import _library as tiled_library
        lib = tiled_library()
        lib.vft_tf32_gemm.argtypes = [_i, _i, ctypes.POINTER(_GemmArgs), _p]
        lib.vft_tf32_gemm.restype = _i
        _lib = lib
    return _lib


def _gelu(v):
    return 0.5 * v * (1.0 + torch.erf(v * 2.0 ** -0.5))


def _real_rows(m: int, n_pad: int, n_real: int, device):
    return (torch.arange(m, device=device) % n_pad < n_real)[:, None]


def gemm_masks(m: int, n: int, seed: int, drops, n_pad: int, n_real: int,
               device=None):
    """The dropout epilogues' two masks [M, N] (f32 kept values): ones at
    a site of rate 0 (or none given), zeros on padded rows otherwise."""
    out = []
    for i in range(2):
        site, rate = drops[i] if i < len(drops) else (0, 0.0)
        if rate == 0.0:
            out.append(torch.ones(m, n, device=device))
            continue
        mask = keep_mask_plain(seed, site, rate, m // n_pad, n_pad, n,
                               device=device).reshape(m, n)
        out.append(mask * _real_rows(m, n_pad, n_real, device))
    return out


def gemm_plain(pairs, epi: str, outs: dict, *, bt: bool = False,
               bias=None, aux=None, res=None, rs=None, scale: float = 1.0,
               dt: float = 0.0, alpha: float = 0.0, seed: int = 0,
               drops=(), n_pad: int = 0, n_real: int = 0):
    """The plain version of :func:`tf32_gemm` and of
    ``bf16_gemm.bf16_gemm``: writes ``outs`` in place. The product is
    summed in the operands' dtype, bf16 operands in f32 (float64 operands
    give the float64 reference); the epilogue runs in that dtype, and each
    output is rounded to its own dtype where it is written. ``gelu_drop``
    also rounds gelu(C) to ``out``'s dtype before the mask, as the kernels
    do."""
    a0 = pairs[0][0]
    dt_ = torch.float32 if a0.dtype == torch.bfloat16 else a0.dtype
    c = sum(a.to(dt_) @ (b.T if bt else b).to(dt_) for a, b in pairs)
    m, n = c.shape
    cast = lambda t: None if t is None else t.to(dt_)
    bias, aux, res = cast(bias), cast(aux), cast(res)
    rsv = None if rs is None else rs.to(dt_).reshape(())
    with_bias = c if bias is None else c + bias
    w = {}
    if epi == "round":
        w["out"] = with_bias
    elif epi == "scale":
        w["out"] = with_bias * scale
    elif epi == "gelu":
        w.update(out=_gelu(with_bias), out32=with_bias, out2=with_bias)
    elif epi == "gelu_grad":
        w["out"] = c * _gelu_grad(aux)
    elif epi == "gelu_grad_resid":
        h1 = torch.where(_real_rows(m, n_pad, n_real, c.device), res,
                         torch.zeros((), dtype=dt_, device=c.device))
        w.update(out=c * _gelu_grad(h1), out2=_gelu(h1))
    elif epi == "f32":
        w["out32"] = c
    elif epi == "advance":
        w["out"] = res + dt * (c * scale)
    elif epi == "mac_resid":
        f = c + bias
        w["fout"] = f
        if aux is not None:
            w["out32"] = aux + alpha * rsv * f
    elif epi == "mac_out":
        f = (aux + alpha * rsv * (c + bias)) * scale
        w["out"] = f if res is None else res + dt * f
    elif epi in DROP_EPILOGUES:
        m0, m1 = (t.to(dt_) for t in gemm_masks(m, n, seed, drops, n_pad,
                                                  n_real, c.device))
        if epi == "gelu_drop":
            g = _gelu(c)
            if outs.get("out") is not None:
                g = g.to(outs["out"].dtype).to(dt_)
            w.update(out=g * m0, out32=c)
        elif epi == "gelu_grad_drop":
            w["out"] = c * m0 * _gelu_grad(aux)
        else:
            w["out"] = (c * m0 + aux * m1) * scale
        w.update(mask0=m0, mask1=m1)
    else:
        raise ValueError(f"unknown epilogue {epi!r}")
    for name, t in outs.items():
        if t is not None and name in w:
            t.copy_(w[name])


def _ptr(t):
    return None if t is None else t.data_ptr()


def check_call(pairs, epi: str, drops, bt: bool):
    """The call's shape rules common to both products: (M, N) of C."""
    if epi not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epi!r}")
    if not 1 <= len(pairs) <= 2 or len(drops) > 2:
        raise ValueError("one or two pairs, at most two dropout sites")
    m = pairs[0][0].shape[0]
    n = pairs[0][1].shape[0 if bt else 1]
    for a, b in pairs:
        k = a.shape[1]
        if a.shape[0] != m or tuple(b.shape) != ((n, k) if bt else (k, n)):
            raise ValueError(f"pair shapes {tuple(a.shape)} x "
                             f"{tuple(b.shape)} do not make [{m}, {n}]")
    return m, n


def gemm_args(pairs, epi: str, outs: dict, *, bt, bias, aux, res, rs, scale,
              dt, alpha, seed, drops, n_pad, n_real) -> _GemmArgs:
    """``vft::GemmArgs`` of one call (contiguous operands and outputs)."""
    m, n = check_call(pairs, epi, drops, bt)
    g = _GemmArgs()
    for p, (a, b) in enumerate(pairs):
        g.a[p], g.b[p] = a.data_ptr(), b.data_ptr()
        g.lda[p], g.ldb[p], g.k[p] = a.shape[1], b.shape[1], a.shape[1]
    g.pairs, g.m, g.n, g.epi = len(pairs), m, n, EPILOGUES.index(epi)
    g.out, g.out32, g.out2, g.fout = (_ptr(outs.get(k)) for k in (
        "out", "out32", "out2", "fout"))
    g.ldo = g.ld32 = g.ldaux = n
    g.aux, g.res, g.bias, g.rs = (_ptr(t) for t in (aux, res, bias, rs))
    g.scale, g.dt, g.alpha = scale, dt, alpha
    g.n_pad, g.n_real = n_pad, n_real
    for i, (site, rate) in enumerate(drops):
        g.key[i] = fold_seed(seed, site) & 0xFFFFFFFF
        g.th[i] = threshold(rate) if rate > 0.0 else 0
        g.sc[i] = keep_scale(rate) if rate > 0.0 else 1.0
    g.mask[0], g.mask[1] = _ptr(outs.get("mask0")), _ptr(outs.get("mask1"))
    return g


def raise_on(err: int, kernel: str) -> None:
    """Raises where a launch of ``kernel`` returned a CUDA error."""
    if err:
        from odevit_tpu_torch.kernels.tiled import _library as tiled_library
        raise RuntimeError(f"{kernel} launch failed: "
                           + tiled_library().vft_error_string(err).decode())


def tf32_gemm(pairs, epi: str, outs: dict, *, bt: bool = False, bias=None,
              aux=None, res=None, rs=None, scale: float = 1.0,
              dt: float = 0.0, alpha: float = 0.0, seed: int = 0, drops=(),
              n_pad: int = 0, n_real: int = 0, plain: bool = False):
    """C = sum over ``pairs`` of A B and the epilogue ``epi`` (see the
    module docstring), written into ``outs`` ({name in :data:`OUTPUTS`:
    [M, N] f32 tensor or None}). ``drops``: up to two (site, rate) of the
    dropout epilogues. f32 contiguous operands, M, N and each K multiples
    of 16.

    A CUDA tensor launches ``vft_gemm_tf32`` (counted as
    ``vft_gemm_tf32``); a CPU tensor runs :func:`gemm_plain`, as does
    ``plain=True``."""
    kw = dict(bt=bt, bias=bias, aux=aux, res=res, rs=rs, scale=scale, dt=dt,
              alpha=alpha, seed=seed, drops=drops, n_pad=n_pad,
              n_real=n_real)
    check_call(pairs, epi, drops, bt)
    a0 = pairs[0][0]
    if plain or a0.device.type == "cpu":
        return gemm_plain(pairs, epi, outs, **kw)
    tensors = [t for ab in pairs for t in ab] + [
        t for t in (bias, aux, res, rs, *outs.values()) if t is not None]
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != a0.device for t in tensors):
        raise ValueError("tf32_gemm takes contiguous f32 tensors on one "
                         "device")
    g = gemm_args(pairs, epi, outs, **kw)
    err = _library().vft_tf32_gemm(
        int(bt), int(epi in DROP_EPILOGUES), ctypes.byref(g),
        torch.cuda.current_stream(a0.device).cuda_stream)
    raise_on(err, "vft_gemm_tf32")
    count_launch("vft_gemm_tf32")
