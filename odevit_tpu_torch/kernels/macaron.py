"""One fused evaluation of the Macaron vector field.

``macaron_eval`` launches a CUDA counterpart of the TPU kernel
``odevit_tpu/kernels/macaron.py::_macaron_kernel`` on a CUDA tensor, and
runs its plain PyTorch version ``macaron_eval_plain`` on a CPU tensor.
:func:`macaron_route` chooses the kernel, by the same rule on either
device: ``csrc/macaron.cu``, one image per CTA, where :func:`macaron_plan`
has a plan, else the tiled route of ``csrc/macaron_tiled.cu``
(``kernels/macaron_tiled.py``; past 256 padded tokens its attention
runs the key-tiled instances of ``csrc/vector_field_tiled.cu``). A shape
with neither plan (sizes that are not multiples of 16) raises. On one CTA
bf16 runs ``mac_kernel``; f32 runs ``mac_kernel_f32`` (split TF32 on
``mac::gemm_tf32``) on the layout of :func:`macaron_plan_f32`, with a
per-image workspace, its launches also counted in C
(:func:`f32_launches`). With
``f = x3 * scaler`` and

    x1 = x  + rs/2 * FFN(LN1 x)        FFN(z) = gelu(z W1 + b1) W2 + b2
    x2 = x1 + rs   * Attn(LN2 x1)      (biased q|k|v and output projections)
    x3 = x2 + rs/2 * FFN(LN3 x2)       (the first half's FFN weights)

three modes, as ``_pallas_macaron`` has them:

  * ``"plain"``: ``f(x)``;
  * ``"euler"``: ``x + dt * f(x)``, with ``f`` not rounded first;
  * ``"base"``: ``base + dt * f(x)`` (the Kutta-3/8 stage advance).

Every mode counts as ``macaron_eval`` (``macaron_eval_tiled`` on the
tiled route). ``x`` is the padded token tensor
``[B, n_pad, D]`` (``n_pad`` a multiple of ``TOKEN_PAD``); tokens
``>= n_real`` are padding: they receive no attention and whatever they hold
never reaches a real token.

Rounding follows the kernel, not JAX's XLA twin ``_xla_macaron``: the
state stays float32; the LayerNorm outputs (flax's eps 1e-6), qkv after its
bias (before the heads are sliced), p, ctx and gelu(h) are rounded to x's
dtype; the FFN output and attn_o stay float32 until they reach the state;
the result is rounded once. Both routes round there, so the plain
version is one. JAX's forward runs its Pallas kernel at every shape
(``_macaron_block_b`` only halves the batch tile); the port's two routes
together take every shape whose sizes are multiples of 16.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from odevit_tpu_torch.kernels import count_launch, count_tiled
from odevit_tpu_torch.kernels.vector_field import (_CHUNKS, _MAX_SMEM,
                                                   _STAGES, F32_BLOCKS,
                                                   TOKEN_PAD, align128,
                                                   block_ok, cta_shape_ok,
                                                   ring_slot)
from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.layer_norm import layer_norm

MODES = {"plain": 0, "euler": 1, "base": 2}
# csrc/macaron.cu: mac_kernel_f32's FFN chunks (kChunksF32), widest first
F32_CHUNKS = (192, 128, 64, 32, 16)


class MacaronWeights(NamedTuple):
    """A MacaronVectorField's weights as the kernel takes them, in the
    order of ``_macaron_tensors``: LayerNorm vectors, biases and ``rs``
    in float32, matrices ``[in, out]`` in the compute dtype."""
    ln1s: torch.Tensor       # [D]
    ln1b: torch.Tensor
    ln2s: torch.Tensor
    ln2b: torch.Tensor
    ln3s: torch.Tensor
    ln3b: torch.Tensor
    wqkv: torch.Tensor       # [D, 3D]
    qkv_bias: torch.Tensor   # [3D]
    wout: torch.Tensor       # [D, D]
    out_bias: torch.Tensor   # [D]
    w1: torch.Tensor         # [D, dh]
    b1: torch.Tensor         # [dh]
    w2: torch.Tensor         # [dh, D]
    b2: torch.Tensor         # [D]
    rs: torch.Tensor         # [1]


_MATRICES = ("wqkv", "wout", "w1", "w2")


def _shapes(d: int, dh: int):
    vec = {name: (d,) for name in ("ln1s", "ln1b", "ln2s", "ln2b", "ln3s",
                                   "ln3b", "out_bias", "b2")}
    return {**vec, "wqkv": (d, 3 * d), "qkv_bias": (3 * d,), "wout": (d, d),
            "w1": (d, dh), "b1": (dh,), "w2": (dh, d), "rs": (1,)}


def macaron_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                 dh: int):
    """(fused q|k|v product, FFN chunk width, shared-memory bytes) of one
    CTA, or None where one image does not fit one CTA (the shape then takes
    the tiled route, :func:`macaron_route`): ``mac_plan`` of
    ``csrc/macaron.cu`` in Python, so that a CPU run routes as the card
    does. ``chip_smoke.py`` holds it against ``mac_plan``. It decides the
    route in either dtype; the f32 kernel then lays its CTA out by
    :func:`macaron_plan_f32`."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    tb = torch.empty((), dtype=dtype).element_size()
    hd, pad = d // num_heads, 16 // tb
    for fused in (1, 0):
        for hc in _CHUNKS:
            if dh % hc:
                continue
            rows = [(d + pad) * tb,                               # z
                    (max(hc, 3 * hd if fused else hd, n_pad) + 4) * 4,
                    (max(hc, hd) + pad) * tb,                     # hbuf
                    *[(hd + pad) * tb] * 3,                       # q, k, v
                    (n_pad + pad) * tb,                           # p
                    *([(d + 4) * 4] if tb == 2 else [])]          # state
            total = sum(align128(n_pad * r) for r in rows)
            if total <= _MAX_SMEM:
                return fused, hc, total
    return None


def f32_layout(n_pad: int, d: int, num_heads: int, hc: int, nb: int) -> dict:
    """``make_plan_f32`` of csrc/macaron.cu: byte offsets of
    ``mac_kernel_f32``'s CTA (the staging ring, then one region for the
    GELU chunk's planes or p's), its row strides (floats) and its workspace
    (floats per image: z, then the head's q | k | v)."""
    n, hd = n_pad, d // num_heads
    lay = {"slot": ring_slot(n, nb), "ld_h": hc + 4, "ld_p": n + 4,
           "ld_qkv": 3 * hd, "ring": 0}
    off = align128(2 * _STAGES * lay["slot"] * 4)
    fh, fp = align128(n * lay["ld_h"] * 4), align128(n * lay["ld_p"] * 4)
    lay.update(hbig=off, hsmall=off + fh, pbig=off, psmall=off + fp,
               total=off + 2 * max(fh, fp), ws_qkv=n * d)
    lay["ws"] = lay["ws_qkv"] + n * lay["ld_qkv"]
    return lay


def macaron_plan_f32(n_pad: int, n_real: int, d: int, num_heads: int,
                     dh: int):
    """``mac_plan_f32`` of csrc/macaron.cu in Python: the widest FFN chunk
    (``kChunksF32``), then the widest column block no narrower than the
    chunk, that fit one CTA, as (FFN chunk width, column block,
    shared-memory bytes, workspace floats per image); or None.
    ``chip_smoke.py`` holds it against ``mac_plan_f32``."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    for hc in F32_CHUNKS:
        for nb in F32_BLOCKS:
            if dh % hc or nb < hc or not block_ok(n_pad, nb):
                continue
            lay = f32_layout(n_pad, d, num_heads, hc, nb)
            if lay["total"] <= _MAX_SMEM:
                return hc, nb, lay["total"], lay["ws"]
    return None


def macaron_route(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                  dh: int, bwd: bool = False) -> str:
    """"cta" where the one-image-per-CTA kernel has a plan (of the backward
    with ``bwd``), else "tiled" where the tiled route has one (key-tiled
    attention past 256 padded tokens); raises where neither has one
    (sizes that are not multiples of 16). The same rule on either
    device."""
    from odevit_tpu_torch.kernels.macaron_tiled import tiled_macaron_plan
    if bwd:
        from odevit_tpu_torch.kernels.macaron_bwd import macaron_bwd_plan
        cta = macaron_bwd_plan(dtype, n_pad, n_real, d, num_heads, dh)
    else:
        cta = macaron_plan(dtype, n_pad, n_real, d, num_heads, dh)
    if cta is not None:
        return "cta"
    if tiled_macaron_plan(dtype, n_pad, n_real, d, num_heads, dh):
        return "tiled"
    raise ValueError(
        f"no Macaron plan for n_pad={n_pad}, D={d}, {num_heads} heads, "
        f"dh={dh} in {dtype}: one image per CTA needs n_pad <= 128, and "
        f"both routes need multiples of 16")


def _check(x, w: MacaronWeights, num_heads, n_real, mode, base,
           bwd: bool = False) -> str:
    """Checks the arguments; returns the route (:func:`macaron_route`)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, n_pad, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    if n % TOKEN_PAD:
        raise ValueError(f"token axis {n} is not padded to {TOKEN_PAD}")
    if not 0 < n_real <= n:
        raise ValueError(f"n_real {n_real} outside (0, {n}]")
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by {num_heads} heads")
    dh = w.w1.shape[1]
    for name, shape in _shapes(d, dh).items():
        t = getattr(w, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if (mode == "base") != (base is not None):
        raise ValueError("base is given exactly when mode == 'base'")
    if base is not None and base.shape != x.shape:
        raise ValueError(f"base {tuple(base.shape)} != x {tuple(x.shape)}")
    return macaron_route(x.dtype, n, n_real, d, num_heads, dh, bwd)


def chain_plain(xf, w: MacaronWeights, *, num_heads: int, n_real: int,
                dtype):
    """The evaluation's chain from the float32 state ``xf``, rounding to
    ``dtype`` where the kernel rounds; returns every intermediate the
    backward needs (``x3`` is the last state)."""
    b, n, d = xf.shape
    hd = d // num_heads
    rs = w.rs.reshape(())

    def ffn(z):
        h1 = dot32(z, w.w1) + w.b1
        h = torch.nn.functional.gelu(h1).to(dtype)
        return dot32(h, w.w2) + w.b2, h1, h

    z1 = layer_norm(xf, w.ln1s, w.ln1b).to(dtype)
    f1, h1_1, h_1 = ffn(z1)
    x1 = xf + 0.5 * rs * f1
    z2 = layer_norm(x1, w.ln2s, w.ln2b).to(dtype)
    qkv = (dot32(z2, w.wqkv) + w.qkv_bias).to(dtype)
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    key = torch.arange(n, device=xf.device) < n_real
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~key, float("-inf"))      # select, never 0 * x
    pf = torch.softmax(s, dim=-1)
    pd = pf.to(dtype)
    v = torch.where(key[:, None], v, torch.zeros((), dtype=dtype,
                                                 device=xf.device))
    ctx = dot32(pd, v).to(dtype).transpose(1, 2).reshape(b, n, d)
    ao = dot32(ctx, w.wout) + w.out_bias
    x2 = x1 + rs * ao
    z3 = layer_norm(x2, w.ln3s, w.ln3b).to(dtype)
    f3, h1_3, h_3 = ffn(z3)
    x3 = x2 + 0.5 * rs * f3
    return dict(z1=z1, h1_1=h1_1, h_1=h_1, f1=f1, x1=x1, z2=z2, q=q, k=k,
                v=v, pf=pf, pd=pd, ctx=ctx, ao=ao, x2=x2, z3=z3, h1_3=h1_3,
                h_3=h_3, f3=f3, x3=x3, key=key)


def macaron_eval_plain(x, w: MacaronWeights, *, num_heads: int,
                       scaler: float, n_real: int, mode: str = "plain",
                       dt: float = 0.0, base=None):
    """The kernel's arithmetic in plain PyTorch."""
    _check(x, w, num_heads, n_real, mode, base)
    f = chain_plain(x.float(), w, num_heads=num_heads, n_real=n_real,
                    dtype=x.dtype)["x3"] * scaler
    if mode == "euler":
        f = x.float() + dt * f
    elif mode == "base":
        f = base.float() + dt * f
    return f.to(x.dtype)


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "base", "out", *MacaronWeights._fields, "ws")]
        + [(name, ctypes.c_int) for name in (
            "batch", "n_pad", "n_real", "d", "heads", "dh", "qkv_fused",
            "hc", "smem", "mode", "nb")]
        + [(name, ctypes.c_float) for name in ("scaler", "coef",
                                                "qk_scale")])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("macaron")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.mac_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 3
        lib.mac_plan.restype = i
        lib.mac_launch.argtypes = [i, ctypes.POINTER(_Args), p]
        lib.mac_launch.restype = i
        lib.mac_error_string.argtypes = [i]
        lib.mac_error_string.restype = ctypes.c_char_p
        lib.mac_plan_f32.argtypes = ([i] * 5 + [ctypes.POINTER(i)] * 3
                                     + [ctypes.POINTER(ctypes.c_longlong)])
        lib.mac_plan_f32.restype = i
        lib.mac_f32_launches.argtypes = []
        lib.mac_f32_launches.restype = ctypes.c_ulonglong
        _lib = lib
    return _lib


def kernel_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                dh: int):
    """``mac_plan`` of ``csrc/macaron.cu``: (fused q|k|v product, FFN chunk
    width, shared-memory bytes), or None where the shape has no plan."""
    fused, hc, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().mac_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                           ctypes.byref(fused), ctypes.byref(hc),
                           ctypes.byref(smem)):
        return None
    return fused.value, hc.value, smem.value


def kernel_plan_f32(n_pad: int, n_real: int, d: int, num_heads: int,
                    dh: int):
    """``mac_plan_f32`` of the CUDA source: (FFN chunk width, column
    block, shared-memory bytes, workspace floats per image) of
    ``mac_kernel_f32``, or None where the shape has none."""
    outs = [ctypes.c_int() for _ in range(3)]
    ws = ctypes.c_longlong()
    if _library().mac_plan_f32(n_pad, n_real, d, num_heads, dh,
                               *map(ctypes.byref, outs), ctypes.byref(ws)):
        return None
    return (*(o.value for o in outs), ws.value)


def f32_launches() -> int:
    """``mac_kernel_f32``'s launches so far (the library's C counter)."""
    return _library().mac_f32_launches()


def check_launch(x, w: MacaronWeights, base=None):
    """Device, dtype and layout of a Macaron kernel's inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA or CPU, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, not {x.dtype}")
    tensors = {"x": x, **w._asdict()}
    if base is not None:
        tensors["base"] = base
    for name, t in tensors.items():
        want = x.dtype if name in ("x", "base", *_MATRICES) else torch.float32
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} is not 32-byte aligned")


def macaron_eval(x, w: MacaronWeights, *, num_heads: int, scaler: float,
                 n_real: int, mode: str = "plain", dt: float = 0.0,
                 base=None, plain: bool = False):
    """One Macaron evaluation (see the module docstring).

    A CUDA tensor launches the kernel of its route; a CPU tensor runs
    :func:`macaron_eval_plain`. ``plain=True`` runs the plain version on
    the GPU too: it exists for comparisons, and the main path never sets
    it.
    """
    if plain or x.device.type == "cpu":
        return macaron_eval_plain(x, w, num_heads=num_heads, scaler=scaler,
                                  n_real=n_real, mode=mode, dt=dt, base=base)
    route = _check(x, w, num_heads, n_real, mode, base)
    check_launch(x, w, base)
    if route == "tiled":
        from odevit_tpu_torch.kernels.macaron_tiled import tiled_eval
        out = tiled_eval(x, w, num_heads=num_heads, scaler=scaler,
                         n_real=n_real, mode=mode, dt=dt, base=base)
        count_tiled("macaron_eval_tiled", x.shape[1])
        return out
    b, n, d = x.shape
    dh = w.w1.shape[1]
    if x.dtype == torch.float32:
        hc, nb, smem, ws = macaron_plan_f32(n, n_real, d, num_heads, dh)
        ws = torch.empty(b * ws, device=x.device)   # z and a head's q|k|v
        plan = dict(ws=ws.data_ptr(), hc=hc, nb=nb, smem=smem)
    else:
        fused, hc, smem = macaron_plan(x.dtype, n, n_real, d, num_heads, dh)
        plan = dict(qkv_fused=fused, hc=hc, smem=smem)
    out = torch.empty_like(x)
    args = _Args(
        x=x.data_ptr(), base=base.data_ptr() if base is not None else None,
        out=out.data_ptr(), **{name: t.data_ptr() for name, t in
                               w._asdict().items()},
        batch=b, n_pad=n, n_real=n_real, d=d, heads=num_heads, dh=dh,
        mode=MODES[mode], scaler=scaler, coef=dt,
        qk_scale=(d // num_heads) ** -0.5, **plan)
    err = _library().mac_launch(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("Macaron kernel launch failed: "
                           + _library().mac_error_string(err).decode())
    count_launch("macaron_eval")
    return out
