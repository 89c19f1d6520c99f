"""Backward of one fused Macaron evaluation.

``macaron_bwd`` launches CUDA counterparts of the TPU kernel
``odevit_tpu/kernels/macaron.py::_macaron_bwd_kernel`` on a CUDA tensor and
runs its plain PyTorch version ``macaron_bwd_plain`` on a CPU tensor. The
route is ``macaron_route(..., bwd=True)``'s: the kernels of
``csrc/macaron_bwd.cu`` (one image per CTA, counted as ``macaron_bwd``)
where :func:`macaron_bwd_plan` has a plan, else the tiled route of
``csrc/macaron_tiled.cu`` (``macaron_bwd_tiled``; key-tiled attention
past 256 padded tokens); a shape with neither plan raises. JAX's
backward is ``pallas_macaron_bwd`` wherever ``macaron_bwd_block_b`` finds
a batch tile, else ``jax.vjp`` of its XLA twin (at MLP ratio 4 and 224
px, for one); the cotangents are the same. Both take the forward's
input ``x``, its weights and the cotangent ``g`` of f(x), and return the
16 cotangents of ``pallas_macaron_bwd`` in its order (x_bar in x's
dtype, the rest in float32, ``rs``'s as a ``(1,)`` tensor):

    (x_bar, ln1s, ln1b, ln2s, ln2b, ln3s, ln3b, wqkv, qkv_bias, wout,
     out_bias, w1, b1, w2, b2, rs)

They follow the TPU kernel's arithmetic, not autograd through the plain
forward: the FFN halves' out_bar is rounded for W2_bar and h_bar while
b2_bar sums the float32 values; h1_bar is rounded before W1_bar, b1_bar
and z_bar; ao_bar is float32 for out_bias_bar and rounded for Wout_bar and
ctx_bar; s_bar takes the float32 p and v_bar the rounded p; k_bar
multiplies round(q tau); qkv_bar is rounded before its three uses; the
LayerNorm backward is the TPU kernel's ``ln_bwd``. The shared FFN's weight
cotangents sum both halves. Rows ``>= n_real`` of ``x`` and ``g`` are read
as zeros and those of ``x_bar`` are zeros, so nothing a padded row holds
reaches a cotangent.
"""

from __future__ import annotations

import ctypes
import math

import torch

from odevit_tpu_torch.kernels import count_launch, count_tiled
from odevit_tpu_torch.kernels.macaron import (MacaronWeights, _check,
                                              chain_plain, check_launch)
from odevit_tpu_torch.kernels.macaron_tiled import tiled_bwd
from odevit_tpu_torch.kernels.vector_field import (_CHUNKS, _MAX_SMEM,
                                                   align128, cta_shape_ok)
from odevit_tpu_torch.kernels.vector_field_bwd import (_SMS, _gelu_grad,
                                                       check_operands,
                                                       weight_splits)
from odevit_tpu_torch.ops.dot import dot32
from odevit_tpu_torch.ops.layer_norm import LN_EPS

BAR_NAMES = ("x", *MacaronWeights._fields)


_BLOCKS = (192, 128, 96, 64, 32, 16)   # ``kBlocks``: the f32 column blocks
_SLICE, _LD_K, _STAGES = 16, 20, 2      # ``mac::kSlice``, ``kLdK``, ``kStages``
_RED = align128((12 + 2 * 128) * 4)     # reduction scratch, row statistics


def cta_layout_bytes(tb: int, n: int, hd: int, hc: int) -> int:
    """Bytes of ``mcb_rows``'s layout (``make_plan``): the one-CTA route's
    rule in either dtype, and the bf16 kernel's plan."""
    pad = 16 // tb
    off = _RED + align128(n * (max(hc, 3 * hd, n) + 4) * 4)     # st
    ffn = align128(n * (hc + 4) * 4) + align128(n * (hc + pad) * tb)
    attn = (align128(n * (n + 4) * 4) + align128(n * (n + pad) * tb)
            + 4 * align128(n * (hd + pad) * tb))                # q k v cb
    return off + max(ffn, attn)


def f32_layout(n: int, hc: int, nb: int) -> dict:
    """``make_plan_f32`` of ``csrc/macaron_bwd.cu``: byte offsets, the
    ring's plane of one slot (``slot``, floats) and the row strides
    (floats) of ``mcb_rows_f32``'s shared memory."""
    slot = n * _LD_K + max(_SLICE * (nb + 8), nb * _LD_K)   # ring_slot
    ld_h, ld_p = hc + 4, n + 4
    fh, fp = align128(n * ld_h * 4), align128(n * ld_p * 4)
    ring = _RED
    off = ring + align128(2 * _STAGES * slot * 4)
    return {"ring": ring, "slot": slot, "ld_h": ld_h, "ld_p": ld_p,
            "ld_b": nb + 8, "ld_k": _LD_K, "pre": off, "hbig": off + fh,
            "hsmall": off + 2 * fh, "st": off, "pf": off + fp,
            "pbig": off + 2 * fp, "psmall": off + 3 * fp,
            "total": off + max(3 * fh, 4 * fp)}


def macaron_bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                     dh: int):
    """(FFN chunk width, shared-memory bytes, column block) of the
    per-image kernel, or None where one image does not fit one CTA (the
    shape then takes the tiled route, ``macaron_route``): ``mcb_plan`` of
    ``csrc/macaron_bwd.cu`` in Python. A shape has a plan where
    ``mcb_rows``'s layout fits (:func:`cta_layout_bytes`); in bf16 that
    layout is the plan (column block 0), in f32 :func:`f32_layout`'s
    (wide column blocks first). ``chip_smoke.py`` holds it against
    ``mcb_plan``."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    tb = torch.empty((), dtype=dtype).element_size()
    for hc in _CHUNKS:
        if dh % hc or cta_layout_bytes(tb, n_pad, d // num_heads,
                                      hc) > _MAX_SMEM:
            continue
        if tb == 2:
            return hc, cta_layout_bytes(tb, n_pad, d // num_heads, hc), 0
        for nb in _BLOCKS:
            if -(-nb // 32) * -(-(n_pad // 16) // 3) > 12:
                continue          # block_fits: one round of warp tiles
            for hc32 in _CHUNKS:
                if dh % hc32:
                    continue
                total = f32_layout(n_pad, hc32, nb)["total"]
                if total <= _MAX_SMEM:
                    return hc32, total, nb
        return None
    return None


def wgrad_splits(dtype, rows: int, d: int, dh: int) -> int:
    """Slices of rows the weight products are split into. bf16:
    ``weight_splits``. f32 (``mcb_wgrad_f32``'s 128 x 64 tiles): about
    four CTAs per SM in the smaller pass (Wqkv and Wout), each slice at
    least 256 rows. Fixed by the shape, so the reduction order, and the
    result, are the same every run."""
    if dtype != torch.float32:
        return weight_splits(rows, d, dh, dtype=dtype)
    t = lambda m, n: -(-m // 128) * -(-n // 64)
    return max(1, min(math.ceil(4 * _SMS / (t(d, 3 * d) + t(d, d))),
                      rows // 256))


def ln_stats(xf):
    """(chat, rstd) of the kernels' LayerNorm of ``xf``, float32."""
    c = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + LN_EPS)
    return c * rstd, rstd


def macaron_bwd_plain(x, w: MacaronWeights, g, *, num_heads: int,
                      scaler: float, n_real: int):
    """The kernels' arithmetic in plain PyTorch: the 16 cotangents."""
    _check(x, w, num_heads, n_real, "plain", None, bwd=True)
    b, n, d = x.shape
    dtype = x.dtype
    zero = torch.zeros((), device=x.device)
    row = (torch.arange(n, device=x.device) < n_real)[:, None]
    xf = torch.where(row, x.float(), zero)
    c = chain_plain(xf, w, num_heads=num_heads, n_real=n_real, dtype=dtype)
    rs = w.rs.reshape(())
    hd = d // num_heads
    tau = hd ** -0.5
    t2 = lambda a: a.reshape(-1, a.shape[-1])
    rsum = lambda a: t2(a).sum(0)

    def ln_bwd(z_bar, src, scale):
        chat, rstd = ln_stats(src)
        u = z_bar * scale
        dx = rstd * (u - u.mean(-1, keepdim=True)
                     - chat * (u * chat).mean(-1, keepdim=True))
        return dx, rsum(z_bar * chat), rsum(z_bar)

    def ffn_bwd(out_bar, z, h1, h):
        ob = out_bar.to(dtype)
        h1_bar = (dot32(ob, w.w2.T) * _gelu_grad(h1)).to(dtype)
        return (dot32(h1_bar, w.w1.T), dot32(t2(z).T, t2(h1_bar)),
                rsum(h1_bar.float()), dot32(t2(h).T, t2(ob)), rsum(out_bar))

    x3b = torch.where(row, g.float() * scaler, zero)
    rs_bar = 0.5 * (x3b * c["f3"]).sum()
    z3b, w1b, b1b, w2b, b2b = ffn_bwd(0.5 * rs * x3b, c["z3"], c["h1_3"],
                                      c["h_3"])
    dx, s3b, b3b = ln_bwd(z3b, c["x2"], w.ln3s)
    x2b = x3b + dx

    rs_bar = rs_bar + (x2b * c["ao"]).sum()
    ao_bar = rs * x2b
    aod = ao_bar.to(dtype)
    heads = lambda a: a.reshape(b, n, num_heads, hd).transpose(1, 2)
    cb = heads(dot32(aod, w.wout.T)).to(dtype)
    pf, pd, q, k, v = c["pf"], c["pd"], c["q"], c["k"], c["v"]
    p_bar = dot32(cb, v.transpose(-1, -2))
    v_bar = dot32(pd.transpose(-1, -2), cb)
    s_bar = pf * (p_bar - (p_bar * pf).sum(-1, keepdim=True))
    s_bar = torch.where(c["key"] & row, s_bar, zero).to(dtype)
    q_bar = dot32(s_bar, k) * tau
    k_bar = dot32(s_bar.transpose(-1, -2), (q.float() * tau).to(dtype))
    qkv_bar = torch.stack([q_bar, k_bar, v_bar], 2).to(dtype)  # [b,H,3,n,hd]
    qkv_bar = qkv_bar.permute(0, 3, 2, 1, 4).reshape(b, n, 3 * d)
    dx, s2b, b2nb = ln_bwd(dot32(qkv_bar, w.wqkv.T), c["x1"], w.ln2s)
    x1b = x2b + dx

    rs_bar = rs_bar + 0.5 * (x1b * c["f1"]).sum()
    z1b, w1b1, b1b1, w2b1, b2b1 = ffn_bwd(0.5 * rs * x1b, c["z1"],
                                          c["h1_1"], c["h_1"])
    dx, s1b, b1nb = ln_bwd(z1b, xf, w.ln1s)
    x_bar = torch.where(row, x1b + dx, zero).to(dtype)
    return (x_bar, s1b, b1nb, s2b, b2nb, s3b, b3b,
            dot32(t2(c["z2"]).T, t2(qkv_bar)), rsum(qkv_bar.float()),
            dot32(t2(c["ctx"]).T, t2(aod)), rsum(ao_bar),
            w1b + w1b1, b1b + b1b1, w2b + w2b1, b2b + b2b1,
            rs_bar.reshape(1))


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "g", *MacaronWeights._fields, "xbar", "z13", "z2", "h13",
        "h1b13", "ob13", "qkv", "ctx", "aod", "qkvbar", "st32", "npart",
        "wpart", "out")]
        + [(name, ctypes.c_int) for name in (
            "batch", "n_pad", "n_real", "d", "heads", "dh", "hc", "nb",
            "smem", "splits")]
        + [("scaler", ctypes.c_float), ("qk_scale", ctypes.c_float)])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("macaron_bwd")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.mcb_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 3
        lib.mcb_plan.restype = i
        lib.mcb_launch.argtypes = [i, ctypes.POINTER(_Args), p]
        lib.mcb_launch.restype = i
        lib.mcb_error_string.argtypes = [i]
        lib.mcb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                    dh: int):
    """``mcb_plan`` of ``csrc/macaron_bwd.cu``: (FFN chunk width,
    shared-memory bytes, column block), or None where the shape has no
    plan."""
    hc, smem, nb = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().mcb_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                           ctypes.byref(hc), ctypes.byref(smem),
                           ctypes.byref(nb)):
        return None
    return hc.value, smem.value, nb.value


def partials(d: int, dh: int) -> int:
    """Length of one image's partials: the six LayerNorm vectors, the four
    biases and rs (``np_offsets`` of ``csrc/macaron_bwd.cu``)."""
    return 11 * d + dh + 1


def macaron_bwd(x, w: MacaronWeights, g, *, num_heads: int, scaler: float,
                n_real: int, plain: bool = False):
    """The 16 cotangents of one evaluation (see the module docstring). A
    CUDA tensor launches the kernels of its route; a CPU tensor, or
    ``plain=True``, runs :func:`macaron_bwd_plain`."""
    if plain or x.device.type == "cpu":
        return macaron_bwd_plain(x, w, g, num_heads=num_heads, scaler=scaler,
                                 n_real=n_real)
    route = _check(x, w, num_heads, n_real, "plain", None, bwd=True)
    check_launch(x, w)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
    check_operands(x, g=(g, x.dtype))
    b, n, d = x.shape
    dh = w.w1.shape[1]
    rows = b * n
    # one split count for both weight passes (B*n_pad and 2*B*n_pad rows)
    splits = wgrad_splits(x.dtype, rows, d, dh)
    wtotal = 4 * d * d + 2 * d * dh
    nlen = partials(d, dh)
    if route == "tiled":
        xbar, out = tiled_bwd(x, w, g, num_heads=num_heads, scaler=scaler,
                              n_real=n_real, splits=splits, nlen=nlen)
        count_tiled("macaron_bwd_tiled", n)
        return split_bars(xbar, out, d, dh)
    hc, smem, nb = macaron_bwd_plan(x.dtype, n, n_real, d, num_heads, dh)

    def scratch(width, halves=1, dtype=x.dtype):
        return torch.empty(halves * rows, width, device=x.device, dtype=dtype)

    bufs = {"xbar": torch.empty_like(x), "z13": scratch(d, 2),
            "z2": scratch(d), "h13": scratch(dh, 2), "h1b13": scratch(dh, 2),
            "ob13": scratch(d, 2), "qkv": scratch(3 * d), "ctx": scratch(d),
            "aod": scratch(d), "qkvbar": scratch(3 * d),
            "st32": scratch(d, 7, torch.float32),
            "npart": torch.empty(b, nlen, device=x.device),
            "wpart": torch.empty(splits, wtotal, device=x.device),
            "out": torch.empty(wtotal + nlen, device=x.device)}
    args = _Args(
        x=x.data_ptr(), g=g.data_ptr(),
        **{name: t.data_ptr() for name, t in w._asdict().items()},
        **{name: t.data_ptr() for name, t in bufs.items()},
        batch=b, n_pad=n, n_real=n_real, d=d, heads=num_heads, dh=dh, hc=hc,
        nb=nb, smem=smem, splits=splits, scaler=scaler,
        qk_scale=(d // num_heads) ** -0.5)
    err = _library().mcb_launch(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("Macaron backward launch failed: "
                           + _library().mcb_error_string(err).decode())
    count_launch("macaron_bwd")
    return split_bars(bufs["xbar"], bufs["out"], d, dh)


def split_bars(xbar, out, d: int, dh: int):
    """x_bar and the flat [Wqkv, Wout, W1, W2, then the partials' sums]
    buffer -> the 16 cotangents in the order of the module docstring."""
    (wqkv, wout, w1, w2, s1, b1n, s2, b2n, s3, b3n, qkvb, outb, b1, b2,
     rs) = torch.split(out, [3 * d * d, d * d, d * dh, dh * d, d, d, d, d, d,
                             d, 3 * d, d, dh, d, 1])
    return (xbar, s1, b1n, s2, b2n, s3, b3n, wqkv.view(d, 3 * d), qkvb,
            wout.view(d, d), outb, w1.view(d, dh), b1, w2.view(dh, d), b2, rs)
