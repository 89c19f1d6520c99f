"""Backward of one fused vector-field evaluation.

``vf_bwd`` launches the CUDA kernels of ``csrc/vector_field_bwd.cu`` (the
counterpart of the TPU kernel ``odevit_tpu/kernels/vector_field_bwd.py::
_vf_bwd_kernel``) on a CUDA tensor, and runs its plain PyTorch version
``vf_bwd_plain`` on a CPU tensor. Both take the forward's input ``x``, its
weights, the cotangent ``g`` of f(x) and, for an evaluation of the
JaSMin-statistics mode, the cotangent ``g_jas`` of its statistics with the
columns ``jas_idx`` the forward took them from, and for an evaluation of the
attention-map mode, the cotangent ``g_attn`` [B, H, n_pad, n_pad] of its
maps (read on real query rows and real keys only). They return the 9
cotangents (x_bar in x's dtype; the norms' and weights' in float32):

    (x_bar, norm_attn_scale, norm_attn_bias, norm_mlp_scale, norm_mlp_bias,
     wqkv, wout, w1, w2)

Rows ``>= n_real`` of ``x`` and ``g`` are read as zeros and those of
``x_bar`` are zeros, so nothing a padded row holds reaches a cotangent.

L2 attention (weights with ``qkv_bias`` and ``out_bias``; the TPU
kernel's ``l2_attention`` with biases) returns 11 cotangents, the two
biases' last, as ``pallas_vf_bwd(l2_attention=True, qkv_bias=...)`` does.
It follows the TPU kernel's arithmetic, not autograd through the plain
forward: with ``e_bar = (p_bar - sum(p_bar p)) / esum`` and ``d2b = -tau e
e_bar`` in float32, ``q_bar = 2 q sum_k d2b - 2 round(d2b) k``, ``k_bar = 2
k sum_q d2b - 2 round(d2b)^T q``, and the biases' cotangents are the
column sums of ``round(g scaler)`` and of ``round([q_bar k_bar v_bar])``.
Without dropout or the maps' cotangent, it runs on one CTA per image where
``l2_bwd_plan`` has a plan (counted as ``vf_bwd_l2``), else on the tiled
route (``vf_bwd_l2_tiled``), and never on the split route: JAX keeps its
combined kernel for L2, and its split halves take no biases.

Routes: for softmax weights where D >= 512 and dh >= 4 D (TS-Base at MLP
ratio 4), the split route of ``vector_field_bwd_split.py`` runs, one
MLP-branch and one attention-branch backward, on the GPU and in its plain
twins on the CPU.
Elsewhere, without ``g_attn``, where one image fits one CTA (``bwd_plan``),
the kernels of ``csrc/vector_field_bwd.cu`` run: the rows kernel of the
dtype (``vfb_rows_bf16``: ``mma.sync`` register tiles, the weights staged
once per CTA by ``cp.async``, m_bar on chip; ``vfb_rows_f32``: split TF32,
each laid out by its own plan, :func:`bf16_bwd_plan` / :func:`f32_bwd_plan`),
the weight products and the fixed-order reduce; with ``g_attn``, or where
no such plan exists (the 224 px TS-Base shape at ratio 1), the tiled route
of ``csrc/vector_field_tiled.cu`` runs (``kernels/tiled.py``).

Residuals (the TPU kernel's ``has_resid``, the backward of
``fused_vf_stash`` and ``fused_vf_jasmin_stash``): ``resid_qkv`` and
``resid_h1``, the forward's stash (``vf_eval(stash=True)``), come as a pair
or not at all, softmax and without dropout. The backward reads q, k and v
from rqkv and h1 from rh1 instead of recomputing the qkv and fc1
products, and takes h = round(gelu(f32(rh1))) and h1_bar = round(h_bar
gelu'(f32(rh1))), as JAX's stash backward does; padded rows of both read
as zeros. The route is that of the same call without them; on the GPU
the kernels' resid instances run, counted as ``vf_bwd_resid`` (one image
per CTA), ``vf_bwd_resid_tiled`` and, on the split route,
``vf_bwd_mlp_resid`` and ``vf_bwd_attn_resid``.

Dropout: ``seed`` and ``drops`` as the forward took them; the masks are
drawn again (``kernels/dropout.py``), never saved. On the GPU the kernels'
dropout instances run, counted as ``vf_bwd_drop`` (one image per CTA) and
``vf_bwd_tiled_drop`` (the tiled route, with or without the maps'
cotangent, which adds to the pre-dropout p's cotangent).
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import count_launch, count_tiled
from odevit_tpu_torch.kernels.dropout import Drop, drop_spec, masks_plain
from odevit_tpu_torch.kernels.tiled import tiled_backward
from odevit_tpu_torch.kernels.vector_field import (
    _CHUNKS, _MAX_SMEM, _STAGES, VFWeights, _check, _check_launch,
    _check_l2_drop, align128, cta_shape_ok, f32_search, l2_probs, l2_route,
    ring_slot)
from odevit_tpu_torch.ops.dot import dot32

# SMs of an H100: the weight products are split over rows to fill them
_SMS = 132


def _gelu_grad(v):
    return (0.5 * (1.0 + torch.erf(v * 2.0 ** -0.5))
            + v * 0.3989422804014327 * torch.exp(-0.5 * v * v))


def _jas_pbar(pb, g_jas, jas_idx, n_real: int):
    """The JaSMin statistics' cotangent as a p_bar term [B, H, n, n]: row 4
    (the clipped row sum) through clip's subgradient (0.5 at either bound,
    as JAX gives it), rows 0..3 onto the saved columns."""
    n = pb.shape[-1]
    pj = pb.float()
    lo = ((pj >= 1e-12).float() + (pj > 1e-12).float()) * 0.5
    hi = ((pj <= 1.0).float() + (pj < 1.0).float()) * 0.5
    key = torch.arange(n, device=pb.device) < n_real
    t = torch.where(key, g_jas[:, :, 4, :, None] * (lo * hi),
                    torch.zeros((), device=pb.device))
    for i in range(4):
        idx = jas_idx[:, :, i, :].long()
        ok = (idx >= 0) & (idx < n_real)
        t = t.scatter_add(-1, idx.clamp(0, n - 1)[..., None],
                          torch.where(ok, g_jas[:, :, i, :], 0.0)[..., None])
    query = (torch.arange(n, device=pb.device) < n_real)[:, None]
    return torch.where(query, t, torch.zeros((), device=pb.device))


def bwd_inputs(x, g, *, scaler: float, n_real: int):
    """(real-row mask [n, 1], cent = (x - mean) d/(d-1), g * scaler): the
    last two float32, with rows >= n_real read as zeros; what both branches
    of the backward start from."""
    d = x.shape[-1]
    zero = torch.zeros((), device=x.device)
    row = (torch.arange(x.shape[1], device=x.device) < n_real)[:, None]
    xf = torch.where(row, x.float(), zero)
    cent = (xf - xf.mean(-1, keepdim=True)) * (d / (d - 1.0))
    return row, cent, torch.where(row, g.float() * scaler, zero)


def _resid_rows(r, b: int, n: int, n_real: int):
    """A stash residual [B * n, w] as [B, n, w] float32, its rows >= n_real
    read as zeros."""
    r = r.reshape(b, n, -1).float()
    row = (torch.arange(n, device=r.device) < n_real)[:, None]
    return torch.where(row, r, torch.zeros((), device=r.device))


def mlp_bars(x, w: VFWeights, cent, gf, mask_h=None, mask_mo=None,
             resid_h1=None, n_real: int = 0):
    """The MLP branch's backward in plain PyTorch: (m_bar [B, n, D] f32,
    W1_bar, W2_bar), rounding where the TPU kernel rounds; the masks are
    the forward's (None without dropout). With ``resid_h1`` (and the
    ``n_real`` its padded rows are cut at) h1 is read from it."""
    b, n, _ = x.shape
    dtype = x.dtype
    cn_m = (cent * w.norm_mlp_scale + w.norm_mlp_bias).to(dtype)
    gd = (gf if mask_mo is None else gf * mask_mo).to(dtype)
    t2 = lambda a: a.reshape(b * n, a.shape[-1])
    h1 = (dot32(cn_m, w.w1) if resid_h1 is None
          else _resid_rows(resid_h1, b, n, n_real))
    h = torch.nn.functional.gelu(h1).to(dtype)
    h_bar = dot32(gd, w.w2.T)
    if mask_h is not None:
        h = (h.float() * mask_h).to(dtype)
        h_bar = h_bar * mask_h
    h1_bar = (h_bar * _gelu_grad(h1)).to(dtype)
    m_bar = dot32(h1_bar, w.w1.T)
    return m_bar, dot32(t2(cn_m).T, t2(h1_bar)), dot32(t2(h).T, t2(gd))


def attn_bars(x, w: VFWeights, cent, gf, row, *, num_heads: int,
              n_real: int, g_jas=None, jas_idx=None, g_attn=None,
              mask_ao=None, mask_p=None, resid_qkv=None):
    """The attention branch's backward in plain PyTorch: (a_bar [B, n, D]
    f32, Wqkv_bar, Wout_bar). g * scaler * mask_ao is its cotangent
    operand, and p is rounded before and after its mask, as in the
    forward. With ``resid_qkv`` q, k and v are read from it."""
    b, n, d = x.shape
    hd = d // num_heads
    tau = hd ** -0.5
    dtype = x.dtype
    zero = torch.zeros((), device=x.device)
    cn_a = (cent * w.norm_attn_scale + w.norm_attn_bias).to(dtype)
    gda = (gf if mask_ao is None else gf * mask_ao).to(dtype)
    t2 = lambda a: a.reshape(b * n, a.shape[-1])
    if resid_qkv is None:
        qkv = dot32(cn_a, w.wqkv)
        if w.l2:
            qkv = qkv + w.qkv_bias
    else:
        qkv = _resid_rows(resid_qkv, b, n, n_real)
    q, k, v = qkv.to(dtype).reshape(b, n, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4)
    key = torch.arange(n, device=x.device) < n_real
    v = torch.where(key[:, None], v, torch.zeros((), dtype=dtype,
                                                 device=x.device))
    if w.l2:
        pf, e, esum = l2_probs(q, k, key)
    else:
        s = (q.float() * tau) @ k.float().transpose(-1, -2)
        pf = torch.softmax(s.masked_fill(~key, float("-inf")), dim=-1)
    pb = pf.to(dtype)
    pu = pb if mask_p is None else (pb.float() * mask_p).to(dtype)

    def merge(a):                   # [b, H, n, hd] -> [b, n, d]
        return a.transpose(1, 2).reshape(b, n, d)

    ctx = merge(dot32(pu, v).to(dtype))
    cb = dot32(gda, w.wout.T).to(dtype).reshape(
        b, n, num_heads, hd).transpose(1, 2)
    v_bar = dot32(pu.transpose(-1, -2), cb).to(dtype)
    p_bar = dot32(cb, v.transpose(-1, -2))
    if mask_p is not None:
        p_bar = p_bar * mask_p
    if g_attn is not None:
        # rounded to x's dtype, as the TPU kernel takes it; selected on
        # real query rows and keys, so nothing padded reaches p_bar
        p_bar = p_bar + torch.where(key & row, g_attn.to(dtype).float(),
                                    zero)
    if g_jas is not None:
        p_bar = p_bar + _jas_pbar(pb, g_jas, jas_idx, n_real)
    dot = (p_bar * pf).sum(-1, keepdim=True)
    if w.l2:
        d2b = (-tau) * e * ((p_bar - dot) / esum)
        d2b = torch.where(key & row, d2b, zero)
        d2b_d = d2b.to(dtype)
        qf, kf = q.float(), k.float()
        q_bar = (2.0 * qf * d2b.sum(-1, keepdim=True)
                 - 2.0 * dot32(d2b_d, k)).to(dtype)
        k_bar = (2.0 * kf * d2b.sum(-2)[..., None]
                 - 2.0 * dot32(d2b_d.transpose(-1, -2), q)).to(dtype)
    else:
        s_bar = torch.where(key & row, pf * (p_bar - dot), zero).to(dtype)
        q_bar = (dot32(s_bar, k) * tau).to(dtype)
        k_bar = dot32(s_bar.transpose(-1, -2),
                      (q.float() * tau).to(dtype)).to(dtype)
    qkv_bar = torch.cat([merge(q_bar), merge(k_bar), merge(v_bar)], -1)
    bars = (dot32(qkv_bar, w.wqkv.T), dot32(t2(cn_a).T, t2(qkv_bar)),
            dot32(t2(ctx).T, t2(gda)))
    if w.l2:
        bars += (qkv_bar.float().sum((0, 1)), gda.float().sum((0, 1)))
    return bars


def vf_bwd_plain(x, w: VFWeights, g, *, num_heads: int, scaler: float,
                 n_real: int, g_jas=None, jas_idx=None, g_attn=None,
                 seed=None, drops=(0.0, 0.0, 0.0), resid_qkv=None,
                 resid_h1=None):
    """The kernels' arithmetic in plain PyTorch: the forward recomputed
    (or read from the residuals), then the MLP, attention and CenterNorm
    backward, rounding to x's dtype where the TPU kernel rounds. With
    dropout, the forward's masks are drawn again and applied where the XLA
    twin's vjp applies them: g * scaler * mask_mo and g * scaler * mask_ao
    are two operands, and p is rounded before and after its mask, as in
    the forward."""
    _check_bwd(x, w, g, num_heads, n_real, g_jas, jas_idx, g_attn)
    _check_l2_drop(w, drops)
    check_resid(x, w, drops, resid_qkv, resid_h1)
    b, n, d = x.shape
    mask_h, mask_mo, mask_ao, mask_p = masks_plain(
        b, n_real, d, w.w1.shape[1], num_heads, seed, drops,
        device=x.device, n_pad=n) or (None,) * 4
    row, cent, gf = bwd_inputs(x, g, scaler=scaler, n_real=n_real)
    m_bar, w1_bar, w2_bar = mlp_bars(x, w, cent, gf, mask_h, mask_mo,
                                     resid_h1, n_real)
    a_bar, wqkv_bar, wout_bar, *bias_bars = attn_bars(
        x, w, cent, gf, row, num_heads=num_heads, n_real=n_real,
        g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn, mask_ao=mask_ao,
        mask_p=mask_p, resid_qkv=resid_qkv)
    # CenterNorm
    c_bar = a_bar * w.norm_attn_scale + m_bar * w.norm_mlp_scale
    x_bar = (d / (d - 1.0)) * (c_bar - c_bar.mean(-1, keepdim=True))
    x_bar = torch.where(row, x_bar, torch.zeros((), device=x.device))
    return (x_bar.to(x.dtype), (a_bar * cent).sum((0, 1)), a_bar.sum((0, 1)),
            (m_bar * cent).sum((0, 1)), m_bar.sum((0, 1)),
            wqkv_bar, wout_bar, w1_bar, w2_bar, *bias_bars)


def _check_bwd(x, w, g, num_heads, n_real, g_jas, jas_idx, g_attn=None):
    _check(x, w, num_heads, n_real, "plain", None)
    if w.l2:
        if g_attn is not None:
            raise NotImplementedError("the maps' cotangent has no L2 "
                                      "instance (nor has JAX's fused L2 "
                                      "path)")
        l2_route(x.dtype, x.shape[1], n_real, x.shape[2], num_heads,
                 w.w1.shape[1], bwd=True)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
    b, n, _ = x.shape
    if g_attn is not None and tuple(g_attn.shape) != (b, num_heads, n, n):
        raise ValueError(f"g_attn has shape {tuple(g_attn.shape)}, "
                         f"expected {(b, num_heads, n, n)}")
    if (g_jas is None) != (jas_idx is None):
        raise ValueError("g_jas and jas_idx come together")
    if g_jas is not None:
        b, n, _ = x.shape
        want = {"g_jas": (g_jas, (b, num_heads, 5, n)),
                "jas_idx": (jas_idx, (b, num_heads, 4, n))}
        for name, (t, shape) in want.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")


def check_resid(x, w: VFWeights, drops, resid_qkv=None, resid_h1=None,
                need=("qkv", "h1")):
    """The stash residuals a backward takes (``need``: both, or a split
    half's one): as a pair or not at all, [B * n_pad, 3D] and [B * n_pad,
    dh] in x's dtype, softmax and without dropout (as JAX asserts)."""
    given = {"qkv": resid_qkv, "h1": resid_h1}
    if all(given[k] is None for k in need):
        return False
    if any(given[k] is None for k in need):
        raise ValueError("the stash residuals come as a (qkv, h1) pair")
    if w.l2 or any(drops):
        raise ValueError("residual stashing is softmax and deterministic "
                         "only (as JAX's)")
    b, n, d = x.shape
    widths = {"qkv": 3 * d, "h1": w.w1.shape[1]}
    for k in need:
        t = given[k]
        if tuple(t.shape) != (b * n, widths[k]):
            raise ValueError(f"resid_{k} has shape {tuple(t.shape)}, "
                             f"expected {(b * n, widths[k])}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"resid_{k} is {t.dtype} on {t.device}, x "
                            f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"resid_{k} is not contiguous")
    return True


def check_operands(x, **tensors):
    """Device, dtype and layout of a backward kernel's other inputs: name
    -> (tensor or None, the dtype the kernel takes)."""
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, the kernel "
                            f"takes {dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "g", "g_jas", "jas_idx", "ga", "ba", "gm", "bm", "wqkv", "wout",
        "w1", "w2", "xbar", "cnm", "cna", "gd", "gd2", "ctx", "h", "h1b",
        "qkvb", "ws", "npart", "wpart", "out", "qkv_bias",
        "out_bias", "rqkv", "rh1")]
        + [(name, ctypes.c_int) for name in (
            "batch", "n_pad", "n_real", "d", "heads", "dh", "cn_smem", "hc",
            "smem", "splits", "nb", "acc_smem", "stages")]
        + [("scaler", ctypes.c_float), ("qk_scale", ctypes.c_float),
           ("drop", Drop)])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("vector_field_bwd")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.vfb_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
        lib.vfb_plan.restype = i
        lib.vfb_launch.argtypes = [i, ctypes.POINTER(_Args), p]
        lib.vfb_launch.restype = i
        lib.vfb_error_string.argtypes = [i]
        lib.vfb_error_string.restype = ctypes.c_char_p
        lib.vfb_plan_f32.argtypes = ([i] * 7 + [ctypes.POINTER(i)] * 4
                                     + [ctypes.POINTER(ctypes.c_longlong)])
        lib.vfb_plan_f32.restype = i
        lib.vfb_rows_f32_launches.argtypes = []
        lib.vfb_rows_f32_launches.restype = ctypes.c_ulonglong
        lib.vfb_plan_bf16.argtypes = [i] * 7 + [ctypes.POINTER(i)] * 5
        lib.vfb_plan_bf16.restype = i
        lib.vfb_rows_bf16_launches.argtypes = []
        lib.vfb_rows_bf16_launches.restype = ctypes.c_ulonglong
        _lib = lib
    return _lib


def cta_bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                 dh: int, drop: bool = False, l2: bool = False):
    """(cn and gd in shared memory, MLP chunk width, shared-memory bytes)
    of the route's per-image plan (of its dropout instance with ``drop``,
    of its L2 instance with ``l2``), or None where one image does not fit
    one CTA: ``vfb_plan`` of ``csrc/vector_field_bwd.cu`` (its
    ``make_plan``, PR 3's layout) in Python, so that a CPU run routes as
    the card does. It decides the route in either dtype; the rows kernels
    then lay their CTAs out by plans of their own, :func:`bf16_bwd_plan`
    (``vfb_rows_bf16``) and :func:`f32_bwd_plan` (``vfb_rows_f32``).
    ``chip_smoke.py`` holds it against ``vfb_plan``."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    tb = torch.empty((), dtype=dtype).element_size()
    n, hd, pad = n_pad, d // num_heads, 16 // tb
    for cn_smem in (1, 0):
        for hc in _CHUNKS:
            if dh % hc:
                continue
            off = ((3 if drop else 2) * align128(n * (d + pad) * tb)
                   if cn_smem else 0)
            off += align128(n * 4)                              # mean
            mlp = (2 * align128(n * (hc + 4) * 4)
                   + align128(n * (hc + pad) * tb))
            attn = (align128(n * (max(hd, n) + 4) * 4)          # st_a
                    + align128(n * (n + 4) * 4)                 # pf
                    + align128(n * (n + pad) * tb)              # pb
                    + 4 * align128(n * (hd + pad) * tb)         # q k v cb
                    + (align128(n * 16) if drop else 0)         # pbits
                    + (5 * align128(n * 4) if l2 else 0))       # L2
            total = off + max(mlp, attn, align128(n * (d + 4) * 4))
            if total <= _MAX_SMEM:
                return cn_smem, hc, total
    return None


def l2_bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                dh: int):
    """:func:`cta_bwd_plan` of the L2 instance."""
    return cta_bwd_plan(dtype, n_pad, n_real, d, num_heads, dh, l2=True)


def f32_bwd_layout(n_pad: int, d: int, num_heads: int, hc: int, nb: int,
                   acc_smem: int, drop: bool = False,
                   l2: bool = False) -> dict:
    """``make_plan_b32`` of csrc/vector_field_bwd.cu: byte offsets of the
    f32 backward's CTA, its row strides (floats) and its workspace (floats
    per image)."""
    n, hd = n_pad, d // num_heads
    lay = {"slot": ring_slot(n, nb), "ld_acc": d + 8, "ld_h": hc + 4,
           "ld_p": n + 4, "ld_ws": 4 * hd}
    off = 0
    lay["l2"] = off
    if l2:
        off += 5 * align128(n * 4)
    lay["mean"] = off
    off += align128(n * 4)
    lay["ring"] = off
    off += align128(2 * _STAGES * lay["slot"] * 4)
    lay["macc"] = off
    if acc_smem:
        off += align128(n * lay["ld_acc"] * 4)
    fh, fp = align128(n * lay["ld_h"] * 4), align128(n * lay["ld_p"] * 4)
    lay.update(reg=off, p0=off, p1=off + fh, pbig=off, psmall=off + fp,
               abar=off)
    a = off + 2 * fp
    lay["pbits"] = a
    if drop:
        a += align128(n * 16)
    lay["total"] = max(off + 2 * fh, a,
                       off + align128(n * lay["ld_acc"] * 4))
    lay["ws_pf"] = n * lay["ld_ws"]
    lay["ws_macc"] = lay["ws_pf"] + n * n
    lay["ws"] = lay["ws_macc"] + (0 if acc_smem else n * d)
    return lay


def f32_bwd_plan(n_pad: int, n_real: int, d: int, num_heads: int, dh: int,
                 drop: bool = False, l2: bool = False):
    """:func:`f32_search` over ``vfb_rows_f32``'s layouts: ``vfb_plan_f32``
    of csrc/vector_field_bwd.cu in Python. ``chip_smoke.py`` holds it
    against ``vfb_plan_f32``."""
    return f32_search(f32_bwd_layout, n_pad, n_real, d, num_heads, dh, drop,
                      l2)


def kernel_bwd_plan_f32(n_pad: int, n_real: int, d: int, num_heads: int,
                        dh: int, drop: bool = False, l2: bool = False):
    """``vfb_plan_f32`` of the CUDA source (see :func:`f32_bwd_plan`);
    raises if the shape has none."""
    outs = [ctypes.c_int() for _ in range(4)]
    ws = ctypes.c_longlong()
    if _library().vfb_plan_f32(n_pad, n_real, d, num_heads, dh, int(drop),
                               int(l2), *map(ctypes.byref, outs),
                               ctypes.byref(ws)):
        raise ValueError(f"no f32 backward plan for n_pad={n_pad}, D={d}, "
                         f"{num_heads} heads, dh={dh}")
    return (*(o.value for o in outs), ws.value)


def rows_f32_launches() -> int:
    """``vfb_rows_f32``'s launches so far (the library's C counter)."""
    return _library().vfb_rows_f32_launches()


# csrc/split_tf32.cuh: mac::gemm_b16's K slice and its stride, and
# csrc/vector_field_bwd.cu: vfb_rows_bf16's MLP chunks and column blocks,
# in the order its plan tries them
B16_SLICE = 32
B16_LD_SLICE = B16_SLICE + 8
B16_CHUNKS = (64, 32, 16)
B16_STAGES = (4, 3, 2)
B16_BLOCKS = (192, 128, 96, 64, 32, 16)
_SA, _GA = 0, 2                 # A in shared memory / staged
_GB, _GBT = 2, 3                # B staged [K][N] / [N][K]


def tiling_b16(mt: int, nt: int, tr: int, tc: int) -> dict:
    """``mac::tiling_b16``: the warps' tiles of an mt x nt (m16 x n8)
    product: column groups of tc tiles, the rows in as many groups of at
    most tr as the 12 warps allow."""
    cg = -(-nt // tc)
    groups = -(-mt // tr)
    while groups < mt and (groups + 1) * cg <= 12:
        groups += 1
    rpg = -(-mt // groups)
    groups = -(-mt // rpg)
    return {"cg": cg, "rpg": rpg, "groups": groups, "tasks": groups * cg}


def slot_b16(m: int, nw: int, ka: int, kb: int, kb2: int = -1) -> int:
    """``mac::slot_b16``: elements of one ring slot."""
    a = m * B16_LD_SLICE if ka == _GA else 0

    def b(k):
        return (B16_SLICE * (nw + 8) if k == _GB
                else nw * B16_LD_SLICE if k == _GBT else 0)
    return a + b(kb) + (a + b(kb2) if kb2 >= 0 else 0)


def abar_groups(n: int, d: int, nb: int) -> int:
    """``abar_groups``: the most row groups of a_bar's column blocks."""
    g = tiling_b16(n // 16, min(nb, d) // 8, 3, 4)["groups"]
    if d > nb and d % nb:
        g = max(g, tiling_b16(n // 16, (d % nb) // 8, 3, 4)["groups"])
    return g


def bf16_bwd_layout(n_pad: int, d: int, num_heads: int, hc: int, nb: int,
                    cn_smem: int, stages: int, drop: bool = False,
                    l2: bool = False) -> dict:
    """``make_plan_b16`` of csrc/vector_field_bwd.cu: byte offsets of the
    bf16 backward's CTA in its three phases, row strides (elements) and
    ring slots (elements)."""
    n, hd = n_pad, d // num_heads
    ka = _SA if cn_smem else _GA
    lay = {"ld_cn": d + 8, "ld_hd": hd + 8, "ld_s": n + 4, "ld_p": n + 8,
           "ld_hb": hc + 8, "ld_mb": d + 4}
    lay["slot_a"] = max(slot_b16(n, min(nb, 3 * hd), ka, _GB),
                        slot_b16(n, min(nb, hd), ka, _GBT))
    lay["slot_m"] = max(slot_b16(n, min(nb, hc), ka, _GB, _GBT),
                        slot_b16(n, min(nb, d), _SA, _GBT))
    lay["slot_e"] = slot_b16(n, min(nb, d), _GA, _GBT)
    lay["groups_e"] = abar_groups(n, d, nb)
    off = 0
    lay["l2"] = off
    if l2:
        off += 5 * align128(n * 4)
    lay["mean"] = off
    off += align128(n * 4)
    cn = align128(n * lay["ld_cn"] * 2)
    hds = align128(n * lay["ld_hd"] * 2)
    fs = align128(n * lay["ld_s"] * 4)
    a = off
    lay.update(cna=a, gda=a + (cn if cn_smem else 0))
    a += 2 * cn if cn_smem else 0
    lay.update(q=a, k=a + hds, v=a + 2 * hds, cb=a + 3 * hds)
    a += 4 * hds
    lay["st"] = a
    a += fs
    lay["pb"] = a
    a += align128(n * lay["ld_p"] * 2)
    lay["pbits"] = a
    if drop:
        a += align128(n * 16)
    lay.update(ring_a=a, st2=a)         # p_bar while the ring is idle
    a += max(stages * lay["slot_a"] * 2, fs)
    mb = align128(n * lay["ld_mb"] * 4)
    lay["mbar"] = off
    m = off + mb
    lay.update(cnm=m, gd=m + (cn if cn_smem else 0))
    m += 2 * cn if cn_smem else 0
    lay["hb"] = m
    m += align128(n * lay["ld_hb"] * 2)
    lay["ring_m"] = m
    m += stages * lay["slot_m"] * 2
    e = off + mb
    lay["part"] = e
    e += align128(lay["groups_e"] * 4 * d * 4)
    lay["ring_e"] = e
    e += stages * lay["slot_e"] * 2
    lay["attn_end"], lay["mlp_end"], lay["abar_end"] = a, m, e
    lay["total"] = max(a, m, e)
    return lay


def bf16_bwd_plan(n_pad: int, n_real: int, d: int, num_heads: int, dh: int,
                  drop: bool = False, l2: bool = False):
    """``vfb_plan_bf16`` of csrc/vector_field_bwd.cu in Python: (cn and gd
    resident, MLP chunk, column block, ring slots, shared-memory bytes) of
    the first layout within 227 KB, trying cn and gd resident and the most
    slots first, or None. ``chip_smoke.py`` holds it against
    ``vfb_plan_bf16``."""
    if not cta_shape_ok(n_pad, n_real, d, num_heads, dh):
        return None
    for cs in (1, 0):
        for stages in B16_STAGES:
            for hc in B16_CHUNKS:
                if dh % hc:
                    continue
                for nb in B16_BLOCKS:
                    total = bf16_bwd_layout(n_pad, d, num_heads, hc, nb, cs,
                                            stages, drop, l2)["total"]
                    if total <= _MAX_SMEM:
                        return cs, hc, nb, stages, total
    return None


def kernel_bwd_plan_bf16(n_pad: int, n_real: int, d: int, num_heads: int,
                         dh: int, drop: bool = False, l2: bool = False):
    """``vfb_plan_bf16`` of the CUDA source (see :func:`bf16_bwd_plan`);
    raises if the shape has none."""
    outs = [ctypes.c_int() for _ in range(5)]
    if _library().vfb_plan_bf16(n_pad, n_real, d, num_heads, dh, int(drop),
                                int(l2), *map(ctypes.byref, outs)):
        raise ValueError(f"no bf16 backward plan for n_pad={n_pad}, D={d}, "
                         f"{num_heads} heads, dh={dh}")
    return tuple(o.value for o in outs)


def rows_bf16_launches() -> int:
    """``vfb_rows_bf16``'s launches so far (the library's C counter)."""
    return _library().vfb_rows_bf16_launches()


def bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
             dh: int, drop: bool = False, l2: bool = False):
    """``vfb_plan`` of the CUDA source (see :func:`cta_bwd_plan`): the
    route's per-image plan (its dropout instance with ``drop``, its L2
    instance with ``l2``); raises if the shape has none."""
    cn_smem, hc, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().vfb_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                           int(drop), int(l2), ctypes.byref(cn_smem),
                           ctypes.byref(hc),
                           ctypes.byref(smem)):
        raise ValueError(
            f"no one-image-per-CTA backward plan for n_pad={n_pad}, D={d}, "
            f"{num_heads} heads, dh={dh} in {dtype}")
    return cn_smem.value, hc.value, smem.value


def has_bwd_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                 dh: int, drop: bool = False) -> bool:
    """Whether the one-image-per-CTA backward takes this shape (else the
    tiled route runs)."""
    try:
        bwd_plan(dtype, n_pad, n_real, d, num_heads, dh, drop)
    except ValueError:
        return False
    return True


# csrc/vector_field_bwd.cu's weight products: rows of a ring stage of
# vfb_wgrad_wgmma (bf16) and of a slice of vfb_wgrad_tf32 (f32), the fewest
# rows of a slice, and their output tiles (M x N): 128 x 128 or, where it
# pads less, 64 x 192
WB_ROWS = 64
TG_ROWS = 32
WB_MIN_SLICE = 512
WB_TILES = ((128, 128), (64, 192))


def wgrad_tile(m: int, n: int) -> int:
    """Which of :data:`WB_TILES` the weight products (``vfb_wgrad_wgmma``,
    ``vfb_wgrad_tf32``) take for an M x N product: the one whose tiles
    cover it with the fewer padded elements, the first on a tie
    (``wb_kind``)."""
    area = [-(-m // tm) * -(-n // tn) * tm * tn for tm, tn in WB_TILES]
    return 1 if area[1] < area[0] else 0


def wgrad_tiles(m: int, n: int) -> int:
    tm, tn = WB_TILES[wgrad_tile(m, n)]
    return -(-m // tm) * -(-n // tn)


def weight_splits(rows: int, d: int, dh: int, shapes=None, *,
                  dtype: torch.dtype) -> int:
    """Slices of rows the weight products (``shapes``, default all four)
    of ``dtype`` operands are split into; fixed by the shape, so the
    reduction order, and the result, are the same every run.

    ``wgrad_splits`` of csrc/vector_field_bwd.cu, for both kernels: the
    fewest slices whose CTAs, one an SM, fill at least 9/10 of the waves
    they take on 132 SMs, each slice at least 512 rows and none empty
    (where none does, the fullest), in whole steps of the kernel's rows:
    stages of 64 in bf16 (``vfb_wgrad_wgmma``), slices of 32 in f32
    (``vfb_wgrad_tf32``)."""
    shapes = shapes or ((d, 3 * d), (d, d), (d, dh), (dh, d))
    step = WB_ROWS if dtype == torch.bfloat16 else TG_ROWS
    tiles = sum(wgrad_tiles(m, n) for m, n in shapes)
    best, best_fill = 1, (0, 1)
    for s in range(1, max(1, rows // WB_MIN_SLICE) + 1):
        per = -(-(-(-rows // s)) // step) * step
        if (s - 1) * per >= rows:
            continue                    # the last slice would be empty
        ctas = tiles * s
        room = -(-ctas // _SMS) * _SMS
        if 10 * ctas >= 9 * room:
            return s
        if ctas * best_fill[1] > best_fill[0] * room:
            best, best_fill = s, (ctas, room)
    return best


def vf_bwd(x, w: VFWeights, g, *, num_heads: int, scaler: float,
           n_real: int, g_jas=None, jas_idx=None, g_attn=None, seed=None,
           drops=(0.0, 0.0, 0.0), plain: bool = False, resid_qkv=None,
           resid_h1=None, scratch=None):
    """The 9 cotangents of one evaluation (11 with L2 attention; see the
    module docstring), reading the stash's ``resid_qkv`` and ``resid_h1``
    where given. A CUDA tensor launches the kernels; a CPU tensor, or
    ``plain=True``, runs :func:`vf_bwd_plain`. Shapes of the split route
    (``vector_field_bwd_split.split_route``) take it on either device; L2
    never does. A dict ``scratch`` receives, where one image per CTA
    runs, the rows kernel's operands of the weight products ([B n_pad,
    width] in x's dtype: cnm, cna, gd, gd2 (dropout), ctx, h, h1b, qkvb),
    for checks."""
    from odevit_tpu_torch.kernels import vector_field_bwd_split as split
    rkw = dict(resid_qkv=resid_qkv, resid_h1=resid_h1)
    if not w.l2 and split.split_route(x.shape[-1], w.w1.shape[1]):
        return split.vf_bwd_split(
            x, w, g, num_heads=num_heads, scaler=scaler, n_real=n_real,
            g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn, seed=seed,
            drops=drops, plain=plain, **rkw)
    if plain or x.device.type == "cpu":
        return vf_bwd_plain(x, w, g, num_heads=num_heads, scaler=scaler,
                            n_real=n_real, g_jas=g_jas, jas_idx=jas_idx,
                            g_attn=g_attn, seed=seed, drops=drops, **rkw)
    _check_bwd(x, w, g, num_heads, n_real, g_jas, jas_idx, g_attn)
    _check_launch(x, w)
    drop = drop_spec(seed, drops)
    check_operands(x, g=(g, x.dtype), g_jas=(g_jas, torch.float32),
                   jas_idx=(jas_idx, torch.int32), g_attn=(g_attn, x.dtype))
    _check_l2_drop(w, drops)
    resid = check_resid(x, w, drops, resid_qkv, resid_h1)
    b, n, d = x.shape
    dh = w.w1.shape[1]
    rows = b * n
    splits = weight_splits(rows, d, dh, dtype=x.dtype)
    if w.l2 and l2_route(x.dtype, n, n_real, d, num_heads, dh,
                         bwd=True) == "tiled":
        xbar, out = tiled_backward(
            x, w, g, num_heads=num_heads, scaler=scaler, n_real=n_real,
            splits=splits, g_jas=g_jas, jas_idx=jas_idx)
        count_tiled("vf_bwd_l2_tiled", n)
        return _split_bars(xbar, out, d, dh)
    if not w.l2 and (g_attn is not None or not has_bwd_plan(
            x.dtype, n, n_real, d, num_heads, dh, drop is not None)):
        xbar, out = tiled_backward(
            x, w, g, num_heads=num_heads, scaler=scaler, n_real=n_real,
            splits=splits, g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn,
            drop=drop, rqkv=resid_qkv, rh1=resid_h1)
        count_tiled("vf_bwd_resid_tiled" if resid
                    else "vf_bwd_tiled" if drop is None
                    else "vf_bwd_tiled_drop", n)
        return _split_bars(xbar, out, d, dh)
    wtotal = 4 * d * d + 2 * d * dh
    nlen = (8 if w.l2 else 4) * d      # the norms' (and biases') sums

    def rows_of(width):
        return torch.empty(rows, width, device=x.device, dtype=x.dtype)

    bufs = {"xbar": torch.empty_like(x), "cnm": rows_of(d),
            "cna": rows_of(d), "gd": rows_of(d),
            "gd2": rows_of(d) if drop is not None else None,
            "ctx": rows_of(d),
            "h": rows_of(dh), "h1b": rows_of(dh), "qkvb": rows_of(3 * d),
            # f32: vfb_rows_f32's workspace
            "ws": (torch.empty(b * kernel_bwd_plan_f32(
                n, n_real, d, num_heads, dh, drop is not None, w.l2)[4],
                device=x.device) if x.dtype == torch.float32 else None),
            "npart": torch.empty(b, nlen, device=x.device),
            "wpart": torch.empty(splits, wtotal, device=x.device),
            "out": torch.empty(wtotal + nlen, device=x.device),
            "qkv_bias": w.qkv_bias, "out_bias": w.out_bias,
            "rqkv": resid_qkv, "rh1": resid_h1}
    args = _Args(
        x=x.data_ptr(), g=g.data_ptr(),
        g_jas=g_jas.data_ptr() if g_jas is not None else None,
        jas_idx=jas_idx.data_ptr() if jas_idx is not None else None,
        ga=w.norm_attn_scale.data_ptr(), ba=w.norm_attn_bias.data_ptr(),
        gm=w.norm_mlp_scale.data_ptr(), bm=w.norm_mlp_bias.data_ptr(),
        wqkv=w.wqkv.data_ptr(), wout=w.wout.data_ptr(),
        w1=w.w1.data_ptr(), w2=w.w2.data_ptr(),
        **{name: t.data_ptr() if t is not None else None
           for name, t in bufs.items()},
        batch=b, n_pad=n, n_real=n_real, d=d, heads=num_heads, dh=dh,
        splits=splits, scaler=scaler,
        qk_scale=(d // num_heads) ** -0.5, drop=drop or Drop())
    err = _library().vfb_launch(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("vector-field backward launch failed: "
                           + _library().vfb_error_string(err).decode())
    count_launch("vf_bwd_l2" if w.l2 else "vf_bwd_resid" if resid
                 else "vf_bwd" if drop is None else "vf_bwd_drop")
    if scratch is not None:
        scratch.update({k: bufs[k] for k in ("cnm", "cna", "gd", "gd2",
                                             "ctx", "h", "h1b", "qkvb")})
    return _split_bars(bufs["xbar"], bufs["out"], d, dh)


def _split_bars(xbar, out, d: int, dh: int):
    """x_bar and the flat [Wqkv, Wout, W1, W2, ga, ba, gm, bm(, qkv_bias,
    out_bias)] buffer -> the 9 (11) cotangents in the order of the module
    docstring."""
    sizes = [3 * d * d, d * d, d * dh, dh * d, d, d, d, d]
    if out.numel() > sum(sizes):
        sizes += [3 * d, d]
    wqkv, wout, w1, w2, ga, ba, gm, bm, *biases = torch.split(out, sizes)
    return (xbar, ga, ba, gm, bm, wqkv.view(d, 3 * d), wout.view(d, d),
            w1.view(d, dh), w2.view(dh, d), *biases)
