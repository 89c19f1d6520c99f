"""The split backward of one evaluation: an MLP-branch and an
attention-branch half, chained through x_bar.

Counterparts of the TPU kernels ``odevit_tpu/kernels/vector_field_bwd.py::
_mlp_bwd_kernel`` and ``_attn_bwd_kernel``, which JAX's
``_pallas_vf_bwd_split`` chains where its combined backward is pinned to
one image (TS-Base at MLP ratio 4: D=768, dh=3072). ``vf_bwd_mlp`` and
``vf_bwd_attn`` launch the kernels of ``csrc/vector_field_bwd_split.cu``
on a CUDA tensor and run their plain PyTorch twins, ``vf_bwd_mlp_plain``
and ``vf_bwd_attn_plain``, on a CPU tensor:

  * ``vf_bwd_mlp(x, w, g, scaler=, n_real=)`` -> (xbar_m [B, n_pad, D]
    f32, W1_bar [D, dh], W2_bar [dh, D], gm_bar [D], bm_bar [D]): the MLP
    branch's cotangents and its term of x_bar (CenterNorm's backward is
    linear in the branches' cotangents, so the two terms add);
  * ``vf_bwd_attn(x, w, g, xbar_m, num_heads=, scaler=, n_real=)`` ->
    (x_bar in x's dtype, ga_bar, ba_bar, Wqkv_bar [D, 3D], Wout_bar [D,
    D]): the attention branch's, with x_bar = xbar_m plus its own term,
    rounded once. It takes the JaSMin cotangent (``g_jas``, ``jas_idx``)
    and the maps' cotangent (``g_attn``) as ``vf_bwd`` does.

``vf_bwd_split`` chains the two and returns ``vf_bwd``'s 9 cotangents in
its order; ``vf_bwd`` takes this route where :func:`split_route` says so.
Rows >= n_real of x and g read as zeros, and x_bar's are zeros.

Dropout: ``seed`` and ``drops`` = (attn, proj, mlp) as the forward took
them. The MLP half draws mask_h and mask_mo (sites H and MLP_OUT, rate
mlp), the attention half mask_ao and mask_p (sites ATTN_OUT and P + head),
from the stream of ``kernels/dropout.py``, so the bits are those of every
other route. A half whose rates are 0 runs its deterministic instance.

Residuals (the TPU kernels' ``has_resid``): the MLP half takes the
stash's ``resid_h1`` and reads h1 from it instead of the cn_m W1 product;
the attention half takes ``resid_qkv`` and reads q, k and v from it
(cn_a is still computed, for Wqkv_bar). Softmax, no dropout. On the GPU
they launch the halves' resid instances, counted as ``vf_bwd_mlp_resid``
and ``vf_bwd_attn_resid``; ``vf_bwd_split`` counts every chained backward.

Launch counts: ``vf_bwd_mlp`` and ``vf_bwd_attn`` (``..._drop`` for the
dropout instances), one per launch of a half, and ``vf_bwd_split`` (or
``vf_bwd_split_drop``) once per chained backward on the GPU.
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import count_launch, count_tiled
from odevit_tpu_torch.kernels.dropout import check_rates, drop_spec, \
    masks_plain
from odevit_tpu_torch.kernels.tiled import _Args, make_args, tiled_plan
from odevit_tpu_torch.kernels.vector_field import VFWeights, _check_launch
from odevit_tpu_torch.kernels.vector_field_bwd import (_check_bwd,
                                                       attn_bars,
                                                       bwd_inputs,
                                                       check_operands,
                                                       check_resid,
                                                       mlp_bars,
                                                       weight_splits)


def split_route(d: int, dh: int) -> bool:
    """Whether ``vf_bwd`` takes the split route: D >= 512 with an MLP ratio
    of at least 4. JAX splits where its combined kernel is pinned to one
    image and the halves tile at two (its TPU's scoped-memory budget);
    this rule agrees with it at every shape the repo configures (split at
    D=768 ratio 4; combined at D=768 ratio 1 and at D=192)."""
    return d >= 512 and dh >= 4 * d


def _mlp_rates(drops):
    return (0.0, 0.0, check_rates(drops)[2])


def _attn_rates(drops):
    attn, proj, _ = check_rates(drops)
    return (attn, proj, 0.0)


def _project(bar, gamma):
    """CenterNorm's backward of one branch: d/(d-1) (c - mean(c)), c = bar
    gamma."""
    d = bar.shape[-1]
    c = bar * gamma
    return (d / (d - 1.0)) * (c - c.mean(-1, keepdim=True))


def vf_bwd_mlp_plain(x, w: VFWeights, g, *, scaler: float, n_real: int,
                     seed=None, drops=(0.0, 0.0, 0.0), resid_h1=None):
    """The MLP half's arithmetic in plain PyTorch (see the module
    docstring), rounding where the TPU kernel rounds."""
    _check_bwd(x, w, g, 1, n_real, None, None)
    check_resid(x, w, _mlp_rates(drops), resid_h1=resid_h1, need=("h1",))
    b, n, d = x.shape
    masks = masks_plain(b, n_real, d, w.w1.shape[1], 1, seed,
                        _mlp_rates(drops), device=x.device, n_pad=n)
    mask_h, mask_mo = masks[:2] if masks else (None, None)
    row, cent, gf = bwd_inputs(x, g, scaler=scaler, n_real=n_real)
    m_bar, w1_bar, w2_bar = mlp_bars(x, w, cent, gf, mask_h, mask_mo,
                                     resid_h1, n_real)
    xbar_m = torch.where(row, _project(m_bar, w.norm_mlp_scale),
                         torch.zeros((), device=x.device))
    return (xbar_m, w1_bar, w2_bar, (m_bar * cent).sum((0, 1)),
            m_bar.sum((0, 1)))


def _check_xbar_m(x, xbar_m):
    if tuple(xbar_m.shape) != tuple(x.shape):
        raise ValueError(f"xbar_m {tuple(xbar_m.shape)} != x "
                         f"{tuple(x.shape)}")
    if xbar_m.dtype != torch.float32 or xbar_m.device != x.device:
        raise TypeError(f"xbar_m is {xbar_m.dtype} on {xbar_m.device}, "
                        f"the kernel takes float32 on {x.device}")


def vf_bwd_attn_plain(x, w: VFWeights, g, xbar_m, *, num_heads: int,
                      scaler: float, n_real: int, g_attn=None, g_jas=None,
                      jas_idx=None, seed=None, drops=(0.0, 0.0, 0.0),
                      resid_qkv=None):
    """The attention half's arithmetic in plain PyTorch (see the module
    docstring), rounding where the TPU kernel rounds."""
    _check_bwd(x, w, g, num_heads, n_real, g_jas, jas_idx, g_attn)
    _check_xbar_m(x, xbar_m)
    check_resid(x, w, _attn_rates(drops), resid_qkv=resid_qkv,
                need=("qkv",))
    b, n, d = x.shape
    masks = masks_plain(b, n_real, d, w.w1.shape[1], num_heads, seed,
                        _attn_rates(drops), device=x.device, n_pad=n)
    mask_ao, mask_p = masks[2:] if masks else (None, None)
    row, cent, gf = bwd_inputs(x, g, scaler=scaler, n_real=n_real)
    a_bar, wqkv_bar, wout_bar = attn_bars(
        x, w, cent, gf, row, num_heads=num_heads, n_real=n_real,
        g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn, mask_ao=mask_ao,
        mask_p=mask_p, resid_qkv=resid_qkv)
    x_bar = torch.where(row, xbar_m + _project(a_bar, w.norm_attn_scale),
                        torch.zeros((), device=x.device))
    return (x_bar.to(x.dtype), (a_bar * cent).sum((0, 1)), a_bar.sum((0, 1)),
            wqkv_bar, wout_bar)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("vector_field_bwd_split")
        for fn in (lib.vfs_mlp, lib.vfs_attn):
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Args),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.vfs_error_string.argtypes = [ctypes.c_int]
        lib.vfs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(fn_name: str, x, w, bufs, *, num_heads: int, scaler: float,
            n_real: int, splits: int, drop, mt: int = 0):
    args = make_args(x, w, bufs, num_heads=num_heads, scaler=scaler,
                     n_real=n_real, mt=mt, splits=splits, drop=drop)
    lib = _library()
    err = getattr(lib, fn_name)(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"split backward launch failed ({fn_name}): "
                           + lib.vfs_error_string(err).decode())


def vf_bwd_mlp(x, w: VFWeights, g, *, scaler: float, n_real: int,
               seed=None, drops=(0.0, 0.0, 0.0), plain: bool = False,
               resid_h1=None):
    """The MLP half (see the module docstring). A CUDA tensor launches the
    kernels; a CPU tensor, or ``plain=True``, runs
    :func:`vf_bwd_mlp_plain`."""
    if plain or x.device.type == "cpu":
        return vf_bwd_mlp_plain(x, w, g, scaler=scaler, n_real=n_real,
                                seed=seed, drops=drops, resid_h1=resid_h1)
    _check_bwd(x, w, g, 1, n_real, None, None)
    _check_launch(x, w)
    check_operands(x, g=(g, x.dtype))
    resid = check_resid(x, w, _mlp_rates(drops), resid_h1=resid_h1,
                        need=("h1",))
    drop = drop_spec(seed, _mlp_rates(drops))
    b, n, d = x.shape
    dh = w.w1.shape[1]
    rows = b * n
    splits = weight_splits(rows, d, dh, ((d, dh), (dh, d)), dtype=x.dtype)
    f32 = lambda *s: torch.empty(*s, device=x.device)
    e = lambda width: torch.empty(rows, width, device=x.device,
                                  dtype=x.dtype)
    bufs = {"g": g, "out": f32(b, n, d), "cna": e(d), "cnm": e(d),
            "mean": f32(rows), "gd": e(d),
            "gd2": e(d) if drop is not None else None, "h": e(dh),
            "h1b": e(dh), "mbar": f32(rows, d), "npart": f32(b, 2, d),
            "wpart": f32(splits, 2 * d * dh),
            "wbars": f32(2 * d * dh + 2 * d), "rh1": resid_h1}
    _launch("vfs_mlp", x, w, bufs, num_heads=1, scaler=scaler,
            n_real=n_real, splits=splits, drop=drop)
    count_launch("vf_bwd_mlp_resid" if resid else "vf_bwd_mlp"
                 if drop is None else "vf_bwd_mlp_drop")
    w1, w2, gm, bm = torch.split(bufs["wbars"], [d * dh, dh * d, d, d])
    return bufs["out"], w1.view(d, dh), w2.view(dh, d), gm, bm


def vf_bwd_attn(x, w: VFWeights, g, xbar_m, *, num_heads: int,
                scaler: float, n_real: int, g_attn=None, g_jas=None,
                jas_idx=None, seed=None, drops=(0.0, 0.0, 0.0),
                plain: bool = False, resid_qkv=None):
    """The attention half (see the module docstring). A CUDA tensor
    launches the kernels; a CPU tensor, or ``plain=True``, runs
    :func:`vf_bwd_attn_plain`."""
    if plain or x.device.type == "cpu":
        return vf_bwd_attn_plain(x, w, g, xbar_m, num_heads=num_heads,
                                 scaler=scaler, n_real=n_real, g_attn=g_attn,
                                 g_jas=g_jas, jas_idx=jas_idx, seed=seed,
                                 drops=drops, resid_qkv=resid_qkv)
    _check_bwd(x, w, g, num_heads, n_real, g_jas, jas_idx, g_attn)
    _check_xbar_m(x, xbar_m)
    _check_launch(x, w)
    check_operands(x, g=(g, x.dtype), xbar_m=(xbar_m, torch.float32),
                   g_attn=(g_attn, x.dtype), g_jas=(g_jas, torch.float32),
                   jas_idx=(jas_idx, torch.int32))
    resid = check_resid(x, w, _attn_rates(drops), resid_qkv=resid_qkv,
                        need=("qkv",))
    drop = drop_spec(seed, _attn_rates(drops))
    b, n, d = x.shape
    rows = b * n
    splits = weight_splits(rows, d, 0, ((d, 3 * d), (d, d)),
                           dtype=x.dtype)
    f32 = lambda *s: torch.empty(*s, device=x.device)
    e = lambda *s: torch.empty(*s, device=x.device, dtype=x.dtype)
    bufs = {"g": g, "g_jas": g_jas, "jas_idx": jas_idx, "g_attn": g_attn,
            "out": torch.empty_like(x), "cna": e(rows, d),
            "cnm": e(rows, d), "ctx": e(rows, d),
            # the stash's rqkv takes the place of the qkv scratch
            "qkv": e(rows, 3 * d) if resid_qkv is None else None,
            "rqkv": resid_qkv,
            "mean": f32(rows), "gd": e(rows, d),
            "gd2": e(rows, d) if drop is not None else None,
            "cb": e(rows, d), "pg": e(b, num_heads, n, n),
            "sbar": e(b, num_heads, n, n), "qkvb": e(rows, 3 * d),
            "abar": f32(rows, d), "mbar": xbar_m, "npart": f32(b, 2, d),
            "wpart": f32(splits, 4 * d * d), "wbars": f32(4 * d * d + 2 * d)}
    # the query-tile rows of the tiled route's attention kernels
    mt = tiled_plan(x.dtype, n, n_real, d, num_heads, w.w1.shape[1],
                    drop is not None)[0]
    _launch("vfs_attn", x, w, bufs, num_heads=num_heads, scaler=scaler,
            n_real=n_real, splits=splits, drop=drop, mt=mt)
    count_tiled("vf_bwd_attn_resid" if resid else "vf_bwd_attn"
                if drop is None else "vf_bwd_attn_drop", n)
    wqkv, wout, ga, ba = torch.split(bufs["wbars"],
                                     [3 * d * d, d * d, d, d])
    return bufs["out"], ga, ba, wqkv.view(d, 3 * d), wout.view(d, d)


def vf_bwd_split(x, w: VFWeights, g, *, num_heads: int, scaler: float,
                 n_real: int, g_jas=None, jas_idx=None, g_attn=None,
                 seed=None, drops=(0.0, 0.0, 0.0), plain: bool = False,
                 resid_qkv=None, resid_h1=None):
    """``vf_bwd``'s 9 cotangents from the two halves: W1, W2 and the MLP
    norm's from the MLP half, Wqkv, Wout and the attention norm's from the
    attention half, x_bar from both; the stash's residuals, a pair, go to
    their halves."""
    check_resid(x, w, drops, resid_qkv, resid_h1)
    xbar_m, w1, w2, gm, bm = vf_bwd_mlp(x, w, g, scaler=scaler,
                                        n_real=n_real, seed=seed,
                                        drops=drops, plain=plain,
                                        resid_h1=resid_h1)
    x_bar, ga, ba, wqkv, wout = vf_bwd_attn(
        x, w, g, xbar_m, num_heads=num_heads, scaler=scaler, n_real=n_real,
        g_attn=g_attn, g_jas=g_jas, jas_idx=jas_idx, seed=seed, drops=drops,
        plain=plain, resid_qkv=resid_qkv)
    if not plain and x.device.type != "cpu":
        count_launch("vf_bwd_split" if drop_spec(seed, drops) is None
                     else "vf_bwd_split_drop")
    return x_bar, ga, ba, gm, bm, wqkv, wout, w1, w2
