"""The tiled route of the fused evaluation and its backward.

``csrc/vector_field_tiled.cu`` runs one evaluation, or one backward, as a
sequence of kernels over all rows of the batch (a CenterNorm pass, tiled
products, an attention kernel per image, head and query tile), for shapes
whose image does not fit the one-image-per-CTA kernels of
``vector_field.cu`` and ``vector_field_bwd.cu`` (the 224 px TS-Base
evaluation: 207 tokens padded to 208, D=768, 12 heads). It replaces the
same TPU kernels, ``_vf_kernel`` (plain, JaSMin, attention-map, Euler and
stage-advance modes) and ``_vf_bwd_kernel``. Past 256 padded tokens
(:func:`key_tiled`; the TS-Base student at 384 px: 587 tokens padded to
592) the route's attention CTAs stream the keys in tiles of 64, so any
n_pad that is a multiple of 16 has a plan; the wrappers count those
launches as ``<name>_kt``. There bf16 softmax runs ``vft_attn_kt_fwd``
(the forward), ``vft_attn_kt_bwd`` and ``vft_attn_keys_kt2`` (the
backward), with scores and accumulators in ``mma.sync`` registers; the f32
and L2 instances run the first key-tiled CTAs. The JaSMin statistics
there take at most 15 extraction passes (k <= 15). The wrappers in
``vector_field.py`` and ``vector_field_bwd.py`` choose the route; this
module binds the library and allocates the scratch the kernels use.

Dropout: a ``dropout.Drop`` (its seed, thresholds and kept values) runs
the dropout instances of every kernel of the route, which draw the masks
of ``kernels/dropout.py`` themselves; the forward then takes an f32
``attn_o`` scratch and the backward a second cotangent operand (``gd2``,
g * scaler * mask_ao beside ``gd``'s mask_mo). None runs the
deterministic instances. With ``emit_masks`` the forward's dropout
instance also writes the four masks it draws (JAX's ``emit_masks``).

L2 attention: weights with biases (``VFWeights.qkv_bias``, ``out_bias``)
run the route's L2 instances, in the plain and JaSMin modes and the
backward (11 cotangents), without dropout, maps or the Euler and
stage-advance modes, as the TPU kernel has them.

Residual stash: ``stash=True`` keeps the forward's qkv scratch (rqkv, one
buffer per evaluation) and has the GELU product's epilogue write rh1, the
rounded pre-GELU hidden; the backward given them (``rqkv``, ``rh1``) skips
the qkv and h1 products and allocates no f32 h1 scratch. Softmax, no
dropout, plain and JaSMin modes, as the TPU kernel's emit_resid.

Plans: :func:`tiled_plan` asks the CUDA library; :func:`tiled_plan_rule`
is the same rule in Python, so that a CPU run routes as the card does
(``chip_smoke.py`` holds the two against each other).
"""

from __future__ import annotations

import ctypes

import torch

from odevit_tpu_torch.kernels import key_tiled
from odevit_tpu_torch.kernels.dropout import Drop

MODES = {"plain": 0, "jasmin": 1, "attn": 2, "euler": 3, "base": 4}

_PTRS = ("x", "base", "g", "g_jas", "jas_idx", "g_attn", "ga", "ba", "gm",
         "bm", "wqkv", "wout", "w1", "w2", "out", "stats", "idx", "pmap",
         "cna", "cnm", "qkv", "h", "ctx", "ao", "mean", "gd", "gd2", "h1",
         "h1b", "cb", "pg", "sbar", "qkvb", "abar", "mbar", "npart", "wpart",
         "wbars", "qkv_bias", "out_bias", "l2cs", "mask_h", "mask_mo",
         "mask_ao", "mask_p", "rqkv", "rh1")
_INTS = ("batch", "n_pad", "n_real", "d", "heads", "dh", "mode", "jas_kk",
         "mt", "splits")


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _PTRS]
                + [(name, ctypes.c_int) for name in _INTS]
                + [("scaler", ctypes.c_float), ("qk_scale", ctypes.c_float),
                   ("dt", ctypes.c_float), ("drop", Drop)])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        lib = build.load("vector_field_tiled")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.vft_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 4
        lib.vft_plan.restype = i
        for fn in (lib.vft_forward, lib.vft_backward):
            fn.argtypes = [i, ctypes.POINTER(_Args), p]
            fn.restype = i
        lib.vft_error_string.argtypes = [i]
        lib.vft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tiled_plan(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
               dh: int, drop: bool = False, l2: bool = False):
    """(query-tile rows, shared-memory bytes of the forward, backward and
    key-tile attention CTAs), of the dropout instances with ``drop``, of
    the L2 instances with ``l2`` (past 256 padded tokens, of the
    key-tiled instances); raises if the shape has no tiled plan (sizes
    that are not multiples of 16)."""
    out = [ctypes.c_int() for _ in range(4)]
    tbytes = torch.empty((), dtype=dtype).element_size()
    if _library().vft_plan(tbytes, n_pad, n_real, d, num_heads, dh,
                           int(drop), int(l2),
                           *(ctypes.byref(o) for o in out)):
        raise ValueError(
            f"no tiled plan for n_pad={n_pad}, D={d}, {num_heads} heads, "
            f"dh={dh} in {dtype}: the tiled kernels need multiples of 16 "
            f"and attention CTAs that fit 227 KB of shared memory")
    return tuple(o.value for o in out)


# csrc/vector_field_tiled.cu: kQTiles, kKeyTile, kMaxJas, kRowVals,
# kBThreads, kLdStg, vf::kMaxSmem (its kMaxCols is kernels.KEY_TILED_FROM)
_Q_TILES = (64, 32, 16)
_KEY_TILE = 64
_MAX_JAS = 16
_ROW_VALS = 6
_B_THREADS = 128
_LD_STG = _KEY_TILE + 8
_MAX_SMEM = 232448


def align128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def shape_rule(n_pad: int, n_real: int, d: int, num_heads: int, dh: int,
               max_cols: int | None = None) -> bool:
    """The kernels' shape rule (``shape_ok``): sizes in multiples of 16,
    with ``max_cols`` at most that many padded tokens."""
    return (num_heads > 0 and d % num_heads == 0 and d % 16 == 0
            and (d // num_heads) % 16 == 0 and dh % 16 == 0
            and n_pad % 16 == 0 and 0 < n_pad
            and (max_cols is None or n_pad <= max_cols)
            and 0 < n_real <= n_pad)


def _attn_smem(n, hd, mt, tb, bwd, drop, l2):
    # attn_plan of csrc/vector_field_tiled.cu
    pad = 16 // tb
    ld_hd, ld_s, ld_p = hd + pad, max(n, hd) + 4, n + pad
    total = (2 * align128(n * ld_hd * tb) + align128(mt * ld_hd * tb)
             + align128(mt * ld_s * 4) + align128(mt * ld_p * tb))
    if bwd:
        total += align128(mt * ld_hd * tb) + align128(mt * ld_s * 4)
        if drop:
            total += align128(mt * 4 * ((n + 127) // 128) * 4)
    if l2:
        total += align128((n + 3 * mt) * 4)
    return total


def _kt_smem(hd, mt, tb, bwd):
    # kt_plan of csrc/vector_field_tiled.cu (the key-tiled attention CTA)
    pad = 16 // tb
    ld_hd, ld_s, ld_p, ld_acc = hd + pad, _KEY_TILE + 4, _KEY_TILE + pad, \
        hd + 4
    total = (align128(mt * ld_hd * tb) + 2 * align128(_KEY_TILE * ld_hd * tb)
             + align128(mt * ld_s * 4) + align128(mt * ld_p * tb)
             + align128(mt * ld_acc * 4)
             + align128((_ROW_VALS * mt + _KEY_TILE) * 4))
    if bwd:
        return (total + align128(mt * ld_hd * tb)
                + align128(mt * ld_s * 4))
    return total + 2 * align128(mt * _MAX_JAS * 4)


def _key_kt_smem(hd, mt, tb):
    # key_kt_plan of csrc/vector_field_tiled.cu
    return (2 * align128(mt * (hd + 16 // tb) * tb)
            + 2 * align128(_KEY_TILE * (hd + 4) * 4)
            + align128(_KEY_TILE * 4))


def _ktb_smem(hd, n_pad, drop):
    # ktb_plan of csrc/vector_field_tiled.cu (vft_attn_kt_bwd, bf16): Q,
    # cb, the staging tiles, a K/V ring of two slots (one where two do not
    # fit), then with dropout the keep bits where they fit
    tile = _KEY_TILE * (hd + 8) * 2
    ring = 2 * tile + _KEY_TILE * _LD_STG * 2
    end = ring + (2 if ring + 4 * tile <= _MAX_SMEM else 1) * 2 * tile
    bits = -(-n_pad // _KEY_TILE) * _B_THREADS * 4
    return end + bits if drop and end + bits <= _MAX_SMEM else end


# kLaneLists: vft_attn_kt_fwd's JaSMin lists at their largest, kMaxJas
# values and columns of two rows for each of its threads
_LANE_LISTS = 2 * 2 * _MAX_JAS * _B_THREADS * 4


def _ktf_smem(hd):
    # ktf_plan of csrc/vector_field_tiled.cu (vft_attn_kt_fwd, bf16): Q,
    # the staging tiles, a K/V ring of two slots (one where two do not fit
    # beside the lists), the lanes' JaSMin lists at kk = kMaxJas (a JaSMin
    # launch takes kk entries, the other modes none); neither n_pad nor
    # dropout changes it
    tile = _KEY_TILE * (hd + 8) * 2
    ring = tile + _KEY_TILE * _LD_STG * 2
    stages = 2 if ring + 4 * tile + _LANE_LISTS <= _MAX_SMEM else 1
    return ring + stages * 2 * tile + _LANE_LISTS


# kKeybSmem: vft_attn_keys_kt2's two slots of four 64-row bf16 tiles
_KEYB_SMEM = 2 * 4 * _KEY_TILE * _LD_STG * 2


def tiled_plan_rule(dtype, n_pad: int, n_real: int, d: int, num_heads: int,
                    dh: int, drop: bool = False, l2: bool = False):
    """``vft_plan``'s answer in Python: the plan :func:`tiled_plan` would
    return, or None where it would raise."""
    if not shape_rule(n_pad, n_real, d, num_heads, dh):
        return None
    tb = torch.empty((), dtype=dtype).element_size()
    hd = d // num_heads
    if key_tiled(n_pad):
        # the bf16 softmax CTAs do not depend on mt
        regs = tb == 2 and not l2
        for mt in _Q_TILES:
            plan = ((mt, _ktf_smem(hd), _ktb_smem(hd, n_pad, drop),
                     _KEYB_SMEM) if regs else
                    (mt, _kt_smem(hd, mt, tb, False),
                     _kt_smem(hd, mt, tb, True), _key_kt_smem(hd, mt, tb)))
            if max(plan[1:]) <= _MAX_SMEM:
                return plan
        return None
    keys = (2 * align128(n_pad * (hd + 16 // tb) * tb)
            + align128(_KEY_TILE * (hd + 4) * 4)
            + (align128(_KEY_TILE * 4) if l2 else 0))
    if keys > _MAX_SMEM:
        return None
    for mt in _Q_TILES:
        bwd = _attn_smem(n_pad, hd, mt, tb, True, drop, l2)
        if bwd <= _MAX_SMEM:
            return (mt, _attn_smem(n_pad, hd, mt, tb, False, drop, l2), bwd,
                    keys)
    return None


def _ptr(t):
    return t.data_ptr() if t is not None else None


def make_args(x, w, bufs, *, num_heads, scaler, n_real, mt, mode="plain",
              jas_kk=0, splits=0, drop=None, dt=0.0) -> _Args:
    """The kernels' ``TiledArgs`` for one call: pointers of x, the weights
    and ``bufs`` (None where absent; the stage base among them), the shape,
    the step ``dt`` and ``drop`` (zeros, the deterministic instances, for
    None)."""
    b, n, d = x.shape
    ptrs = {"ga": w.norm_attn_scale, "ba": w.norm_attn_bias,
            "gm": w.norm_mlp_scale, "bm": w.norm_mlp_bias, "wqkv": w.wqkv,
            "wout": w.wout, "w1": w.w1, "w2": w.w2, "qkv_bias": w.qkv_bias,
            "out_bias": w.out_bias, "x": x, **bufs}
    return _Args(**{k: _ptr(v) for k, v in ptrs.items()},
                 batch=b, n_pad=n, n_real=n_real, d=d, heads=num_heads,
                 dh=w.w1.shape[1], mode=MODES[mode], jas_kk=jas_kk, mt=mt,
                 splits=splits, scaler=scaler,
                 qk_scale=(d // num_heads) ** -0.5, dt=dt,
                 drop=drop or Drop())


def _query_tile(x, w, num_heads: int, n_real: int, drop) -> int:
    """The plan's query-tile rows for this call."""
    b, n, d = x.shape
    return tiled_plan(x.dtype, n, n_real, d, num_heads, w.w1.shape[1],
                      drop is not None, w.l2)[0]


def _run(fn_name: str, x, w, bufs, *, num_heads, scaler, n_real, mode="plain",
         jas_kk=0, splits=0, drop=None, dt=0.0, mt=None):
    if mt is None:
        mt = _query_tile(x, w, num_heads, n_real, drop)
    args = make_args(x, w, bufs, num_heads=num_heads, scaler=scaler,
                     n_real=n_real, mt=mt, mode=mode, jas_kk=jas_kk,
                     splits=splits, drop=drop, dt=dt)
    lib = _library()
    err = getattr(lib, fn_name)(
        x.element_size(), ctypes.byref(args),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled vector-field kernel launch failed "
                           f"({fn_name}): "
                           + lib.vft_error_string(err).decode())


def _scratch(x, dh: int):
    b, n, d = x.shape
    e = lambda w, dt=x.dtype: torch.empty(b * n, w, device=x.device,
                                           dtype=dt)
    return {"cna": e(d), "cnm": e(d), "qkv": e(3 * d), "h": e(dh),
            "ctx": e(d)}


MASKS = ("mask_h", "mask_mo", "mask_ao", "mask_p")


def _drawn(drop: Drop) -> dict:
    """Whether the kernels draw each mask: its site's rate is not 0."""
    return {"mask_h": drop.th_m, "mask_mo": drop.th_m,
            "mask_ao": drop.th_ao, "mask_p": drop.th_p}


def mask_buffers(x, dh: int, num_heads: int, drop: Drop) -> dict:
    """The four masks ``emit_masks`` returns, in JAX's layouts (mask_h
    [B * n_pad, dh], mask_mo and mask_ao [B * n_pad, D], mask_p [B, H,
    n_pad, n_pad], f32): empty where the kernels draw the site, all ones
    where its rate is 0 (the kernels leave those alone)."""
    b, n, d = x.shape
    shapes = {"mask_h": (b * n, dh), "mask_mo": (b * n, d),
              "mask_ao": (b * n, d), "mask_p": (b, num_heads, n, n)}
    drawn = _drawn(drop)
    return {k: (torch.empty if drawn[k] else torch.ones)(
        s, device=x.device) for k, s in shapes.items()}


def forward_buffers(x, w, *, num_heads: int, mode: str = "plain",
                    drop=None, emit_masks: bool = False,
                    stash: bool = False) -> dict:
    """The outputs and scratch of one tiled evaluation, by ``TiledArgs``
    field: with ``drop`` also the f32 ``ao`` [B * n_pad, D], with
    ``emit_masks`` the four masks (:func:`mask_buffers`), and with
    ``stash`` ``rh1`` [B * n_pad, dh] in x's dtype."""
    b, n, d = x.shape
    bufs = _scratch(x, w.w1.shape[1])
    bufs["out"] = torch.empty_like(x)
    if stash:
        bufs["rh1"] = torch.empty(b * n, w.w1.shape[1], device=x.device,
                                  dtype=x.dtype)
    if drop is not None:
        bufs["ao"] = torch.empty(b * n, d, device=x.device)
    if emit_masks:
        bufs.update(mask_buffers(x, w.w1.shape[1], num_heads, drop))
    if mode == "jasmin":
        bufs["stats"] = torch.empty(b, num_heads, 5, n, device=x.device)
        bufs["idx"] = torch.empty(b, num_heads, 4, n, device=x.device,
                                  dtype=torch.int32)
    elif mode == "attn":
        bufs["pmap"] = torch.empty(b, num_heads, n, n, device=x.device,
                                   dtype=x.dtype)
    return bufs


def tiled_forward(x, w, *, num_heads: int, scaler: float, n_real: int,
                  mode: str = "plain", jas_kk: int = 0, drop=None,
                  dt: float = 0.0, base=None, emit_masks: bool = False,
                  stash: bool = False):
    """One evaluation on the tiled route: f(x), and for mode "jasmin" the
    statistics and their columns, for mode "attn" the map ``[B, H, n_pad,
    n_pad]`` (zeros on padded query rows), both of the pre-dropout p; for
    mode "euler" x + dt f(x) and for mode "base" base + dt f(x) instead of
    f(x), summed in f32 and rounded once (these two take no ``drop``); with
    ``emit_masks`` (which needs ``drop``) last the four masks as a tuple,
    and with ``stash`` last (rqkv, rh1). The caller has checked the
    arguments. ``drop``: a ``dropout.Drop`` or None (see the module
    docstring)."""
    if mode == "jasmin" and key_tiled(x.shape[1]) and jas_kk > _MAX_JAS:
        raise ValueError(f"past 256 padded tokens the JaSMin statistics take "
                         f"k <= {_MAX_JAS - 1}, got k={jas_kk - 1}")
    bufs = forward_buffers(x, w, num_heads=num_heads, mode=mode, drop=drop,
                           emit_masks=emit_masks, stash=stash)
    kernel_bufs = dict(bufs, base=base)
    if emit_masks:
        # the kernels write the sites they draw; the others stay ones
        drawn = _drawn(drop)
        kernel_bufs.update({k: bufs[k] if drawn[k] else None for k in MASKS})
    _run("vft_forward", x, w, kernel_bufs, num_heads=num_heads,
         scaler=scaler, n_real=n_real, mode=mode, jas_kk=jas_kk, drop=drop,
         dt=dt)
    extra = {"jasmin": ("stats", "idx"), "attn": ("pmap",)}.get(mode, ())
    out = (bufs["out"], *(bufs[k] for k in extra))
    if stash:
        return out + ((bufs["qkv"], bufs["rh1"]),)
    return out + (tuple(bufs[k] for k in MASKS),) if emit_masks else out


def backward_buffers(x, w, g, *, num_heads: int, splits: int, g_jas=None,
                     jas_idx=None, g_attn=None, drop=None,
                     mt: int = 0, rqkv=None, rh1=None) -> dict:
    """The cotangents and scratch of one tiled backward, by ``TiledArgs``
    field: with ``drop`` also ``gd2``, the second cotangent operand; with
    L2 weights the bias partials (8 D floats an image, not 4 D) and the
    query tiles' column sums ``l2cs`` (``mt``: the plan's query-tile
    rows); with the stash's ``rqkv`` and ``rh1``, those in place of the
    qkv and f32 h1 scratch."""
    b, n, d = x.shape
    dh = w.w1.shape[1]
    rows = b * n
    wtotal = 4 * d * d + 2 * d * dh
    nlen = (8 if w.l2 else 4) * d
    f32 = lambda *s: torch.empty(*s, device=x.device)
    e = lambda *s: torch.empty(*s, device=x.device, dtype=x.dtype)
    bufs = _scratch(x, dh)
    if rqkv is not None:
        bufs["qkv"] = None          # rqkv takes its place
    bufs.update(
        g=g, g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn,
        out=torch.empty_like(x), mean=f32(rows), gd=e(rows, d),
        gd2=e(rows, d) if drop is not None else None,
        h1=f32(rows, dh) if rh1 is None else None, rqkv=rqkv, rh1=rh1,
        h1b=e(rows, dh), cb=e(rows, d), pg=e(b, num_heads, n, n),
        sbar=e(b, num_heads, n, n), qkvb=e(rows, 3 * d), abar=f32(rows, d),
        mbar=f32(rows, d), npart=f32(b, nlen), wpart=f32(splits, wtotal),
        wbars=f32(wtotal + nlen),
        l2cs=f32(b, num_heads, -(-n // mt), n) if w.l2 else None)
    return bufs


def tiled_backward(x, w, g, *, num_heads: int, scaler: float, n_real: int,
                   splits: int, g_jas=None, jas_idx=None, g_attn=None,
                   drop=None, rqkv=None, rh1=None):
    """The 9 cotangents of one evaluation on the tiled route (11 with L2
    weights; see ``vector_field_bwd.py``), with the forward's ``drop``
    (masks drawn again), or reading the stash's ``rqkv`` and ``rh1``. The
    caller has checked the arguments."""
    mt = _query_tile(x, w, num_heads, n_real, drop)
    bufs = backward_buffers(x, w, g, num_heads=num_heads, splits=splits,
                            g_jas=g_jas, jas_idx=jas_idx, g_attn=g_attn,
                            drop=drop, mt=mt, rqkv=rqkv, rh1=rh1)
    _run("vft_backward", x, w, bufs, num_heads=num_heads, scaler=scaler,
         n_real=n_real, splits=splits, drop=drop, mt=mt)
    return bufs["out"], bufs["wbars"]
