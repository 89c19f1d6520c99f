"""Dropout masks of the fused evaluation: one counter-based stream.

Counterpart of ``odevit_tpu/kernels/vector_field.py:72-193`` (the sites,
the per-site seed, the keep rule and ``generate_dropout_masks``, whose TPU
kernel is ``_mask_gen_kernel``).

A keep bit is a pure function of (seed, site, image, row, column): it does
not depend on a CTA, a tile or a launch, so the forward kernel, the
backward kernel (both one image per CTA), the generator kernel of
``csrc/dropout_masks.cu`` (any grid) and the plain PyTorch version below
all draw the same bits. The TPU's ``pltpu.prng_*`` bits cannot be
reproduced, so the stream is Philox4x32-10 (Salmon et al., SC'11):

  * key = (site seed as uint32, :data:`PHILOX_KEY_HI`), where the site seed
    is ``seed + 0x9E3779B9 * (site + 1)`` with int32 wraparound, as JAX's
    ``_site_seed``;
  * counter = (image, row, column // 4, 0); output word = column % 4. For
    the attention maps, row is the query and column the key;
  * keep where ``bits >= min(floor(rate * 2^32), 2^32 - 1)``, kept values
    scaled by ``1 / (1 - rate)`` (inverted dropout), as JAX's
    ``_keep_mask``.

Sites: ``DROP_SITE_H`` (gelu(h), rate mlp_drop), ``DROP_SITE_MLP_OUT``
(mlp_o, mlp_drop), ``DROP_SITE_ATTN_OUT`` (attn_o, proj_drop) and
``DROP_SITE_P + head`` (the head's probabilities, attn_drop). Only real
rows and real keys are drawn; padded positions hold 0.

``generate_dropout_masks`` launches the generator kernel on the GPU and
runs :func:`keep_mask_plain` (int64 tensor arithmetic, no product above
2^63) on the CPU or with ``plain=True``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from odevit_tpu_torch.device import resolve_device
from odevit_tpu_torch.kernels import count_launch

DROP_SITE_H, DROP_SITE_MLP_OUT, DROP_SITE_ATTN_OUT, DROP_SITE_P = 0, 1, 2, 3

SEED_GOLD = 0x9E3779B9           # folds a site (or a stage) into a seed
PHILOX_KEY_HI = 0x6F766974       # the key's second word, fixed
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def wrap_int32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v >= 1 << 31 else v


def fold_seed(seed: int, k: int) -> int:
    """``seed + 0x9E3779B9 * (k + 1)`` with int32 wraparound: the seed of
    site ``k`` (JAX's ``_site_seed``) and the evaluation seed of stage
    ``k`` of a solver step (JAX's ``step_seed + GOLD[k]``)."""
    return wrap_int32(int(seed) + SEED_GOLD * (k + 1))


def threshold(rate: float) -> int:
    """Keep where the 32 bits are >= this."""
    return min(int(rate * 4294967296.0), _U32)


def keep_scale(rate: float) -> float:
    """The kept value, 1 / (1 - rate), in float32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def check_rates(drops: Sequence[float]):
    rates = tuple(float(r) for r in drops)
    if len(rates) != 3 or not all(0.0 <= r < 1.0 for r in rates):
        raise ValueError(f"drops must be three rates in [0, 1) "
                         f"(attn, proj, mlp), got {drops!r}")
    return rates


class Drop(ctypes.Structure):
    """One evaluation's dropout as the kernels take it (``vf::Drop``):
    its seed, and per site group the keep threshold (0: no dropout there)
    and the kept value. p: attention maps (attn_drop); ao: attn_o
    (proj_drop); m: gelu(h) and mlp_o (mlp_drop)."""
    _fields_ = [("seed", ctypes.c_uint32), ("th_p", ctypes.c_uint32),
                ("th_ao", ctypes.c_uint32), ("th_m", ctypes.c_uint32),
                ("sc_p", ctypes.c_float), ("sc_ao", ctypes.c_float),
                ("sc_m", ctypes.c_float)]


def _spec(seed: int, rates) -> Drop:
    # a site of rate 0 has threshold 0 and value 1: it keeps everything
    th = [threshold(r) if r > 0.0 else 0 for r in rates]
    sc = [keep_scale(r) if r > 0.0 else 1.0 for r in rates]
    return Drop(int(seed) & _U32, *th, *sc)


def drop_spec(seed: Optional[int], drops: Sequence[float]) -> Optional[Drop]:
    """The kernels' ``Drop`` for (seed, rates), or None for the
    deterministic route: rates of 0 take it whatever the seed, as JAX's
    ``has_seed`` does. Nonzero rates without a seed raise."""
    rates = check_rates(drops)
    if not any(rates):
        return None
    if seed is None:
        raise ValueError("dropout in the fused evaluation needs a seed")
    return _spec(seed, rates)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for ``a`` an int64 tensor in
    [0, 2^32) and ``m`` < 2^32, from m's 16-bit halves: every product stays
    below 2^48."""
    u = a * (m & 0xFFFF)
    t = a * (m >> 16) + (u >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (u & 0xFFFF)


def philox4x32_plain(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words (broadcast
    together); returns the four output words."""
    dev = next((v.device for v in (c0, c1, c2, c3) if torch.is_tensor(v)),
               None)
    c = [torch.as_tensor(v, dtype=torch.int64, device=dev)
         for v in (c0, c1, c2, c3)]
    c = list(torch.broadcast_tensors(*c))
    k0, k1 = k0 & _U32, k1 & _U32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _U32
            k1 = (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c[0], PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def keep_mask_plain(seed: int, site: int, rate: float, batch: int,
                    rows: int, cols: int, *, img0: int = 0, device=None):
    """[batch, rows, cols] float32 keep mask of one site for images
    ``img0 .. img0 + batch - 1``: ``1 / (1 - rate)`` where kept, else 0."""
    dev = resolve_device(device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    words = philox4x32_plain(
        (ar(batch) + img0)[:, None, None], ar(rows)[None, :, None],
        ar(-(-cols // 4))[None, None, :], 0, fold_seed(seed, site),
        PHILOX_KEY_HI)
    bits = torch.stack(words, -1).reshape(batch, rows, -1)[..., :cols]
    keep = bits >= threshold(rate)
    return torch.where(keep, torch.tensor(keep_scale(rate), device=dev),
                       torch.zeros((), device=dev))


class DropoutMasks(NamedTuple):
    """The forward's four keep masks (None where the site's rate is 0):
    mask_h [B, n, dh], mask_mo [B, n, D], mask_ao [B, n, D], mask_p
    [B, H, n, n], float32."""
    mask_h: Optional[torch.Tensor]
    mask_mo: Optional[torch.Tensor]
    mask_ao: Optional[torch.Tensor]
    mask_p: Optional[torch.Tensor]


def masks_plain(b: int, n: int, d: int, dh: int, num_heads: int, seed,
                drops: Sequence[float], *, img0: int = 0, device=None,
                n_pad: Optional[int] = None) -> Optional[DropoutMasks]:
    """The four masks in plain PyTorch, None at a site of rate 0, and None
    in all for the deterministic route (:func:`drop_spec`). With ``n_pad``,
    padded to ``n_pad`` tokens with zeros, as the plain versions of the
    kernels take them."""
    if drop_spec(seed, drops) is None:
        return None
    attn, proj, mlp = check_rates(drops)
    n_pad = n if n_pad is None else n_pad

    def site(s, rate, width, rows=n):
        if rate == 0.0:
            return None
        m = keep_mask_plain(seed, s, rate, b, rows, width, img0=img0,
                            device=device)
        pad = [0, 0, 0, n_pad - rows] if rows == n else [0, n_pad - width]
        return torch.nn.functional.pad(m, pad)

    mask_p = None
    if attn:
        mask_p = torch.stack(
            [torch.nn.functional.pad(
                keep_mask_plain(seed, DROP_SITE_P + h, attn, b, n, n,
                                img0=img0, device=device),
                (0, n_pad - n, 0, n_pad - n)) for h in range(num_heads)], 1)
    return DropoutMasks(site(DROP_SITE_H, mlp, dh),
                        site(DROP_SITE_MLP_OUT, mlp, d),
                        site(DROP_SITE_ATTN_OUT, proj, d), mask_p)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.dm_launch.argtypes = ([p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.POINTER(Drop), p])
    lib.dm_launch.restype = ctypes.c_int
    lib.dm_error_string.argtypes = [ctypes.c_int]
    lib.dm_error_string.restype = ctypes.c_char_p
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from odevit_tpu_torch.kernels import build
        _lib = _bind(build.load("dropout_masks"))
    return _lib


def generate_dropout_masks(b: int, n: int, d: int, dh: int, num_heads: int,
                           seed: int, *, attn_drop: float, proj_drop: float,
                           mlp_drop: float, img0: int = 0, device=None,
                           plain: bool = False):
    """The forward's dropout masks as explicit tensors, cut to the ``n``
    real tokens as JAX's are: (mask_h [B, n, dh], mask_mo [B, n, D],
    mask_ao [B, n, D], mask_p [B, H, n, n]), float32, ``1 / (1 - rate)``
    where kept, else 0; a site of rate 0 is all ones. On a CUDA device one
    launch of the generator kernel writes all four; on the CPU, or with
    ``plain=True``, :func:`keep_mask_plain` draws them."""
    drops = check_rates((attn_drop, proj_drop, mlp_drop))
    dev = resolve_device(device)
    if plain or dev.type == "cpu":
        got = masks_plain(b, n, d, dh, num_heads, seed, drops, img0=img0,
                          device=dev) or (None,) * 4
        shapes = ((b, n, dh), (b, n, d), (b, n, d), (b, num_heads, n, n))
        return tuple(m if m is not None else torch.ones(s, device=dev)
                     for m, s in zip(got, shapes))
    if dev.type != "cuda":
        raise ValueError(f"the generator runs on CUDA or CPU, not {dev}")
    outs = (torch.empty(b, n, dh, device=dev),
            torch.empty(b, n, d, device=dev),
            torch.empty(b, n, d, device=dev),
            torch.empty(b, num_heads, n, n, device=dev))
    err = _library().dm_launch(
        *(o.data_ptr() for o in outs), b, n, d, dh, num_heads, img0,
        ctypes.byref(_spec(seed, drops)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("dropout-mask kernel launch failed: "
                           + _library().dm_error_string(err).decode())
    count_launch("dropout_masks")
    return outs
