"""The split backward's plain twins against the JAX package.

``vf_bwd_mlp_plain`` and ``vf_bwd_attn_plain`` (the port's counterparts of
``_mlp_bwd_kernel`` and ``_attn_bwd_kernel``) and ``vf_bwd_split``, which
chains them, are held against JAX's ``_pallas_vf_bwd_split`` in interpret
mode, as ``tests/test_kernel_bwd.py::test_split_bwd_matches_xla_vjp`` runs
it: D=64, 2 heads, dh=256 in two 128-column chunks, 17 tokens (padded to
32), B=16, tiles (8, 128, 8). Each half's own cotangents are compared
(W1, W2 and the MLP norm's come from the MLP kernel alone; Wqkv, Wout and
the attention norm's from the attention kernel alone), and x_bar; the MLP
half's x_bar term alone against JAX's with the attention norm's scale set
to 0, which removes the attention branch's term from JAX's x_bar.
Cotangents: dx only, with the maps' cotangent, with the JaSMin cotangent
(k=2), and with dropout (seed 1234, rates 0.1).

Dropout. JAX's kernels draw their masks from ``pltpu.prng_*``, which has no
CPU lowering. Inside these tests JAX's two mask functions
(``_mask_2d``, ``_mask_p``, in both of its kernel modules) draw the port's
stream instead: Philox4x32-10 written in ``jax.numpy`` on the kernel's own
traced seed and image index, with JAX's per-site seeds (``_site_seed``).
So JAX's own kernels run with the same bits as the port; the masks are
checked bit for bit against the port's generator first.

The route: ``split_route`` against JAX's dispatch in ``pallas_vf_bwd``
(``auto_block_b`` and ``_split_tiles``) at every shape the repo configures,
and against the port's own rule where the two differ by design. On the
CPU, ``vf_bwd`` at a split shape runs the split twins, and launches
nothing.

The whole distillation step at that shape is in
``tests/test_torch_split_step.py``.

Tolerances (max|got - want| over max|want|): float32 1e-4 (long sums in
another order; the TPU kernel's erf polynomial against exact erf);
bfloat16 2 ulps (2^-7) of the output scale, as
``tests/test_torch_train_kernels.py`` states them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import odevit_tpu.kernels.vector_field as jax_vf
import odevit_tpu.kernels.vector_field_bwd as jax_vfb
from odevit_tpu.kernels.vector_field import (DROP_SITE_P, _site_seed,
                                             auto_block_b, fused_vf_jasmin)
from odevit_tpu.kernels.vector_field_bwd import (_pallas_vf_bwd_split,
                                                 _split_tiles)
import odevit_tpu_torch.kernels.vector_field_bwd as port_vfb
import odevit_tpu_torch.kernels.vector_field_bwd_split as port_split
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.dropout import (PHILOX_KEY_HI, keep_scale,
                                              masks_plain, threshold)
from odevit_tpu_torch.kernels.vector_field import (VFWeights,
                                                   vf_eval_jasmin_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
from odevit_tpu_torch.kernels.vector_field_bwd_split import (
    split_route, vf_bwd_attn_plain, vf_bwd_mlp_plain, vf_bwd_split)

B, N, N_PAD, D, H, DH = 16, 17, 32, 64, 2, 256
TILES = (8, 128, 8)
SCALER = 3.0
K = 2
SEED = 1234
DROPS = (0.1, 0.1, 0.1)            # attn, proj, mlp
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
ATTN = ("norm_attn_scale", "norm_attn_bias", "wqkv", "wout")


# --- the port's mask stream inside JAX's kernels --------------------------

def _mulhilo(a, m: int):
    """(hi, lo) words of a * m for uint32 ``a`` and a constant ``m``, from
    16-bit halves (no product leaves 32 bits)."""
    u32 = jnp.uint32
    a_lo, a_hi = a & u32(0xFFFF), a >> u32(16)
    m_lo, m_hi = u32(m & 0xFFFF), u32(m >> 16)
    p0, p1, p2, p3 = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (p0 >> u32(16)) + (p1 & u32(0xFFFF)) + (p2 & u32(0xFFFF))
    hi = p3 + (p1 >> u32(16)) + (p2 >> u32(16)) + (mid >> u32(16))
    return hi, a * u32(m)


def _philox(c, k0, k1):
    """Philox4x32-10 of uint32 counter words ``c`` under key (k0, k1)."""
    u32 = jnp.uint32
    c = list(c)
    for r in range(10):
        if r:
            k0 = k0 + u32(0x9E3779B9)
            k1 = k1 + u32(0xBB67AE85)
        hi0, lo0 = _mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = _mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _port_keep(rate, seed, site, img0, block_b, rows, cols, n_real):
    """[block_b, rows, cols] keep mask of the port's stream for images
    img0.., zeros on rows and columns >= n_real (the attention maps) or
    rows >= n_real (the others, ``cols`` wide)."""
    u32 = jnp.uint32
    key = jax.lax.bitcast_convert_type(_site_seed(seed, site), u32)
    img = (jax.lax.broadcasted_iota(u32, (block_b, rows, cols), 0)
           + jnp.asarray(img0).astype(u32))
    row = jax.lax.broadcasted_iota(u32, (block_b, rows, cols), 1)
    col = jax.lax.broadcasted_iota(u32, (block_b, rows, cols), 2)
    words = _philox((img, row, col >> u32(2), jnp.zeros_like(col)), key,
                    u32(PHILOX_KEY_HI))
    sel = col & u32(3)
    bits = jnp.where(sel == 0, words[0], jnp.where(
        sel == 1, words[1], jnp.where(sel == 2, words[2], words[3])))
    keep = bits >= u32(threshold(rate))
    keep = keep & (row < u32(n_real))
    return jnp.where(keep, jnp.float32(keep_scale(rate)), jnp.float32(0.0))


def port_stream(monkeypatch, n_real):
    """JAX's ``_mask_2d`` and ``_mask_p``, in both of its kernel modules,
    draw the port's stream for ``n_real`` real tokens."""
    def mask_2d(rate, seed, site, img0, block_b, n_pad, width):
        m = _port_keep(rate, seed, site, img0, block_b, n_pad, width, n_real)
        return m.reshape(block_b * n_pad, width)

    def mask_p(rate, seed, head, img0, block_b, n_pad):
        m = _port_keep(rate, seed, DROP_SITE_P + head, img0, block_b, n_pad,
                       n_pad, n_real)
        col = jax.lax.broadcasted_iota(jnp.int32, m.shape, 2)
        return jnp.where(col < n_real, m, 0.0)

    for module in (jax_vf, jax_vfb):
        monkeypatch.setattr(module, "_mask_2d", mask_2d)
        monkeypatch.setattr(module, "_mask_p", mask_p)


def test_port_stream_in_jax_is_the_ports_generator():
    """The test's Philox in jax.numpy draws the port's bits: every site,
    an image offset, padding 0."""
    drops = (0.1, 0.2, 0.3)
    want = masks_plain(3, N, D, DH, H, SEED, drops, img0=5, device="cpu",
                       n_pad=N_PAD)
    seed = jnp.int32(SEED)
    for i, (site, rate, width) in enumerate(((0, drops[2], DH),
                                             (1, drops[2], D),
                                             (2, drops[1], D))):
        got = _port_keep(rate, seed, site, 5, 3, N_PAD, width, N)
        np.testing.assert_array_equal(np.asarray(got), want[i].numpy())
    for h in range(H):
        got = _port_keep(drops[0], seed, DROP_SITE_P + h, 5, 3, N_PAD, N_PAD,
                         N)
        got = np.where(np.arange(N_PAD) < N, np.asarray(got), 0.0)
        np.testing.assert_array_equal(got, want[3][:, h].numpy())


# --- the halves against _pallas_vf_bwd_split -----------------------------

def make_case(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D) * 0.6,
         f(D, D) * 0.6, f(D, DH) * 0.6, f(DH, D) * 0.3]
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    g_attn = rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.1
    g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32) * 0.1
    return x, w, g, g_attn, g_jas


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:]))


def pad(a, axes=(1,)):
    width = [(0, 0)] * a.ndim
    for ax in axes:
        width[ax] = (0, N_PAD - N)
    return np.pad(a, width)


def rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


_jax_split = jax.jit(_pallas_vf_bwd_split, static_argnames=(
    "tiles", "num_heads", "scaler", "n_real", "attn_drop", "proj_drop",
    "mlp_drop", "jas_k"))


def jax_split(x, w, g, dtype, *, g_attn=None, g_jas=None, stats=None,
              drop=False):
    """JAX's split backward, its 9 cotangents as float32 numpy, by name."""
    jdt = jdtype(dtype)
    kw = dict(seed=SEED, attn_drop=DROPS[0], proj_drop=DROPS[1],
              mlp_drop=DROPS[2]) if drop else {}
    bars = _jax_split(
        jnp.asarray(x, jdt), *map(jnp.asarray, w), jnp.asarray(g, jdt),
        None if g_attn is None else jnp.asarray(g_attn), tiles=TILES,
        num_heads=H, scaler=SCALER, n_real=N,
        g_jas=None if g_jas is None else jnp.asarray(g_jas),
        jas_stats=stats, jas_k=K if g_jas is not None else 0, **kw)
    return {n: np.asarray(b.astype(jnp.float32)) for n, b in zip(NAMES, bars)}


def port_inputs(x, w, g, g_attn, g_jas, dtype, cotangent):
    """The port's (x, w, g, cotangent kwargs), padded to 32 tokens, and
    JAX's cotangent kwargs."""
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    tg = torch.from_numpy(pad(g)).to(dtype)
    if cotangent == "dx":
        return tx, tw, tg, {}, {}
    if cotangent == "map":
        return tx, tw, tg, {"g_attn": torch.from_numpy(
            pad(g_attn, (2, 3))).to(dtype)}, {"g_attn": g_attn}
    _, stats = fused_vf_jasmin(jnp.asarray(x, jdtype(dtype)),
                               *map(jnp.asarray, w), H, SCALER, 8, N, K)
    _, _, idx = vf_eval_jasmin_plain(tx, tw, num_heads=H, scaler=SCALER,
                                     n_real=N, jas_k=K)
    return (tx, tw, tg,
            {"g_jas": torch.from_numpy(pad(g_jas, (3,))), "jas_idx": idx},
            {"g_jas": g_jas, "stats": stats})


@pytest.mark.parametrize("drop", [False, True], ids=["det", "drop"])
@pytest.mark.parametrize("cotangent", ["dx", "map", "jas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_halves_match_jax_split(dtype, cotangent, drop, monkeypatch):
    if drop:
        port_stream(monkeypatch, N)
    x, w, g, g_attn, g_jas = make_case(1)
    tx, tw, tg, ckw, jkw = port_inputs(x, w, g, g_attn, g_jas, dtype,
                                       cotangent)
    want = jax_split(x, w, g, dtype, drop=drop, **jkw)
    dkw = dict(seed=SEED, drops=DROPS) if drop else {}
    tol = TOL[dtype]
    xbar_m, *mlp = vf_bwd_mlp_plain(tx, tw, tg, scaler=SCALER, n_real=N,
                                    **dkw)
    assert xbar_m.dtype == torch.float32
    for name, got in zip(("w1", "w2", "norm_mlp_scale", "norm_mlp_bias"),
                         mlp):
        assert rel(got, want[name]) <= tol, (name, rel(got, want[name]))
    xbar, *attn = vf_bwd_attn_plain(tx, tw, tg, xbar_m, num_heads=H,
                                    scaler=SCALER, n_real=N, **ckw, **dkw)
    assert xbar.dtype == dtype
    assert not xbar[:, N:].any()
    for name, got in zip(("x",) + ATTN, (xbar[:, :N], *attn)):
        assert rel(got, want[name]) <= tol, (name, rel(got, want[name]))
    # the pair, in vf_bwd's order
    bars = vf_bwd_split(tx, tw, tg, num_heads=H, scaler=SCALER, n_real=N,
                        **ckw, **dkw)
    got = dict(zip(NAMES, bars))
    got["x"] = got["x"][:, :N]
    for name in NAMES:
        assert rel(got[name], want[name]) <= tol, (name,
                                                   rel(got[name], want[name]))


@pytest.mark.parametrize("drop", [False, True], ids=["det", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlp_half_xbar_matches_jax(dtype, drop, monkeypatch):
    """The MLP half's x_bar term alone: with the attention norm's scale at
    0 the attention branch adds nothing to JAX's x_bar, which is then its
    MLP kernel's (rounded to the compute dtype)."""
    if drop:
        port_stream(monkeypatch, N)
    x, w, g, _, _ = make_case(2)
    w[0] = np.zeros_like(w[0])
    want = jax_split(x, w, g, dtype, drop=drop)["x"]
    xbar_m = vf_bwd_mlp_plain(
        torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype),
        torch.from_numpy(pad(g)).to(dtype), scaler=SCALER, n_real=N,
        **(dict(seed=SEED, drops=DROPS) if drop else {}))[0]
    assert not xbar_m[:, N:].any()
    assert rel(xbar_m[:, :N].to(dtype), want) <= TOL[dtype]


def test_halves_take_only_their_sites_rates():
    """A half with no dropout of its own equals the deterministic half:
    the MLP half reads the mlp rate only, the attention half attn and
    proj only."""
    x, w, g, _, _ = make_case(3)
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    tg = torch.from_numpy(pad(g))
    kw = dict(scaler=SCALER, n_real=N)
    det = vf_bwd_mlp_plain(tx, tw, tg, **kw)
    other = vf_bwd_mlp_plain(tx, tw, tg, seed=SEED, drops=(0.3, 0.2, 0.0),
                             **kw)
    assert all(torch.equal(a, b) for a, b in zip(det, other))
    xm = det[0]
    det = vf_bwd_attn_plain(tx, tw, tg, xm, num_heads=H, **kw)
    other = vf_bwd_attn_plain(tx, tw, tg, xm, num_heads=H, seed=SEED,
                              drops=(0.0, 0.0, 0.3), **kw)
    assert all(torch.equal(a, b) for a, b in zip(det, other))


# --- the route ---------------------------------------------------------------

def jax_takes_split(b, n, d, dh, heads, *, emit_attn=False, emit_jas=False,
                    has_drop=False, itemsize=2):
    """Whether ``pallas_vf_bwd`` dispatches to ``_pallas_vf_bwd_split``
    (its rule at vector_field_bwd.py:564-573, requested tile 16)."""
    cb = auto_block_b(b, n, d, dh, heads, emit_attn=emit_attn,
                      emit_jas=emit_jas, requested=16, bwd=True,
                      itemsize=itemsize)
    if not (cb == 0 or (cb == 1 and d >= 512)):
        return False
    tiles = _split_tiles(b, n, d, dh, heads, has_attn_bar=emit_attn,
                         has_drop=has_drop, requested=16,
                         emit_jas=emit_jas, itemsize=itemsize)
    return tiles is not None and (cb == 0 or min(tiles[0], tiles[2]) >= 2)


# (B, tokens, D, dh, heads): JAX's headline cell and its 207-token twin,
# the port's TS-Base cells at ratio 1, the CIFAR cells at ratio 4 and 2
AGREE = {"tsbase-r4": (64, 197, 768, 3072, 12),
         "tsbase-r4-207": (64, 207, 768, 3072, 12),
         "tsref-r1": (64, 207, 768, 768, 12),
         "cifar-r4": (1024, 69, 192, 768, 3),
         "cifar-r2": (1024, 69, 192, 384, 3)}
# where JAX's choice follows its TPU's scoped-memory budget
DIFFER = {"d512-r1": (64, 197, 512, 512, 8),
          "d512-r2": (64, 197, 512, 1024, 8),
          "d768-r1-69": (64, 69, 768, 768, 12)}
COTANGENTS = [dict(), dict(emit_jas=True), dict(emit_attn=True),
              dict(emit_jas=True, has_drop=True),
              dict(emit_attn=True, has_drop=True)]


@pytest.mark.parametrize("shape", list(AGREE), ids=list(AGREE))
def test_route_agrees_with_jax(shape):
    b, n, d, dh, heads = AGREE[shape]
    for kw in COTANGENTS:
        assert split_route(d, dh) == jax_takes_split(b, n, d, dh, heads,
                                                     **kw), kw


@pytest.mark.parametrize("shape", list(DIFFER), ids=list(DIFFER))
def test_route_differs_from_jax_by_design(shape):
    b, n, d, dh, heads = DIFFER[shape]
    assert jax_takes_split(b, n, d, dh, heads, emit_jas=True)
    assert not split_route(d, dh)


def test_cpu_vf_bwd_at_a_split_shape_runs_the_twins(monkeypatch):
    """D=512, dh=2048: ``vf_bwd`` on a CPU tensor runs the split twins,
    not ``vf_bwd_plain``, and launches nothing."""
    d, heads, dh, n, n_real = 512, 8, 2048, 32, 17
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.05).astype(np.float32))
    w = VFWeights(f(d) + 1.0, f(d), f(d) + 1.0, f(d), f(d, 3 * d),
                  f(d, d), f(d, dh), f(dh, d))
    x, g = f(2, n, d) * 20, f(2, n, d)
    want = vf_bwd_split(x, w, g, num_heads=heads, scaler=2.0, n_real=n_real)
    calls = []
    real = port_split.vf_bwd_mlp_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("vf_bwd_plain ran at a split shape")

    monkeypatch.setattr(port_split, "vf_bwd_mlp_plain", spy)
    monkeypatch.setattr(port_vfb, "vf_bwd_plain", refuse)
    before = dict(launch_counts)
    got = vf_bwd(x, w, g, num_heads=heads, scaler=2.0, n_real=n_real)
    assert launch_counts == before
    assert calls == [1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
