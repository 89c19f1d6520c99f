"""Dropout: the port's mask stream, and the dropout modes of the fused
evaluation's plain versions, against the JAX package.

The TPU kernel draws its masks from ``pltpu.prng_*``, whose bits cannot
be reproduced and have no CPU lowering, so the JAX package checks its
dropout by feeding explicit keep masks to its XLA twin
(``_xla_reference(masks=...)``). These tests do the same with the port's
masks: ``vf_eval_plain`` / ``vf_eval_jasmin_plain`` against the twin, and
``vf_bwd_plain`` against ``jax.vjp`` of the twin. The CUDA kernels are held
against these plain versions, bit for bit in their masks, by
``chip_smoke.py``.

Tolerances (max|got - want| over max|want|):
  * float32: 1e-5 forward, 1e-4 backward, as
    ``tests/test_torch_train_kernels.py`` holds the deterministic modes;
  * bfloat16 forward: 2 ulps of bf16 (2^-7) of the output scale: the port
    rounds qkv before slicing the heads (as the Pallas kernel does), the
    twin does not, and a score that moves by that rounding can round p to
    the neighbouring bf16 value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import (DROP_SITE_ATTN_OUT, DROP_SITE_H,
                                             DROP_SITE_MLP_OUT, DROP_SITE_P,
                                             _site_seed, _xla_reference)
from odevit_tpu.losses.jasmin import jasmin_order_stats
from odevit_tpu_torch.kernels import dropout, launch_counts, tiled
from odevit_tpu_torch.kernels.autograd import fused_vf, fused_vf_jasmin
from odevit_tpu_torch.kernels.dropout import (fold_seed,
                                              generate_dropout_masks,
                                              keep_mask_plain, masks_plain,
                                              philox4x32_plain)
from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval,
                                                   vf_eval_attn,
                                                   vf_eval_jasmin,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd, vf_bwd_plain

B, N, N_PAD, D, H, DH = 2, 19, 32, 32, 2, 64
SCALER = 4.0
K = 10
DROPS = (0.1, 0.2, 0.3)            # attn, proj, mlp: a rate per site group
SEED = 1234
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2")
EDGE_SEEDS = [-2 ** 31, -1, 0, 1, 2 ** 31 - 1]


def make_case(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D), f(D, D),
         f(D, DH), f(DH, D)]
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32)
    return x, w, g, g_jas


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:]))


def pad(a, axis=1):
    width = [(0, 0)] * a.ndim
    width[axis] = (0, N_PAD - N)
    return np.pad(a, width)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def port_masks(seed=SEED, drops=DROPS, b=B):
    return generate_dropout_masks(b, N, D, DH, H, seed, attn_drop=drops[0],
                                  proj_drop=drops[1], mlp_drop=drops[2],
                                  device="cpu")


def twin(x, w, masks, dtype):
    """(dx, pre-dropout p) of the JAX package's XLA twin fed the masks."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return _xla_reference(jnp.asarray(x, jdt), *map(jnp.asarray, w),
                          num_heads=H, scaler=SCALER, return_attn=True,
                          masks=tuple(jnp.asarray(m.numpy()) for m in masks))


# --- the stream ----------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_matches_known_answers(counter, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    got = philox4x32_plain(*counter, *key)
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_site_and_stage_seeds_match_jax(seed):
    """fold_seed is JAX's _site_seed (vector_field.py:95-97) and its
    per-stage evaluation seed, step_seed + GOLD[s]
    (train/fast_steps.py:251-252), with int32 wraparound."""
    gold = [jnp.int32(np.uint32((0x9E3779B9 * k) & 0xFFFFFFFF)
                      .astype(np.int32)) for k in range(1, 6)]
    for site in range(6):
        assert fold_seed(seed, site) == int(_site_seed(jnp.int32(seed), site))
    for stage in range(5):
        assert fold_seed(seed, stage) == int(jnp.int32(seed) + gold[stage])
    assert (DROP_SITE_H, DROP_SITE_MLP_OUT, DROP_SITE_ATTN_OUT,
            DROP_SITE_P) == (dropout.DROP_SITE_H, dropout.DROP_SITE_MLP_OUT,
                             dropout.DROP_SITE_ATTN_OUT, dropout.DROP_SITE_P)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_values_and_keep_rate(rate):
    m = keep_mask_plain(7, DROP_SITE_H, rate, 4, 69, 768, device="cpu")
    scale = np.float32(1.0 / (1.0 - rate))
    values = set(np.unique(m.numpy()).tolist())
    assert values == {0.0, float(scale)}
    # 212k draws: the keep rate's standard deviation is below 1.1e-3
    assert abs((m > 0).float().mean().item() - (1.0 - rate)) < 6e-3
    # kept where the 32 bits reach floor(rate 2^32), as JAX's _keep_mask
    assert dropout.threshold(rate) == min(int(rate * 4294967296.0),
                                          0xFFFFFFFF)


@pytest.mark.parametrize("what", ["seed", "site", "head", "image"])
def test_masks_differ_across_seed_site_head_and_image(what):
    base = port_masks()
    if what == "seed":
        other = port_masks(seed=SEED + 1)
        pairs = list(zip(base, other))
    elif what == "site":
        # mask_mo and mask_ao have one shape and one rate here
        a, b = port_masks(drops=(0.1, 0.3, 0.3))[1:3]
        pairs = [(a, b)]
    elif what == "head":
        pairs = [(base[3][:, 0], base[3][:, 1])]
    else:
        pairs = [(m[0], m[1]) for m in base]
    for a, b in pairs:
        assert not torch.equal(a, b)
    # the same seed draws the same masks
    for a, b in zip(base, port_masks()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("start,stop", [(0, 1), (1, 3), (3, 4)])
def test_masks_of_images_drawn_alone_equal_the_batch_slice(start, stop):
    """A keep bit depends on the image's index, not on the launch: the
    masks of images [start, stop) drawn alone are that slice of the whole
    batch's."""
    whole = generate_dropout_masks(4, N, D, DH, H, SEED, attn_drop=0.1,
                                   proj_drop=0.1, mlp_drop=0.1, device="cpu")
    part = generate_dropout_masks(stop - start, N, D, DH, H, SEED,
                                  attn_drop=0.1, proj_drop=0.1, mlp_drop=0.1,
                                  img0=start, device="cpu")
    for a, b in zip(part, whole):
        assert torch.equal(a, b[start:stop])


def test_padded_masks_hold_zeros_and_zero_rates_none():
    m = masks_plain(B, N, D, DH, H, SEED, (0.1, 0.0, 0.2), device="cpu",
                    n_pad=N_PAD)
    assert m.mask_ao is None
    assert not m.mask_h[:, N:].any() and not m.mask_mo[:, N:].any()
    assert not m.mask_p[:, :, N:].any() and not m.mask_p[..., N:].any()
    assert torch.equal(m.mask_p[:, :, :N, :N], port_masks(
        drops=(0.1, 0.0, 0.2))[3])
    # the generator gives a site of rate 0 as ones, as JAX's does
    assert torch.equal(port_masks(drops=(0.1, 0.0, 0.2))[2],
                       torch.ones(B, N, D))


def test_rates_without_a_seed_or_out_of_range_raise():
    x, w, _, _ = make_case()
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    with pytest.raises(ValueError, match="seed"):
        vf_eval(xt, wt, drops=DROPS, **kw)
    with pytest.raises(ValueError, match="rates"):
        vf_eval(xt, wt, seed=1, drops=(0.1, 1.0, 0.0), **kw)
    assert dropout.drop_spec(None, (0.0, 0.0, 0.0)) is None
    assert dropout.drop_spec(5, (0.0, 0.0, 0.0)) is None
    spec = dropout.drop_spec(-1, (0.1, 0.0, 0.5))
    assert (spec.seed, spec.th_ao, spec.sc_ao) == (0xFFFFFFFF, 0, 1.0)
    assert spec.th_p == dropout.threshold(0.1)
    assert spec.sc_m == 2.0


# --- the plain versions against the XLA twin -----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jasmin", [False, True])
def test_forward_with_dropout_matches_the_twin(dtype, jasmin):
    x, w, _, _ = make_case(1)
    masks = port_masks()
    want_dx, want_p = twin(x, w, masks, dtype)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, seed=SEED, drops=DROPS)
    xt, wt = torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    if jasmin:
        dx, st, idx = vf_eval_jasmin_plain(xt, wt, jas_k=K, **kw)
        # the statistics are those of the pre-dropout p
        want_st = jasmin_order_stats(want_p, K)
        assert rel(st[..., :N].numpy(), want_st) <= tol
        assert int(idx.max()) < N
    else:
        dx = vf_eval_plain(xt, wt, **kw)
    assert dx.dtype == dtype
    assert rel(dx[:, :N].float().numpy(),
               np.asarray(want_dx.astype(jnp.float32))) <= tol
    # dropout changed the result
    plain = vf_eval_plain(xt, wt, num_heads=H, scaler=SCALER, n_real=N)
    assert rel(dx[:, :N].float().numpy(), plain[:, :N].float().numpy()) > tol


def jax_vjp(x, w, g, g_jas, masks):
    def f(x, *w):
        dx, p = _xla_reference(x, *w, num_heads=H, scaler=SCALER,
                               return_attn=True,
                               masks=tuple(jnp.asarray(m.numpy())
                                           for m in masks))
        return dx, jasmin_order_stats(p, K)
    _, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, w))
    return [np.asarray(b) for b in vjp((jnp.asarray(g), jnp.asarray(g_jas)))]


@pytest.mark.parametrize("with_jas", [False, True])
def test_backward_with_dropout_matches_the_twins_vjp(with_jas):
    x, w, g, g_jas = make_case(2)
    if not with_jas:
        g_jas = np.zeros_like(g_jas)
    want = jax_vjp(x, w, g, g_jas, port_masks())
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, seed=SEED, drops=DROPS)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    extra = {}
    if with_jas:
        _, _, idx = vf_eval_jasmin_plain(xt, wt, jas_k=K, **kw)
        extra = dict(g_jas=torch.from_numpy(pad(g_jas, 3)), jas_idx=idx)
    got = vf_bwd_plain(xt, wt, torch.from_numpy(pad(g)), **kw, **extra)
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        assert rel(a.numpy(), b) <= 1e-4, (name, rel(a.numpy(), b))
    assert not got[0].isnan().any()


@pytest.mark.parametrize("seed", [None, 99])
def test_zero_rates_are_bit_identical_to_the_deterministic_route(seed):
    x, w, g, g_jas = make_case(3)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    gt = torch.from_numpy(pad(g))
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    zero = dict(seed=seed, drops=(0.0, 0.0, 0.0))
    assert torch.equal(vf_eval_plain(xt, wt, **kw, **zero),
                       vf_eval_plain(xt, wt, **kw))
    for a, b in zip(vf_eval_jasmin_plain(xt, wt, jas_k=K, **kw, **zero),
                    vf_eval_jasmin_plain(xt, wt, jas_k=K, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(vf_bwd_plain(xt, wt, gt, **kw, **zero),
                    vf_bwd_plain(xt, wt, gt, **kw)):
        assert torch.equal(a, b)


def test_padded_rows_reach_nothing_with_dropout():
    x, w, g, g_jas = make_case(4)
    wt = torch_weights(w, torch.float32)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, seed=SEED, drops=DROPS)
    xc, gc = torch.from_numpy(pad(x)), torch.from_numpy(pad(g))
    xd, gd = xc.clone(), gc.clone()
    xd[:, N:N + 3] = float("nan")
    xd[:, N + 3:] = 1e30
    gd[:, N:] = 7.0
    clean, dirty = vf_eval_plain(xc, wt, **kw), vf_eval_plain(xd, wt, **kw)
    assert torch.equal(clean[:, :N], dirty[:, :N])
    for a, b in zip(vf_bwd_plain(xc, wt, gc, **kw),
                    vf_bwd_plain(xd, wt, gd, **kw)):
        assert torch.equal(a, b)


def test_autograd_functions_with_dropout_match_the_plain_backward():
    """FusedVF / FusedVFJasmin with a seed on CPU tensors: the backward
    draws the forward's masks again; gradients equal vf_bwd_plain's with
    the same seed, and no kernel launch is counted."""
    x, w, _, _ = make_case(5)
    wt = torch_weights(w, torch.float32)
    params = [torch.from_numpy(a).requires_grad_(True) for a in w]
    xt = torch.from_numpy(pad(x)).requires_grad_(True)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, drops=DROPS)
    before = dict(launch_counts)
    dx = fused_vf(xt, wt, params, seed=SEED, **kw)
    dxj, st = fused_vf_jasmin(xt, wt, params, jas_k=K, seed=SEED + 1, **kw)
    g = torch.randn(dx.shape, generator=torch.Generator().manual_seed(0))
    gj = torch.randn(st.shape, generator=torch.Generator().manual_seed(1))
    ((dx + dxj) * g).sum().add((st * gj).sum()).backward()
    assert launch_counts == before
    _, _, idx = vf_eval_jasmin(xt.detach(), wt, jas_k=K, seed=SEED + 1, **kw)
    a = vf_bwd_plain(xt.detach(), wt, g, seed=SEED, **kw)
    b = vf_bwd_plain(xt.detach(), wt, g, g_jas=gj, jas_idx=idx,
                     seed=SEED + 1, **kw)
    assert torch.allclose(xt.grad, a[0] + b[0], rtol=1e-5, atol=1e-6)
    for p, ga, gb in zip(params, a[1:], b[1:]):
        assert torch.allclose(p.grad, ga + gb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("where", ["tiled_forward", "tiled_backward",
                                   "map_mode", "map_cotangent"])
def test_unported_dropout_routes_raise(where):
    """The routes that raised on dropout before the tiled route carried it
    now take the seed: the tiled forward and backward hand the ``Drop`` to
    the kernels' struct beside their dropout scratch (the f32 attn_o, the
    second cotangent operand), and the map mode and the map cotangent
    apply the masks (plain versions, against the XLA twin fed the same
    masks and against its vjp)."""
    x, w, g, _ = make_case(6)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    gt = torch.from_numpy(pad(g))
    spec = dropout.drop_spec(SEED, DROPS)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    if where == "tiled_forward":
        bufs = tiled.forward_buffers(xt, wt, num_heads=H, mode="attn",
                                     drop=spec)
        assert bufs["ao"].dtype == torch.float32
        assert tuple(bufs["ao"].shape) == (B * N_PAD, D)
        assert "ao" not in tiled.forward_buffers(xt, wt, num_heads=H)
        args = tiled.make_args(xt, wt, bufs, mt=16, mode="attn", drop=spec,
                               **kw)
        assert args.ao == bufs["ao"].data_ptr() and args.mode == 2
        assert bytes(args.drop) == bytes(spec)
        det = tiled.make_args(xt, wt, bufs, mt=16, **kw)
        assert bytes(det.drop) == bytes(dropout.Drop())
    elif where == "tiled_backward":
        bufs = tiled.backward_buffers(xt, wt, gt, num_heads=H, splits=2,
                                      drop=spec)
        assert bufs["gd2"].shape == bufs["gd"].shape
        assert bufs["gd2"].dtype == xt.dtype
        assert tiled.backward_buffers(xt, wt, gt, num_heads=H,
                                      splits=2)["gd2"] is None
        args = tiled.make_args(xt, wt, bufs, mt=16, splits=2, drop=spec,
                               **kw)
        assert args.gd2 == bufs["gd2"].data_ptr() and args.splits == 2
        assert (args.drop.seed, args.drop.th_p, args.drop.sc_m) == (
            spec.seed, spec.th_p, spec.sc_m)
    elif where == "map_mode":
        want_dx, want_p = twin(x, w, port_masks(), torch.float32)
        dx, p = vf_eval_attn(xt, wt, **kw, seed=SEED, drops=DROPS)
        # the maps are the pre-dropout p
        assert rel(p[:, :, :N, :N].numpy(), want_p) <= 1e-5
        assert rel(dx[:, :N].numpy(), want_dx) <= 1e-5
    else:
        ga = np.random.default_rng(7).standard_normal(
            (B, H, N, N)).astype(np.float32)
        masks = tuple(jnp.asarray(m.numpy()) for m in port_masks())
        _, vjp = jax.vjp(
            lambda *a: _xla_reference(*a, num_heads=H, scaler=SCALER,
                                      return_attn=True, masks=masks),
            jnp.asarray(x), *map(jnp.asarray, w))
        want = vjp((jnp.asarray(g), jnp.asarray(ga)))
        gap = np.zeros((B, H, N_PAD, N_PAD), np.float32)
        gap[:, :, :N, :N] = ga
        got = vf_bwd(xt, wt, gt, **kw, g_attn=torch.from_numpy(gap),
                     seed=SEED, drops=DROPS)
        got = [got[0][:, :N]] + list(got[1:])
        for name, a, b in zip(NAMES, got, want):
            assert rel(a.numpy(), np.asarray(b)) <= 1e-4, name
