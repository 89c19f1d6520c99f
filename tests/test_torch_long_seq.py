"""Sequences past 256 padded tokens (the tiled route's key-tiled
attention) against JAX.

The smallest shape past 256: 64 px at patch 4 with 4 registers, 261
tokens padded to 272, D=32, 2 heads, dh=64, B=2. On the CPU the port runs
the plain versions, which route as the card does (the route is "tiled",
whose attention runs its key-tiled instances on the card); JAX runs its
Pallas kernels in interpret mode, which tile the batch and take any
sequence length:

  * the routes and plans at 272 and 592 padded tokens (the TS-Base
    student at 384 px: 587 tokens), in both dtypes;
  * ``vf_eval_plain`` / ``vf_eval_jasmin_plain`` / ``vf_eval_attn_plain``
    against ``fused_vf`` / ``fused_vf_jasmin`` / ``fused_vf_attn``;
  * ``vf_bwd_plain`` against ``jax.vjp`` of ``fused_vf`` and, with the
    JaSMin cotangent, against ``pallas_vf_bwd``;
  * the L2 plain versions against ``fused_vf_l2`` / ``fused_vf_l2_jasmin``
    and ``jax.vjp`` of the latter;
  * the Macaron plain versions against ``_pallas_macaron`` and
    ``pallas_macaron_bwd``;
  * one deterministic free step (Euler on 3 points, JaSMin k=10) against
    JAX's ``make_fast_free_train_step``, and ``fast_forward`` logits
    against JAX's;
  * the 384 px student's geometry at a narrow width: JAX's parameters
    (577 position rows) through ``from_jax_params``, one Euler step's
    logits against JAX's.

Tolerances are those of the tiled tests (``tests/test_torch_l2_tiled.py``,
``tests/test_torch_distill_kernels.py``,
``tests/test_torch_macaron_tiled.py``), as max|got - want| over
max|want|: f32 forward and statistics 1e-5, cotangents 1e-4; bf16 2^-7
forward (2 ulps of the output scale), 2^-5 Macaron cotangents; the step's
loss and JaSMin loss rtol 1e-4, grad_norm rtol 1e-2, parameters atol
5e-5 / rtol 5e-3; logits atol 5e-4 / rtol 5e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.macaron import _pallas_macaron, pallas_macaron_bwd
from odevit_tpu.kernels.vector_field import (fused_vf, fused_vf_attn,
                                             fused_vf_jasmin, fused_vf_l2,
                                             fused_vf_l2_jasmin)
from odevit_tpu.kernels.vector_field_bwd import pallas_vf_bwd
from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.train.fast_steps import make_fast_free_train_step \
    as jax_make_step
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.macaron import macaron_eval_plain, macaron_route
from odevit_tpu_torch.kernels.macaron_bwd import BAR_NAMES, macaron_bwd_plain
from odevit_tpu_torch.kernels.tiled import key_tiled, tiled_plan_rule
from odevit_tpu_torch.kernels.vector_field import (VFWeights, l2_route,
                                                   vf_eval_attn_plain,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd_plain
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.train.fast_steps import make_fast_free_train_step
from odevit_tpu_torch.train.state import create_train_state, make_optimizer
from test_torch_macaron import jax_tensors, jax_vf_tree, port_weights

B, N, N_PAD, D, H, DH = 2, 261, 272, 32, 2, 64
SCALER = 4.0
JAS_K = 10
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2", "qkv_bias", "out_bias")
CFG = dict(img_size=64, patch_size=4, embed_dim=D, num_heads=H,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           num_eval_steps=3, solver="euler", register_tokens=4)
LR = 1e-4
KW = dict(num_heads=H, scaler=SCALER, n_real=N)


def make_case(seed, l2=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D), f(D, D),
         f(D, DH), f(DH, D)]
    if l2:
        w += [f(3 * D) * 0.5, f(D) * 0.5]
    return rng.standard_normal((B, N, D)).astype(np.float32), w


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    bias = {}
    if len(w) > 8:
        bias = dict(qkv_bias=t(w[8], torch.float32),
                    out_bias=t(w[9], torch.float32))
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:8]), **bias)


def pad(a, n_axis=1):
    shape = list(a.shape)
    shape[n_axis] = N_PAD - N
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=n_axis)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routes_and_plans_past_256(dtype):
    # this file's shape and the 384 px TS-Base student (587 tokens, D=768,
    # 12 heads, MLP ratio 1) take the tiled route, key-tiled attention
    for args in ((N_PAD, N, D, H, DH), (592, 587, 768, 12, 768)):
        assert key_tiled(args[0])
        for bwd in (False, True):
            assert l2_route(dtype, *args, bwd=bwd) == "tiled"
            assert macaron_route(dtype, *args, bwd=bwd) == "tiled"
        for drop in (False, True):
            for l2 in (False, True):
                mt, fwd, bwd, keys = tiled_plan_rule(dtype, *args, drop, l2)
                assert mt in (64, 32, 16) and max(fwd, bwd, keys) <= 232448
    # the key-tiled CTAs' shared memory does not grow with n_pad
    assert tiled_plan_rule(dtype, 592, 587, 768, 12, 768) \
        == tiled_plan_rule(dtype, 1024, 1000, 768, 12, 768)
    assert tiled_plan_rule(dtype, 592, 587, 768, 12, 768)[0] == 64
    assert not key_tiled(256) and tiled_plan_rule(dtype, 256, 250, 768, 12,
                                                  768) is not None
    # sizes that are not multiples of 16 still have no plan
    assert tiled_plan_rule(dtype, 600, 587, 768, 12, 768) is None
    with pytest.raises(ValueError, match="multiples of 16"):
        l2_route(dtype, 600, 587, 768, 12, 768)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_forward_matches_pallas(dtype, tol):
    x, w = make_case(1)
    jx = jnp.asarray(x, jdtype(dtype))
    jw = list(map(jnp.asarray, w))
    dx = fused_vf(jx, *jw, H, SCALER, 2, N)
    jdx, jst = fused_vf_jasmin(jx, *jw, H, SCALER, 2, N, JAS_K)
    adx, amap = fused_vf_attn(jx, *jw, H, SCALER, 2, N)
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    got = vf_eval_plain(tx, tw, **KW)
    gdx, gst, idx = vf_eval_jasmin_plain(tx, tw, jas_k=JAS_K, **KW)
    gadx, gmap = vf_eval_attn_plain(tx, tw, **KW)
    assert got.dtype == dtype and torch.equal(gdx, got)
    assert torch.equal(gadx, got)
    assert rel(got[:, :N].float().numpy(), f32(dx)) <= tol
    assert rel(gdx[:, :N].float().numpy(), f32(jdx)) <= tol
    assert rel(gst[..., :N].numpy(), f32(jst)) <= tol
    assert rel(gmap[:, :, :N, :N].float().numpy(), f32(amap)) <= tol
    assert not gst[..., N:].any() and int(idx.max()) < N
    assert not gmap[:, :, N:].any() and not gmap[..., N:].any()


@pytest.mark.parametrize("with_jas", [False, True])
def test_backward_matches_jax(with_jas):
    x, w = make_case(2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32)
    args = [jnp.asarray(x)] + list(map(jnp.asarray, w))
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    tkw = {}
    if with_jas:
        _, stats = fused_vf_jasmin(*args, H, SCALER, 2, N, JAS_K)
        want = pallas_vf_bwd(*args, jnp.asarray(g), num_heads=H,
                             scaler=SCALER, block_b=2, n_real=N,
                             g_jas=jnp.asarray(g_jas), jas_k=JAS_K,
                             jas_stats=stats)
        _, _, idx = vf_eval_jasmin_plain(tx, tw, jas_k=JAS_K, **KW)
        tkw = dict(g_jas=torch.from_numpy(pad(g_jas, 3)), jas_idx=idx)
    else:
        _, vjp = jax.vjp(lambda *a: fused_vf(*a, H, SCALER, 2, N), *args)
        want = vjp(jnp.asarray(g))
    got = vf_bwd_plain(tx, tw, torch.from_numpy(pad(g)), **KW, **tkw)
    assert len(got) == len(want) == 9 and not got[0][:, N:].any()
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        assert rel(a.numpy(), f32(b)) <= 1e-4, name


def test_l2_matches_jax():
    x, w = make_case(4, l2=True)
    args = [jnp.asarray(x)] + list(map(jnp.asarray, w))
    dx = fused_vf_l2(*args, H, SCALER, 2, N)
    (jdx, jst), vjp = jax.vjp(lambda *a: fused_vf_l2_jasmin(
        *a, H, SCALER, 2, N, JAS_K), *args)
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    got = vf_eval_plain(tx, tw, **KW)
    gdx, gst, idx = vf_eval_jasmin_plain(tx, tw, jas_k=JAS_K, **KW)
    assert rel(got[:, :N].numpy(), f32(dx)) <= 1e-5
    assert rel(gdx[:, :N].numpy(), f32(jdx)) <= 1e-5
    assert rel(gst[..., :N].numpy(), f32(jst)) <= 1e-5
    rng = np.random.default_rng(5)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32)
    want = vjp((jnp.asarray(g), jnp.asarray(g_jas)))
    bars = vf_bwd_plain(tx, tw, torch.from_numpy(pad(g)), **KW,
                        g_jas=torch.from_numpy(pad(g_jas, 3)), jas_idx=idx)
    assert len(bars) == len(want) == 11
    bars = [bars[0][:, :N]] + list(bars[1:])
    for name, a, b in zip(NAMES, bars, want):
        assert rel(a.numpy(), f32(b)) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_macaron_matches_pallas(dtype):
    _, p = jax_vf_tree(6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    jdt = jdtype(dtype)
    w = port_weights(p, dtype)
    xt = torch.from_numpy(pad(x)).to(dtype)
    got = macaron_eval_plain(xt, w, **KW)
    want = _pallas_macaron(jnp.asarray(x, jdt), *jax_tensors(p),
                           num_heads=H, scaler=SCALER, block_b=B, n_real=N)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert rel(got[:, :N].float().numpy(), f32(want)) <= tol
    bars = macaron_bwd_plain(xt, w, torch.from_numpy(pad(g)).to(dtype), **KW)
    tensors = tuple(t.astype(jdt) if i in (6, 8, 10, 12) else t
                    for i, t in enumerate(jax_tensors(p)))
    want = pallas_macaron_bwd((jnp.asarray(x, jdt), *tensors),
                              jnp.asarray(g, jdt), num_heads=H,
                              scaler=SCALER, n_real=N)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    for name, a, b in zip(BAR_NAMES, bars, want):
        a = a[:, :N] if name == "x" else a
        assert rel(a.float().numpy(), f32(b)) <= tol, name


def setup(seed, **over):
    cfg = {**CFG, **over}
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 7, B)
    jm = JaxViTODE(**cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(pixels))["params"])
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    assert tm.patch_embed.seq_len == N
    return jm, params, tm, pixels, labels


def test_free_step_matches_jax():
    jm, params, tm, pixels, labels = setup(0)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js, jmet = jax_make_step(jm, tx, jasmin_k=JAS_K, donate=False)(
        jax_state(params, tx), {"pixel_values": jnp.asarray(pixels),
                                "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    before = dict(launch_counts)
    ts, tmet = make_fast_free_train_step(tm, jasmin_k=JAS_K)(
        create_train_state(tm, make_optimizer(LR)),
        {"pixel_values": torch.from_numpy(pixels),
         "labels": torch.from_numpy(labels)})
    assert launch_counts == before          # the CPU runs the plain version
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmet["jasmin_loss"]),
                               float(jmet["jasmin_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-2)
    want_sd = from_jax_params(jax.device_get(js.params))
    got_sd = {n: p.detach() for n, p in tm.named_parameters()}
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(),
                                   atol=5e-5, rtol=5e-3, err_msg=name)


def test_fast_forward_matches_jax():
    jm, params, tm, pixels, _ = setup(1, num_eval_steps=4)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=2)["logits"])
    got = fast_forward(tm, torch.from_numpy(pixels))["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


def test_student_at_384_px_loads_jax_params():
    # evidence_free_base.yaml's student geometry at 384 px (patch 16, 10
    # registers not in pos_embed: 577 position rows, 587 tokens padded to
    # 592), at a narrow width so that the CPU runs it: JAX's parameters
    # load into the port and one Euler step gives JAX's logits
    cfg = dict(img_size=384, patch_size=16, embed_dim=D, num_heads=H,
               mlp_ratio=1.0, num_classes=7, emulate_depth=12,
               time_interval=1.0, register_tokens=10,
               pos_embed_register_tokens=False, solver="euler",
               num_eval_steps=2)
    pixels = np.random.default_rng(8).standard_normal(
        (1, 384, 384, 3)).astype(np.float32)
    jm = JaxViTODE(**cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(8),
                                    jnp.asarray(pixels))["params"])
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    assert tm.patch_embed.seq_len == 587
    pos = tm.state_dict()["patch_embed.pos_embed"]
    assert tuple(pos.shape) == (1, 577, D)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=1)["logits"])
    got = fast_forward(tm, torch.from_numpy(pixels))["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)
