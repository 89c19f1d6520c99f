"""L2 attention past one CTA (the tiled route's L2 instances) against JAX.

The shape leaves the one-image-per-CTA plan (at most 128 padded tokens)
and stays within the tiled route's (at most 256): 48 px at patch 4 with 2
registers, 147 tokens padded to 160, D=32, 2 heads, dh=64, B=2. On the
CPU the port runs the plain versions, which route as the card does
(``l2_route``); JAX runs its L2 Pallas kernels in interpret mode, which
take every shape:

  * ``vf_eval_plain`` / ``vf_eval_jasmin_plain`` against ``fused_vf_l2`` /
    ``fused_vf_l2_jasmin``;
  * ``vf_bwd_plain``'s 11 cotangents against ``jax.vjp`` of the same
    (with and without the JaSMin statistics' cotangent);
  * one free-training step (Euler on 3 points: two JaSMin evaluations)
    against JAX's ``make_fast_free_train_step``, and ``fast_forward``
    logits against JAX's;
  * the routes: one CTA at <= 128 padded tokens, the tiled route above
    (past 256 too), a raise where a size is not a multiple of 16, and
    never the split backward (L2 weights at D=768,
    dh=3072 take the tiled combined backward; JAX keeps its combined
    kernel for L2).

Tolerances are ``tests/test_torch_l2.py``'s and
``tests/test_torch_l2_step.py``'s: f32 forward and statistics 1e-5, the
11 cotangents 1e-4 (max|got - want| over max|want|); bf16 2 ulps (2^-7)
of the output scale; loss and JaSMin loss rtol 1e-4, grad_norm rtol
1e-2, gradients and parameters atol 5e-5 / rtol 5e-3; logits atol 5e-4 /
rtol 5e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import fused_vf_l2, fused_vf_l2_jasmin
from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.train.fast_steps import make_fast_free_train_step \
    as jax_make_step
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels import vector_field_bwd_split as split
from odevit_tpu_torch.kernels.tiled import tiled_plan_rule
from odevit_tpu_torch.kernels.vector_field import (VFWeights, l2_route,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd, vf_bwd_plain
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.train.fast_steps import make_fast_free_train_step
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

B, N, N_PAD, D, H, DH = 2, 147, 160, 32, 2, 64
SCALER = 4.0
JAS_K = 10
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2", "qkv_bias", "out_bias")
CFG = dict(img_size=48, patch_size=4, embed_dim=D, num_heads=H,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           num_eval_steps=3, solver="euler", register_tokens=2,
           l2_attention=True)
LR = 1e-4


def make_case(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D), f(D, D),
         f(D, DH), f(DH, D), f(3 * D) * 0.5, f(D) * 0.5]
    return rng.standard_normal((B, N, D)).astype(np.float32), w


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:8]),
                     qkv_bias=t(w[8], torch.float32),
                     out_bias=t(w[9], torch.float32))


def pad(a):
    return np.concatenate([a, np.zeros((B, N_PAD - N) + a.shape[2:],
                                       a.dtype)], axis=1)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


KW = dict(num_heads=H, scaler=SCALER, n_real=N)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_l2_tiled_forward_matches_pallas(dtype, tol):
    x, w = make_case(1)
    assert l2_route(dtype, N_PAD, N, D, H, DH) == "tiled"
    jx = jnp.asarray(x, jdtype(dtype))
    jw = list(map(jnp.asarray, w))
    dx = fused_vf_l2(jx, *jw, H, SCALER, 2, N)
    jdx, jst = fused_vf_l2_jasmin(jx, *jw, H, SCALER, 2, N, JAS_K)
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    got = vf_eval_plain(tx, tw, **KW)
    gdx, gst, idx = vf_eval_jasmin_plain(tx, tw, jas_k=JAS_K, **KW)
    assert got.dtype == dtype and torch.equal(gdx, got)
    assert rel(got[:, :N].float().numpy(), f32(dx)) <= tol
    assert rel(gdx[:, :N].float().numpy(), f32(jdx)) <= tol
    assert rel(gst[..., :N].numpy(), np.asarray(jst)) <= tol
    assert not gst[..., N:].any() and int(idx.max()) < N


@pytest.mark.parametrize("with_jas", [False, True])
def test_l2_tiled_backward_matches_jax_vjp(with_jas):
    x, w = make_case(2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    g_jas = rng.standard_normal((B, H, 5, N_PAD)).astype(np.float32)
    g_jas[..., N:] = 0.0
    args = [jnp.asarray(x)] + list(map(jnp.asarray, w))
    assert l2_route(torch.float32, N_PAD, N, D, H, DH, bwd=True) == "tiled"
    if with_jas:
        _, vjp = jax.vjp(lambda *a: fused_vf_l2_jasmin(
            *a, H, SCALER, 2, N, JAS_K), *args)
        want = vjp((jnp.asarray(g), jnp.asarray(g_jas[..., :N])))
    else:
        _, vjp = jax.vjp(lambda *a: fused_vf_l2(*a, H, SCALER, 2, N), *args)
        want = vjp(jnp.asarray(g))
    tx = torch.from_numpy(pad(x))
    tw = torch_weights(w, torch.float32)
    tkw = {}
    if with_jas:
        _, _, idx = vf_eval_jasmin_plain(tx, tw, jas_k=JAS_K, **KW)
        tkw = dict(g_jas=torch.from_numpy(g_jas), jas_idx=idx)
    got = vf_bwd_plain(tx, tw, torch.from_numpy(pad(g)), **KW, **tkw)
    assert len(got) == len(want) == 11 and not got[0][:, N:].any()
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        err = rel(a.numpy(), f32(b))
        assert err <= 1e-4, (name, err)


def setup(seed, **over):
    """JAX model and params (attention biases drawn nonzero), the port's
    model with them loaded, a batch of 48 px images."""
    cfg = {**CFG, **over}
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((B, 48, 48, 3)).astype(np.float32)
    labels = rng.integers(0, 7, B)
    jm = JaxViTODE(**cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(pixels))["params"])
    attn = params["vf"]["attn"]
    for name in ("q_bias", "k_bias", "v_bias", "out_bias"):
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.1).astype(
            np.float32)
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    assert tm.patch_embed.seq_len == N
    return jm, params, tm, pixels, labels


def assert_tree_close(got_sd, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].detach().numpy(),
                                   want.numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_l2_tiled_train_step_matches_jax():
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
    assert_tree_close({n: p.detach() for n, p in tm.named_parameters()},
                      js.params, atol=5e-5, rtol=5e-3)


def test_l2_tiled_fast_forward_matches_jax():
    jm, params, tm, pixels, _ = setup(1, num_eval_steps=4)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=2)["logits"])
    got = fast_forward(tm, torch.from_numpy(pixels))["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("case", ["cta", "tiled", "past_256",
                                  "never_split"])
def test_l2_routes(case):
    if case == "cta":
        # the CIFAR shape: one image per CTA, forward and backward
        for dtype in (torch.bfloat16, torch.float32):
            assert l2_route(dtype, 80, 69, 192, 3, 768) == "cta"
            assert l2_route(dtype, 80, 69, 192, 3, 768, bwd=True) == "cta"
    elif case == "tiled":
        # past 128 padded tokens: the TS-Base student (207 tokens) and
        # this file's 147; the tiled route's L2 plan takes the largest
        # query tile whose backward CTA fits, as the softmax one's
        for args in ((208, 207, 768, 12, 768), (N_PAD, N, D, H, DH)):
            for dtype in (torch.bfloat16, torch.float32):
                assert l2_route(dtype, *args) == "tiled"
                assert l2_route(dtype, *args, bwd=True) == "tiled"
        assert tiled_plan_rule(torch.bfloat16, 208, 207, 768, 12, 768,
                               l2=True)[0] == 64
        assert tiled_plan_rule(torch.float32, 208, 207, 768, 12, 768,
                               l2=True)[0] == 32
    elif case == "past_256":
        # 64 px at patch 4 (259 tokens padded to 272) and the 384 px
        # TS-Base student (587 tokens padded to 592) take the tiled route,
        # whose attention runs its key-tiled instances on the card
        for args in ((272, 259, 32, 2, 64), (592, 587, 768, 12, 768)):
            for dtype in (torch.bfloat16, torch.float32):
                assert l2_route(dtype, *args) == "tiled"
                assert l2_route(dtype, *args, bwd=True) == "tiled"
        x, w = make_case(4)
        tx = torch.zeros(B, 272, D)
        out = vf_eval_plain(tx, torch_weights(w, torch.float32), num_heads=H,
                            scaler=SCALER, n_real=259)
        assert out.shape == tx.shape and torch.isfinite(out).all()
        # a size that is not a multiple of 16 still has no plan
        with pytest.raises(ValueError, match="multiples of 16"):
            l2_route(torch.bfloat16, 600, 587, 768, 12, 768)
    else:
        # L2 weights at MLP ratio 4 (D=768, dh=3072) keep the combined
        # backward: vf_bwd never asks the split route
        d, dh, heads, n = 768, 3072, 12, 208
        assert split.split_route(d, dh)
        assert l2_route(torch.float32, n, 197, d, heads, dh,
                        bwd=True) == "tiled"
        g = torch.Generator().manual_seed(5)
        r = lambda *s, sc=0.02: torch.randn(*s, generator=g) * sc
        w = VFWeights(1 + r(d), r(d), 1 + r(d), r(d), r(d, 3 * d),
                      r(d, d), r(d, dh), r(dh, d), qkv_bias=r(3 * d),
                      out_bias=r(d))
        x = torch.randn(1, n, d, generator=g)
        gx = r(1, n, d, sc=1.0)

        def no_split(*a, **k):
            raise AssertionError("L2 took the split backward")

        orig = split.vf_bwd_split
        split.vf_bwd_split = no_split
        try:
            bars = vf_bwd(x, w, gx, num_heads=heads, scaler=SCALER,
                          n_real=197)
        finally:
            split.vf_bwd_split = orig
        assert len(bars) == 11 and all(torch.isfinite(b).all() for b in bars)
