"""The Macaron family past one CTA (the tiled route) against JAX.

The shape leaves the one-image-per-CTA plans (at most 128 padded tokens)
and stays within the tiled route's (at most 256): 48 px at patch 4, 145
tokens padded to 160, D=32, 2 heads, dh=64, B=2. On the CPU the port runs
the plain versions, which route as the card does (``macaron_route``); JAX
runs its Pallas kernels in interpret mode, which take this shape (its
backward's ``macaron_bwd_block_b`` is 2 here, so ``pallas_macaron_bwd``
runs its kernel, not the XLA twin's vjp):

  * the route: tiled at 160 padded tokens, forward and backward, in both
    dtypes, and at 272 and 592 (key-tiled attention on the card); a raise
    at 600 (not a multiple of 16);
  * ``macaron_eval_plain`` in its three modes against ``_pallas_macaron``
    and ``_xla_macaron``;
  * ``macaron_bwd_plain``'s 16 cotangents against ``pallas_macaron_bwd``
    and ``jax.vjp`` of ``_xla_macaron``;
  * NaN in the padded rows changes no real row and no cotangent;
  * the slice: ``fast_forward`` (Euler and rk4 on uniform grids) against
    JAX's ``fast_forward``, and 1 and 3 steps of
    ``make_fast_macaron_train_step`` against JAX's, from the same
    perturbed weights (``from_jax_params``) and numpy batch.

Weights are JAX's initialisation plus normal(0, 0.1) noise, as
``tests/test_torch_macaron.py`` perturbs them. Tolerances are that file's
(max|got - want| over max|want|): f32 1e-5 forward, 1e-4 cotangents;
bf16 2^-7 forward, 2^-5 cotangents; logits atol 5e-4 / rtol 5e-3; and
``tests/test_torch_macaron_step.py``'s for the step: loss rtol 1e-4,
grad_norm rtol 1e-2, parameters atol 5e-5 / rtol 5e-3.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.macaron import (_pallas_macaron, _xla_macaron,
                                        pallas_macaron_bwd)
from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.models.macaron import ViTMacaron as JaxViTMacaron
from odevit_tpu.train.fast_steps import (make_fast_macaron_train_step
                                         as jax_make_step)
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.macaron import macaron_eval_plain, macaron_route
from odevit_tpu_torch.kernels.macaron_bwd import BAR_NAMES, macaron_bwd_plain
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.macaron import ViTMacaron
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.train.fast_steps import make_fast_macaron_train_step
from odevit_tpu_torch.train.state import create_train_state, make_optimizer
from test_torch_macaron import (D, DH, H, LOGIT_TOL, SCALER, jax_tensors,
                                jax_vf_tree, perturb, port_weights, rel)
from test_torch_macaron_step import assert_tree_close

B, N, N_PAD = 2, 145, 160
CFG = dict(img_size=48, patch_size=4, embed_dim=D, num_heads=H,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4.0,
           time_interval=1.0, num_eval_steps=3, solver="euler")
# The key bias's gradient is zero in exact arithmetic (softmax is shift
# invariant along a row), so AdamW turns its rounding noise into steps of up
# to lr; at 1e-4 (the rate chip_smoke.py trains at) three of them stay
# within the parameters' atol, at 1e-3 they do not.
LR = 1e-4
KW = dict(num_heads=H, scaler=SCALER, n_real=N)


def inputs(dtype, seed, nan_pad=False):
    """(x [B, N, D] as numpy, the port's padded x [B, N_PAD, D])."""
    x = np.random.default_rng(seed).standard_normal((B, N, D)).astype(
        np.float32)
    xt = torch.zeros(B, N_PAD, D)
    xt[:, :N] = torch.from_numpy(x)
    xt = xt.to(dtype)
    if nan_pad:
        xt[:, N:] = float("nan")
    return x, xt


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_is_tiled_and_raises_past_256(dtype):
    for bwd in (False, True):
        assert macaron_route(dtype, N_PAD, N, D, H, DH, bwd) == "tiled"
        # past 256 padded tokens the tiled route's attention is key-tiled
        assert macaron_route(dtype, 272, 257, D, H, DH, bwd) == "tiled"
        assert macaron_route(dtype, 592, 587, D, H, DH, bwd) == "tiled"
        # a size that is not a multiple of 16 still raises
        with pytest.raises(ValueError, match="multiples of 16"):
            macaron_route(dtype, 600, 587, D, H, DH, bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "euler", "base"])
def test_eval_plain_matches_pallas_and_xla(mode, dtype):
    _, p = jax_vf_tree(17)
    x, xt = inputs(dtype, 18)
    jdt = jdtype(dtype)
    jx = jnp.asarray(x, jdt)
    base = (np.random.default_rng(19).standard_normal(x.shape).astype(
        np.float32) if mode == "base" else None)
    kw = dict(mode=mode, dt=0.25 if mode != "plain" else 0.0)
    if mode == "base":
        bt = torch.zeros_like(xt)
        bt[:, :N] = torch.from_numpy(base).to(dtype)
        kw["base"] = bt
    got = macaron_eval_plain(xt, port_weights(p, dtype), **KW, **kw)
    assert got.dtype == dtype
    got = got[:, :N].float().numpy()
    want = _pallas_macaron(
        jx, *jax_tensors(p), num_heads=H, scaler=SCALER, block_b=B,
        n_real=N, euler_dt=kw["dt"],
        base=None if base is None else jnp.asarray(base, jdt))
    # the twin returns f in x's dtype; its Euler and stage-advance updates
    # are formed here from the rounded inputs
    f = np.asarray(_xla_macaron(jx, *jax_tensors(p), num_heads=H,
                                scaler=SCALER, n_real=N), np.float32)
    xr = np.asarray(jx, np.float32)
    br = 0 if base is None else np.asarray(jnp.asarray(base, jdt), np.float32)
    twin = {"plain": f, "euler": xr + 0.25 * f, "base": br + 0.25 * f}[mode]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert rel(got, np.asarray(want, np.float32)) <= tol
    assert rel(got, twin) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_matches_pallas_and_vjp(dtype):
    _, p = jax_vf_tree(20)
    x, xt = inputs(dtype, 21)
    jdt = jdtype(dtype)
    g = np.random.default_rng(22).standard_normal(x.shape).astype(np.float32)
    gt = torch.zeros_like(xt)
    gt[:, :N] = torch.from_numpy(g).to(dtype)
    got = macaron_bwd_plain(xt, port_weights(p, dtype), gt, **KW)
    assert len(got) == 16 and got[0].dtype == dtype
    tensors = tuple(t.astype(jdt) if i in (6, 8, 10, 12) else t
                    for i, t in enumerate(jax_tensors(p)))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want = pallas_macaron_bwd((jx, *tensors), jg, num_heads=H,
                              scaler=SCALER, n_real=N)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    for name, a, b in zip(BAR_NAMES, got, want):
        a = a[:, :N] if name == "x" else a
        assert rel(a.float().numpy(), np.asarray(b, np.float32)) <= tol, name
    if dtype == torch.float32:
        ref = functools.partial(_xla_macaron, num_heads=H, scaler=SCALER,
                                n_real=N)
        _, vjp = jax.vjp(ref, jx, *jax_tensors(p))
        for name, a, b in zip(BAR_NAMES, got, vjp(jg)):
            a = a[:, :N] if name == "x" else a
            assert rel(a.numpy(), np.asarray(b)) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_padding_stays_inert(dtype):
    _, p = jax_vf_tree(23)
    w = port_weights(p, dtype)
    _, clean = inputs(dtype, 24)
    _, dirty = inputs(dtype, 24, nan_pad=True)
    for mode in ("plain", "euler", "base"):
        extra = dict(dt=0.5, base=clean) if mode == "base" else \
            dict(dt=0.5 if mode == "euler" else 0.0)
        a = macaron_eval_plain(clean, w, mode=mode, **KW, **extra)
        b = macaron_eval_plain(dirty, w, mode=mode, **KW, **extra)
        assert torch.equal(a[:, :N], b[:, :N]), mode
    g = torch.randn(clean.shape, generator=torch.Generator().manual_seed(25))
    g = g.to(dtype)
    for a, b in zip(macaron_bwd_plain(clean, w, g, **KW),
                    macaron_bwd_plain(dirty, w, g, **KW)):
        assert torch.equal(a, b)


def jax_model_and_params(seed, **over):
    cfg = {**CFG, **over}
    jm = JaxViTMacaron(**cfg)
    pixels = np.random.default_rng(seed).standard_normal(
        (B, 48, 48, 3)).astype(np.float32)
    params = perturb(jm.init(jax.random.PRNGKey(seed),
                             jnp.asarray(pixels))["params"], seed + 7)
    tm = ViTMacaron(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm, pixels


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_fast_forward_matches_jax(solver):
    jm, params, tm, pixels = jax_model_and_params(3, solver=solver,
                                                  num_eval_steps=4)
    assert tm.seq_len == N
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=B)["logits"])
    before = dict(launch_counts)
    got = fast_forward(tm, torch.from_numpy(pixels))["logits"]
    assert launch_counts == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (B, 7)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.fixture(scope="module")
def three_steps():
    jm, params, tm, pixels = jax_model_and_params(6)
    labels = np.random.default_rng(6).integers(0, 7, B)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js = jax_state(params, tx)
    jstep = jax_make_step(jm, tx, block_b=B, donate=False)
    ts = create_train_state(tm, make_optimizer(LR))
    tstep = make_fast_macaron_train_step(tm)
    jbatch = {"pixel_values": jnp.asarray(pixels),
              "labels": jnp.asarray(labels)}
    tbatch = {"pixel_values": torch.from_numpy(pixels),
              "labels": torch.from_numpy(labels)}
    runs = {}
    for i in range(1, 4):
        js, jmet = jstep(js, jbatch, jax.random.PRNGKey(0))
        ts, tmet = tstep(ts, tbatch)
        runs[i] = (jmet, tmet, ts.step, jax.device_get(js.params),
                   {n: p.detach().clone() for n, p in tm.named_parameters()})
    return runs


@pytest.mark.parametrize("steps", [1, 3])
def test_macaron_train_steps_match_jax(three_steps, steps):
    for i in range(1, steps + 1):
        jmet, tmet = three_steps[i][:2]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
        assert float(tmet["acc"]) == float(jmet["acc"])
    _, _, step, jparams, tparams = three_steps[steps]
    assert step == steps
    assert_tree_close(tparams, jparams, atol=5e-5, rtol=5e-3)
