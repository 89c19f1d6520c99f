"""The port's Macaron slice through its fused paths, against JAX's.

``make_fast_macaron_train_step`` against JAX's ``make_fast_macaron_train_step``
(``fused_macaron``: the Pallas forward and ``pallas_macaron_bwd`` in
interpret mode) over 3 steps from the same perturbed weights and numpy
batch, at float32 and at model dtype bfloat16 (whose states are float32 in
both); ``fast_forward`` on a ``ViTMacaron`` against JAX's ``fast_forward``
(Euler and rk4 on uniform grids: the fused Euler and stage-advance routes;
rk4 on a non-uniform grid: the generic integrator), the float32 promotion
of a bfloat16 model, ``ServingEngine`` over a ``ViTMacaron``, and the
routes that raise. The small config is ``tests/test_torch_macaron.py``'s
(16 px, patch 4, D=32, 2 heads, 17 tokens, rk4 on 4 points, learned IVP).

Tolerances, as ``tests/test_torch_l2_step.py`` holds the L2 step: loss
rtol 1e-4, grad_norm rtol 1e-2, updated parameters atol 5e-5 / rtol 5e-3;
logits atol 5e-4 / rtol 5e-3 at float32. At model dtype bfloat16 the
patch projection and the FFN's rounded operands differ by bf16 ulps
between the two, so the loss takes rtol 1e-2 and the logits 2e-2.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import odevit_tpu.kernels.macaron as jax_macaron
from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.train.fast_steps import (make_fast_macaron_train_step
                                         as jax_make_step)
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.macaron import ViTMacaron
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.serve.engine import ServingEngine
from odevit_tpu_torch.train.fast_steps import make_fast_macaron_train_step
from odevit_tpu_torch.train.state import create_train_state, make_optimizer
from test_torch_macaron import CFG, LOGIT_TOL, jax_model_and_params

LR = 1e-3


def assert_tree_close(got_sd, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].detach().numpy(),
                                   want.numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def three_steps(request):
    bf16 = request.param == "bfloat16"
    jm, params, tm, pixels = jax_model_and_params(
        6, learn_ivp=True, dtype=jnp.bfloat16 if bf16 else None)
    labels = np.random.default_rng(6).integers(0, 7, pixels.shape[0])
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js = jax_state(params, tx)
    jstep = jax_make_step(jm, tx, block_b=4, donate=False)
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
    return request.param, runs


@pytest.mark.parametrize("steps", [1, 3])
def test_macaron_train_steps_match_jax(three_steps, steps):
    dtype, runs = three_steps
    loss_rtol = 1e-4 if dtype == "float32" else 1e-2
    for i in range(1, steps + 1):
        jmet, tmet = runs[i][:2]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=loss_rtol)
        assert float(tmet["jasmin_loss"]) == float(jmet["jasmin_loss"]) == 0
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
        assert float(tmet["acc"]) == float(jmet["acc"])
    _, _, step, jparams, tparams = runs[steps]
    assert step == steps
    if dtype == "float32":
        assert_tree_close(tparams, jparams, atol=5e-5, rtol=5e-3)


@pytest.mark.parametrize("case", ["dropout", "mesh", "no_cta_plan"])
def test_macaron_routes_that_raise(case):
    if case == "dropout":
        # JAX's fused Macaron step asserts it is deterministic
        tm = ViTMacaron(**CFG, mlp_drop=0.1, device="cpu")
        with pytest.raises(ValueError, match="deterministic"):
            make_fast_macaron_train_step(tm)
    elif case == "mesh":
        tm = ViTMacaron(**CFG, device="cpu")
        with pytest.raises(NotImplementedError, match="mesh"):
            make_fast_macaron_train_step(tm, mesh=object())
    else:
        # 64 px at patch 4: 257 tokens (272 padded), beyond one image per
        # CTA: the tiled route, key-tiled past 256 padded tokens
        tm = ViTMacaron(**{**CFG, "img_size": 64}, device="cpu")
        logits = fast_forward(tm, torch.zeros(2, 64, 64, 3))["logits"]
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("route", ["euler", "rk4", "rk4_nonuniform"])
def test_fast_forward_matches_jax(route):
    solver = "euler" if route == "euler" else "rk4"
    jm, params, tm, pixels = jax_model_and_params(
        3, solver=solver, num_eval_steps=5, learn_ivp=True)
    t_grid = (np.array([0.0, 0.1, 0.35, 0.6, 1.0])
              if route == "rk4_nonuniform" else None)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=4, t_grid=t_grid)["logits"])
    before = dict(launch_counts)
    got = fast_forward(tm, torch.from_numpy(pixels), t_grid=t_grid)["logits"]
    assert launch_counts == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_bf16_model_integrates_in_float32(monkeypatch):
    """At dtype bfloat16 with float32 parameters JAX's patch projection
    adds its float32 bias, so its tokens, states and every Macaron kernel
    launch are float32; the port's are too."""
    seen = {"jax": set(), "port": set()}
    real = jax_macaron._pallas_macaron

    def spy(x, *a, **kw):
        seen["jax"].add(str(x.dtype))
        return real(x, *a, **kw)

    monkeypatch.setattr(jax_macaron, "_pallas_macaron", spy)
    import odevit_tpu_torch.models.fast_forward as ff
    real_t = ff.macaron_eval

    def spy_t(x, *a, **kw):
        seen["port"].add(str(x.dtype))
        return real_t(x, *a, **kw)

    monkeypatch.setattr(ff, "macaron_eval", spy_t)
    jm, params, tm, pixels = jax_model_and_params(
        4, dtype=jnp.bfloat16, solver="euler", num_eval_steps=3)
    x16 = jnp.asarray(pixels, jnp.bfloat16)
    want = np.asarray(jax_fast_forward(jm, params, x16, block_b=4)["logits"])
    xt = torch.from_numpy(pixels).to(torch.bfloat16)
    got = fast_forward(tm, xt)["logits"]
    assert seen == {"jax": {"float32"}, "port": {"torch.float32"}}
    assert tm.embed(xt, fused=True).dtype == torch.float32
    assert tm.embed(xt).dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


def test_serving_engine_over_a_macaron_model():
    _, _, tm, pixels = jax_model_and_params(5)
    with ServingEngine(tm, batch_buckets=(1, 4), device="cpu") as engine:
        futs = [engine.submit(pixels[:k]) for k in (1, 3, 4)]
        answers = [f.result(timeout=120) for f in futs]
        stats = engine.stats()
    assert stats["requests"] == 3 and stats["failed_requests"] == 0
    for k, got in zip((1, 3, 4), answers):
        want = fast_forward(tm, torch.from_numpy(pixels[:k]))["logits"]
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
