"""The fused free-training step with dropout against JAX's other dropout
route: ``_xla_dropout_eval`` for every evaluation, JaSMin from the
pre-dropout maps through ``jasmin_map_loss``
(``odevit_tpu/train/fast_steps.py:259-273``). JAX takes it wherever
``auto_block_b(..., emit_attn=True, bwd=True, itemsize)`` is 0, as at f32
for ``experiment_vit_edo.yaml``'s shape; here ``auto_block_b`` is patched
to 0, as ``tests/test_torch_distill_dropout.py`` does for the distillation
step, at the smallest shape that reaches the route.
``tests/test_torch_train_dropout.py`` holds the port against JAX's
in-kernel route; the port has one route for both (dropout drawn in its
kernels, statistics of the pre-dropout p).

JAX's dropout evaluations go through its XLA twin fed the port's masks
(the ``twin_dropout`` fixture), and the port draws JAX's step seeds. f32,
the shapes and tolerances of ``tests/test_torch_train_dropout.py``: loss
rtol 1e-4, grad_norm rtol 1e-2, gradients and updated parameters atol
5e-5 / rtol 5e-3; rk4 on 4 points and Euler on 8 for the forward, 3 rk4
steps of AdamW."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odevit_tpu.kernels.vector_field as jax_vf
import odevit_tpu.train.fast_steps as jax_steps
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.train.fast_steps import (fast_free_forward,
                                               make_fast_free_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

from test_torch_train_dropout import (GRIDS, LR, assert_tree_close,
                                      seeds_of, setup, twin_dropout)


@pytest.fixture
def xla_route(twin_dropout, monkeypatch):
    """JAX's ``_xla_dropout_eval`` route, its calls counted."""
    monkeypatch.setattr(jax_vf, "auto_block_b", lambda *a, **k: 0)
    calls = []
    twin = jax_steps._xla_dropout_eval

    def counted(*args, **kw):
        calls.append(kw["want_attn"])
        return twin(*args, **kw)

    monkeypatch.setattr(jax_steps, "_xla_dropout_eval", counted)
    return calls


@pytest.mark.parametrize("solver", ["rk4", "euler"])
def test_forward_loss_and_gradients_match_jax_xla_route(xla_route, solver):
    jm, params, tm, pixels, labels = setup(solver)
    key = jax.random.PRNGKey(3)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jax_steps.fast_free_forward(
            jm, p, jnp.asarray(pixels), jnp.asarray(labels), jasmin_k=10,
            rng=key), has_aux=True)(params)
    # every evaluation took the route, the JaSMin ones with their maps
    assert len(xla_route) > 0 and any(xla_route)
    assert next(tm.parameters()).dtype == torch.float32
    got, got_aux = fast_free_forward(
        tm, torch.from_numpy(pixels), torch.from_numpy(labels), jasmin_k=10,
        step_seeds=seeds_of(key, GRIDS[solver] - 1))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(got_aux["jasmin_loss"].item(),
                               float(aux["jasmin_loss"]), rtol=1e-4)
    np.testing.assert_allclose(got_aux["logits"].detach().numpy(),
                               np.asarray(aux["logits"]), atol=1e-4,
                               rtol=1e-3)
    assert_tree_close({n: p.grad for n, p in tm.named_parameters()}, grads,
                      atol=5e-5, rtol=5e-3)


@pytest.fixture
def three_xla_steps(xla_route):
    """Three steps of both packages on JAX's xla dropout route, from the
    same start and rng: each step's metrics, and the parameters after
    steps 1 and 3."""
    jm, params, tm, pixels, labels = setup("rk4", 1)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js = jax_state(params, tx)
    jstep = jax_steps.make_fast_free_train_step(jm, tx, jasmin_k=10,
                                                donate=False)
    ts = create_train_state(tm, make_optimizer(LR))
    tstep = make_fast_free_train_step(tm, jasmin_k=10)
    jbatch = {"pixel_values": jnp.asarray(pixels),
              "labels": jnp.asarray(labels)}
    tbatch = {"pixel_values": torch.from_numpy(pixels),
              "labels": torch.from_numpy(labels)}
    runs = {}
    for i in range(1, 4):
        js, jmet = jstep(js, jbatch, jax.random.PRNGKey(5))
        ts, tmet = tstep(ts, tbatch, rng=5)
        runs[i] = (jmet, tmet, ts.step, jax.device_get(js.params),
                   {n: p.detach().clone() for n, p in tm.named_parameters()})
    assert xla_route
    return runs


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_xla_route(three_xla_steps, steps):
    for i in range(1, steps + 1):
        jmet, tmet = three_xla_steps[i][:2]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["jasmin_loss"]),
                                   float(jmet["jasmin_loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
        assert float(tmet["acc"]) == float(jmet["acc"])
    _, _, step, jparams, tparams = three_xla_steps[steps]
    assert step == steps
    assert_tree_close(tparams, jparams, atol=5e-5, rtol=5e-3)
