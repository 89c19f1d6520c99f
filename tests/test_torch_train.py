"""The port's fused free-training step against the JAX package's.

Same weights (``from_jax_params``) and the same numpy-seeded batch go
through ``odevit_tpu.train.fast_steps`` (Pallas kernels in interpret
mode, float32) and ``odevit_tpu_torch.train.fast_steps`` on the CPU
(plain versions of the kernels). Tolerances are those
``tests/test_fast_steps.py`` holds the JAX fused step to against the flax
step: loss rtol 1e-4, grad_norm rtol 1e-2, gradients and updated
parameters atol 5e-5 / rtol 5e-3. Shapes are small (16 px, D=32, 2
heads, 19 tokens) and the grid is rk4 on 4 points: 2 plain steps and one
JaSMin step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.train.fast_steps import (fast_free_forward as jax_forward,
                                         make_fast_free_train_step
                                         as jax_make_step)
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.train.fast_steps import (fast_free_forward,
                                               jasmin_window,
                                               make_fast_free_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

CFG = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           num_eval_steps=4, solver="rk4", register_tokens=2)
LR = 1e-4


def setup(seed=0):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    jm = JaxViTODE(**CFG)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(pixels))["params"]
    tm = ViTODE(**CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    return jm, params, tm, pixels, labels


def assert_tree_close(got_sd, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].detach().numpy(),
                                   want.numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_forward_loss_and_gradients_match_jax():
    jm, params, tm, pixels, labels = setup()
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jax_forward(jm, p, jnp.asarray(pixels),
                              jnp.asarray(labels), jasmin_k=10),
        has_aux=True)(params)
    got, got_aux = fast_free_forward(tm, torch.from_numpy(pixels),
                                     torch.from_numpy(labels), jasmin_k=10)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(got_aux["jasmin_loss"].item(),
                               float(aux["jasmin_loss"]), rtol=1e-4)
    np.testing.assert_allclose(got_aux["logits"].detach().numpy(),
                               np.asarray(aux["logits"]), atol=1e-4,
                               rtol=1e-3)
    assert_tree_close({n: p.grad for n, p in tm.named_parameters()}, grads,
                      atol=5e-5, rtol=5e-3)


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of both packages from the same start; the metrics of
    every step and the parameters after steps 1 and 3."""
    jm, params, tm, pixels, labels = setup(1)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js = jax_state(params, tx)
    jstep = jax_make_step(jm, tx, jasmin_k=10, donate=False)
    ts = create_train_state(tm, make_optimizer(LR))
    tstep = make_fast_free_train_step(tm, jasmin_k=10)
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
def test_train_steps_match_jax(three_steps, steps):
    for i in range(1, steps + 1):
        jmet, tmet = three_steps[i][:2]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["jasmin_loss"]),
                                   float(jmet["jasmin_loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
        assert float(tmet["acc"]) == float(jmet["acc"])
    _, _, step, jparams, tparams = three_steps[steps]
    assert step == steps
    assert_tree_close(tparams, jparams, atol=5e-5, rtol=5e-3)


def test_window_splits_the_grid_as_jax():
    # rk4: 12 steps on 13 points -> 9 plain steps, 3 JaSMin steps (the
    # window of int(0.85 * 13) = 11 evaluations, rounded up to steps)
    assert jasmin_window(13, "rk4") == (9, 3)
    assert jasmin_window(4, "rk4") == (2, 1)
    assert jasmin_window(49, "euler") == (7, 41)


def test_cpu_step_counts_no_launch():
    _, _, tm, pixels, labels = setup(2)
    before = dict(launch_counts)
    ts = create_train_state(tm, make_optimizer(LR))
    ts, met = make_fast_free_train_step(tm, jasmin_k=10)(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)})
    assert np.isfinite(float(met["loss"]))
    assert launch_counts == before


@pytest.mark.parametrize("option", ["mesh", "short_sequence", "schedule"])
def test_routes_not_ported_raise(option):
    _, _, tm, pixels, labels = setup(3)
    if option == "schedule":
        with pytest.raises(NotImplementedError):
            make_optimizer(lambda step: LR)
        return
    if option == "short_sequence":
        # 19 tokens cannot hold the k+1 = 20 extraction passes of k=19:
        # the step takes JAX's map route now, and no longer raises (held
        # against JAX in tests/test_torch_map_route.py)
        loss, _ = fast_free_forward(tm, torch.from_numpy(pixels),
                                    torch.from_numpy(labels), jasmin_k=19)
        assert np.isfinite(loss.item())
        return
    with pytest.raises(NotImplementedError):
        make_fast_free_train_step(tm, mesh=object())
