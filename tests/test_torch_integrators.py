"""The port's fixed-grid integrators against the JAX package's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.core.integrators import odeint as jax_odeint
from odevit_tpu_torch.core.integrators import (METHOD_STAGES, make_step,
                                               nfe, num_stages, odeint)

A = (np.random.default_rng(0).standard_normal((6, 6)) * 0.5).astype(
    np.float32)


def torch_f(t, y):
    return torch.tanh(y @ torch.from_numpy(A).to(y.dtype)) + t


def jax_f(t, y):
    return jnp.tanh(y @ jnp.asarray(A).astype(y.dtype)) + t


@pytest.mark.parametrize("method", sorted(METHOD_STAGES))
def test_odeint_matches_jax(method):
    y0 = np.random.default_rng(1).standard_normal((3, 6)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 7)
    want, _ = jax_odeint(jax_f, jnp.asarray(y0), jnp.asarray(ts, jnp.float32),
                         method=method)
    got = odeint(torch_f, torch.from_numpy(y0), ts, method=method)
    assert got.shape == (7, 3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    final = odeint(torch_f, torch.from_numpy(y0), ts, method=method,
                   return_states=False)
    assert torch.equal(final, got[-1])


def test_rk4_is_kutta_three_eighths():
    """One step against the 3/8 tableau written out by hand."""
    step = make_step("rk4")
    y = torch.tensor([0.3, -1.2], dtype=torch.float64)
    f = lambda t, y: torch.sin(y) * (1.0 + t)
    h, t = 0.4, 0.1
    k1 = f(t, y)
    k2 = f(t + h / 3, y + h * k1 / 3)
    k3 = f(t + 2 * h / 3, y + h * (-k1 / 3 + k2))
    k4 = f(t + h, y + h * (k1 - k2 + k3))
    want = y + h * (k1 + 3 * k2 + 3 * k3 + k4) / 8
    got = step(f, y, t, h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("method", sorted(METHOD_STAGES))
def test_bf16_state_stays_bf16_and_matches_jax(method):
    y0 = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 5)
    got = odeint(torch_f, torch.from_numpy(y0).to(torch.bfloat16), ts,
                 method=method, return_states=False)
    assert got.dtype == torch.bfloat16
    want, _ = jax_odeint(jax_f, jnp.asarray(y0, jnp.bfloat16),
                         jnp.asarray(ts, jnp.float32), method=method,
                         return_states=False)
    assert want.dtype == jnp.bfloat16
    # same float32 update rounded once per step; tanh may differ by an ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)


def test_each_step_evaluates_f_nfe_times():
    calls = []

    def f(t, y):
        calls.append(t)
        return -y
    for method in sorted(METHOD_STAGES):
        calls.clear()
        odeint(f, torch.ones(2), np.linspace(0, 1, 4), method=method,
               return_states=False)
        assert len(calls) == nfe(method, 4)


def test_nfe_and_stage_counts():
    assert nfe("euler", 49) == 48
    assert nfe("rk4", 13) == 48
    assert nfe("midpoint", 5) == 8 and num_stages("heun") == 2
    with pytest.raises(ValueError):
        num_stages("dopri5")
    with pytest.raises(ValueError):
        make_step("bogus")


@pytest.mark.parametrize("method", sorted(METHOD_STAGES))
def test_step_aux_matches_jax(method):
    """has_aux: one aux per evaluation, stacked along the stage axis in
    evaluation order, as JAX's make_step(has_aux=True) returns them."""
    from odevit_tpu.core.integrators import make_step as jax_make_step
    y0 = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)

    def tf(t, y):
        dy = torch_f(t, y)
        return dy, dy.sum(-1)

    def jf(t, y):
        dy = jax_f(t, y)
        return dy, dy.sum(-1)

    y, aux = make_step(method, has_aux=True)(tf, torch.from_numpy(y0),
                                             0.25, 0.5)
    want_y, want_aux = jax_make_step(method, has_aux=True)(
        jf, jnp.asarray(y0), jnp.float32(0.25), jnp.float32(0.5))
    assert aux.shape == (num_stages(method), 3)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-6,
                               rtol=1e-5)
    assert torch.equal(y, make_step(method)(torch_f, torch.from_numpy(y0),
                                            0.25, 0.5))
