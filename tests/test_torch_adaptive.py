"""The port's dopri5 (``core/adaptive.py``) against the JAX package's
``odeint_dopri5`` on a fixed vector field: the same number of
evaluations, the same ``max_steps_hit``, and states at the grid points
within 1e-5 at float32 (the controller's float32 arithmetic is JAX's, so
both accept and reject the same steps; the field's tanh and cos differ by
ulps)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.core.adaptive import odeint_dopri5 as jax_dopri5
from odevit_tpu_torch.core.adaptive import odeint_dopri5

W = (np.random.default_rng(0).standard_normal((8, 8)) / np.sqrt(8)).astype(
    np.float32)
Y0 = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)


def field(lib):
    """dy/dt = 3 tanh(y W) + cos(4 t): stiff enough for tens of steps,
    and time-dependent so that the stage times count."""
    if lib == "jax":
        w = jnp.asarray(W)
        return lambda t, y: 3.0 * jnp.tanh(y @ w) + jnp.cos(4.0 * t)
    w = torch.from_numpy(W)
    return lambda t, y: 3.0 * torch.tanh(y @ w) + float(np.cos(
        np.float32(4.0) * np.float32(t)))


@pytest.mark.parametrize("case", ["one_segment", "grid", "tight", "capped",
                                  "first_step"])
def test_dopri5_matches_jax(case):
    ts = [0.0, 1.0]
    kw = {}
    if case == "grid":
        ts = [0.0, 0.3, 0.35, 1.0, 2.0]
    elif case == "tight":
        kw = dict(rtol=1e-7, atol=1e-9)
    elif case == "capped":
        # the segment stops refining after 3 steps, short of its end
        kw = dict(max_steps_per_segment=3)
    elif case == "first_step":
        kw = dict(first_step=0.5)
    want, winfo = jax_dopri5(field("jax"), jnp.asarray(Y0), jnp.asarray(ts),
                             **kw)
    got, info = odeint_dopri5(field("torch"), torch.from_numpy(Y0), ts, **kw)
    assert info["nfe"] == int(winfo["nfe"])
    assert info["max_steps_hit"] == bool(winfo["max_steps_hit"])
    assert info["max_steps_hit"] == (case == "capped")
    assert tuple(got.shape) == (len(ts), 4, 8)
    # a capped segment ends where its last accepted step left it, which
    # moves with the step sizes: the error estimate is a difference of
    # nearly equal stage sums, so float32 noise in the field (XLA's tanh
    # and cos against torch's) shows in its 4th digit and in dt's 5th
    tol = 1e-4 if case == "capped" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_dopri5_keeps_the_state_dtype():
    """A bfloat16 state stays bfloat16; stages are combined in float32
    and rounded once, as JAX's ``_lc``."""
    y0 = torch.from_numpy(Y0).to(torch.bfloat16)
    f = lambda t, y: 3.0 * torch.tanh(y.float() @ torch.from_numpy(W)).to(
        y.dtype)
    states, info = odeint_dopri5(f, y0, [0.0, 1.0], rtol=1e-2, atol=1e-3)
    assert states.dtype == torch.bfloat16 and info["nfe"] > 1
    assert torch.isfinite(states.float()).all()
