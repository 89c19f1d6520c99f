"""The port's serving path against the JAX package's: ``fast_forward``
on the CPU (the kernel's plain version) vs the JAX ``fast_forward`` (the
Pallas kernel in interpret mode), ``ViTODE.forward`` vs the flax model,
and ``make_preprocess``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.data.pipeline import make_preprocess as jax_preprocess
from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu_torch.data.pipeline import make_preprocess
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params

SMALL = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
             mlp_ratio=2.0, num_classes=7, emulate_depth=4,
             time_interval=1.0, num_eval_steps=5, register_tokens=2)


def pair(solver, dtype=None, **extra):
    """A JAX model and its port, with the JAX params loaded into the port."""
    kw = {**SMALL, "solver": solver, **extra}
    jm = JaxViTODE(dtype=jnp.bfloat16 if dtype else None, **kw)
    x = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(x))["params"])
    tm = ViTODE(dtype=torch.bfloat16 if dtype else None, device="cpu", **kw)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm, x


@pytest.mark.parametrize("solver", ["euler", "rk4", "midpoint"])
def test_fast_forward_matches_jax_f32(solver):
    jm, params, tm, x = pair(solver)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x),
                                       block_b=4)["logits"])
    got = fast_forward(tm, torch.from_numpy(x))["logits"]
    assert got.dtype == torch.float32 and got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("solver", ["euler", "rk4", "midpoint"])
def test_fast_forward_matches_jax_bf16(solver):
    """bf16: both round the same intermediates; the port's plain-f route
    (midpoint) also rounds qkv where the JAX XLA twin does not, and erf
    differs from the kernel's polynomial. Tolerance: 1% of the logit
    scale."""
    jm, params, tm, x = pair(solver, dtype="bf16")
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x),
                                       block_b=4)["logits"])
    got = fast_forward(tm, torch.from_numpy(x))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(),
                               rtol=0)


def test_fast_forward_non_uniform_grid_uses_generic_route():
    jm, params, tm, x = pair("euler")
    grid = np.array([0.0, 0.1, 0.35, 0.7, 1.0])
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x),
                                       t_grid=grid, block_b=4)["logits"])
    got = fast_forward(tm, torch.from_numpy(x), t_grid=grid)["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_forward_matches_flax_and_fast_forward(solver):
    jm, params, tm, x = pair(solver)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x))["logits"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    fast = fast_forward(tm, torch.from_numpy(x))["logits"].numpy()
    np.testing.assert_allclose(fast, got, atol=5e-4, rtol=5e-3)


def test_dist_token_head():
    jm, params, tm, x = pair("euler", register_tokens=0,
                             add_distillation_token=True)
    want = jax_fast_forward(jm, params, jnp.asarray(x), block_b=4)
    got = fast_forward(tm, torch.from_numpy(x))
    for key in ("logits", "logits_dist"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, rtol=5e-3)


def test_from_jax_params_fills_every_parameter():
    _, params, tm, _ = pair("euler")
    sd = from_jax_params(params)
    assert set(sd) == set(tm.state_dict())
    assert tuple(sd["vf.attn.qkv.weight"].shape) == (96, 32)      # [out, in]
    assert tuple(sd["patch_embed.proj_kernel"].shape) == (48, 32)  # [in, out]


@pytest.mark.parametrize("case", ["dopri5", "chain", "forward_flag",
                                  "not_vitode"])
def test_unported_paths_raise(case, monkeypatch):
    _, _, tm, x = pair("euler")
    x = torch.from_numpy(x)
    with pytest.raises(NotImplementedError):
        if case == "dopri5":
            tm.solver = "dopri5"
            fast_forward(tm, x)
        elif case == "chain":
            # Euler on a uniform grid of 4 steps: JAX chains 4 per launch
            monkeypatch.setenv("ODEVIT_EULER_CHAIN", "4")
            fast_forward(tm, x)
        elif case == "not_vitode":       # e.g. a Macaron model
            fast_forward(tm.vf, x)
        else:
            tm(x, output_attentions=True)


@pytest.mark.parametrize("solver,chain,grid", [
    ("rk4", "5", None),                  # not the fused Euler route
    ("euler", "3", None),                # 3 does not divide 4 steps
    ("euler", "0", None),                # not above 1
    ("euler", "4", [0.0, 0.1, 0.35, 0.7, 1.0])])   # not a uniform grid
def test_euler_chain_is_ignored_where_jax_does_not_chain(solver, chain, grid,
                                                         monkeypatch):
    """JAX reads ODEVIT_EULER_CHAIN only on the fused Euler route over a
    uniform grid, and chains only when the value is above 1 and divides
    the step count; elsewhere the port takes JAX's route unchanged."""
    _, _, tm, x = pair(solver)
    x = torch.from_numpy(x)
    want = fast_forward(tm, x, t_grid=grid)["logits"]
    monkeypatch.setenv("ODEVIT_EULER_CHAIN", chain)
    assert torch.equal(fast_forward(tm, x, t_grid=grid)["logits"], want)


def test_make_preprocess_matches_jax():
    u8 = np.random.default_rng(5).integers(0, 256, (3, 8, 8, 3),
                                           dtype=np.uint8)
    want = np.asarray(jax_preprocess()(jnp.asarray(u8)))
    got = make_preprocess()(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    bf = make_preprocess(dtype=torch.bfloat16)(torch.from_numpy(u8))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  np.asarray(jax_preprocess(
                                      dtype=jnp.bfloat16)(jnp.asarray(u8))
                                      .astype(jnp.float32)))
    with pytest.raises(NotImplementedError):
        make_preprocess(image_size=16)(torch.from_numpy(u8))
