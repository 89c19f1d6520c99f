"""The port's serving path against the JAX package's: ``fast_forward``
on the CPU (the kernel's plain version) vs the JAX ``fast_forward`` (the
Pallas kernel in interpret mode) on every route (Euler, rk4, the generic
integrator, the chained Euler opt-in, dopri5), at a small shape and at the
TS-Base token count; ``ViTODE.forward`` vs the flax model; and
``make_preprocess`` with its bilinear resize."""

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
    # the flax model integrates fixed grids only: a dopri5 model takes the
    # parameters of its Euler twin
    init = jm.clone(solver="euler") if solver == "dopri5" else jm
    params = jax.device_get(init.init(jax.random.PRNGKey(0),
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


@pytest.mark.parametrize("case", ["forward_flag", "not_vitode",
                                  "forward_dopri5"])
def test_unported_paths_raise(case):
    _, _, tm, x = pair("euler")
    x = torch.from_numpy(x)
    with pytest.raises(NotImplementedError):
        if case == "not_vitode":  # neither a ViTODE nor a ViTMacaron
            fast_forward(tm.vf, x)
        elif case == "forward_dopri5":
            # the flax model integrates fixed grids only (its ODEBlock
            # knows no dopri5); dopri5 runs in fast_forward
            tm.solver = "dopri5"
            tm(x)
        else:
            tm(x, output_attentions=True)


@pytest.mark.parametrize("chain", ["2", "4"])
def test_euler_chain_matches_jax_and_the_per_step_route(chain, monkeypatch):
    """Euler on 4 uniform steps, chained 2 or 4 steps per launch: JAX's
    chain (``_vf_euler_chain_kernel``, interpret mode) at f32, and bit for
    bit the port's per-step route, at f32 and bf16."""
    jm, params, tm, x = pair("euler")
    xt = torch.from_numpy(x)
    per_step = fast_forward(tm, xt)["logits"]
    monkeypatch.setenv("ODEVIT_EULER_CHAIN", chain)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x),
                                       block_b=4)["logits"])
    got = fast_forward(tm, xt)["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)
    assert torch.equal(got, per_step)
    _, _, tb, _ = pair("euler", dtype="bf16")
    chained = fast_forward(tb, xt)["logits"]
    monkeypatch.delenv("ODEVIT_EULER_CHAIN")
    assert torch.equal(chained, fast_forward(tb, xt)["logits"])


def test_dopri5_matches_jax_f32():
    """dopri5 over one segment [0, 1] with the model's rtol/atol, against
    JAX's route (``odeint_dopri5`` over the XLA twin) at f32."""
    jm, params, tm, x = pair("dopri5")
    assert (tm.solver_rtol, tm.solver_atol) == (jm.solver_rtol,
                                                 jm.solver_atol)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x), block_b=4,
                                       use_pallas=False)["logits"])
    got = fast_forward(tm, torch.from_numpy(x))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)


# the TS-Base student's token count (224 px, patch 16, 10 registers: 207
# tokens padded to 208) at narrow widths
TS_NARROW = dict(img_size=224, patch_size=16, embed_dim=64, num_heads=4,
                 mlp_ratio=1.0, num_classes=7, emulate_depth=12,
                 time_interval=1.0, num_eval_steps=4, register_tokens=10,
                 pos_embed_register_tokens=False)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_fast_forward_at_the_ts_base_token_count(solver):
    """The routes the 224 px student serves on (fused Euler, fused rk4
    stage advance) at 207 tokens, B=2, f32, against JAX's fast_forward."""
    kw = {**TS_NARROW, "solver": solver}
    jm = JaxViTODE(**kw)
    x = np.random.default_rng(3).standard_normal((2, 224, 224, 3)).astype(
        np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1),
                                    jnp.asarray(x))["params"])
    tm = ViTODE(device="cpu", **kw)
    tm.load_state_dict(from_jax_params(params))
    assert tm.patch_embed.seq_len == 207
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(x),
                                       block_b=2)["logits"])
    got = fast_forward(tm, torch.from_numpy(x))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)


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
    # a size the images already have needs no resize
    same = make_preprocess(image_size=8)(torch.from_numpy(u8))
    assert torch.equal(same, got)


@pytest.mark.parametrize("src", [32, 256, 300, 224])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_preprocess_resize_matches_jax(src, dtype):
    """x/255, ``jax.image.resize(method="bilinear")`` to 224, normalize,
    cast. float32: within 1e-4 of the normalized values (the resize agrees
    to 2e-5 of [0, 1] at 300 -> 224, ~8e-5 after dividing by the std).
    bfloat16: the same values rounded once, so a value next to a rounding
    boundary may land one bf16 ulp (2^-7 relative) away, rarely."""
    u8 = np.random.default_rng(src).integers(0, 256, (2, src, src, 3),
                                             dtype=np.uint8)
    want = np.asarray(jax_preprocess(image_size=224,
                                     dtype=getattr(jnp, dtype))(
        jnp.asarray(u8)).astype(jnp.float32))
    got = make_preprocess(image_size=224, dtype=getattr(torch, dtype))(
        torch.from_numpy(u8))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, 224, 224, 3) and got.is_contiguous()
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=2 ** -7)
        assert (got != want).mean() < 1e-3
    if src == 224:
        np.testing.assert_array_equal(got, want)
