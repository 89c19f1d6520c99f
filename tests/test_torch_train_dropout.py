"""The fused free-training step with dropout against the JAX package's.

JAX's dropout evaluations draw ``pltpu`` bits, which have no CPU lowering,
so inside these tests its three dropout evaluation routes
(``fused_vf_jasmin_from_params`` with a seed, ``fused_vf_dropout_from_params``
and ``_xla_dropout_eval``) are routed through its XLA twin
``_xla_reference(masks=...)``, with the masks drawn by the port's plain
generator on the traced seed (``jax.pure_callback``). Nothing in the JAX
package changes: the step, its per-step and per-stage seeds, its window
split and its stage combinations are JAX's own. The port runs the same
evaluations through the plain versions of its kernels on the CPU.

Same weights (``from_jax_params``), the same numpy-seeded batch and the
same step seeds (JAX's ``randint`` on its key, handed to the port as
``step_seeds``). Tolerances are those of ``tests/test_torch_train.py``:
loss rtol 1e-4, grad_norm rtol 1e-2, gradients and updated parameters
atol 5e-5 / rtol 5e-3. Shapes are small (16 px, D=32, 2 heads, 19
tokens); rk4 on 4 points (2 plain steps, one JaSMin step) and Euler on 8
(one plain step, 6 JaSMin steps).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import odevit_tpu.kernels.vector_field as jax_vf
import odevit_tpu.train.fast_steps as jax_steps
from odevit_tpu.kernels.vector_field import _vf_args, _xla_reference
from odevit_tpu.losses.jasmin import jasmin_order_stats
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
import odevit_tpu_torch.train.fast_steps as port_steps
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.train.fast_steps import (_comb, _lc, draw_step_seeds,
                                               fast_distill_forward,
                                               fast_free_forward,
                                               make_fast_distill_train_step,
                                               make_fast_free_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

DROPS = dict(attn_drop=0.1, proj_drop=0.2, mlp_drop=0.3)
CFG = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           register_tokens=2, **DROPS)
GRIDS = {"rk4": 4, "euler": 8}
LR = 1e-4
I32 = jnp.iinfo(jnp.int32)


def twin_eval(y, vf_params, seed, *, num_heads, scaler, drops, want_attn):
    """A JAX dropout evaluation through the XLA twin, fed the port's
    masks for the traced seed."""
    b, n, d = y.shape
    dh = vf_params["mlp"]["fc1_kernel"].shape[-1]

    def host(s):
        masks = generate_dropout_masks(
            b, n, d, dh, num_heads, int(s), attn_drop=drops[0],
            proj_drop=drops[1], mlp_drop=drops[2], device="cpu")
        return tuple(m.numpy() for m in masks)

    f32 = jnp.float32
    shapes = (jax.ShapeDtypeStruct((b, n, dh), f32),
              jax.ShapeDtypeStruct((b, n, d), f32),
              jax.ShapeDtypeStruct((b, n, d), f32),
              jax.ShapeDtypeStruct((b, num_heads, n, n), f32))
    masks = jax.pure_callback(host, shapes, seed)
    return _xla_reference(*_vf_args(y, vf_params), num_heads=num_heads,
                          scaler=scaler, return_attn=want_attn, masks=masks)


@pytest.fixture
def twin_dropout(monkeypatch):
    """Route JAX's dropout evaluations through the twin (deterministic
    evaluations keep their own route)."""
    jasmin = jax_steps.fused_vf_jasmin_from_params

    def jasmin_from_params(x, vf_params, *, seed=None, drops=(0.0,) * 3,
                           **kw):
        if seed is None or not any(drops):
            return jasmin(x, vf_params, seed=seed, drops=drops, **kw)
        dx, p = twin_eval(x, vf_params, seed, num_heads=kw["num_heads"],
                          scaler=kw["scaler"], drops=drops, want_attn=True)
        return dx, jasmin_order_stats(p, kw["jas_k"])

    def dropout_from_params(x, vf_params, seed, *, num_heads, scaler, drops,
                            **kw):
        return twin_eval(x, vf_params, seed, num_heads=num_heads,
                         scaler=scaler, drops=drops, want_attn=False)

    def xla_dropout_eval(y, vf_params, seed, *, num_heads, scaler, n_real,
                         drops, want_attn):
        return twin_eval(y, vf_params, seed, num_heads=num_heads,
                         scaler=scaler, drops=drops, want_attn=want_attn)

    monkeypatch.setattr(jax_steps, "fused_vf_jasmin_from_params",
                        jasmin_from_params)
    monkeypatch.setattr(jax_vf, "fused_vf_dropout_from_params",
                        dropout_from_params)
    monkeypatch.setattr(jax_steps, "_xla_dropout_eval", xla_dropout_eval)
    # the port's step draws JAX's step seeds: the key folded with the step
    monkeypatch.setattr(port_steps, "draw_step_seeds", jax_step_seeds)


def jax_step_seeds(rng, step, count):
    key = jax.random.fold_in(jax.random.PRNGKey(rng), step)
    return seeds_of(key, count)


def seeds_of(key, count):
    return np.asarray(jax.random.randint(key, (count,), I32.min, I32.max,
                                         dtype=jnp.int32)).tolist()


def setup(solver="rk4", seed=0):
    cfg = dict(CFG, solver=solver, num_eval_steps=GRIDS[solver])
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    jm = JaxViTODE(**cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(pixels))["params"]
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    return jm, params, tm, pixels, labels


def assert_tree_close(got_sd, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].detach().numpy(),
                                   want.numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("solver", ["rk4", "euler"])
def test_forward_loss_and_gradients_match_jax(twin_dropout, solver):
    jm, params, tm, pixels, labels = setup(solver)
    key = jax.random.PRNGKey(3)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jax_steps.fast_free_forward(
            jm, p, jnp.asarray(pixels), jnp.asarray(labels), jasmin_k=10,
            rng=key), has_aux=True)(params)
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
    # dropout took part: the deterministic forward gives another loss
    tm.attn_drop = tm.proj_drop = tm.mlp_drop = 0.0
    plain, _ = fast_free_forward(tm, torch.from_numpy(pixels),
                                 torch.from_numpy(labels), jasmin_k=10)
    assert abs(plain.item() - got.item()) > 1e-3 * abs(got.item())


@pytest.fixture
def three_steps(twin_dropout):
    """Three steps of both packages with dropout from the same start and
    the same rng; the metrics of every step and the parameters after
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
    return runs


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_with_dropout_match_jax(three_steps, steps):
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
    # each step drew new masks: the losses of steps 1 and 2 differ more
    # than one AdamW step at lr 1e-4 moves them
    assert three_steps[1][1]["loss"] != three_steps[2][1]["loss"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_combinations_round_as_jax(dtype):
    """JAX's step_drop forms rk4's stage states as (y + dt * (c k1 + k2))
    .astype(y.dtype): the inner sum in the slopes' dtype, each Python
    coefficient rounded to it. The port's _comb and _lc are bit-equal."""
    rng = np.random.default_rng(0)
    y, k1, k2, k3, k4 = (rng.standard_normal((4, 8)).astype(np.float32)
                         for _ in range(5))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda a: jnp.asarray(a, jdt)
    t = lambda a: torch.from_numpy(a).to(dtype)
    dt, third = np.float32(1.0 / 12.0), 1.0 / 3.0
    jdt_ = jnp.float32(dt)
    want = [(j(y) + jdt_ * third * j(k1)).astype(jdt),
            (j(y) + jdt_ * (-third * j(k1) + j(k2))).astype(jdt),
            (j(y) + jdt_ * (j(k1) - j(k2) + j(k3))).astype(jdt),
            (j(y) + jdt_ * (0.125 * j(k1) + 0.375 * j(k2) + 0.375 * j(k3)
                            + 0.125 * j(k4))).astype(jdt)]
    got = [_lc(t(y), float(dt), [(third, t(k1))]),
           _comb(t(y), float(dt), [(-third, t(k1)), (1.0, t(k2))]),
           _comb(t(y), float(dt), [(1.0, t(k1)), (-1.0, t(k2)),
                                   (1.0, t(k3))]),
           _comb(t(y), float(dt), [(0.125, t(k1)), (0.375, t(k2)),
                                   (0.375, t(k3)), (0.125, t(k4))])]
    for a, b in zip(got, want):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


def test_step_seeds_are_drawn_per_run_and_step():
    a = draw_step_seeds(7, 0, 12)
    assert a == draw_step_seeds(7, 0, 12)
    assert a != draw_step_seeds(7, 1, 12) and a != draw_step_seeds(8, 0, 12)
    assert len(set(a)) == 12
    assert all(-2 ** 31 <= s < 2 ** 31 - 1 for s in a)


def test_cpu_dropout_step_counts_no_launch():
    _, _, tm, pixels, labels = setup("rk4", 2)
    before = dict(launch_counts)
    ts = create_train_state(tm, make_optimizer(LR))
    ts, met = make_fast_free_train_step(tm, jasmin_k=10)(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)}, rng=0)
    assert np.isfinite(float(met["loss"]))
    assert launch_counts == before


@pytest.mark.parametrize("case", ["step_without_rng",
                                  "forward_without_seeds",
                                  "wrong_seed_count", "solver",
                                  "distillation"])
def test_dropout_routes_that_raise(case):
    _, _, tm, pixels, labels = setup("rk4", 3)
    px, lb = torch.from_numpy(pixels), torch.from_numpy(labels)
    if case == "step_without_rng":
        step = make_fast_free_train_step(tm, jasmin_k=10)
        with pytest.raises(ValueError, match="rng"):
            step(create_train_state(tm, make_optimizer(LR)),
                 {"pixel_values": px, "labels": lb})
    elif case == "forward_without_seeds":
        with pytest.raises(ValueError, match="step_seeds"):
            fast_free_forward(tm, px, lb, jasmin_k=10)
    elif case == "wrong_seed_count":
        with pytest.raises(ValueError, match="step seeds"):
            fast_free_forward(tm, px, lb, jasmin_k=10, step_seeds=[1])
    elif case == "solver":
        tm.solver = "midpoint"
        with pytest.raises(ValueError, match="midpoint"):
            fast_free_forward(tm, px, lb, jasmin_k=10, step_seeds=[1, 2, 3])
    else:
        # the distillation step with dropout needs its rng too (it raises
        # before the teacher runs), and its forward the step seeds
        tm.solver = "euler"
        step = make_fast_distill_train_step(tm, None, lambda_param=0.5,
                                            jasmin_k=2, temperature=3.0)
        with pytest.raises(ValueError, match="rng"):
            step(create_train_state(tm, make_optimizer(LR)),
                 {"pixel_values": px, "labels": lb}, supervise=True)
        with pytest.raises(ValueError, match="step_seeds"):
            fast_distill_forward(tm, px, lb, None, None, jasmin_k=2,
                                 temperature=3.0, lambda_param=0.5)
