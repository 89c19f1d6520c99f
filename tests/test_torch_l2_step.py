"""The port's L2-attention ViTODE through its fused paths, against JAX's.

``make_fast_free_train_step`` on an L2 model against JAX's
``make_fast_free_train_step`` (``fused_vf_l2``, ``fused_vf_l2_jasmin`` and
the L2 ``pallas_vf_bwd``, Pallas in interpret mode, float32) over 3 steps,
from the same weights with nonzero attention biases and the same
numpy-seeded batch; ``fast_forward`` against JAX's ``fast_forward`` with
rk4, Euler (both on the generic integrator, as JAX routes L2) and dopri5
(JAX's XLA twin, as ``tests/test_torch_fast_forward.py`` runs it);
``ODEVIT_EULER_CHAIN`` ignored for L2; and the routes JAX's L2 path does
not have, which raise (and shapes past the tiled route's 256 padded
tokens). The small config is ``tests/test_torch_train.py``'s
``CFG`` (16 px, D=32, 2 heads, 19 tokens, rk4 on 4 points) with
``l2_attention=True``.

Tolerances are ``tests/test_torch_train.py``'s: loss and JaSMin loss rtol
1e-4, grad_norm rtol 1e-2, gradients and updated parameters atol 5e-5 /
rtol 5e-3; logits atol 5e-4 / rtol 5e-3, as
``tests/test_torch_fast_forward.py`` holds the softmax model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.models.fast_forward import fast_forward as jax_fast_forward
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.train.fast_steps import (fast_free_forward as jax_forward,
                                         make_fast_free_train_step
                                         as jax_make_step)
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.models import fast_forward as ff
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import (fast_free_forward,
                                               make_fast_distill_train_step,
                                               make_fast_free_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

CFG = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           num_eval_steps=4, solver="rk4", register_tokens=2,
           l2_attention=True)
LR = 1e-4


def setup(seed=0, **over):
    """JAX model and params (attention biases drawn nonzero), the port's
    model with them loaded, a batch."""
    cfg = {**CFG, **over}
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    jm = JaxViTODE(**cfg)
    init = jm.clone(solver="euler") if cfg["solver"] == "dopri5" else jm
    params = jax.device_get(init.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(pixels))["params"])
    attn = params["vf"]["attn"]
    for name in ("q_bias", "k_bias", "v_bias", "out_bias"):
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.1).astype(
            np.float32)
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm, pixels, labels


def assert_tree_close(got_sd, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].detach().numpy(),
                                   want.numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_l2_forward_loss_and_gradients_match_jax():
    """Every parameter's gradient, the four attention biases among them
    (the 11 cotangents of each evaluation, carried back through the
    concatenated Wqkv and qkv bias)."""
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
    grads_sd = {n: p.grad for n, p in tm.named_parameters()}
    assert grads_sd["vf.attn.q.bias"].abs().max() > 0
    assert grads_sd["vf.attn.out.bias"].abs().max() > 0
    assert_tree_close(grads_sd, grads, atol=5e-5, rtol=5e-3)


@pytest.fixture(scope="module")
def three_steps():
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
def test_l2_train_steps_match_jax(three_steps, steps):
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


@pytest.mark.parametrize("solver", ["rk4", "euler", "dopri5"])
def test_l2_fast_forward_matches_jax(solver):
    jm, params, tm, pixels, _ = setup(2, solver=solver, num_eval_steps=5)
    # JAX routes L2 to the generic integrator (fixed grids) or dopri5;
    # dopri5 runs its XLA twin here
    want = np.asarray(jax_fast_forward(
        jm, params, jnp.asarray(pixels), block_b=4,
        use_pallas=solver != "dopri5")["logits"])
    before = dict(launch_counts)
    got = fast_forward(tm, torch.from_numpy(pixels))["logits"]
    assert launch_counts == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (8, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


def test_euler_chain_is_ignored_for_l2(monkeypatch):
    """Euler on 4 uniform steps with ODEVIT_EULER_CHAIN=4, where a softmax
    model would chain: L2 keeps the generic route, as JAX does."""
    jm, params, tm, pixels, _ = setup(3, solver="euler", num_eval_steps=5)
    xt = torch.from_numpy(pixels)
    per_step = fast_forward(tm, xt)["logits"]
    monkeypatch.setenv("ODEVIT_EULER_CHAIN", "4")

    def no_chain(*args, **kw):
        raise AssertionError("L2 took the chained Euler route")

    monkeypatch.setattr(ff, "vf_euler_chain", no_chain)
    want = np.asarray(jax_fast_forward(jm, params, jnp.asarray(pixels),
                                       block_b=4)["logits"])
    got = fast_forward(tm, xt)["logits"]
    assert torch.equal(got, per_step)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("case", ["dropout", "no_cta_plan", "distill",
                                  "short_sequence"])
def test_l2_routes_jax_does_not_have_raise(case):
    pixels = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    labels = torch.tensor([1, 2])
    if case == "dropout":
        # JAX's fused L2 path asserts it is deterministic
        tm = ViTODE(**CFG, attn_drop=0.1, device="cpu")
        step = make_fast_free_train_step(tm, jasmin_k=10)
        with pytest.raises(ValueError, match="deterministic"):
            step(create_train_state(tm, make_optimizer(LR)),
                 {"pixel_values": pixels, "labels": labels}, rng=0)
    elif case == "no_cta_plan":
        # 64 px at patch 4: 259 tokens padded to 272, beyond one image per
        # CTA: the tiled route, key-tiled past 256 padded tokens
        # (tests/test_torch_long_seq.py holds that shape against JAX)
        tm = ViTODE(**{**CFG, "img_size": 64}, device="cpu")
        logits = fast_forward(tm, torch.zeros(2, 64, 64, 3))["logits"]
        assert torch.isfinite(logits).all()
        loss, _ = fast_free_forward(tm, torch.zeros(2, 64, 64, 3), labels,
                                    jasmin_k=10)
        assert torch.isfinite(loss)
    elif case == "distill":
        tm = ViTODE(**{**CFG, "solver": "euler"}, device="cpu")
        teacher = ViTTeacher(image_size=16, patch_size=4, hidden_size=32,
                             num_layers=2, num_heads=2, mlp_dim=64,
                             device="cpu")
        step = make_fast_distill_train_step(tm, teacher, lambda_param=0.5,
                                            jasmin_k=2, temperature=3.0)
        with pytest.raises(ValueError, match="softmax"):
            step(create_train_state(tm, make_optimizer(LR)),
                 {"pixel_values": pixels, "labels": labels})
    else:
        # 19 tokens cannot hold k+1 = 21 extraction passes, and JAX's L2
        # path has no map route to fall back to
        tm = ViTODE(**CFG, device="cpu")
        with pytest.raises(ValueError, match="tokens"):
            fast_free_forward(tm, pixels, labels, jasmin_k=20)
