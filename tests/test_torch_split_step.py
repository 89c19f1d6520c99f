"""The distillation step at MLP ratio 4 against the JAX package's, on the
split backward.

The smallest shape that ``split_route`` sends to the split backward: D=512,
8 heads, dh=2048, a 32 px image at patch 8 (16 patches and the CLS token:
17 tokens, padded to 32), no registers, B=2, float32. JAX's
``make_fast_distill_train_step`` takes its own split backward there
(``_pallas_vf_bwd_split``, kernels in interpret mode), and the port's step
on the CPU takes the plain twins of its split route. One step each, from
the same weights (``from_jax_params``) and batch, with and without dropout
(rates 0.1; JAX's kernels draw the port's mask stream, as
``tests/test_torch_split_bwd.py`` sets it up, and the port's step takes
JAX's step seeds). JAX's interpret-mode kernels make one step take tens of
seconds to compile, so the grid is cut to Euler on 3 points (two
evaluations, both in the JaSMin window, the second with its maps), not the
width. JaSMin k=2, temperature 3, lambda 0.5, L1 attention loss,
supervised. Tolerances are those of ``tests/test_torch_distill.py``: loss
parts rtol 2e-4, grad_norm rtol 1e-2, parameters atol 5e-5 / rtol 5e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.teacher.vit import ViTTeacher as JaxTeacher
from odevit_tpu.train.fast_steps import \
    make_fast_distill_train_step as jax_make_step
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
import odevit_tpu_torch.train.fast_steps as port_steps
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.vector_field_bwd_split import split_route
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import make_fast_distill_train_step
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

from test_torch_split_bwd import jax_takes_split, port_stream
from test_torch_train_dropout import jax_step_seeds

STUDENT = dict(img_size=32, patch_size=8, embed_dim=512, num_heads=8,
               mlp_ratio=4.0, num_classes=7, emulate_depth=12.0,
               time_interval=1.0, num_eval_steps=3, solver="euler",
               register_tokens=0)
TEACHER = dict(image_size=32, patch_size=8, hidden_size=512, num_layers=12,
               num_heads=8, mlp_dim=512, num_classes=7)
RECIPE = dict(lambda_param=0.5, jasmin_k=2, temperature=3.0,
              use_kl_loss=False, mse_full_path=True)
RATES = dict(attn_drop=0.1, proj_drop=0.1, mlp_drop=0.1)
LR = 1e-4


def test_step_shape_takes_the_split_route_in_both_packages():
    assert split_route(512, 2048)
    assert jax_takes_split(2, 17, 512, 2048, 8, emit_jas=True, itemsize=4)


@pytest.fixture(scope="module")
def step_inputs():
    """The batch and both packages' initial weights (dropout rates do not
    change a parameter, so the two cases share them)."""
    rng = np.random.default_rng(6)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 2)
    params = JaxViTODE(**STUDENT).init(jax.random.PRNGKey(0),
                                       jnp.asarray(pixels))["params"]
    tparams = JaxTeacher(**TEACHER).init(jax.random.PRNGKey(1),
                                         jnp.asarray(pixels))["params"]
    return pixels, labels, params, tparams


@pytest.mark.parametrize("drop", [False, True], ids=["det", "drop"])
def test_ratio_4_distill_step_matches_jax(drop, step_inputs, monkeypatch):
    rates = RATES if drop else {}
    if drop:
        port_stream(monkeypatch, 17)
        # the port's step draws JAX's step seeds
        monkeypatch.setattr(port_steps, "draw_step_seeds", jax_step_seeds)
    pixels, labels, params, tparams = step_inputs
    jm, jt = JaxViTODE(**STUDENT, **rates), JaxTeacher(**TEACHER)
    tm = ViTODE(**STUDENT, **rates, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    tt = ViTTeacher(**TEACHER, device="cpu")
    tt.load_state_dict(from_jax_params(jax.device_get(tparams)))
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    jstep = jax_make_step(jm, jt, tx, donate=False, **RECIPE)
    js, jmet = jstep(jax_state(params, tx), tparams,
                     {"pixel_values": jnp.asarray(pixels),
                      "labels": jnp.asarray(labels)},
                     jax.random.PRNGKey(5), supervise=True)
    ts = create_train_state(tm, make_optimizer(LR))
    before = dict(launch_counts)
    ts, tmet = make_fast_distill_train_step(tm, tt, **RECIPE)(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)},
        rng=5 if drop else None, supervise=True)
    assert launch_counts == before          # the CPU runs the plain path
    for key in ("loss", "mse_loss", "kl_loss", "jasmin_loss",
                "supervision_loss", "acc", "nonfinite"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-2)
    want_sd = from_jax_params(jax.device_get(js.params))
    got_sd = {n: p.detach() for n, p in tm.named_parameters()}
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(),
                                   atol=5e-5, rtol=5e-3, err_msg=name)
