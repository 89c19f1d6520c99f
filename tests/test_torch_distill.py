"""The port's distillation slice against the JAX package, on the CPU.

Control points, the trajectory and attention-distillation losses (values
and gradients against ``jax.grad``), the ViT teacher with carried weights,
and the whole fused distillation step against JAX
``make_fast_distill_train_step`` (Pallas kernels in interpret mode,
float32), with the same numpy-seeded inputs and weights
(``from_jax_params``). The step's tolerances are those
``tests/test_fast_steps.py`` holds the JAX fused step to against the flax
step: loss parts rtol 2e-4, ``grad_norm`` rtol 1e-2, parameters atol 5e-5 /
rtol 5e-3. The losses and the teacher agree to float32 noise: rtol 1e-5
(sums over the batch in another order), 1e-4 where the teacher's twelve
layers compound it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.losses import attention_distill as jad
from odevit_tpu.losses.control_points import \
    proportional_control_points as jax_control_points
from odevit_tpu.losses.trajectory import (trajectory_mse as jax_mse,
                                          uniform_checkpoints as jax_uniform,
                                          weighted_full_path_mse as jax_wmse)
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.teacher.vit import ViTTeacher as JaxTeacher
from odevit_tpu.train.fast_steps import \
    make_fast_distill_train_step as jax_make_step
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.losses import attention_distill as tad
from odevit_tpu_torch.losses.control_points import \
    proportional_control_points
from odevit_tpu_torch.losses.trajectory import (trajectory_mse,
                                                uniform_checkpoints,
                                                weighted_full_path_mse)
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import (fast_distill_forward,
                                               make_fast_distill_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

STUDENT = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=12.0,
               time_interval=1.0, num_eval_steps=7, solver="euler",
               register_tokens=2)
TEACHER = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=12,
               num_heads=2, mlp_dim=64, num_classes=7)
LR = 1e-4


@pytest.mark.parametrize("steps", [12, 36, 37])
@pytest.mark.parametrize("temperature", [3.0, 30.0])
def test_control_points_match_jax(steps, temperature):
    got = proportional_control_points(steps, temperature)
    want = jax_control_points(steps, temperature)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == steps - 1


def test_recipe_control_points():
    # the TS-Base recipe: 36 points at temperature 3 put eleven control
    # points at the start and the last at the end of the grid
    assert list(proportional_control_points(36, 3.0)) == [0] * 11 + [35]


@pytest.mark.parametrize("full_path", [True, False])
def test_trajectory_mse_matches_jax(full_path):
    rng = np.random.default_rng(0)
    s = rng.standard_normal((12, 4, 1, 8)).astype(np.float32)
    t = rng.standard_normal((12, 4, 3, 8)).astype(np.float32)
    want, want_parts = jax_mse(jnp.asarray(s), jnp.asarray(t),
                               full_path=full_path)
    got, parts = trajectory_mse(torch.from_numpy(s), torch.from_numpy(t),
                                full_path=full_path)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(parts) == set(want_parts)
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), float(want_parts[k]), rtol=1e-5)


def test_uniform_and_weighted_paths_match_jax():
    np.testing.assert_array_equal(uniform_checkpoints(36, 12),
                                  jax_uniform(36, 12))
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 3, 8)).astype(np.float32)
    t = rng.standard_normal((5, 3, 8)).astype(np.float32)
    want, _ = jax_wmse(jnp.asarray(s), jnp.asarray(t))
    got, _ = weighted_full_path_mse(torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def attention_rows(seed, ties=False):
    """[B, H, 16] softmax rows of a 4x4 patch grid; with ``ties``, runs of
    equal values (each row holds four copies of two values)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 3, 16)).astype(np.float32)
    if ties:
        a[..., 4:8] = a[..., 4:5]
        a[..., 10:14] = a[..., 2:3]
    e = np.exp(a)
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("smooth", [True, False])
def test_extract_mass_matches_jax(ties, smooth):
    rows = attention_rows(2, ties)
    want = jad.extract_mass(jnp.asarray(rows), 0.6, smooth=smooth,
                            return_mask=True)
    got = tad.extract_mass(torch.from_numpy(rows), 0.6, smooth=smooth,
                           return_mask=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def full_maps(seed, ties=False):
    """[B, H, 17, 17] maps whose CLS rows are ``attention_rows`` (with a
    CLS->CLS entry in front)."""
    rng = np.random.default_rng(seed + 100)
    m = rng.random((2, 3, 17, 17)).astype(np.float32)
    m[:, :, 0, 1:] = attention_rows(seed, ties)
    return m


@pytest.mark.parametrize("kind", ["l1", "l1_conjugate", "kl",
                                  "kl_spatial"])
def test_attention_losses_and_gradients_match_jax(kind):
    s, t = full_maps(3, ties=True), full_maps(4)
    if kind.startswith("l1"):
        kw = dict(lambda_param=0.5, conjugate=kind == "l1_conjugate")
        jfn, tfn = jad.l1_attention_loss, tad.l1_attention_loss
    else:
        kw = dict(lambda_param=0.5, temperature=3.0,
                  per_head=kind == "kl")
        jfn, tfn = jad.kl_attention_loss, tad.kl_attention_loss
    want, want_grad = jax.value_and_grad(
        lambda a: jfn(a, jnp.asarray(t), **kw))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    got = tfn(st, torch.from_numpy(t), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)


def test_attention_loss_takes_cached_teacher_rows():
    s, t = full_maps(5), full_maps(6)
    a = tad.l1_attention_loss(torch.from_numpy(s), torch.from_numpy(t),
                              lambda_param=1.0)
    b = tad.l1_attention_loss(torch.from_numpy(s),
                              torch.from_numpy(t[:, :, 0, 1:]),
                              lambda_param=1.0)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def teachers():
    rng = np.random.default_rng(7)
    pixels = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    jt = JaxTeacher(**TEACHER)
    params = jt.init(jax.random.PRNGKey(1), jnp.asarray(pixels))["params"]
    tt = ViTTeacher(**TEACHER, device="cpu")
    tt.load_state_dict(from_jax_params(jax.device_get(params)))
    want = jt.apply({"params": params}, jnp.asarray(pixels))
    with torch.no_grad():
        got = tt(torch.from_numpy(pixels))
    return got, want


@pytest.mark.parametrize("key", ["hidden_states", "attentions", "logits",
                                 "last_hidden_state"])
def test_teacher_matches_flax(teachers, key):
    got, want = teachers
    w = np.asarray(want[key])
    assert tuple(got[key].shape) == w.shape
    np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4, atol=1e-5)


def setup(seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    jm, jt = JaxViTODE(**STUDENT), JaxTeacher(**TEACHER)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tparams = jt.init(jax.random.PRNGKey(1), jnp.asarray(pixels))["params"]
    tm = ViTODE(**STUDENT, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    tt = ViTTeacher(**TEACHER, device="cpu")
    tt.load_state_dict(from_jax_params(jax.device_get(tparams)))
    return jm, jt, params, tparams, tm, tt, pixels, labels


@pytest.mark.parametrize("supervise", [True, False])
@pytest.mark.parametrize("loss", ["l1", "kl"])
def test_distill_step_matches_jax(supervise, loss):
    jm, jt, params, tparams, tm, tt, pixels, labels = setup(3)
    kw = dict(lambda_param=0.5, jasmin_k=2, mse_full_path=True,
              use_distillation=True, temperature=30.0,
              use_kl_loss=loss == "kl")
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    jstep = jax_make_step(jm, jt, tx, donate=False, **kw)
    js, jmet = jstep(jax_state(params, tx), tparams,
                     {"pixel_values": jnp.asarray(pixels),
                      "labels": jnp.asarray(labels)},
                     jax.random.PRNGKey(2), supervise=supervise)
    ts = create_train_state(tm, make_optimizer(LR))
    before = dict(launch_counts)
    ts, tmet = make_fast_distill_train_step(tm, tt, **kw)(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)}, supervise=supervise)
    assert launch_counts == before          # the CPU runs the plain path
    names = {"loss", "mse_loss", "kl_loss", "kl_nonfinite", "jasmin_loss",
             "supervision_loss", "acc", "nonfinite"}
    names |= {k for k in jmet if k.startswith("mse_loss_t@")}
    assert names <= set(tmet)
    for key in names:
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


def test_distill_map_is_cut_to_real_tokens_before_registers():
    """19 real tokens padded to 32: the student map reaching the attention
    loss is [B, H, 17, 17] (CLS + 16 patches), the registers and the
    padding cut off."""
    _, _, _, _, tm, tt, pixels, labels = setup(4)
    seen = {}
    real = tad.l1_attention_loss

    def spy(s_attn, t_attn, **kw):
        seen["shape"] = tuple(s_attn.shape)
        return real(s_attn, t_attn, **kw)

    tad_l1 = "odevit_tpu_torch.train.fast_steps.l1_attention_loss"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tad_l1, spy)
        with torch.no_grad():
            out = tt(torch.from_numpy(pixels))
        fast_distill_forward(tm, torch.from_numpy(pixels),
                             torch.from_numpy(labels),
                             out["hidden_states"][1:],
                             out["attentions"][-1], jasmin_k=2,
                             temperature=30.0, lambda_param=0.5)
    assert seen["shape"] == (8, 2, 17, 17)


@pytest.mark.parametrize("option", ["mesh", "teacher_cache", "solver"])
def test_distill_routes_not_ported_raise(option):
    _, _, _, _, tm, tt, pixels, labels = setup(5)
    if option == "solver":
        tm.solver = "rk4"
        with pytest.raises(ValueError, match="Euler"):
            fast_distill_forward(tm, torch.from_numpy(pixels),
                                 torch.from_numpy(labels), None, None,
                                 jasmin_k=2, temperature=30.0,
                                 lambda_param=0.5)
        return
    kw = {"mesh": object(), "teacher_cache": True}
    with pytest.raises(NotImplementedError):
        make_fast_distill_train_step(tm, tt, lambda_param=0.5,
                                     **{option: kw[option]})


def test_ts_base_student_config():
    """``ViTODE.base_224`` is the recipe's student: 224 px, patch 16,
    D=768, 12 heads, mlp 1.0, 10 registers without positions (207 tokens),
    Euler on 36 points."""
    m = ViTODE.base_224(device="cpu")
    assert m.patch_embed.seq_len == 207
    assert (m.embed_dim, m.num_heads, m.mlp_ratio) == (768, 12, 1.0)
    assert m.vf.mlp.fc1.weight.shape == (768, 768)
    assert m.patch_embed.pos_embed.shape == (1, 197, 768)
    assert (m.solver, m.num_eval_steps) == ("euler", 36)
