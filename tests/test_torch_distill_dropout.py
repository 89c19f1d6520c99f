"""The distillation step with dropout, and the tiled route's dropout modes
in their plain versions, against the JAX package.

JAX's dropout evaluations draw ``pltpu`` bits, which have no CPU lowering,
so inside these tests JAX's dropout routes (``fused_vf_dropout_from_params``,
``fused_vf_jasmin_from_params`` with a seed,
``fused_vf_attn_dropout_from_params`` and ``_xla_dropout_eval``) go through
its XLA twin ``_xla_reference(masks=...)``, fed the masks of the port's
plain generator for the traced seed (``jax.pure_callback``), as
``tests/test_torch_train_dropout.py`` does. JAX's step runs on both of its
routes: the in-kernel one (dropout in the kernels, JaSMin from the
statistics), which it takes at this small D and at TS-Base in bf16 (both
MLP ratios), and, with ``auto_block_b`` patched to 0, the one it takes at
TS-Base in f32 at MLP ratio 4 (``_xla_dropout_eval`` for every evaluation,
JaSMin from the pre-dropout maps through ``jasmin_map_loss``). The port
keeps its in-kernel statistics of the pre-dropout p on both.

Small shapes: 16 px, D=32, 2 heads, 2 registers (19 tokens), Euler on 8
points, JaSMin k=2, temperature 3, lambda 0.5, L1 attention loss,
supervised, rates (attn, proj, mlp) = (0.1, 0.2, 0.3). Tolerances are
those of ``tests/test_torch_distill.py``: loss rtol 1e-4 (metrics 2e-4),
grad_norm rtol 1e-2, gradients and parameters atol 5e-5 / rtol 5e-3; the
plain versions as ``tests/test_torch_dropout.py`` holds them (f32: 1e-5
forward, 1e-4 backward; bf16: 2 ulps, 2^-7, of the output scale).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import odevit_tpu.kernels.vector_field as jax_vf
import odevit_tpu.train.fast_steps as jax_steps
from odevit_tpu.kernels.vector_field import _xla_reference
from odevit_tpu.losses.jasmin import jasmin_order_stats
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.teacher.vit import ViTTeacher as JaxTeacher
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
from odevit_tpu_torch.kernels import dropout, launch_counts, tiled
from odevit_tpu_torch.kernels.autograd import fused_vf_attn
from odevit_tpu_torch.kernels.vector_field import (vf_eval_attn,
                                                   vf_eval_attn_plain,
                                                   vf_eval_jasmin_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd_plain
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import (fast_distill_forward,
                                               make_fast_distill_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

from test_torch_dropout import (B, DROPS, H, N, N_PAD, NAMES, SCALER, SEED,
                                make_case, pad, port_masks, rel, twin,
                                torch_weights)
from test_torch_train_dropout import (assert_tree_close, seeds_of,
                                      twin_dropout, twin_eval)

RATES = dict(attn_drop=0.1, proj_drop=0.2, mlp_drop=0.3)
STUDENT = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=12.0,
               time_interval=1.0, num_eval_steps=8, solver="euler",
               register_tokens=2, **RATES)
TEACHER = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=12,
               num_heads=2, mlp_dim=64, num_classes=7)
RECIPE = dict(lambda_param=0.5, jasmin_k=2, temperature=3.0,
              use_kl_loss=False, mse_full_path=True)
LR = 1e-4
K = 2


@pytest.fixture(params=["kernel", "xla"])
def jax_route(request, twin_dropout, monkeypatch):
    """JAX's dropout routes through the twin; "xla": the route JAX takes
    where ``auto_block_b`` finds no backward tile (TS-Base in f32 at MLP
    ratio 4)."""
    def attn_dropout_from_params(x, vf_params, seed, *, num_heads, scaler,
                                 drops, **kw):
        return twin_eval(x, vf_params, seed, num_heads=num_heads,
                         scaler=scaler, drops=drops, want_attn=True)

    monkeypatch.setattr(jax_vf, "fused_vf_attn_dropout_from_params",
                        attn_dropout_from_params)
    if request.param == "xla":
        monkeypatch.setattr(jax_vf, "auto_block_b", lambda *a, **k: 0)
    return request.param


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


def test_forward_loss_and_gradients_match_jax(jax_route):
    jm, jt, params, tparams, tm, _, pixels, labels = setup(0)
    t_out = jt.apply({"params": tparams}, jnp.asarray(pixels))
    t_states, t_attn = t_out["hidden_states"][1:], t_out["attentions"][-1]
    key = jax.random.PRNGKey(3)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.fast_distill_forward(
            jm, p, jnp.asarray(pixels), jnp.asarray(labels), t_states,
            t_attn, supervise=True, rng=key, **RECIPE), has_aux=True))(params)
    tk = lambda a: torch.from_numpy(np.array(a))
    args = (tm, torch.from_numpy(pixels), torch.from_numpy(labels),
            tk(t_states), tk(t_attn))
    got, got_aux = fast_distill_forward(
        *args, supervise=True, step_seeds=seeds_of(key, 7), **RECIPE)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    for name, want in aux["metrics"].items():
        np.testing.assert_allclose(got_aux["metrics"][name].item(),
                                   float(want), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    assert_tree_close({n: p.grad for n, p in tm.named_parameters()}, grads,
                      atol=5e-5, rtol=5e-3)
    # dropout took part: the deterministic forward gives another loss
    tm.attn_drop = tm.proj_drop = tm.mlp_drop = 0.0
    with torch.no_grad():
        plain, _ = fast_distill_forward(*args, supervise=True, **RECIPE)
    assert abs(plain.item() - got.item()) > 1e-3 * abs(got.item())


_RUNS = {}


@pytest.fixture
def three_steps(jax_route):
    """Three steps of both packages with dropout from the same start and
    the same rng: the metrics of every step and the parameters after
    each (run once per JAX route)."""
    if jax_route not in _RUNS:
        _RUNS[jax_route] = _three_steps()
    return _RUNS[jax_route]


def _three_steps():
    jm, jt, params, tparams, tm, tt, pixels, labels = setup(1)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js = jax_state(params, tx)
    jstep = jax_steps.make_fast_distill_train_step(jm, jt, tx, donate=False,
                                                   **RECIPE)
    ts = create_train_state(tm, make_optimizer(LR))
    tstep = make_fast_distill_train_step(tm, tt, **RECIPE)
    jbatch = {"pixel_values": jnp.asarray(pixels),
              "labels": jnp.asarray(labels)}
    tbatch = {"pixel_values": torch.from_numpy(pixels),
              "labels": torch.from_numpy(labels)}
    before = dict(launch_counts)
    runs = {}
    for i in range(1, 4):
        js, jmet = jstep(js, tparams, jbatch, jax.random.PRNGKey(5),
                         supervise=True)
        ts, tmet = tstep(ts, tbatch, rng=5, supervise=True)
        runs[i] = (jmet, tmet, ts.step, jax.device_get(js.params),
                   {n: p.detach().clone() for n, p in tm.named_parameters()})
    assert launch_counts == before          # the CPU runs the plain path
    return runs


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_with_dropout_match_jax(three_steps, steps):
    for i in range(1, steps + 1):
        jmet, tmet = three_steps[i][:2]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        for name in ("mse_loss", "kl_loss", "jasmin_loss",
                     "supervision_loss", "acc", "nonfinite"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                       rtol=2e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
    _, _, step, jparams, tparams = three_steps[steps]
    assert step == steps
    assert_tree_close(tparams, jparams, atol=5e-5, rtol=5e-3)
    # each step drew new masks
    assert three_steps[1][1]["loss"] != three_steps[2][1]["loss"]


# --- the map mode and its cotangent with dropout (plain versions) --------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_map_mode_with_dropout_matches_the_twin(dtype):
    """f(x) with every mask, and the pre-dropout maps, zeros on padded
    query rows and keys."""
    x, w, _, _ = make_case(11)
    want_dx, want_p = twin(x, w, port_masks(), dtype)
    xt, wt = torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    dx, p = vf_eval_attn_plain(xt, wt, seed=SEED, drops=DROPS, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert dx.dtype == p.dtype == dtype
    assert rel(dx[:, :N].float().numpy(),
               np.asarray(want_dx.astype(jnp.float32))) <= tol
    assert rel(p[:, :, :N, :N].float().numpy(),
               np.asarray(want_p.astype(jnp.float32))) <= tol
    assert not p[:, :, N:].any() and not p[..., N:].any()
    # the map is the deterministic evaluation's; f(x) is not
    det_dx, det_p = vf_eval_attn_plain(xt, wt, **kw)
    assert torch.equal(p, det_p)
    assert rel(dx[:, :N].float().numpy(), det_dx[:, :N].float().numpy()) > tol


@pytest.mark.parametrize("with_jas", [False, True])
def test_map_cotangent_with_dropout_matches_the_twins_vjp(with_jas):
    """x_bar and the 8 cotangents with the maps' cotangent (and the JaSMin
    statistics' beside it), against jax.vjp of the twin fed the masks."""
    x, w, g, g_jas = make_case(12)
    if not with_jas:
        g_jas = np.zeros_like(g_jas)
    ga = np.random.default_rng(13).standard_normal(
        (B, H, N, N)).astype(np.float32)
    masks = tuple(jnp.asarray(m.numpy()) for m in port_masks())

    def f(x, *w):
        dx, p = _xla_reference(x, *w, num_heads=H, scaler=SCALER,
                               return_attn=True, masks=masks)
        return dx, p, jasmin_order_stats(p, K)

    _, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, w))
    want = vjp((jnp.asarray(g), jnp.asarray(ga), jnp.asarray(g_jas)))
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, seed=SEED, drops=DROPS)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    gap = np.zeros((B, H, N_PAD, N_PAD), np.float32)
    gap[:, :, :N, :N] = ga
    extra = {}
    if with_jas:
        _, _, idx = vf_eval_jasmin_plain(xt, wt, jas_k=K, **kw)
        extra = dict(g_jas=torch.from_numpy(pad(g_jas, 3)), jas_idx=idx)
    got = vf_bwd_plain(xt, wt, torch.from_numpy(pad(g)),
                       g_attn=torch.from_numpy(gap), **kw, **extra)
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-4, name
    assert not got[0].isnan().any()


def test_fused_vf_attn_with_dropout_matches_the_plain_backward():
    """FusedVFAttn with a seed on CPU tensors keeps the seed, not a mask:
    its gradients equal vf_bwd_plain's with the maps' cotangent and the
    same seed, and no kernel launch is counted."""
    x, w, _, _ = make_case(14)
    wt = torch_weights(w, torch.float32)
    params = [torch.from_numpy(a).requires_grad_(True) for a in w]
    xt = torch.from_numpy(pad(x)).requires_grad_(True)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N, seed=SEED, drops=DROPS)
    before = dict(launch_counts)
    dx, p = fused_vf_attn(xt, wt, params, **kw)
    ref_dx, ref_p = vf_eval_attn(xt.detach(), wt, **kw)
    assert torch.equal(dx, ref_dx) and torch.equal(p, ref_p)
    g = torch.randn(dx.shape, generator=torch.Generator().manual_seed(0))
    gp = torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
    ((dx * g).sum() + (p * gp).sum()).backward()
    assert launch_counts == before
    want = vf_bwd_plain(xt.detach(), wt, g, g_attn=gp, **kw)
    assert torch.allclose(xt.grad, want[0], rtol=1e-5, atol=1e-6)
    for q, b in zip(params, want[1:]):
        assert torch.allclose(q.grad, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [None, 99])
def test_map_mode_at_rates_0_is_the_deterministic_route(seed):
    x, w, g, _ = make_case(15)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    gap = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (B, H, N_PAD, N_PAD)).astype(np.float32))
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    zero = dict(seed=seed, drops=(0.0, 0.0, 0.0))
    for a, b in zip(vf_eval_attn_plain(xt, wt, **kw, **zero),
                    vf_eval_attn_plain(xt, wt, **kw)):
        assert torch.equal(a, b)
    gt = torch.from_numpy(pad(g))
    for a, b in zip(vf_bwd_plain(xt, wt, gt, g_attn=gap, **kw, **zero),
                    vf_bwd_plain(xt, wt, gt, g_attn=gap, **kw)):
        assert torch.equal(a, b)
    # nonzero rates without a seed raise, in the map mode too
    with pytest.raises(ValueError, match="seed"):
        vf_eval_attn(xt, wt, drops=DROPS, **kw)


# --- the struct the tiled kernels take ----------------------------------

def _c_fields(src: str, struct: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if line:
            kind, names = re.match(r"(.*?)(\w+(?:, \w+)*)$", line).groups()
            fields += [(n, kind.strip()) for n in names.split(", ")]
    return fields


def test_tiled_struct_carries_the_drop():
    """``tiled._Args`` ends with ``vf::Drop drop`` as the C ``TiledArgs``
    does, with the dropout scratch among its pointers, and
    ``dropout.Drop`` lists the fields of the C ``vf::Drop`` in order."""
    csrc = Path(tiled.__file__).resolve().parent.parent / "csrc"
    targs = _c_fields((csrc / "vector_field_tiled.cu").read_text(),
                      "TiledArgs")
    assert targs[-1] == ("drop", "vf::Drop")
    assert tiled._Args._fields_[-1] == ("drop", dropout.Drop)
    names = [n for n, _ in tiled._Args._fields_]
    assert names == [n for n, _ in targs]
    assert {"ao", "gd2", "base", "dt"} <= set(names)
    drop = _c_fields((csrc / "vector_field.cu").read_text(), "Drop")
    kinds = {"unsigned": ctypes.c_uint32, "float": ctypes.c_float}
    assert [(n, kinds[k]) for n, k in drop] == dropout.Drop._fields_
