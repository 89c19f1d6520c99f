"""Residual stashing: the port's stash forward, resid backwards and fused
steps with ``stash=True`` against the JAX package, on the CPU.

JAX's side runs as its own stash tests run it (``tests/test_kernel_bwd.py``:
D=64, 2 heads, 17 tokens): ``_pallas_forward(..., emit_resid=True)``,
``pallas_vf_bwd`` and ``_pallas_vf_bwd_split`` with ``resid_qkv`` /
``resid_h1``, Pallas in interpret mode, and the fused steps with
``stash=True``. The port's side runs the plain versions of its kernels
(the CPU launches nothing).

  * the stash forward (dx, rqkv, rh1), plain and JaSMin (k=2), in f32 and
    bf16, against ``_pallas_forward``'s; the residuals in JAX's padded
    2-D row layout (17 tokens padded to 32, zeros in x's padded rows);
  * the combined backward reading JAX's residuals, ± the JaSMin
    cotangent, against ``pallas_vf_bwd`` given the same residuals;
  * the split pair (dh=256, B=16, JAX's tiles (8, 128, 8)) reading JAX's
    residuals against ``_pallas_vf_bwd_split``; in both, the residuals
    are scaled by 1 + U(-1/2, 1/2) first, the same on both sides, so a
    backward that recomputed instead of reading them would disagree (with
    the JaSMin cotangent rh1 only: JAX finds the statistics' columns by
    matching the recomputed p against the forward's statistics, the port
    keeps the columns, and a changed rqkv changes p);
  * one step of ``make_fast_free_train_step(stash=True)`` and of
    ``make_fast_distill_train_step(stash=True)`` against JAX's, from the
    same weights (``from_jax_params``);
  * in f32, stash against recompute (``FusedVFStash`` against ``FusedVF``,
    and whole steps), within JAX's own tolerance for that (atol / rtol
    1e-5, ``test_stash_bwd_matches_plain``);
  * the flag ignored, not raised, where JAX ignores it (dropout, L2
    attention, the map route): the step is bit-identical to
    ``stash=False`` and no stash Function runs.

Tolerances (max|got - want| over max|want|, as
``tests/test_torch_split_bwd.py`` states them): float32 1e-4 (long sums
in another order; the TPU kernel's erf polynomial against exact erf),
bfloat16 2 ulps (2^-7) of the output scale. In bf16 the stash backward
rounds h1 once more than a recompute, the same rounding on both sides
here. The steps keep ``tests/test_torch_train.py``'s and
``tests/test_torch_distill.py``'s tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import _pallas_forward
from odevit_tpu.kernels.vector_field_bwd import (_pallas_vf_bwd_split,
                                                 pallas_vf_bwd)
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.teacher.vit import ViTTeacher as JaxTeacher
from odevit_tpu.train.fast_steps import (
    make_fast_distill_train_step as jax_make_distill,
    make_fast_free_train_step as jax_make_free)
from odevit_tpu.train.state import (all_trainable, create_train_state
                                    as jax_state, make_optimizer
                                    as jax_optimizer)
import odevit_tpu_torch.kernels.autograd as port_autograd
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.autograd import fused_vf, fused_vf_jasmin
from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval,
                                                   vf_eval_jasmin,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd
from odevit_tpu_torch.kernels.vector_field_bwd_split import (
    vf_bwd_attn_plain, vf_bwd_mlp_plain, vf_bwd_split)
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import (make_fast_distill_train_step,
                                               make_fast_free_train_step)
from odevit_tpu_torch.train.state import create_train_state, make_optimizer

B, N, N_PAD, D, H = 4, 17, 32, 64, 2
SCALER = 3.0
K = 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
DTYPES = [torch.float32, torch.bfloat16]
IDS = ["f32", "bf16"]
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2")


def make_case(seed, b=B, dh=2 * D):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D) * 0.6,
         f(D, D) * 0.6, f(D, dh) * 0.6, f(dh, D) * 0.3]
    x = rng.standard_normal((b, N, D)).astype(np.float32)
    g = rng.standard_normal((b, N, D)).astype(np.float32)
    g_jas = rng.standard_normal((b, H, 5, N)).astype(np.float32) * 0.1
    return x, w, g, g_jas


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:]))


def pad(a, axes=(1,)):
    width = [(0, 0)] * a.ndim
    for ax in axes:
        width[ax] = (0, N_PAD - N)
    return np.pad(a, width)


def f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def perturbed(resid, seed):
    """The residuals scaled by 1 + U(-1/2, 1/2), in their dtype: no longer
    what a recompute gives."""
    rng = np.random.default_rng(seed)
    return tuple((r.astype(jnp.float32) * jnp.asarray(
        1.0 + rng.uniform(-0.5, 0.5, r.shape), jnp.float32)).astype(r.dtype)
        for r in resid)


def rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def to_torch(a, dtype):
    return torch.from_numpy(f32(a)).to(dtype)


_jax_forward = jax.jit(_pallas_forward, static_argnames=(
    "num_heads", "scaler", "block_b", "n_real", "jas_kk", "emit_resid"))


def jax_stash_forward(x, w, dtype, jas: bool):
    """JAX's stash forward: (dx, [stats,] (rqkv, rh1))."""
    return _jax_forward(jnp.asarray(x, jdtype(dtype)), *map(jnp.asarray, w),
                        num_heads=H, scaler=SCALER, block_b=2, n_real=N,
                        jas_kk=K + 1 if jas else 0, emit_resid=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["plain", "jasmin"])
def test_stash_forward_matches_jax(mode, dtype):
    x, w, _, _ = make_case(0)
    want = jax_stash_forward(x, w, dtype, mode == "jasmin")
    tx, tw = torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    if mode == "plain":
        dx, (rqkv, rh1) = vf_eval_plain(tx, tw, stash=True, **kw)
        ref = vf_eval_plain(tx, tw, **kw)
        want_dx, (want_q, want_h1) = want
    else:
        dx, stats, _, (rqkv, rh1) = vf_eval_jasmin_plain(
            tx, tw, jas_k=K, stash=True, **kw)
        ref = vf_eval_jasmin_plain(tx, tw, jas_k=K, **kw)[0]
        want_dx, want_stats, (want_q, want_h1) = want
        assert rel(stats[..., :N], f32(want_stats)) <= TOL[dtype]
    # f(x) is that of the evaluation without the stash
    assert torch.equal(dx, ref)
    assert (rqkv.dtype, rh1.dtype) == (dtype, dtype)
    assert tuple(rqkv.shape) == (B * N_PAD, 3 * D) == want_q.shape
    assert tuple(rh1.shape) == (B * N_PAD, 2 * D) == want_h1.shape
    assert rel(dx[:, :N], f32(want_dx)) <= TOL[dtype]
    # every row, padded ones too: x's padded rows are zeros on both sides
    assert rel(rqkv, f32(want_q)) <= TOL[dtype]
    assert rel(rh1, f32(want_h1)) <= TOL[dtype]


_jax_bwd = jax.jit(pallas_vf_bwd, static_argnames=(
    "num_heads", "scaler", "block_b", "n_real", "jas_k"))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("cotangent", ["dx", "jas"])
def test_resid_bwd_matches_jax(cotangent, dtype):
    """The combined backward given JAX's residuals, against
    ``pallas_vf_bwd`` given the same."""
    x, w, g, g_jas = make_case(1)
    jas = cotangent == "jas"
    out = jax_stash_forward(x, w, dtype, jas)
    rqkv, rh1 = perturbed(out[-1], 11)
    if jas:
        rqkv = out[-1][0]
    jdt = jdtype(dtype)
    jkw = dict(g_jas=jnp.asarray(g_jas), jas_k=K, jas_stats=out[1]) \
        if jas else {}
    want = _jax_bwd(jnp.asarray(x, jdt), *map(jnp.asarray, w),
                    jnp.asarray(g, jdt), num_heads=H, scaler=SCALER,
                    block_b=2, n_real=N, resid_qkv=rqkv, resid_h1=rh1,
                    **jkw)
    tx, tw = torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype)
    tkw = {}
    if jas:
        idx = vf_eval_jasmin_plain(tx, tw, num_heads=H, scaler=SCALER,
                                   n_real=N, jas_k=K)[2]
        tkw = dict(g_jas=torch.from_numpy(pad(g_jas, (3,))), jas_idx=idx)
    got = vf_bwd(tx, tw, torch.from_numpy(pad(g)).to(dtype), num_heads=H,
                 scaler=SCALER, n_real=N, resid_qkv=to_torch(rqkv, dtype),
                 resid_h1=to_torch(rh1, dtype), **tkw)
    assert got[0].dtype == dtype and not got[0][:, N:].any()
    for name, a, b in zip(NAMES, (got[0][:, :N], *got[1:]), want):
        assert rel(a, f32(b)) <= TOL[dtype], (name, rel(a, f32(b)))


_jax_split = jax.jit(_pallas_vf_bwd_split, static_argnames=(
    "tiles", "num_heads", "scaler", "n_real"))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_resid_split_matches_jax(dtype):
    """The split pair given JAX's residuals (dh=256 in two 128-column
    chunks, B=16), each half's own cotangents and the pair's, against
    ``_pallas_vf_bwd_split`` given the same."""
    b, dh = 16, 256
    x, w, g, _ = make_case(2, b=b, dh=dh)
    jdt = jdtype(dtype)
    _, resid = _jax_forward(
        jnp.asarray(x, jdt), *map(jnp.asarray, w), num_heads=H,
        scaler=SCALER, block_b=4, n_real=N, emit_resid=True)
    rqkv, rh1 = perturbed(resid, 12)
    want = _jax_split(jnp.asarray(x, jdt), *map(jnp.asarray, w),
                      jnp.asarray(g, jdt), None, tiles=(8, 128, 8),
                      num_heads=H, scaler=SCALER, n_real=N,
                      resid_qkv=rqkv, resid_h1=rh1)
    want = dict(zip(NAMES, want))
    tx, tw = torch.from_numpy(pad(x)).to(dtype), torch_weights(w, dtype)
    tg = torch.from_numpy(pad(g)).to(dtype)
    tq, th = to_torch(rqkv, dtype), to_torch(rh1, dtype)
    tol = TOL[dtype]
    xbar_m, *mlp = vf_bwd_mlp_plain(tx, tw, tg, scaler=SCALER, n_real=N,
                                    resid_h1=th)
    for name, got in zip(("w1", "w2", "norm_mlp_scale", "norm_mlp_bias"),
                         mlp):
        assert rel(got, f32(want[name])) <= tol, name
    xbar, *attn = vf_bwd_attn_plain(tx, tw, tg, xbar_m, num_heads=H,
                                    scaler=SCALER, n_real=N, resid_qkv=tq)
    for name, got in zip(("x", "norm_attn_scale", "norm_attn_bias", "wqkv",
                          "wout"), (xbar[:, :N], *attn)):
        assert rel(got, f32(want[name])) <= tol, name
    bars = vf_bwd_split(tx, tw, tg, num_heads=H, scaler=SCALER, n_real=N,
                        resid_qkv=tq, resid_h1=th)
    for name, got in zip(NAMES, (bars[0][:, :N], *bars[1:])):
        assert rel(got, f32(want[name])) <= tol, name


@pytest.mark.parametrize("mode", ["plain", "jasmin"])
def test_stash_equals_recompute_f32(mode):
    """``FusedVFStash`` / ``FusedVFJasminStash`` against ``FusedVF`` /
    ``FusedVFJasmin`` in f32: values and every gradient within atol / rtol
    1e-5 (JAX's ``test_stash_bwd_matches_plain``)."""
    x, w, _, _ = make_case(3)
    grads = {}
    for stash in (False, True):
        tx = torch.from_numpy(pad(x)).requires_grad_()
        params = [torch.from_numpy(a).requires_grad_() for a in w]
        tw = VFWeights(*(p.detach() for p in params))
        kw = dict(num_heads=H, scaler=2.0, n_real=N, stash=stash)
        if mode == "plain":
            out = fused_vf(tx, tw, params, **kw)
            loss = torch.sin(out[:, :N]).sum()
        else:
            dx, st = fused_vf_jasmin(tx, tw, params, jas_k=K, **kw)
            loss = ((dx[:, :N] ** 2).sum()
                    + torch.log(st[..., :N] + 1e-3).sum())
        loss.backward()
        grads[stash] = [loss.detach(), tx.grad] + [p.grad for p in params]
    for name, a, b in zip(("loss",) + NAMES, grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_stash_rejects_what_jax_lacks():
    """The stash exists for the deterministic softmax plain and JaSMin
    modes; its residuals come as a pair of the right shapes."""
    x, w, g, _ = make_case(4)
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    with pytest.raises(ValueError, match="stash"):
        vf_eval(tx, tw, mode="euler", dt=0.1, stash=True, **kw)
    with pytest.raises(ValueError, match="stash"):
        vf_eval(tx, tw, seed=1, drops=(0.1, 0.0, 0.0), stash=True, **kw)
    l2 = tw._replace(qkv_bias=torch.zeros(3 * D), out_bias=torch.zeros(D))
    with pytest.raises(ValueError, match="stash"):
        vf_eval_jasmin(tx, l2, jas_k=K, stash=True, **kw)
    _, (rqkv, rh1) = vf_eval(tx, tw, stash=True, **kw)
    tg = torch.from_numpy(pad(g))
    with pytest.raises(ValueError, match="pair"):
        vf_bwd(tx, tw, tg, resid_qkv=rqkv, **kw)
    with pytest.raises(ValueError, match="shape"):
        vf_bwd(tx, tw, tg, resid_qkv=rqkv[:-1], resid_h1=rh1, **kw)
    with pytest.raises(ValueError, match="deterministic"):
        vf_bwd(tx, tw, tg, resid_qkv=rqkv, resid_h1=rh1, seed=1,
               drops=(0.0, 0.0, 0.1), **kw)


def test_cpu_stash_counts_no_launch():
    x, w, g, _ = make_case(5)
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    before = dict(launch_counts)
    _, (rqkv, rh1) = vf_eval(tx, tw, stash=True, **kw)
    vf_bwd(tx, tw, torch.from_numpy(pad(g)), resid_qkv=rqkv, resid_h1=rh1,
           **kw)
    assert launch_counts == before


# --- the fused steps --------------------------------------------------------

FREE = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
            mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
            num_eval_steps=4, solver="rk4", register_tokens=2)
STUDENT = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=12.0,
               time_interval=1.0, num_eval_steps=7, solver="euler",
               register_tokens=2)
TEACHER = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=12,
               num_heads=2, mlp_dim=64, num_classes=7)
DISTILL = dict(lambda_param=0.5, jasmin_k=2, mse_full_path=True,
               use_distillation=True, temperature=30.0, use_kl_loss=False)
LR = 1e-4


def batch(seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    return pixels, rng.integers(0, 7, 8)


def free_model(params, cfg):
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    return tm


def assert_params_close(tm, want_tree, atol, rtol):
    want_sd = from_jax_params(jax.device_get(want_tree))
    got_sd = {n: p.detach() for n, p in tm.named_parameters()}
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


class StashSpy:
    """Counts the stash Functions' runs (``fused_vf`` and
    ``fused_vf_jasmin`` look them up at every call)."""

    def __init__(self, monkeypatch):
        self.calls = {"FusedVFStash": 0, "FusedVFJasminStash": 0}
        for name in self.calls:
            real = getattr(port_autograd, name)
            spy = type(name, (real,), {})

            def apply(*a, _name=name, _real=real):
                self.calls[_name] += 1
                return _real.apply(*a)

            spy.apply = staticmethod(apply)
            monkeypatch.setattr(port_autograd, name, spy)


def test_free_step_stash_matches_jax(monkeypatch):
    """One step of the free step with ``stash=True`` against JAX's (rk4 on
    4 points: 8 plain evaluations and 4 JaSMin ones, all stashing), with
    ``tests/test_torch_train.py``'s tolerances."""
    pixels, labels = batch(0)
    jm = JaxViTODE(**FREE)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js, jmet = jax_make_free(jm, tx, jasmin_k=10, donate=False, stash=True)(
        jax_state(params, tx), {"pixel_values": jnp.asarray(pixels),
                                "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    tm = free_model(params, FREE)
    spy = StashSpy(monkeypatch)
    ts, tmet = make_fast_free_train_step(tm, jasmin_k=10, stash=True)(
        create_train_state(tm, make_optimizer(LR)),
        {"pixel_values": torch.from_numpy(pixels),
         "labels": torch.from_numpy(labels)})
    assert spy.calls == {"FusedVFStash": 8, "FusedVFJasminStash": 4}
    for key, rtol in (("loss", 1e-4), ("jasmin_loss", 1e-4),
                      ("grad_norm", 1e-2)):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=rtol, err_msg=key)
    assert float(tmet["acc"]) == float(jmet["acc"])
    assert_params_close(tm, js.params, atol=5e-5, rtol=5e-3)


def distill_setup(seed, **rates):
    pixels, labels = batch(seed)
    jm, jt = JaxViTODE(**STUDENT, **rates), JaxTeacher(**TEACHER)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tparams = jt.init(jax.random.PRNGKey(1), jnp.asarray(pixels))["params"]
    tm = free_model(params, dict(STUDENT, **rates))
    tt = ViTTeacher(**TEACHER, device="cpu")
    tt.load_state_dict(from_jax_params(jax.device_get(tparams)))
    return jm, jt, params, tparams, tm, tt, pixels, labels


def test_distill_step_stash_matches_jax(monkeypatch):
    """One distillation step with ``stash=True`` against JAX's (Euler on 7
    points: 5 stashing evaluations, the JaSMin ones among them, and the
    final map evaluation without the stash), with
    ``tests/test_torch_distill.py``'s tolerances."""
    jm, jt, params, tparams, tm, tt, pixels, labels = distill_setup(3)
    tx = jax_optimizer(LR, trainable_mask=all_trainable(params))
    js, jmet = jax_make_distill(jm, jt, tx, donate=False, stash=True,
                                **DISTILL)(
        jax_state(params, tx), tparams,
        {"pixel_values": jnp.asarray(pixels), "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(2), supervise=True)
    spy = StashSpy(monkeypatch)
    ts, tmet = make_fast_distill_train_step(tm, tt, stash=True, **DISTILL)(
        create_train_state(tm, make_optimizer(LR)),
        {"pixel_values": torch.from_numpy(pixels),
         "labels": torch.from_numpy(labels)}, supervise=True)
    assert sum(spy.calls.values()) == 5
    for key in ("loss", "mse_loss", "kl_loss", "jasmin_loss",
                "supervision_loss", "acc", "nonfinite"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-2)
    assert_params_close(tm, js.params, atol=5e-5, rtol=5e-3)


def run_free(tm, pixels, labels, stash, jasmin_k=10, rng=None):
    ts = create_train_state(tm, make_optimizer(LR))
    ts, met = make_fast_free_train_step(tm, jasmin_k=jasmin_k, stash=stash)(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)}, rng=rng)
    return met, {n: p.detach().clone() for n, p in tm.named_parameters()}


def run_distill(tm, tt, pixels, labels, stash, jasmin_k=2, rng=None):
    ts = create_train_state(tm, make_optimizer(LR))
    ts, met = make_fast_distill_train_step(
        tm, tt, stash=stash, **dict(DISTILL, jasmin_k=jasmin_k))(
        ts, {"pixel_values": torch.from_numpy(pixels),
             "labels": torch.from_numpy(labels)}, rng=rng, supervise=True)
    return met, {n: p.detach().clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("step", ["free", "distill"])
def test_step_stash_equals_recompute_f32(step):
    """The whole step with and without the stash, from the same weights,
    in f32: metrics and updated parameters within atol / rtol 1e-5."""
    if step == "free":
        pixels, labels = batch(6)
        params = JaxViTODE(**FREE).init(jax.random.PRNGKey(6),
                                        jnp.asarray(pixels))["params"]
        runs = [run_free(free_model(params, FREE), pixels, labels, s)
                for s in (False, True)]
    else:
        _, _, params, _, tm, tt, pixels, labels = distill_setup(7)
        runs = [run_distill(free_model(params, STUDENT), tt, pixels, labels,
                            s) for s in (False, True)]
    (met0, sd0), (met1, sd1) = runs
    for key in met0:
        np.testing.assert_allclose(float(met1[key]), float(met0[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    for name in sd0:
        np.testing.assert_allclose(sd1[name].numpy(), sd0[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


RATES = dict(attn_drop=0.1, proj_drop=0.1, mlp_drop=0.1)
# Euler on 3 points: every evaluation lies in the JaSMin window, so on a
# sequence too short for the statistics (k=19 on 19 tokens) every one
# takes the map route
MAP_GRID = dict(num_eval_steps=3, solver="euler")


@pytest.mark.parametrize("case", ["free-dropout", "free-l2", "free-map",
                                  "distill-dropout", "distill-map"])
def test_stash_ignored_where_jax_ignores_it(case, monkeypatch):
    """Dropout, L2 attention and the map route take no stash in JAX: the
    port's step with ``stash=True`` is bit-identical to ``stash=False``,
    raises nothing and runs no stash Function."""
    step, kind = case.split("-")
    extra = {"dropout": RATES, "l2": dict(l2_attention=True),
             "map": MAP_GRID}[kind]
    rng = 5 if kind == "dropout" else None
    jasmin_k = 19 if kind == "map" else None
    if step == "free":
        cfg = dict(FREE, **extra)
        pixels, labels = batch(8)
        params = JaxViTODE(**cfg).init(jax.random.PRNGKey(8),
                                       jnp.asarray(pixels))["params"]

        def run(stash):
            return run_free(free_model(params, cfg), pixels, labels, stash,
                            jasmin_k=jasmin_k or 10, rng=rng)
    else:
        cfg = dict(STUDENT, **extra)
        pixels, labels = batch(9)
        params = JaxViTODE(**cfg).init(jax.random.PRNGKey(9),
                                       jnp.asarray(pixels))["params"]
        tt = distill_setup(9)[5]

        def run(stash):
            return run_distill(free_model(params, cfg), tt, pixels, labels,
                               stash, jasmin_k=jasmin_k or 2, rng=rng)
    want_met, want_sd = run(False)
    spy = StashSpy(monkeypatch)
    got_met, got_sd = run(True)
    assert spy.calls == {"FusedVFStash": 0, "FusedVFJasminStash": 0}
    assert set(got_met) == set(want_met)
    for key in want_met:
        assert torch.equal(got_met[key], want_met[key]), key
    for name in want_sd:
        assert torch.equal(got_sd[name], want_sd[name]), name
