"""The training kernels' plain versions against the JAX package.

``vf_eval_jasmin_plain`` (the JaSMin-statistics mode of the forward) is
held against ``fused_vf_jasmin`` and ``vf_bwd_plain`` (the backward)
against ``pallas_vf_bwd``, both Pallas kernels in interpret mode, and
against ``torch.autograd`` through ``vf_eval_plain``. The CUDA kernels
are held against these plain versions on the GPU by ``chip_smoke.py``.

Cases: random inputs; "ties", where six tokens are copies of one, so
their keys tie exactly in every attention row; "peaked" (bf16), with
large query/key weights, so rows saturate and the rounded p is exactly
1.0, where clip's subgradient is 0.5. (In float32 such scores, hundreds
wide, make p sensitive to the order of the q.k sums beyond 1e-5, so the
float32 cases are random and ties.)

Tolerances (max|got - want| over max|want|):
  * float32 forward, dx and statistics: 1e-5 (same operations, sums in
    another order);
  * float32 backward, the 9 cotangents: 1e-4 (long sums over rows and
    columns in another order, and the erf polynomial of the TPU kernel
    against exact erf);
  * bfloat16: 2 ulps of bf16 (2^-7) of the output scale, because an
    intermediate rounded to bf16 on each side can land on neighbouring
    values when the sums before it are taken in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import fused_vf_jasmin
from odevit_tpu.kernels.vector_field_bwd import pallas_vf_bwd
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.autograd import (fused_vf, fused_vf_jasmin
                                               as torch_fused_jasmin)
from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval_plain,
                                                   vf_eval_jasmin,
                                                   vf_eval_jasmin_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd, vf_bwd_plain

B, N, N_PAD, D, H, DH = 2, 19, 32, 32, 2, 64
SCALER = 4.0
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2")


def make_case(kind="random", seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D), f(D, D),
         f(D, DH), f(DH, D)]
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    if kind == "ties":
        x[:, 5:11] = x[:, 5:6]
    if kind == "peaked":
        w[4][:, :2 * D] *= 40.0
    return x, w


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:]))


def pad(a):
    return np.concatenate([a, np.zeros((B, N_PAD - N) + a.shape[2:],
                                       a.dtype)], axis=1)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jasmin_case(kind, k, dtype):
    x, w = make_case(kind, k)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    dx, st = fused_vf_jasmin(jnp.asarray(x, jdt), *map(jnp.asarray, w), H,
                             SCALER, 2, N, k)
    got = vf_eval_jasmin_plain(torch.from_numpy(pad(x)).to(dtype),
                               torch_weights(w, dtype), num_heads=H,
                               scaler=SCALER, n_real=N, jas_k=k)
    return (np.asarray(dx.astype(jnp.float32)), np.asarray(st)), got


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 10])
def test_jasmin_forward_matches_pallas_f32(kind, k):
    (dx, st), (got_dx, got_st, idx) = jasmin_case(kind, k, torch.float32)
    assert rel(got_dx[:, :N].numpy(), dx) <= 1e-5
    assert rel(got_st[..., :N].numpy(), st) <= 1e-5
    # padded query rows hold zeros; columns index real keys only
    assert not got_st[..., N:].any() and not idx[..., N:].any()
    assert int(idx.max()) < N


def test_jasmin_forward_matches_pallas_bf16():
    (dx, st), (got_dx, got_st, _) = jasmin_case("peaked", 10, torch.bfloat16)
    assert got_dx.dtype == torch.bfloat16
    assert rel(got_dx[:, :N].float().numpy(), dx) <= 2 ** -7
    assert rel(got_st[..., :N].numpy(), st) <= 2 ** -7
    # peaked heads: the rounded rows hold exactly 1.0
    assert (got_st[:, :, 0, :N] == 1.0).any()


def jax_bwd(x, w, g, g_jas=None, stats=None, k=0):
    bars = pallas_vf_bwd(jnp.asarray(x), *map(jnp.asarray, w),
                         jnp.asarray(g), num_heads=H, scaler=SCALER,
                         block_b=2, n_real=N, g_jas=g_jas, jas_k=k,
                         jas_stats=stats)
    return [np.asarray(b, np.float32) for b in bars]


def check_bars(got, want, tol):
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        a = a.float().detach().numpy() if torch.is_tensor(a) else a
        assert rel(a, b) <= tol, (name, rel(a, b))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("with_jas", [False, True])
def test_backward_matches_pallas_f32(kind, with_jas):
    x, w = make_case(kind, 3)
    rng = np.random.default_rng(4)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    kw = {}
    jkw = {}
    if with_jas:
        _, stats = fused_vf_jasmin(jnp.asarray(x), *map(jnp.asarray, w), H,
                                   SCALER, 2, N, 10)
        g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32)
        jkw = dict(g_jas=jnp.asarray(g_jas), stats=stats, k=10)
        _, _, idx = vf_eval_jasmin_plain(
            torch.from_numpy(pad(x)), torch_weights(w, torch.float32),
            num_heads=H, scaler=SCALER, n_real=N, jas_k=10)
        gj = np.zeros((B, H, 5, N_PAD), np.float32)
        gj[..., :N] = g_jas
        kw = dict(g_jas=torch.from_numpy(gj), jas_idx=idx)
    want = jax_bwd(x, w, g, **jkw)
    got = vf_bwd_plain(torch.from_numpy(pad(x)),
                       torch_weights(w, torch.float32),
                       torch.from_numpy(pad(g)), num_heads=H, scaler=SCALER,
                       n_real=N, **kw)
    check_bars(got, want, 1e-4)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_backward_matches_pallas_bf16(kind):
    """bf16; the peaked case carries a JaSMin cotangent, so the scatter
    meets rows whose rounded maximum is exactly 1.0."""
    x, w = make_case(kind, 5)
    rng = np.random.default_rng(6)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    jkw, kw = {}, {}
    if kind == "peaked":
        xb = torch.from_numpy(pad(x)).bfloat16()
        _, st, idx = vf_eval_jasmin_plain(
            xb, torch_weights(w, torch.bfloat16), num_heads=H,
            scaler=SCALER, n_real=N, jas_k=10)
        assert (st[:, :, 0, :N] == 1.0).any()
        g_jas = rng.standard_normal((B, H, 5, N_PAD)).astype(np.float32)
        g_jas[..., N:] = 0.0
        _, stats = fused_vf_jasmin(jnp.asarray(x, jnp.bfloat16),
                                   *map(jnp.asarray, w), H, SCALER, 2, N, 10)
        jkw = dict(g_jas=jnp.asarray(g_jas[..., :N]), jas_k=10,
                   jas_stats=stats)
        kw = dict(g_jas=torch.from_numpy(g_jas), jas_idx=idx)
    want = pallas_vf_bwd(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w),
                         jnp.asarray(g, jnp.bfloat16), num_heads=H,
                         scaler=SCALER, block_b=2, n_real=N, **jkw)
    want = [np.asarray(b.astype(jnp.float32)) for b in want]
    got = vf_bwd_plain(torch.from_numpy(pad(x)).bfloat16(),
                       torch_weights(w, torch.bfloat16),
                       torch.from_numpy(pad(g)).bfloat16(), num_heads=H,
                       scaler=SCALER, n_real=N, **kw)
    assert got[0].dtype == torch.bfloat16
    assert all(b.dtype == torch.float32 for b in got[1:])
    check_bars(got, want, 2 ** -7)


def autograd_reference(x, w, g, g_jas=None, idx=None):
    """Cotangents by torch.autograd through vf_eval_plain (and, with
    g_jas, through the statistics taken at the saved columns)."""
    xt = torch.from_numpy(pad(x)).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    vw = VFWeights(*wt)
    dx = vf_eval_plain(xt, vw, num_heads=H, scaler=SCALER, n_real=N)
    loss = (dx * torch.from_numpy(pad(g))).sum()
    if g_jas is not None:
        # the same p, differentiable: softmax over the real keys
        from odevit_tpu_torch.kernels.vector_field import _field_plain
        _, p = _field_plain(xt, vw, H, SCALER, N)
        p = p[..., :N, :N]
        taken = p.gather(-1, idx[..., :N].transpose(-1, -2).long())
        stats = torch.cat([taken.transpose(-1, -2),
                           p.clamp(1e-12, 1.0).sum(-1)[:, :, None]], 2)
        loss = loss + (stats * torch.from_numpy(g_jas)).sum()
    loss.backward()
    return [xt.grad[:, :N].numpy()] + [t.grad.numpy() for t in wt]


@pytest.mark.parametrize("with_jas", [False, True])
def test_backward_matches_autograd_f32(with_jas):
    x, w = make_case("random", 7)
    rng = np.random.default_rng(8)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    kw, g_jas, idx = {}, None, None
    if with_jas:
        _, _, idx = vf_eval_jasmin_plain(
            torch.from_numpy(pad(x)), torch_weights(w, torch.float32),
            num_heads=H, scaler=SCALER, n_real=N, jas_k=10)
        g_jas = rng.standard_normal((B, H, 5, N)).astype(np.float32)
        gj = np.zeros((B, H, 5, N_PAD), np.float32)
        gj[..., :N] = g_jas
        kw = dict(g_jas=torch.from_numpy(gj), jas_idx=idx)
    got = vf_bwd_plain(torch.from_numpy(pad(x)),
                       torch_weights(w, torch.float32),
                       torch.from_numpy(pad(g)), num_heads=H, scaler=SCALER,
                       n_real=N, **kw)
    check_bars(got, autograd_reference(x, w, g, g_jas, idx), 1e-4)


def test_padded_rows_reach_no_cotangent():
    x, w = make_case("random", 9)
    g = np.random.default_rng(10).standard_normal((B, N, D)).astype(
        np.float32)
    wt = torch_weights(w, torch.float32)
    xc, gc = torch.from_numpy(pad(x)), torch.from_numpy(pad(g))
    xd, gd = xc.clone(), gc.clone()
    xd[:, N:N + 3] = float("nan")
    xd[:, N + 3:] = 1e30
    gd[:, N:] = 7.0
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    clean = vf_bwd(xc, wt, gc, **kw)
    dirty = vf_bwd(xd, wt, gd, **kw)
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)
    assert not clean[0][:, N:].any()


def test_autograd_functions_match_plain_backward():
    """FusedVF / FusedVFJasmin on CPU tensors: gradients arrive in
    float32 on the float32 parameters, equal to vf_bwd_plain's, and no
    kernel launch is counted."""
    x, w = make_case("ties", 11)
    wt = torch_weights(w, torch.float32)
    params = [torch.from_numpy(a).requires_grad_(True) for a in w]
    xt = torch.from_numpy(pad(x)).requires_grad_(True)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    before = dict(launch_counts)
    dx = fused_vf(xt, wt, params, **kw)
    dxj, st = torch_fused_jasmin(xt, wt, params, jas_k=10, **kw)
    g = torch.randn(dx.shape, generator=torch.Generator().manual_seed(0))
    gj = torch.randn(st.shape, generator=torch.Generator().manual_seed(1))
    ((dx + dxj) * g).sum().add((st * gj).sum()).backward()
    assert launch_counts == before
    _, _, idx = vf_eval_jasmin(xt.detach(), wt, jas_k=10, **kw)
    a = vf_bwd_plain(xt.detach(), wt, g, **kw)
    b = vf_bwd_plain(xt.detach(), wt, g, g_jas=gj, jas_idx=idx, **kw)
    assert torch.allclose(xt.grad, a[0] + b[0], rtol=1e-5, atol=1e-6)
    for p, ga, gb in zip(params, a[1:], b[1:]):
        assert p.grad.dtype == torch.float32
        assert torch.allclose(p.grad, ga + gb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["shape", "jas_pair", "jas_shape"])
def test_bad_backward_arguments_raise(bad):
    x, w = make_case("random", 12)
    xt = torch.from_numpy(pad(x))
    g = torch.zeros_like(xt)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    if bad == "shape":
        g = g[:, :-16]
    elif bad == "jas_pair":
        kw["g_jas"] = torch.zeros(B, H, 5, N_PAD)
    else:
        kw["g_jas"] = torch.zeros(B, H, 5, N)
        kw["jas_idx"] = torch.zeros(B, H, 4, N, dtype=torch.int32)
    with pytest.raises(ValueError):
        vf_bwd(xt, torch_weights(w, torch.float32), g, **kw)
