"""The attention-map mode of the fused evaluation and the map cotangent of
its backward, in their plain versions, against the JAX package.

``vf_eval_attn_plain`` is held against ``fused_vf_attn`` (Pallas, interpret
mode) in bfloat16 and against ``_xla_reference(return_attn=True)`` in
float32; ``vf_bwd_plain`` with ``g_attn`` (and with ``g_attn`` and the
JaSMin cotangent) against ``pallas_vf_bwd(..., g_attn)`` and against
``jax.vjp`` of ``_xla_reference``. The CUDA kernels of the tiled route are
held against these plain versions on the GPU by ``chip_smoke.py``.

Tolerances (max|got - want| over max|want|), as in
``tests/test_torch_train_kernels.py``: float32 forward 1e-5, float32
backward 1e-4 (long sums in another order, the TPU kernel's erf
polynomial), bfloat16 2 ulps (2^-7) of the output scale.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import _xla_reference, fused_vf_attn
from odevit_tpu.kernels.vector_field import fused_vf_jasmin
from odevit_tpu.kernels.vector_field_bwd import pallas_vf_bwd
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels import tiled
from odevit_tpu_torch.kernels.autograd import fused_vf_attn as torch_attn
from odevit_tpu_torch.kernels.vector_field import (vf_eval_attn,
                                                   vf_eval_attn_plain,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import vf_bwd, vf_bwd_plain

from test_torch_train_kernels import (B, D, H, N, N_PAD, SCALER,
                                      check_bars, make_case, pad, rel,
                                      torch_weights)


def pad_map(a):
    out = np.zeros(a.shape[:2] + (N_PAD, N_PAD), a.dtype)
    out[:, :, :N, :N] = a
    return out


def test_attn_forward_matches_xla_reference_f32():
    x, w = make_case("random", 20)
    dx, p = _xla_reference(jnp.asarray(x), *map(jnp.asarray, w),
                           num_heads=H, scaler=SCALER, n_real=N,
                           return_attn=True)
    got_dx, got_p = vf_eval_attn_plain(torch.from_numpy(pad(x)),
                                       torch_weights(w, torch.float32),
                                       num_heads=H, scaler=SCALER, n_real=N)
    assert tuple(got_p.shape) == (B, H, N_PAD, N_PAD)
    assert rel(got_dx[:, :N].numpy(), np.asarray(dx)) <= 1e-5
    assert rel(got_p[:, :, :N, :N].numpy(), np.asarray(p)) <= 1e-5
    # padded query rows and padded keys hold zeros; real rows sum to 1
    assert not got_p[:, :, N:].any() and not got_p[..., N:].any()
    np.testing.assert_allclose(got_p[:, :, :N].sum(-1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_attn_forward_matches_pallas_bf16(kind):
    x, w = make_case(kind, 21)
    dx, p = fused_vf_attn(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w),
                          H, SCALER, 2, N)
    got_dx, got_p = vf_eval_attn_plain(
        torch.from_numpy(pad(x)).bfloat16(), torch_weights(w, torch.bfloat16),
        num_heads=H, scaler=SCALER, n_real=N)
    assert got_p.dtype == torch.bfloat16
    assert rel(got_dx[:, :N].float().numpy(),
               np.asarray(dx.astype(jnp.float32))) <= 2 ** -7
    assert rel(got_p[:, :, :N, :N].float().numpy(),
               np.asarray(p.astype(jnp.float32))) <= 2 ** -7


def attn_cotangents(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    ga = (rng.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    return g, ga


@pytest.mark.parametrize("with_jas", [False, True])
def test_attn_backward_matches_pallas_f32(with_jas):
    x, w = make_case("ties", 22)
    g, ga = attn_cotangents(23)
    jkw, kw = {}, {}
    if with_jas:
        _, stats = fused_vf_jasmin(jnp.asarray(x), *map(jnp.asarray, w), H,
                                   SCALER, 2, N, 10)
        g_jas = np.random.default_rng(24).standard_normal(
            (B, H, 5, N)).astype(np.float32)
        jkw = dict(g_jas=jnp.asarray(g_jas), jas_k=10, jas_stats=stats)
        _, _, idx = vf_eval_jasmin_plain(
            torch.from_numpy(pad(x)), torch_weights(w, torch.float32),
            num_heads=H, scaler=SCALER, n_real=N, jas_k=10)
        gj = np.zeros((B, H, 5, N_PAD), np.float32)
        gj[..., :N] = g_jas
        kw = dict(g_jas=torch.from_numpy(gj), jas_idx=idx)
    want = pallas_vf_bwd(jnp.asarray(x), *map(jnp.asarray, w),
                         jnp.asarray(g), jnp.asarray(ga), num_heads=H,
                         scaler=SCALER, block_b=2, n_real=N, **jkw)
    got = vf_bwd_plain(torch.from_numpy(pad(x)),
                       torch_weights(w, torch.float32),
                       torch.from_numpy(pad(g)), num_heads=H, scaler=SCALER,
                       n_real=N, g_attn=torch.from_numpy(pad_map(ga)), **kw)
    check_bars(got, [np.asarray(b, np.float32) for b in want], 1e-4)


def test_attn_backward_matches_jax_vjp_f32():
    x, w = make_case("random", 25)
    g, ga = attn_cotangents(26)
    _, vjp = jax.vjp(
        lambda *a: _xla_reference(*a, num_heads=H, scaler=SCALER, n_real=N,
                                  return_attn=True),
        jnp.asarray(x), *map(jnp.asarray, w))
    want = vjp((jnp.asarray(g), jnp.asarray(ga)))
    got = vf_bwd_plain(torch.from_numpy(pad(x)),
                       torch_weights(w, torch.float32),
                       torch.from_numpy(pad(g)), num_heads=H, scaler=SCALER,
                       n_real=N, g_attn=torch.from_numpy(pad_map(ga)))
    check_bars(got, [np.asarray(b, np.float32) for b in want], 1e-4)


def test_attn_backward_matches_pallas_bf16():
    x, w = make_case("peaked", 27)
    g, ga = attn_cotangents(28)
    want = pallas_vf_bwd(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w),
                         jnp.asarray(g, jnp.bfloat16),
                         jnp.asarray(ga, jnp.bfloat16), num_heads=H,
                         scaler=SCALER, block_b=2, n_real=N)
    got = vf_bwd_plain(torch.from_numpy(pad(x)).bfloat16(),
                       torch_weights(w, torch.bfloat16),
                       torch.from_numpy(pad(g)).bfloat16(), num_heads=H,
                       scaler=SCALER, n_real=N,
                       g_attn=torch.from_numpy(pad_map(ga)).bfloat16())
    check_bars(got, [np.asarray(b.astype(jnp.float32)) for b in want],
               2 ** -7)


def test_padded_map_cotangent_reaches_nothing():
    """NaN and garbage in the padded rows and columns of the map's
    cotangent (and in the padded rows of x and g) change no cotangent."""
    x, w = make_case("random", 29)
    g, ga = attn_cotangents(30)
    wt = torch_weights(w, torch.float32)
    xc, gc = torch.from_numpy(pad(x)), torch.from_numpy(pad(g))
    gac = torch.from_numpy(pad_map(ga))
    xd, gd, gad = xc.clone(), gc.clone(), gac.clone()
    xd[:, N:] = float("nan")
    gd[:, N:] = 7.0
    gad[:, :, N:] = float("nan")
    gad[..., N:] = 1e30
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    clean = vf_bwd(xc, wt, gc, g_attn=gac, **kw)
    dirty = vf_bwd(xd, wt, gd, g_attn=gad, **kw)
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)
    assert not clean[0][:, N:].any()


def test_fused_vf_attn_function_matches_plain_backward():
    """FusedVFAttn on CPU tensors: gradients in float32 on the float32
    parameters, equal to vf_bwd_plain's with the maps' cotangent, and no
    kernel launch counted."""
    x, w = make_case("ties", 31)
    wt = torch_weights(w, torch.float32)
    params = [torch.from_numpy(a).requires_grad_(True) for a in w]
    xt = torch.from_numpy(pad(x)).requires_grad_(True)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    before = dict(launch_counts)
    dx, p = torch_attn(xt, wt, params, **kw)
    ref_dx, ref_p = vf_eval_attn(xt.detach(), wt, **kw)
    assert torch.equal(dx, ref_dx) and torch.equal(p, ref_p)
    g = torch.randn(dx.shape, generator=torch.Generator().manual_seed(0))
    gp = torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
    ((dx * g).sum() + (p * gp).sum()).backward()
    assert launch_counts == before
    want = vf_bwd_plain(xt.detach(), wt, g, g_attn=gp, **kw)
    assert torch.allclose(xt.grad, want[0], rtol=1e-5, atol=1e-6)
    for q, b in zip(params, want[1:]):
        assert q.grad.dtype == torch.float32
        assert torch.allclose(q.grad, b, rtol=1e-5, atol=1e-6)


def test_attn_forward_equals_plain_evaluation():
    x, w = make_case("random", 32)
    xt, wt = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    dx, _ = vf_eval_attn_plain(xt, wt, **kw)
    assert torch.equal(dx, vf_eval_plain(xt, wt, **kw))


def test_bad_map_cotangent_raises():
    x, w = make_case("random", 33)
    xt = torch.from_numpy(pad(x))
    with pytest.raises(ValueError, match="g_attn"):
        vf_bwd(xt, torch_weights(w, torch.float32), torch.zeros_like(xt),
               num_heads=H, scaler=SCALER, n_real=N,
               g_attn=torch.zeros(B, H, N, N))


def test_tiled_arguments_match_the_kernel_struct():
    """The ctypes structure passed to the tiled route lists the fields of
    the C ``TiledArgs`` in the same order and with the same kinds."""
    src = (Path(tiled.__file__).resolve().parent.parent / "csrc"
           / "vector_field_tiled.cu").read_text()
    body = re.search(r"struct TiledArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind, names = re.match(r"(.*?)(\w+(?:, \w+)*)$", line).groups()
        kind = ("ptr" if "*" in kind else kind.strip())
        fields += [(n, kind) for n in names.split(", ")]
    want = [(name, {ctypesf: k for ctypesf, k in (
        ("c_void_p", "ptr"), ("c_int", "int"), ("c_float", "float"),
        ("Drop", "vf::Drop"))}[
        t.__name__]) for name, t in tiled._Args._fields_]
    assert fields == want
    # the stage base and the step of the Euler and stage-advance modes
    assert {("base", "ptr"), ("dt", "float")} <= set(fields)
