"""L2-distance attention in the port against the JAX package.

The modules (``L2SelfAttention``, the L2 ``ParallelVectorField``,
``from_jax_params`` on an L2 tree, ``ViTODE.forward``) are held against
their flax counterparts, with nonzero biases. The kernels' plain versions
are held against the TPU kernel's L2+bias instances in interpret mode:
``vf_eval_plain`` / ``vf_eval_jasmin_plain`` against ``fused_vf_l2`` /
``fused_vf_l2_jasmin``, and ``vf_bwd_plain`` (all 11 cotangents, with and
without the JaSMin cotangent) against ``pallas_vf_bwd(l2_attention=True,
...)``. The CUDA instances are held against these plain versions on the
GPU by ``chip_smoke.py``.

Cases: "random" (small random biases), and "far", where head 0's q and k
biases sit +4 and -4 apart on every channel, so that every distance of
that head exceeds 100 sqrt(hd) and all its exponentials underflow: p = 0
on whole rows (the 1e-8 in the row sum keeps them finite), while head 1
attends normally.

Tolerances (max|got - want| over max|want|), as in
``tests/test_torch_train_kernels.py``:
  * float32 modules against flax: atol = rtol = 1e-5;
  * float32 forward, dx and statistics: 1e-5 (same operations, sums in
    another order);
  * float32 backward, the 11 cotangents: 1e-4 (long sums over rows and
    columns in another order, and the TPU kernel's erf polynomial
    against exact erf);
  * bfloat16: 2 ulps of bf16 (2^-7) of the output scale, since an
    intermediate rounded to bf16 on each side can land on neighbouring
    values when the sums before it are taken in another order;
  * the whole ViTODE forward against flax at float32: atol 5e-4, rtol
    5e-3, as ``tests/test_torch_fast_forward.py`` holds the softmax model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import fused_vf_l2, fused_vf_l2_jasmin
from odevit_tpu.kernels.vector_field_bwd import pallas_vf_bwd
from odevit_tpu.models.vector_field import ParallelVectorField as JaxVF
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.ops.attention import L2SelfAttention as JaxL2Attn
from odevit_tpu_torch.kernels.vector_field import (VFWeights, l2_plan,
                                                   vf_eval_jasmin_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.kernels.vector_field_bwd import (l2_bwd_plan,
                                                       vf_bwd_plain)
from odevit_tpu_torch.models.vector_field import ParallelVectorField
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.ops.attention import L2SelfAttention
from odevit_tpu_torch.params import from_jax_params

B, N, N_PAD, D, H, DH = 2, 19, 32, 32, 2, 64
SCALER = 4.0
TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ("x", "norm_attn_scale", "norm_attn_bias", "norm_mlp_scale",
         "norm_mlp_bias", "wqkv", "wout", "w1", "w2", "qkv_bias", "out_bias")


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def with_random_biases(tree, seed):
    """The flax tree with every ``*_bias`` of the attention drawn from a
    normal(0, 0.1)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    for name in ("q_bias", "k_bias", "v_bias", "out_bias"):
        a = tree["attn"][name]
        tree["attn"][name] = (rng.standard_normal(a.shape) * 0.1).astype(
            np.float32)
    return tree


def test_l2_attention_matches_flax():
    x = np.random.default_rng(0).standard_normal((2, 9, 32)).astype(
        np.float32)
    jm = JaxL2Attn(dim=32, num_heads=2)
    p = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    p = {"params": with_random_biases({"attn": p["params"]}, 2)["attn"]}
    out_w, maps_w = jm.apply(p, jnp.asarray(x))
    tm = L2SelfAttention(32, 2, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict({f"{n}.{kind}": (tt(p["params"][f"{n}_kernel"]).T
                                        if kind == "weight" else
                                        tt(p["params"][f"{n}_bias"]))
                        for n in ("q", "k", "v", "out")
                        for kind in ("weight", "bias")})
    out, maps = tm(tt(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_w),
                               **TOL)
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(maps_w),
                               **TOL)


def test_l2_vector_field_matches_flax_and_its_kernel_weights():
    x = np.random.default_rng(3).standard_normal((2, 9, 32)).astype(
        np.float32)
    jm = JaxVF(dim=32, num_heads=2, mlp_ratio=2.0, emulate_depth=12.0,
               time_interval=1.0, l2_attention=True)
    p = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), 0.0))
    p = with_random_biases(p["params"], 4)
    dx_w, maps_w = jm.apply({"params": p}, jnp.asarray(x), 0.0)
    tm = ParallelVectorField(32, 2, 2.0, 12.0, 1.0, l2_attention=True,
                             generator=torch.Generator().manual_seed(0))
    a = p["attn"]
    tm.load_state_dict({
        "norm_attn.weight": tt(p["norm_attn"]["scale"]),
        "norm_attn.bias": tt(p["norm_attn"]["bias"]),
        "norm_mlp.weight": tt(p["norm_mlp"]["scale"]),
        "norm_mlp.bias": tt(p["norm_mlp"]["bias"]),
        "mlp.fc1.weight": tt(p["mlp"]["fc1_kernel"]).T,
        "mlp.fc2.weight": tt(p["mlp"]["fc2_kernel"]).T,
        **{f"attn.{n}.weight": tt(a[f"{n}_kernel"]).T
           for n in ("q", "k", "v", "out")},
        **{f"attn.{n}.bias": tt(a[f"{n}_bias"])
           for n in ("q", "k", "v", "out")}})
    dx, maps = tm(tt(x))
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(dx_w), **TOL)
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(maps_w),
                               **TOL)
    # the kernel's weights: [Wq | Wk | Wv], the biases in float32
    kw = tm.kernel_weights(torch.bfloat16)
    assert kw.l2 and kw.wqkv.shape == (32, 96)
    want = np.concatenate([p["attn"][f"{n}_kernel"] for n in "qkv"], 1)
    np.testing.assert_array_equal(
        kw.wqkv.float().numpy(), tt(want).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        kw.qkv_bias.numpy(),
        np.concatenate([p["attn"][f"{n}_bias"] for n in "qkv"]))
    assert kw.out_bias.dtype == torch.float32
    assert not ParallelVectorField(
        32, 2, generator=torch.Generator()).kernel_weights(torch.float32).l2


def vitode_pair():
    cfg = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=4,
               time_interval=1.0, num_eval_steps=4, solver="rk4",
               register_tokens=2, l2_attention=True)
    x = np.random.default_rng(5).standard_normal((3, 16, 16, 3)).astype(
        np.float32)
    jm = JaxViTODE(**cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(6),
                                    jnp.asarray(x))["params"])
    params["vf"] = with_random_biases(params["vf"], 7)
    tm = ViTODE(**cfg, device="cpu")
    return jm, params, tm, x


def test_from_jax_params_fills_the_l2_tree_and_forward_matches_flax():
    jm, params, tm, x = vitode_pair()
    sd = from_jax_params(params)
    assert set(sd) == set(tm.state_dict())
    assert "vf.attn.qkv.weight" not in sd
    assert tuple(sd["vf.attn.k.weight"].shape) == (32, 32)        # [out, in]
    np.testing.assert_array_equal(sd["vf.attn.out.bias"].numpy(),
                                  params["vf"]["attn"]["out_bias"])
    tm.load_state_dict(sd)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x))["logits"])
    with torch.no_grad():
        got = tm(tt(x))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)


def make_case(kind="random", seed=0):
    """Inputs: x [B, N, D] and the 10 weights (8 matrices and norms, then
    qkv_bias [3D], out_bias [D])."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = [f(D) + 1.0, f(D), f(D) + 1.0, f(D), f(D, 3 * D), f(D, D),
         f(D, DH), f(DH, D), f(3 * D) * 0.5, f(D) * 0.5]
    if kind == "far":
        hd = D // H
        w[8][:hd] += 4.0               # head 0's q bias
        w[8][D:D + hd] -= 4.0          # head 0's k bias
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    return x, w


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(a, torch.float32) for a in w[:4]),
                     *(t(a) for a in w[4:8]),
                     qkv_bias=t(w[8], torch.float32),
                     out_bias=t(w[9], torch.float32))


def pad(a):
    return np.concatenate([a, np.zeros((B, N_PAD - N) + a.shape[2:],
                                       a.dtype)], axis=1)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype,kind,tol", [
    (torch.float32, "random", 1e-5), (torch.float32, "far", 1e-5),
    (torch.bfloat16, "random", 2 ** -7), (torch.bfloat16, "far", 2 ** -7)])
def test_l2_forward_matches_pallas(dtype, kind, tol):
    x, w = make_case(kind, 1)
    jx = jnp.asarray(x, jdtype(dtype))
    jw = list(map(jnp.asarray, w))
    dx = fused_vf_l2(jx, *jw, H, SCALER, 2, N)
    jdx, jst = fused_vf_l2_jasmin(jx, *jw, H, SCALER, 2, N, 10)
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    got = vf_eval_plain(tx, tw, **kw)
    gdx, gst, idx = vf_eval_jasmin_plain(tx, tw, jas_k=10, **kw)
    assert got.dtype == dtype
    assert rel(got[:, :N].float().numpy(), f32(dx)) <= tol
    assert torch.equal(gdx, got)
    assert rel(gdx[:, :N].float().numpy(), f32(jdx)) <= tol
    assert rel(gst[..., :N].numpy(), np.asarray(jst)) <= tol
    assert not gst[..., N:].any() and int(idx.max()) < N
    if kind == "far":
        # every row of head 0 underflows: its statistics are all 0
        assert not gst[:, 0, :4, :N].any() and gst[:, 1, 0, :N].all()
        assert torch.isfinite(got).all()


def jax_bwd(x, w, g, dtype, g_jas=None, stats=None):
    jw = list(map(jnp.asarray, w))
    bars = pallas_vf_bwd(jnp.asarray(x, jdtype(dtype)), *jw[:8],
                         jnp.asarray(g, jdtype(dtype)), num_heads=H,
                         scaler=SCALER, block_b=2, n_real=N, g_jas=g_jas,
                         jas_k=10 if g_jas is not None else 0,
                         jas_stats=stats, qkv_bias=jw[8], out_bias=jw[9],
                         l2_attention=True)
    return [f32(b) for b in bars]


@pytest.mark.parametrize("dtype,kind,with_jas,tol", [
    (torch.float32, "random", False, 1e-4),
    (torch.float32, "random", True, 1e-4),
    (torch.float32, "far", True, 1e-4),
    (torch.bfloat16, "random", True, 2 ** -7)])
def test_l2_backward_matches_pallas(dtype, kind, with_jas, tol):
    x, w = make_case(kind, 2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    jkw, tkw = {}, {}
    if with_jas:
        _, stats = fused_vf_l2_jasmin(jnp.asarray(x, jdtype(dtype)),
                                      *map(jnp.asarray, w), H, SCALER, 2, N,
                                      10)
        g_jas = rng.standard_normal((B, H, 5, N_PAD)).astype(np.float32)
        g_jas[..., N:] = 0.0
        jkw = dict(g_jas=jnp.asarray(g_jas[..., :N]), stats=stats)
        _, _, idx = vf_eval_jasmin_plain(tx, tw, jas_k=10, **kw)
        tkw = dict(g_jas=torch.from_numpy(g_jas), jas_idx=idx)
    want = jax_bwd(x, w, g, dtype, **jkw)
    got = vf_bwd_plain(tx, tw, torch.from_numpy(pad(g)).to(dtype), **kw,
                       **tkw)
    assert len(got) == len(want) == 11
    assert got[0].dtype == dtype and not got[0][:, N:].any()
    assert all(b.dtype == torch.float32 for b in got[1:])
    got = [got[0][:, :N]] + list(got[1:])
    for name, a, b in zip(NAMES, got, want):
        err = rel(a.float().numpy(), b)
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_padded_rows_reaches_no_real_row(dtype):
    """Garbage and NaN in the padded rows change neither a real row of the
    L2 forward, its statistics, nor any cotangent."""
    x, w = make_case("random", 4)
    tx = torch.from_numpy(pad(x)).to(dtype)
    tw = torch_weights(w, dtype)
    dirty = tx.clone()
    dirty[:, N:N + 3] = float("nan")
    dirty[:, N + 3:] = 1e30
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    clean_dx, clean_st, clean_idx = vf_eval_jasmin_plain(tx, tw, jas_k=10,
                                                         **kw)
    dx, st, idx = vf_eval_jasmin_plain(dirty, tw, jas_k=10, **kw)
    assert torch.equal(dx[:, :N], clean_dx[:, :N])
    assert torch.equal(st, clean_st) and torch.equal(idx, clean_idx)
    g = torch.from_numpy(pad(np.random.default_rng(5).standard_normal(
        (B, N, D)).astype(np.float32))).to(dtype)
    gdirty = g.clone()
    gdirty[:, N:] = 7.0
    g_jas = torch.zeros(B, H, 5, N_PAD)
    g_jas[..., :N] = 0.01
    clean = vf_bwd_plain(tx, tw, g, g_jas=g_jas, jas_idx=clean_idx, **kw)
    got = vf_bwd_plain(dirty, tw, gdirty, g_jas=g_jas, jas_idx=idx, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, clean))


def test_l2_plans_follow_the_kernels_rule():
    """The Python plans route a CPU run as the card's plans do: the CIFAR
    shape (80 padded tokens, D=192, 3 heads, dh=768) has one in both
    dtypes, 128 tokens at D=192 (the f32 accumulator and q, k, v, p no
    longer fit 227 KB) and 208 tokens (over the 128-row limit) have none."""
    for dtype in (torch.bfloat16, torch.float32):
        assert l2_plan(dtype, 80, 69, 192, 3, 768) is not None
        assert l2_bwd_plan(dtype, 80, 69, 192, 3, 768) is not None
        assert l2_plan(dtype, 208, 207, 64, 4, 64) is None
        assert l2_bwd_plan(dtype, 208, 207, 64, 4, 64) is None
    assert l2_plan(torch.bfloat16, 128, 128, 192, 3, 768) is None
    # the bf16 CIFAR plan fuses q|k|v into one product, as the softmax
    # instance's does, and adds the 2 x 384 bytes of q2 and k2 to it
    fused, hc, smem = l2_plan(torch.bfloat16, 80, 69, 192, 3, 768)
    assert (fused, hc, smem) == (1, 128, 227840 + 768)


def test_l2_weights_reject_other_modes_and_dropout():
    x, w = make_case("random", 6)
    tx, tw = torch.from_numpy(pad(x)), torch_weights(w, torch.float32)
    kw = dict(num_heads=H, scaler=SCALER, n_real=N)
    for mode, extra in (("euler", {"dt": 0.1}),
                        ("base", {"dt": 0.1, "base": tx})):
        with pytest.raises(ValueError, match="L2"):
            vf_eval_plain(tx, tw, mode=mode, **extra, **kw)
    with pytest.raises(ValueError, match="dropout"):
        vf_eval_plain(tx, tw, seed=1, drops=(0.1, 0.0, 0.0), **kw)
    from odevit_tpu_torch.kernels.vector_field import vf_eval_attn
    with pytest.raises(NotImplementedError, match="L2"):
        vf_eval_attn(tx, tw, **kw)
    with pytest.raises(ValueError, match="together"):
        vf_eval_plain(tx, tw._replace(out_bias=None), **kw)
