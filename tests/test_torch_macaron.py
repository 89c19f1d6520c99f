"""The Macaron family in the port against the JAX package.

The modules (``LayerNorm``, ``MacaronFFN``, the biased
``SoftmaxSelfAttention``, ``MacaronVectorField``, ``ViTMacaron`` with
``learn_ivp`` and the distillation token) are held against their flax
counterparts, and ``from_jax_params`` must fill every parameter of the
Macaron tree. The kernels' plain versions are held against the TPU kernels
in interpret mode and against JAX's XLA twin: ``macaron_eval_plain`` in
its three modes against ``_pallas_macaron`` and ``_xla_macaron``, and
``macaron_bwd_plain`` (all 16 cotangents) against ``pallas_macaron_bwd``
and ``jax.vjp`` of ``_xla_macaron``; NaN padding stays inert; the plans,
and the route: one CTA up to 128 padded tokens, the tiled route past it
(``tests/test_torch_macaron_tiled.py`` holds it against JAX), a raise
past 256. The CUDA kernels are
held against the plain versions on the GPU by ``chip_smoke.py``;
``tests/test_torch_macaron_step.py`` holds the whole slice (serving,
training) against JAX.

Weights are JAX's initialisation plus normal(0, 0.1) noise on every
parameter, as ``tests/test_kernels.py`` perturbs them: the FFN's 1e-3
initialisation would otherwise compare near-zeros. Shapes: D=32, 2 heads,
FFN ratio 2; n=17 tokens (padded to 32), n=32, and n=32 with 20 real.

Tolerances (max|got - want| over max|want|, per output):
  * float32 modules and plain versions against flax, the Pallas kernels
    and the XLA twin: 1e-5 (forward; the same operations with sums in
    another order, and the TPU kernel's erf polynomial against exact
    erf) and 1e-4 for the 16 cotangents (long sums over rows);
  * bfloat16 forward against the Pallas kernel and the XLA twin: 2^-7
    (two bf16 ulps: an intermediate rounded on each side can land on
    neighbouring values; the twin does not round qkv before the heads and
    returns f rounded, so its Euler and stage-advance updates are formed
    here from a rounded f);
    the cotangents: 2^-5, since rounding differences of the forward
    chain's five rounded intermediates reach every cotangent through
    several rounded products;
  * logits of the whole model against flax at float32: atol 5e-4, rtol
    5e-3, as ``tests/test_torch_fast_forward.py`` holds the softmax model.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

import odevit_tpu.kernels.macaron as jax_macaron
from odevit_tpu.kernels.macaron import (_pallas_macaron, _xla_macaron,
                                        pallas_macaron_bwd)
from odevit_tpu.models.fast_forward import _layer_norm as jax_layer_norm
from odevit_tpu.models.macaron import ViTMacaron as JaxViTMacaron
from odevit_tpu.models.vector_field import MacaronVectorField as JaxMacVF
from odevit_tpu.ops.attention import SoftmaxSelfAttention as JaxAttn
from odevit_tpu.ops.mlp import MacaronFFN as JaxFFN
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.macaron import (MacaronWeights, macaron_eval,
                                              macaron_eval_plain,
                                              macaron_plan, macaron_route)
from odevit_tpu_torch.kernels.macaron_bwd import (BAR_NAMES, macaron_bwd,
                                                  macaron_bwd_plain,
                                                  macaron_bwd_plan)
from odevit_tpu_torch.models.macaron import ViTMacaron
from odevit_tpu_torch.models.vector_field import MacaronVectorField
from odevit_tpu_torch.ops.attention import SoftmaxSelfAttention
from odevit_tpu_torch.ops.layer_norm import LayerNorm, layer_norm
from odevit_tpu_torch.ops.mlp import MacaronFFN
from odevit_tpu_torch.params import from_jax_params

D, H, DH = 32, 2, 64
SCALER = 4.0
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=5e-4, rtol=5e-3)
CFG = dict(img_size=16, patch_size=4, embed_dim=D, num_heads=H,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4.0,
           time_interval=1.0, num_eval_steps=4, solver="rk4")
# (tokens given to JAX, n_real, the port's padded token count)
CASES = {"pad17": (17, 17, 32), "full32": (32, 32, 32),
         "real20": (32, 20, 32)}


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def perturb(tree, seed):
    """Every leaf plus normal(0, 0.1) noise (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a))).astype(np.float32), jax.device_get(tree))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jax_vf_tree(seed=0):
    """A perturbed MacaronVectorField tree at D=32, 2 heads, ratio 2."""
    x = jnp.zeros((1, 5, D))
    jm = JaxMacVF(dim=D, num_heads=H, mlp_ratio=2.0, emulate_depth=SCALER,
                  time_interval=1.0)
    return jm, perturb(jm.init(jax.random.PRNGKey(seed), x, 0.0)["params"],
                       seed + 1)


def jax_tensors(p):
    """The 15 tensors in ``_macaron_tensors``' order."""
    return tuple(jnp.asarray(t) for t in jax_macaron._macaron_tensors(p))


def port_weights(p, dtype=torch.float32):
    """The port's MacaronWeights from the same tree."""
    mats = {"wqkv", "wout", "w1", "w2"}
    return MacaronWeights(*(
        tt(t).to(dtype if name in mats else torch.float32)
        for name, t in zip(MacaronWeights._fields,
                           jax_macaron._macaron_tensors(p))))


def port_vf(p):
    tm = MacaronVectorField(D, H, 2.0, emulate_depth=SCALER,
                            time_interval=1.0,
                            generator=torch.Generator().manual_seed(0))
    a, f = p["attn"], p["ffn"]
    tm.load_state_dict({
        **{f"norm{i}.{k}": tt(p[f"norm{i}"][j])
           for i in (1, 2, 3) for k, j in (("weight", "scale"),
                                           ("bias", "bias"))},
        "attn.qkv.weight": tt(a["qkv_kernel"]).T,
        "attn.qkv.bias": tt(a["qkv_bias"]),
        "attn.proj.weight": tt(a["out_kernel"]).T,
        "attn.proj.bias": tt(a["out_bias"]),
        **{f"ffn.{n}.{k}": (tt(f[n]["kernel"]).T if k == "weight"
                            else tt(f[n]["bias"]))
           for n in ("fc1", "fc2") for k in ("weight", "bias")},
        "res_scale": tt(p["res_scale"])})
    return tm


# ---------------------------------------------------------------- modules

def test_layer_norms_match_flax_and_fast_forward():
    """The module against flax's nn.LayerNorm (its E[x^2] - E[x]^2
    variance), the functional two-pass norm against JAX's
    ``_layer_norm``; rows with a mean of 3 among them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    x[1] += 3.0
    scale = rng.standard_normal(D).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    want = fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    tm = LayerNorm(D)
    tm.load_state_dict({"weight": tt(scale), "bias": tt(bias)})
    np.testing.assert_allclose(tm(tt(x)).detach().numpy(), np.asarray(want),
                               **TOL)
    want2 = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias))
    got2 = layer_norm(tt(x).to(torch.bfloat16), tt(scale), tt(bias))
    assert got2.dtype == torch.float32
    np.testing.assert_allclose(layer_norm(tt(x), tt(scale), tt(bias)).numpy(),
                               np.asarray(want2), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_macaron_ffn_and_biased_attention_match_flax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)

    jf = JaxFFN(dim=D, hidden_dim=DH, dtype=jdt)
    pf = perturb(jf.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2)
    want = jf.apply({"params": pf}, jnp.asarray(x))
    tf = MacaronFFN(D, DH, dtype=tdt,
                    generator=torch.Generator().manual_seed(0))
    tf.load_state_dict({f"{n}.{k}": (tt(pf[n]["kernel"]).T if k == "weight"
                                     else tt(pf[n]["bias"]))
                        for n in ("fc1", "fc2") for k in ("weight", "bias")})
    got = tf(tt(x))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)

    ja = JaxAttn(dim=D, num_heads=H, use_bias=True, spectral_init=False,
                 dtype=jdt)
    pa = perturb(ja.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 4)
    out_w, maps_w = ja.apply({"params": pa}, jnp.asarray(x))
    ta = SoftmaxSelfAttention(D, H, dtype=tdt, use_bias=True,
                              spectral_init=False,
                              generator=torch.Generator().manual_seed(0))
    ta.load_state_dict({"qkv.weight": tt(pa["qkv_kernel"]).T,
                        "qkv.bias": tt(pa["qkv_bias"]),
                        "proj.weight": tt(pa["out_kernel"]).T,
                        "proj.bias": tt(pa["out_bias"])})
    out, maps = ta(tt(x))
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(out_w, np.float32), **tol)
    np.testing.assert_allclose(maps.float().detach().numpy(),
                               np.asarray(maps_w, np.float32), **tol)


def test_macaron_vector_field_matches_flax_and_its_kernel_weights():
    jm, p = jax_vf_tree(5)
    x = np.random.default_rng(6).standard_normal((2, 9, D)).astype(
        np.float32)
    dx_w, _ = jm.apply({"params": p}, jnp.asarray(x), 0.0)
    tm = port_vf(p)
    dx, maps = tm(tt(x))
    assert maps.shape == (2, H, 9, 9)
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(dx_w),
                               atol=1e-4, rtol=1e-4)
    # the kernel's weights are _macaron_tensors in its order and dtypes
    w = tm.kernel_weights(torch.bfloat16)
    for name, got, want in zip(MacaronWeights._fields, w, port_weights(p)):
        assert got.dtype == (torch.bfloat16 if name in
                             ("wqkv", "wout", "w1", "w2") else torch.float32)
        np.testing.assert_allclose(got.float().numpy(),
                                   want.to(got.dtype).float().numpy(),
                                   err_msg=name)


def jax_model_and_params(seed=0, **over):
    cfg = {**CFG, **over}
    jm = JaxViTMacaron(**cfg)
    pixels = np.random.default_rng(seed).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    params = perturb(jm.init(jax.random.PRNGKey(seed),
                             jnp.asarray(pixels))["params"], seed + 7)
    tm = ViTMacaron(**{**cfg, "dtype": None if cfg.get("dtype") is None
                       else torch.bfloat16}, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm, pixels


@pytest.mark.parametrize("variant", ["plain", "ivp", "dist", "ivp_dist"])
def test_vit_macaron_matches_flax(variant):
    over = dict(learn_ivp="ivp" in variant,
                add_distillation_token="dist" in variant)
    jm, params, tm, pixels = jax_model_and_params(1, **over)
    want = jm.apply({"params": params}, jnp.asarray(pixels))
    got = tm(torch.from_numpy(pixels))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **LOGIT_TOL)


def test_from_jax_params_fills_every_parameter():
    """Every parameter of the port's model comes from the tree, with its
    shape, and the tree has nothing left over."""
    over = dict(learn_ivp=True, add_distillation_token=True)
    jm, params, tm, _ = jax_model_and_params(2, **over)
    sd = from_jax_params(params)
    assert set(sd) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name
    n_tree = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert n_tree == sum(t.numel() for t in sd.values())
    assert tuple(sd["init_ivp.weight"].shape) == (D, 3, 5, 5)


def test_raising_paths():
    tm = ViTMacaron(**CFG, device="cpu")
    x = torch.zeros(2, 16, 16, 3)
    for kw in (dict(labels=torch.tensor([0, 1])),
               dict(output_hidden_states=True),
               dict(output_control_points=True)):
        with pytest.raises(NotImplementedError):
            tm(x, **kw)


# ----------------------------------------------------------------- kernels

def inputs(case, dtype, seed, nan_pad=False):
    """(JAX's x [B, n, D] as numpy, the port's padded x, n_real)."""
    n, n_real, n_pad = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n, D)).astype(np.float32)
    xp = np.zeros((3, n_pad, D), np.float32)
    xp[:, :n] = x
    xt = torch.from_numpy(xp).to(dtype)
    if nan_pad:
        xt[:, n_real:] = float("nan")
    return x, xt, n_real


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "euler", "base"])
def test_eval_plain_matches_pallas_and_xla(mode, dtype, case):
    _, p = jax_vf_tree(7)
    x, xt, n_real = inputs(case, getattr(torch, dtype), 8)
    n = x.shape[1]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    base = (np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32) if mode == "base" else None)
    kw = dict(mode=mode, dt=0.25 if mode != "plain" else 0.0)
    if mode == "base":
        bt = torch.zeros_like(xt)
        bt[:, :n] = torch.from_numpy(base).to(xt.dtype)
        kw["base"] = bt
    got = macaron_eval_plain(xt, port_weights(p, xt.dtype), num_heads=H,
                             scaler=SCALER, n_real=n_real, **kw)
    assert got.dtype == xt.dtype
    got = got[:, :n_real].float().numpy()
    want = _pallas_macaron(
        jx, *jax_tensors(p), num_heads=H, scaler=SCALER, block_b=3,
        n_real=n_real, euler_dt=kw["dt"],
        base=None if base is None else jnp.asarray(base, jdt))
    want = np.asarray(want[:, :n_real], np.float32)
    # the twin returns f in x's dtype; its Euler and stage-advance updates
    # are formed here from the rounded inputs
    f = np.asarray(_xla_macaron(jx, *jax_tensors(p), num_heads=H,
                                scaler=SCALER, n_real=n_real), np.float32)
    xr = np.asarray(jx, np.float32)
    br = 0 if base is None else np.asarray(jnp.asarray(base, jdt), np.float32)
    twin = {"plain": f, "euler": xr + 0.25 * f, "base": br + 0.25 * f}[mode]
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert rel(got, want) <= tol
    assert rel(got, twin[:, :n_real]) <= tol


@pytest.mark.parametrize("case", ["pad17", "real20"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_and_vjp(dtype, case):
    _, p = jax_vf_tree(10)
    x, xt, n_real = inputs(case, getattr(torch, dtype), 11)
    n = x.shape[1]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    g = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    g[:, n_real:] = 0.0                  # the padded rows' cotangent
    gt = torch.zeros_like(xt)
    gt[:, :n] = torch.from_numpy(g).to(xt.dtype)
    got = macaron_bwd_plain(xt, port_weights(p, xt.dtype), gt, num_heads=H,
                            scaler=SCALER, n_real=n_real)
    assert len(got) == 16 and got[0].dtype == xt.dtype
    assert all(t.dtype == torch.float32 for t in got[1:])
    assert got[-1].shape == (1,)
    tensors = tuple(t.astype(jdt) if i in (6, 8, 10, 12) else t
                    for i, t in enumerate(jax_tensors(p)))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want = pallas_macaron_bwd((jx, *tensors), jg, num_heads=H,
                              scaler=SCALER, n_real=n_real)
    tol = 1e-4 if dtype == "float32" else 2 ** -5
    for name, a, b in zip(BAR_NAMES, got, want):
        a = a[:, :n_real] if name == "x" else a
        b = b[:, :n_real] if name == "x" else b
        assert rel(a.float().numpy(), np.asarray(b, np.float32)) <= tol, name
    if dtype == "float32":
        ref = functools.partial(_xla_macaron, num_heads=H, scaler=SCALER,
                                n_real=n_real)
        _, vjp = jax.vjp(ref, jx, *jax_tensors(p))
        for name, a, b in zip(BAR_NAMES, got, vjp(jg)):
            a = a[:, :n_real] if name == "x" else a
            b = b[:, :n_real] if name == "x" else b
            assert rel(a.numpy(), np.asarray(b)) <= 1e-4, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_padding_stays_inert(dtype):
    """NaN in the padded rows changes no real row of any mode and no
    cotangent: keys are masked and value rows zeroed by selection, and the
    backward reads padded rows as zeros."""
    _, p = jax_vf_tree(13)
    dt = getattr(torch, dtype)
    w = port_weights(p, dt)
    _, clean, n_real = inputs("real20", dt, 14)
    _, dirty, _ = inputs("real20", dt, 14, nan_pad=True)
    kw = dict(num_heads=H, scaler=SCALER, n_real=n_real)
    for mode in ("plain", "euler", "base"):
        extra = dict(dt=0.5, base=clean) if mode == "base" else \
            dict(dt=0.5 if mode == "euler" else 0.0)
        a = macaron_eval_plain(clean, w, mode=mode, **kw, **extra)
        b = macaron_eval_plain(dirty, w, mode=mode, **kw, **extra)
        assert torch.equal(a[:, :n_real], b[:, :n_real]), mode
    g = torch.randn(clean.shape, generator=torch.Generator().manual_seed(0))
    g = g.to(dt)
    for a, b in zip(macaron_bwd_plain(clean, w, g, **kw),
                    macaron_bwd_plain(dirty, w, g, **kw)):
        assert torch.equal(a, b)


def test_plans_and_the_shapes_without_one_raise():
    # the Macaron CIFAR shape fits one image per CTA in both dtypes
    assert macaron_plan(torch.bfloat16, 80, 65, 192, 3, 768) == \
        (1, 128, 227840)
    assert macaron_plan(torch.float32, 80, 65, 192, 3, 768)[0] == 0
    for dt in (torch.bfloat16, torch.float32):
        assert macaron_bwd_plan(dt, 80, 65, 192, 3, 768) is not None
        for bwd in (False, True):
            assert macaron_route(dt, 80, 65, 192, 3, 768, bwd) == "cta"
            # 144 tokens have no one-CTA plan: they take the tiled route
            assert macaron_route(dt, 144, 130, 192, 3, 768, bwd) == "tiled"
        assert macaron_plan(dt, 144, 130, 192, 3, 768) is None
        assert macaron_bwd_plan(dt, 144, 130, 192, 3, 768) is None
        # past 256 padded tokens the tiled route's attention is key-tiled
        for bwd in (False, True):
            assert macaron_route(dt, 272, 260, 192, 3, 768, bwd) == "tiled"
            assert macaron_route(dt, 592, 587, 768, 12, 1536,
                                 bwd) == "tiled"
        # heads of 8 channels have a plan on neither route
        assert macaron_plan(dt, 32, 20, 32, 4, 64) is None
        with pytest.raises(ValueError, match="multiples of 16"):
            macaron_route(dt, 32, 20, 32, 4, 64)
    _, p = jax_vf_tree(15)
    w = port_weights(p)
    # on the CPU the tiled route's shapes run the plain versions
    x = torch.zeros(1, 144, D)
    before = dict(launch_counts)
    assert macaron_eval(x, w, num_heads=H, scaler=1.0,
                        n_real=140).shape == x.shape
    assert len(macaron_bwd(x, w, x, num_heads=H, scaler=1.0,
                           n_real=140)) == 16
    assert launch_counts == before
    # past 256 padded tokens too (the tiled route; its attention is
    # key-tiled on the card)
    x = torch.zeros(1, 272, D)
    assert macaron_eval(x, w, num_heads=H, scaler=1.0,
                        n_real=260).shape == x.shape
    assert len(macaron_bwd(x, w, x, num_heads=H, scaler=1.0,
                           n_real=260)) == 16
    assert launch_counts == before
    with pytest.raises(ValueError, match="padded"):
        macaron_eval(torch.zeros(1, 17, D), w, num_heads=H, scaler=1.0,
                     n_real=17)
