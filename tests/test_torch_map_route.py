"""The fused steps' attention-map route, and ``emit_masks``, against JAX.

Map route: a sequence shorter than ``max(jasmin_k, 1) + 1`` tokens cannot
hold the in-kernel JaSMin statistics' extraction passes, so JAX's fused
steps take JaSMin from the maps there (``fused_vf_attn`` and
``jasmin_map_loss``; ``odevit_tpu/train/fast_steps.py:196``, ``:218-222``,
``:285-289``, ``:485-493``). The small config (16 px, D=32, 2 heads, 2
registers: 19 tokens) with k=19 takes that route in both packages: JAX's
``_g_pair`` indexes the k-th order statistic, so k=19 is the largest k
its map route takes at 19 tokens. Held against JAX: the free step's
forward loss and every gradient (Euler on 3 points: two map
evaluations), and the distillation step's (Euler on 4 points: two map
evaluations in the window and the final one), each deterministic and at
dropout (0.1, 0.2, 0.3). With
dropout JAX's evaluations run through its XLA twin fed the port's masks
(``tests/test_torch_train_dropout.py``'s fixture), since its ``pltpu``
bits have no CPU lowering.

``emit_masks``: at ``benchmarks/tpu_dropout_check.py``'s shape (b=16,
n=21, D=64, 2 heads, dh=128, rates attn/proj/mlp 0.2/0.1/0.3, f32), the
plain version's masks equal ``generate_dropout_masks`` bit for bit, take
the values {0, 1/(1 - rate)} with keep rates within 0.02 of 1 - rate (the
script's checks, over the real rows and keys), and f(x) and the maps
match the script's ``xla_twin_with_masks`` (copied below: the script
enables a compile cache when imported) fed those masks, within its 1e-4
and 1e-5.

Tolerances of the steps are ``tests/test_torch_train.py``'s: loss and
JaSMin loss rtol 1e-4 (distillation metrics 2e-4), gradients atol 5e-5 /
rtol 5e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import odevit_tpu.kernels.vector_field as jax_vf
import odevit_tpu.train.fast_steps as jax_steps
from odevit_tpu.models.vit_ode import ViTODE as JaxViTODE
from odevit_tpu.teacher.vit import ViTTeacher as JaxTeacher
from odevit_tpu_torch.kernels.dropout import generate_dropout_masks
from odevit_tpu_torch.kernels.vector_field import (VFWeights,
                                                   vf_eval_attn_plain,
                                                   vf_eval_plain)
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.params import from_jax_params
from odevit_tpu_torch.teacher.vit import ViTTeacher
from odevit_tpu_torch.train.fast_steps import (fast_distill_forward,
                                               fast_free_forward, stats_ok)
from test_torch_train_dropout import (assert_tree_close, seeds_of,
                                      twin_dropout, twin_eval)

K = 19
RATES = dict(attn_drop=0.1, proj_drop=0.2, mlp_drop=0.3)
CFG = dict(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
           mlp_ratio=2.0, num_classes=7, emulate_depth=4, time_interval=1.0,
           register_tokens=2)
TEACHER = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=12,
               num_heads=2, mlp_dim=64, num_classes=7)
RECIPE = dict(lambda_param=0.5, jasmin_k=K, temperature=3.0,
              use_kl_loss=False, mse_full_path=True)


@pytest.fixture(params=["deterministic", "dropout"])
def route(request):
    """"dropout": JAX's dropout evaluations, the map route's
    ``fused_vf_attn_dropout_from_params`` among them, through the twin."""
    if request.param == "dropout":
        request.getfixturevalue("twin_dropout")
        mp = request.getfixturevalue("monkeypatch")

        def attn_dropout_from_params(x, vf_params, seed, *, num_heads,
                                     scaler, drops, **kw):
            return twin_eval(x, vf_params, seed, num_heads=num_heads,
                             scaler=scaler, drops=drops, want_attn=True)

        mp.setattr(jax_vf, "fused_vf_attn_dropout_from_params",
                   attn_dropout_from_params)
    return request.param


def models(cfg, seed=0):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    jm = JaxViTODE(**cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(pixels))["params"]
    tm = ViTODE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    assert not stats_ok(K, tm.patch_embed.seq_len)
    return jm, params, tm, pixels, labels


def test_free_step_map_route_matches_jax(route):
    drop = route == "dropout"
    cfg = dict(CFG, num_eval_steps=3, solver="euler",
               **(RATES if drop else {}))
    jm, params, tm, pixels, labels = models(cfg)
    key = jax.random.PRNGKey(3)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.fast_free_forward(
            jm, p, jnp.asarray(pixels), jnp.asarray(labels), jasmin_k=K,
            rng=key if drop else None), has_aux=True))(params)
    got, got_aux = fast_free_forward(
        tm, torch.from_numpy(pixels), torch.from_numpy(labels), jasmin_k=K,
        step_seeds=seeds_of(key, 2) if drop else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(got_aux["jasmin_loss"].item(),
                               float(aux["jasmin_loss"]), rtol=1e-4)
    assert_tree_close({n: p.grad for n, p in tm.named_parameters()}, grads,
                      atol=5e-5, rtol=5e-3)


def test_distill_step_map_route_matches_jax(route):
    drop = route == "dropout"
    cfg = dict(CFG, emulate_depth=12.0, num_eval_steps=4, solver="euler",
               **(RATES if drop else {}))
    jm, params, tm, pixels, labels = models(cfg, 1)
    jt = JaxTeacher(**TEACHER)
    tparams = jt.init(jax.random.PRNGKey(1), jnp.asarray(pixels))["params"]
    tt = ViTTeacher(**TEACHER, device="cpu")
    tt.load_state_dict(from_jax_params(jax.device_get(tparams)))
    t_out = jt.apply({"params": tparams}, jnp.asarray(pixels))
    t_states, t_attn = t_out["hidden_states"][1:], t_out["attentions"][-1]
    key = jax.random.PRNGKey(4)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.fast_distill_forward(
            jm, p, jnp.asarray(pixels), jnp.asarray(labels), t_states,
            t_attn, supervise=True, rng=key if drop else None, **RECIPE),
        has_aux=True))(params)
    tk = lambda a: torch.from_numpy(np.array(a))
    got, got_aux = fast_distill_forward(
        tm, torch.from_numpy(pixels), torch.from_numpy(labels),
        tk(t_states), tk(t_attn), supervise=True,
        step_seeds=seeds_of(key, 3) if drop else None, **RECIPE)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    for name, want in aux["metrics"].items():
        np.testing.assert_allclose(got_aux["metrics"][name].item(),
                                   float(want), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    assert_tree_close({n: p.grad for n, p in tm.named_parameters()}, grads,
                      atol=5e-5, rtol=5e-3)


# --- emit_masks at tpu_dropout_check.py's shape ---------------------------

MB, MN, MD, MH, MDH = 16, 21, 64, 2, 128
M_PAD = 32
M_DROPS = (0.2, 0.1, 0.3)                  # attn, proj, mlp
M_SCALER, M_SEED = 12.0, 12345


def xla_twin_with_masks(x, cna_s, cna_b, cnm_s, cnm_b, wqkv, wout, w1, w2,
                        masks, *, num_heads, scaler, n_real):
    """benchmarks/tpu_dropout_check.py:41: the kernel's math with the
    kernel's own (scaled) keep masks."""
    mask_h, mask_mo, mask_ao, mask_p = masks
    b, n, d = x.shape
    hd = d // num_heads
    xf = x.astype(jnp.float32)
    cent = (xf - jnp.mean(xf, -1, keepdims=True)) * (d / (d - 1.0))
    cn_a = cent * cna_s + cna_b
    cn_m = cent * cnm_s + cnm_b

    h = jax.nn.gelu(cn_m @ w1, approximate=False)
    h = h * mask_h.reshape(b, n, -1)
    mlp_o = (h @ w2) * mask_mo.reshape(b, n, d)

    qkv = cn_a @ wqkv
    q, k, v = jnp.split(qkv, 3, axis=-1)
    heads = lambda t: t.reshape(b, n, num_heads, hd).transpose(0, 2, 1, 3)
    q, k, v = heads(q) * hd ** -0.5, heads(k), heads(v)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k)
    if n_real < n:
        s = jnp.where((jnp.arange(n) < n_real)[None, None, None, :],
                      s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    p_used = p * mask_p
    ctx = jnp.einsum("bhqk,bhkd->bhqd", p_used, v)
    ctx = ctx.transpose(0, 2, 1, 3).reshape(b, n, d)
    attn_o = (ctx @ wout) * mask_ao.reshape(b, n, d)
    return (mlp_o + attn_o) * scaler, p


def mask_case():
    rng = np.random.default_rng(0)
    mk = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    x = mk(MB, MN, MD)
    w = [mk(MD), mk(MD), mk(MD), mk(MD), mk(MD, 3 * MD), mk(MD, MD),
         mk(MD, MDH), mk(MDH, MD)]
    return x, w


def test_emit_masks_plain_matches_generator_and_twin():
    x, w = mask_case()
    x_pad = np.pad(x, ((0, 0), (0, M_PAD - MN), (0, 0)))
    tw = VFWeights(*map(torch.from_numpy, w))
    kw = dict(num_heads=MH, scaler=M_SCALER, n_real=MN, seed=M_SEED,
              drops=M_DROPS, emit_masks=True)
    f, p, masks = vf_eval_attn_plain(torch.from_numpy(x_pad), tw, **kw)
    f2, masks2 = vf_eval_plain(torch.from_numpy(x_pad), tw, **kw)
    assert torch.equal(f, f2)
    assert all(torch.equal(a, b) for a, b in zip(masks, masks2))
    shapes = ((MB * M_PAD, MDH), (MB * M_PAD, MD), (MB * M_PAD, MD),
              (MB, MH, M_PAD, M_PAD))
    assert tuple(tuple(m.shape) for m in masks) == shapes
    # bit for bit the generator's, cut to the real rows and keys; zeros
    # on the padded ones
    gen = generate_dropout_masks(MB, MN, MD, MDH, MH, M_SEED,
                                 attn_drop=M_DROPS[0], proj_drop=M_DROPS[1],
                                 mlp_drop=M_DROPS[2], device="cpu")
    real = []
    for m, want in zip(masks, gen):
        if m.dim() == 2:
            m = m.reshape(MB, M_PAD, -1)
            assert not m[:, MN:].any()
            m = m[:, :MN]
        else:
            assert not m[:, :, MN:].any() and not m[..., MN:].any()
            m = m[:, :, :MN, :MN]
        assert torch.equal(m, want)
        real.append(m.numpy())
    # tpu_dropout_check.py:118-127, over the real rows and keys
    for m, rate in zip(real, (M_DROPS[2], M_DROPS[2], M_DROPS[1],
                              M_DROPS[0])):
        vals = np.unique(m)
        assert len(vals) == 2 and vals[0] == 0.0
        assert abs(float(vals[-1]) - 1.0 / (1.0 - rate)) < 1e-5
        assert abs(float((m > 0).mean()) - (1.0 - rate)) < 0.02
    dx_t, p_t = xla_twin_with_masks(
        jnp.asarray(x_pad), *map(jnp.asarray, w),
        tuple(jnp.asarray(m.numpy()) for m in masks), num_heads=MH,
        scaler=M_SCALER, n_real=MN)
    assert np.abs(f[:, :MN].numpy() - np.asarray(dx_t)[:, :MN]).max() < 1e-4
    assert np.abs(p[:, :, :MN, :MN].numpy()
                  - np.asarray(p_t)[:, :, :MN, :MN]).max() < 1e-5


def test_emit_masks_needs_dropout():
    x, w = mask_case()
    tw = VFWeights(*map(torch.from_numpy, w))
    x_pad = torch.from_numpy(np.pad(x, ((0, 0), (0, M_PAD - MN), (0, 0))))
    with pytest.raises(ValueError, match="emit_masks"):
        vf_eval_plain(x_pad, tw, num_heads=MH, scaler=M_SCALER, n_real=MN,
                      emit_masks=True)
    # a site of rate 0 is all ones
    _, masks = vf_eval_plain(x_pad, tw, num_heads=MH, scaler=M_SCALER,
                             n_real=MN, seed=1, drops=(0.0, 0.1, 0.0),
                             emit_masks=True)
    assert bool((masks[0] == 1).all() and (masks[1] == 1).all()
                and (masks[3] == 1).all())
    assert set(np.unique(masks[2].numpy())) <= {0.0, np.float32(1 / 0.9)}
