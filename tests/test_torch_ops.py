"""The port's ops and vector field against their flax modules at f32,
on the same parameters (loaded with ``from_jax_params``-style transposes)
and the same inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.models.vector_field import ParallelVectorField as JaxVF
from odevit_tpu.ops.attention import SoftmaxSelfAttention as JaxAttn
from odevit_tpu.ops.center_norm import center_norm as jax_center_norm
from odevit_tpu.ops.mlp import Mlp as JaxMlp
from odevit_tpu.ops.patch_embed import PatchEmbed as JaxPatchEmbed
from odevit_tpu.ops.patch_embed import patchify as jax_patchify
from odevit_tpu_torch.models.vector_field import (ParallelVectorField,
                                                  drift_scaler)
from odevit_tpu_torch.ops.attention import SoftmaxSelfAttention
from odevit_tpu_torch.ops.center_norm import CenterNorm, center_norm
from odevit_tpu_torch.ops.init import spectral_xavier_normal
from odevit_tpu_torch.ops.mlp import Mlp
from odevit_tpu_torch.ops.patch_embed import PatchEmbed, patchify

TOL = dict(atol=1e-5, rtol=1e-5)


def gen():
    return torch.Generator().manual_seed(0)


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_center_norm_matches_jax(dtype):
    x = rand(3, 5, 24)
    w, b = rand(24, seed=1), rand(24, seed=2)
    want = jax_center_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           dtype=jnp.bfloat16 if dtype else None)
    got = center_norm(tt(x), tt(w), tt(b),
                      dtype=torch.bfloat16 if dtype else None)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(TOL if dtype is None else
                                  dict(atol=2e-2, rtol=1e-2)))
    mod = CenterNorm(24)
    assert torch.equal(mod(tt(x)), center_norm(tt(x), torch.ones(24),
                                               torch.zeros(24)))


def test_spectral_init_has_unit_top_singular_value():
    w = spectral_xavier_normal((48, 32), gen())
    assert w.dtype == torch.float32 and w.shape == (48, 32)
    assert abs(torch.linalg.svdvals(w.double())[0].item() - 1.0) < 1e-6
    again = spectral_xavier_normal((48, 32), gen())
    assert torch.equal(w, again)      # a seed fixes the weights


def test_patchify_channel_major_matches_jax():
    x = rand(2, 8, 8, 3)
    np.testing.assert_array_equal(patchify(tt(x), 4).numpy(),
                                  np.asarray(jax_patchify(jnp.asarray(x), 4)))


@pytest.mark.parametrize("pos_reg,dist", [(False, False), (True, False),
                                          (False, True)])
def test_patch_embed_matches_flax(pos_reg, dist):
    kw = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32,
              add_distillation_token=dist, register_tokens=2,
              pos_embed_register_tokens=pos_reg)
    x = rand(2, 16, 16, 3)
    jm = JaxPatchEmbed(**kw)
    p = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    p = p["params"]
    tm = PatchEmbed(**kw, generator=gen())
    sd = {k: tt(v) for k, v in p.items()}
    tm.load_state_dict(sd)
    assert tm.seq_len == want.shape[1]
    np.testing.assert_allclose(tm(tt(x)).detach().numpy(), want, **TOL)


def test_attention_matches_flax():
    x = rand(2, 9, 32)
    jm = JaxAttn(dim=32, num_heads=2)
    p = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    out_w, maps_w = jm.apply(p, jnp.asarray(x))
    p = p["params"]
    tm = SoftmaxSelfAttention(32, 2, generator=gen())
    tm.load_state_dict({"qkv.weight": tt(p["qkv_kernel"]).T,
                        "proj.weight": tt(p["out_kernel"]).T})
    out, maps = tm(tt(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_w),
                               **TOL)
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(maps_w),
                               **TOL)


def test_mlp_matches_flax():
    x = rand(2, 9, 32)
    jm = JaxMlp(dim=32, hidden_dim=64)
    p = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    p = p["params"]
    tm = Mlp(32, 64, generator=gen())
    tm.load_state_dict({"fc1.weight": tt(p["fc1_kernel"]).T,
                        "fc2.weight": tt(p["fc2_kernel"]).T})
    np.testing.assert_allclose(tm(tt(x)).detach().numpy(), want, **TOL)


def test_vector_field_matches_flax_and_its_kernel_weights():
    x = rand(2, 9, 32)
    jm = JaxVF(dim=32, num_heads=2, mlp_ratio=2.0, emulate_depth=12.0,
               time_interval=1.0)
    p = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), 0.0))
    dx_w, maps_w = jm.apply(p, jnp.asarray(x), 0.0)
    p = p["params"]
    tm = ParallelVectorField(32, 2, 2.0, 12.0, 1.0, generator=gen())
    tm.load_state_dict({
        "norm_attn.weight": tt(p["norm_attn"]["scale"]),
        "norm_attn.bias": tt(p["norm_attn"]["bias"]),
        "norm_mlp.weight": tt(p["norm_mlp"]["scale"]),
        "norm_mlp.bias": tt(p["norm_mlp"]["bias"]),
        "attn.qkv.weight": tt(p["attn"]["qkv_kernel"]).T,
        "attn.proj.weight": tt(p["attn"]["out_kernel"]).T,
        "mlp.fc1.weight": tt(p["mlp"]["fc1_kernel"]).T,
        "mlp.fc2.weight": tt(p["mlp"]["fc2_kernel"]).T})
    dx, maps = tm(tt(x))
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(dx_w), **TOL)
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(maps_w),
                               **TOL)
    kw = tm.kernel_weights(torch.bfloat16)
    assert kw.wqkv.dtype == torch.bfloat16 and kw.wqkv.is_contiguous()
    assert kw.norm_attn_scale.dtype == torch.float32
    np.testing.assert_array_equal(
        kw.w1.float().numpy(),
        tt(p["mlp"]["fc1_kernel"]).to(torch.bfloat16).float().numpy())
    assert tm.scaler == drift_scaler(12.0, 1.0) == 12.0
    assert drift_scaler(12.0, 12.0) == 1.0


@pytest.mark.parametrize("flag", ["time_conditioning"])
def test_unported_vector_field_options_raise(flag):
    with pytest.raises(NotImplementedError):
        ParallelVectorField(32, 2, generator=gen(), **{flag: True})
