"""The port's variance-scaling initialisers against flax's.

``lecun_normal`` and ``xavier_normal`` (``odevit_tpu_torch/ops/init.py``)
are held against ``flax.linen.initializers.lecun_normal`` /
``xavier_normal`` over one 1024x512 draw each: the std within 1 %, and
max|w| / the nominal std within 1 % of flax's (2.27: flax scales a normal
truncated at +-2 by the nominal std over 0.8796). The generators differ,
so no bit parity is asked. The sites that take them (``lecun_linear``,
``xavier_linear``, the teacher's ``_dense`` and the Macaron IVP conv) are
held to the nominal std within 2 % and to the bound;
``spectral_xavier_normal`` is ``xavier_normal``'s draw over its sigma_1.
``truncated_normal`` keeps flax's uncorrected std of 0.88 stddev.
"""

import math

import numpy as np
import jax
import pytest
import torch
from flax import linen as nn

from odevit_tpu_torch.models.macaron import ViTMacaron
from odevit_tpu_torch.ops import init
from odevit_tpu_torch.teacher.vit import _dense

FAN_IN, FAN_OUT = 1024, 512
TOL = 0.01


def flax_draw(name):
    fn = getattr(nn.initializers, name)()
    return np.asarray(fn(jax.random.PRNGKey(0), (FAN_IN, FAN_OUT)))


def port_draw(name):
    g = torch.Generator().manual_seed(0)
    if name == "lecun_normal":
        w = init.lecun_normal((FAN_OUT, FAN_IN), FAN_IN, g)
    else:
        w = init.xavier_normal((FAN_OUT, FAN_IN), FAN_IN, FAN_OUT, g)
    return w.numpy()


def nominal(name):
    fan = FAN_IN if name == "lecun_normal" else (FAN_IN + FAN_OUT) / 2
    return math.sqrt(1.0 / fan)


@pytest.mark.parametrize("name", ["lecun_normal", "xavier_normal"])
def test_variance_scaling_matches_flax(name):
    want, got = flax_draw(name), port_draw(name)
    sigma = nominal(name)
    np.testing.assert_allclose(got.std(), want.std(), rtol=TOL)
    np.testing.assert_allclose(got.std(), sigma, rtol=TOL)
    bound = np.abs(want).max() / sigma
    assert abs(bound - 2.0 / 0.87962566103423978) < 0.01 * bound
    np.testing.assert_allclose(np.abs(got).max() / sigma, bound, rtol=TOL)


def _ivp_weight():
    # D=192: 14,400 draws of fan_in 3 x 5 x 5
    model = ViTMacaron(img_size=32, patch_size=16, embed_dim=192,
                       num_heads=3, learn_ivp=True, device="cpu", seed=0)
    return model.init_ivp.weight.detach(), 3 * 25


@pytest.mark.parametrize("site", ["lecun_linear", "xavier_linear",
                                  "spectral_draw", "teacher_dense",
                                  "ivp_conv"])
def test_sites_draw_flax_std(site):
    g = torch.Generator().manual_seed(1)
    if site == "lecun_linear":
        w, sigma = init.lecun_linear(FAN_IN, FAN_OUT, g).weight, nominal(
            "lecun_normal")
    elif site == "xavier_linear":
        w, sigma = init.xavier_linear(FAN_IN, FAN_OUT, g).weight, nominal(
            "xavier_normal")
    elif site == "spectral_draw":
        # the draw before the division by sigma_1 is xavier_normal's, from
        # the same generator state (a small shape: the SVD is the cost)
        g2 = torch.Generator().manual_seed(1)
        w = init.spectral_xavier_normal((64, 32), g)
        raw = init.xavier_normal((64, 32), 64, 32, g2, torch.float64)
        sigma1 = torch.linalg.svdvals(raw)[0]
        torch.testing.assert_close(w, (raw / sigma1).float())
        return
    elif site == "teacher_dense":
        w, sigma = _dense(FAN_IN, FAN_OUT, g).weight, nominal("lecun_normal")
    else:
        w, fan = _ivp_weight()
        sigma = math.sqrt(1.0 / fan)
    w = w.detach().double()
    np.testing.assert_allclose(w.std().item(), sigma, rtol=2 * TOL)
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 * sigma * 1.0001


def test_truncated_normal_keeps_flax_std():
    g = torch.Generator().manual_seed(2)
    got = init.truncated_normal((FAN_IN, FAN_OUT), g, std=0.02).numpy()
    want = np.asarray(nn.initializers.truncated_normal(stddev=0.02)(
        jax.random.PRNGKey(0), (FAN_IN, FAN_OUT)))
    np.testing.assert_allclose(got.std(), want.std(), rtol=TOL)
    np.testing.assert_allclose(np.abs(got).max(), np.abs(want).max(),
                               rtol=TOL)
