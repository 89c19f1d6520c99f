"""The f32 product of the tiled route, ``vft_gemm_tf32``
(``csrc/vector_field_tiled.cu``), on the CPU: its tile constants frozen
in the source, and the plain version of :func:`tf32_gemm`, which
``chip_smoke.py``'s ``tf32_gemm_vs_plain`` takes in float64 as its
reference, against JAX: the products
by ``jnp.matmul`` at ``precision="highest"``, the GELU epilogues by
``jax.nn.gelu(approximate=False)`` and its ``jax.grad``, the dropout
epilogues' masks from the port's Philox stream as the tiled route's
evaluations take them. Small shapes (M=48 rows of images of 16 padded
tokens, 13 real; N=32; K=16 and 32); tolerance 1e-5 of the output scale
(f32 sums in another order, and erf against JAX's)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.dropout import (DROP_SITE_ATTN_OUT,
                                              DROP_SITE_H,
                                              DROP_SITE_MLP_OUT,
                                              keep_mask_plain)
from odevit_tpu_torch.kernels.tf32_gemm import EPILOGUES, OUTPUTS, tf32_gemm

SRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc" \
    / "vector_field_tiled.cu"
M, N, KS, N_PAD, N_REAL = 48, 32, (16, 32), 16, 13
SEED = 1234567
DROPS = {"gelu_drop": ((DROP_SITE_H, 0.1),),
         "gelu_grad_drop": ((DROP_SITE_H, 0.3),),
         "out_drop": ((DROP_SITE_MLP_OUT, 0.1), (DROP_SITE_ATTN_OUT, 0.2))}
TOL = 1e-5


def test_tile_constants_frozen_in_the_source():
    # 128 x 128 tile, K slices of 32, four landing slots, two warpgroups;
    # the source asserts that a CTA's shared memory fits an SM
    src = SRC.read_text()
    want = {"kTfM": 128, "kTfN": 128, "kTfK": 32, "kTfThreads": 256,
            "kTfLand": 4}
    consts = dict(re.findall(r"\b(kTf\w+) = (\d+);?", src))
    assert {k: int(consts[k]) for k in want} == want
    assert "static_assert(kTfSmem <= 232448" in src
    assert "vft_gemm_f32" not in src


def jax_gelu(v):
    return jax.nn.gelu(v, approximate=False)


def jax_reference(pairs, epi, kw):
    """The epilogue of ``epi`` on the product, in JAX (f32, highest
    precision): {output name: numpy array}."""
    hi = jax.lax.Precision.HIGHEST
    j = lambda t: jnp.asarray(t.numpy())
    c = sum(jnp.matmul(j(a), j(b).T if kw["bt"] else j(b), precision=hi)
            for a, b in pairs)
    bias, aux, res = j(kw["bias"]), j(kw["aux"]), j(kw["res"])
    rs = float(kw["rs"][0])
    scale, dt, alpha = kw["scale"], kw["dt"], kw["alpha"]
    grad = jax.vmap(jax.vmap(jax.grad(jax_gelu)))
    real = (jnp.arange(M) % N_PAD < N_REAL)[:, None]
    masks = []
    for i in range(2):
        site, rate = kw["drops"][i] if i < len(kw["drops"]) else (0, 0.0)
        if rate == 0.0:
            masks.append(jnp.ones((M, N)))
        else:
            m = keep_mask_plain(SEED, site, rate, M // N_PAD, N_PAD, N,
                                device="cpu")
            masks.append(j(m.reshape(M, N)) * real)
    m0, m1 = masks
    out = {
        "round": lambda: {"out": c + bias},
        "scale": lambda: {"out": (c + bias) * scale},
        "gelu": lambda: {"out": jax_gelu(c + bias), "out32": c + bias,
                         "out2": c + bias},
        "gelu_grad": lambda: {"out": c * grad(aux)},
        "gelu_grad_resid": lambda: {
            "out": c * grad(jnp.where(real, res, 0.0)),
            "out2": jax_gelu(jnp.where(real, res, 0.0))},
        "f32": lambda: {"out32": c},
        "advance": lambda: {"out": res + dt * (c * scale)},
        "mac_resid": lambda: {"fout": c + bias,
                              "out32": aux + alpha * rs * (c + bias)},
        "mac_out": lambda: {
            "out": res + dt * ((aux + alpha * rs * (c + bias)) * scale)},
        "gelu_drop": lambda: {"out": jax_gelu(c) * m0, "out32": c,
                              "mask0": m0, "mask1": m1},
        "gelu_grad_drop": lambda: {"out": c * m0 * grad(aux),
                                   "mask0": m0, "mask1": m1},
        "out_drop": lambda: {"out": (c * m0 + aux * m1) * scale,
                             "mask0": m0, "mask1": m1},
    }[epi]()
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("bt", [False, True])
@pytest.mark.parametrize("epi", EPILOGUES)
def test_plain_epilogues_match_jax(epi, bt, pairs):
    rng = np.random.default_rng(EPILOGUES.index(epi))
    r = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    ab = [(r(M, k), r(N, k) if bt else r(k, N)) for k in KS[:pairs]]
    kw = dict(bias=r(N), aux=r(M, N), res=r(M, N), rs=r(1), scale=0.37,
              dt=0.05, alpha=0.5, seed=SEED, drops=DROPS.get(epi, ()),
              n_pad=N_PAD, n_real=N_REAL, bt=bt)
    outs = {k: torch.zeros(M, N) for k in OUTPUTS}
    before = dict(launch_counts)
    tf32_gemm(ab, epi, outs, **kw)
    assert launch_counts == before          # the CPU launches nothing
    want = jax_reference(ab, epi, kw)
    for name in OUTPUTS:
        got = outs[name].numpy()
        if name not in want:
            assert not got.any(), f"{epi} wrote {name}"
            continue
        scale = max(np.abs(want[name]).max(), 1e-30)
        assert np.abs(got - want[name]).max() <= TOL * scale, name


def test_unknown_epilogue_and_three_pairs_raise():
    a, b = torch.zeros(16, 16), torch.zeros(16, 16)
    with pytest.raises(ValueError):
        tf32_gemm([(a, b)], "gelu_tanh", {"out": torch.zeros(16, 16)})
    with pytest.raises(ValueError):
        tf32_gemm([(a, b)] * 3, "f32", {"out32": torch.zeros(16, 16)})
