"""The bf16 product of the tiled route, ``vft_gemm_wgmma``
(``csrc/vector_field_tiled.cu``), on the CPU: its constants frozen in the
source and the WMMA kernel it replaced gone; the plain version of
:func:`bf16_gemm` against JAX, in every epilogue, both layouts, one and
two pairs: the products by ``jnp.matmul`` of the bf16 operands at
``precision="highest"`` (f32 sums), the GELU epilogues by
``jax.nn.gelu(approximate=False)`` and its ``jax.grad``, rounding to bf16
by ``astype`` where the kernel rounds, the dropout epilogues' masks from
the port's Philox stream. Small shapes (M=48 rows of images of 16 padded
tokens, 13 real; N=32; K=16 and 32). Tolerance: one bf16 ulp of the output
scale for the rounded outputs (f32 sums in another order can round to the
neighbouring bf16 value), 1e-5 of the scale for the f32 ones. CPU tensors
take the plain version and launch nothing; what the kernel does not take
raises. No interpret-mode Pallas."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.bf16_gemm import DTYPES, bf16_gemm
from odevit_tpu_torch.kernels.dropout import (DROP_SITE_ATTN_OUT,
                                              DROP_SITE_H,
                                              DROP_SITE_MLP_OUT,
                                              keep_mask_plain)
from odevit_tpu_torch.kernels.tf32_gemm import EPILOGUES, OUTPUTS

CSRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
SRC = CSRC / "vector_field_tiled.cu"
M, N, KS, N_PAD, N_REAL = 48, 32, (16, 32), 16, 13
SEED = 1234567
DROPS = {"gelu_drop": ((DROP_SITE_H, 0.1),),
         "gelu_grad_drop": ((DROP_SITE_H, 0.3),),
         "out_drop": ((DROP_SITE_MLP_OUT, 0.1), (DROP_SITE_ATTN_OUT, 0.2))}
TOL_F32 = 1e-5
ROUNDED = ("out", "out2")


def test_constants_frozen_in_the_source():
    # warpgroup tiles of 128 x 128, K stages of 64 (128 bytes of bf16), a
    # ring of four stages, two consumer warpgroups and a producer
    # warpgroup whose registers setmaxnreg hands to them; the source
    # asserts that the CTA's shared memory (ring, input chunks, staging)
    # fits an SM and the registers the register file
    src = SRC.read_text()
    want = {"kWgM": 128, "kWgN": 128, "kWgK": 64, "kWgStages": 4,
            "kWgConsumers": 256, "kWgRegsProducer": 40,
            "kWgRegsConsumer": 232}
    consts = dict(re.findall(r"\b(kWg\w+) = (\d+)[;,]", src))
    assert {k: int(consts[k]) for k in want} == want
    assert "kWgThreads = kWgConsumers + 128;" in src
    assert "kWgInBytes = 64 * 1024;" in src
    assert "kWgStageOut = 64 * 64 * 4;" in src
    assert 'static_assert(kWgSmem <= 232448, "one CTA an SM' in src
    assert "static_assert(kWgRegsConsumer * kWgConsumers + kWgRegsProducer" \
        in src
    assert "__launch_bounds__(kWgThreads, 1)" in src


def test_the_wmma_product_kernel_is_gone():
    # every bf16 vft::gemm launches vft_gemm_wgmma; the WMMA mainloop is
    # left only to vfs_hidden_bf16
    for path in CSRC.iterdir():
        assert "vft_gemm_bf16" not in path.read_text(), path.name
    src = SRC.read_text()
    body = src[src.index("int gemm(const GemmArgs& g, cudaStream_t st) {"):]
    body = body[:body.index("\n}\n")]
    assert "gemm_bf16<BT, kDrop>(g, st)" in body
    assert "vft_gemm_wgmma<BT, kDrop>" in src
    users = [p.name for p in CSRC.iterdir()
             if "gemm_mainloop<" in p.read_text()]
    assert users == ["vector_field_bwd_split.cu"]


def jax_gelu(v):
    return jax.nn.gelu(v, approximate=False)


def rnd(v):
    return v.astype(jnp.bfloat16).astype(jnp.float32)


def jax_reference(pairs, epi, kw):
    """The epilogue of ``epi`` on the product of the bf16 operands, in
    JAX (f32 sums at highest precision, rounded to bf16 where the kernel
    rounds): {output name: numpy array}."""
    hi = jax.lax.Precision.HIGHEST
    j = lambda t: jnp.asarray(t.float().numpy())
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
    h1 = jnp.where(real, res, 0.0)
    out = {
        "round": lambda: {"out": rnd(c + bias)},
        "scale": lambda: {"out": rnd((c + bias) * scale)},
        "gelu": lambda: {"out": rnd(jax_gelu(c + bias)), "out32": c + bias,
                         "out2": rnd(c + bias)},
        "gelu_grad": lambda: {"out": rnd(c * grad(aux))},
        "gelu_grad_resid": lambda: {"out": rnd(c * grad(h1)),
                                    "out2": rnd(jax_gelu(h1))},
        "f32": lambda: {"out32": c},
        "advance": lambda: {"out": rnd(res + dt * (c * scale))},
        "mac_resid": lambda: {"fout": c + bias,
                              "out32": aux + alpha * rs * (c + bias)},
        "mac_out": lambda: {
            "out": rnd(res + dt * ((aux + alpha * rs * (c + bias))
                                   * scale))},
        "gelu_drop": lambda: {"out": rnd(rnd(jax_gelu(c)) * m0),
                              "out32": c, "mask0": m0, "mask1": m1},
        "gelu_grad_drop": lambda: {"out": rnd(c * m0 * grad(aux)),
                                   "mask0": m0, "mask1": m1},
        "out_drop": lambda: {"out": rnd((c * m0 + aux * m1) * scale),
                             "mask0": m0, "mask1": m1},
    }[epi]()
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}


def case(epi, bt, pairs):
    """Seeded bf16 operands of ``pairs`` pairs, every epilogue input and
    all six outputs (zeros)."""
    rng = np.random.default_rng(EPILOGUES.index(epi))
    r = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    bf = lambda *s: r(*s).to(torch.bfloat16)
    ab = [(bf(M, k), bf(N, k) if bt else bf(k, N)) for k in KS[:pairs]]
    kw = dict(bias=r(N), aux=r(M, N), res=bf(M, N), rs=r(1), scale=0.37,
              dt=0.05, alpha=0.5, seed=SEED, drops=DROPS.get(epi, ()),
              n_pad=N_PAD, n_real=N_REAL, bt=bt)
    outs = {k: torch.zeros(M, N, dtype=DTYPES[k]) for k in OUTPUTS}
    return ab, kw, outs


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("bt", [False, True])
@pytest.mark.parametrize("epi", EPILOGUES)
def test_plain_epilogues_match_jax(epi, bt, pairs):
    ab, kw, outs = case(epi, bt, pairs)
    bf16_gemm(ab, epi, outs, **kw)
    want = jax_reference(ab, epi, kw)
    for name in OUTPUTS:
        got = outs[name].float().numpy()
        if name not in want:
            assert not got.any(), f"{epi} wrote {name}"
            continue
        if name.startswith("mask"):
            assert np.array_equal(got, want[name]), name
            continue
        scale = max(np.abs(want[name]).max(), 1e-30)
        tol = (2.0 ** (np.floor(np.log2(scale)) - 7) if name in ROUNDED
               else TOL_F32 * scale)
        assert np.abs(got - want[name]).max() <= tol, name


@pytest.mark.parametrize("epi", ["round", "gelu_drop", "out_drop"])
def test_cpu_tensors_take_the_plain_version(epi):
    ab, kw, outs = case(epi, False, 2)
    before = dict(launch_counts)
    bf16_gemm(ab, epi, outs, **kw)
    assert launch_counts == before          # the CPU launches nothing
    assert outs["out"].any()


def _bad_calls():
    """(what, pairs, outs, keywords) of calls the kernel does not take."""
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    out = lambda m=M, n=N, dtype=torch.bfloat16: {
        "out": torch.zeros(m, n, dtype=dtype)}
    unaligned = torch.zeros(M * 16 + 1, dtype=torch.bfloat16)[1:]
    return {
        "M not a multiple of 16": ([(bf(40, 16), bf(16, N))], out(40), {}),
        "K not a multiple of 16": ([(bf(M, 24), bf(24, N))], out(), {}),
        "N not a multiple of 16": ([(bf(M, 16), bf(16, 24))], out(n=24), {}),
        "unaligned base": ([(unaligned.view(M, 16), bf(16, N))], out(), {}),
        "not contiguous": ([(bf(16, M).T, bf(16, N))], out(), {}),
        "f32 operands": ([(torch.zeros(M, 16), torch.zeros(16, N))], out(),
                         {}),
        "f32 out": ([(bf(M, 16), bf(16, N))], out(dtype=torch.float32), {}),
        "bf16 aux": ([(bf(M, 16), bf(16, N))], out(), {"aux": bf(M, N)}),
        "pairs of other M": ([(bf(M, 16), bf(16, N)), (bf(32, 16),
                                                       bf(16, N))], out(),
                             {}),
        "three pairs": ([(bf(M, 16), bf(16, N))] * 3, out(), {}),
    }


@pytest.mark.parametrize("what", sorted(_bad_calls()))
def test_what_the_kernel_does_not_take_raises(what):
    pairs, outs, kw = _bad_calls()[what]
    before = dict(launch_counts)
    with pytest.raises(ValueError):
        bf16_gemm(pairs, "round", outs, **kw)
    assert launch_counts == before


def test_unknown_epilogue_raises():
    a = torch.zeros(16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bf16_gemm([(a, a)], "gelu_tanh",
                  {"out": torch.zeros(16, 16, dtype=torch.bfloat16)})
