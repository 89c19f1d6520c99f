"""The serving kernels of the 224 px student, in their plain versions,
against the JAX package: the Euler and stage-advance modes at the TS-Base
token count (207 real tokens of 208), which the tiled route carries on the
GPU, and the chained Euler kernel; and the ctypes side of the tiled route's
new modes. The CUDA kernels are held against these plain versions on the
GPU by ``chip_smoke.py``.

Tolerances (max|got - want| over max|want|), as in
``tests/test_torch_kernels.py``: float32 1e-5 against the XLA twin,
bfloat16 2 ulps (2^-7) of the output scale against the Pallas kernel in
interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import (_pallas_forward, _xla_reference,
                                             fused_euler_chain_from_params)
from odevit_tpu_torch.kernels import launch_counts, tiled
from odevit_tpu_torch.kernels.vector_field import (VFWeights, vf_eval,
                                                   vf_eval_plain,
                                                   vf_euler_chain,
                                                   vf_euler_chain_plain)

# TS-Base's token count at narrow widths
D, HEADS, DH, N_REAL, N_PAD, B = 64, 4, 64, 207, 208, 2
SCALER = 12.0


def make_case(seed, n_real=N_REAL, n_pad=N_PAD, d=D, dh=DH, b=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = {"cna_s": f(d) + 1.0, "cna_b": f(d), "cnm_s": f(d) + 1.0,
         "cnm_b": f(d), "wqkv": f(d, 3 * d), "wout": f(d, d), "w1": f(d, dh),
         "w2": f(dh, d)}
    x = rng.standard_normal((b, n_pad, d)).astype(np.float32)
    x[:, n_real:] = 0.0
    base = rng.standard_normal((b, n_pad, d)).astype(np.float32)
    return w, x, base


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(*(t(w[k], torch.float32)
                       for k in ("cna_s", "cna_b", "cnm_s", "cnm_b")),
                     *(t(w[k]) for k in ("wqkv", "wout", "w1", "w2")))


def jax_args(w):
    return [jnp.asarray(w[k]) for k in ("cna_s", "cna_b", "cnm_s", "cnm_b",
                                        "wqkv", "wout", "w1", "w2")]


def vf_params(w):
    a = lambda k: jnp.asarray(w[k])
    return {"norm_attn": {"scale": a("cna_s"), "bias": a("cna_b")},
            "norm_mlp": {"scale": a("cnm_s"), "bias": a("cnm_b")},
            "attn": {"qkv_kernel": a("wqkv"), "out_kernel": a("wout")},
            "mlp": {"fc1_kernel": a("w1"), "fc2_kernel": a("w2")}}


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


MODES = [("euler", 1.0 / 24), ("base", 1.0 / 18)]


@pytest.mark.parametrize("mode,dt", MODES)
def test_advance_modes_match_the_xla_twin_f32(mode, dt):
    """x + dt f(x) (Euler) and base + dt f(x) (stage advance), f in f32."""
    w, x, base = make_case(0)
    f = np.asarray(_xla_reference(jnp.asarray(x), *jax_args(w),
                                  num_heads=HEADS, scaler=SCALER,
                                  n_real=N_REAL))
    want = (x if mode == "euler" else base) + dt * f
    got = vf_eval_plain(torch.from_numpy(x), torch_weights(w, torch.float32),
                        num_heads=HEADS, scaler=SCALER, n_real=N_REAL,
                        mode=mode, dt=dt,
                        base=torch.from_numpy(base) if mode == "base"
                        else None).numpy()
    assert rel(got[:, :N_REAL], want[:, :N_REAL]) <= 1e-5


@pytest.mark.parametrize("mode,dt", MODES)
def test_advance_modes_match_the_pallas_kernel_bf16(mode, dt):
    """The TPU kernel's ``euler_dt`` and ``base`` paths (interpret mode),
    which round where the port rounds."""
    w, x, base = make_case(1)
    xb = jnp.asarray(x, jnp.bfloat16)
    bb = jnp.asarray(base, jnp.bfloat16) if mode == "base" else None
    want = np.asarray(_pallas_forward(
        xb, *jax_args(w), num_heads=HEADS, scaler=SCALER, block_b=1,
        n_real=N_REAL, euler_dt=dt, base=bb).astype(jnp.float32))
    got = vf_eval_plain(torch.from_numpy(x).bfloat16(),
                        torch_weights(w, torch.bfloat16), num_heads=HEADS,
                        scaler=SCALER, n_real=N_REAL, mode=mode, dt=dt,
                        base=torch.from_numpy(base).bfloat16()
                        if mode == "base" else None)
    assert got.dtype == torch.bfloat16
    assert rel(got[:, :N_REAL].float().numpy(), want[:, :N_REAL]) <= 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", [2, 3])
def test_chain_matches_the_pallas_chain_kernel(dtype, chain):
    """``vf_euler_chain`` (on the CPU its plain version) against
    ``fused_euler_chain_from_params`` (``_vf_euler_chain_kernel``,
    interpret mode), at a shape one image per CTA takes on the GPU; and
    bit for bit ``chain`` per-step Euler evaluations."""
    n_real, n_pad = 19, 32
    w, x, _ = make_case(2, n_real=n_real, n_pad=n_pad, d=32, dh=64, b=4)
    dt, heads = 1.0 / 12, 2
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(fused_euler_chain_from_params(
        jnp.asarray(x, jd), vf_params(w), num_heads=heads, scaler=SCALER,
        dt=dt, chain=chain, block_b=2, n_real=n_real).astype(jnp.float32))
    xt, wt = torch.from_numpy(x).to(td), torch_weights(w, td)
    kw = dict(num_heads=heads, scaler=SCALER, n_real=n_real, dt=dt)
    before = dict(launch_counts)
    got = vf_euler_chain(xt, wt, chain=chain, **kw)
    assert launch_counts == before          # the CPU runs the plain version
    assert got.dtype == td
    assert torch.equal(got, vf_euler_chain_plain(xt, wt, chain=chain, **kw))
    step = xt
    for _ in range(chain):
        step = vf_eval(step, wt, mode="euler", **kw)
    assert torch.equal(got, step)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert rel(got[:, :n_real].float().numpy(), want[:, :n_real]) <= tol


def test_advance_modes_take_no_dropout():
    """JAX has no dropout Euler or stage-advance route: a nonzero rate
    raises; rates of 0 with a seed are the deterministic route."""
    w, x, _ = make_case(3)
    xt, wt = torch.from_numpy(x), torch_weights(w, torch.float32)
    kw = dict(num_heads=HEADS, scaler=SCALER, n_real=N_REAL, mode="euler",
              dt=0.1)
    with pytest.raises(ValueError, match="dropout"):
        vf_eval(xt, wt, seed=3, drops=(0.1, 0.0, 0.0), **kw)
    assert torch.equal(vf_eval(xt, wt, seed=3, drops=(0.0, 0.0, 0.0), **kw),
                       vf_eval(xt, wt, **kw))
    with pytest.raises(ValueError, match="chain"):
        vf_euler_chain(xt, wt, num_heads=HEADS, scaler=SCALER, n_real=N_REAL,
                       dt=0.1, chain=0)


def _c_enum(src: str, name: str) -> dict:
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def test_tiled_modes_and_arguments_match_the_kernels():
    """``tiled.MODES`` are the values the C forward switches on, and
    ``make_args`` carries the stage base and the step into ``TiledArgs``
    (whose field order ``test_tiled_arguments_match_the_kernel_struct``
    holds)."""
    src = (Path(tiled.__file__).resolve().parent.parent / "csrc"
           / "vector_field_tiled.cu").read_text()
    enums = {**_c_enum(src, "AttnMode"), **_c_enum(src, "ForwardMode")}
    assert enums == {"kPlain": 0, "kJasmin": 1, "kMap": 2, "kEuler": 3,
                     "kBase": 4}
    assert tiled.MODES == {"plain": 0, "jasmin": 1, "attn": 2, "euler": 3,
                           "base": 4}
    assert "kAdvance = 8" in src
    w, x, base = make_case(4)
    xt, bt = torch.from_numpy(x), torch.from_numpy(base)
    args = tiled.make_args(xt, torch_weights(w, torch.float32),
                           {"base": bt}, num_heads=HEADS, scaler=SCALER,
                           n_real=N_REAL, mt=64, mode="base", dt=0.25)
    assert args.base == bt.data_ptr() and args.x == xt.data_ptr()
    assert args.mode == 4 and args.dt == 0.25 and args.scaler == SCALER
    assert not tiled.make_args(xt, torch_weights(w, torch.float32), {},
                               num_heads=HEADS, scaler=SCALER, n_real=N_REAL,
                               mt=64).base
