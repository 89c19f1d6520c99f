"""The port's vector-field kernel module against the JAX package.

On the CPU ``vf_eval`` runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic; here it is held against the JAX kernel's XLA
twin at f32 and against the Pallas kernel itself (interpret mode) at
bf16, for the plain, Euler and stage-advance modes. The CUDA kernel is
held against the plain version on the GPU by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.kernels.vector_field import _pallas_forward, _xla_reference
from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.vector_field import (TOKEN_PAD, VFWeights,
                                                   vf_eval, vf_eval_plain)

D, HEADS, DH, N_REAL, N_PAD, B = 32, 2, 64, 19, 32, 4
SCALER = 4.0


def make_case(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    w = {"cna_s": f(D) + 1.0, "cna_b": f(D), "cnm_s": f(D) + 1.0,
         "cnm_b": f(D), "wqkv": f(D, 3 * D), "wout": f(D, D),
         "w1": f(D, DH), "w2": f(DH, D)}
    x = rng.standard_normal((B, N_PAD, D)).astype(np.float32)
    x[:, N_REAL:] = 0.0
    base = rng.standard_normal((B, N_PAD, D)).astype(np.float32)
    return w, x, base


def torch_weights(w, dtype):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    return VFWeights(t(w["cna_s"], torch.float32),
                     t(w["cna_b"], torch.float32),
                     t(w["cnm_s"], torch.float32),
                     t(w["cnm_b"], torch.float32),
                     t(w["wqkv"]), t(w["wout"]), t(w["w1"]), t(w["w2"]))


def jax_args(w):
    return [jnp.asarray(w[k]) for k in ("cna_s", "cna_b", "cnm_s", "cnm_b",
                                        "wqkv", "wout", "w1", "w2")]


MODES = [("plain", 0.0), ("euler", 0.25), ("base", 0.125)]


@pytest.mark.parametrize("mode,dt", MODES)
def test_plain_version_matches_xla_reference_f32(mode, dt):
    w, x, base = make_case()
    ref = np.asarray(_xla_reference(jnp.asarray(x), *jax_args(w),
                                    num_heads=HEADS, scaler=SCALER,
                                    n_real=N_REAL))
    if mode == "euler":
        ref = x + dt * ref
    elif mode == "base":
        ref = base + dt * ref
    got = vf_eval_plain(torch.from_numpy(x), torch_weights(w, torch.float32),
                        num_heads=HEADS, scaler=SCALER, n_real=N_REAL,
                        mode=mode, dt=dt,
                        base=torch.from_numpy(base) if mode == "base"
                        else None).numpy()
    np.testing.assert_allclose(got[:, :N_REAL], ref[:, :N_REAL],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,dt", MODES)
def test_plain_version_matches_pallas_kernel_bf16(mode, dt):
    """bf16 against the Pallas kernel (interpret mode), which rounds where
    the port rounds. Tolerance: 2 bf16 ulps (2^-7 relative) of the output
    scale, for erf polynomial vs exact erf and sums taken in another
    order flipping an intermediate bf16 rounding."""
    w, x, base = make_case(1)
    xb = jnp.asarray(x, jnp.bfloat16)
    bb = jnp.asarray(base, jnp.bfloat16) if mode == "base" else None
    ref = _pallas_forward(xb, *jax_args(w), num_heads=HEADS, scaler=SCALER,
                          block_b=2, n_real=N_REAL, euler_dt=dt, base=bb)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = vf_eval_plain(xt, torch_weights(w, torch.bfloat16),
                        num_heads=HEADS, scaler=SCALER, n_real=N_REAL,
                        mode=mode, dt=dt,
                        base=torch.from_numpy(base).to(torch.bfloat16)
                        if mode == "base" else None)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(ref[:, :N_REAL]).max()
    np.testing.assert_allclose(got[:, :N_REAL], ref[:, :N_REAL],
                               atol=2 ** -7 * scale, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_padded_rows_does_not_reach_real_rows(dtype):
    w, x, _ = make_case(2)
    wt = torch_weights(w, dtype)
    clean = torch.from_numpy(x).to(dtype)
    dirty = clean.clone()
    dirty[:, N_REAL:N_REAL + 3] = float("nan")
    dirty[:, N_REAL + 3:] = 1e30
    kw = dict(num_heads=HEADS, scaler=SCALER, n_real=N_REAL, mode="euler",
              dt=0.25)
    a = vf_eval(clean, wt, **kw)
    b = vf_eval(dirty, wt, **kw)
    assert torch.isfinite(b[:, :N_REAL]).all()
    assert torch.equal(a[:, :N_REAL], b[:, :N_REAL])


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    w, x, _ = make_case(3)
    wt = torch_weights(w, torch.float32)
    before = launch_counts["vf_eval"]
    kw = dict(num_heads=HEADS, scaler=SCALER, n_real=N_REAL)
    got = vf_eval(torch.from_numpy(x), wt, **kw)
    want = vf_eval_plain(torch.from_numpy(x), wt, **kw)
    assert torch.equal(got, want)
    assert launch_counts["vf_eval"] == before


@pytest.mark.parametrize("bad", ["unpadded", "n_real", "mode", "base",
                                 "heads", "weight"])
def test_bad_arguments_raise(bad):
    w, x, base = make_case(4)
    wt = torch_weights(w, torch.float32)
    xt = torch.from_numpy(x)
    kw = dict(num_heads=HEADS, scaler=SCALER, n_real=N_REAL, mode="plain")
    if bad == "unpadded":
        xt = xt[:, :N_PAD - 1]
        assert (N_PAD - 1) % TOKEN_PAD
    elif bad == "n_real":
        kw["n_real"] = N_PAD + 1
    elif bad == "mode":
        kw["mode"] = "heun"
    elif bad == "base":
        kw["mode"] = "base"
    elif bad == "heads":
        kw["num_heads"] = 3
    else:
        wt = wt._replace(w2=wt.w2[:, :-1])
    with pytest.raises(ValueError):
        vf_eval(xt, wt, **kw)
