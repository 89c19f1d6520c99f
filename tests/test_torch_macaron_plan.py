"""The Macaron backward's one-CTA plans and routes (no JAX, no kernels).

The f32 backward lays its CTA out by ``f32_layout`` (``make_plan_f32`` of
``csrc/macaron_bwd.cu``); which shapes take the one-CTA route is fixed by
``mcb_rows``'s own layout, so the routes below are frozen as they were
before the f32 layout changed: over ``chip_smoke.py::macaron_plans_agree``'s
sweep, the shapes whose (n_pad, D, heads) is listed take the one-CTA route
at every MLP ratio, every other shape the tiled route.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from odevit_tpu_torch.kernels.macaron import macaron_route
from odevit_tpu_torch.kernels.macaron_bwd import (_Args, _BLOCKS,
                                                  f32_layout,
                                                  macaron_bwd_plan,
                                                  wgrad_splits)
from odevit_tpu_torch.kernels.vector_field import _MAX_SMEM

N_PADS = (16, 32, 64, 80, 96, 128, 144)
WIDTHS = ((32, 2), (64, 2), (128, 2), (192, 3), (256, 4), (384, 6), (192, 12))
RATIOS = (1, 2, 4)
ALL = WIDTHS
SMALL_HEADS = ((32, 2), (64, 2), (192, 12))

# n_pad -> (D, heads) routed to one CTA, by (dtype, backward)
ONE_CTA = {
    ("bfloat16", False): {16: ALL, 32: ALL, 64: ALL,
                          80: tuple(w for w in ALL if w != (384, 6)),
                          96: ((32, 2), (64, 2), (128, 2), (192, 3),
                               (192, 12)),
                          128: ((32, 2), (64, 2))},
    ("bfloat16", True): {16: ALL, 32: ALL, 64: ALL, 80: ALL, 96: ALL,
                         128: SMALL_HEADS},
    ("float32", False): {16: ALL, 32: ALL, 64: ALL,
                         80: tuple(w for w in ALL if w != (384, 6)),
                         96: ((32, 2), (64, 2), (128, 2), (192, 12)),
                         128: ((32, 2),)},
    ("float32", True): {16: ALL, 32: ALL, 64: ALL, 80: ALL,
                        96: SMALL_HEADS},
}
COUNTS = {("bfloat16", False): 102, ("bfloat16", True): 114,
          ("float32", False): 96, ("float32", True): 93}


def sweep():
    for n in N_PADS:
        for d, heads in WIDTHS:
            for r in RATIOS:
                yield n, d, heads, r * d


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_routes_over_the_sweep_are_as_before(dtype, bwd):
    cta = ONE_CTA[dtype, bwd]
    count = 0
    for n, d, heads, dh in sweep():
        want = "cta" if (d, heads) in cta.get(n, ()) else "tiled"
        got = macaron_route(getattr(torch, dtype), n, n - 3, d, heads, dh,
                            bwd)
        assert got == want, (dtype, bwd, n, d, heads, dh)
        count += want == "cta"
    assert count == COUNTS[dtype, bwd]


def f32_plans():
    for n, d, heads, dh in sweep():
        plan = macaron_bwd_plan(torch.float32, n, n - 3, d, heads, dh)
        if plan is not None:
            yield (n, d, heads, dh), plan


def test_the_cifar_f32_plan_fits_and_its_strides_are_aligned():
    hc, smem, nb = macaron_bwd_plan(torch.float32, 80, 65, 192, 3, 768)
    lay = f32_layout(80, hc, nb)
    assert smem == lay["total"] <= 232448 == _MAX_SMEM
    assert (hc, nb) == (128, 192)
    # 16-byte copies: every staged row and plane starts on 4 floats
    for key in ("slot", "ld_h", "ld_p", "ld_b", "ld_k"):
        assert lay[key] % 4 == 0, key
    for key in ("ring", "pre", "hbig", "hsmall", "st", "pf", "pbig",
                "psmall"):
        assert lay[key] % 128 == 0, key


@pytest.mark.parametrize("part", ["fits", "banks", "warps"])
def test_every_f32_plan_of_the_sweep(part):
    plans = dict(f32_plans())
    assert len(plans) == COUNTS["float32", True]
    for (n, d, heads, dh), (hc, smem, nb) in plans.items():
        lay = f32_layout(n, hc, nb)
        if part == "fits":
            assert smem == lay["total"] <= _MAX_SMEM
            assert dh % hc == 0 and nb in _BLOCKS
        elif part == "banks":
            # fragment rows read 4g + t (row-major planes) and 8t + g
            # (a row-major B slice): 32 distinct banks
            for key in ("ld_h", "ld_p", "ld_k"):
                assert lay[key] % 16 == 4, (n, key)
            assert lay["ld_b"] % 16 == 8
        else:
            # one round of warp tiles: column groups of 32 times row
            # groups of up to 3 m16 tiles fit the 12 warps
            assert -(-nb // 32) * -(-(n // 16) // 3) <= 12


def test_bf16_plans_keep_their_layout():
    hc, smem, nb = macaron_bwd_plan(torch.bfloat16, 80, 65, 192, 3, 768)
    assert (hc, smem, nb) == (128, 150912, 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_weight_splits_are_fixed_by_the_shape(dtype):
    dt = getattr(torch, dtype)
    cifar = wgrad_splits(dt, 1024 * 80, 192, 768)
    assert cifar == wgrad_splits(dt, 1024 * 80, 192, 768)
    assert 1 <= cifar <= 1024 * 80 // 256
    # each slice at least 256 rows
    assert wgrad_splits(dt, 300, 192, 768) == 1
    if dt == torch.float32:
        # about four CTAs per SM in the smaller pass of 128 x 64 tiles
        tiles = 2 * 9 + 2 * 3
        assert cifar == -(-4 * 132 // tiles)


def test_args_mirror_mcbargs_field_for_field():
    src = (Path(__file__).resolve().parents[1] / "odevit_tpu_torch" /
           "csrc" / "macaron_bwd.cu").read_text()
    body = re.search(r"struct McbArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        decl = re.sub(r"^(const\s+)?(void|float|int)\s*\*?\s*", "", line)
        names += [n.strip().lstrip("*") for n in decl.split(",")]
    assert names == [name for name, _ in _Args._fields_]
