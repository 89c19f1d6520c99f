"""The weight products of every backward, ``vfb_wgrad_wgmma`` (bf16) and
``vfb_wgrad_tf32`` (f32; ``csrc/vector_field_bwd.cu``), on the CPU: the
plain version of :func:`weight_bars` against JAX's ``jnp.dot(a.T, g,
preferred_element_type=jnp.float32)`` on the same numpy-seeded bf16
operands (ragged sizes, one and four products; tolerance 1e-5 of the
output scale: bf16 products are exact in f32, the sums over 300 rows run
in another order), CPU tensors of either dtype taking the plain version,
the split rules of both dtypes frozen at the training cells' shapes with
their invariants, the kernels' tile, slice and stage constants frozen in
the source, and the wrapper's checks. ``chip_smoke.py``'s
``wgrad_vs_plain`` holds the kernels themselves against a float64
product on the card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels.macaron_bwd import wgrad_splits
from odevit_tpu_torch.kernels.vector_field_bwd import (
    _SMS, TG_ROWS, WB_MIN_SLICE, WB_ROWS, WB_TILES, weight_splits,
    wgrad_tile)
from odevit_tpu_torch.kernels.wgrad import weight_bars, weight_bars_plain

CSRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
SRC = CSRC / "vector_field_bwd.cu"
TOL = 1e-5
ROWS = 300
PAIRS = {"one": ((48, 80),),
         "four": ((48, 80), (32, 16), (64, 192), (16, 48))}


def operands(shapes, seed=0):
    """(torch bf16, jax bf16) pairs of the same values: N(0.5, 1) and
    N(0.25, 1) rounded to bf16."""
    rng = np.random.default_rng(seed)
    out = []
    for m, n in shapes:
        pair = []
        for width, mean in ((m, 0.5), (n, 0.25)):
            t = torch.from_numpy(
                rng.normal(mean, 1.0, (ROWS, width)).astype(np.float32)
            ).bfloat16()
            pair.append((t, jnp.asarray(t.float().numpy(), jnp.bfloat16)))
        out.append(pair)
    return out


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plain_matches_jax(name):
    pairs = operands(PAIRS[name])
    got = weight_bars_plain([(a, g) for (a, _), (g, _) in pairs])
    for ((_, ja), (_, jg)), x in zip(pairs, got):
        ref = np.asarray(jnp.dot(ja.T, jg,
                                 preferred_element_type=jnp.float32))
        assert x.dtype == torch.float32 and x.shape == ref.shape
        err = np.abs(x.numpy() - ref).max() / np.abs(ref).max()
        assert err <= TOL, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_cpu_tensors_take_the_plain_version(name, dtype):
    pairs = [(a.to(dtype), g.to(dtype))
             for (a, _), (g, _) in operands(PAIRS[name], seed=1)]
    before = dict(launch_counts)
    got = weight_bars(pairs)
    assert launch_counts == before
    for x, y in zip(got, weight_bars_plain(pairs)):
        assert torch.equal(x, y)


# the training cells' bf16 weight products: (rows, (M, N) of each problem)
# and their slices; the Macaron passes take wgrad_splits' one number
D, DH = 768, 768
CELLS = {
    "cifar": (1024 * 80, 192, 768, None, 7),
    "tsbase224": (64 * 208, D, DH, None, 3),
    "r4_mlp": (64 * 208, D, 3072, ((D, 3072), (3072, D)), 3),
    "r4_attn": (64 * 208, D, 0, ((D, 3 * D), (D, D)), 5),
    "tsbase384": (64 * 592, D, DH, None, 3),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_splits_frozen_at_the_cells(cell):
    rows, d, dh, shapes, want = CELLS[cell]
    assert weight_splits(rows, d, dh, shapes, dtype=torch.bfloat16) == want
    with pytest.raises(TypeError):      # every caller names the dtype
        weight_splits(rows, d, dh, shapes)


def test_macaron_passes_take_the_combined_rule():
    assert wgrad_splits(torch.bfloat16, 1024 * 80, 192, 768) == 7
    assert wgrad_splits(torch.bfloat16, 1024 * 80, 192, 768) == \
        weight_splits(1024 * 80, 192, 768, dtype=torch.bfloat16)


def test_split_invariants():
    for rows in (1, 300, 511, 1023, 1024, 4096, 13312, 37888, 81920,
                 163840):
        for d in (64, 192, 384, 768, 1024):
            for dh in (d, 2 * d, 4 * d):
                s = weight_splits(rows, d, dh, dtype=torch.bfloat16)
                # fixed by the shape
                assert s == weight_splits(rows, d, dh, dtype=torch.bfloat16)
                assert 1 <= s <= max(1, rows // WB_MIN_SLICE)
                if rows < 2 * WB_MIN_SLICE:
                    assert s == 1
                if s > 1:
                    # each slice at least 512 rows, in whole stages
                    per = -(-rows // s)
                    per = -(-per // WB_ROWS) * WB_ROWS
                    assert per >= WB_MIN_SLICE and per % WB_ROWS == 0
                    assert (s - 1) * per < rows          # none empty
                # the fewest slices whose CTAs fill 9/10 of their waves on
                # 132 SMs; where none up to the most slices does, the
                # fullest
                tiles = sum(-(-m // WB_TILES[wgrad_tile(m, n)][0])
                            * -(-n // WB_TILES[wgrad_tile(m, n)][1])
                            for m, n in ((d, 3 * d), (d, d), (d, dh),
                                         (dh, d)))
                fill = lambda k: tiles * k / (-(-tiles * k // _SMS) * _SMS)
                full = lambda k: (k - 1) * (-(-(-(-rows // k)) // WB_ROWS)
                                            * WB_ROWS) < rows
                ks = [k for k in range(1, max(1, rows // WB_MIN_SLICE) + 1)
                      if full(k)]
                if fill(s) >= 0.9:
                    assert all(fill(k) < 0.9 for k in ks if k < s)
                else:
                    assert all(fill(s) >= fill(k) for k in ks)


# vfb_wgrad_tf32's slices at the same cells: the same rule in whole
# slices of 32 rows
F32_SPLITS = {"cifar": 7, "tsbase224": 3, "r4_mlp": 3, "r4_attn": 5,
              "tsbase384": 3}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_f32_splits_frozen_at_the_cells(cell):
    rows, d, dh, shapes, _ = CELLS[cell]
    s = weight_splits(rows, d, dh, shapes, dtype=torch.float32)
    assert s == F32_SPLITS[cell]
    # fixed by the shape
    assert s == weight_splits(rows, d, dh, shapes, dtype=torch.float32)
    assert 1 <= s <= max(1, rows // WB_MIN_SLICE)
    # whole 32-row slices of at least 512 rows, none empty
    per = -(-(-(-rows // s)) // TG_ROWS) * TG_ROWS
    assert per % TG_ROWS == 0 and per >= WB_MIN_SLICE
    assert (s - 1) * per < rows
    # the fewest slices whose CTAs fill 9/10 of their waves on 132 SMs
    tiles = sum(-(-m // WB_TILES[wgrad_tile(m, n)][0])
                * -(-n // WB_TILES[wgrad_tile(m, n)][1])
                for m, n in shapes or ((d, 3 * d), (d, d), (d, dh),
                                       (dh, d)))
    fill = lambda k: tiles * k / (-(-tiles * k // _SMS) * _SMS)
    assert fill(s) >= 0.9 and all(fill(k) < 0.9 for k in range(1, s))


@pytest.mark.parametrize("m, n, tile", [
    (192, 576, 1), (192, 192, 1), (192, 768, 1), (768, 192, 1),
    (768, 768, 0), (768, 2304, 0), (3072, 768, 0), (768, 3072, 0),
    (48, 80, 1), (128, 128, 0)])
def test_tile_choice(m, n, tile):
    # the tile that pads less; 128 x 128 on a tie
    assert wgrad_tile(m, n) == tile


def wgmma_constants(src):
    # vfb_wgrad_wgmma: stages of 64 rows, four 64-column boxes (128 bytes)
    # a stage, a ring of six, a fresh accumulator every eight stages, two
    # consumer warpgroups and a producer warp, slices of at least 512
    # rows, 132 SMs
    want = {"kWbRows": WB_ROWS, "kWbBox": 64, "kWbBoxes": 4,
            "kWbStages": 6, "kWbChunk": 8, "kWbConsumers": 256,
            "kWbMinSlice": WB_MIN_SLICE, "kWbSms": _SMS}
    consts = dict(re.findall(r"constexpr int (kWb\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in want} == want
    assert "static_assert(kWbSmem <= 232448" in src
    # the two tiles of wb_kind, in WB_TILES' order
    assert WB_TILES == ((128, 128), (64, 192))
    body = re.search(r"inline int wb_kind\(int m, int n\) \{(.*?)\n\}",
                     src, re.S).group(1)
    assert "* 128 * 128" in body and "* 64 * 192" in body
    # the WMMA kernel it replaced is gone
    assert "vfb_wgrad_bf16" not in src
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src


def tf32_constants(src):
    # vfb_wgrad_tf32: slices of 32 rows through three landing slots, two
    # warpgroups, landed rows of 136 (A, 128 + 8) and 196 (G, 192 + 4)
    # floats
    want = {"kTgRows": TG_ROWS, "kTgLand": 3, "kTgThreads": 256,
            "kTgLdA": 136, "kTgLdG": 196}
    consts = dict(re.findall(r"constexpr int (kTg\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in want} == want
    assert "static_assert(kTgSmem <= 232448" in src
    # a warp's A fragment loads, A(m, k) at landed row k, column m (m =
    # lane / 4 + const, k = lane % 4 + const), fall on 32 banks
    ld = want["kTgLdA"]
    assert len({(k * ld + m) % 32 for k in range(4) for m in range(8)}) == 32
    # the launcher's slices are the Python rule's steps
    assert "slice_rows(ps.rows, splits, kTgRows)" in src
    assert "tbytes == 2 ? kWbRows : kTgRows" in src
    # split TF32 on wgmma (the instructions live in split_tf32.cuh); the
    # CUDA-core kernel it replaced is gone
    assert "vf::wgmma_tf32_m64n128_rs" in src
    assert "vf::wgmma_tf32_m64n96_rs" in src
    header = (CSRC / "split_tf32.cuh").read_text()
    for n in (96, 128):
        assert (f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32"
                in header)
    assert "vfb_wgrad_f32" not in src and "wgrad_cuda_f32" not in src


@pytest.mark.parametrize("kernel", ["vfb_wgrad_wgmma", "vfb_wgrad_tf32"])
def test_constants_frozen_in_the_source(kernel):
    check = {"vfb_wgrad_wgmma": wgmma_constants,
             "vfb_wgrad_tf32": tf32_constants}[kernel]
    check(SRC.read_text())


def bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", [
    "no pairs", "five pairs", "float16", "mixed dtypes", "rows differ",
    "m not a multiple of 16", "n not a multiple of 16", "not 2-D",
    "not contiguous"])
def test_wrapper_raises(case):
    a, g = bf16(64, 32), bf16(64, 48)
    pairs = {
        "no pairs": [],
        "five pairs": [(a, g)] * 5,
        "float16": [(a.half(), g.half())],
        "mixed dtypes": [(a, g.float())],
        "rows differ": [(a, bf16(32, 48))],
        "m not a multiple of 16": [(bf16(64, 24), g)],
        "n not a multiple of 16": [(a, bf16(64, 40))],
        "not 2-D": [(bf16(2, 32, 32), g)],
        "not contiguous": [(bf16(32, 64).T, g)],
    }[case]
    with pytest.raises((ValueError, TypeError)):
        weight_bars(pairs)
