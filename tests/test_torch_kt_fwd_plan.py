"""The bf16 softmax forward past 256 padded tokens, ``vft_attn_kt_fwd``
(``csrc/vector_field_tiled.cu``): which attention CTA each tiled forward
takes (the rule of ``vft::attn``, in the plan's forward bytes), the new
CTA's shared
memory (``_ktf_smem``, the Python copy of ``ktf_plan``) within 227 KB at
every head width from 16 to 256 and every n_pad from 272 to 1,024, ±
dropout, and no bf16 shape that had a plan before the forward's redesign
losing it. Needs no JAX and no card: the rules are Python, and the card
holds them against ``vft_plan`` (``chip_smoke.py``, ``long_plans_agree``)
and counts which CTA ran (``vft_kt_fwd_launches``)."""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from odevit_tpu_torch.kernels.tiled import (_B_THREADS, _KEY_TILE,
                                            _KEYB_SMEM, _LANE_LISTS, _LD_STG,
                                            _MAX_JAS, _MAX_SMEM, _Q_TILES,
                                            _kt_smem, _ktb_smem, _ktf_smem,
                                            key_tiled, tiled_plan_rule)

SOURCE = (Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
          / "vector_field_tiled.cu").read_text()
N_PADS = (272, 400, 592, 1024)
# the forward attention CTA by (past 256 padded tokens, dtype, L2)
BF16, F32 = torch.bfloat16, torch.float32
CTAS = {(False, BF16, False): "vft_attn", (False, BF16, True): "vft_attn",
        (False, F32, False): "vft_attn", (False, F32, True): "vft_attn",
        (True, BF16, False): "vft_attn_kt_fwd",
        (True, BF16, True): "vft_attn_kt",
        (True, F32, False): "vft_attn_kt", (True, F32, True): "vft_attn_kt"}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_pad", [256, 272, 592])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_cta(dtype, l2, drop, n_pad, hd):
    # whole rows up to 256 padded tokens; past that the new CTA for bf16
    # softmax, whatever the dropout and head width, the first key-tiled
    # CTA for f32 and L2: the plan's forward bytes are that CTA's
    heads = 12
    cta = CTAS[n_pad > 256, dtype, l2]
    assert key_tiled(n_pad) == (cta != "vft_attn")
    if cta == "vft_attn":
        return
    plan = tiled_plan_rule(dtype, n_pad, n_pad - 5, hd * heads, heads,
                           hd * heads, drop, l2)
    tb = torch.empty((), dtype=dtype).element_size()
    fwd = (_ktf_smem(hd) if cta == "vft_attn_kt_fwd"
           else _kt_smem(hd, plan[0], tb, False))
    assert plan[1] == fwd
    if cta == "vft_attn_kt_fwd":
        # the bytes tell the two CTAs apart at these widths
        assert fwd != _kt_smem(hd, plan[0], tb, False)


@pytest.mark.parametrize("hd", range(16, 257, 16))
def test_new_cta_fits_every_head_width(hd):
    # Q, staging, two ring slots of K and V and the lanes' JaSMin lists
    # within the shared memory at every width to 256, the same bytes at
    # every n_pad and with dropout, in the plan of every head count
    tile = _KEY_TILE * (hd + 8) * 2
    fixed = tile + _KEY_TILE * _LD_STG * 2 + _LANE_LISTS
    assert _ktf_smem(hd) == fixed + 2 * 2 * tile <= _MAX_SMEM
    for heads in (1, 4, 12):
        for n_pad in N_PADS:
            for drop in (False, True):
                plan = tiled_plan_rule(torch.bfloat16, n_pad, n_pad - 5,
                                       hd * heads, heads, hd * heads, drop)
                assert plan is not None and plan[1] == _ktf_smem(hd)
                assert max(plan[1:]) <= _MAX_SMEM


@pytest.mark.parametrize("n_pad", [272, 592, 1024, 4096])
def test_no_bf16_shape_loses_its_plan(n_pad):
    # the rule before this forward: the first key-tiled forward CTA beside
    # the register backward pair, all within the shared memory
    for heads in (1, 3, 4, 12):
        for hd in range(16, 529, 16):
            d = hd * heads
            for drop in (False, True):
                before = any(max(_kt_smem(hd, mt, 2, False),
                                 _ktb_smem(hd, n_pad, drop),
                                 _KEYB_SMEM) <= _MAX_SMEM
                             for mt in _Q_TILES)
                plan = tiled_plan_rule(torch.bfloat16, n_pad, n_pad - 5, d,
                                       heads, d, drop)
                assert (plan is not None) >= before, (n_pad, d, heads, drop)
                if plan is not None:
                    assert plan[1] == _ktf_smem(hd)
                    assert max(plan[1:]) <= _MAX_SMEM


@pytest.mark.parametrize("hd,stages", [(64, 2), (256, 2), (288, 2),
                                       (304, 1), (480, 1)])
def test_ring_slots(hd, stages):
    # two K/V slots up to hd = 288, one past it (where two and the lists
    # do not fit)
    tile = _KEY_TILE * (hd + 8) * 2
    fixed = tile + _KEY_TILE * _LD_STG * 2 + _LANE_LISTS
    assert _ktf_smem(hd) == fixed + stages * 2 * tile <= _MAX_SMEM


def test_the_384px_layout():
    # the TS-Base student at 384 px: hd = 64, Q 9,216, staging 9,216, two
    # slots of K and V 36,864, then the lists: kMaxJas values and columns
    # of two rows for each of 128 threads, 32,768 at most (the JaSMin
    # mode's launches take kk entries: 6,144 bytes at the recipe's k = 2;
    # four CTAs of the other modes fit an SM's 227 KB)
    assert _LANE_LISTS == 2 * 2 * _MAX_JAS * _B_THREADS * 4 == 32768
    assert _ktf_smem(64) == 9216 + 9216 + 36864 + 32768 == 88064
    assert 4 * (_ktf_smem(64) - _LANE_LISTS) <= _MAX_SMEM


def test_the_rules_are_the_sources():
    # ktf_plan's layout, the route of vft::attn and the C counter, as the
    # Python copies above read them
    plan = SOURCE[SOURCE.index("inline KtfPlan ktf_plan(int hd)"):]
    plan = plan[:plan.index("return a;")]
    plan = re.sub(r"\s+", " ", plan)
    for line in ("a.ld = hd + 8;",
                 "const size_t tile = (size_t)kKeyTile * a.ld * 2;",
                 "a.stg = tile;", "a.ring = a.stg + kStgTile;",
                 "a.slot = 2 * tile;",
                 "a.stages = a.ring + 2 * a.slot + kLaneLists <= "
                 "(size_t)vf::kMaxSmem ? 2 : 1;",
                 "a.top = a.ring + a.stages * a.slot;",
                 "a.total = a.top + kLaneLists;"):
        assert line in plan, line
    assert "return (size_t)2 * 2 * kk * kBThreads * 4;" in SOURCE
    assert "constexpr size_t kLaneLists = lane_lists(kMaxJas);" in SOURCE
    route = SOURCE[SOURCE.index("int attn(const TiledArgs& t, cudaStream_t "
                                "st) {"):]
    route = re.sub(r"\s+", " ", route[:route.index("const int hd")])
    assert ("if constexpr (!kL2 && std::is_same<T, bf16>::value) { if "
            "constexpr (kBwd) return attn_kt_bwd<kDrop>(t, st); else return "
            "attn_kt_fwd<kDrop>(t, st); } else { return attn_kt<T, kBwd, "
            "kDrop, kL2>(t, st); }" in route)
    plan_rule = SOURCE[SOURCE.index("int plan(int tbytes"):]
    assert ("regs ? ktf_plan(hd).total : kt_plan(hd, mt, tbytes, false)"
            ".total" in re.sub(r"\s+", " ", plan_rule))
    assert 'extern "C" void vft_kt_fwd_launches' in SOURCE
    assert re.search(r"kMaxJas = 16;", SOURCE) and _MAX_JAS == 16
