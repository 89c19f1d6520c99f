"""The bf16 one-CTA backward's plan, route and source (no JAX, no kernels).

``vfb_rows_bf16`` (``csrc/vector_field_bwd.cu``) lays its CTA out by
``make_plan_b16`` and picks it by ``plan_b16``, which ``bf16_bwd_layout``
and ``bf16_bwd_plan`` repeat in Python. Which shapes take one CTA is still
``vfb_plan``'s decision (``cta_bwd_plan``), frozen below as it was before
the kernel changed; every shape it sends to one CTA in bf16 must have a
plan within 227 KB in every instance. ``chip_smoke.py`` holds the Python
plan against ``vfb_plan_bf16`` and the kernel against ``vf_bwd_plain``.
"""

from __future__ import annotations

import hashlib
import inspect
import re
from pathlib import Path

import pytest
import torch

from odevit_tpu_torch.kernels import launch_counts
from odevit_tpu_torch.kernels import vector_field_bwd as vfb
from odevit_tpu_torch.kernels.vector_field import _MAX_SMEM, VFWeights
from odevit_tpu_torch.kernels.vector_field_bwd import (
    B16_BLOCKS, B16_CHUNKS, B16_LD_SLICE, B16_SLICE, B16_STAGES, _Args,
    bf16_bwd_layout, bf16_bwd_plan, cta_bwd_plan, tiling_b16, vf_bwd)

CSRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
N_PADS = tuple(range(16, 129, 16))
WIDTHS = ((32, 2), (64, 2), (64, 4), (128, 2), (192, 3), (256, 4), (384, 6),
          (192, 12), (96, 6), (48, 3), (320, 5), (128, 8))
RATIOS = (1, 2, 3, 4)
INSTANCES = ("det", "drop", "l2")
# the bf16 one-CTA backward's route over the sweep, as before the kernel
# changed: shapes per n_pad, and the SHA-256 of their list (the same in
# every instance)
ONE_CTA_PER_N = {16: 48, 32: 48, 48: 48, 64: 48, 80: 48, 96: 48, 112: 48,
                 128: 28}
ONE_CTA_SHA = "7599878131578597"


def flags(inst):
    return {"drop": inst == "drop", "l2": inst == "l2"}


def one_cta(inst):
    """The (n_pad, D, heads, dh) of the sweep that take one CTA in bf16."""
    return [(n, d, heads, r * d) for n in N_PADS for d, heads in WIDTHS
            for r in RATIOS
            if cta_bwd_plan(torch.bfloat16, n, n - 3, d, heads, r * d,
                            **flags(inst)) is not None]


@pytest.mark.parametrize("inst", INSTANCES)
def test_the_bf16_route_is_frozen(inst):
    shapes = one_cta(inst)
    assert {n: sum(s[0] == n for s in shapes) for n in N_PADS} == \
        ONE_CTA_PER_N
    digest = hashlib.sha256(repr(shapes).encode()).hexdigest()[:16]
    assert digest == ONE_CTA_SHA


def test_the_cifar_plan():
    # the training cells' shape: cn and gd resident, chunks of 64, column
    # blocks of 192, four ring slots
    shape = (80, 69, 192, 3, 768)
    assert bf16_bwd_plan(*shape) == (1, 64, 192, 4, 202624)
    assert bf16_bwd_plan(*shape, drop=True) == (1, 64, 192, 4, 203904)
    assert bf16_bwd_plan(*shape, l2=True) == (1, 64, 192, 4, 204544)
    lay = bf16_bwd_layout(80, 192, 3, 64, 192, 1, 4)
    assert {k: lay[k] for k in ("ld_cn", "ld_hd", "ld_s", "ld_p", "ld_hb",
                                "ld_mb")} == {
        "ld_cn": 200, "ld_hd": 72, "ld_s": 84, "ld_p": 88, "ld_hb": 72,
        "ld_mb": 196}
    assert (lay["slot_a"], lay["slot_m"], lay["slot_e"], lay["groups_e"]) \
        == (6400, 7680, 10880, 2)
    assert {k: lay[k] for k in ("cna", "gda", "q", "k", "v", "cb", "st",
                                "pb", "ring_a", "st2")} == {
        "cna": 384, "gda": 32384, "q": 64384, "k": 75904, "v": 87424,
        "cb": 98944, "st": 110464, "pb": 137344, "ring_a": 151424,
        "st2": 151424}
    assert {k: lay[k] for k in ("mbar", "cnm", "gd", "hb", "ring_m",
                                "part", "ring_e")} == {
        "mbar": 384, "cnm": 63104, "gd": 95104, "hb": 127104,
        "ring_m": 138624, "part": 63104, "ring_e": 69248}
    assert (lay["attn_end"], lay["mlp_end"], lay["abar_end"]) == \
        (202624, 200064, 156288)
    # a_bar's (and m_bar's) 80 x 192 in 3 x 4 tiles of m16n8 is one round
    # of the 12 warps, the MLP's dual 80 x 64 in 1 x 4 tiles takes 10
    assert tiling_b16(5, 24, 3, 4) == {"cg": 6, "rpg": 3, "groups": 2,
                                       "tasks": 12}
    assert tiling_b16(5, 8, 1, 4)["tasks"] == 10
    # the map route's 16 rows
    assert bf16_bwd_plan(16, 9, 192, 3, 768) == (1, 64, 192, 4, 89216)


@pytest.mark.parametrize("part", ["fits", "aligned", "disjoint", "banks"])
@pytest.mark.parametrize("inst", INSTANCES)
def test_every_one_cta_shape_has_a_plan(inst, part):
    shapes = one_cta(inst)
    assert len(shapes) == 364
    for n, d, heads, dh in shapes:
        plan = bf16_bwd_plan(n, n - 3, d, heads, dh, **flags(inst))
        assert plan is not None, (inst, n, d, heads, dh)
        cs, hc, nb, stages, smem = plan
        lay = bf16_bwd_layout(n, d, heads, hc, nb, cs, stages,
                              **flags(inst))
        hd = d // heads
        if part == "fits":
            assert smem == lay["total"] <= _MAX_SMEM == 232448
            assert dh % hc == 0 and hc in B16_CHUNKS and nb in B16_BLOCKS
            assert stages in B16_STAGES and cs in (0, 1)
        elif part == "aligned":
            # every region on 128 bytes; ring slots whole 16-byte chunks
            for key, v in lay.items():
                if key.startswith("slot"):
                    assert v * 2 % 16 == 0, (n, d, key)
                elif not key.startswith(("ld_", "groups")):
                    assert v % 128 == 0, (n, d, key, v)
        elif part == "disjoint":
            # each phase's regions in order, each within the total
            cn = 128 * -(-n * lay["ld_cn"] * 2 // 128)
            attn = [lay[k] for k in ("q", "k", "v", "cb", "st", "pb")]
            assert attn == sorted(attn) and attn[0] == lay["cna"] + 2 * cs * cn
            assert lay["ring_a"] == lay["st2"] >= lay["pb"]
            assert lay["mean"] < lay["cna"] == lay["mbar"] <= lay["cnm"]
            assert lay["cnm"] <= lay["gd"] <= lay["hb"] < lay["ring_m"]
            assert lay["mbar"] < lay["part"] < lay["ring_e"]
            # c_bar (f32 [n][D + 4]) ends where a_bar's partials begin
            assert lay["part"] - lay["mbar"] >= n * (d + 4) * 4
            assert max(lay["attn_end"], lay["mlp_end"], lay["abar_end"]) \
                == lay["total"]
        else:
            # ldmatrix reads 8 rows of 16 bytes at once: every bf16 row
            # stride an odd number of 16-byte chunks, so the 8 rows hit 32
            # banks; a row-major staged B slice likewise
            for ld in (lay["ld_cn"], lay["ld_hd"], lay["ld_p"],
                       lay["ld_hb"], B16_LD_SLICE,
                       min(nb, 3 * hd) + 8, min(nb, hc) + 8):
                assert ld * 2 % 16 == 0 and (ld * 2 // 16) % 2 == 1, \
                    (n, d, ld)


def body(src: str, head: str) -> str:
    """The text of the function whose definition starts at ``head``, up to
    its closing brace at column 0."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


def test_the_old_template_is_gone():
    for p in CSRC.iterdir():
        assert "vfb_rows<" not in p.read_text(), p.name
    bwd = (CSRC / "vector_field_bwd.cu").read_text()
    launch = body(bwd, "int launch(const Args& a, cudaStream_t st)")
    for inst in ("<false, true, false>", "<true, false, false>",
                 "<false, false, true>", "<false, false, false>"):
        assert "vfb_rows_bf16" + inst in launch
    assert "++rows_bf16_launches;" in launch


def test_the_kernel_runs_on_gemm_b16():
    bwd = (CSRC / "vector_field_bwd.cu").read_text()
    text = body(bwd, "__global__ void __launch_bounds__(kThreads, 1) "
                     "vfb_rows_bf16(")
    # qkv (two A placements), scores, ctx, cb (two), v_bar, p_bar, q_bar,
    # k_bar, the MLP's h1 and h_bar (dual; resid single; two A
    # placements each), m_bar, a_bar
    assert len(re.findall(r"gemm_b16<", text)) == 16
    assert not re.search(r"\bmm(_f32)?\s*[<(]", text)
    assert "macc" not in text and "args.macc" not in bwd


def test_static_asserts_and_counter_in_the_source():
    bwd = (CSRC / "vector_field_bwd.cu").read_text()
    asserts = re.findall(r"static_assert\((.*?)\);", bwd, re.S)
    joined = " ".join(" ".join(a.split()) for a in asserts)
    assert "constexpr int kRegsB16 = 65536 / kThreads / 8 * 8;" in bwd
    assert "3 * 4 * 4 + 120 <= kRegsB16" in joined
    assert ("make_plan_b16(80, 192, 64, 64, 192, 1, 4, true, false) "
            ".total <= kMaxSmem") in joined
    assert ("make_plan_b16(80, 192, 64, 64, 192, 1, 4, false, true) "
            ".total <= kMaxSmem") in joined
    c_api = bwd[bwd.index('extern "C" {'):]
    assert "unsigned long long vfb_rows_bf16_launches()" in c_api
    assert "int vfb_plan_bf16(" in c_api
    assert "__launch_bounds__(kThreads, 1) vfb_rows_bf16(" in bwd


def test_constants_frozen_in_the_source():
    head = (CSRC / "split_tf32.cuh").read_text()
    assert f"constexpr int kSliceB = {B16_SLICE};" in head
    assert "constexpr int kLdSlice = kSliceB + 8;" in head
    assert B16_LD_SLICE == B16_SLICE + 8
    bwd = (CSRC / "vector_field_bwd.cu").read_text()
    chunks = re.search(r"kChunksB16\[\] = \{([\d, ]+)\}", bwd).group(1)
    blocks = re.search(r"kBlocksB16\[\] = \{([\d, ]+)\}", bwd).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == B16_CHUNKS
    assert tuple(int(b) for b in blocks.split(",")) == B16_BLOCKS
    assert "constexpr int kStagesB16 = 4;" in bwd
    assert B16_STAGES == tuple(range(4, 1, -1))


def test_no_m_bar_buffer_in_device_memory():
    names = [name for name, _ in _Args._fields_]
    assert "macc" not in names and "stages" in names
    assert "macc" not in inspect.getsource(vf_bwd)


def _bad_calls():
    """keyword -> the vf_bwd arguments the kernel does not take."""
    b, n, d, heads, dh = 2, 32, 64, 2, 128
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    w = VFWeights(torch.ones(d), torch.zeros(d), torch.ones(d),
                  torch.zeros(d), bf(d, 3 * d), bf(d, d), bf(d, dh),
                  bf(dh, d))
    l2 = w._replace(qkv_bias=torch.zeros(3 * d), out_bias=torch.zeros(d))
    x, g = bf(b, n, d), bf(b, n, d)
    kw = dict(num_heads=heads, scaler=1.0, n_real=29)
    rq, rh = bf(b * n, 3 * d), bf(b * n, dh)
    gj = torch.zeros(b, heads, 5, n)
    return {
        "n_pad not a multiple of 16": (bf(b, 24, d), w, bf(b, 24, d),
                                       dict(kw, n_real=20)),
        "n_real past n_pad": (x, w, g, dict(kw, n_real=33)),
        "g of another shape": (x, w, bf(b, 16, d), kw),
        "g_jas without its columns": (x, w, g, dict(kw, g_jas=gj)),
        "residuals with dropout": (x, w, g, dict(
            kw, resid_qkv=rq, resid_h1=rh, seed=1, drops=(0.1, 0.1, 0.1))),
        "one residual": (x, w, g, dict(kw, resid_qkv=rq)),
        "residuals of another width": (x, w, g, dict(
            kw, resid_qkv=bf(b * n, d), resid_h1=rh)),
        "residuals with L2": (x, l2, g, dict(kw, resid_qkv=rq,
                                             resid_h1=rh)),
        "L2 with dropout": (x, l2, g, dict(kw, seed=1,
                                           drops=(0.1, 0.0, 0.0))),
    }


@pytest.mark.parametrize("what", sorted(_bad_calls()))
def test_what_the_kernel_does_not_take_raises(what):
    x, w, g, kw = _bad_calls()[what]
    before = dict(launch_counts)
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        vf_bwd(x, w, g, **kw)
    assert launch_counts == before


def test_the_card_path_checks_as_the_cpu_path_does():
    # the launch path runs the plain path's checks before it launches
    src = inspect.getsource(vf_bwd)
    launch = src[src.index("_check_bwd("):src.index("vfb_launch(")]
    for check in ("_check_bwd(", "_check_l2_drop(", "check_resid(",
                  "_check_launch(", "check_operands("):
        assert check in launch, check
    plain = inspect.getsource(vfb.vf_bwd_plain)
    for check in ("_check_bwd(", "_check_l2_drop(", "check_resid("):
        assert check in plain, check
