"""The f32 one-CTA Macaron forward's plans (no JAX, no kernels).

``mac_kernel_f32`` (``csrc/macaron.cu``) lays its CTA out by
``macaron_plan_f32`` (``make_plan_f32`` and ``plan_f32`` in Python). Which
shapes take the one-CTA route is still decided by ``macaron_plan`` (the
layout of ``mac_kernel``, which ``mac_plan`` keeps for the route), frozen
by ``tests/test_torch_macaron_plan.py``: every shape of its sweep that the
route sends to one CTA in f32 must have an f32 plan, within one CTA's
shared memory, with aligned regions that do not overlap and fragment reads
that hit 32 banks. ``chip_smoke.py`` holds the Python plan against
``mac_plan_f32`` on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from odevit_tpu_torch.kernels.macaron import (F32_CHUNKS, _Args,
                                              f32_layout, macaron_plan,
                                              macaron_plan_f32, macaron_route)
from odevit_tpu_torch.kernels.vector_field import (_MAX_SMEM, F32_BLOCKS,
                                                   block_ok)
from test_torch_macaron_plan import COUNTS, ONE_CTA, sweep

CSRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
# the regions of one CTA, each with its size in bytes
REGIONS = {"ring": lambda n, lay: 2 * 2 * lay["slot"] * 4,
           "hbig": lambda n, lay: n * lay["ld_h"] * 4,
           "hsmall": lambda n, lay: n * lay["ld_h"] * 4,
           "pbig": lambda n, lay: n * lay["ld_p"] * 4,
           "psmall": lambda n, lay: n * lay["ld_p"] * 4}


def one_cta_f32():
    """{shape: (plan, layout)} over the sweep's shapes that the forward's
    route sends to one CTA in f32."""
    out = {}
    for n, d, heads, dh in sweep():
        if macaron_route(torch.float32, n, n - 3, d, heads, dh) != "cta":
            continue
        plan = macaron_plan_f32(n, n - 3, d, heads, dh)
        assert plan is not None, (n, d, heads, dh)
        hc, nb = plan[:2]
        out[n, d, heads, dh] = plan, f32_layout(n, d, heads, hc, nb)
    return out


def test_the_routes_are_those_the_route_test_freezes():
    cta = ONE_CTA["float32", False]
    shapes = one_cta_f32()
    assert len(shapes) == COUNTS["float32", False] == 96
    assert set(shapes) == {(n, d, heads, dh) for n, d, heads, dh in sweep()
                           if (d, heads) in cta.get(n, ())}
    # the route's own plan, by mac_kernel's layout, decides: an f32 plan
    # exists past it, where the route takes the tiled kernels
    assert macaron_plan(torch.float32, 128, 125, 64, 2, 256) is None
    assert macaron_plan_f32(128, 125, 64, 2, 256) is not None


def test_the_cifar_plan():
    # chunks of 192 (one z W1 column block each) and column blocks of 192:
    # the ring (87,040 B) and the chunk's planes (125,440 B); the f32 state
    # goes through the output buffer, and the workspace holds z and one
    # head's q | k | v
    plan = macaron_plan_f32(80, 65, 192, 3, 768)
    assert plan == (192, 192, 212480, 80 * (192 + 3 * 64))
    lay = f32_layout(80, 192, 3, 192, 192)
    assert (lay["hbig"], lay["total"] - lay["hbig"]) == (87040, 125440)
    # at other shapes, narrower chunks where dh asks for them, and past
    # 96 rows blocks of 192 take too many warp tiles: blocks of 128
    assert macaron_plan_f32(32, 29, 192, 3, 768)[:2] == (192, 192)
    assert macaron_plan_f32(80, 65, 128, 2, 512)[:2] == (128, 192)
    assert macaron_plan_f32(80, 65, 64, 1, 64)[:2] == (64, 192)
    assert macaron_plan_f32(32, 29, 32, 2, 32)[:2] == (32, 192)
    assert macaron_plan_f32(128, 122, 32, 2, 128)[:2] == (128, 128)


@pytest.mark.parametrize("part", ["fits", "aligned", "disjoint", "warps",
                                  "workspace"])
def test_every_f32_plan_of_the_routes_shapes(part):
    for (n, d, heads, dh), (plan, lay) in one_cta_f32().items():
        hc, nb, smem, ws = plan
        if part == "fits":
            assert smem == lay["total"] <= _MAX_SMEM == 232448
            assert hc in F32_CHUNKS and dh % hc == 0 and nb in F32_BLOCKS
            # a chunk's z W1 product takes one column block
            assert hc <= nb
        elif part == "aligned":
            # 16-byte cp.async and float4 rows: every staged row and
            # workspace offset starts on 4 floats, every region on 128
            # bytes
            for key, v in lay.items():
                if key.startswith(("ld_", "ws", "slot")):
                    assert v % 4 == 0, (n, d, key, v)
                elif key != "total":
                    assert v % 128 == 0, (n, d, key, v)
        elif part == "disjoint":
            # the ring, the chunk's planes; p's planes reuse the chunk's
            # region (never both live), within it
            spans = [(lay[k], lay[k] + REGIONS[k](n, lay))
                     for k in ("ring", "hbig", "hsmall")]
            spans.sort()
            for (_, end), (start, _) in zip(spans, spans[1:]):
                assert end <= start, (n, d, spans)
            assert lay["pbig"] + REGIONS["pbig"](n, lay) <= lay["psmall"]
            for key in ("hsmall", "psmall"):
                assert lay[key] + REGIONS[key](n, lay) <= lay["total"]
        elif part == "warps":
            # one round of warp tiles (column groups of 32 by row groups
            # of up to 3 m16 tiles in 12 warps); a staged slice's 16-byte
            # chunks (4 n + 4 nb) within 3 a thread
            assert -(-nb // 32) * -(-(n // 16) // 3) <= 12
            assert 4 * n + 4 * nb <= 3 * 384
        else:
            # z, then one head's q | k | v (the state is the output)
            assert ws == lay["ws"] == n * (d + 3 * (d // heads))
            assert lay["ws_qkv"] == n * d


def banks(addrs):
    """The most lanes of a warp that one shared-memory bank serves."""
    per = {}
    for a in addrs:
        per[a % 32] = per.get(a % 32, 0) + 1
    return max(per.values())


def test_fragment_reads_of_the_planes_hit_32_banks():
    # an m16n8k8 A fragment's first register reads row g, column t of a
    # row-major plane (g = lane / 4, t = lane % 4): with a stride of 4 mod
    # 16 floats the 32 lanes fall on 32 banks
    seen = set()
    for (n, *_), (plan, lay) in one_cta_f32().items():
        for key in ("ld_h", "ld_p"):
            ld = lay[key]
            seen.add(ld % 16)
            assert banks([(lane // 4) * ld + lane % 4
                          for lane in range(32)]) == 1, (n, key, ld)
    assert seen == {4}


def body(src: str, head: str) -> str:
    """The text of the function whose definition starts at ``head``, up to
    its closing brace at column 0."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


def test_the_kernel_runs_every_product_on_gemm_tf32():
    src = (CSRC / "macaron.cu").read_text()
    text = body(src, "mac_kernel_f32(MacArgs a)")
    # z W1, h W2, z Wqkv, q k^T, p v, ctx Wout
    assert len(re.findall(r"gemm_tf32<", text)) == 6
    assert not re.search(r"\b(mm|mm_f32|prod|mm_axpy)\s*[<(]", text)
    # the old f32 instance and what only it used are gone
    assert "mac_kernel<float>" not in src and "launch<float>" not in src
    assert "mm_axpy(const float*" not in src
    assert not re.search(r"prod\(const float\*", src)
    # mm_f32 is left to the tiled route's whole-row attention CTAs
    users = [p.name for p in sorted(CSRC.iterdir())
             if re.search(r"\bmm_f32\s*<", p.read_text())
             and p.suffix == ".cu"]
    assert users == ["vector_field_tiled.cu"]


def test_the_chunks_and_the_rule_are_the_sources():
    # plan_f32 tries kChunksF32 widest first, then the widest column block
    # no narrower than the chunk (one z W1 block a chunk); no wider chunk
    # or block than the plan's fits at any shape of the route
    src = (CSRC / "macaron.cu").read_text()
    rule = body(src, "bool plan_f32(")
    chunks = re.search(r"kChunksF32\[\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == F32_CHUNKS
    assert "for (int c : kChunksF32)" in rule
    assert "!block_ok(s.n_pad, b) || b < c" in rule
    for (n, d, heads, dh), (plan, _) in one_cta_f32().items():
        hc, nb = plan[:2]
        for c in F32_CHUNKS:
            for b in F32_BLOCKS:
                wider = c > hc or (c == hc and b > nb)
                if wider and not dh % c and b >= c and block_ok(n, b):
                    assert f32_layout(n, d, heads, c, b)["total"] \
                        > _MAX_SMEM, (n, d, heads, dh, c, b)


def test_args_mirror_macargs_field_for_field():
    src = (CSRC / "macaron.cu").read_text()
    fields = re.search(r"struct MacArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in fields.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        decl = re.sub(r"^(const\s+)?(void|float|int)\s*\*?\s*", "", line)
        names += [n.strip().lstrip("*") for n in decl.split(",")]
    assert names == [name for name, _ in _Args._fields_]
