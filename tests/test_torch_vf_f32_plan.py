"""The f32 one-CTA ViTODE kernels' plans and routes (no JAX, no kernels).

``vf_kernel_f32`` (``csrc/vector_field.cu``) and ``vfb_rows_f32``
(``csrc/vector_field_bwd.cu``) lay their CTAs out by ``f32_plan`` and
``f32_bwd_plan`` (``make_plan_f32`` and ``make_plan_b32`` in Python). Which
shapes take the one-CTA route is still decided by ``vf_plan`` and
``vfb_plan`` (the layouts of the bf16 kernels and of the CUDA-core f32
instances the new kernels replaced), which ``cta_plan`` and
``cta_bwd_plan`` repeat in Python; the routes below are frozen as they
were before the f32 kernels changed: over the sweep (n_pad 16-144, D
32-384, MLP ratios 1, 2 and 4), the shapes whose (n_pad, D, heads) is
listed take one CTA at every ratio, every other shape the tiled route.
``chip_smoke.py`` holds the Python plans against the CUDA ones.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from odevit_tpu_torch.kernels.vector_field import (_MAX_SMEM, F32_BLOCKS,
                                                   cta_plan, f32_layout,
                                                   f32_plan)
from odevit_tpu_torch.kernels.vector_field_bwd import (_Args, cta_bwd_plan,
                                                       f32_bwd_layout,
                                                       f32_bwd_plan)

CSRC = Path(__file__).resolve().parents[1] / "odevit_tpu_torch" / "csrc"
N_PADS = (16, 32, 64, 80, 96, 112, 128, 144)
WIDTHS = ((32, 2), (64, 2), (64, 4), (128, 2), (192, 3), (256, 4), (384, 6),
          (192, 12))
RATIOS = (1, 2, 4)
ALL = WIDTHS
SMALL = ((32, 2), (64, 2), (64, 4))
NOT_384 = tuple(w for w in ALL if w != (384, 6))

# n_pad -> (D, heads) routed to one CTA, by (dtype, backward, instance)
ONE_CTA = {
    ("bfloat16", False, "det"): {
        16: ALL, 32: ALL, 64: ALL, 80: NOT_384,
        96: SMALL + ((128, 2), (192, 3), (192, 12)), 112: SMALL,
        128: SMALL},
    ("bfloat16", False, "drop"): {
        16: ALL, 32: ALL, 64: NOT_384,
        80: SMALL + ((128, 2), (192, 3), (192, 12)),
        96: SMALL + ((128, 2), (192, 12)), 112: SMALL, 128: SMALL},
    ("bfloat16", True, "det"): {
        16: ALL, 32: ALL, 64: ALL, 80: ALL, 96: ALL, 112: ALL,
        128: SMALL + ((192, 12),)},
    ("float32", False, "det"): {
        16: ALL, 32: ALL, 64: ALL, 80: NOT_384,
        96: SMALL + ((128, 2), (192, 12)), 112: SMALL + ((192, 12),),
        128: ((32, 2), (64, 4))},
    ("float32", False, "drop"): {
        16: ALL, 32: ALL, 64: ALL, 80: NOT_384,
        96: SMALL + ((192, 12),), 112: SMALL + ((192, 12),),
        128: ((32, 2), (64, 4))},
    ("float32", True, "det"): {
        16: ALL, 32: ALL, 64: ALL, 80: ALL, 96: ALL,
        112: SMALL + ((192, 12),)},
}
# L2 routes as the deterministic instance does, except the f32 forward,
# which routes as its dropout instance (both add a small region); every
# backward instance routes alike
ONE_CTA["bfloat16", False, "l2"] = ONE_CTA["bfloat16", False, "det"]
ONE_CTA["float32", False, "l2"] = ONE_CTA["float32", False, "drop"]
for _dt in ("bfloat16", "float32"):
    for _inst in ("drop", "l2"):
        ONE_CTA[_dt, True, _inst] = ONE_CTA[_dt, True, "det"]
COUNTS = {("bfloat16", False): {"det": 129, "drop": 120, "l2": 129},
          ("bfloat16", True): {"det": 156, "drop": 156, "l2": 156},
          ("float32", False): {"det": 126, "drop": 123, "l2": 123},
          ("float32", True): {"det": 132, "drop": 132, "l2": 132}}
INSTANCES = ("det", "drop", "l2")


def sweep():
    for n in N_PADS:
        for d, heads in WIDTHS:
            for r in RATIOS:
                yield n, d, heads, r * d


def flags(inst):
    return {"drop": inst == "drop", "l2": inst == "l2"}


@pytest.mark.parametrize("inst", INSTANCES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_routes_over_the_sweep_are_as_before(dtype, bwd, inst):
    cta = ONE_CTA[dtype, bwd, inst]
    rule = cta_bwd_plan if bwd else cta_plan
    count = 0
    for n, d, heads, dh in sweep():
        want = (d, heads) in cta.get(n, ())
        got = rule(getattr(torch, dtype), n, n - 3, d, heads, dh,
                   **flags(inst)) is not None
        assert got == want, (dtype, bwd, inst, n, d, heads, dh)
        count += want
    assert count == COUNTS[dtype, bwd][inst]


def f32_plans(bwd, inst):
    """{shape: (plan, layout)} of every shape the route sends to one CTA in
    f32, for the instance ``inst``."""
    rule = cta_bwd_plan if bwd else cta_plan
    new, layout = ((f32_bwd_plan, f32_bwd_layout) if bwd
                   else (f32_plan, f32_layout))
    out = {}
    for n, d, heads, dh in sweep():
        if rule(torch.float32, n, n - 3, d, heads, dh, **flags(inst)):
            plan = new(n, n - 3, d, heads, dh, **flags(inst))
            assert plan is not None, (bwd, inst, n, d, heads, dh)
            acc_smem, hc, nb = plan[:3]
            out[n, d, heads, dh] = plan, layout(n, d, heads, hc, nb,
                                                acc_smem, **flags(inst))
    return out


def test_the_cifar_f32_plans():
    # the training cell's shape: chunks of 128, column blocks of 192, the
    # accumulator (m_bar) in the workspace, for which that leaves no room
    shape = (80, 69, 192, 3, 768)
    assert f32_plan(*shape) == (0, 128, 192, 171520, 46080)
    assert f32_plan(*shape, drop=True) == (0, 128, 192, 174080, 46080)
    assert f32_plan(*shape, l2=True) == (0, 128, 192, 172288, 46080)
    for inst in ("det", "drop"):
        assert f32_bwd_plan(*shape, **flags(inst)) == \
            (0, 128, 192, 171904, 42240)
    assert f32_bwd_plan(*shape, l2=True) == (0, 128, 192, 173824, 42240)
    # where the accumulator still fits beside the widest chunk and block,
    # it stays in shared memory
    assert f32_plan(32, 29, 192, 3, 768)[:3] == (1, 128, 192)
    assert f32_bwd_plan(32, 29, 192, 3, 768)[:3] == (1, 128, 192)


@pytest.mark.parametrize("part", ["fits", "aligned", "warps"])
@pytest.mark.parametrize("inst", INSTANCES)
@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_every_f32_plan_of_the_sweep(bwd, inst, part):
    plans = f32_plans(bwd, inst)
    assert len(plans) == COUNTS["float32", bwd][inst]
    for (n, d, heads, dh), (plan, lay) in plans.items():
        acc_smem, hc, nb, smem, ws = plan
        if part == "fits":
            assert smem == lay["total"] <= _MAX_SMEM == 232448
            assert dh % hc == 0 and nb in F32_BLOCKS and ws == lay["ws"]
        elif part == "aligned":
            # 16-byte cp.async: every staged row and workspace offset
            # starts on 4 floats, every region on 128 bytes
            for key, v in lay.items():
                if key.startswith(("ld_", "ws", "slot")):
                    assert v % 4 == 0, (n, d, key, v)
                elif key != "total":
                    assert v % 128 == 0, (n, d, key, v)
        else:
            # one round of warp tiles: column groups of 32 times row
            # groups of up to 3 m16 tiles fit the 12 warps; a staged
            # slice's chunks (4 n + 4 nb) fit 3 a thread
            assert -(-nb // 32) * -(-(n // 16) // 3) <= 12
            assert 4 * n + 4 * nb <= 3 * 384


def banks(addrs):
    """The most lanes of a warp that one shared-memory bank serves."""
    per = {}
    for a in addrs:
        per[a % 32] = per.get(a % 32, 0) + 1
    return max(per.values())


def fragment_reads(ld, transposed):
    """Word offsets an m16n8k8 A fragment's first register reads, by lane
    (g = lane / 4 the row, t = lane % 4 the column of K): row-major planes
    (kAPlanes) at g ld + t, planes stored [K][M] (kAPlanesT) at t ld + g."""
    return [(lane % 4) * ld + lane // 4 if transposed
            else (lane // 4) * ld + lane % 4 for lane in range(32)]


def test_fragment_reads_of_the_planes():
    # every plane of every f32 plan: a row-major read puts the 32 lanes on
    # 32 banks; the transposed reads (p^T cb and s_bar^T q of the
    # backward) at most two lanes a bank, one extra wavefront
    seen = set()
    for bwd in (False, True):
        for inst in INSTANCES:
            for (n, *_), (plan, lay) in f32_plans(bwd, inst).items():
                for key in ("ld_h", "ld_p"):
                    ld = lay[key]
                    seen.add(ld % 32)
                    assert banks(fragment_reads(ld, False)) == 1, (n, key)
                    if bwd and key == "ld_p":
                        assert banks(fragment_reads(ld, True)) <= 2, n
    assert seen <= {4, 20}
    # the ring's staged slices: A at kLdK = 20 floats a row (g ld + t),
    # a row-major B slice at nb + 8 (t ld + 8 j + g), a transposed one at
    # kLdK (g ld + t)
    assert banks(fragment_reads(20, False)) == 1
    for nb in F32_BLOCKS:
        assert banks(fragment_reads(nb + 8, True)) == 1, nb


def test_constants_frozen_in_the_source():
    # gemm_tf32's ring: K slices of 16 in two slots, 48 x 32 register
    # tiles, 3 staged chunks a thread; the f32 kernels' column blocks; the
    # source asserts that the ring and p's planes at 128 rows fit a CTA
    src = (CSRC / "split_tf32.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    want = {"kSlice": 16, "kTileRows": 3, "kTileCols": 4, "kStages": 2,
            "kMaxOwn": 3}
    assert {k: int(consts[k]) for k in want} == want
    assert "constexpr int kLdK = kSlice + 4;" in src
    blocks = re.search(r"kBlocksF32\[\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(b) for b in blocks.split(",")) == F32_BLOCKS
    assert "static_assert(2 * kStages * 4 * (128 * kLdK + 128 * kLdK) +" \
        in src
    # the macaron source no longer holds its own copy of the product
    assert "void gemm_tf32(" not in (CSRC / "macaron.cu").read_text()


def body(src: str, head: str) -> str:
    """The text of the function whose definition starts at ``head``, up to
    its closing brace at column 0."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("source,kernel", [
    ("vector_field.cu", "vf_kernel_f32("),
    ("vector_field_bwd.cu", "vfb_rows_f32(")])
def test_the_f32_kernels_take_no_cuda_core_product(source, kernel):
    text = body((CSRC / source).read_text(), kernel)
    assert "gemm_tf32<" in text
    assert not re.search(r"\bmm(_f32)?\s*<", text), kernel
    assert not re.search(r"\bmm\s*\(", text), kernel


def test_no_f32_instance_of_the_cuda_core_kernels():
    fwd = (CSRC / "vector_field.cu").read_text()
    bwd = (CSRC / "vector_field_bwd.cu").read_text()
    # the forward's launcher takes bf16 only; f32 goes to launch_f32
    assert "VF_LAUNCH(float" not in fwd and "launch_f32(" in fwd
    # the backward's launcher names vfb_rows_f32 where T is f32 and
    # vfb_rows_bf16 where it is bf16; the template vfb_rows<T, ...> is gone
    launch = body(bwd, "int launch(const Args& a, cudaStream_t st)")
    f32, bf16 = launch.split("} else {", 1)
    assert "if constexpr (sizeof(T) == 4)" in f32
    assert "vfb_rows<" not in f32 and "vfb_rows_f32<" in f32
    assert "vfb_rows<" not in bf16 and "vfb_rows_bf16<" in bf16


def test_args_mirror_the_c_struct_field_for_field():
    src = (CSRC / "vector_field_bwd.cu").read_text()
    fields = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in fields.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        decl = re.sub(r"^(const\s+)?(void|float|int|Drop)\s*\*?\s*", "",
                      line)
        names += [n.strip().lstrip("*") for n in decl.split(",")]
    assert names == [name for name, _ in _Args._fields_]
