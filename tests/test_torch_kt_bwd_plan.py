"""The key-tiled plans past 256 padded tokens, now that the bf16 softmax
backward runs ``vft_attn_kt_bwd`` and ``vft_attn_keys_kt2`` and the bf16
softmax forward ``vft_attn_kt_fwd`` (``csrc/vector_field_tiled.cu``):
``tiled_plan_rule``'s answers frozen at the 261-, 587- and 1,000-token
shapes of the TS-Base width (D=768, 12 heads, MLP ratio 1). bf16 ±
dropout take the register CTAs' shared memory (the backward's dropout
instance keeps its keep bits, 512 bytes per 64-key tile; the forward's
88,064 bytes do not change with n_pad or dropout); f32 and L2 keep the
first key-tiled CTAs' numbers; no bf16 shape that had a plan before the
backward's redesign loses it. Needs no JAX: the rule is Python, and the
card holds it against ``vft_plan`` (``chip_smoke.py``,
``long_plans_agree``)."""

import pytest
import torch

from odevit_tpu_torch.kernels.tiled import (_KEY_TILE, _MAX_SMEM, _Q_TILES,
                                            _kt_smem, _key_kt_smem,
                                            tiled_plan_rule)

SHAPES = ((272, 261), (592, 587), (1024, 1000))
WIDTH = (768, 12, 768)   # D, heads, dh

# (query-tile rows, forward, backward and key-tile CTA bytes)
BF16 = {
    (272, False): (64, 88064, 64512, 73728),
    (592, False): (64, 88064, 64512, 73728),
    (1024, False): (64, 88064, 64512, 73728),
    (272, True): (64, 88064, 67072, 73728),
    (592, True): (64, 88064, 69632, 73728),
    (1024, True): (64, 88064, 72704, 73728),
}
# the first key-tiled CTAs' plans, which the f32 and L2 instances keep
FIRST = {torch.float32: (64, 114432, 141056, 69888),
         torch.bfloat16: (64, 81664, 100096, 53504)}


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("n_pad,n_real", SHAPES)
def test_bf16_softmax_backward_plan(n_pad, n_real, drop):
    assert tiled_plan_rule(torch.bfloat16, n_pad, n_real, *WIDTH,
                           drop) == BF16[n_pad, drop]


@pytest.mark.parametrize("dtype,drop,l2", [
    (torch.float32, False, False), (torch.float32, True, False),
    (torch.float32, False, True), (torch.bfloat16, False, True)])
@pytest.mark.parametrize("n_pad,n_real", SHAPES)
def test_f32_and_l2_plans_unchanged(n_pad, n_real, dtype, drop, l2):
    assert tiled_plan_rule(dtype, n_pad, n_real, *WIDTH, drop, l2) \
        == FIRST[dtype]


def test_keep_bits_grow_by_key_tile():
    # without dropout the backward CTA does not grow with n_pad; with it
    # by one word per thread (128) and 64-key tile
    base = tiled_plan_rule(torch.bfloat16, 592, 587, *WIDTH)[2]
    for n_pad in (272, 400, 592, 1024, 2048):
        plan = tiled_plan_rule(torch.bfloat16, n_pad, n_pad - 5, *WIDTH,
                               True)
        tiles = -(-n_pad // _KEY_TILE)
        assert plan[2] == base + tiles * 128 * 4


@pytest.mark.parametrize("n_pad", [272, 592, 1024, 4096])
def test_every_bf16_shape_keeps_a_plan(n_pad):
    # the rule before the redesign: the first key-tiled CTAs, forward,
    # backward and key tile, all within the shared memory
    for heads in (1, 3, 4, 12):
        for hd in range(16, 513, 16):
            d = hd * heads
            before = any(max(_kt_smem(hd, mt, 2, False),
                             _kt_smem(hd, mt, 2, True),
                             _key_kt_smem(hd, mt, 2)) <= _MAX_SMEM
                         for mt in _Q_TILES)
            for drop in (False, True):
                plan = tiled_plan_rule(torch.bfloat16, n_pad, n_pad - 5, d,
                                       heads, d, drop)
                assert (plan is not None) >= before, (n_pad, d, heads, drop)
                if plan is not None:
                    assert max(plan[1:]) <= _MAX_SMEM


def test_wide_heads_take_one_ring_slot():
    # two K/V slots up to hd = 272, one past it (hd = 288: Q, cb, staging,
    # one slot of K and V)
    two = tiled_plan_rule(torch.bfloat16, 592, 587, 272 * 4, 4, 1088)[2]
    one = tiled_plan_rule(torch.bfloat16, 592, 587, 288 * 4, 4, 1152)[2]
    assert two == 2 * 64 * 280 * 2 + 64 * 72 * 2 + 2 * 2 * 64 * 280 * 2
    assert one == 4 * 64 * 296 * 2 + 64 * 72 * 2
