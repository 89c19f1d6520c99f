"""The port's JaSMin and classification losses against the JAX package's.

Values and gradients of ``jasmin_order_stats`` / ``jasmin_from_stats`` /
``jasmin_map_loss`` on the same float32 maps, including rows with exact
ties (where only first-occurrence extraction gives JAX's columns) and
peaked rows holding exactly 1.0 and 1e-12 (where clip's subgradient is
0.5 in JAX, 1 in ``torch.clamp``). Tolerance: 1e-6 relative (both sides
compute the same float32 operations; only the order of a few sums
differs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from odevit_tpu.losses import jasmin as jj
from odevit_tpu.losses.classification import cross_entropy as jax_ce
from odevit_tpu_torch.losses import jasmin as tj
from odevit_tpu_torch.losses.classification import cross_entropy

B, H, N = 2, 3, 13
RTOL = 1e-6


def maps(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # a few distinct scores in a row, so probabilities tie exactly
        # within it, and the same row for every query, so the per-row
        # losses tie exactly too and max splits its gradient among them
        s = np.broadcast_to(rng.choice([0.0, 1.5, 3.0], size=(B, H, 1, N)),
                            (B, H, N, N))
    else:
        s = rng.standard_normal((B, H, N, N))
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "peaked":
        # one-hot rows (x1 == 1.0 exactly) and entries at exactly 1e-12
        p[:, :, ::2] = 0.0
        p[:, :, ::2, 0] = 1.0
        p[:, :, 1::4, 3:5] = np.float32(1e-12)
    return p


def close(got, want, floor=0.0):
    """Equal within RTOL of the largest |want| (and within ``floor``)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=max(RTOL * np.abs(want).max(), floor))


@pytest.mark.parametrize("kind", ["random", "ties", "peaked"])
@pytest.mark.parametrize("k", [0, 1, 2, 10])
def test_stats_loss_and_gradients_match_jax(kind, k):
    a = maps(kind, k)
    want_st = jj.jasmin_order_stats(jnp.asarray(a), k)
    want, want_g = jax.value_and_grad(
        lambda m: jj.jasmin_from_stats(jj.jasmin_order_stats(m, k), k))(
            jnp.asarray(a))
    t = torch.from_numpy(a).requires_grad_(True)
    got_st, idx = tj.jasmin_order_stats(t, k, return_indices=True)
    got = tj.jasmin_from_stats(got_st, k)
    got.backward()
    close(got_st.detach(), want_st)
    close(got.item(), float(want))
    # with k=1 the loss log(g1 / (g1 + eps) + eps) is flat: its gradient is
    # 0 up to float noise (~1e-8) on both sides
    close(t.grad, want_g, floor=1e-6 if k == 1 else 0.0)
    # the columns are the first occurrences of each order statistic
    taken = np.take_along_axis(a, idx.numpy().transpose(0, 1, 3, 2),
                               axis=-1)
    close(taken.transpose(0, 1, 3, 2), got_st.detach()[:, :, :4])


@pytest.mark.parametrize("kind", ["random", "ties", "peaked"])
@pytest.mark.parametrize("k", [0, 10])
def test_map_loss_matches_jax(kind, k):
    a = maps(kind, 7 + k)
    want, want_g = jax.value_and_grad(
        lambda m: jj.jasmin_map_loss(m, k=k))(jnp.asarray(a))
    t = torch.from_numpy(a).requires_grad_(True)
    got = tj.jasmin_map_loss(t, k=k)
    got.backward()
    close(got.item(), float(want))
    close(t.grad, want_g)


def test_ties_resolve_to_the_first_column():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    tops, ids = tj._top_values(p, 4)
    assert [i.item() for i in ids] == [1, 2, 4, 3]
    assert [v.item() for v in tops] == pytest.approx([0.3, 0.3, 0.3, 0.2])


def test_clip_subgradient_is_half_at_the_bounds():
    x = torch.tensor([1e-13, 1e-12, 0.5, 1.0, 2.0], requires_grad=True)
    tj._clip(x, 1e-12, 1.0).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_trajectory_window_matches_jax():
    v = np.random.default_rng(3).standard_normal(12).astype(np.float32)
    for t in (4, 13):
        close(tj.jasmin_trajectory_window(torch.from_numpy(v), t).item(),
              float(jj.jasmin_trajectory_window(jnp.asarray(v), t)))


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((16, 100)) * 3).astype(np.float32)
    labels = rng.integers(0, 100, 16)
    want, want_g = jax.value_and_grad(
        lambda z: jax_ce(z, jnp.asarray(labels),
                         label_smoothing=smoothing))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(t, torch.from_numpy(labels),
                        label_smoothing=smoothing)
    got.backward()
    close(got.item(), float(want))
    close(t.grad, want_g)
