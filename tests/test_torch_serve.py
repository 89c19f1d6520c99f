"""The port's serving engine: bucketed micro-batching returns the same
logits as a direct ``fast_forward``, under concurrent submission, and
survives the races the JAX engine handles (on the CPU)."""

import threading

import numpy as np
import pytest
import torch

from odevit_tpu_torch.data.pipeline import make_preprocess
from odevit_tpu_torch.models.fast_forward import fast_forward
from odevit_tpu_torch.models.vit_ode import ViTODE
from odevit_tpu_torch.serve.engine import ServingEngine


def setup():
    m = ViTODE(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=4,
               time_interval=1.0, num_eval_steps=5, solver="rk4",
               register_tokens=2, device="cpu", seed=0)
    return m, np.random.default_rng(0)


def direct(m, x):
    return fast_forward(m, torch.from_numpy(
        np.asarray(x, np.float32)))["logits"].numpy()


def test_engine_matches_direct_forward():
    m, rng = setup()
    with ServingEngine(m, batch_buckets=(2, 4, 8), max_delay_ms=1.0,
                       device="cpu") as eng:
        for b in (1, 3, 8, 11):   # odd sizes, incl. > max bucket
            x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
            got = eng.submit(x).result(timeout=60)
            assert got.shape == (b, 7)
            np.testing.assert_allclose(got, direct(m, x), atol=2e-5,
                                       rtol=1e-4)
        s = eng.stats()
        assert s["requests"] == 4 and s["images"] == 23
        assert s["runs"] >= s["batches"] and s["mean_latency_ms"] > 0


def test_engine_concurrent_submits():
    m, rng = setup()
    xs = [rng.standard_normal((i % 3 + 1, 16, 16, 3)).astype(np.float32)
          for i in range(12)]
    wants = [direct(m, x) for x in xs]
    with ServingEngine(m, batch_buckets=(4, 16), max_delay_ms=5.0,
                       device="cpu") as eng:
        futs = [None] * len(xs)

        def worker(i):
            futs[i] = eng.submit(xs[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=60), wants[i],
                                       atol=2e-5, rtol=1e-4)
        s = eng.stats()
        assert s["requests"] == 12
        assert s["batches"] <= s["requests"]


def test_engine_uint8_with_preprocess():
    m, rng = setup()
    pre = make_preprocess()
    u8 = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    want = fast_forward(m, pre(torch.from_numpy(u8)))["logits"].numpy()
    with ServingEngine(m, batch_buckets=(4,), preprocess=pre,
                       max_delay_ms=0.5, device="cpu") as eng:
        got = eng.submit(u8).result(timeout=60)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
        with pytest.raises(TypeError):      # uint8 engines take only uint8
            eng.submit(u8.astype(np.float32))


def test_engine_rejects_bad_shape():
    m, _ = setup()
    with ServingEngine(m, batch_buckets=(2,), max_delay_ms=0.5,
                       device="cpu") as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((1, 8, 8, 3), np.float32))


def test_engine_survives_failing_run():
    """A failed run resolves the affected futures with the exception and
    the dispatcher keeps serving; submit() after close() raises."""
    m, rng = setup()
    with ServingEngine(m, batch_buckets=(2, 4), max_delay_ms=0.5,
                       device="cpu") as eng:
        good_run = eng._run
        calls = {"n": 0}

        def flaky(images):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return good_run(images)

        eng._run = flaky
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        with pytest.raises(RuntimeError, match="injected device failure"):
            eng.submit(x).result(timeout=60)
        got = eng.submit(x).result(timeout=60)
        assert got.shape == (2, 7)
        assert eng.stats()["failed_requests"] == 1
    with pytest.raises(RuntimeError):
        eng.submit(x)


def test_engine_dtype_guard():
    """Float and integer inputs coerce to float32 requests; other dtypes
    are rejected."""
    m, rng = setup()
    with ServingEngine(m, batch_buckets=(2,), max_delay_ms=0.5,
                       device="cpu") as eng:
        x64 = rng.standard_normal((2, 16, 16, 3))
        np.testing.assert_allclose(eng.submit(x64).result(timeout=60),
                                   direct(m, x64), atol=2e-5, rtol=1e-4)
        u8 = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
        np.testing.assert_allclose(eng.submit(u8).result(timeout=60),
                                   direct(m, u8), atol=2e-5, rtol=1e-4)
        with pytest.raises(TypeError):
            eng.submit(np.zeros((1, 16, 16, 3), np.complex64))


def test_engine_cancelled_future_does_not_poison_batch():
    m, rng = setup()
    with ServingEngine(m, batch_buckets=(4,), max_delay_ms=200.0,
                       device="cpu") as eng:
        x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
        f1 = eng.submit(x)
        f2 = eng.submit(x)
        assert f1.cancel()
        assert f2.result(timeout=60).shape == (1, 7)
        assert eng.stats()["failed_requests"] == 0


def test_engine_submit_close_race_resolves_future():
    """close() draining the queue between submit()'s stop check and its
    put() must not orphan the future."""
    m, rng = setup()
    eng = ServingEngine(m, batch_buckets=(2,), max_delay_ms=0.5,
                        device="cpu")
    orig_put = eng._queue.put

    def put_then_close(item):
        eng.close()
        orig_put(item)

    eng._queue.put = put_then_close
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    fut = eng.submit(x)
    try:
        fut.result(timeout=10)
    except RuntimeError as e:
        assert "engine closed" in str(e)


def test_engine_at_the_ts_base_token_count():
    """The 224 px student's shape (patch 16, 10 registers: 207 tokens
    padded to 208) at narrow widths: uint8 requests through the engine's
    preprocess with its resize step, against a direct ``fast_forward``."""
    m = ViTODE(img_size=224, patch_size=16, embed_dim=64, num_heads=4,
               mlp_ratio=1.0, num_classes=7, emulate_depth=12,
               time_interval=1.0, num_eval_steps=3, solver="euler",
               register_tokens=10, device="cpu", seed=0)
    assert m.patch_embed.seq_len == 207
    rng = np.random.default_rng(1)
    pre = make_preprocess(image_size=224)
    reqs = [rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
            for b in (1, 3)]
    with ServingEngine(m, batch_buckets=(1, 4), preprocess=pre,
                       max_delay_ms=0.5, device="cpu") as eng:
        for u8 in reqs:
            got = eng.submit(u8).result(timeout=120)
            want = fast_forward(m, pre(torch.from_numpy(u8)))["logits"]
            np.testing.assert_allclose(got, want.numpy(), atol=2e-5,
                                       rtol=1e-4)
        assert eng.stats()["images"] == 4


def test_engine_over_an_l2_model():
    """An L2-attention model (its attention biases drawn nonzero) served
    through the engine, which ``fast_forward`` sends along the generic
    integrator, matches a direct ``fast_forward``."""
    m = ViTODE(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               mlp_ratio=2.0, num_classes=7, emulate_depth=4,
               time_interval=1.0, num_eval_steps=5, solver="rk4",
               register_tokens=2, l2_attention=True, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for lin in (m.vf.attn.q, m.vf.attn.k, m.vf.attn.v, m.vf.attn.out):
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.1)
    rng = np.random.default_rng(2)
    with ServingEngine(m, batch_buckets=(2, 4), max_delay_ms=0.5,
                       device="cpu") as eng:
        for b in (1, 3, 6):
            x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
            got = eng.submit(x).result(timeout=60)
            np.testing.assert_allclose(got, direct(m, x), atol=2e-5,
                                       rtol=1e-4)
        assert eng.stats()["images"] == 10
