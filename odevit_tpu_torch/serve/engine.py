"""Micro-batching serving engine over the fused inference path.

Counterpart of ``odevit_tpu/serve/engine.py``:
  * a fixed ladder of batch buckets, each run once at start (the first
    run builds the CUDA kernel), so no request pays for set-up;
  * one dispatcher thread drains a queue, coalesces pending requests up
    to the largest bucket, pads to the smallest bucket that fits, runs
    under ``torch.inference_mode()`` on the engine's device, and resolves
    per-request futures;
  * ``submit()`` is thread-safe and returns a ``concurrent.futures.Future``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from odevit_tpu_torch.device import resolve_device
from odevit_tpu_torch.models.fast_forward import fast_forward


class ServingEngine:
    """Batched inference over ``fast_forward`` with shape-bucketing.

    Args:
      model: a ``ViTODE`` or a ``ViTMacaron``; it is moved to ``device``.
      batch_buckets: ascending ladder of batch sizes.
      preprocess: optional uint8 -> float function run on the device
        (``data.pipeline.make_preprocess``); requests are then uint8.
      max_delay_ms: how long the dispatcher waits to coalesce more
        requests once it holds at least one (latency/throughput knob).
      device: ``None`` means the GPU; pass ``"cpu"`` for the plain path.
    """

    def __init__(self, model, *, batch_buckets: Sequence[int] =
                 (1, 8, 32, 128), preprocess=None, max_delay_ms: float = 2.0,
                 device=None, warmup: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.preprocess = preprocess
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.max_delay_s = max_delay_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        # batches: coalesced groups of requests; runs: forwards on the
        # device (a group larger than the top bucket takes several)
        self._stats = {"requests": 0, "images": 0, "batches": 0, "runs": 0,
                       "padded_images": 0, "failed_requests": 0,
                       "latency_ms_sum": 0.0}
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        img = model.img_size
        self._sample_shape = (img, img, model.in_chans)
        # the dtype requests run at; submit() coerces numbers to it and
        # rejects everything else
        self._in_dtype = np.uint8 if preprocess is not None else np.float32
        if warmup:
            for b in self.buckets:
                self._run(np.zeros((b, *self._sample_shape), self._in_dtype))
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def _run(self, images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(images).to(self.device)
            if self.preprocess is not None:
                x = self.preprocess(x)
            logits = fast_forward(self.model, x)["logits"]
            return logits.cpu().numpy()

    # -------------------------------------------------- public surface
    def submit(self, images) -> Future:
        """Enqueue [b, H, W, C] images; resolves to [b, num_classes]
        float32 logits (numpy). Thread-safe."""
        if self._stop.is_set():
            raise RuntimeError("engine closed")
        images = np.asarray(images)
        if images.shape[1:] != self._sample_shape:
            raise ValueError(
                f"expected (*, {self._sample_shape}), got {images.shape}")
        if images.dtype != self._in_dtype:
            if self._in_dtype == np.float32 and (
                    np.issubdtype(images.dtype, np.floating)
                    or np.issubdtype(images.dtype, np.integer)):
                images = images.astype(np.float32)
            else:
                raise TypeError(
                    f"engine runs {np.dtype(self._in_dtype).name} inputs, "
                    f"got {images.dtype.name}")
        fut: Future = Future()
        self._queue.put((images, fut, time.perf_counter()))
        # TOCTOU vs close(): the put can land after close() drained the
        # queue (that future would never resolve) — re-check and fail it
        # here; done() guards on both sides make double-resolution safe
        if self._stop.is_set():
            try:
                fut.set_exception(RuntimeError("engine closed"))
            except Exception:                               # noqa: BLE001
                pass  # dispatcher/close resolved it first
        return fut

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        if s["requests"]:
            s["mean_latency_ms"] = s["latency_ms_sum"] / s["requests"]
        return s

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail any requests still queued so callers don't hang
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------- dispatcher
    def _dispatch(self):
        max_b = self.buckets[-1]
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            pending = [first]
            total = first[0].shape[0]
            deadline = time.perf_counter() + self.max_delay_s
            # coalesce until the largest bucket is full or the delay
            # budget is spent
            while total < max_b:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                pending.append(nxt)
                total += nxt[0].shape[0]
            # a failing run must not kill the dispatcher: resolve the
            # affected futures with the error and keep serving —
            # otherwise every later submit() hangs forever
            try:
                self._run_batch(pending, total)
            except Exception as e:                        # noqa: BLE001
                with self._stats_lock:
                    self._stats["failed_requests"] += len(pending)
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_batch(self, pending, total):
        images = np.concatenate([p[0] for p in pending], axis=0)
        done, padded, runs, outs = 0, 0, 0, []
        # oversized coalesced batches run in max-bucket chunks; each
        # tail takes the smallest bucket that fits it
        while done < total:
            remaining = total - done
            bucket = next((b for b in self.buckets if b >= remaining),
                          self.buckets[-1])
            take = min(remaining, bucket)
            chunk = images[done:done + take]
            if take < bucket:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], bucket - take, axis=0)],
                    axis=0)
                padded += bucket - take
            outs.append(self._run(chunk)[:take])
            done += take
            runs += 1
        logits = np.concatenate(outs, axis=0)
        now = time.perf_counter()
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["runs"] += runs
            self._stats["images"] += total
            self._stats["padded_images"] += padded
            for imgs, fut, t0 in pending:
                self._stats["requests"] += 1
                self._stats["latency_ms_sum"] += (now - t0) * 1e3
        off = 0
        for imgs, fut, _ in pending:
            # a caller may have cancelled its future; set_result would
            # raise InvalidStateError and poison the rest of the batch
            if not fut.done():
                fut.set_result(logits[off:off + imgs.shape[0]])
            off += imgs.shape[0]
