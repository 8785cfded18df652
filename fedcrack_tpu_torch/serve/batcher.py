"""Dynamic micro-batching for the serving plane.

The counterpart of ``fedcrack_tpu.serve.batcher.MicroBatcher`` without the
JAX package's tracing, metrics registry and chaos hooks. Requests for one
bucket accumulate until ``max_batch`` lanes wait or ``max_delay_ms`` has
passed since the oldest, then run as one ``engine.predict_bucket`` call.
One worker thread per bucket; the device serializes the batches.

Weight-version semantics: a worker takes ONE weights snapshot per batch,
immediately before dispatch, and answers every request of the batch from
it, so a swap installed meanwhile affects only later batches. Requests past
their deadline are served and counted, never dropped. A batch whose
dispatch raises is retried (with a fresh snapshot) up to
``MAX_BATCH_ATTEMPTS`` times, then its requests fail loudly.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np

log = logging.getLogger("fedcrack_torch.serve.batcher")

MAX_BATCH_ATTEMPTS = 3


@dataclass
class PredictResult:
    """What the front door needs to answer one request."""

    probs: np.ndarray          # [S, S, 1] float32 bucket-resolution output
    model_version: int
    queue_ms: float
    latency_ms: float
    deadline_missed: bool


@dataclass
class _Request:
    image: np.ndarray          # [S, S, 3] uint8, already bucket-shaped
    t_submit: float
    deadline_s: float | None   # absolute monotonic deadline, None = none
    future: Future = field(default_factory=Future)


class StaticWeights:
    """A constant ``(version, weights)`` snapshot with the version manager's
    API, for swap-less serving and tests."""

    def __init__(self, variables: Any, version: int = 0):
        self._snap = (version, variables)

    def snapshot(self) -> tuple[int, Any]:
        return self._snap


class _Percentiles:
    """p50/p95/p99 over a bounded reservoir (Vitter's algorithm R, seeded):
    exact ``numpy.percentile`` until ``capacity`` samples, a uniform sample
    after."""

    def __init__(self, capacity: int, seed: int = 0):
        self._capacity = capacity
        self._rng = random.Random(seed)
        self._values: list[float] = []
        self._count = 0
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._count += 1
            if len(self._values) < self._capacity:
                self._values.append(float(value))
            else:
                j = self._rng.randrange(self._count)
                if j < self._capacity:
                    self._values[j] = float(value)

    def summary(self) -> dict:
        with self._lock:
            values = list(self._values)
            count = self._count
        if not values:
            return {"count": 0}
        p50, p95, p99 = np.percentile(values, [50, 95, 99])
        return {"count": count, "p50": float(p50), "p95": float(p95), "p99": float(p99)}


class MicroBatcher:
    """Per-bucket micro-batching over one engine. ``weights`` is any object
    with ``snapshot() -> (version, weights)``: :class:`StaticWeights` or
    the ``ModelVersionManager``."""

    def __init__(
        self,
        engine: Any,
        weights: Any,
        *,
        max_delay_ms: float | None = None,
        reservoir_capacity: int = 4096,
    ):
        self.engine = engine
        self.weights = weights
        self.max_batch = engine.max_batch
        cfg_delay = engine.serve_config.max_delay_ms
        self.max_delay_s = (cfg_delay if max_delay_ms is None else max_delay_ms) / 1e3
        self._queues: dict[int, queue.Queue] = {
            size: queue.Queue() for size in engine.bucket_sizes
        }
        self.latency = _Percentiles(reservoir_capacity)
        self.queue_latency = _Percentiles(reservoir_capacity)
        self._lock = threading.Lock()
        self._counts = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "deadline_missed": 0,
            "batches": 0,
            "batch_retries": 0,
        }
        self._per_bucket: dict[int, int] = {s: 0 for s in engine.bucket_sizes}
        self._versions_served: dict[int, int] = {}
        self._running = True
        self._workers = [
            threading.Thread(target=self._worker, args=(size,), daemon=True)
            for size in engine.bucket_sizes
        ]
        for t in self._workers:
            t.start()

    # ---- submission ----

    def submit(self, image_u8: np.ndarray, deadline_ms: float | None = None) -> Future:
        """Enqueue one bucket-shaped ``[S, S, 3]`` uint8 image; resolves to a
        :class:`PredictResult`. Raises at once on a non-bucket shape."""
        h, w, _ = image_u8.shape
        if h != w or h not in self._queues:
            raise ValueError(
                f"submit() takes exact bucket shapes {self.engine.bucket_sizes}; "
                f"got {image_u8.shape} (pad or tile through the engine)"
            )
        now = time.monotonic()
        cfg_deadline = self.engine.serve_config.deadline_ms
        if deadline_ms is None and cfg_deadline > 0:
            deadline_ms = cfg_deadline
        req = _Request(
            image=image_u8,
            t_submit=now,
            deadline_s=(now + deadline_ms / 1e3) if deadline_ms else None,
        )
        # The running check and the enqueue share one locked section with
        # close(), so a request never lands in a queue nobody drains.
        with self._lock:
            if not self._running:
                raise RuntimeError("batcher is closed")
            self._counts["submitted"] += 1
            self._queues[h].put(req)
        return req.future

    # ---- the per-bucket worker ----

    def _collect(self, size: int) -> list[_Request] | None:
        """Block for the first request, then fill until max_batch or the
        delay window closes. None = shutdown."""
        q = self._queues[size]
        while True:
            try:
                first = q.get(timeout=0.05)
                break
            except queue.Empty:
                if not self._running:
                    return None
        batch = [first]
        t_close = time.monotonic() + self.max_delay_s
        while len(batch) < self.max_batch:
            remaining = t_close - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self, size: int) -> None:
        while True:
            batch = self._collect(size)
            if batch is None:
                return
            self._execute(size, batch)

    def _execute(self, size: int, batch: list[_Request]) -> None:
        images = np.stack([r.image for r in batch])
        last_err: Exception | None = None
        for _ in range(MAX_BATCH_ATTEMPTS):
            # One snapshot per attempt, taken right before dispatch.
            version, variables = self.weights.snapshot()
            try:
                t0 = time.monotonic()
                probs = self.engine.predict_bucket(variables, images)
                t1 = time.monotonic()
            except Exception as e:  # the worker must survive a failed batch
                log.exception("bucket %d batch of %d failed", size, len(batch))
                last_err = e
                with self._lock:
                    self._counts["batch_retries"] += 1
                continue
            self._resolve(batch, probs, version, t0, t1, size)
            return
        with self._lock:
            self._counts["failed"] += len(batch)
        for r in batch:
            r.future.set_exception(last_err)

    def _resolve(self, batch, probs, version, t0, t1, size) -> None:
        n_missed = 0
        results = []
        for i, r in enumerate(batch):
            queue_ms = (t0 - r.t_submit) * 1e3
            latency_ms = (t1 - r.t_submit) * 1e3
            missed = r.deadline_s is not None and t1 > r.deadline_s
            n_missed += bool(missed)
            self.queue_latency.add(queue_ms)
            self.latency.add(latency_ms)
            results.append(PredictResult(probs[i], version, queue_ms, latency_ms, missed))
        with self._lock:
            self._counts["completed"] += len(batch)
            self._counts["batches"] += 1
            self._counts["deadline_missed"] += n_missed
            self._per_bucket[size] += len(batch)
            self._versions_served[version] = self._versions_served.get(version, 0) + len(batch)
        for r, res in zip(batch, results):
            r.future.set_result(res)

    # ---- observability / shutdown ----

    def stats(self) -> dict:
        """Counters, per-bucket traffic, versions served and latency
        percentiles (ms), JSON-safe."""
        with self._lock:
            counts = dict(self._counts)
            per_bucket = {str(k): v for k, v in self._per_bucket.items()}
            versions = {str(k): v for k, v in self._versions_served.items()}
        return {
            **counts,
            "per_bucket": per_bucket,
            "versions_served": versions,
            "latency_ms": self.latency.summary(),
            "queue_ms": self.queue_latency.summary(),
        }

    def close(self) -> None:
        """Stop accepting work, let the workers drain their queues, fail
        anything left."""
        with self._lock:
            self._running = False
        for t in self._workers:
            t.join(timeout=30)
        for q in self._queues.values():
            while True:
                try:
                    r = q.get_nowait()
                except queue.Empty:
                    break
                if not r.future.done():
                    r.future.set_exception(RuntimeError("batcher closed"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
