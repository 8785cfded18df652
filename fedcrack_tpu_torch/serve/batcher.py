"""Dynamic micro-batching for the serving plane.

The counterpart of ``fedcrack_tpu.serve.batcher.MicroBatcher``. Requests
for one bucket accumulate until ``max_batch`` lanes wait or
``max_delay_ms`` has passed since the oldest, then run as one
``engine.predict_bucket`` call. One worker thread per bucket; the device
serializes the batches.

Weight-version semantics: a worker takes ONE weights snapshot per batch,
immediately before dispatch, and answers every request of the batch from
it, so a swap installed meanwhile affects only later batches. Requests past
their deadline are served and counted, never dropped. A batch whose
dispatch raises is retried (with a fresh snapshot) up to
``MAX_BATCH_ATTEMPTS`` times, then its requests fail loudly.

Accounting: per-request queue and total latency through
:class:`~fedcrack_tpu_torch.obs.metrics.StreamingPercentiles` reservoirs,
deadline misses, the swap gap (idle time between the last batch on one
version and the first on the next), the ``serve_*`` registry families,
one ``serve.batch`` span per dispatched batch, and, with ``metrics=``, one
``serve_batch`` record per batch. The fleet plumbing (``outstanding``,
``queued``, ``queued_by_bucket``, ``resubmit``, ``drain``) is what the
router dispatches and fails over on. ``chaos=`` attaches a
``chaos.ServeChaos`` hook, called as ``on_batch(bucket, batch_index,
attempt)`` between each attempt's snapshot and its dispatch; an injected
device loss takes the retry path a real failure would.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.metrics import StreamingPercentiles
from fedcrack_tpu_torch.obs.registry import REGISTRY

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
    trace: str = ""            # correlation id (req-NNNNNN) for span joins
    future: Future = field(default_factory=Future)


class StaticWeights:
    """A constant ``(version, weights)`` snapshot with the version manager's
    API, for swap-less serving and tests."""

    def __init__(self, variables: Any, version: int = 0):
        self._snap = (version, variables)

    def snapshot(self) -> tuple[int, Any]:
        return self._snap


class MicroBatcher:
    """Per-bucket micro-batching over one engine. ``weights`` is any object
    with ``snapshot() -> (version, weights)``: :class:`StaticWeights`, the
    ``ModelVersionManager`` or a fleet replica's slot. ``replica`` stamps
    the fleet index on every ``serve.batch`` span."""

    def __init__(
        self,
        engine: Any,
        weights: Any,
        *,
        max_delay_ms: float | None = None,
        metrics: Any | None = None,
        chaos: Any | None = None,
        reservoir_capacity: int = 4096,
        replica: int | None = None,
    ):
        self.engine = engine
        self._chaos = chaos
        self.weights = weights
        self.replica = replica
        self.max_batch = engine.max_batch
        cfg_delay = engine.serve_config.max_delay_ms
        self.max_delay_s = (cfg_delay if max_delay_ms is None else max_delay_ms) / 1e3
        self._metrics = metrics
        self._queues: dict[int, queue.Queue] = {
            size: queue.Queue() for size in engine.bucket_sizes
        }
        self.latency = StreamingPercentiles(reservoir_capacity)
        self.queue_latency = StreamingPercentiles(reservoir_capacity)
        self._lock = make_lock("serve.batcher.stats")
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
        self._m_requests = REGISTRY.counter(
            "serve_requests_total", "requests completed per bucket program", labels=("bucket",)
        )
        self._m_latency = REGISTRY.histogram(
            "serve_request_seconds",
            "submit-to-answer latency per bucket (queue + dispatch)",
            labels=("bucket",),
        )
        self._m_queue_wait = REGISTRY.histogram(
            "serve_queue_seconds", "submit-to-dispatch queue wait per bucket", labels=("bucket",)
        )
        self._m_deadline = REGISTRY.counter(
            "serve_deadline_missed_total",
            "requests answered past their deadline (served, never dropped)",
        )
        self._m_batches = REGISTRY.counter("serve_batches_total", "dispatched micro-batches")
        self._m_retries = REGISTRY.counter(
            "serve_batch_retries_total", "batch dispatch retries after a failure"
        )
        self._m_failed = REGISTRY.counter(
            "serve_failed_requests_total",
            "requests failed loudly after every batch attempt raised",
        )
        self._m_qdepth = REGISTRY.gauge(
            "serve_queue_depth_total", "requests waiting across all bucket queues"
        )
        self._last_batch_end: float | None = None
        self._last_version: int | None = None
        # Versions whose first served batch already joined its swap's trace.
        self._linked_versions: set[int] = set()
        self.swap_gaps_ms: list[float] = []
        self._running = True
        # drain() halts the workers promptly (only the in-flight batch
        # finishes) so the queued requests can move to survivors.
        self._halt = False
        self._workers = [
            threading.Thread(target=self._worker, args=(size,), daemon=True)
            for size in engine.bucket_sizes
        ]
        for t in self._workers:
            t.start()

    def _set_queue_depth(self) -> None:
        self._m_qdepth.set(sum(q.qsize() for q in self._queues.values()))

    # ---- submission ----

    def submit(self, image_u8: np.ndarray, deadline_ms: float | None = None) -> Future:
        """Enqueue one bucket-shaped ``[S, S, 3]`` uint8 image; resolves to a
        :class:`PredictResult`. Raises at once on a non-bucket shape."""
        h, w, _ = image_u8.shape
        if h != w or h not in self._queues:
            raise ValueError(
                f"submit() takes exact bucket shapes {self.engine.bucket_sizes}; "
                f"got {image_u8.shape} (route through the front door for "
                f"padding/tiling)"
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
        # drain() and close(), so a request either lands in a queue before
        # a drain begins (the sweep reroutes it) or sees the closed batcher
        # and raises; it never lands in a queue nobody drains.
        with self._lock:
            if not self._running:
                raise RuntimeError("batcher is closed")
            self._counts["submitted"] += 1
            req.trace = f"req-{self._counts['submitted']:06d}"
            self._queues[h].put(req)
        self._set_queue_depth()
        return req.future

    # ---- the per-bucket worker ----

    def _collect(self, size: int) -> list[_Request] | None:
        """Block for the first request, then fill until max_batch or the
        delay window closes. None = shutdown."""
        q = self._queues[size]
        while True:
            if self._halt:
                return None
            try:
                first = q.get(timeout=0.05)
                break
            except queue.Empty:
                if not self._running:
                    return None
        batch = [first]
        t_close = time.monotonic() + self.max_delay_s
        while len(batch) < self.max_batch:
            if self._halt:
                break  # dispatch what we hold; the queue moves to survivors
            remaining = t_close - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self, size: int) -> None:
        batch_index = 0
        while True:
            batch = self._collect(size)
            if batch is None:
                return
            self._execute(size, batch, batch_index)
            batch_index += 1

    def _span_route(self, size: int, version: int) -> dict:
        """The ``serve.batch`` span's trace: the FIRST batch served on a
        swapped-in version joins the swap's version-lineage trace and links
        to its span; later batches keep the per-bucket trace."""
        route: dict = {"trace": f"bucket-{size}"}
        swap_ctx_of = getattr(self.weights, "swap_context", None)
        if swap_ctx_of is not None:
            with self._lock:
                first_on_version = version not in self._linked_versions
                if first_on_version:
                    self._linked_versions.add(version)
            if first_on_version:
                wire = swap_ctx_of(version)
                parsed = tracing.TraceContext.from_wire(wire)
                if parsed is not None:
                    route = {"trace": parsed.trace, "remote_parent": wire}
        if self.replica is not None:
            route["replica"] = self.replica
        return route

    def _execute(self, size: int, batch: list[_Request], batch_index: int) -> None:
        images = np.stack([r.image for r in batch])
        last_err: Exception | None = None
        for attempt in range(MAX_BATCH_ATTEMPTS):
            # One snapshot per attempt, taken right before dispatch.
            version, variables = self.weights.snapshot()
            try:
                if self._chaos is not None:
                    self._chaos.on_batch(size, batch_index, attempt)
                with tracing.span(
                    "serve.batch",
                    bucket=size,
                    n=len(batch),
                    attempt=attempt,
                    batch_index=batch_index,
                    model_version=version,
                    requests=[r.trace for r in batch],
                    **self._span_route(size, version),
                ):
                    t0 = time.monotonic()
                    probs = self.engine.predict_bucket(variables, images)
                    t1 = time.monotonic()
            except Exception as e:  # the worker must survive a failed batch
                log.exception("bucket %d batch of %d failed", size, len(batch))
                last_err = e
                with self._lock:
                    self._counts["batch_retries"] += 1
                self._m_retries.inc()
                continue
            self._resolve(batch, probs, version, t0, t1, size)
            return
        flight.note("serve.batch_failed", bucket=size, n=len(batch), error=repr(last_err))
        with self._lock:
            self._counts["failed"] += len(batch)
        self._m_failed.inc(len(batch))
        for r in batch:
            r.future.set_exception(last_err)

    def _resolve(self, batch, probs, version, t0, t1, size) -> None:
        with self._lock:
            self._counts["completed"] += len(batch)
            self._counts["batches"] += 1
            self._per_bucket[size] += len(batch)
            self._versions_served[version] = self._versions_served.get(version, 0) + len(batch)
            if self._last_version is not None and version != self._last_version:
                # The swap pause as the served plane sees it, clamped at 0:
                # bucket workers may overlap across the version boundary.
                gap = (t0 - self._last_batch_end) * 1e3 if self._last_batch_end else 0.0
                self.swap_gaps_ms.append(max(0.0, gap))
            self._last_version = version
            self._last_batch_end = t1
        bucket_lbl = str(size)
        m_latency = self._m_latency.labels(bucket=bucket_lbl)
        m_queue = self._m_queue_wait.labels(bucket=bucket_lbl)
        self._m_requests.labels(bucket=bucket_lbl).inc(len(batch))
        self._m_batches.inc()
        self._set_queue_depth()
        n_missed = 0
        for i, r in enumerate(batch):
            queue_ms = (t0 - r.t_submit) * 1e3
            latency_ms = (t1 - r.t_submit) * 1e3
            missed = r.deadline_s is not None and t1 > r.deadline_s
            n_missed += bool(missed)
            self.queue_latency.add(queue_ms)
            self.latency.add(latency_ms)
            m_queue.observe(queue_ms / 1e3)
            m_latency.observe(latency_ms / 1e3)
            r.future.set_result(PredictResult(probs[i], version, queue_ms, latency_ms, missed))
        if n_missed:
            with self._lock:
                self._counts["deadline_missed"] += n_missed
            self._m_deadline.inc(n_missed)
        if self._metrics is not None:
            self._metrics.log(
                "serve_batch",
                bucket=size,
                batch=len(batch),
                model_version=version,
                exec_ms=round((t1 - t0) * 1e3, 3),
            )

    # ---- fleet plumbing ----

    def outstanding(self) -> int:
        """Requests accepted but not yet answered (queued or in a batch):
        the router's least-outstanding dispatch key."""
        with self._lock:
            c = self._counts
            return c["submitted"] - c["completed"] - c["failed"]

    def queued(self) -> int:
        """Requests waiting in bucket queues (not yet in a batch)."""
        return sum(q.qsize() for q in self._queues.values())

    def queued_by_bucket(self) -> dict[int, int]:
        """Per-bucket queue depth, which the router aggregates into the
        gauges the autoscaler scrapes (approximate by nature: a pressure
        signal, not an accounting truth)."""
        return {size: q.qsize() for size, q in self._queues.items()}

    def resubmit(self, req: _Request) -> None:
        """Re-enqueue a request drained from ANOTHER batcher (the router's
        failover). It keeps its submit time, deadline and Future, so the
        original caller's handle resolves and its latency spans the
        failover."""
        size = req.image.shape[0]
        if size not in self._queues:
            raise ValueError(f"resubmit bucket {size} not served here ({self.engine.bucket_sizes})")
        with self._lock:
            if not self._running:
                raise RuntimeError("batcher is closed")
            self._counts["submitted"] += 1
            self._queues[size].put(req)
        self._set_queue_depth()

    def drain(self) -> list[_Request]:
        """Stop this replica and hand back everything still queued, futures
        UNANSWERED (unlike :meth:`close`, which fails them), for the router
        to resubmit to surviving replicas. In-flight batches finish here
        first (their snapshot was already taken)."""
        with self._lock:
            self._halt = True
            self._running = False
        for t in self._workers:
            t.join(timeout=30)
        leftovers: list[_Request] = []
        for q in self._queues.values():
            while True:
                try:
                    leftovers.append(q.get_nowait())
                except queue.Empty:
                    break
        self._m_qdepth.set(0)
        return leftovers

    # ---- observability / shutdown ----

    def stats(self) -> dict:
        """Counters, per-bucket traffic, versions served, swap gaps and
        latency percentiles (ms), JSON-safe."""
        with self._lock:
            counts = dict(self._counts)
            per_bucket = {str(k): v for k, v in self._per_bucket.items()}
            versions = {str(k): v for k, v in self._versions_served.items()}
            gaps = list(self.swap_gaps_ms)
        return {
            **counts,
            "per_bucket": per_bucket,
            "versions_served": versions,
            "swap_gaps_ms": [round(g, 3) for g in gaps],
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
