"""Fleet router: least-outstanding dispatch and SLO load shedding.

The counterpart of ``fedcrack_tpu.serve.router``. One router owns the
fleet's replicas (each an engine and a micro-batcher); ``submit`` is the
single admission point:

1. **Admission control.** Before a request is accepted it may be SHED
   with a loud :class:`LoadShedError` (the gRPC front door answers
   ``RESOURCE_EXHAUSTED``): when the queued requests across live replicas
   reach ``ServeConfig.queue_bound``, or when the fleet's rolling p95
   latency breaches ``ServeConfig.slo_p95_ms``. Shedding happens only
   here; an admitted request is never dropped.
2. **Dispatch.** The live replica serving the bucket with the fewest
   outstanding requests wins, ties to the lowest index. A ``serve.route``
   span records the choice.

Rolling p95: per-completion latencies feed two bounded reservoirs rotated
every ``window_s``; reads pool the current and the previous window, so a
breach recovers once latencies do. The probe arms only past
``MIN_SHED_SAMPLES`` samples in the window pair.

Replica failure: :meth:`FleetRouter.kill_replica` drains the dead replica's
queued requests and resubmits them, with their original futures and
submit times, to survivors, bypassing admission control: they were
already accepted.

Lock order: ``_pick`` runs under ``serve.router.dispatch`` and reads each
batcher's ``outstanding()`` under ``serve.batcher.stats``. No path takes
the router's lock while holding a batcher's.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.metrics import StreamingPercentiles
from fedcrack_tpu_torch.obs.registry import REGISTRY

log = logging.getLogger("fedcrack_torch.serve.router")

# The p95 shed probe stays disarmed until this many samples sit in the
# rolling window pair: shedding on a cold-start sample would page on noise.
MIN_SHED_SAMPLES = 16

SHED_QUEUE_BOUND = "queue_bound"
SHED_P95_SLO = "p95_slo"


class LoadShedError(RuntimeError):
    """Admission refused: the caller gets this BEFORE the request enters
    any queue (RESOURCE_EXHAUSTED at the front door, never a silent drop)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"load shed ({reason}): {detail}")
        self.reason = reason
        self.detail = detail


class RollingPercentiles:
    """Two-reservoir rolling latency window: samples land in the current
    reservoir; every ``window_s`` it becomes the previous one and a fresh
    reservoir starts. Reads pool both."""

    def __init__(self, window_s: float = 10.0, capacity: int = 2048, seed: int = 0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self._window_s = window_s
        self._capacity = capacity
        self._seed = seed
        self._lock = threading.Lock()
        self._cur = StreamingPercentiles(capacity, seed=seed)
        self._prev = StreamingPercentiles(capacity, seed=seed + 1)
        self._t_rotate = time.monotonic() + window_s

    def _maybe_rotate_locked(self) -> None:
        now = time.monotonic()
        if now >= self._t_rotate:
            self._prev = self._cur
            self._cur = StreamingPercentiles(self._capacity, seed=self._seed)
            self._t_rotate = now + self._window_s

    def add(self, value_ms: float) -> None:
        with self._lock:
            self._maybe_rotate_locked()
            self._cur.add(value_ms)

    def percentile(self, q: float) -> float | None:
        """Pooled percentile over the previous and current window; None
        until any sample exists."""
        with self._lock:
            self._maybe_rotate_locked()
            cur, prev = self._cur, self._prev
        pooled = StreamingPercentiles(self._capacity, seed=self._seed)
        pooled.merge(cur)
        pooled.merge(prev)
        return pooled.percentile(q)

    def count(self) -> int:
        with self._lock:
            self._maybe_rotate_locked()
            return self._cur.count + self._prev.count


class FleetRouter:
    """Admission and dispatch over the fleet's replicas: objects with
    ``.index``, ``.batcher`` (a ``MicroBatcher``) and ``.alive``
    (``serve.fleet.Replica``). The router exposes the batcher's ``submit``
    surface, so the front door works against one replica or a fleet."""

    def __init__(self, replicas: list, serve_config: Any, *, window_s: float = 10.0):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.serve_config = serve_config
        self._lock = make_lock("serve.router.dispatch")
        self.rolling = RollingPercentiles(window_s=window_s)
        self._shed_counts: dict[str, int] = {}
        self._m_shed = REGISTRY.counter(
            "serve_shed_total",
            "requests refused at admission (RESOURCE_EXHAUSTED) by reason",
            labels=("reason",),
        )
        self._m_replicas = REGISTRY.gauge(
            "serve_fleet_replicas", "live replica workers behind the fleet router"
        )
        self._m_replicas.set(sum(1 for r in self.replicas if r.alive))
        # The signals admission control acts on, published so that the
        # autoscaler (and any operator) scrapes them.
        self._m_rolling_p95 = REGISTRY.gauge(
            "serve_rolling_p95_seconds",
            "rolling windowed p95 served latency the admission probe reads",
        )
        self._m_queue_depth = REGISTRY.gauge(
            "serve_router_queue_depth_total",
            "queued requests across live replicas per bucket",
            labels=("bucket",),
        )
        # The shadow mirror hook: observe-only, production answers never
        # depend on it. None = no candidate under evaluation.
        self._shadow: Any | None = None

    # ---- admission control ----

    def live_replicas(self) -> list:
        return [r for r in self.replicas if r.alive]

    def total_queued(self) -> int:
        return sum(r.batcher.queued() for r in self.live_replicas())

    def shed_reason(self) -> tuple[str, str] | None:
        """``(reason, detail)`` when the next request must be shed; None =
        admit. Checked outside the dispatch lock."""
        bound = self.serve_config.queue_bound
        if bound > 0:
            queued = self.total_queued()
            if queued >= bound:
                return SHED_QUEUE_BOUND, f"{queued} queued >= queue_bound {bound}"
        slo = self.serve_config.slo_p95_ms
        if slo > 0 and self.rolling.count() >= MIN_SHED_SAMPLES:
            p95 = self.rolling.percentile(95.0)
            if p95 is not None and p95 > slo:
                return SHED_P95_SLO, f"rolling p95 {p95:.1f} ms > SLO {slo:.1f} ms"
        return None

    def shed_counts(self) -> dict:
        with self._lock:
            return dict(self._shed_counts)

    def refresh_gauges(self) -> dict:
        """Publish the admission signals (rolling p95, per-bucket queue
        depth) as registry gauges and return them. Buckets with empty
        queues publish 0, so the series never goes stale."""
        p95_ms = self.rolling.percentile(95.0)
        p95_s = (p95_ms if p95_ms is not None else 0.0) / 1e3
        self._m_rolling_p95.set(p95_s)
        depths: dict[int, int] = {}
        for r in self.live_replicas():
            for size, n in r.batcher.queued_by_bucket().items():
                depths[size] = depths.get(size, 0) + n
        for size, n in sorted(depths.items()):
            self._m_queue_depth.labels(bucket=str(size)).set(n)
        return {"p95_s": p95_s, "queue_depth": depths}

    # ---- shadow mirroring ----

    def attach_shadow(self, mirror: Any) -> None:
        """Install the shadow mirror hook, an object with
        ``observe(image_u8)``, called AFTER a request is admitted and
        dispatched; its answer never reaches the client. One mirror at a
        time; attach replaces. ``serve/shadow.py``'s controller attaches
        one per staged candidate."""
        with self._lock:
            self._shadow = mirror

    def detach_shadow(self, mirror: Any | None = None) -> None:
        """Remove the shadow hook. With ``mirror`` given, only while it is
        still the attached one: a finished evaluation never tears down its
        successor's mirror."""
        with self._lock:
            if mirror is None or self._shadow is mirror:
                self._shadow = None

    # ---- dispatch ----

    def _pick(self, size: int):
        """Least-outstanding live replica serving this bucket (ties to the
        lowest index): the same filter the kill failover applies."""
        live = [r for r in self.live_replicas() if size in r.batcher.engine.bucket_sizes]
        if not live:
            raise RuntimeError(f"no live replica serves bucket {size}")
        return min(live, key=lambda r: (r.batcher.outstanding(), r.index))

    def submit(self, image_u8: np.ndarray, deadline_ms: float | None = None) -> Future:
        """Admission-checked, least-outstanding-dispatched submit. Raises
        :class:`LoadShedError` when admission refuses; returns the replica
        batcher's Future otherwise."""
        shed = self.shed_reason()
        if shed is not None:
            reason, detail = shed
            with self._lock:
                self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1
            self._m_shed.labels(reason=reason).inc()
            flight.note("serve.shed", reason=reason, detail=detail)
            raise LoadShedError(reason, detail)
        size = image_u8.shape[0]
        # A replica may die between pick and submit (kill_replica drains its
        # batcher after flipping alive): re-pick instead of failing an
        # ADMITTED request; each retry sees one fewer live replica.
        for _ in range(len(self.replicas) + 1):
            with self._lock:
                replica = self._pick(size)
            try:
                with tracing.span(
                    "serve.route",
                    trace=f"bucket-{size}",
                    replica=replica.index,
                    bucket=size,
                    outstanding=replica.batcher.outstanding(),
                ):
                    fut = replica.batcher.submit(image_u8, deadline_ms=deadline_ms)
            except RuntimeError:
                if replica.alive:
                    raise
                continue
            fut.add_done_callback(self._on_done)
            shadow = self._shadow
            if shadow is not None:
                try:
                    shadow.observe(image_u8)
                except Exception:
                    # The shadow plane's failure, never the client's.
                    log.exception("shadow mirror failed to observe a request")
            return fut
        raise RuntimeError("no live replicas")

    def _on_done(self, fut: Future) -> None:
        # Served latency feeds the rolling probe, whichever replica served
        # it; a failed future carries no latency.
        if fut.cancelled() or fut.exception() is not None:
            return
        self.rolling.add(fut.result().latency_ms)

    # ---- replica lifecycle ----

    def kill_replica(self, index: int) -> dict:
        """Take replica ``index`` out of rotation and reroute its queued
        requests to survivors with their original futures: zero accepted
        requests dropped. In-flight batches on it complete first; with no
        survivor for a bucket, its drained requests fail loudly."""
        with self._lock:
            replica = self.replicas[index]
            if not replica.alive:
                return {"rerouted": 0, "failed": 0, "already_dead": True}
            replica.alive = False
        leftovers = replica.batcher.drain()
        rerouted = failed = 0
        for req in leftovers:
            target = None
            for r in sorted(self.live_replicas(), key=lambda r: (r.batcher.outstanding(), r.index)):
                if req.image.shape[0] in r.batcher.engine.bucket_sizes:
                    target = r
                    break
            if target is None:
                failed += 1
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("replica crashed with no survivor for its bucket")
                    )
                continue
            target.batcher.resubmit(req)
            rerouted += 1
        self._m_replicas.set(sum(1 for r in self.replicas if r.alive))
        flight.note("serve.replica_killed", replica=index, rerouted=rerouted, failed=failed)
        return {"rerouted": rerouted, "failed": failed, "already_dead": False}

    def stats(self) -> dict:
        """Per-replica batcher stats, shed counts and the rolling p95 the
        admission probe reads."""
        return {
            "replicas": len(self.replicas),
            "live": len(self.live_replicas()),
            "shed": self.shed_counts(),
            "rolling_p95_ms": self.rolling.percentile(95.0),
            "per_replica": {
                str(r.index): {"alive": r.alive, **r.batcher.stats()} for r in self.replicas
            },
        }
