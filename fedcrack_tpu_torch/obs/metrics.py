"""Streaming percentiles (the counterpart of
``fedcrack_tpu.obs.metrics.StreamingPercentiles``; the JSONL metrics
logger and the profiler helpers of that module are not ported yet)."""

from __future__ import annotations

import math
import random
import threading


class StreamingPercentiles:
    """Streaming p50/p95/p99 over a bounded reservoir (Vitter's algorithm R).

    A seeded reservoir keeps a uniform sample of everything seen in
    O(capacity) memory; until it overflows the percentiles are exact,
    ``numpy.percentile(all_samples, q)`` with linear interpolation. The
    reservoir draws from the stdlib's ``random.Random(seed)`` exactly as
    the JAX package's does, so the same seed and inserts keep the same
    sample. Thread-safe: ``add`` may run while another thread reads
    ``summary``.
    """

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._capacity = capacity
        self._rng = random.Random(seed)
        self._values: list[float] = []
        self._count = 0
        self._max = None
        self._min = None
        self._sum = 0.0
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._max = v if self._max is None else max(self._max, v)
            self._min = v if self._min is None else min(self._min, v)
            if len(self._values) < self._capacity:
                self._values.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self._capacity:
                    self._values[j] = v

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float | None:
        """``numpy.percentile(..., method='linear')`` over the reservoir;
        None while empty."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return None
        pos = (len(vals) - 1) * (q / 100.0)
        lo = math.floor(pos)
        hi = math.ceil(pos)
        if lo == hi:
            return vals[int(pos)]
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    def summary(self) -> dict:
        """count, min / mean / max and p50 / p95 / p99 (None while empty)."""
        with self._lock:
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        return {
            "count": count,
            "min": vmin,
            "mean": (total / count) if count else None,
            "max": vmax,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }
