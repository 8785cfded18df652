"""Flight recorder: a bounded in-memory ring of recent events.

The counterpart of ``fedcrack_tpu.obs.flight``. Instrumented code calls
:func:`note` unconditionally (one global read when no ring is installed,
one deque append when one is); :func:`dump` writes the ring as one JSON
artifact, with the metric registry's exposition at that instant. Spans
(``obs.spans``) and the transport's update outcomes and flushes feed it.
The reference's crash triggers (chained ``sys.excepthook`` and
``threading.excepthook``, SIGUSR2) belong to the server's command line,
which is not ported yet, and are left out.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.ioutils import atomic_write_bytes

DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """The bounded ring itself; thread-safe, O(1) per event."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, path: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self._events: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = make_lock("obs.flight.ring")
        self._t0 = time.monotonic()
        self._seen = 0
        self.dumps: list[dict] = []

    def note(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "t": round(time.monotonic() - self._t0, 6)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._events.append(rec)
            self._seen += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, reason: str, path: str | None = None) -> str:
        """Write the ring (+ a registry exposition snapshot) as one JSON
        artifact via the atomic writer; returns the path. Never raises —
        a dump failing must not mask the failure being dumped."""
        target = path or self.path or os.path.join(".", "flight_dump.json")
        exposition = ""
        try:
            from fedcrack_tpu_torch.obs.registry import REGISTRY

            exposition = REGISTRY.exposition()
        except Exception:  # the registry must never block a crash dump
            pass
        with self._lock:
            events = list(self._events)
            seen = self._seen
        payload = {
            "reason": reason,
            # Interval math in events is monotonic ("t"); the wall clock is
            # the display-only dump timestamp, per the obs convention.
            "ts": time.time(),
            "capacity": self.capacity,
            "events_seen": seen,
            "events": events,
            "metrics_exposition": exposition,
        }
        try:
            atomic_write_bytes(
                target,
                json.dumps(payload, sort_keys=True, default=str).encode("utf-8"),
            )
        except Exception:
            return target
        self.dumps.append({"reason": reason, "path": target})
        return target


# ---- the module-level ring (sanitizer idiom: zero-cost when off) ----

_ring: FlightRecorder | None = None
_ring_lock = make_lock("obs.flight.install")


def install(path: str | None = None, capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Arm the process flight recorder, replacing any existing ring.
    ``path`` is where :func:`dump` lands by default."""
    global _ring
    ring = FlightRecorder(capacity=capacity, path=path)
    with _ring_lock:
        _ring = ring
    return ring


def uninstall() -> None:
    global _ring
    with _ring_lock:
        _ring = None


def current() -> FlightRecorder | None:
    return _ring


def note(kind: str, **fields: Any) -> None:
    """Feed one event into the installed ring; one global read when off —
    instrumentation sites call this unconditionally."""
    ring = _ring
    if ring is not None:
        ring.note(kind, **fields)


def dump(reason: str, path: str | None = None) -> str | None:
    """Dump the installed ring (None when no ring is armed)."""
    ring = _ring
    if ring is None:
        return None
    return ring.dump(reason, path=path)
