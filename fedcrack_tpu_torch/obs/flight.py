"""Flight recorder: a bounded in-memory ring of recent events.

The counterpart of ``fedcrack_tpu.obs.flight``. Instrumented code calls
:func:`note` unconditionally (one global read when no ring is installed,
one deque append when one is); :func:`dump` writes the ring as one JSON
artifact, with the metric registry's exposition at that instant. Spans
(``obs.spans``), the transport's update outcomes and flushes, every fault
``chaos.plan.FaultPlan.take`` hands out and every watchdog evaluation
feed it.

Besides an explicit :func:`dump` (a failed audit, a watchdog breach), two
triggers dump the ring when :func:`install` arms them (``hooks=True``):

- an unhandled exception: ``sys.excepthook`` and ``threading.excepthook``
  are chained, so the previous hooks still run;
- SIGUSR2: an operator can ask a live process for a dump (armed only
  where the interpreter allows it, on the main thread).

:func:`uninstall` disarms the ring and restores whatever it replaced.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
import traceback
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
            # fedlint: disable=DET001 -- human-readable dump timestamp
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
_prev_excepthook = None
_prev_threading_hook = None
_prev_sigusr2: Any = None
_hooks_armed = False


def _on_excepthook(exc_type, exc, tb) -> None:
    ring = _ring
    if ring is not None:
        ring.dump("unhandled exception: " + "".join(traceback.format_exception_only(exc_type, exc)).strip())
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _on_threading_excepthook(args) -> None:
    ring = _ring
    if ring is not None:
        ring.dump(
            f"unhandled exception in thread {args.thread.name if args.thread else '?'}: "
            + "".join(traceback.format_exception_only(args.exc_type, args.exc_value)).strip()
        )
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def _on_sigusr2(signum, frame) -> None:
    ring = _ring
    if ring is not None:
        ring.dump("SIGUSR2")
    prev = _prev_sigusr2
    if callable(prev):
        prev(signum, frame)


def install(path: str | None = None, capacity: int = DEFAULT_CAPACITY, hooks: bool = True) -> FlightRecorder:
    """Arm the process flight recorder, replacing any existing ring, and
    with ``hooks`` chain the exception hooks and the SIGUSR2 trigger.
    ``path`` is where :func:`dump` lands by default."""
    global _ring, _prev_excepthook, _prev_threading_hook, _prev_sigusr2, _hooks_armed
    ring = FlightRecorder(capacity=capacity, path=path)
    with _ring_lock:
        _ring = ring
        if hooks and not _hooks_armed:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _on_excepthook
            _prev_threading_hook = threading.excepthook
            threading.excepthook = _on_threading_excepthook
            try:
                _prev_sigusr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
            except (ValueError, AttributeError, OSError):
                # Not the main thread, or no SIGUSR2 here: the exception
                # hooks still arm; the signal trigger is optional.
                _prev_sigusr2 = None
            _hooks_armed = True
    return ring


def uninstall() -> None:
    """Disarm the ring and restore whatever hooks :func:`install` replaced."""
    global _ring, _prev_excepthook, _prev_threading_hook, _prev_sigusr2, _hooks_armed
    with _ring_lock:
        _ring = None
        if _hooks_armed:
            if _prev_excepthook is not None:
                sys.excepthook = _prev_excepthook
                _prev_excepthook = None
            if _prev_threading_hook is not None:
                threading.excepthook = _prev_threading_hook
                _prev_threading_hook = None
            if _prev_sigusr2 is not None:
                try:
                    signal.signal(signal.SIGUSR2, _prev_sigusr2)
                except (ValueError, AttributeError, OSError):
                    pass
                _prev_sigusr2 = None
            _hooks_armed = False


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
