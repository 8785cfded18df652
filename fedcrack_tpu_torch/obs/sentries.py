"""Leak sentries: RSS and device-memory watermarks with ``assert_steady``.

The counterpart of ``fedcrack_tpu.obs.sentries``. A long-lived session (a
soak, a production serve fleet) must reach a steady state and stay there:
a drifting resident set or device-memory watermark is a leak even when
every request succeeds. :class:`LeakSentry` samples

- **host RSS** through ``/proc/self/statm`` (``resource.getrusage``'s
  peak RSS on hosts without procfs), and
- **device memory in use** through ``torch.cuda.memory_allocated``, summed
  over the visible CUDA devices (the caching allocator's live tensor
  bytes, the counterpart of ``jax.Device.memory_stats()["bytes_in_use"]``).
  Where there is no CUDA device it reads 0, as the JAX package reads 0 on
  backends without memory stats; the device half of the audit is then
  vacuously steady,

tracks the high-watermark of each, exports all four series as collect-time
gauges (``process_resident_bytes``, ``process_resident_watermark_bytes``,
``device_memory_in_use_bytes``, ``device_memory_watermark_bytes``), and,
after :meth:`mark` pins the steady-state baseline, :meth:`assert_steady`
raises :class:`LeakError` when growth since the mark exceeds the slack.
Sampling is explicit (``sample()``); nothing spawns threads here.
"""

from __future__ import annotations

import os
import time
from typing import Any

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


class LeakError(AssertionError):
    """A watched memory series grew past its steady-state slack."""


def rss_bytes() -> int:
    """Current resident set size of this process, in bytes."""
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            fields = f.read().split()
        return int(fields[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        import resource

        # ru_maxrss is the PEAK (KiB on linux); a peak is still a usable
        # watermark signal on procfs-less hosts.
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


# glibc's mallopt parameter number for the mmap threshold, and the value
# it starts from.
_M_MMAP_THRESHOLD = -3
_MMAP_THRESHOLD_BYTES = 128 * 1024


def pin_mmap_threshold() -> bool:
    """Fix glibc's mmap threshold at its starting value (128 KiB) for this
    process. Left dynamic, glibc raises the threshold to the size of each
    large block freed, so multi-MB weight blobs and leaves churned by many
    threads land in per-thread heaps that never shrink, and RSS climbs
    with the churn though nothing stays live; pinned, every block above
    the threshold is mapped on its own and returned to the system when
    freed. Returns whether the allocator took the setting (False off
    glibc)."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        return bool(libc.mallopt(_M_MMAP_THRESHOLD, _MMAP_THRESHOLD_BYTES))
    except (OSError, AttributeError):
        return False


def device_memory_bytes() -> int:
    """Bytes of live tensors on the visible CUDA devices
    (``torch.cuda.memory_allocated``, summed); 0 where CUDA is absent."""
    import torch

    if not torch.cuda.is_available():
        return 0
    return sum(int(torch.cuda.memory_allocated(i)) for i in range(torch.cuda.device_count()))


class LeakSentry:
    """Watermark tracker + steady-state assertion over host and device
    memory. ``registry=None`` exports against the process default."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        rss_slack_bytes: int = 192 * 1024 * 1024,
        device_slack_bytes: int = 64 * 1024 * 1024,
        sample_on_collect: bool = False,
    ):
        self._lock = make_lock("obs.sentries.leak")
        self.rss_slack_bytes = int(rss_slack_bytes)
        self.device_slack_bytes = int(device_slack_bytes)
        self._last = {"rss": 0, "device": 0}
        self._high = {"rss": 0, "device": 0}
        self._mark: dict[str, int] | None = None
        # sample_on_collect: every scrape refreshes the reading (throttled
        # to one sample per window, so four gauges share one measurement),
        # which keeps the exported watermarks live for sessions with no
        # sampling hook of their own; harnesses that sample explicitly
        # leave it off for a deterministic cadence.
        self._sample_on_collect = bool(sample_on_collect)
        self._last_sample_t = 0.0
        reg = registry if registry is not None else REGISTRY
        reg.gauge(
            "process_resident_bytes",
            "host RSS at the last sentry sample",
        ).set_function(lambda: self._collect()["rss"])
        reg.gauge(
            "process_resident_watermark_bytes",
            "high-watermark host RSS over the sentry's lifetime",
        ).set_function(lambda: self._high["rss"])
        reg.gauge(
            "device_memory_in_use_bytes",
            "sum of torch.cuda.memory_allocated over the visible devices at "
            "the last sentry sample (0 without CUDA)",
        ).set_function(lambda: self._collect()["device"])
        reg.gauge(
            "device_memory_watermark_bytes",
            "high-watermark device memory over the sentry's lifetime",
        ).set_function(lambda: self._high["device"])
        self.sample()

    def sample(self) -> dict[str, int]:
        """Take one measurement; updates the watermarks. Returns the
        current ``{"rss": ..., "device": ...}`` reading."""
        reading = {"rss": rss_bytes(), "device": device_memory_bytes()}
        with self._lock:
            self._last = dict(reading)
            self._last_sample_t = time.monotonic()
            for k, v in reading.items():
                if v > self._high[k]:
                    self._high[k] = v
        return reading

    def _collect(self) -> dict[str, int]:
        """Gauge-callback read: the cached reading, refreshed first when
        ``sample_on_collect`` and the throttle window (0.5 s) has passed."""
        if self._sample_on_collect:
            with self._lock:
                stale = time.monotonic() - self._last_sample_t > 0.5
            if stale:
                self.sample()
        with self._lock:
            return dict(self._last)

    def mark(self) -> dict[str, int]:
        """Steady state begins now: growth past (mark + slack) is a leak."""
        reading = self.sample()
        with self._lock:
            self._mark = dict(reading)
        return reading

    def watermarks(self) -> dict[str, int]:
        with self._lock:
            return dict(self._high)

    def deltas(self) -> dict[str, int]:
        """Growth of the CURRENT reading over the mark (not the watermark:
        a transient spike that drained back is allowed; still-resident
        growth is what leaks look like)."""
        current = self.sample()
        with self._lock:
            if self._mark is None:
                raise RuntimeError("deltas() before mark()")
            return {k: current[k] - self._mark[k] for k in current}

    def steady(self) -> bool:
        d = self.deltas()
        return (
            d["rss"] <= self.rss_slack_bytes
            and d["device"] <= self.device_slack_bytes
        )

    def assert_steady(self) -> None:
        d = self.deltas()
        problems = []
        if d["rss"] > self.rss_slack_bytes:
            problems.append(
                f"RSS grew {d['rss']} B past the mark "
                f"(slack {self.rss_slack_bytes} B)"
            )
        if d["device"] > self.device_slack_bytes:
            problems.append(
                f"device memory grew {d['device']} B past the mark "
                f"(slack {self.device_slack_bytes} B)"
            )
        if problems:
            raise LeakError(
                "memory not steady since mark(): " + "; ".join(problems)
                + " — a long-lived session must plateau, not climb"
            )

    def summary(self) -> dict[str, Any]:
        """A JSON-safe audit block."""
        with self._lock:
            out: dict[str, Any] = {
                "last": dict(self._last),
                "watermark": dict(self._high),
                "mark": dict(self._mark) if self._mark else None,
            }
        if self._mark is not None:
            out["deltas"] = self.deltas()
            out["steady"] = (
                out["deltas"]["rss"] <= self.rss_slack_bytes
                and out["deltas"]["device"] <= self.device_slack_bytes
            )
        return out
