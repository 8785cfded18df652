"""The JSONL metrics sink, timing and profiling helpers, and streaming
percentiles (the counterpart of ``fedcrack_tpu.obs.metrics``).

One record per line, one file per process; each record carries a
monotonic ``t`` (seconds since the logger was made) and a wall-clock
``ts``. The sink is thread-safe: the gRPC service, its tick loop and
background tasks log concurrently.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import numbers
import os
import random
import threading
import time
from typing import Any, Iterator


class MetricsLogger:
    """Append-only JSONL metrics writer, optionally teed into a TensorBoard
    event file.

    ``kind`` names the record type (``round``, ``local_fit``, ``session``,
    ...); the other fields are free-form and made JSON-safe (numpy and
    torch scalars through ``int``/``float``).
    With ``tb_dir``, every numeric field of a record that carries an int
    ``round`` or ``epoch`` becomes the scalar ``kind/field`` at that step.
    """

    def __init__(
        self,
        path: str | os.PathLike | io.TextIOBase,
        echo=None,
        tb_dir: str | os.PathLike | None = None,
    ):
        if isinstance(path, io.TextIOBase):
            self._f = path
            self._owns = False
        else:
            p = os.fspath(path)
            os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
            self._f = open(p, "a", encoding="utf-8")
            self._owns = True
        self._echo = echo
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._tb = None
        if tb_dir:
            from fedcrack_tpu_torch.obs.tb import SummaryWriter

            self._tb = SummaryWriter(tb_dir)

    def log(self, kind: str, **fields: Any) -> dict:
        # fedlint: disable=DET001 -- human-readable record timestamp
        record = {"kind": kind, "t": round(time.monotonic() - self._t0, 6), "ts": time.time()}
        for k, v in fields.items():
            record[k] = _coerce(v)
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
        if self._tb is not None:
            step = record.get("round", record.get("epoch"))
            if isinstance(step, int) and not isinstance(step, bool):
                for k, v in record.items():
                    if k in ("kind", "t", "ts", "round", "epoch"):
                        continue
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        self._tb.add_scalar(f"{kind}/{k}", float(v), step)
        if self._echo is not None:
            self._echo(line)
        return record

    @property
    def tb_enabled(self) -> bool:
        """Whether a TensorBoard tee is attached (callers skip building
        histogram inputs when nothing reads them)."""
        return self._tb is not None

    def log_histograms(self, step: int, tree: Any, prefix: str = "weights") -> None:
        """One TensorBoard histogram per leaf of a nested-dict tree (numpy
        or CPU tensor leaves), tagged ``prefix/<key>/.../<key>``, leaves in
        sorted key order: the tags and order of the JAX package's pytree
        walk over the same flax-layout tree. A no-op without ``tb_dir``."""
        if self._tb is None:
            return
        for path, leaf in _flat_items(tree):
            self._tb.add_histogram(f"{prefix}/{'/'.join(path)}", leaf, step)

    def close(self) -> None:
        if self._owns:
            with self._lock:
                self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _flat_items(tree: Any, path: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_items(tree[k], path + (str(k),))
    else:
        yield path, tree


def _coerce(value: Any) -> Any:
    """A JSON-safe value, as the JAX package makes it: Python scalars pass
    through, containers recurse, other integers become ``int``, other
    numbers (numpy and torch scalars) ``float``, their non-finite values
    the string (RFC 8259 has no NaN), anything else its ``repr``."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _coerce(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_coerce(v) for v in value]
    if isinstance(value, numbers.Integral):
        return int(value)
    try:
        as_float = float(value)
    except (TypeError, ValueError):
        return repr(value)
    return as_float if math.isfinite(as_float) else str(as_float)


def read_metrics(path: str | os.PathLike, kind: str | None = None) -> list[dict]:
    """Load a JSONL metrics file, optionally filtered by record kind."""
    records = []
    with open(os.fspath(path), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                records.append(rec)
    return records


@contextlib.contextmanager
def stopwatch() -> Iterator[dict]:
    """``with stopwatch() as w: ...; w['seconds']``: the span's wall clock."""
    out = {"seconds": 0.0}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0


_TRACE_COUNTER = itertools.count()


@contextlib.contextmanager
def profiler_trace(logdir: str | None) -> Iterator[None]:
    """Wrap a span in ``torch.profiler`` (CPU, and CUDA where a card is
    present) and write its trace into ``logdir`` in TensorBoard's profiler
    layout (``<worker>.<n>.pt.trace.json``); ``None`` or ``""`` traces
    nothing at no cost."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    worker = f"{os.getpid()}_{next(_TRACE_COUNTER)}"
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir, worker_name=worker)):
        yield


# The throwaway kernels that open every card_profile window: a spin of
# LEAD_CYCLES clocks each.
PROFILE_LEAD, LEAD_CYCLES, LEAD_KERNEL = 128, 20_000, "spin_kernel"


@contextlib.contextmanager
def card_profile(cpu: bool = True) -> Iterator[Any]:
    """torch.profiler over the body on the current CUDA device, after
    ``PROFILE_LEAD`` throwaway spin kernels and a synchronize; yields the
    profiler. On the H100 the profiler drops the first kernel records of a
    window, more of them the older the process, and now and then a whole
    window's: the lead takes the first kind of loss (:func:`lead_kept`
    shows how much of it there was), :func:`card_kernels` leaves it out,
    and a caller that needs every record checks its count and retakes the
    window. ``cpu`` also records host activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def card_kernels(prof) -> list:
    """The CUDA kernels of a :func:`card_profile` window by name
    (``key_averages`` rows), without its lead and without the device-side
    ranges of user annotations: ``Optimizer.step#Adam.step`` comes back as
    a CUDA row spanning the optimizer's kernels, which would count their
    time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation and LEAD_KERNEL not in e.key]


def lead_kept() -> str:
    """How many of an empty window's lead kernels the profiler kept."""
    from torch.autograd import DeviceType

    with card_profile() as prof:
        pass
    kept = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and LEAD_KERNEL in e.key)
    return f"{kept} of {PROFILE_LEAD} lead kernels kept"


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

    def merge(self, other: "StreamingPercentiles") -> "StreamingPercentiles":
        """Fold ``other``'s reservoir into this one, as the JAX package does:
        count, sum, min and max merge exactly; while the combined sample
        fits ``capacity`` the reservoir is the concatenation (self's values,
        then other's), so the percentiles stay exact; past it, a weighted
        sample without replacement (Efraimidis-Spirakis keys ``u ** (1/w)``
        from self's rng, each value weighted by the stream items it stands
        for). ``other`` is read under its own lock first, then self is
        updated under its lock. Returns ``self``."""
        if other is self:
            raise ValueError("merge(self) would double-count the reservoir")
        with other._lock:
            o_values = list(other._values)
            o_count, o_sum = other._count, other._sum
            o_min, o_max = other._min, other._max
        if o_count == 0:
            return self
        with self._lock:
            s_len = len(self._values)
            if self._count + o_count <= self._capacity:
                self._values.extend(o_values)
            else:
                weighted = []
                if s_len:
                    w_self = self._count / s_len
                    weighted += [(v, w_self) for v in self._values]
                w_other = o_count / len(o_values)
                weighted += [(v, w_other) for v in o_values]
                keyed = [(self._rng.random() ** (1.0 / w), v) for v, w in weighted]
                keyed.sort(key=lambda kv: (-kv[0], kv[1]))
                self._values = [v for _, v in keyed[: self._capacity]]
            self._count += o_count
            self._sum += o_sum
            if o_min is not None:
                self._min = o_min if self._min is None else min(self._min, o_min)
            if o_max is not None:
                self._max = o_max if self._max is None else max(self._max, o_max)
        return self

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
