"""Trace spans: correlated JSONL timelines across planes and processes.

The counterpart of ``fedcrack_tpu.obs.spans``. A span is one named
interval with a trace id and an optional parent span id. Instrumentation
calls the module-level :func:`span` unconditionally: it costs one global
read until a recorder is installed (:func:`install`). Durations come from
the monotonic clock; the wall clock is the display-only ``ts`` field.

Record shape (one JSON object per line)::

    {"name": "fed.flush", "trace": "fedtr-v0", "span": 17, "parent": null,
     "t": 3.104, "dur_s": 0.0021, "start_ns": 88312..., "end_ns": 88312...,
     "ts": 1789..., "version": 1}

``start_ns`` and ``end_ns`` are the span's bounds on ``time.monotonic_ns()``,
absolute, so that spans line up with another trace taken in the process
(a profiler's, once an offset between the two clocks is measured). A span
opened without ``parent`` inside another span of the same thread takes
the innermost one as its parent; an explicit ``parent`` wins. A recorder
installed without a path keeps its records in memory (``records``), read
after :func:`uninstall`.

Across processes a span is referenced by a wire-safe
:class:`TraceContext`, ``"<trace>#<key>"``: the sender records it as its
span's ``ctx``, the receiver as ``links`` (a flush links every upload it
averaged). Trace ids follow the model-version lineage
(:func:`version_trace`), which every party learns in band.
``TraceContext.from_wire`` returns ``None`` on anything malformed: a lost
context degrades to a parentless span, never an error. (The JAX
module's size-based file rotation is not ported.)
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight as _flight

# Longest wire context accepted back off the wire: contexts are
# observability, never load-bearing, so an absurd one is dropped rather
# than stored.
_MAX_WIRE_CTX = 256


def version_trace(base_version: int) -> str:
    """The lineage trace id for work rooted at global model version
    ``base_version``: a client training on the version-``B`` broadcast, the
    flush publishing ``B+1``, the swap installing it and the first batch
    served from it all join ``fedtr-vB`` — one trace id across processes,
    derived from a number every party already carries in-band."""
    return f"fedtr-v{int(base_version)}"


@dataclass(frozen=True)
class TraceContext:
    """A wire-safe span reference: the trace id plus a sender-chosen key
    unique within that trace (NOT the recorder's integer span id, which is
    a per-process sequence and ambiguous across files)."""

    trace: str
    key: str

    def to_wire(self) -> str:
        return f"{self.trace}#{self.key}"

    @classmethod
    def from_wire(cls, wire: Any) -> "TraceContext | None":
        """Parse a wire context; ``None`` for anything malformed (missing,
        wrong type, no separator, empty halves, oversized) — the dropped-
        context contract: degrade to parentless, never raise."""
        if not isinstance(wire, str) or not wire or len(wire) > _MAX_WIRE_CTX:
            return None
        trace, sep, key = wire.partition("#")
        if not sep or not trace or not key:
            return None
        return cls(trace=trace, key=key)


def flush_context(version: int) -> TraceContext:
    """The DETERMINISTIC context of the flush that published global model
    ``version``: computable by anyone who knows the version (the serve
    plane links swap→flush from the statefile's version counter alone —
    nothing extra rides the statefile, so its snapshot bytes stay a pure
    function of protocol state)."""
    return TraceContext(version_trace(version - 1), f"flush:v{int(version)}")


class SpanHandle:
    """What a ``with span(...)`` body sees: the ids to thread to children."""

    __slots__ = ("span_id", "trace", "attrs")

    def __init__(self, span_id: int, trace: str | None):
        self.span_id = span_id
        self.trace = trace
        self.attrs: dict[str, Any] = {}

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (e.g. the model version a
        batch was answered from)."""
        self.attrs.update(attrs)


class SpanRecorder:
    """Span sink: append-only JSONL (a path or an open text file), or with
    no path a list of records in memory (``records``); thread-safe."""

    def __init__(self, path: str | os.PathLike | io.TextIOBase | None = None):
        self.records: list[dict] | None = None
        self._f = None
        self._owns = False
        if path is None:
            self.records = []
        elif isinstance(path, io.TextIOBase):
            self._f = path
        else:
            p = os.fspath(path)
            os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
            self._f = open(p, "a", encoding="utf-8")
            self._owns = True
        self._lock = make_lock("obs.spans.sink")
        self._t0_ns = time.monotonic_ns()
        self._seq = 0
        # Each thread's open spans, innermost last: the default parent.
        self._open = threading.local()

    def _next_id(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _stack(self) -> list[int]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        trace: str | None = None,
        parent: int | None = None,
        **attrs: Any,
    ) -> Iterator[SpanHandle]:
        handle = SpanHandle(self._next_id(), trace)
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        stack.append(handle.span_id)
        start_ns = time.monotonic_ns()
        try:
            yield handle
        finally:
            end_ns = time.monotonic_ns()
            if stack[-1] == handle.span_id:
                stack.pop()
            else:
                stack.remove(handle.span_id)
            record: dict[str, Any] = {
                "name": name,
                "trace": trace,
                "span": handle.span_id,
                "parent": parent,
                "t": round((start_ns - self._t0_ns) * 1e-9, 6),
                "dur_s": round((end_ns - start_ns) * 1e-9, 6),
                "start_ns": start_ns,
                "end_ns": end_ns,
                # Interval math above is monotonic; the wall clock is the
                # display-only "ts" field (obs JSONL convention).
                # fedlint: disable=DET001 -- human-readable record timestamp
                "ts": time.time(),
            }
            for k, v in attrs.items():
                record[k] = v
            for k, v in handle.attrs.items():
                record[k] = v
            if self.records is not None:
                with self._lock:
                    self.records.append(record)
            else:
                line = json.dumps(record, sort_keys=True, default=str)
                with self._lock:
                    self._f.write(line + "\n")
                    self._f.flush()
            # Flight-recorder tee: a compact event per span (name, trace,
            # duration, context); one global read when no ring is installed.
            _flight.note(
                "span",
                name=name,
                trace=trace,
                dur_s=record["dur_s"],
                ctx=record.get("ctx"),
            )

    def close(self) -> None:
        if self._owns:
            with self._lock:
                self._f.close()

    def __enter__(self) -> "SpanRecorder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---- the module-level recorder (sanitizer idiom: zero-cost when off) ----

_recorder: SpanRecorder | None = None
_recorder_lock = make_lock("obs.spans.install")


def install(path: str | os.PathLike | io.TextIOBase | None = None) -> SpanRecorder:
    """Install the process span recorder; returns it. Without ``path`` it
    keeps its records in memory (read them from the returned recorder's
    ``records`` after :func:`uninstall`). Replacing an existing recorder
    closes the old one."""
    global _recorder
    rec = SpanRecorder(path)
    with _recorder_lock:
        old, _recorder = _recorder, rec
    if old is not None:
        old.close()
    return rec


def uninstall() -> None:
    global _recorder
    with _recorder_lock:
        old, _recorder = _recorder, None
    if old is not None:
        old.close()


def current() -> SpanRecorder | None:
    return _recorder


@contextlib.contextmanager
def span(
    name: str,
    *,
    trace: str | None = None,
    parent: int | None = None,
    **attrs: Any,
) -> Iterator[SpanHandle | None]:
    """Record ``name`` against the installed recorder; a no-op (yielding
    ``None``) when none is installed — instrumentation sites never branch.

    When only the flight ring is installed (tracing off), the span still
    feeds the ring a compact timed event — "every plane feeds the flight
    recorder for free" — at the cost of two global reads and one deque
    append."""
    rec = _recorder
    if rec is not None:
        with rec.span(name, trace=trace, parent=parent, **attrs) as handle:
            yield handle
        return
    if _flight.current() is None:
        yield None
        return
    t_start = time.monotonic()
    handle = SpanHandle(0, trace)
    try:
        yield handle
    finally:
        _flight.note(
            "span",
            name=name,
            trace=trace,
            dur_s=round(time.monotonic() - t_start, 6),
            ctx=attrs.get("ctx") or handle.attrs.get("ctx"),
        )


def read_spans(path: str | os.PathLike, name: str | None = None) -> list[dict]:
    """Load a span JSONL, optionally filtered by span name."""
    out = []
    with open(os.fspath(path), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if name is None or rec.get("name") == name:
                out.append(rec)
    return out


def span_files(path: str | os.PathLike) -> list[str]:
    """The rotated set behind ``path``, oldest first (``path.N`` ...
    ``path``): what a stitcher reads so a chain is never cut by a rotation.
    The port writes no rotations; the JAX package's recorder does."""
    p = os.fspath(path)
    rotated: list[str] = []
    i = 1
    while os.path.exists(f"{p}.{i}"):
        rotated.append(f"{p}.{i}")
        i += 1
    return list(reversed(rotated)) + ([p] if os.path.exists(p) else [])
