"""The port's own spans in the round cell: the host's split of a steady
round, and each stretch of the card's idle time put down to the span the
host was in.

The readers of the round layer's ``program_span`` metrics call
:func:`read` in a traced run, after the harness has profiled its
sub-window and checked the cell. The harness frees the cell's round before
its readers run, so the first call sets the cell up again, once a run,
with the rounds driver's own ``setup`` on the cell's configuration,
traffic and seed, and drives two windows from there, each one call of
``run_mesh_federation`` as the timed window drives its rounds:

- **(a) spans only**: ``A_ROUNDS`` steady rounds under the port's
  in-memory span recorder (``obs.spans.install()`` with no path) and no
  profiler, so the host's split is read without CUPTI's cost per launch;
- **(b) spans under a device-only profiler**: ``B_ROUNDS`` steady rounds,
  the window opened as ``trace.profiled`` opens it (the lead of spin
  kernels, then spin kernels bracketing the rounds, below), kept only
  where the profiler holds a ``bce_sums_kernel`` record for every step's
  ``train.forward`` span (each step launches one), and retaken otherwise.

Steady rounds. Every round of the timed window stages the next round's
data under its own steps, inside its ``driver.round`` span; a window's
last round stages nothing, and its first round's data is staged before
its ``driver.round`` opens. So each window drives one round more than it
reads, and reads only the rounds whose ``driver.round`` holds a
``driver.stage``, with the spans nested in them; window (b)'s interval
runs from the first such round's start to the last one's end. Window (a)'s
figures are medians over its steady rounds, each with its spread over
them (quartiles over the median).

Clock. The spans carry ``time.monotonic_ns()`` bounds; the profiler's
records are on its own clock. Each bracket is ``MARKS`` spin kernels:
after a synchronize the host reads the monotonic clock just before it
launches each, and on an empty queue that kernel starts a launch latency
later. The first launch after an idle spell starts up to ~70 us late, so
a bracket's offset between the two clocks is the least of its marks', and
its marks must agree within ``MAX_SKEW_NS``. On the H100 the trace's
clock runs at a rate of its own against the host's through a busy
window, steady within a window and different in each (0.2 to 14 ms over
a round's ~1.2 s), so the two brackets' offsets pin a linear map from the
host's clock onto the trace's; a window drifting by more than
``MAX_DRIFT`` of its length is retaken. The check on the card: no
``bce_sums_kernel`` record (the n-th) may start before the
``train.forward`` span (the n-th) of the step that launched it.

Attribution. Every idle stretch of window (b)'s interval (less the union
of the card's records) goes to the innermost span open on the host then,
by a sweep over the sorted intervals; idle under no span (between rounds),
or under ``driver.round``'s own time, is what the spans cannot name. The
shares of all names sum to the interval's idle share.

A program whose span recorder has no in-memory sink gives nothing, and
the readers return None.
"""

from __future__ import annotations

import argparse
import gc
import heapq
import inspect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Steady rounds read in windows (a) and (b).
A_ROUNDS = 8
B_ROUNDS = 2
# The largest disagreement between the clock offsets of one bracket's
# marks, and the largest drift between the brackets, as a share of the
# window (the rounds' windows drifted by up to 2.5%).
MAX_SKEW_NS = 100_000
MAX_DRIFT = 0.05
# Spin kernels a bracket, and long ones after the closing bracket, with a
# pause before the profiler stops: on the H100 a window now and then loses
# its last records (once the closing bracket and 32 kernels after it), as
# it loses its first.
MARKS = 4
TAIL = 256
TAIL_PAUSE_S = 0.02
# Retakes of window (b): on the H100 a window now and then loses a mark,
# or its trace clock steps by milliseconds against the host's.
ATTEMPTS = 8
TRAIN = "train."
STEP_SPANS = ("train.forward", "train.backward", "train.optimizer")
# Idle under these labels is idle the spans cannot name.
UNNAMED = (None, "driver.round")


def supported() -> bool:
    """Whether the port's span recorder keeps records in memory."""
    from fedcrack_tpu_torch.obs import spans

    param = inspect.signature(spans.install).parameters.get("path")
    return param is not None and param.default is None


def _seed(argv=None) -> int:
    """The run's ``--seed``: the harness reads it from the command line
    and hands the readers no copy."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


# ---- host spans ----


def steady_rounds(records: list[dict]) -> list[tuple[dict, list[dict]]]:
    """``[(round, spans nested in it)]`` for each ``driver.round`` that
    holds a ``driver.stage`` (the next round's staging), in order; nesting
    follows the records' ``parent`` ids."""
    children: dict = {}
    for r in records:
        children.setdefault(r.get("parent"), []).append(r)
    out = []
    for rnd in sorted((r for r in records if r["name"] == "driver.round"), key=lambda r: r["start_ns"]):
        inner, todo = [], [rnd]
        while todo:
            kids = children.get(todo.pop()["span"], [])
            inner.extend(kids)
            todo.extend(kids)
        if any(r["name"] == "driver.stage" for r in inner):
            out.append((rnd, inner))
    return out


def _ms(records: list[dict], *names: str) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] in names) * 1e-6


def round_figures(rnd: dict, inner: list[dict]) -> dict:
    """One steady round's figures, in ms: its wall, its steps' dispatch a
    step, its slots' inits and folds, its staging and the pinning in it,
    and its barrier."""
    steps = sum(r["name"] == "train.forward" for r in inner)
    return {
        "round_wall_ms": (rnd["end_ns"] - rnd["start_ns"]) * 1e-6,
        "step_dispatch_ms": _ms(inner, *STEP_SPANS) / steps if steps else None,
        "slot_ms": _ms(inner, "mesh.slot_init", "mesh.fold"),
        "staging_ms": _ms(inner, "driver.stage"),
        "pin_ms": _ms(inner, "data.pin"),
        "barrier_wait_ms": _ms(inner, "driver.barrier"),
    }


def spread(values: list[float]) -> float | None:
    """The distance between the first and third quartiles over the
    median (``statistics.quantiles``)."""
    if len(values) < 2 or statistics.median(values) == 0:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def host_split(records: list[dict]) -> dict:
    """What window (a) reads from its steady rounds: each figure of
    :func:`round_figures` as its median over them, the figures of each
    round and their spreads, and each span name's count, total and own
    milliseconds a round."""
    steady = steady_rounds(records)
    if not steady:
        raise RuntimeError("window (a) holds no round that stages the next one")
    per_round = [round_figures(rnd, inner) for rnd, inner in steady]
    by_name: dict = {}
    for rnd, inner in steady:
        spans = [rnd] + inner
        for name, a, b in label_segments([(r["start_ns"], r["end_ns"], r["name"]) for r in spans],
                                         rnd["start_ns"], rnd["end_ns"]):
            by_name.setdefault(name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})["self_ms"] += (b - a) * 1e-6
        for r in spans:
            slot = by_name.setdefault(r["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            slot["count"] += 1
            slot["total_ms"] += (r["end_ns"] - r["start_ns"]) * 1e-6
    n = len(steady)
    out = {
        "rounds": n,
        "steps_per_round": sum(r["name"] == "train.forward" for r in steady[0][1]),
        "by_name": {k: {f: v / n for f, v in s.items()} for k, s in by_name.items() if k is not None},
        "per_round": {k: [f[k] for f in per_round] for k in per_round[0]},
    }
    out["spread"] = {k: spread(v) for k, v in out["per_round"].items() if None not in v}
    for k, v in out["per_round"].items():
        out[k] = None if None in v else statistics.median(v)
    return out


def label_segments(spans: list[tuple], lo: float, hi: float) -> list[tuple]:
    """``[(label, a, b)]`` covering ``[lo, hi]`` in order: the name of the
    innermost span open over ``[a, b)`` (of those open, the latest
    started; of two started together, the shorter), None where none is.
    ``spans`` are ``(start, end, name)``."""
    inside = sorted((s for s in spans if s[1] > lo and s[0] < hi), key=lambda s: (s[0], -s[1]))
    bounds = sorted({lo, hi} | {t for s in inside for t in s[:2] if lo < t < hi})
    heap: list = []
    out: list = []
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(inside) and inside[i][0] <= a:
            heapq.heappush(heap, (-inside[i][0], inside[i][1], i))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        label = inside[heap[0][2]][2] if heap else None
        if out and out[-1][0] == label and out[-1][2] == a:
            out[-1] = (label, out[-1][1], b)
        else:
            out.append((label, a, b))
    return out


def idle_gaps(busy: list[tuple], lo: float, hi: float) -> list[tuple]:
    """The stretches of ``[lo, hi]`` that no ``(start, end)`` of ``busy``
    covers, in order."""
    gaps = []
    cursor = lo
    for a, b in sorted(busy):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def attribute_idle(gaps: list[tuple], segments: list[tuple]) -> dict:
    """Idle time by label: each gap split at the segments' bounds."""
    out: dict = {}
    j = 0
    for ga, gb in gaps:
        while j < len(segments) and segments[j][2] <= ga:
            j += 1
        k = j
        while k < len(segments) and segments[k][1] < gb:
            label, a, b = segments[k]
            overlap = min(b, gb) - max(a, ga)
            if overlap > 0:
                out[label] = out.get(label, 0.0) + overlap
            k += 1
    return out


# ---- window (b): the device trace ----


def clock_offset(marks: list[tuple], reads: list[int]) -> tuple[float, int, float]:
    """One bracket's trace clock less the host's monotonic clock, in ns:
    the least, over its marks, of the mark kernel's start against the
    host's read just before its launch. Returns it, that read, and the
    spread of the marks' offsets."""
    offsets = [(start * 1e3 - ns, ns) for (start, _), ns in zip(marks, reads)]
    least = min(offsets)
    return least[0], least[1], max(o for o, _ in offsets) - least[0]


def host_to_trace(open_fix: tuple, close_fix: tuple):
    """The linear map from the host's monotonic ns onto the trace's us
    through the two brackets' ``(offset_ns, host_ns)``."""
    (off_a, h_a), (off_b, h_b) = open_fix, close_fix
    rate = (off_b - off_a) / (h_b - h_a)

    def us(ns):
        return (ns + off_a + rate * (ns - h_a)) * 1e-3

    return us


def device_split(device: list[tuple], marks: tuple, records: list[dict], host_marks: tuple) -> dict:
    """What window (b) reads. ``device``: the card's records ``(name,
    start_us, end_us)`` on the trace's clock, the bracketing spin kernels
    included; ``marks``: the two brackets, each a list of its spin
    kernels' ``(start_us, end_us)``; ``records``: the spans;
    ``host_marks``: the host's reads before each bracket launch, the same
    shape. The interval read runs from the first steady round's start to
    the last one's end. Returns the shares of the interval, the offsets
    and the clock check's count, or ``{"retake": reason}``."""
    opening, closing = marks
    off_open, h_open, skew_open = clock_offset(opening, host_marks[0])
    off_close, h_close, skew_close = clock_offset(closing, host_marks[1])
    if max(skew_open, skew_close) > MAX_SKEW_NS:
        return {"retake": f"a bracket's marks disagree by {max(skew_open, skew_close):.0f} ns"}
    drift = off_close - off_open
    if abs(drift) > MAX_DRIFT * (h_close - h_open):
        return {"retake": f"the trace's clock drifted {drift:.0f} ns against the host's over "
                          f"{(h_close - h_open) * 1e-6:.1f} ms"}
    steady = steady_rounds(records)
    if not steady:
        return {"retake": "no round that stages the next one"}
    us = host_to_trace((off_open, h_open), (off_close, h_close))
    lo, hi = us(steady[0][0]["start_ns"]), us(steady[-1][0]["end_ns"])
    spans = [(us(r["start_ns"]), us(r["end_ns"]), r["name"]) for r in records]
    busy = [(a, b) for _, a, b in device if b > lo and a < hi]
    kernels = sorted(a for name, a, _ in device if "bce_sums_kernel" in name and lo <= a <= hi)
    forwards = sorted(us(r["start_ns"]) for _, inner in steady for r in inner if r["name"] == "train.forward")
    if len(kernels) != len(forwards):
        return {"retake": f"{len(kernels)} bce_sums_kernel records against {len(forwards)} train.forward spans"}
    violations = sum(k < f for k, f in zip(kernels, forwards))
    if violations:
        return {"retake": f"{violations} bce_sums_kernel records start before their step's train.forward"}
    window = hi - lo
    idle = attribute_idle(idle_gaps(busy, lo, hi), label_segments(spans, lo, hi))
    share = {k: 100.0 * v / window for k, v in idle.items()}
    return {
        "rounds": len(steady),
        "window_ms": window * 1e-3,
        "idle_share": sum(share.values()),
        "idle_by_span": {("(none)" if k is None else k): v for k, v in sorted(share.items(), key=lambda kv: -kv[1])},
        "idle_dispatch_share": sum(v for k, v in share.items() if k is not None and k.startswith(TRAIN)),
        "idle_unspanned_share": sum(share.get(k, 0.0) for k in UNNAMED),
        "offsets_ns": [off_open, off_close],
        "drift_ns": drift,
        "clock_violations": violations,
        "kernels_checked": len(kernels),
    }


def _profiled_rounds(body):
    """``body()`` under a device-only profiler opened as ``trace.profiled``
    opens it, bracketed by ``MARKS`` spin kernels on each side, the host's
    monotonic clock read just before each launch on an empty queue.
    Returns the card's records ``(name, start_us, end_us)`` and the host's
    reads, a list a bracket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import LEAD_CYCLES, MARK_CYCLES, PROFILE_LEAD

    def bracket() -> list[int]:
        reads = []
        for _ in range(MARKS):
            torch.cuda.synchronize()
            reads.append(time.monotonic_ns())
            torch.cuda._sleep(MARK_CYCLES)
        return reads

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(LEAD_CYCLES)
        opening = bracket()
        body()
        closing = bracket()
        for _ in range(TAIL):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TAIL_PAUSE_S)
    # The raw records, not prof.events(): building those takes seconds.
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    device = [(e.name(), (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3) for e in results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation() and not e.is_hidden_event()]
    return device, (opening, closing)


def brackets(device: list[tuple]) -> tuple | None:
    """The opening and closing brackets' spin kernels ``(start_us,
    end_us)`` among the card's records, or None where one was lost: the
    spin kernels less than half as long as the longest (a lead's or a
    tail's, ``LEAD_CYCLES`` against ``MARK_CYCLES``)."""
    from benchmark.trace import SPIN

    spins = sorted((a, b) for name, a, b in device if SPIN in name)
    longest = max((b - a for a, b in spins), default=0.0)
    marks = [(a, b) for a, b in spins if 2 * (b - a) < longest]
    if len(marks) != 2 * MARKS:
        return None
    return marks[:MARKS], marks[MARKS:]


# ---- the windows ----


def _rounds(state, n: int) -> list[float]:
    """``n`` more rounds of the set-up round in one call, driven as the
    timed window drives them; each round's wall
    (``RoundRecord.wall_clock_s``)."""
    from fedcrack_tpu_torch.parallel import driver

    start = state["next_round"]
    fed = state["fed"]
    variables, records = driver.run_mesh_federation(
        state["round_fn"], state["variables"], state["data_fn"], start + n, state["mesh"], overlap_staging=True,
        segment_overlap=fed.segment_overlap, data_placement=fed.data_placement, start_round=start)
    state["variables"], state["next_round"] = variables, start + n
    return [r.wall_clock_s for r in records]


def spans_window(state, n: int = A_ROUNDS) -> dict:
    """Window (a): ``n`` steady rounds (``n + 1`` driven) under the
    in-memory recorder."""
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    try:
        _rounds(state, n + 1)
    finally:
        spans.uninstall()
    return host_split(rec.records)


def device_window(state, n: int = B_ROUNDS, attempts: int = ATTEMPTS) -> dict | None:
    """Window (b): ``n`` steady rounds (``n + 1`` driven) under the
    recorder and the device-only profiler, retaken where the profiler lost
    records (a bracket's, or a ``bce_sums_kernel`` of one of the steps) or
    the clocks disagree."""
    from fedcrack_tpu_torch.obs import spans

    for _ in range(attempts):
        rec = spans.install()
        try:
            device, host_marks = _profiled_rounds(lambda: _rounds(state, n + 1))
        finally:
            spans.uninstall()
        marks = brackets(device)
        if marks is None:
            print("program spans: the profiler lost a bracket's spin kernels; retaking window (b)", file=sys.stderr)
            continue
        out = device_split(device, marks, rec.records, host_marks)
        if "retake" in out:
            print(f"program spans: {out['retake']}; retaking window (b)", file=sys.stderr)
            continue
        out["round_wall_ms"] = [1e-6 * (rnd["end_ns"] - rnd["start_ns"]) for rnd, _ in steady_rounds(rec.records)]
        return out
    return None


def measure(run) -> dict | None:
    """Both windows on the cell set up again; None where the program keeps
    no spans in memory or there is no card."""
    import torch

    if not supported() or not torch.cuda.is_available():
        return None
    from benchmark import harness
    from benchmark.drivers import rounds

    t0 = time.perf_counter()
    state = rounds.setup(harness.context(ROOT, run.cell, _seed(), torch.device("cuda", 0)))
    try:
        host = spans_window(state)
        dev = device_window(state)
    finally:
        rounds.release(state)
        state.clear()
        gc.collect()
        torch.cuda.empty_cache()
    out = {"host": host, "device": dev, "seconds": time.perf_counter() - t0}
    print("program spans: " + json.dumps(out, sort_keys=True), file=sys.stderr)
    return out


def read(run) -> dict | None:
    """:func:`measure` once a run (kept in ``run.observed``)."""
    if "program_spans" not in run.observed:
        run.observed["program_spans"] = measure(run)
    return run.observed["program_spans"]
