"""A profiled sub-window on the card, reduced to what the metrics read.

The window is opened the way ``fedcrack_tpu_torch/obs/metrics.py::
card_profile`` opens it (frozen here): ``torch.profiler``, a lead of
throwaway spin kernels and a synchronize before the traffic, because on
the H100 the profiler drops the first kernel records of a window. Every
device record (kernels, copies, sets) inside the window counts. The
profiler can still lose records, so a caller checks a kernel count it
knows (the forwards' launches, the steps' ``bce_sums``) and retakes the
window when it is short.

``CATEGORIES`` and :func:`kernel_category` are a frozen copy of
``fedcrack_tpu_torch/tools/profile_step.py``'s.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

PROFILE_LEAD, LEAD_CYCLES, MARK_CYCLES = 128, 20_000, 1_000
SPIN = "spin_kernel"

CATEGORIES = (
    ("port_kernels", ("bce_sums_kernel", "dequant_")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("pooling", ("pool",)),
    ("copy_memset", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "im2col")),
    ("reduction", ("reduce",)),
    ("gemm", ("gemm", "gemv", "cutlass", "nvjet")),
    ("elementwise", ("elementwise",)),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for category, needles in CATEGORIES:
        if any(n in low for n in needles):
            return category
    return "other"


@dataclasses.dataclass
class Trace:
    """The device's records in one window: seconds and count by name, the
    union of their intervals, and the longest idle gaps named by the host
    op that ran beside them."""

    window_s: float
    busy_s: float
    by_name: dict            # name -> [seconds, count]
    gaps: list               # [(host op, seconds)], longest first, at most 10

    def seconds_matching(self, needle: str) -> float:
        return sum(v[0] for k, v in self.by_name.items() if needle in k)

    def count_matching(self, needle: str) -> int:
        return sum(v[1] for k, v in self.by_name.items() if needle in k)

    def seconds_in(self, *categories: str) -> float:
        return sum(v[0] for k, v in self.by_name.items() if kernel_category(k) in categories)

    def top_ops(self, n: int = 10) -> list:
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k[:160], v[0]] for k, v in ranked]


@contextlib.contextmanager
def profiled(host_ops: bool = False):
    """Profile the body on the current CUDA device; yields a holder whose
    ``trace`` is set to the reduced :class:`Trace` on exit, or to None
    where the profiler lost the window's bracketing kernels.

    Two spin kernels bracket the body, after the lead and after the body's
    last synchronize; the window is the device time between them. Without
    ``host_ops`` only the card's activity is recorded, which costs the
    host little, so the window's idle share is near an untraced one's;
    with it the host's torch ops are recorded too (slower) and each idle
    gap is named by the op that ran beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        yield holder
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    holder.trace = reduce(prof.events())


def reduce(events) -> Trace | None:
    from torch.autograd import DeviceType

    device_events = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    spins = sorted((e for e in device_events if SPIN in e.name), key=lambda e: e.time_range.start)
    if len(spins) < 2:
        return None
    w0, w1 = spins[-2].time_range.end, spins[-1].time_range.start
    device, host = [], []
    by_name: dict = {}
    for e in device_events:
        a, b = e.time_range.start, e.time_range.end
        if a < w0 or b > w1:
            continue
        device.append((a, b))
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += (b - a) * 1e-6
        slot[1] += 1
    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is None and not e.is_user_annotation:
            a, b = e.time_range.start, e.time_range.end
            if b > w0 and a < w1:
                host.append((a, b, e.name))
    device.sort()
    busy = 0.0
    gaps = []
    cursor = w0
    for a, b in device:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        best, best_overlap = "no torch op on the host", 0.0
        for ha, hb, name in host[:bisect.bisect_left(starts, b)]:
            overlap = min(b, hb) - max(a, ha)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        named.append((best, (b - a) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, by_name=by_name, gaps=named)


def host_named_gaps(body, attempts: int = 3) -> list:
    """The longest idle gaps of a window of ``body`` profiled with the
    host's ops, each named by the op beside it; none where the profiler
    lost every retake's window."""
    for _ in range(attempts):
        with profiled(host_ops=True) as holder:
            body()
        if holder.trace is not None:
            return holder.trace.gaps
    return []
