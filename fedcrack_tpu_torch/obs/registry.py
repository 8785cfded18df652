"""Thread-safe metrics registry: one catalog for every plane's counters.

The counterpart of ``fedcrack_tpu.obs.registry``, with Prometheus's data
model: **Counter** (monotone), **Gauge** (set/inc) and **Histogram**
(cumulative buckets plus ``_sum``/``_count``), each optionally a labeled
family (``REGISTRY.counter("fed_updates_total", labels=("result",))``).

- Thread-safe: family creation under the registry lock, value updates
  under a per-family lock, all leaf-level (``analysis.sanitizers.make_lock``).
- Deterministic exposition: families in sorted name order, children in
  sorted label order, buckets ascending; equal registries expose equal text.
- Names are ``snake_case`` with a unit suffix, checked at creation.
- Get-or-create: asking twice for a name returns the same family (kind
  and labels must match, else ``ValueError``).

``REGISTRY`` is the process-default instance.
"""

from __future__ import annotations

import math
import re
from typing import Any, Sequence

from fedcrack_tpu_torch.analysis.sanitizers import make_lock

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# The unit vocabulary of metric names: seconds, bytes, totals, ratios,
# model-version lag (`_versions`), fleet population (`_replicas`) and the
# Prometheus info-metric idiom (`_info`, a constant-1 gauge whose labels
# carry categorical state).
UNIT_SUFFIXES = (
    "_seconds", "_bytes", "_total", "_ratio", "_versions", "_replicas", "_info",
)

# Latency-shaped default buckets (Prometheus client defaults extended to
# 30 s — a federation flush on a loaded CPU host can take seconds).
DEFAULT_SECONDS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
# Staleness-shaped buckets: versions behind the global.
DEFAULT_VERSIONS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


def validate_metric_name(name: str) -> str:
    """A metric name is snake_case with a unit suffix."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} is not snake_case "
            "([a-z][a-z0-9_]*; no leading digit, no uppercase)"
        )
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(
            f"metric name {name!r} lacks a unit suffix {UNIT_SUFFIXES} "
            "(the catalog stays greppable and unit-unambiguous)"
        )
    return name


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Prometheus text-format number: integral floats print as integers,
    non-finite values in Go spelling (``+Inf``/``-Inf``/``NaN``)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


class _Child:
    """One (label-values) time series inside a family."""

    __slots__ = ("_family",)

    def __init__(self, family: "MetricFamily"):
        self._family = family


class Counter(_Child):
    __slots__ = ("_value",)

    def __init__(self, family: "MetricFamily"):
        super().__init__(family)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        a = float(amount)
        if a < 0:
            raise ValueError(f"counters only go up; inc({amount}) refused")
        with self._family._lock:
            self._value += a

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class Gauge(_Child):
    __slots__ = ("_value",)

    def __init__(self, family: "MetricFamily"):
        super().__init__(family)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._family._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._family._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class Histogram(_Child):
    __slots__ = ("_counts", "_sum", "_count")

    def __init__(self, family: "MetricFamily"):
        super().__init__(family)
        self._counts = [0] * (len(family.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        buckets = self._family.buckets
        i = len(buckets)
        for j, ub in enumerate(buckets):
            if v <= ub:
                i = j
                break
        with self._family._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper bound, plus sum/count."""
        with self._family._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {
            "buckets": list(zip(list(self._family.buckets) + [math.inf], cum)),
            "sum": total,
            "count": n,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric + its labeled children. An unlabeled family has a
    single anonymous child and proxies its methods (``family.inc(...)``)."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] | None = None,
    ):
        validate_metric_name(name)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__") or ln == "le":
                raise ValueError(f"bad label name {ln!r} for metric {name!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            bks = tuple(
                float(b) for b in (
                    DEFAULT_SECONDS_BUCKETS if buckets is None else buckets
                )
            )
            if list(bks) != sorted(set(bks)):
                raise ValueError(f"histogram buckets must be strictly increasing: {bks}")
            self.buckets = bks
        elif buckets is not None:
            raise ValueError(f"buckets= is histogram-only (metric {name!r})")
        else:
            self.buckets = ()
        self._lock = make_lock(f"obs.registry.{kind}")
        self._children: dict[tuple[str, ...], Any] = {}
        if not self.labelnames:
            self._children[()] = _KINDS[kind](self)

    def labels(self, **labelvalues: str) -> Any:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} wants labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](self)
                self._children[key] = child
            return child

    # -- unlabeled proxy --

    def _solo(self) -> Any:
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                "use .labels(...)"
            )
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    def snapshot(self) -> dict:
        return self._solo().snapshot()

    # -- exposition --

    def _series(self) -> list[tuple[tuple[str, ...], Any]]:
        with self._lock:
            items = list(self._children.items())
        return sorted(items, key=lambda kv: kv[0])

    def expose(self) -> list[str]:
        """This family's exposition lines (sorted children — deterministic)."""
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key, child in self._series():
            pairs = [
                f'{ln}="{_escape_label(lv)}"'
                for ln, lv in zip(self.labelnames, key)
            ]
            base = "{" + ",".join(pairs) + "}" if pairs else ""
            if self.kind == "histogram":
                snap = child.snapshot()
                for ub, cum in snap["buckets"]:
                    le = f'le="{format_value(ub)}"'
                    lbl = "{" + ",".join(pairs + [le]) + "}"
                    lines.append(f"{self.name}_bucket{lbl} {cum}")
                lines.append(f"{self.name}_sum{base} {format_value(snap['sum'])}")
                lines.append(f"{self.name}_count{base} {snap['count']}")
            else:
                lines.append(f"{self.name}{base} {format_value(child.value)}")
        return lines


class MetricsRegistry:
    """The catalog: get-or-create metric families, deterministic exposition."""

    def __init__(self) -> None:
        self._lock = make_lock("obs.registry.families")
        self._families: dict[str, MetricFamily] = {}

    def _get_or_create(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Sequence[str],
        buckets: Sequence[float] | None = None,
    ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(
                    name, kind, help=help, labelnames=labels, buckets=buckets
                )
                self._families[name] = fam
                return fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, wanted {kind}"
            )
        if tuple(labels) != fam.labelnames:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.labelnames}, wanted {tuple(labels)}"
            )
        if kind == "histogram" and buckets is not None and (
            tuple(float(b) for b in buckets) != fam.buckets
        ):
            raise ValueError(
                f"metric {name!r} already registered with buckets {fam.buckets}"
            )
        return fam

    def counter(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> MetricFamily:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> MetricFamily:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] | None = None,
    ) -> MetricFamily:
        return self._get_or_create(name, "histogram", help, labels, buckets=buckets)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            fams = list(self._families.values())
        return sorted(fams, key=lambda f: f.name)

    def exposition(self) -> str:
        """Prometheus text format v0.0.4 of the whole registry — sorted
        families, sorted children, trailing newline (the format requires the
        final line be newline-terminated)."""
        lines: list[str] = []
        for fam in self.families():
            lines.extend(fam.expose())
        return "\n".join(lines) + "\n" if lines else ""

    def values(self) -> dict[str, dict[tuple[str, ...], float]]:
        """Plain-number snapshot (histograms as their ``_count``) — the
        cheap programmatic read tests and drills diff before/after."""
        out: dict[str, dict[tuple[str, ...], float]] = {}
        for fam in self.families():
            series: dict[tuple[str, ...], float] = {}
            for key, child in fam._series():
                if fam.kind == "histogram":
                    series[key] = float(child.snapshot()["count"])
                else:
                    series[key] = float(child.value)
            out[fam.name] = series
        return out


# The process-default registry every plane instruments against.
REGISTRY = MetricsRegistry()
