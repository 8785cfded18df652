"""SLO watchdog: declarative thresholds over the metric registry, enforced.

The counterpart of ``fedcrack_tpu.obs.watchdog``. A rule set (JSON under
``configs/``, or :func:`default_rules`) is evaluated over the registry's
own Prometheus exposition, or over a scrape of a live ``/metrics``, the
same text a dashboard reads, so the watchdog cannot disagree with what
operators see. A breach follows one contract:

    breach -> flight-recorder dump -> nonzero exit.

Rule shape (one JSON object per rule)::

    {"name": "serve_p95",  "metric": "serve_request_seconds",
     "stat": "p95", "op": "<=", "threshold": 5.0}
    {"name": "updates_floor", "metric": "fed_updates_total",
     "labels": {"result": "accepted"}, "stat": "rate", "op": ">=",
     "threshold": 0.01}

``stat`` says how the samples reduce to one number:

- ``value``: the sample (samples matching the ``labels`` subset are
  summed, so a label-free rule pools a labeled family's children);
- ``rate``: per-second delta of a counter between this evaluation and the
  previous one (indeterminate on the first evaluation and under
  ``min_elapsed_s``);
- ``p50``/``p95``/``p99``: histogram quantile from the cumulative buckets
  (matching children pooled, linear inside the winning bucket, capped at
  the highest finite bound: Prometheus's ``histogram_quantile``);
- ``count``/``sum``: a histogram's ``_count``/``_sum``.

A rule whose metric is absent is indeterminate (skipped) by default;
``"on_missing": "breach"`` makes absence itself a breach.
``"consecutive": N`` is the analog of Prometheus's ``for:`` clause: the
condition must fail N evaluations in a row before a breach is recorded.
:meth:`Watchdog.audit` reduces a run to every rule evaluated at least once
determinately, zero breaches, and ``clean``. Harnesses exit
:data:`BREACH_EXIT` on a breach (distinct from a generic failure's 1).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, field

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs.promexp import parse_prometheus_text, scrape
from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

# The breach -> dump -> exit contract's exit code (distinct from 1, a
# generic audit failure, and 2, a usage error).
BREACH_EXIT = 3

_OPS = {
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}
_STATS = ("value", "rate", "p50", "p95", "p99", "count", "sum")


@dataclass(frozen=True)
class SloRule:
    """One declarative threshold over one metric."""

    name: str
    metric: str
    op: str
    threshold: float
    stat: str = "value"
    labels: dict = field(default_factory=dict)
    on_missing: str = "skip"        # "skip" (indeterminate) | "breach"
    min_elapsed_s: float = 1.0      # rate only: shortest meaningful window
    consecutive: int = 1            # failing evals in a row before a breach

    def __post_init__(self) -> None:
        if not self.name or not self.metric:
            raise ValueError("rule needs a name and a metric")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.stat not in _STATS:
            raise ValueError(f"rule {self.name!r}: unknown stat {self.stat!r}")
        if self.on_missing not in ("skip", "breach"):
            raise ValueError(
                f"rule {self.name!r}: on_missing must be 'skip' or 'breach'"
            )
        if not math.isfinite(float(self.threshold)):
            raise ValueError(f"rule {self.name!r}: non-finite threshold")
        if self.consecutive < 1:
            raise ValueError(f"rule {self.name!r}: consecutive must be >= 1")


def load_rules(path: str) -> list[SloRule]:
    """Parse a ``configs/slo_*.json`` rule file: ``{"rules": [...]}``.
    Every malformed rule is a loud ValueError — a watchdog armed with a
    typo'd rule set would audit nothing while looking green."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    rules_raw = payload.get("rules")
    if not isinstance(rules_raw, list) or not rules_raw:
        raise ValueError(f"{path}: expected a non-empty 'rules' list")
    out = []
    for i, raw in enumerate(rules_raw):
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: rules[{i}] is not an object")
        known = {
            "name", "metric", "op", "threshold", "stat", "labels",
            "on_missing", "min_elapsed_s", "consecutive",
        }
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"{path}: rules[{i}] unknown keys {sorted(unknown)}")
        out.append(SloRule(**raw))
    return out


def default_rules() -> list[SloRule]:
    """The built-in rule set, equal field for field to
    ``configs/slo_default.json`` and to the JAX package's."""
    return [
        SloRule(
            name="serve_p95_seconds", metric="serve_request_seconds",
            stat="p95", op="<=", threshold=5.0,
        ),
        SloRule(
            name="staleness_p99_versions", metric="fed_update_staleness_versions",
            stat="p99", op="<=", threshold=32.0,
        ),
        SloRule(
            # 1 s windows x 4 consecutive failures: only sustained
            # starvation pages, not a storm gust's empty window or a
            # server kill and restart that the clients ride out.
            name="updates_per_sec_floor", metric="fed_updates_total",
            labels={"result": "accepted"}, stat="rate", op=">=",
            threshold=0.01, min_elapsed_s=1.0, consecutive=4,
        ),
        SloRule(
            # <= 0, not == 0: a gauge of -1 means unknown, not a breach.
            # The port's serve command exports it as the kernel libraries
            # loaded (and built) since warm-up (serve.engine.watch_kernel_compiles).
            name="zero_serve_recompiles", metric="serve_recompiles_total",
            op="<=", threshold=0.0,
        ),
        SloRule(
            # Rate, not absolute: the process registry is shared, so the
            # SLO is "no new loud failures on my watch".
            name="zero_failed_requests", metric="serve_failed_requests_total",
            stat="rate", op="<=", threshold=0.0,
        ),
        SloRule(
            # Leak-sentry watermark ceiling (the sentries' growth-since-mark
            # audit stays the sharp check; this is the absolute backstop).
            name="rss_watermark_ceiling", metric="process_resident_watermark_bytes",
            op="<=", threshold=16.0 * 1024**3,
        ),
    ]


def _match(labels_key: tuple, want: dict) -> bool:
    """Does a sample's sorted (name, value) label tuple satisfy the rule's
    label subset?"""
    have = dict(labels_key)
    return all(have.get(k) == str(v) for k, v in want.items())


def _histogram_quantile(fam: dict, want: dict, q: float) -> float | None:
    """Pooled histogram quantile over every child matching the label
    subset: cumulative per-``le`` counts summed across children, then
    linear interpolation inside the winning bucket (highest finite bound
    for the +Inf bucket — the ``histogram_quantile`` convention)."""
    per_le: dict[float, float] = {}
    for key, value in fam["samples"].items():
        have = dict(key)
        if have.get("__sample__") != "_bucket":
            continue
        rest = {k: v for k, v in key if k not in ("__sample__", "le")}
        if not _match(tuple(sorted(rest.items())), want):
            continue
        le = math.inf if have["le"] == "+Inf" else float(have["le"])
        per_le[le] = per_le.get(le, 0.0) + value
    if not per_le:
        return None
    bounds = sorted(per_le)
    total = per_le[bounds[-1]]
    if total <= 0:
        return None
    target = (q / 100.0) * total
    prev_ub, prev_cum = 0.0, 0.0
    highest_finite = max((b for b in bounds if math.isfinite(b)), default=0.0)
    for ub in bounds:
        cum = per_le[ub]
        if cum >= target:
            if not math.isfinite(ub):
                return highest_finite
            if cum == prev_cum:
                return ub
            return prev_ub + (ub - prev_ub) * (target - prev_cum) / (cum - prev_cum)
        prev_ub, prev_cum = (ub if math.isfinite(ub) else prev_ub), cum
    return highest_finite


def _reduce(rule: SloRule, parsed: dict) -> float | None:
    """One rule's current value from a parsed exposition; None = absent."""
    fam = parsed.get(rule.metric)
    if fam is None:
        return None
    if rule.stat in ("p50", "p95", "p99"):
        return _histogram_quantile(fam, rule.labels, float(rule.stat[1:]))
    if rule.stat in ("count", "sum"):
        suffix = f"_{rule.stat}"
        total, seen = 0.0, False
        for key, value in fam["samples"].items():
            have = dict(key)
            if have.get("__sample__") != suffix:
                continue
            rest = {k: v for k, v in key if k != "__sample__"}
            if _match(tuple(sorted(rest.items())), rule.labels):
                total += value
                seen = True
        return total if seen else None
    # "value" / "rate": plain samples (children matching the subset sum).
    total, seen = 0.0, False
    for key, value in fam["samples"].items():
        if any(k == "__sample__" for k, _ in key):
            continue
        if _match(key, rule.labels):
            total += value
            seen = True
    return total if seen else None


class Watchdog:
    """Evaluate a rule set repeatedly; accumulate the audit."""

    def __init__(
        self,
        rules: list[SloRule] | None = None,
        registry: MetricsRegistry | None = None,
    ):
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.registry = registry if registry is not None else REGISTRY
        self._lock = make_lock("obs.watchdog.eval")
        self._evaluations = 0
        self._determinate: dict[str, int] = {r.name: 0 for r in self.rules}
        self._fail_streak: dict[str, int] = {}
        self._last_counter: dict[str, tuple[float, float]] = {}
        self.breaches: list[dict] = []
        self._dumped = False

    def evaluate(self, parsed: dict | None = None) -> dict:
        """One pass over every rule. ``parsed`` is a
        :func:`parse_prometheus_text` result (e.g. from a real scrape);
        None evaluates the registry's own exposition. Returns the per-rule
        report and feeds the flight ring the sampled values (the
        metric-sample feed a post-mortem reads)."""
        if parsed is None:
            parsed = parse_prometheus_text(self.registry.exposition())
        now = time.monotonic()
        results = []
        with self._lock:
            self._evaluations += 1
            eval_idx = self._evaluations
            for rule in self.rules:
                streak = self._fail_streak.get(rule.name, 0)
                value = _reduce(rule, parsed)
                if rule.stat == "rate" and value is not None:
                    prev = self._last_counter.get(rule.name)
                    if prev is None:
                        self._last_counter[rule.name] = (value, now)
                        value = None
                    elif now - prev[1] < rule.min_elapsed_s:
                        # Keep the previous anchor: advancing it every
                        # evaluation would shrink every window below
                        # min_elapsed_s and leave the rule permanently
                        # indeterminate.
                        value = None
                    else:
                        rate = (value - prev[0]) / (now - prev[1])
                        self._last_counter[rule.name] = (value, now)
                        value = rate
                if value is None or (
                    isinstance(value, float) and math.isnan(value)
                ):
                    failing = rule.on_missing == "breach"
                    streak = streak + 1 if failing else streak
                    results.append(
                        {
                            "rule": rule.name,
                            "value": None,
                            "ok": False if failing else None,
                            "breach": failing and streak >= rule.consecutive,
                        }
                    )
                else:
                    self._determinate[rule.name] += 1
                    ok = _OPS[rule.op](float(value), float(rule.threshold))
                    streak = 0 if ok else streak + 1
                    results.append(
                        {
                            "rule": rule.name,
                            "value": float(value),
                            "ok": bool(ok),
                            # The `for:`-style clause: only a failure
                            # SUSTAINED for `consecutive` evaluations is a
                            # breach (a single empty rate window is not).
                            "breach": not ok and streak >= rule.consecutive,
                        }
                    )
                self._fail_streak[rule.name] = streak
            new_breaches = [
                {
                    "rule": r["rule"],
                    "value": r["value"],
                    "op": next(
                        x.op for x in self.rules if x.name == r["rule"]
                    ),
                    "threshold": next(
                        x.threshold for x in self.rules if x.name == r["rule"]
                    ),
                    "evaluation": eval_idx,
                }
                for r in results
                if r["breach"]
            ]
            self.breaches.extend(new_breaches[: max(0, 64 - len(self.breaches))])
        flight.note(
            "watchdog.eval",
            evaluation=eval_idx,
            values={r["rule"]: r["value"] for r in results},
            breaches=[b["rule"] for b in new_breaches] or None,
        )
        return {"evaluation": eval_idx, "results": results, "breaches": new_breaches}

    def enforce(self, parsed: dict | None = None) -> dict:
        """evaluate() + the breach contract: the FIRST breaching evaluation
        dumps the flight ring (reason names the rules), once per watchdog."""
        report = self.evaluate(parsed)
        if report["breaches"] and not self._dumped:
            self._dumped = True
            names = sorted({b["rule"] for b in report["breaches"]})
            flight.dump(f"watchdog breach: {', '.join(names)}")
        return report

    def audit(self) -> dict:
        """The run's verdict: rules, evaluations, the rules never
        determinate, the breaches, and ``clean``."""
        with self._lock:
            never = sorted(
                name for name, n in self._determinate.items() if n == 0
            )
            breaches = list(self.breaches)
            evaluations = self._evaluations
        return {
            "rules_evaluated": len(self.rules),
            "rules": sorted(r.name for r in self.rules),
            "evaluations": evaluations,
            "never_determinate": never,
            "all_rules_evaluated": evaluations > 0 and not never,
            "breaches": breaches,
            "clean": evaluations > 0 and not breaches and not never,
        }


def main(argv=None) -> int:
    """Standalone watchdog over a live ``/metrics`` endpoint:
    ``python -m fedcrack_tpu_torch.obs.watchdog --rules configs/slo_default.json
    --url http://127.0.0.1:9109/metrics --interval 5 --count 12`` — exits
    ``BREACH_EXIT`` on any breach (after the flight dump, when a ring is
    armed), 0 on a clean audit."""
    p = argparse.ArgumentParser(
        prog="python -m fedcrack_tpu_torch.obs.watchdog", description=__doc__
    )
    p.add_argument("--rules", default="", help="JSON rule file; empty = built-ins")
    p.add_argument("--url", required=True, help="the /metrics endpoint to watch")
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--count", type=int, default=2)
    p.add_argument("--flight-dump", default="", help="arm a flight ring dumping here")
    args = p.parse_args(argv)
    rules = load_rules(args.rules) if args.rules else None
    if args.flight_dump:
        flight.install(path=args.flight_dump)
    wd = Watchdog(rules)
    for i in range(max(1, args.count)):
        if i:
            time.sleep(args.interval)
        report = wd.enforce(scrape(args.url))
        for b in report["breaches"]:
            print(f"BREACH {b['rule']}: {b['value']} {b['op']} {b['threshold']} is false")
    audit = wd.audit()
    print(json.dumps(audit, indent=1, sort_keys=True))
    if audit["breaches"]:
        return BREACH_EXIT
    # Not clean without a breach = rules that never went determinate
    # (absent metrics): a configuration/coverage failure, not an SLO one.
    return 0 if audit["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
