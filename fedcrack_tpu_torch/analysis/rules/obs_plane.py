"""Observability rule pack (round 15).

- **OBS001 non-catalog metric name**: every ``registry.counter(...)`` /
  ``registry.gauge(...)`` / ``registry.histogram(...)`` call site must name
  its metric with a **string literal** that is ``snake_case`` and carries a
  unit suffix (``_seconds``, ``_bytes``, ``_total``, ``_ratio``,
  ``_versions`` — the staleness unit — or ``_replicas``, the fleet
  population unit). Two failure modes this kills:

  * a *computed* name (f-string, variable, concatenation) makes the metric
    catalog ungreppable — ``grep -r fed_updates_total`` must find every
    producer — and lets label-like variance leak into the name (unbounded
    series, broken dashboards);
  * a free-spelled name (``FedUpdates``, ``updates_count``, no unit) makes
    the Prometheus exposition drift from the documented catalog; the
    registry enforces the same contract at runtime
    (``obs.registry.validate_metric_name``), this rule catches it before
    anything runs.

  The receiver is matched by NAME — a variable/attribute called
  ``registry``/``REGISTRY`` (or containing ``registry``) or the
  conventional short alias ``reg`` — so the rule follows the idiom, not
  the import graph. Calls that pass the name via ``name=`` keyword are
  checked the same way.

- **OBS002 non-catalog span name** (round 16): every ``tracing.span(...)``
  call site must name its span with a **string literal** that is a dotted
  ``plane.verb`` (``client.push``, ``fed.flush``, ``edge.flush_partial``)
  — the OBS001 literal-name contract extended to spans. The plane prefix
  is what ``tools/trace_stitch.py`` reports as ``planes_crossed`` and what
  the soak's span census groups by; a computed or undotted name breaks
  both. The receiver is matched by idiom: the module alias ``tracing``
  (the repo convention) or ``spans``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity

METRIC_METHODS = ("counter", "gauge", "histogram")
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
# Keep in lockstep with obs.registry.UNIT_SUFFIXES (runtime half of the
# same contract); `_info` is round 20's constant-1 labeled info-gauge unit.
UNIT_SUFFIXES = (
    "_seconds", "_bytes", "_total", "_ratio", "_versions", "_replicas", "_info",
)


def _registry_receiver(call: ast.Call) -> bool:
    func = call.func
    if not isinstance(func, ast.Attribute) or func.attr not in METRIC_METHODS:
        return False
    recv = func.value
    if isinstance(recv, ast.Name):
        name = recv.id
    elif isinstance(recv, ast.Attribute):
        name = recv.attr
    else:
        return False
    low = name.lower()
    return "registry" in low or low in ("reg", "_reg")


def _name_arg(call: ast.Call) -> ast.expr | None:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "name":
            return kw.value
    return None


class MetricCatalogNameRule(Rule):
    id = "OBS001"
    severity = Severity.ERROR
    description = (
        "registry.counter/gauge/histogram metric name must be a snake_case "
        "string literal with a unit suffix (_seconds/_bytes/_total/_ratio/"
        "_versions/_replicas/_info) — computed or free-spelled names break "
        "the greppable catalog and the exposition's stability"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _registry_receiver(node)):
                continue
            arg = _name_arg(node)
            if arg is None:
                yield self.finding(module, node, "metric call without a name argument")
                continue
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                yield self.finding(
                    module,
                    arg if hasattr(arg, "lineno") else node,
                    "metric name must be a string LITERAL (computed names "
                    "make the catalog ungreppable and can mint unbounded "
                    "series)",
                )
                continue
            name = arg.value
            if not NAME_RE.match(name):
                yield self.finding(
                    module, arg,
                    f"metric name {name!r} is not snake_case ([a-z][a-z0-9_]*)",
                )
            elif not name.endswith(UNIT_SUFFIXES):
                yield self.finding(
                    module, arg,
                    f"metric name {name!r} lacks a unit suffix {UNIT_SUFFIXES}",
                )


SPAN_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")


def _tracing_receiver(call: ast.Call) -> bool:
    func = call.func
    if not isinstance(func, ast.Attribute) or func.attr != "span":
        return False
    recv = func.value
    if isinstance(recv, ast.Name):
        name = recv.id
    elif isinstance(recv, ast.Attribute):
        name = recv.attr
    else:
        return False
    low = name.lower()
    return low in ("tracing", "spans") or "tracing" in low


class SpanCatalogNameRule(Rule):
    id = "OBS002"
    severity = Severity.ERROR
    description = (
        "tracing.span(...) span name must be a dotted plane.verb string "
        "literal (e.g. 'client.push', 'fed.flush') — computed or undotted "
        "names break the stitchable span catalog and the plane census"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _tracing_receiver(node)):
                continue
            arg = _name_arg(node)
            if arg is None:
                yield self.finding(module, node, "span call without a name argument")
                continue
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                yield self.finding(
                    module,
                    arg if hasattr(arg, "lineno") else node,
                    "span name must be a string LITERAL (computed names "
                    "make the span catalog ungreppable)",
                )
                continue
            if not SPAN_NAME_RE.match(arg.value):
                yield self.finding(
                    module, arg,
                    f"span name {arg.value!r} is not a dotted plane.verb "
                    "([a-z][a-z0-9_]* '.' [a-z][a-z0-9_]*)",
                )


RULES = (MetricCatalogNameRule, SpanCatalogNameRule)
