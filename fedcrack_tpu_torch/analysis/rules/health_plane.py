"""Federation-health rule pack (round 18).

- **HEALTH001 client-labeled metric outside the ledger chokepoint**: any
  ``registry.counter/gauge/histogram(...)`` call site whose ``labels=``
  tuple contains a per-client axis (``client``, ``cname``, ``client_id``,
  ``client_name``) must live in ``health/ledger.py`` — the ONE module
  whose export path (:func:`fedcrack_tpu_torch.health.ledger.client_label` /
  ``export_anomaly_metrics``) bounds the label's cardinality
  (``MAX_CLIENT_LABELS`` + ``_overflow`` collapse, max-aggregated).

  The failure mode this kills is the classic federation-metrics leak: a
  well-meaning ``fed_whatever_total`` labeled by client name looks fine on
  a 3-client devbox and mints one Prometheus series per enrolled client in
  production — unbounded cardinality, exactly what the r15 registry's
  bounded-label discipline exists to prevent, except the registry cannot
  know which label VALUES are unbounded; only the lint layer can see that
  the label NAME is a client axis. Anyone who needs a client-resolved
  metric routes it through the ledger's helper instead of minting a new
  family. Same receiver idiom as OBS001 (``registry``/``REGISTRY``/
  ``reg`` by name) so the two rules cover the same call sites.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules.obs_plane import _registry_receiver

# Label names that resolve to one series PER CLIENT — the unbounded axis.
CLIENT_LABELS = frozenset({"client", "cname", "client_id", "client_name"})
# The one module allowed to mint client-labeled families: its export path
# bounds cardinality by construction (client_label / MAX_CLIENT_LABELS).
CHOKEPOINT = "health/ledger.py"


def _client_label_names(call: ast.Call) -> list[str]:
    """Literal label names in the call's ``labels=`` that are client axes.
    Non-literal label expressions are OBS001's problem (computed names);
    this rule only judges what it can read."""
    for kw in call.keywords:
        if kw.arg != "labels":
            continue
        if not isinstance(kw.value, (ast.Tuple, ast.List)):
            return []
        return [
            elt.value
            for elt in kw.value.elts
            if isinstance(elt, ast.Constant)
            and isinstance(elt.value, str)
            and elt.value.lower() in CLIENT_LABELS
        ]
    return []


class ClientLabelChokepointRule(Rule):
    id = "HEALTH001"
    severity = Severity.ERROR
    description = (
        "a metric family labeled by client name mints one series per "
        "enrolled client (unbounded cardinality) — route it through "
        "health/ledger.py's bounded export (client_label / "
        "export_anomaly_metrics) instead of a new registry family"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        if module.path.endswith(CHOKEPOINT):
            return
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _registry_receiver(node)):
                continue
            for label in _client_label_names(node):
                yield self.finding(
                    module,
                    node,
                    f"metric labeled by client axis {label!r} outside "
                    f"{CHOKEPOINT} — per-client series are unbounded; use "
                    "health.ledger.export_anomaly_metrics/client_label "
                    "(MAX_CLIENT_LABELS + _overflow) instead",
                )


RULES = (ClientLabelChokepointRule,)
