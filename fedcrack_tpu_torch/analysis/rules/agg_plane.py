"""Aggregation-algebra rule pack (round 21).

- **AGG001 aggregation fold outside the algebra**: any ``fedavg(...)``
  call in ``fed/`` or ``parallel/`` outside the two chokepoint modules —
  ``fed/aggregation.py`` (the algebra's own instances) and
  ``fed/algorithms.py`` (the weighted-mean primitive's home) — is an
  ERROR.

  The failure surface this kills is the one round 21 just paid down: the
  repo grew FOUR structurally-identical aggregation folds (rounds-plane
  sorted FedAvg, ``fold_buffer``, the edge ``partial``, the mesh ordered
  cohort fold), and when the r18 health plane needed to gate "how updates
  combine" there was no seam — a flagged update was averaged in at full
  weight on every plane. The folds are now one algebra
  (``fed/aggregation.py``: ordered ``(name, weight, tree)`` triples,
  pluggable combine); a NEW direct ``fedavg`` call in the federation or
  mesh planes is someone minting fold copy number five, invisible to
  ``FedConfig.aggregation``, the quarantine gate, and every robust
  combine. Route it through ``aggregation.fold(...)`` instead. Call sites
  outside ``fed/``/``parallel/`` (benches, tools, tests cross-checking
  the algebra against the primitive) are deliberately out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity

# Where the rule looks: the federation and mesh planes.
SCOPED_DIRS = ("/fed/", "/parallel/")
# The two modules allowed to spell the primitive: the algebra's instances
# and the primitive's own definition.
CHOKEPOINTS = ("fed/aggregation.py", "fed/algorithms.py")


def _is_fedavg_call(node: ast.Call) -> bool:
    """``fedavg(...)`` by Name or any-receiver Attribute (``R.fedavg``,
    ``algorithms.fedavg`` — the aliasing idioms the planes actually used)."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id == "fedavg"
    if isinstance(fn, ast.Attribute):
        return fn.attr == "fedavg"
    return False


class AggregationChokepointRule(Rule):
    id = "AGG001"
    severity = Severity.ERROR
    description = (
        "a direct fedavg(...) call in fed/ or parallel/ is an aggregation "
        "fold outside the algebra — invisible to FedConfig.aggregation, "
        "the quarantine gate, and every robust combine; route it through "
        "fed/aggregation.py's fold(algebra, triples)"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        path = "/" + module.path
        if not any(d in path for d in SCOPED_DIRS):
            return
        if any(path.endswith(c) for c in CHOKEPOINTS):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and _is_fedavg_call(node):
                yield self.finding(
                    module,
                    node,
                    "direct fedavg call outside fed/aggregation.py — the "
                    "fifth copy of the fold; use aggregation.fold("
                    "aggregation.FedAvg(), triples) (or from_config) so "
                    "the combine stays pluggable and quarantine-gated",
                )


RULES = (AggregationChokepointRule,)
