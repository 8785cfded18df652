"""Elastic-fleet rule pack (round 22).

- **FLEET001 replica-set mutation outside the fleet chokepoints**: any
  statement in ``serve/`` that mutates a router/fleet replica set —
  ``.replicas.append/extend/insert/pop/remove/clear(...)``, ``del
  x.replicas[i]``, or a call to the lifecycle verbs
  ``add_replica``/``remove_replica``/``kill_replica``/``grow_slot`` —
  outside ``serve/fleet.py`` and ``serve/autoscaler.py`` is an ERROR.

  The failure surface is the r17 one-lock two-phase invariant: the fleet
  manager's slot list and the router's replica list must grow and shrink
  in lockstep (a replica the router dispatches to MUST have a committed
  weights slot, and a drained replica must leave through the reroute path
  so zero accepted requests drop). Round 22 made the set dynamic — the
  autoscaler resizes it live — which is exactly when a convenience
  mutation in the router, the service front door, or a new serve module
  would desynchronize the two lists and produce a replica serving without
  weights (or dropping queued futures). All replica-set surgery therefore
  lives behind ``ServeFleet.add_replica``/``remove_replica`` (fleet.py)
  and the controller that calls them (autoscaler.py). Constructing the
  initial list (plain ``Assign``) stays legal everywhere — the router's
  ``__init__`` receives the list it routes over; it just may not reshape
  it. Code outside ``serve/`` (drills, benches, tests driving
  ``kill_replica`` as the crash hook) is deliberately out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity

# Where the rule looks: the serving plane only.
SCOPED_DIRS = ("/serve/",)
# The two modules allowed to reshape a replica set: the fleet (owner of
# both lists and the slot commit) and the autoscaler (the controller).
CHOKEPOINTS = ("serve/fleet.py", "serve/autoscaler.py")

# Mutating list methods on a `.replicas` attribute.
_LIST_MUTATORS = frozenset(
    {"append", "extend", "insert", "pop", "remove", "clear"}
)
# Lifecycle verbs that ARE replica-set surgery wherever they're invoked.
_LIFECYCLE_VERBS = frozenset(
    {"add_replica", "remove_replica", "kill_replica", "grow_slot"}
)


def _is_replica_set_mutation(node: ast.AST) -> str | None:
    """A human-readable description of the mutation, or None."""
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # x.replicas.append(...) etc.
            if (
                fn.attr in _LIST_MUTATORS
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "replicas"
            ):
                return f".replicas.{fn.attr}(...)"
            if fn.attr in _LIFECYCLE_VERBS:
                return f".{fn.attr}(...)"
        elif isinstance(fn, ast.Name) and fn.id in _LIFECYCLE_VERBS:
            return f"{fn.id}(...)"
    if isinstance(node, ast.Delete):
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr == "replicas"
            ):
                return "del .replicas[...]"
    # x.replicas[i] = ... (slot surgery through subscript assignment).
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr == "replicas"
            ):
                return ".replicas[...] = ..."
    return None


class FleetChokepointRule(Rule):
    id = "FLEET001"
    severity = Severity.ERROR
    description = (
        "replica-set mutation in serve/ outside serve/fleet.py and "
        "serve/autoscaler.py — the router's replica list and the fleet "
        "manager's weights slots must resize in lockstep under the "
        "two-phase commit; route it through ServeFleet.add_replica/"
        "remove_replica"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        path = "/" + module.path
        if not any(d in path for d in SCOPED_DIRS):
            return
        if any(path.endswith(c) for c in CHOKEPOINTS):
            return
        for node in ast.walk(module.tree):
            what = _is_replica_set_mutation(node)
            if what is not None:
                yield self.finding(
                    module,
                    node,
                    f"{what} outside serve/fleet.py — a replica set "
                    "reshaped without its weights slot (or its drain "
                    "reroute) desynchronizes the two-phase commit; use "
                    "ServeFleet.add_replica / remove_replica",
                )


RULES = (FleetChokepointRule,)
