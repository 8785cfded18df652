"""Compressed-transport rule pack.

- **COMP001 frame decode bypasses sanitation**: a compressed-update frame
  that decodes cleanly (magic + CRC + manifest) can still carry anything a
  poisoned trainer produces — NaN deltas, adversarial values — because the
  CRC proves transport integrity, not semantic safety. Every decode path
  that feeds FedAvg must therefore route its reconstruction through
  ``fed.serialization.validate_update`` (the same gate raw uploads take).
  The rule statically pins that invariant over ``fed/`` and ``compress/``:
  any function calling a frame decoder (``decode_update``/``decode_frame``)
  must also reference ``validate_update`` in the same function scope. The
  decoder layer itself (functions NAMED as a frame decoder, which compose
  the lower-level parses) is exempt — it returns trees, it does not feed
  the aggregator.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import terminal_name

FRAME_DECODERS = frozenset({"decode_update", "decode_frame"})
SANITATION_GATE = "validate_update"


def _enclosing_function(module: ModuleSource, node: ast.AST):
    for anc in module.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _references(scope: ast.AST, name: str) -> bool:
    for n in ast.walk(scope):
        if isinstance(n, ast.Name) and n.id == name:
            return True
        if isinstance(n, ast.Attribute) and n.attr == name:
            return True
    return False


class FrameDecodeBypassesSanitationRule(Rule):
    id = "COMP001"
    severity = Severity.ERROR
    description = (
        "compressed-frame decode feeding FedAvg never touches "
        "serialization.validate_update: a CRC-valid frame can still carry "
        "NaN/poisoned deltas into the global average"
    )
    paths = ("/fed/", "/compress/")

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node)
            if name not in FRAME_DECODERS:
                continue
            fn = _enclosing_function(module, node)
            if fn is None:
                # Module-level decode: check the whole module for the gate.
                scope: ast.AST = module.tree
            elif fn.name in FRAME_DECODERS:
                continue  # the decoder layer composing its own parses
            else:
                scope = fn
            if not _references(scope, SANITATION_GATE):
                yield self.finding(
                    module,
                    node,
                    f"{name}() reconstruction must pass through "
                    f"serialization.{SANITATION_GATE} before it can reach "
                    "FedAvg (the CRC proves transport integrity, not that "
                    "the decoded tree is safe to average)",
                )


RULES = (FrameDecodeBypassesSanitationRule,)
