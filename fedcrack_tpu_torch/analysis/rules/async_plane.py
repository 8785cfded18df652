"""Async-federation rule pack (round 14).

- **ASYNC001 unordered iteration in a buffered flush / staleness path**:
  the buffered aggregator's headline invariant is that a flush is a pure
  function of the buffer CONTENTS — never of cross-client arrival order
  (the sorted ``(cname, seq)`` fold, the same ordered-fold discipline the
  r13 cohort plane pinned). The hazard is one careless iteration: a
  ``dict``-view or ``set`` walked inside a flush/staleness code path feeds
  ``fedavg``/serialization in arrival (or hash-randomized) order and the
  "bit-identical resume / sync-degeneration" contracts silently die.
  DET004 already polices dict-views that LEXICALLY feed a serializer in
  ``fed/``; this rule extends it to the new plane with a stricter scope:
  inside any ``fed/`` function whose name marks it as buffer-flush or
  staleness machinery (``flush``/``buffer``/``stale`` in the name), EVERY
  unsorted dict-view or set iteration is an ERROR — in those functions
  iteration order IS aggregation/serialization order, so there is no
  benign case to carve out.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import (
    assigned_names,
    terminal_name,
    wrapped_in_sorted,
)

# Function names that mark the buffered-aggregation / staleness plane.
ASYNC_FUNC_PAT = re.compile(r"flush|buffer|stale", re.IGNORECASE)


def _scope_walk(scope: ast.AST) -> Iterable[ast.AST]:
    """Walk without descending into nested function scopes (each matching
    function is checked on its own)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _iterations(node: ast.AST) -> list[tuple[ast.expr, str]]:
    iters: list[ast.expr] = []
    if isinstance(node, (ast.For, ast.AsyncFor)):
        iters.append(node.iter)
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
        iters.extend(gen.iter for gen in node.generators)
    out = []
    for it in iters:
        if (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Attribute)
            and it.func.attr in ("items", "keys", "values")
            and not it.args
        ):
            out.append((it, "dictview"))
        elif isinstance(it, ast.Set) or (
            isinstance(it, ast.Call) and terminal_name(it) in ("set", "frozenset")
        ):
            out.append((it, "set"))
        else:
            out.append((it, "other"))
    return out


class BufferedFlushOrderRule(Rule):
    id = "ASYNC001"
    severity = Severity.ERROR
    description = (
        "unsorted dict/set iteration inside a buffer-flush/staleness code "
        "path in fed/: arrival order must never reach aggregation or "
        "serialization (extends DET004 to the async plane)"
    )
    paths = ("/fed/",)

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for fn in ast.walk(module.tree):
            if isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and ASYNC_FUNC_PAT.search(fn.name):
                yield from self._check_fn(module, fn)

    def _check_fn(self, module: ModuleSource, fn: ast.AST) -> Iterable[Finding]:
        set_vars: set[str] = set()
        for node in _scope_walk(fn):
            if isinstance(node, ast.Assign):
                val = node.value
                if isinstance(val, ast.Set) or (
                    isinstance(val, ast.Call)
                    and terminal_name(val) in ("set", "frozenset")
                ):
                    for t in node.targets:
                        set_vars.update(assigned_names(t))
        for node in _scope_walk(fn):
            for it, kind in _iterations(node):
                if wrapped_in_sorted(module, it):
                    continue
                is_set_name = isinstance(it, ast.Name) and it.id in set_vars
                if kind in ("dictview", "set") or is_set_name:
                    yield self.finding(
                        module,
                        it,
                        f"unsorted {'set' if kind == 'set' or is_set_name else 'dict-view'} "
                        f"iteration inside {getattr(fn, 'name', '?')}(): in a "
                        "buffer-flush/staleness path iteration order IS "
                        "aggregation/serialization order — wrap in sorted(...)",
                    )


RULES = (BufferedFlushOrderRule,)
