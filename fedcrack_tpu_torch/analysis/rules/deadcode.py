"""Dead-code rule pack.

Mechanical hygiene with a real failure mode behind it: the reference
codebase shipped a fully written log uploader whose call site was commented
out — dead code that LOOKED like a feature. Unused imports and unreachable
branches are where that class of accident hides.

- **DEAD001 unused import**: an imported name never referenced in the
  module. ``__init__.py`` files are exempt (imports there ARE the API), as
  are ``import x as x`` re-exports and names listed in ``__all__``.
- **DEAD002 unreachable code**: statements after an unconditional
  ``return``/``raise``/``break``/``continue`` in the same block, and
  branches guarded by a constant-false test.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity

_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


class UnusedImportRule(Rule):
    id = "DEAD001"
    severity = Severity.WARNING
    description = "imported name never used in the module"

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        if module.path.endswith("__init__.py"):
            return
        imported: list[tuple[str, ast.AST, str]] = []  # (name, node, spelled)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    imported.append((name, node, alias.name))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    if alias.asname == alias.name:
                        continue  # explicit re-export idiom
                    name = alias.asname or alias.name
                    imported.append((name, node, alias.name))
        if not imported:
            return
        used: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                # root of a dotted chain is a Name and caught above; nothing
                # extra needed, but keep attribute names out of `used`.
                pass
        used |= self._string_referenced(module)
        for name, node, spelled in imported:
            if name not in used:
                yield self.finding(
                    module, node,
                    f"'{spelled}' imported but unused",
                )

    @staticmethod
    def _string_referenced(module: ModuleSource) -> set[str]:
        """Names referenced from string contexts that behave like code:
        ``__all__`` entries and string annotations."""
        out: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
                if "__all__" in targets:
                    for c in ast.walk(node.value):
                        if isinstance(c, ast.Constant) and isinstance(c.value, str):
                            out.add(c.value)
            ann = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ann = [a.annotation for a in node.args.args + node.args.kwonlyargs
                       if a.annotation is not None]
                if node.returns is not None:
                    ann.append(node.returns)
            elif isinstance(node, ast.AnnAssign):
                ann = [node.annotation]
            for a in ann:
                for c in ast.walk(a):
                    if isinstance(c, ast.Constant) and isinstance(c.value, str):
                        out.update(_WORD.findall(c.value))
        return out


def _is_terminal(stmt: ast.stmt) -> bool:
    return isinstance(stmt, (ast.Return, ast.Raise, ast.Break, ast.Continue))


def _const_false(test: ast.expr) -> bool:
    return isinstance(test, ast.Constant) and not test.value


class UnreachableRule(Rule):
    id = "DEAD002"
    severity = Severity.WARNING
    description = (
        "unreachable statement (after return/raise/break/continue, or under "
        "a constant-false test)"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not isinstance(block, list):
                    continue
                for prev, stmt in zip(block, block[1:]):
                    if _is_terminal(prev) and isinstance(stmt, ast.stmt):
                        yield self.finding(
                            module, stmt,
                            f"unreachable: follows a {type(prev).__name__.lower()}",
                        )
                        break  # one finding per block is enough
            if isinstance(node, (ast.If, ast.While)) and _const_false(node.test):
                yield self.finding(
                    module, node,
                    f"{'if' if isinstance(node, ast.If) else 'while'} guarded "
                    "by a constant-false test: the body never runs",
                )


RULES = (UnusedImportRule, UnreachableRule)
