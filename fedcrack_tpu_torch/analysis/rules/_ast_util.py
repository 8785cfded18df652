"""Shared AST matchers for the fedlint rule packs."""

from __future__ import annotations

import ast


def dotted_name(node: ast.AST) -> str | None:
    """'time.time' for Attribute(Name('time'), 'time'); None for anything
    that is not a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def terminal_name(node: ast.AST) -> str | None:
    """The last component of a call target: 'packb' for msgpack.packb(...),
    'dumps' for json.dumps(...)."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def wrapped_in_sorted(module, node: ast.AST) -> bool:
    """Whether ``node`` sits (at any depth, within its statement) inside a
    ``sorted(...)`` call — the canonical order-fixing wrapper."""
    for anc in module.ancestors(node):
        if isinstance(anc, ast.Call) and terminal_name(anc) == "sorted":
            return True
        if isinstance(anc, ast.stmt):
            break
    return False


def assigned_names(target: ast.expr) -> list[str]:
    """Flat Name targets of an assignment ('x' for x = ..., both for
    x, y = ...)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for elt in target.elts:
            out.extend(assigned_names(elt))
        return out
    return []
