"""Serving-plane rule pack.

- **SERVE001 cache key misses model version**: the round-19 video plane
  caches per-tile inference output across frames. Any such cache whose key
  does not include the model version SURVIVES a hot swap: after new weights
  install, lookups keep answering from tiles computed under the old model —
  the silent-staleness class the (model_version, content-hash) key exists to
  make impossible. The rule statically pins that invariant over ``serve/``:
  every tile/stream cache LOOKUP (a ``[...]`` read or ``.get(...)`` on a
  cache-named receiver) must use a key expression that references the model
  version — directly, or through a local variable whose assignment does
  (the ``key = (version, digest)`` idiom). Writes and deletes are exempt:
  an entry stored under a bad key is unreachable if every read is gated.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity


def _enclosing_function(module: ModuleSource, node: ast.AST):
    for anc in module.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _recv_name(expr: ast.AST) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _is_cache_recv(expr: ast.AST) -> bool:
    name = _recv_name(expr)
    return name is not None and "cache" in name.lower()


def _mentions_version(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and "version" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "version" in n.attr.lower():
            return True
    return False


def _key_is_versioned(key: ast.AST, scope: ast.AST) -> bool:
    """True when the key expression references the model version, directly
    or via a local name whose assignment in ``scope`` does (the
    ``key = (version, digest)`` idiom)."""
    if _mentions_version(key):
        return True
    if isinstance(key, ast.Name):
        for n in ast.walk(scope):
            if isinstance(n, ast.Assign):
                for tgt in n.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == key.id:
                        if _mentions_version(n.value):
                            return True
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                if isinstance(n.target, ast.Name) and n.target.id == key.id:
                    if _mentions_version(n.value):
                        return True
    return False


def _cache_lookup(node: ast.AST):
    """(receiver, key_expr) when ``node`` READS a cache-named container:
    ``cache[key]`` under Load, or ``cache.get(key[, default])``."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if _is_cache_recv(node.value):
            return node.value, node.slice
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and node.args
        and _is_cache_recv(node.func.value)
    ):
        return node.func.value, node.args[0]
    return None, None


class CacheKeyMissesModelVersionRule(Rule):
    id = "SERVE001"
    severity = Severity.ERROR
    description = (
        "tile/stream cache lookup whose key never references the model "
        "version: the cache survives a hot swap and serves tiles computed "
        "under the OLD weights (silent staleness)"
    )
    paths = ("/serve/",)

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            recv, key = _cache_lookup(node)
            if recv is None:
                continue
            scope = _enclosing_function(module, node) or module.tree
            if _key_is_versioned(key, scope):
                continue
            yield self.finding(
                module,
                node,
                f"cache lookup on {_recv_name(recv)!r} keyed without the "
                "model version: entries computed under old weights survive "
                "a hot swap — key on (model_version, content hash) like "
                "serve/stream.py, or trace the key through an assignment "
                "that includes the version",
            )


RULES = (CacheKeyMissesModelVersionRule,)
