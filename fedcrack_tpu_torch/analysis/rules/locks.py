"""Lock-order rule pack.

**LOCK001**: a cycle in the static lock-acquisition graph. Two code paths
acquiring the same pair of locks in opposite orders is the classic
serve-plane deadlock: the batcher worker holds its stats lock while reading
a swap snapshot at the instant the poll thread holds the snapshot lock while
publishing stats. The serving plane owns three locks today (``batcher.py``,
``service.py``, ``hot_swap.py``) and the contract is that the graph over
them — plus ``ckpt/`` and ``obs/`` — stays acyclic.

Graph construction (static, name-based — the runtime twin that records real
acquisition stacks is ``analysis.sanitizers.LockOrderMonitor``):

- **nodes**: every ``threading.Lock()``/``RLock()``/``Condition()``/
  ``make_lock()`` bound to a module-level name or a ``self.<attr>``;
- **edges**: inside a ``with <lock>:`` body, (a) a lexically nested
  ``with <other-lock>:`` and (b) any call whose terminal method name matches
  a method known (transitively) to acquire another lock. Call resolution is
  by name across the analyzed modules — over-approximate on purpose: a
  phantom edge costs nothing unless it closes a cycle, a missed edge hides
  a deadlock.

``build_lock_graph`` is also the ``tools/fedlint.py --lock-graph`` payload:
nodes, edges (with acquisition sites), and any cycles, as one JSON artifact.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Sequence

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import terminal_name

LOCK_CONSTRUCTORS = {"Lock", "RLock", "Condition", "Semaphore",
                     "BoundedSemaphore", "make_lock"}

# Methods on builtin containers: never resolve a call-mediated edge through
# these names (set.add vs StreamingPercentiles.add would otherwise alias).
BUILTIN_METHOD_NAMES = {
    "append", "extend", "pop", "get", "items", "keys", "values", "add",
    "discard", "update", "setdefault", "clear", "remove", "insert", "copy",
    "join", "split", "strip", "format", "encode", "decode", "read", "write",
    "flush", "close", "put", "get_nowait", "put_nowait",
}


@dataclasses.dataclass(frozen=True)
class LockDef:
    node_id: str       # "path::Class.attr" or "path::name"
    path: str
    line: int
    ctor: str          # "Lock" / "RLock" / ...


@dataclasses.dataclass(frozen=True)
class LockEdge:
    src: str
    dst: str
    path: str
    line: int
    via: str           # "nested-with" or "call:<name>"


class _LockGraph:
    def __init__(self) -> None:
        self.locks: dict[str, LockDef] = {}
        self.edges: dict[tuple[str, str], LockEdge] = {}

    def cycles(self) -> list[list[str]]:
        """Strongly connected components of size > 1, plus self-edges on
        non-reentrant locks, as sorted node-id cycles."""
        adj: dict[str, set[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
        out: list[list[str]] = []
        for comp in _sccs(sorted(self.locks), adj):
            if len(comp) > 1:
                out.append(sorted(comp))
        for (src, dst) in sorted(self.edges):
            if src == dst and self.locks.get(src, LockDef("", "", 0, "")).ctor != "RLock":
                out.append([src])
        return out

    def to_json(self) -> dict:
        return {
            "nodes": [dataclasses.asdict(d) for _, d in sorted(self.locks.items())],
            "edges": [dataclasses.asdict(e) for _, e in sorted(self.edges.items())],
            "cycles": self.cycles(),
        }


def _sccs(nodes: Sequence[str], adj: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan's algorithm, iterative (lint inputs are small but recursion
    limits are not ours to spend)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    out: list[list[str]] = []

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _enclosing_class(module: ModuleSource, node: ast.AST) -> str | None:
    for anc in module.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc.name
    return None


def _lock_expr_id(module: ModuleSource, expr: ast.expr,
                  class_locks: dict[tuple[str, str], str],
                  module_locks: dict[str, str],
                  enclosing_class: str | None) -> str | None:
    """Resolve a with/acquire target to a known lock node id."""
    target = expr
    if isinstance(target, ast.Call) and isinstance(target.func, ast.Attribute) \
            and target.func.attr == "acquire":
        target = target.func.value
    if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name) \
            and target.value.id == "self" and enclosing_class is not None:
        return class_locks.get((enclosing_class, target.attr))
    if isinstance(target, ast.Name):
        return module_locks.get(target.id)
    return None


def build_lock_graph(modules: Sequence[ModuleSource]) -> _LockGraph:
    graph = _LockGraph()
    # (module, class or None, attr/name) discovery + function inventory.
    class_locks_by_mod: dict[str, dict[tuple[str, str], str]] = {}
    module_locks_by_mod: dict[str, dict[str, str]] = {}
    funcs: list[tuple[ModuleSource, ast.AST, str, str | None]] = []
    name_index: dict[str, list[int]] = {}

    for module in modules:
        class_locks: dict[tuple[str, str], str] = {}
        module_locks: dict[str, str] = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if not (isinstance(val, ast.Call) and terminal_name(val) in LOCK_CONSTRUCTORS):
                continue
            ctor = terminal_name(val) or ""
            for t in node.targets:
                if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    cls = _enclosing_class(module, node)
                    if cls is not None:
                        node_id = f"{module.path}::{cls}.{t.attr}"
                        class_locks[(cls, t.attr)] = node_id
                        graph.locks[node_id] = LockDef(node_id, module.path, node.lineno, ctor)
                elif isinstance(t, ast.Name) and _enclosing_class(module, node) is None:
                    node_id = f"{module.path}::{t.id}"
                    module_locks[t.id] = node_id
                    graph.locks[node_id] = LockDef(node_id, module.path, node.lineno, ctor)
        class_locks_by_mod[module.path] = class_locks
        module_locks_by_mod[module.path] = module_locks
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls = _enclosing_class(module, node)
                funcs.append((module, node, node.name, cls))
                name_index.setdefault(node.name, []).append(len(funcs) - 1)

    # Per function: directly acquired locks + called names.
    direct: list[set[str]] = []
    calls: list[set[str]] = []
    for module, fn, _, cls in funcs:
        acquired: set[str] = set()
        called: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = _lock_expr_id(
                        module, item.context_expr,
                        class_locks_by_mod[module.path],
                        module_locks_by_mod[module.path], cls,
                    )
                    if lid is not None:
                        acquired.add(lid)
            elif isinstance(node, ast.Call):
                term = terminal_name(node)
                if term is not None and term not in BUILTIN_METHOD_NAMES:
                    called.add(term)
                lid = _lock_expr_id(
                    module, node,
                    class_locks_by_mod[module.path],
                    module_locks_by_mod[module.path], cls,
                )
                if lid is not None:
                    acquired.add(lid)
        direct.append(acquired)
        calls.append(called)

    # Fixpoint: locks reachable through the name-resolved call graph.
    reach = [set(s) for s in direct]
    changed = True
    while changed:
        changed = False
        for i in range(len(funcs)):
            for n in calls[i]:
                for j in name_index.get(n, ()):
                    if not reach[j] <= reach[i]:
                        reach[i] |= reach[j]
                        changed = True

    # Edges: held lock -> lock acquired inside the with body.
    for i, (module, fn, _, cls) in enumerate(funcs):
        for node in ast.walk(fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            held = [
                lid for item in node.items
                if (lid := _lock_expr_id(
                    module, item.context_expr,
                    class_locks_by_mod[module.path],
                    module_locks_by_mod[module.path], cls,
                )) is not None
            ]
            if not held:
                continue
            # `with a, b:` acquires in item order: a -> b.
            for k in range(len(held) - 1):
                for later in held[k + 1:]:
                    _add_edge(graph, held[k], later, module.path, node.lineno,
                              "nested-with")
            for inner in ast.walk(ast.Module(body=node.body, type_ignores=[])):
                if isinstance(inner, (ast.With, ast.AsyncWith)):
                    for item in inner.items:
                        lid = _lock_expr_id(
                            module, item.context_expr,
                            class_locks_by_mod[module.path],
                            module_locks_by_mod[module.path], cls,
                        )
                        if lid is not None:
                            for h in held:
                                _add_edge(graph, h, lid, module.path,
                                          inner.lineno, "nested-with")
                elif isinstance(inner, ast.Call):
                    term = terminal_name(inner)
                    if term is None or term in BUILTIN_METHOD_NAMES:
                        continue
                    for j in name_index.get(term, ()):
                        for lid in reach[j]:
                            for h in held:
                                _add_edge(graph, h, lid, module.path,
                                          inner.lineno, f"call:{term}")
    return graph


def _add_edge(graph: _LockGraph, src: str, dst: str, path: str, line: int,
              via: str) -> None:
    key = (src, dst)
    if key not in graph.edges:
        graph.edges[key] = LockEdge(src, dst, path, line, via)


class LockOrderRule(Rule):
    id = "LOCK001"
    severity = Severity.ERROR
    description = (
        "cycle in the static lock-acquisition graph: two paths take the "
        "same locks in opposite orders (or a non-reentrant lock re-enters "
        "itself) — the serve-plane deadlock class"
    )
    paths = ("/serve/", "/ckpt/", "/obs/", "/native/", "/transport/")
    project_scope = True

    def check_project(self, modules: Sequence[ModuleSource]) -> Iterable[Finding]:
        graph = build_lock_graph(modules)
        by_path = {m.path: m for m in modules}
        for cycle in graph.cycles():
            # Anchor the finding at the first edge participating in the cycle.
            members = set(cycle)
            anchor = None
            for key, edge in sorted(graph.edges.items()):
                if edge.src in members and edge.dst in members:
                    anchor = edge
                    break
            if anchor is None:
                d = graph.locks[cycle[0]]
                anchor = LockEdge(cycle[0], cycle[0], d.path, d.line, "self")
            module = by_path.get(anchor.path)
            line_text = module.line_text(anchor.line) if module else ""
            yield Finding(
                rule=self.id,
                severity=self.severity,
                path=anchor.path,
                line=anchor.line,
                col=0,
                message=(
                    "lock-order cycle " + " -> ".join(cycle + [cycle[0]])
                    + f" (via {anchor.via}): acquire these locks in one "
                    "global order everywhere"
                ),
                source_line=line_text,
            )


RULES = (LockOrderRule,)
