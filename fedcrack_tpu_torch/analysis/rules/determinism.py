"""Determinism rule pack.

The repo's headline invariant is byte-identical trajectories; each rule
here targets one way a PR silently breaks that:

- **DET001 wall-clock**: ``time.time()`` / ``datetime.now()`` reads. Wall
  clocks jump (NTP slew, suspend); every deadline, interval or retry budget
  must use ``time.monotonic()``. Human-readable record timestamps are the
  one legitimate use — keep them, with a ``# fedlint: disable=DET001``
  stating so (hot_swap records, obs JSONL ``ts``).
- **DET002 unseeded randomness**: module-level ``random.*`` /
  ``np.random.*`` draws, and torch's global-RNG draws (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``) called without
  ``generator=``, share hidden global state; two runs (or two threads)
  diverge. Use ``random.Random(seed)`` / ``np.random.default_rng(seed)`` /
  ``torch.Generator().manual_seed(seed)``.
- **DET003 unsorted directory listing**: ``os.listdir`` / ``glob.glob``
  order is filesystem-dependent (the classic cross-host trajectory split
  when file order feeds sample order). Wrap in ``sorted(...)``.
- **DET004 unordered iteration into serialization**: in ``fed/``, ``ckpt/``
  and ``serve/`` — where iteration order lands in wire bytes, statefiles,
  or aggregation — iterating a set, or a dict view that feeds a
  serializer/hasher, must go through ``sorted(...)`` (set order is
  hash-randomized across processes; dict order is arrival order, which a
  federation does not control).
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import (
    assigned_names,
    call_name,
    terminal_name,
    wrapped_in_sorted,
)

WALL_CLOCK_CALLS = {
    "time.time",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "date.today",
    "datetime.date.today",
}

# Constructors / seeding entry points on the random modules that are fine.
SEEDED_RANDOM_OK = {"Random", "SystemRandom", "default_rng", "RandomState",
                    "Generator", "SeedSequence", "PCG64", "Philox"}

# torch's draws from its process-global generator unless given generator=.
TORCH_GLOBAL_DRAWS = {"rand", "randn", "randint", "randperm", "normal"}

LISTING_CALLS = {"os.listdir", "glob.glob", "glob.iglob", "os.scandir"}
LISTING_METHODS = {"glob", "rglob", "iterdir"}  # pathlib.Path

# Terminal call names whose arguments become bytes/hashes: iteration order
# inside them IS the output.
SERIALIZATION_SINKS = {
    "packb", "pack", "dumps", "dump", "msgpack_serialize", "tree_to_bytes",
    "server_state_to_bytes", "sha256", "sha1", "md5", "blake2b", "crc32c",
    "SerializeToString",
}


class WallClockRule(Rule):
    id = "DET001"
    severity = Severity.ERROR
    description = (
        "wall-clock read (time.time/datetime.now): deadlines and intervals "
        "must use time.monotonic(); human-readable timestamps need a "
        "suppression stating so"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and call_name(node) in WALL_CLOCK_CALLS:
                yield self.finding(
                    module,
                    node,
                    f"{call_name(node)}() is a wall clock — use "
                    "time.monotonic() for deadline/interval math; if this is "
                    "a human-readable record timestamp, suppress with a "
                    "reason",
                )


class UnseededRandomRule(Rule):
    id = "DET002"
    severity = Severity.ERROR
    description = (
        "module-level random draw (random.*/np.random.*, or torch.rand/"
        "randn/randint/randperm/normal without generator=): hidden global "
        "state breaks reproducibility — use a seeded generator object "
        "(torch.Generator().manual_seed(seed) for torch)"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            parts = name.split(".")
            if parts[0] == "random" and len(parts) == 2:
                if parts[1] not in SEEDED_RANDOM_OK:
                    yield self.finding(
                        module, node,
                        f"{name}() draws from the process-global RNG — use "
                        "random.Random(seed)",
                    )
            elif parts[0] in ("np", "numpy") and len(parts) >= 3 and parts[1] == "random":
                if parts[2] not in SEEDED_RANDOM_OK:
                    yield self.finding(
                        module, node,
                        f"{name}() draws from numpy's global RNG — use "
                        "np.random.default_rng(seed)",
                    )
            elif (
                parts[0] == "torch" and len(parts) == 2
                and parts[1] in TORCH_GLOBAL_DRAWS
                and not any(kw.arg == "generator" for kw in node.keywords)
            ):
                yield self.finding(
                    module, node,
                    f"{name}() without generator= draws from torch's global "
                    "RNG — pass generator=torch.Generator().manual_seed(seed)",
                )


class UnsortedListingRule(Rule):
    id = "DET003"
    severity = Severity.ERROR
    description = (
        "os.listdir/glob without sorted(): filesystem order is "
        "host-dependent and leaks into sample/checkpoint order"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            is_listing = name in LISTING_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in LISTING_METHODS
                and name is not None
                and not name.startswith(("re.", "fnmatch."))
            )
            if is_listing and not wrapped_in_sorted(module, node):
                yield self.finding(
                    module, node,
                    f"{name or node.func.attr}() returns filesystem order — "
                    "wrap in sorted(...)",
                )


class OrderedSerializationRule(Rule):
    id = "DET004"
    severity = Severity.ERROR
    description = (
        "unordered set/dict iteration feeding serialization, aggregation "
        "or hashing in fed/, ckpt/, serve/"
    )
    paths = ("/fed/", "/ckpt/", "/serve/")

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        # Scopes: module body + each function body, walked independently so
        # "which names feed a sink" stays local.
        scopes: list[ast.AST] = [module.tree]
        scopes.extend(
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )
        seen: set[tuple[int, int]] = set()
        for scope in scopes:
            for f in self._check_scope(module, scope):
                key = (f.line, f.col)
                if key not in seen:
                    seen.add(key)
                    yield f

    @staticmethod
    def _scope_walk(scope: ast.AST) -> Iterable[ast.AST]:
        """Walk ``scope`` WITHOUT descending into nested function scopes —
        a name bound in one function must not taint a same-named variable
        in another (nested functions are scopes of their own in ``check``)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def _check_scope(self, module: ModuleSource, scope: ast.AST) -> Iterable[Finding]:
        set_vars: set[str] = set()
        sink_fed_vars: set[str] = set()
        # Pass 1: names bound to sets, and names passed to serializer sinks.
        for node in self._scope_walk(scope):
            if isinstance(node, ast.Assign):
                val = node.value
                is_set = isinstance(val, ast.Set) or (
                    isinstance(val, ast.Call)
                    and terminal_name(val) in ("set", "frozenset")
                )
                if is_set:
                    for t in node.targets:
                        set_vars.update(assigned_names(t))
            if isinstance(node, ast.Call) and terminal_name(node) in SERIALIZATION_SINKS:
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        sink_fed_vars.add(arg.id)
        # Pass 2: offending iterations.
        for node in self._scope_walk(scope):
            for it, kind in self._iterations(node):
                if wrapped_in_sorted(module, it):
                    continue
                if kind == "set" or self._is_set_expr(it, set_vars):
                    yield self.finding(
                        module, it,
                        "iterating a set: order is hash-randomized across "
                        "processes — wrap in sorted(...)",
                    )
                elif kind == "dictview" and self._feeds_sink(
                    module, it, sink_fed_vars
                ):
                    yield self.finding(
                        module, it,
                        "dict-view iteration feeding a serializer/hash: "
                        "order is arrival order — wrap in sorted(...)",
                    )

    @staticmethod
    def _iterations(node: ast.AST) -> list[tuple[ast.expr, str]]:
        iters: list[ast.expr] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            iters.extend(gen.iter for gen in node.generators)
        out = []
        for it in iters:
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                    and it.func.attr in ("items", "keys", "values") and not it.args:
                out.append((it, "dictview"))
            elif isinstance(it, ast.Set) or (
                isinstance(it, ast.Call)
                and terminal_name(it) in ("set", "frozenset")
            ):
                out.append((it, "set"))
            else:
                out.append((it, "other"))
        return out

    @staticmethod
    def _is_set_expr(node: ast.expr, set_vars: set[str]) -> bool:
        return isinstance(node, ast.Name) and node.id in set_vars

    @staticmethod
    def _feeds_sink(module: ModuleSource, node: ast.AST, sink_fed: set[str]) -> bool:
        """The iteration lexically sits inside a sink call's arguments, or
        inside the RHS of an assignment to a name later passed to a sink."""
        for anc in module.ancestors(node):
            if isinstance(anc, ast.Call) and terminal_name(anc) in SERIALIZATION_SINKS:
                return True
            if isinstance(anc, ast.Assign):
                for t in anc.targets:
                    if set(assigned_names(t)) & sink_fed:
                        return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        return False


RULES = (WallClockRule, UnseededRandomRule, UnsortedListingRule,
         OrderedSerializationRule)
