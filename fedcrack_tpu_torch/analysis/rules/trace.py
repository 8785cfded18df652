"""Trace-safety rule pack.

**TRACE001**: host operations inside functions that are compiled or
captured. A ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
``float(...)``, ``np.*`` call or ``print`` inside a ``torch.compile``d,
scripted, traced or ``torch.func``-transformed function, or inside a CUDA
graph capture, either breaks the graph (a recompile or an eager fallback
every step), fails at capture time, or silently forces a device->host
copy and a stall every step.

A function counts as *traced* when it is

- decorated with ``torch.compile`` / ``torch.jit.script`` /
  ``torch.jit.trace`` / ``torch.func.vmap`` / ``grad`` / ``jacrev`` /
  ``torch.cuda.make_graphed_callables`` (called or not, or through
  ``partial``); or
- passed **by name** to one of those calls anywhere in the module; or
- lexically nested inside a traced function (closures over its state).

The body of a ``with torch.cuda.graph(...)`` block counts too.
``torch.func.functional_call`` is not a transform: it runs eagerly.

Scoped to the slot plane and the serving engine (``parallel/``,
``serve/engine.py``), where a hot function would be compiled or captured;
host-side drivers legitimately mix numpy with device code. The counterpart
of the JAX rule over ``jit`` / ``shard_map`` / ``scan`` / ``remat``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import call_name, dotted_name, terminal_name

# Dotted spellings of the transforms, full and as commonly imported.
TRANSFORM_NAMES = {
    "torch.compile",
    "torch.jit.script", "jit.script",
    "torch.jit.trace", "jit.trace",
    "torch.func.vmap", "torch.vmap", "func.vmap", "vmap",
    "torch.func.grad", "func.grad", "grad",
    "torch.func.jacrev", "func.jacrev", "jacrev",
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables", "make_graphed_callables",
}
CAPTURE_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}

HOST_CALLS = {"print", "input", "breakpoint"}
HOST_CASTS = {"float", "int", "bool"}
HOST_MODULES = {"np", "numpy"}
HOST_METHODS = {"item", "cpu", "numpy", "tolist"}


def _decorator_is_transform(dec: ast.expr) -> bool:
    if isinstance(dec, ast.Call):
        # @partial(torch.compile, ...) / @torch.compile(mode=...)
        if terminal_name(dec) == "partial" and dec.args:
            return dotted_name(dec.args[0]) in TRANSFORM_NAMES
        return call_name(dec) in TRANSFORM_NAMES
    return dotted_name(dec) in TRANSFORM_NAMES


class TracedHostOpRule(Rule):
    id = "TRACE001"
    severity = Severity.ERROR
    description = (
        "host op (.item()/.cpu()/.numpy()/.tolist()/float()/np.*/print) "
        "inside a torch.compile/jit/torch.func-transformed function or a "
        "CUDA graph capture: a graph break, a capture failure or a "
        "device->host stall every step"
    )
    paths = ("/parallel/", "/serve/engine.py")

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        reported: set[tuple[int, int]] = set()
        for scope in self._traced_scopes(module):
            for f in self._host_ops(module, scope):
                key = (f.line, f.col)
                if key not in reported:
                    reported.add(key)
                    yield f

    def _traced_scopes(self, module: ModuleSource) -> list[ast.AST]:
        funcs = [
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        by_name: dict[str, list[ast.AST]] = {}
        for fn in funcs:
            by_name.setdefault(fn.name, []).append(fn)
        traced: set[ast.AST] = set()
        captures: list[ast.AST] = []
        # Decorated.
        for fn in funcs:
            if any(_decorator_is_transform(d) for d in fn.decorator_list):
                traced.add(fn)
        for node in ast.walk(module.tree):
            # Passed by name to a transform call.
            if isinstance(node, ast.Call) and call_name(node) in TRANSFORM_NAMES:
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in by_name:
                        traced.update(by_name[arg.id])
            # A CUDA graph capture's body.
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and call_name(item.context_expr) in CAPTURE_CONTEXTS
                for item in node.items
            ):
                captures.append(ast.Module(body=node.body, type_ignores=[]))
        # Lexical nesting: a def inside a traced def is traced.
        changed = True
        while changed:
            changed = False
            for fn in funcs:
                if fn in traced:
                    continue
                for anc in module.ancestors(fn):
                    if anc in traced:
                        traced.add(fn)
                        changed = True
                        break
        return [fn for fn in funcs if fn in traced] + captures

    def _host_ops(self, module: ModuleSource, scope: ast.AST) -> Iterable[Finding]:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            term = terminal_name(node)
            if term in HOST_METHODS and isinstance(node.func, ast.Attribute) and not node.args \
                    and (name is None or name.split(".")[0] not in HOST_MODULES):
                yield self.finding(
                    module, node,
                    f".{term}() forces a device->host copy inside a compiled "
                    "or captured function",
                )
            elif name in HOST_CALLS:
                yield self.finding(
                    module, node,
                    f"{name}() is a host side effect inside a compiled or "
                    "captured function — a graph break every call",
                )
            elif name in HOST_CASTS and node.args and not isinstance(
                node.args[0], ast.Constant
            ):
                yield self.finding(
                    module, node,
                    f"{name}() on a tensor value forces a host read — use "
                    "tensor casts (x.to(dtype)) instead",
                )
            elif name is not None and name.split(".")[0] in HOST_MODULES:
                yield self.finding(
                    module, node,
                    f"{name}() runs on the host inside a compiled or captured "
                    "function — use the torch equivalent",
                )


RULES = (TracedHostOpRule,)
