"""Durability rule pack.

**DUR001**: a raw ``open(path, "w"/"wb")`` write landing on a
checkpoint/statefile/model path bypasses ``ioutils.atomic_write_bytes`` —
a crash mid-write leaves a torn file where the r8 contract promises "the
old complete file or the new complete file, never a torn one".

A write-mode ``open`` is flagged when any of these hold:

- the module lives under ``ckpt/`` (everything there is durable state);
- the path expression's source mentions a durable-state name
  (state/ckpt/best/weights);
- the ``with`` body writes the output of a known tree/state serializer
  (``tree_to_bytes``, ``server_state_to_bytes``, ``packb``, ...) — bytes
  whose only consumer is a later restore, i.e. a checkpoint by any name.

Scratch/report writes (json.dump of a bench artifact, log sinks) are not
flagged; the round checkpointer (``ckpt/manager.py``) writes through
``ioutils.atomic_write_bytes`` like the statefile.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import call_name, terminal_name

DURABLE_PATH_HINTS = ("state", "ckpt", "checkpoint", "best", "weights")

SERIALIZER_CALLS = {
    "tree_to_bytes", "server_state_to_bytes", "packb", "msgpack_serialize",
    "SerializeToString", "to_bytes",
}

WRITE_MODES = ("w", "wb", "w+", "wb+", "w+b")


def _open_write_mode(call: ast.Call) -> bool:
    if call_name(call) not in ("open", "io.open", "os.fdopen"):
        return False
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and mode in WRITE_MODES


class AtomicWriteRule(Rule):
    id = "DUR001"
    severity = Severity.ERROR
    description = (
        "raw open(.., 'w'/'wb') on a checkpoint/statefile/model path: "
        "route through ioutils.atomic_write_bytes (write-temp + fsync + "
        "rename)"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        in_ckpt = "/ckpt/" in "/" + module.path
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _open_write_mode(node)):
                continue
            why = None
            if in_ckpt:
                why = "module is under ckpt/"
            elif node.args and self._durable_path_expr(module, node.args[0]):
                why = "path names durable state"
            elif self._writes_serialized_tree(module, node):
                why = "writes serialized tree/state bytes"
            if why is not None:
                yield self.finding(
                    module, node,
                    f"torn-write hazard ({why}): use "
                    "ioutils.atomic_write_bytes so a crash leaves the old "
                    "complete file or the new one, never a torn file",
                )

    @staticmethod
    def _durable_path_expr(module: ModuleSource, expr: ast.expr) -> bool:
        try:
            text = ast.unparse(expr).lower()
        except Exception:
            return False
        return any(h in text for h in DURABLE_PATH_HINTS)

    @staticmethod
    def _writes_serialized_tree(module: ModuleSource, open_call: ast.Call) -> bool:
        """``with open(...) as f: f.write(<serializer>(...))`` — find the
        enclosing With and scan its body for serializer-fed writes."""
        with_stmt = None
        for anc in module.ancestors(open_call):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                if any(
                    item.context_expr is open_call or open_call in ast.walk(item.context_expr)
                    for item in anc.items
                ):
                    with_stmt = anc
                break
            if isinstance(anc, ast.stmt):
                break
        if with_stmt is None:
            return False
        for node in ast.walk(with_stmt):
            if (
                isinstance(node, ast.Call)
                and terminal_name(node) == "write"
                and node.args
                and isinstance(node.args[0], ast.Call)
                and terminal_name(node.args[0]) in SERIALIZER_CALLS
            ):
                return True
        return False


RULES = (AtomicWriteRule,)
