"""Transport rule pack.

The reference codebase's transport accidents were mechanical: a ``grcp.``
typo that only failed on the error path it guarded, and retry loops that
re-asked the server questions it had already refused to answer. Both are
statically checkable:

- **TRANS001 unaudited retry**: an ``except`` handler catching
  ``grpc.RpcError`` inside a retry loop that never consults
  ``NON_RETRYABLE_CODES`` retries *every* status code — including the ones a
  retry can never fix (bad request, bad credentials). The r8 retry audit
  made the decision explicit; this rule keeps it that way for every future
  call site.
- **TRANS002 unknown status code**: ``grpc.StatusCode.<NAME>`` where NAME is
  not a real gRPC status code. Python resolves the attribute only when the
  error path runs — exactly the ``grcp.``-typo class the paper's reference
  shipped: the bug hides until the one retry that needed it.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import dotted_name, terminal_name

# The complete grpc.StatusCode enum (grpc/_common.py; stable since gRPC 1.0).
GRPC_STATUS_CODES = frozenset(
    {
        "OK",
        "CANCELLED",
        "UNKNOWN",
        "INVALID_ARGUMENT",
        "DEADLINE_EXCEEDED",
        "NOT_FOUND",
        "ALREADY_EXISTS",
        "PERMISSION_DENIED",
        "RESOURCE_EXHAUSTED",
        "FAILED_PRECONDITION",
        "ABORTED",
        "OUT_OF_RANGE",
        "UNIMPLEMENTED",
        "INTERNAL",
        "UNAVAILABLE",
        "DATA_LOSS",
        "UNAUTHENTICATED",
    }
)

RETRY_REGISTRY_NAME = "NON_RETRYABLE_CODES"


def _catches_rpc_error(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return False
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(terminal_name(x) == "RpcError" for x in types)


class UnauditedRetryRule(Rule):
    id = "TRANS001"
    severity = Severity.ERROR
    description = (
        "grpc.RpcError handler inside a retry loop never consults "
        "NON_RETRYABLE_CODES: non-retryable codes burn the whole backoff "
        "schedule re-asking a server that already refused"
    )
    paths = ("/transport/", "/serve/")

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.ExceptHandler) and _catches_rpc_error(node)):
                continue
            if not self._inside_loop(module, node):
                continue
            consults = any(
                isinstance(n, ast.Name) and n.id == RETRY_REGISTRY_NAME
                for stmt in node.body
                for n in ast.walk(stmt)
            )
            if not consults:
                yield self.finding(
                    module,
                    node,
                    "RpcError retry handler must check the code against "
                    f"{RETRY_REGISTRY_NAME} and raise immediately on a match "
                    "(a retry cannot fix INVALID_ARGUMENT or UNAUTHENTICATED)",
                )

    @staticmethod
    def _inside_loop(module: ModuleSource, node: ast.AST) -> bool:
        for anc in module.ancestors(node):
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
        return False


class UnknownStatusCodeRule(Rule):
    id = "TRANS002"
    severity = Severity.ERROR
    description = (
        "grpc.StatusCode.<NAME> where NAME is not a gRPC status code: the "
        "AttributeError hides until the error path that needed it runs"
    )

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Attribute):
                continue
            name = dotted_name(node)
            if name is None:
                continue
            parts = name.split(".")
            # grpc.StatusCode.X or (from grpc import StatusCode) StatusCode.X
            if len(parts) >= 2 and parts[-2] == "StatusCode":
                member = parts[-1]
                if member not in GRPC_STATUS_CODES:
                    yield self.finding(
                        module,
                        node,
                        f"StatusCode.{member} is not a gRPC status code — "
                        "this AttributeError only fires on the error path "
                        "that references it",
                    )


RULES = (UnauditedRetryRule, UnknownStatusCodeRule)
