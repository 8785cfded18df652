"""Kernel-plane rule pack.

- **KERN001 a hand kernel without a plain twin**: every CUDA kernel of
  the port must be testable off the card. The contract (``ops/bce.py``,
  ``kernels/dequant.py``) is that the module launching a kernel ships its
  plain PyTorch version beside it: a function whose name carries
  ``_plain`` (``_dequant_matmul_plain``, ``_dequant_conv3x3_plain``,
  ``_dequant_dwconv3x3_plain``, ``_dequant_codes_plain``,
  ``_bce_sums_plain``). The wrappers take it on
  CPU tensors, the tests hold it against the JAX package, and the chip
  smoke holds each kernel against it on the card.

  A module that launches a kernel without one is untestable until a card
  shows up: its numerics can drift from the math the rest of the port
  assumes, unpinned. The rule fires one ERROR per launch site in such a
  module.

  Matching is by idiom, not import graph: a kernel launch is a
  ``KernelLibrary(...)`` construction (``kernels/build.py``) or a
  ``<library>.launch(...)`` call; docstring mentions and attribute reads
  without a call do not fire. This is the counterpart of the JAX rule
  over ``pallas_call`` sites, whose twins were an ``interpret=`` path or a
  ``reference`` function.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity

# The function-name fragment that marks the plain PyTorch twin of a kernel.
_TWIN_NAME_FRAGMENT = "_plain"


def _is_kernel_launch(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr in ("launch", "KernelLibrary")
    if isinstance(func, ast.Name):
        return func.id == "KernelLibrary"
    return False


def _module_has_twin(module: ModuleSource) -> bool:
    """True when the module defines a function whose name marks the plain
    PyTorch version of its kernels."""
    return any(
        isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and _TWIN_NAME_FRAGMENT in node.name.lower()
        for node in ast.walk(module.tree)
    )


class KernelWithoutPlainTwinRule(Rule):
    id = "KERN001"
    severity = Severity.ERROR
    description = (
        "KernelLibrary(...) or <library>.launch(...) in a module with no "
        "plain PyTorch twin (a function named *_plain*) — the kernel is "
        "untestable off the card and its numerics can drift unpinned"
    )
    paths = ("/fedcrack_tpu_torch/",)

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        has_twin: bool | None = None  # computed lazily; most modules launch nothing
        for node in ast.walk(module.tree):
            if not _is_kernel_launch(node):
                continue
            if has_twin is None:
                has_twin = _module_has_twin(module)
            if has_twin:
                return
            yield self.finding(
                module,
                node,
                "kernel launch without a plain twin in this module: add a "
                "_<name>_plain function computing the same thing in plain "
                "PyTorch (the ops/bce.py idiom), take it on CPU tensors, "
                "and pin the two against each other on the card",
            )


RULES = (KernelWithoutPlainTwinRule,)
