"""fedlint, the repo-native static analysis, and the lock-order monitor
(the counterpart of ``fedcrack_tpu.analysis``).

- **static** (``engine`` + ``rules/``): an AST-level lint engine with
  repo-specific rule packs (determinism, durability, trace-safety,
  transport, lock order, dead code and the planes' chokepoints), driven by
  ``tools/fedlint.py`` and pinned at zero non-baselined findings over
  ``fedcrack_tpu_torch/`` by a tier-1 gate test;
- **runtime** (``sanitizers``): a debug-mode lock-order monitor that
  records acquisition stacks. The JAX package's recompile sentry and
  transfer guard have no counterpart: the port runs eagerly and places
  every tensor by hand.

Suppression syntax (checked by the engine, see ``engine.py``)::

    x = time.time()  # fedlint: disable=DET001 -- human-readable record ts

Baseline: ``fedlint_torch_baseline.json`` at the repo root carries the
findings that are accepted as they are (each entry fingerprinted against
the offending source line, so the baseline goes stale, and the gate fails,
the moment the line changes).
"""

from fedcrack_tpu_torch.analysis.engine import (
    Finding,
    LintEngine,
    ModuleSource,
    Severity,
    load_baseline,
    make_baseline,
)
from fedcrack_tpu_torch.analysis.sanitizers import LockOrderMonitor, make_lock

__all__ = [
    "Finding",
    "LintEngine",
    "LockOrderMonitor",
    "ModuleSource",
    "Severity",
    "load_baseline",
    "make_baseline",
    "make_lock",
]
