"""The lock factory the telemetry uses.

The counterpart of ``make_lock`` in ``fedcrack_tpu.analysis.sanitizers``.
Every lock the port makes through it is a leaf lock (none is taken while
another is held), so there is no acquisition order to check and the
reference's lock-order monitor is not ported; the jit-cache and
transfer-guard sanitizers are JAX's and have no part here.
"""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A plain ``threading.Lock``; ``name`` labels the call site as in the
    reference's signature."""
    return threading.Lock()
