"""Live install of the served model: the weights snapshot and its swap.

The counterpart of ``fedcrack_tpu.serve.hot_swap.ModelVersionManager``
for one replica. ``install`` places new weights OFF the serving path and
flips the served ``(version, weights)`` snapshot under a lock; the batcher
reads one snapshot per batch, so a swap never tears a batch and never
stalls one in flight. With ``quant == "int8"`` every install goes through
``serve.fleet.prepare_gated_payload``: the quantized program is served
only when its probe-batch IoU against the reference program clears the
floor. Watching the federation's statefile / checkpoint outputs waits for
the slice that ports the weight blobs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload

log = logging.getLogger("fedcrack_torch.serve.hot_swap")


class ModelVersionManager:
    """Owns the served weights snapshot. ``snapshot()`` is the batcher's
    per-batch read: one lock, no device work."""

    def __init__(
        self,
        engine: Any,
        initial_variables: Any,
        *,
        initial_version: int = 0,
    ):
        self.engine = engine
        self._lock = threading.Lock()
        self._current = (int(initial_version), engine.prepare(initial_variables))
        self.last_swap: dict | None = None
        self.last_quant_gate: dict | None = None

    def snapshot(self) -> tuple[int, Any]:
        with self._lock:
            return self._current

    @property
    def version(self) -> int:
        return self.snapshot()[0]

    def install(self, version: int, host_variables: Any) -> bool:
        """Place ``host_variables`` (quant-gated when the config asks for
        int8) and flip the served snapshot to ``version``; a no-op unless
        ``version`` is strictly newer. Returns whether it installed."""
        current_version = self.snapshot()[0]
        if version <= current_version:
            return False
        t0 = time.monotonic()
        payload, gate = prepare_gated_payload(
            self.engine, host_variables, self.engine.serve_config
        )
        load_ms = (time.monotonic() - t0) * 1e3
        record = {
            "from_version": current_version,
            "to_version": int(version),
            "load_ms": round(load_ms, 3),
            "quantized": gate is not None and gate.passed,
        }
        with self._lock:
            if version <= self._current[0]:
                return False  # a concurrent install won the race
            self._current = (int(version), payload)
            self.last_swap = record
            if gate is not None:
                self.last_quant_gate = gate.to_json()
        log.info("installed served model: v%d -> v%d (%.1f ms load)",
                 current_version, version, load_ms)
        return True
