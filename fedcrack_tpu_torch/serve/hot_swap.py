"""Live hot swap of the served model: serve while the federation trains.

The counterpart of ``fedcrack_tpu.serve.hot_swap`` for one replica and
the statefile source. The federation's server writes its global model
into the mid-round statefile (``ckpt/statefile.py``: ``model_version`` and
``global_blob``); :class:`ModelVersionManager` watches that file, loads a
newer version OFF the serving path (decode, quantize, quant gate, device
placement) and installs the new ``(version, weights)`` snapshot with one
pointer flip under a lock. The batcher reads one snapshot per batch, so a
swap never tears a batch across versions and never stalls one in flight.
With ``quant == "int8"`` every install goes through
``serve.fleet.prepare_gated_payload``: the quantized program is served
only when its probe-batch IoU against the reference program clears the
floor. The orbax checkpoint source (``ckpt_dir=``) and the canary
evaluator (``canary=``) are not ported yet.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any

from fedcrack_tpu_torch.ckpt.statefile import STATE_FORMAT
from fedcrack_tpu_torch.fed.serialization import packb, tree_from_bytes, tree_to_bytes, unpackb
from fedcrack_tpu_torch.ioutils import atomic_write_bytes
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload

log = logging.getLogger("fedcrack_torch.serve.hot_swap")

_CKPT_DIR_REFUSAL = (
    "ckpt_dir= (the orbax round-boundary checkpoint) is not ported yet: "
    "ckpt/manager.py, ROADMAP Queue 1 item 5"
)


def read_statefile_weights(path: str, template: Any | None = None):
    """``(model_version, variables)`` from a federation statefile, or None
    (missing or unreadable: logged). Reads the raw payload, not a whole
    ``ServerState``: serving needs only the version and the weights."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    try:
        payload = unpackb(blob)
        if payload.get("format") != STATE_FORMAT:
            raise ValueError(f"unknown statefile format {payload.get('format')!r}")
        version = int(payload["model_version"])
        variables = tree_from_bytes(bytes(payload["global_blob"]), template=template)
    except Exception:
        log.exception("statefile %s unreadable for serving; keeping current model", path)
        return None
    return version, variables


def publish_statefile(
    path: str,
    variables: Any = None,
    model_version: int = 0,
    *,
    blob: bytes | None = None,
) -> None:
    """Write a minimal statefile carrying ``variables`` (or their
    pre-encoded msgpack ``blob``) at ``model_version``, atomically: the
    JAX package's bytes, for a harness that stands in for a federation
    publishing a new global."""
    if blob is None:
        blob = tree_to_bytes(variables)
    payload = {
        "format": STATE_FORMAT,
        "phase": "FINISHED",
        "cohort": [],
        "departed": [],
        "current_round": int(model_version),
        "model_version": int(model_version),
        "failed_rounds": 0,
        "global_blob": blob,
        "received": {},
        "logs": {},
        "history": [],
        "rejected": {},
        "opt_state": None,
    }
    atomic_write_bytes(path, packb(payload, sort_keys=False))


class WeightSourceWatcher:
    """Where new global models come from and how to read them (the
    statefile), nothing about serving. An unreadable source is logged and
    skipped; the caller keeps its model."""

    def __init__(self, *, ckpt_dir: str | None = None, state_path: str | None = None,
                 template: Any | None = None):
        if ckpt_dir:
            raise NotImplementedError(_CKPT_DIR_REFUSAL)
        self._state_path = state_path or None
        self._template = template

    def best_available(self, newer_than: int):
        """``(version, host_variables)`` of the statefile when it is newer
        than ``newer_than``; None otherwise."""
        if self._state_path and os.path.exists(self._state_path):
            got = read_statefile_weights(self._state_path, template=self._template)
            if got is not None and got[0] > newer_than:
                return got
        return None


class ModelVersionManager:
    """Owns the served weights snapshot and watches the federation's
    statefile. ``snapshot()`` is the batcher's per-batch read: one lock,
    no disk and no device work. ``poll_once()`` does the heavy lifting; a
    daemon thread runs it every ``poll_s`` between ``start`` and
    ``stop`` (or the ``with`` block), and tests call it directly."""

    def __init__(
        self,
        engine: Any,
        initial_variables: Any,
        *,
        initial_version: int = 0,
        ckpt_dir: str | None = None,
        state_path: str | None = None,
        poll_s: float = 2.0,
        template: Any | None = None,
        canary: Any | None = None,
    ):
        if canary is not None:
            raise NotImplementedError(
                "ModelVersionManager(canary=...) is not ported yet: health/canary.py, "
                "ROADMAP Queue 1 item 5"
            )
        self.engine = engine
        self._watcher = WeightSourceWatcher(ckpt_dir=ckpt_dir, state_path=state_path, template=template)
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._current = (int(initial_version), engine.prepare(initial_variables))
        self.last_quant_gate: dict | None = None
        # The wire context of the swap that installed each recent version.
        self._swap_ctx: dict[int, str] = {}
        self.swaps: list[dict] = []
        self.last_swap: dict | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def snapshot(self) -> tuple[int, Any]:
        with self._lock:
            return self._current

    def swap_context(self, version: int) -> str | None:
        """The wire context of the swap that installed ``version`` (None for
        the initial weights or evicted versions)."""
        with self._lock:
            return self._swap_ctx.get(int(version))

    @property
    def version(self) -> int:
        return self.snapshot()[0]

    def poll_once(self) -> bool:
        """Install the statefile's model when it is newer; returns whether
        a swap happened."""
        got = self._watcher.best_available(self.snapshot()[0])
        if got is None:
            return False
        return self.install(*got)

    def install(self, version: int, host_variables: Any) -> bool:
        """Prepare ``host_variables`` (quant-gated when the config asks for
        int8) and flip the served snapshot to ``version``; a no-op unless
        ``version`` is strictly newer. The swap joins the version-lineage
        trace and links to the flush that published ``version``."""
        current_version = self.snapshot()[0]
        if version <= current_version:
            return False
        fctx = tracing.flush_context(version)
        sctx = tracing.TraceContext(fctx.trace, f"swap:v{version}")
        with tracing.span("serve.swap", trace=fctx.trace, ctx=sctx.to_wire(), remote_parent=fctx.to_wire(),
                          from_version=current_version, to_version=version) as span_handle:
            t0 = time.monotonic()
            payload, gate = prepare_gated_payload(self.engine, host_variables, self.engine.serve_config)
            load_ms = (time.monotonic() - t0) * 1e3
            with self._lock:
                if version <= self._current[0]:
                    if span_handle is not None:
                        span_handle.set(installed=False)
                    return False  # a concurrent install won the race
                # Registered with the flip: the first batch on the new
                # version finds its swap context.
                self._swap_ctx[int(version)] = sctx.to_wire()
                while len(self._swap_ctx) > 8:
                    self._swap_ctx.pop(min(self._swap_ctx))
                self._current = (int(version), payload)
                if gate is not None:
                    self.last_quant_gate = gate.to_json()
            if span_handle is not None:
                span_handle.set(installed=True)
        flight.note("serve.swap", from_version=current_version, to_version=version, load_ms=round(load_ms, 3))
        REGISTRY.counter("serve_swaps_total", "hot swaps installed by the version manager").inc()
        REGISTRY.histogram(
            "serve_swap_pause_seconds",
            "off-path load cost of a swap (decode, quant gate and device "
            "placement; the serving path pays only the pointer flip)",
        ).observe(load_ms / 1e3)
        record = {
            "from_version": current_version,
            "to_version": int(version),
            "load_ms": round(load_ms, 3),
            "quantized": gate is not None and gate.passed,
        }
        self.swaps.append(record)
        self.last_swap = record
        log.info("hot-swapped served model: v%d -> v%d (%.1f ms load)", current_version, version, load_ms)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._poll_s):
                try:
                    self.poll_once()
                except Exception:
                    log.exception("hot-swap poll failed; retrying next period")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None

    def __enter__(self) -> "ModelVersionManager":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
