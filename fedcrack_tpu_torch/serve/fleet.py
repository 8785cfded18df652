"""Multi-replica serve fleet with a fleet-wide two-phase hot swap.

The counterpart of ``fedcrack_tpu.serve.fleet``: N :class:`Replica`
workers (each an engine and a micro-batcher) behind a
:class:`~fedcrack_tpu_torch.serve.router.FleetRouter`, with ONE
:class:`FleetVersionManager` owning every replica's weights slot.

**Two-phase swap: zero torn versions fleet-wide.** A publish (statefile or
direct install) runs:

1. *Prepare*, off the serving path with no lock held: the host weights are
   placed for every live replica's engine. With ``ServeConfig.quant ==
   "int8"`` :func:`prepare_gated_payload` builds the quantized payload for
   the engines' kernel plane and A/B-gates it against the reference
   program on a seeded probe batch; a refused gate prepares the reference
   program instead, loudly, never a silent accuracy cliff.
2. *Commit*, one fleet-lock acquisition: every replica's ``(version,
   payload)`` slot flips together. The batchers' per-batch snapshot reads
   take the same lock, so a request accepted after the commit answers, on
   ANY replica, from the new version, and a batch that snapshotted before
   it answers entirely from its snapshot. The lock hold is the fleet-wide
   pause, exported as ``serve_fleet_swap_pause_seconds``.

On one GPU every replica serves from ONE shared engine: N batcher threads
dispatch onto the same device and the caller's current stream, each
kernel wrapper's launch count and the engine's forward count under their
own locks. So one placed payload serves every replica, and a replica that
joins (``grow_slot``) takes the current ``(version, payload)`` in the same
lock acquisition that appends its slot: a scale-up racing a swap never
labels an old payload with the new version. The JAX ``ServeFleet``'s
``share_engine=`` (an engine per replica, for a device mesh) and
``router_window_s=`` are deliberately absent: the port's engine serves
one device. With ``canary=`` the committed payload is probed once after
each commit (every replica serves the same version), wrapped so that a
raising canary never fails or blocks a swap. The manager watches the
statefile (``state_path=``) and the round checkpoints (``ckpt_dir=``),
the highest version winning.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.serve import quant as quant_mod
from fedcrack_tpu_torch.serve.batcher import MicroBatcher
from fedcrack_tpu_torch.serve.engine import InferenceEngine
from fedcrack_tpu_torch.serve.router import FleetRouter

log = logging.getLogger("fedcrack_torch.serve.fleet")


def prepare_gated_payload(
    engine: Any, host_variables: Any, serve_config: Any
) -> tuple[Any, quant_mod.QuantGateResult | None]:
    """``(payload, gate)`` for installing ``host_variables``: the placed
    quantized weights when ``serve_config.quant == "int8"`` and the gate
    passes, else the placed reference program; ``gate`` is None when no
    quantized build was asked for. The gate's knobs come from
    ``serve_config`` (the deployment's), not from the engine's."""
    reference = engine.prepare(host_variables)
    if serve_config.quant != "int8":
        return reference, None
    plane = engine.kernel_plane
    quantized = engine.prepare_quantized(
        quant_mod.quantize_for_plane(host_variables, plane)
    )
    gate = quant_mod.quant_gate(
        engine,
        reference,
        quantized,
        floor=serve_config.quant_iou_floor,
        probe_batch=serve_config.quant_probe_batch,
        probe_seed=serve_config.quant_probe_seed,
    )
    if not gate.passed:
        log.error(
            "quantized build (kernel_plane=%s) REFUSED: probe mask IoU %.4f "
            "< floor %.4f; serving the reference program",
            plane,
            gate.iou,
            gate.floor,
        )
        return reference, gate
    return quantized, gate


def _place(engine: Any, host_variables: Any, quantized: bool) -> Any:
    """Place ``host_variables`` on ``engine`` as the program an earlier
    gate chose, without gating again."""
    if quantized:
        return engine.prepare_quantized(
            quant_mod.quantize_for_plane(host_variables, engine.kernel_plane)
        )
    return engine.prepare(host_variables)


class _ReplicaWeights:
    """The batcher-facing weights source of one replica: ``snapshot()``
    reads the fleet manager's slot for it (the commit barrier's lock),
    ``swap_context()`` forwards the fleet swap's trace context."""

    def __init__(self, manager: "FleetVersionManager", index: int):
        self._manager = manager
        self._index = index

    def snapshot(self) -> tuple[int, Any]:
        return self._manager.snapshot_for(self._index)

    def swap_context(self, version: int) -> str | None:
        return self._manager.swap_context(version)


class Replica:
    """One serve worker: a micro-batcher over its fleet slot, on the
    fleet's shared ``engine`` (one device, N serving lanes)."""

    def __init__(
        self,
        index: int,
        engine: InferenceEngine,
        manager: "FleetVersionManager",
        *,
        metrics: Any | None = None,
        chaos: Any | None = None,
    ):
        self.index = index
        self.engine = engine
        self.alive = True
        self.batcher = MicroBatcher(
            engine, _ReplicaWeights(manager, index), metrics=metrics, chaos=chaos, replica=index
        )


class FleetVersionManager:
    """Fleet-wide weights ownership: one slot per replica, flipped together.

    The fleet's ``ModelVersionManager``: the same statefile watcher and
    off-path heavy lifting, but ``install`` runs the two-phase
    prepare/commit over every live replica. Replicas are registered after
    construction (:meth:`attach_replicas`), because batchers need the
    manager first.
    """

    def __init__(
        self,
        serve_config: Any,
        *,
        ckpt_dir: str | None = None,
        state_path: str | None = None,
        poll_s: float | None = None,
        template: Any | None = None,
        metrics: Any | None = None,
        canary: Any | None = None,
    ):
        # hot_swap imports prepare_gated_payload from this module.
        from fedcrack_tpu_torch.serve.hot_swap import WeightSourceWatcher

        self.serve_config = serve_config
        self._watcher = WeightSourceWatcher(ckpt_dir=ckpt_dir, state_path=state_path, template=template)
        self._poll_s = poll_s if poll_s is not None else serve_config.swap_poll_s
        self._metrics = metrics
        self.canary = canary
        self._lock = make_lock("serve.fleet.snapshot")
        self._replicas: list[Replica] = []
        self._slots: list[tuple[int, Any]] = []
        self._version = -1
        # The one engine every replica serves from, and the payload placed
        # on it for ``_version``: a replica that joins takes both at once.
        self._engine: InferenceEngine | None = None
        self._payload: Any = None
        self._swap_ctx: dict[int, str] = {}
        self.swaps: list[dict] = []
        self.last_swap: dict | None = None
        self.quant_gates: list[dict] = []
        self.last_quant_gate: dict | None = None
        self._m_pause = REGISTRY.histogram(
            "serve_fleet_swap_pause_seconds",
            "commit-barrier hold of a fleet-wide swap (all replica pointers "
            "flip under one lock; prepare/gate work happens off-path before)",
        )
        self._m_quant_iou = REGISTRY.gauge(
            "serve_quant_iou_ratio",
            "probe-batch mask IoU of the int8 predict program vs the "
            "reference program at the last install gate (min over buckets; "
            "installs below ServeConfig.quant_iou_floor are refused)",
        )
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- wiring ----

    def attach_replicas(self, replicas: list, initial_variables: Any, initial_version: int = 0) -> None:
        """Register the fleet and install the initial weights on every
        replica (prepare and commit, quant gate included), before traffic.
        Every replica must share one engine."""
        if self._replicas:
            raise RuntimeError("replicas already attached")
        if not replicas or any(r.engine is not replicas[0].engine for r in replicas):
            raise ValueError("every replica of a fleet serves from one shared engine")
        self._engine = replicas[0].engine
        payload, _ = self._prepare_payload(initial_variables)
        with self._lock:
            self._replicas = list(replicas)
            self._version = int(initial_version)
            self._payload = payload
            self._slots = [(self._version, payload)] * len(replicas)

    def grow_slot(self, replica: "Replica") -> None:
        """Register ONE new replica after boot, on the shared engine. It
        takes the current ``(version, payload)`` in the lock acquisition
        that appends its slot, so it joins either before a concurrent
        commit (which then flips it too) or after it. ``replica.index``
        must be the current fleet size: indices only grow, and a scale-down
        leaves its dead slot behind."""
        if replica.engine is not self._engine:
            raise ValueError("a grown replica must share the fleet's engine")
        with self._lock:
            if replica.index != len(self._replicas):
                raise ValueError(f"grow_slot expects index {len(self._replicas)}, got {replica.index}")
            self._replicas.append(replica)
            self._slots.append((self._version, self._payload))
            version = self._version
        flight.note("serve.fleet_grow", replica=replica.index, version=version)

    @property
    def watcher(self):
        """The configured weight source (``WeightSourceWatcher``)."""
        return self._watcher

    # ---- serving-path reads ----

    def snapshot_for(self, index: int) -> tuple[int, Any]:
        with self._lock:
            return self._slots[index]

    def snapshot(self) -> tuple[int, Any]:
        """The front door's tiled-path read: replica 0's slot (tiled
        requests run on replica 0's engine)."""
        return self.snapshot_for(0)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def slot_versions(self) -> list[int]:
        """Each replica's slot version, dead replicas' included."""
        with self._lock:
            return [v for v, _ in self._slots]

    def swap_context(self, version: int) -> str | None:
        with self._lock:
            return self._swap_ctx.get(int(version))

    # ---- the two-phase install ----

    def _prepare_payload(self, host_variables: Any):
        """Phase 1: the shared engine's payload, quant-gated when enabled,
        run WITHOUT the fleet lock. Returns ``(payload, gate_record_or_None)``."""
        payload, gate = prepare_gated_payload(self._engine, host_variables, self.serve_config)
        gate_record = None
        if gate is not None:
            gate_record = gate.to_json()
            self._m_quant_iou.set(gate.iou)
            self.quant_gates.append(gate_record)
            self.last_quant_gate = gate_record
            flight.note("serve.quant_gate", passed=gate.passed, iou=gate.iou, floor=gate.floor)
        return payload, gate_record

    def install(self, version: int, host_variables: Any) -> bool:
        """Two-phase fleet swap to ``version`` (a no-op unless strictly
        newer): prepare off-path, then commit under one lock acquisition,
        after which no snapshot anywhere in the fleet returns the old
        version."""
        current = self.version
        if version <= current:
            return False
        fctx = tracing.flush_context(version)
        sctx = tracing.TraceContext(fctx.trace, f"fleet-swap:v{version}")
        with tracing.span(
            "serve.fleet_swap",
            trace=fctx.trace,
            ctx=sctx.to_wire(),
            remote_parent=fctx.to_wire(),
            from_version=current,
            to_version=version,
            replicas=len(self._replicas),
        ) as span_handle:
            t0 = time.monotonic()
            payload, gate_record = self._prepare_payload(host_variables)
            load_ms = (time.monotonic() - t0) * 1e3
            t_commit = time.monotonic()
            with self._lock:
                if version <= self._version:
                    if span_handle is not None:
                        span_handle.set(installed=False)
                    return False
                # Every replica live at commit flips, those grown since
                # prepare included; a dead one keeps its last slot.
                flipped = 0
                for i, r in enumerate(self._replicas):
                    if r.alive:
                        self._slots[i] = (version, payload)
                        flipped += 1
                self._payload = payload
                self._version = version
                self._swap_ctx[version] = sctx.to_wire()
                while len(self._swap_ctx) > 8:
                    self._swap_ctx.pop(min(self._swap_ctx))
            pause_s = time.monotonic() - t_commit
            if span_handle is not None:
                span_handle.set(installed=True, pause_ms=round(pause_s * 1e3, 3))
        self._m_pause.observe(pause_s)
        REGISTRY.counter("serve_swaps_total", "hot swaps installed by the version manager").inc()
        flight.note(
            "serve.fleet_swap", from_version=current, to_version=version,
            load_ms=round(load_ms, 3), pause_ms=round(pause_s * 1e3, 3),
        )
        record = {
            "from_version": current,
            "to_version": version,
            "load_ms": round(load_ms, 3),
            "pause_ms": round(pause_s * 1e3, 3),
            "replicas": flipped,
            "quant_gate": gate_record,
            # fedlint: disable=DET001 -- human-readable record timestamp
            "ts": time.time(),
        }
        self.swaps.append(record)
        self.last_swap = record
        log.info(
            "fleet hot-swap: v%d -> v%d on %d replicas (%.1f ms prepare, %.3f ms commit pause)",
            current, version, record["replicas"], load_ms, pause_s * 1e3,
        )
        if self._metrics is not None:
            self._metrics.log("serve_fleet_swap", **record)
        if self.canary is not None:
            # One probe pass is the fleet's verdict: every replica serves
            # the committed payload.
            try:
                self.canary.evaluate(version, payload)
            except Exception:
                log.exception("canary eval failed for v%d (swap unaffected)", version)
        return True

    # ---- polling lifecycle ----

    def poll_once(self) -> bool:
        got = self._watcher.best_available(self.version)
        if got is None:
            return False
        return self.install(*got)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._poll_s):
                try:
                    self.poll_once()
                except Exception:
                    log.exception("fleet swap poll failed; retrying next period")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=30)
            self._thread = None
        self._watcher.close()


class ServeFleet:
    """The assembled fleet: engines, replicas, manager and router, what the
    gRPC front door and the harnesses hold. ``submit`` and ``snapshot``
    mirror the single-replica batcher and manager, so ``ServeService``
    works unchanged. ``device`` places the engines it builds (CUDA unless
    given)."""

    def __init__(
        self,
        model_config: Any,
        serve_config: Any,
        initial_variables: Any,
        *,
        initial_version: int = 0,
        ckpt_dir: str | None = None,
        state_path: str | None = None,
        template: Any | None = None,
        metrics: Any | None = None,
        chaos: Any | None = None,
        shared_engine: InferenceEngine | None = None,
        warmup: bool = True,
        device: Any = None,
    ):
        engine = shared_engine
        if engine is None:
            engine = InferenceEngine(model_config, serve_config, device=device)
        self.manager = FleetVersionManager(
            serve_config, ckpt_dir=ckpt_dir, state_path=state_path, template=template, metrics=metrics
        )
        self._metrics = metrics
        self._chaos = chaos
        self.replicas = [
            Replica(i, engine, self.manager, metrics=metrics, chaos=chaos)
            for i in range(serve_config.replicas)
        ]
        self.manager.attach_replicas(self.replicas, initial_variables, initial_version)
        if warmup:
            _, payload = self.manager.snapshot()
            engine.warmup(payload)
            if serve_config.quant == "int8":
                # Warm BOTH programs: a refused gate serves the reference
                # program, and a later passing install swaps to the
                # quantized one.
                other = not isinstance(payload, quant_mod.QuantizedVariables)
                engine.warmup(_place(engine, initial_variables, other))
        from fedcrack_tpu_torch.obs.flops import export_kernel_plane

        export_kernel_plane(self.engine.kernel_plane, requested=serve_config.kernel_plane)
        self.router = FleetRouter(self.replicas, serve_config)

    # the batcher-shaped surface of the front door
    def submit(self, image_u8, deadline_ms=None):
        return self.router.submit(image_u8, deadline_ms=deadline_ms)

    def snapshot(self):
        return self.manager.snapshot()

    @property
    def engine(self) -> InferenceEngine:
        return self.replicas[0].engine

    def install(self, version: int, host_variables: Any) -> bool:
        return self.manager.install(version, host_variables)

    # ---- elastic lifecycle ----

    def add_replica(self, *, warm: bool = True) -> Replica:
        """Scale-up: build, register and (by default) warm ONE new replica
        off the serving path, then publish it to the router, which first
        sees it with its batcher live and its slot committed. It shares
        replica 0's engine."""
        engine = self.replicas[0].engine
        index = len(self.replicas)
        replica = Replica(index, engine, self.manager, metrics=self._metrics, chaos=self._chaos)
        self.manager.grow_slot(replica)
        if warm:
            _, payload = self.manager.snapshot_for(index)
            engine.warmup(payload)
        self.replicas.append(replica)
        with self.router._lock:
            self.router.replicas.append(replica)
            self.router._m_replicas.set(sum(1 for r in self.router.replicas if r.alive))
        flight.note("serve.replica_added", replica=index)
        return replica

    def remove_replica(self, index: int) -> dict:
        """Scale-down: drain replica ``index`` through the router's
        kill/reroute, so its queued requests move to survivors with their
        original futures. The slot stays behind, dead."""
        return self.router.kill_replica(index)

    def stats(self) -> dict:
        return {
            "router": self.router.stats(),
            "swaps": list(self.manager.swaps),
            "quant_gate": self.manager.last_quant_gate,
            "replica_versions": self.manager.slot_versions(),
        }

    def close(self) -> None:
        self.manager.stop()
        for r in self.replicas:
            r.batcher.close()
