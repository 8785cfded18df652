"""Shadow-lane progressive delivery: evaluate a candidate before it serves.

The counterpart of ``fedcrack_tpu.serve.shadow``. Without it the fleet
installs every gate-passing version fleet-wide; with it a release is an
evaluation first:

- **Mirroring** (:class:`ShadowMirror`): the router calls ``observe`` for
  every admitted request after dispatching it; every ``stride``-th one
  (``ServeConfig.shadow_fraction``, a count-based stride, no RNG) is
  re-submitted to a shadow lane, a :class:`~fedcrack_tpu_torch.serve.batcher.MicroBatcher`
  over the candidate's weights pinned by ``StaticWeights``. The lane is
  not one of the router's replicas, so no answer of it reaches a client:
  its latencies are kept and its masks dropped. A failing lane is counted
  and swallowed, here and in the router.
- **Verdict** (:meth:`ShadowController.stage`): candidate against
  production on three axes: the canary mask IoU
  (:class:`~fedcrack_tpu_torch.health.canary.CanaryEvaluator`, production
  as the reference), the prediction-drift PSI of the seeded probe set
  (:class:`~fedcrack_tpu_torch.health.drift.DriftMonitor`), and the
  shadow / production p95 latency ratio of the mirrored traffic. The
  floors and ceilings come from ``ServeConfig``; each value and the
  verdict land in the record, and a ``serve.shadow_verdict`` span joins
  the candidate's flush lineage.
- **Promote / rollback**: promote is the fleet's two-phase commit
  (``fleet.install``); a rolled-back version is remembered and never
  staged again. Either way the shadow lane is torn down first.

Where the lane runs: ``stage`` places the candidate with
``engine.prepare`` (the reference program, cuDNN on the card), as the JAX
package does. On a quantized fleet the candidate's mirrored and probed
batches therefore run the f32 reference program, and production's batches,
canary probes and PSI reference captures run the fused forward through the
dequant kernels; the candidate runs them only once promoted. The canary
IoU then includes the quantization error, and the latency factor compares
two programs. The candidate's first batches on a fresh ``ResUNet``, in
the lane's fresh worker threads, would carry cuDNN's lazy per-thread
set-up into the shadow p95, so ``stage`` runs one warm-up batch per bucket
through the lane's own batcher before attaching the mirror.

The canary and PSI probes run on the controller's poll thread while the
replicas' batchers serve on the same engine; the kernels' launch counts
and the engine's forward count are kept under locks.

:meth:`ShadowController.start` runs the delivery poll in place of the
manager's auto-install loop: each new statefile version stages through
the shadow first.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

import numpy as np

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry
from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

log = logging.getLogger("fedcrack_torch.serve.shadow")

PROMOTE = "promote"
ROLLBACK = "rollback"


class ShadowMirror:
    """The router's sampling hook: every ``stride``-th observed request is
    copied to the shadow batcher, whose answers feed a latency list and
    are dropped. ``observe`` never raises."""

    def __init__(self, batcher: MicroBatcher, fraction: float):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"shadow fraction must be in (0, 1], got {fraction}")
        self._batcher = batcher
        # fraction 0.25 -> every 4th admitted request mirrors.
        self.stride = max(1, round(1.0 / fraction))
        self._lock = make_lock("serve.shadow.mirror")
        self._seen = 0
        self.mirrored = 0
        self.failures = 0
        self.latencies_ms: list[float] = []
        self._m_mirrored = REGISTRY.counter(
            "serve_shadow_mirrored_total",
            "admitted requests mirrored to the shadow candidate lane",
        )
        self._m_failures = REGISTRY.counter(
            "serve_shadow_failures_total",
            "shadow-lane submissions or answers that failed (production "
            "unaffected by contract)",
        )

    def observe(self, image_u8: np.ndarray) -> None:
        with self._lock:
            self._seen += 1
            if self._seen % self.stride:
                return
            self.mirrored += 1
        self._m_mirrored.inc()
        try:
            fut = self._batcher.submit(image_u8)
        except Exception:
            self._failed()
            return
        fut.add_done_callback(self._on_done)

    def _failed(self) -> None:
        with self._lock:
            self.failures += 1
        self._m_failures.inc()

    def _on_done(self, fut) -> None:
        if fut.cancelled() or fut.exception() is not None:
            self._failed()
            return
        with self._lock:
            self.latencies_ms.append(fut.result().latency_ms)

    def completed(self) -> int:
        with self._lock:
            return len(self.latencies_ms)

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self.latencies_ms)
            return {
                "seen": self._seen,
                "mirrored": self.mirrored,
                "completed": len(lat),
                "failures": self.failures,
                "latencies_ms": lat,
            }


class ShadowController:
    """Stages candidate versions on a shadow lane and promotes or rolls
    them back on the measured verdict, one candidate at a time. Needs
    ``ServeConfig.shadow_fraction > 0``."""

    def __init__(self, fleet: Any, *, registry: MetricsRegistry | None = None, metrics: Any | None = None):
        cfg = fleet.router.serve_config
        if cfg.shadow_fraction <= 0:
            raise ValueError("shadow delivery needs ServeConfig.shadow_fraction > 0")
        self.fleet = fleet
        self.cfg = cfg
        self.registry = registry if registry is not None else REGISTRY
        self._metrics = metrics
        self._lock = make_lock("serve.shadow.stage")
        self._rejected: set[int] = set()
        self.verdicts: list[dict] = []
        self.last: dict | None = None
        self._m_verdicts = REGISTRY.counter(
            "serve_shadow_verdicts_total", "shadow staging outcomes by verdict", labels=("verdict",),
        )
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- the evaluation ----

    def _probe_psi(self, engine: Any, ref_payload: Any, cand_payload: Any) -> dict:
        """Prediction-drift PSI between production and candidate on the
        seeded probe set: the same inputs through both programs, so the
        ``input`` signal is 0 and confidence, entropy and crack_fraction
        isolate what the model changed."""
        from fedcrack_tpu_torch.health.drift import DriftMonitor
        from fedcrack_tpu_torch.serve.quant import probe_images

        ref = DriftMonitor.capture_reference(engine, ref_payload)
        mon = DriftMonitor(ref)
        n = min(self.cfg.quant_probe_batch, engine.max_batch)
        for size in engine.bucket_sizes:
            batch = probe_images(size, n, self.cfg.quant_probe_seed)
            mon.observe(batch, engine.predict_bucket(cand_payload, batch))
        return mon.compare()

    def stage(self, version: int, host_variables: Any, *, wait_s: float = 5.0) -> dict:
        """Evaluate candidate ``version`` against live production and
        decide. Waits up to ``wait_s`` for ``shadow_min_samples`` mirrored
        answers; the canary and PSI probes run on the engine directly, so a
        verdict always lands, and a lane that answered too little is rolled
        back. Returns the verdict record (also appended to
        :attr:`verdicts`)."""
        from fedcrack_tpu_torch.health.canary import CanaryEvaluator

        version = int(version)
        with self._lock:
            engine = self.fleet.engine
            prod_version, prod_payload = self.fleet.manager.snapshot_for(0)
            fctx = tracing.flush_context(version)
            with tracing.span(
                "serve.shadow_verdict", trace=fctx.trace, remote_parent=fctx.to_wire(), version=version,
                baseline_version=prod_version,
            ) as span_handle:
                cand_payload = engine.prepare(host_variables)
                shadow = MicroBatcher(engine, StaticWeights(cand_payload, version))
                for size in engine.bucket_sizes:  # warm-up: see the module docstring
                    shadow.submit(np.zeros((size, size, 3), np.uint8)).result()
                mirror = ShadowMirror(shadow, self.cfg.shadow_fraction)
                self.fleet.router.attach_shadow(mirror)
                try:
                    deadline = time.monotonic() + wait_s
                    while mirror.completed() < self.cfg.shadow_min_samples and time.monotonic() < deadline:
                        time.sleep(0.02)
                finally:
                    self.fleet.router.detach_shadow(mirror)
                    shadow.close()
                mirrored = mirror.snapshot()
                # Off-path quality probes: production is the canary's
                # reference (IoU 1.0 by construction), the candidate the
                # measured evaluation.
                canary = CanaryEvaluator(engine, registry=self.registry)
                canary.evaluate(prod_version, prod_payload)
                iou = canary.evaluate(version, cand_payload)["iou"]
                psis = self._probe_psi(engine, prod_payload, cand_payload)
                psi_max = max(psis.values()) if psis else 0.0
                prod_p95 = self.fleet.router.rolling.percentile(95.0)
                lat = mirrored["latencies_ms"]
                shadow_p95 = float(np.percentile(np.asarray(lat), 95.0)) if lat else None
                if shadow_p95 is None:
                    latency_factor = None
                elif prod_p95 is None or prod_p95 <= 0:
                    latency_factor = 1.0
                else:
                    latency_factor = shadow_p95 / prod_p95
                reasons = []
                if mirrored["completed"] < self.cfg.shadow_min_samples:
                    reasons.append(
                        f"shadow answered {mirrored['completed']} < min_samples {self.cfg.shadow_min_samples}"
                    )
                if iou < self.cfg.shadow_iou_floor:
                    reasons.append(f"canary iou {iou:.4f} < floor {self.cfg.shadow_iou_floor:.4f}")
                if psi_max > self.cfg.shadow_psi_ceiling:
                    reasons.append(f"psi max {psi_max:.4f} > ceiling {self.cfg.shadow_psi_ceiling:.4f}")
                if latency_factor is not None and latency_factor > self.cfg.shadow_latency_factor:
                    reasons.append(
                        f"shadow p95 {latency_factor:.2f}x production > {self.cfg.shadow_latency_factor:.2f}x"
                    )
                verdict = PROMOTE if not reasons else ROLLBACK
                record = {
                    "version": version,
                    "baseline_version": prod_version,
                    "verdict": verdict,
                    "reasons": reasons,
                    "iou": iou,
                    "iou_floor": self.cfg.shadow_iou_floor,
                    "psi": psis,
                    "psi_max": round(psi_max, 6),
                    "psi_ceiling": self.cfg.shadow_psi_ceiling,
                    "latency_factor": round(latency_factor, 4) if latency_factor is not None else None,
                    "latency_ceiling": self.cfg.shadow_latency_factor,
                    "shadow_p95_ms": round(shadow_p95, 3) if shadow_p95 is not None else None,
                    "production_p95_ms": round(prod_p95, 3) if prod_p95 is not None else None,
                    "mirrored": mirrored["mirrored"],
                    "completed": mirrored["completed"],
                    "shadow_failures": mirrored["failures"],
                    "trace": fctx.trace,
                }
                if span_handle is not None:
                    span_handle.set(verdict=verdict, iou=round(iou, 6), psi_max=round(psi_max, 6))
                if verdict == PROMOTE:
                    record["installed"] = self.fleet.install(version, host_variables)
                else:
                    # The statefile keeps advertising this version: never
                    # stage a known-bad candidate again.
                    self._rejected.add(version)
                    record["installed"] = False
        self.verdicts.append(record)
        self.last = record
        self._m_verdicts.labels(verdict=verdict).inc()
        flight.note(
            "serve.shadow_verdict", version=version, verdict=verdict, iou=record["iou"],
            psi_max=record["psi_max"], latency_factor=record["latency_factor"], reasons=reasons or None,
        )
        if self._metrics is not None:
            self._metrics.log("shadow_verdict", **{k: v for k, v in record.items() if k != "psi"})
        log.info(
            "shadow verdict v%d: %s (iou=%.4f psi_max=%.4f latency=%sx)%s",
            version, verdict, iou, psi_max,
            f"{latency_factor:.2f}" if latency_factor is not None else "?",
            f" — {'; '.join(reasons)}" if reasons else "",
        )
        return record

    # ---- the delivery poll loop ----

    def poll_once(self) -> dict | None:
        """One delivery tick: the newest statefile version that is neither
        installed nor rejected stages through the shadow."""
        floor = self.fleet.manager.version
        if self._rejected:
            floor = max(floor, max(self._rejected))
        got = self.fleet.manager.watcher.best_available(floor)
        if got is None:
            return None
        return self.stage(*got)

    def start(self, poll_s: float | None = None) -> None:
        """Run the delivery loop in place of the manager's auto-install
        poll: every publish stages through the shadow first."""
        if self._thread is not None:
            return
        interval = poll_s if poll_s is not None else self.cfg.swap_poll_s
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.poll_once()
                except Exception:
                    log.exception("shadow staging failed; retrying next poll")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=30)
            self._thread = None

    def audit(self) -> dict:
        """JSON-safe delivery summary: staged, promoted and rolled back
        counts and every verdict record."""
        verdicts = list(self.verdicts)
        return {
            "staged": len(verdicts),
            "promoted": sum(1 for v in verdicts if v["verdict"] == PROMOTE),
            "rolled_back": sum(1 for v in verdicts if v["verdict"] == ROLLBACK),
            "verdicts": verdicts,
        }
