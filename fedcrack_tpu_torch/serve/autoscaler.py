"""SLO-driven fleet autoscaler.

The counterpart of ``fedcrack_tpu.serve.autoscaler``. It scales a
:class:`~fedcrack_tpu_torch.serve.fleet.ServeFleet` between
``ServeConfig.min_replicas`` and ``max_replicas``:

- **Signals**: the registry's own Prometheus exposition, parsed by
  ``obs/promexp.parse_prometheus_text`` after the router refreshed its
  gauges: ``serve_rolling_p95_seconds``, the per-bucket
  ``serve_router_queue_depth_total`` and ``serve_fleet_replicas``, the
  signals admission control acts on.
- **Scale-up** (:meth:`ServeFleet.add_replica`) when the queue holds
  ``scale_up_queue_depth`` requests per live replica or the rolling p95
  reaches ``scale_up_p95_frac`` of the SLO; the new replica is prepared and
  warmed off the serving path.
- **Scale-down** (:meth:`ServeFleet.remove_replica`, the router's
  kill/reroute) of the newest live replica after ``scale_down_idle_evals``
  consecutive calm evaluations; queued requests move to survivors with
  their original futures, so no accepted request drops.
- **Hysteresis**: one action per evaluation, a ``scale_cooldown_s`` dead
  time after each, and calm means empty queues and a p95 under half the
  scale-up trigger.

It also integrates replica-seconds (live replicas x wall time), the
fleet's cost meter. The clock is injectable.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs.promexp import parse_prometheus_text, sample_value
from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

log = logging.getLogger("fedcrack_torch.serve.autoscaler")

SCALE_UP = "up"
SCALE_DOWN = "down"
# Calm is stricter than the scale-up trigger (half of it): the band between
# them keeps a load sitting near the trigger from flapping the fleet.
CALM_P95_FACTOR = 0.5


class FleetAutoscaler:
    """Scale a fleet from its scraped pressure signals. Construction
    requires an armed band (``min_replicas >= 1``)."""

    def __init__(self, fleet: Any, *, registry: MetricsRegistry | None = None, clock=time.monotonic):
        cfg = fleet.router.serve_config
        if cfg.min_replicas < 1:
            raise ValueError(
                "autoscaler needs an armed band: set ServeConfig.min_replicas"
                " >= 1 (and max_replicas >= min_replicas)"
            )
        self.fleet = fleet
        self.cfg = cfg
        self.registry = registry if registry is not None else REGISTRY
        self._clock = clock
        self._lock = make_lock("serve.autoscaler.control")
        self._cooldown_until = 0.0
        self._calm_evals = 0
        self._evaluations = 0
        self._replica_seconds = 0.0
        self._last_t: float | None = None
        self.actions: list[dict] = []
        self._m_events = REGISTRY.counter(
            "serve_scale_events_total", "autoscaler fleet resizes by direction", labels=("direction",)
        )
        self._m_replica_seconds = REGISTRY.gauge(
            "serve_replica_seconds_total",
            "integrated live-replicas x wall-time, the elastic fleet's cost meter",
        )
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- signal read ----

    def read_signals(self, parsed: dict | None = None) -> dict:
        """The controller's inputs from a :func:`parse_prometheus_text`
        result; None refreshes the router's gauges and parses the
        registry's own exposition (the production path)."""
        if parsed is None:
            self.fleet.router.refresh_gauges()
            parsed = parse_prometheus_text(self.registry.exposition())
        live = sample_value(parsed, "serve_fleet_replicas")
        p95_s = sample_value(parsed, "serve_rolling_p95_seconds")
        fam = parsed.get("serve_router_queue_depth_total")
        queued = 0.0
        if fam is not None:
            queued = sum(
                v for k, v in fam["samples"].items() if not any(name == "__sample__" for name, _ in k)
            )
        return {
            "live": int(live) if live is not None else 0,
            "p95_ms": (p95_s or 0.0) * 1e3,
            "queued": int(queued),
        }

    # ---- the control law ----

    def _wants_up(self, sig: dict) -> str | None:
        """The reason to grow, or None. Queue pressure is per live replica;
        the p95 trigger fires before the SLO breaches."""
        live = max(1, sig["live"])
        if sig["queued"] >= self.cfg.scale_up_queue_depth * live:
            return f"queued {sig['queued']} >= {self.cfg.scale_up_queue_depth}/replica x {live}"
        slo = self.cfg.slo_p95_ms
        if slo > 0 and sig["p95_ms"] >= self.cfg.scale_up_p95_frac * slo:
            return (
                f"p95 {sig['p95_ms']:.1f} ms >= "
                f"{self.cfg.scale_up_p95_frac:.2f} x SLO {slo:.1f} ms"
            )
        return None

    def _is_calm(self, sig: dict) -> bool:
        """Empty queues and a p95 well inside the hysteresis band."""
        if sig["queued"] > 0:
            return False
        slo = self.cfg.slo_p95_ms
        if slo > 0 and sig["p95_ms"] >= CALM_P95_FACTOR * self.cfg.scale_up_p95_frac * slo:
            return False
        return True

    def evaluate(self, parsed: dict | None = None) -> dict:
        """One control-loop tick: read the signals, integrate
        replica-seconds, take at most ONE scaling action. Returns the
        decision record (appended to :attr:`actions` when one fired)."""
        with self._lock:
            sig = self.read_signals(parsed)
            now = self._clock()
            self._evaluations += 1
            if self._last_t is not None:
                self._replica_seconds += sig["live"] * (now - self._last_t)
            self._last_t = now
            self._m_replica_seconds.set(self._replica_seconds)
            decision = {"evaluation": self._evaluations, "action": None, "reason": "", **sig}
            if now < self._cooldown_until:
                decision["reason"] = "cooldown"
                return decision
            up_reason = self._wants_up(sig)
            if up_reason is not None:
                self._calm_evals = 0
                if sig["live"] >= self.cfg.max_replicas:
                    decision["reason"] = f"at max_replicas: {up_reason}"
                    return decision
                return self._scale_up(decision, up_reason, now)
            if not self._is_calm(sig):
                self._calm_evals = 0
                decision["reason"] = "steady"
                return decision
            self._calm_evals += 1
            if sig["live"] > self.cfg.min_replicas and self._calm_evals >= self.cfg.scale_down_idle_evals:
                return self._scale_down(decision, now)
            decision["reason"] = f"calm {self._calm_evals}/{self.cfg.scale_down_idle_evals}"
            return decision

    def _scale_up(self, decision: dict, reason: str, now: float) -> dict:
        replica = self.fleet.add_replica(warm=True)
        self._cooldown_until = now + self.cfg.scale_cooldown_s
        self._m_events.labels(direction=SCALE_UP).inc()
        decision.update(action=SCALE_UP, reason=reason, replica=replica.index)
        self.actions.append(decision)
        flight.note("serve.scale_up", replica=replica.index, reason=reason)
        log.info("scale-up -> replica %d (%s)", replica.index, reason)
        return decision

    def _scale_down(self, decision: dict, now: float) -> dict:
        # The highest-index live replica drains: the newest capacity leaves
        # first, and replica 0 (the tiled path's) never does.
        victim = max(self.fleet.router.live_replicas(), key=lambda r: r.index)
        reroute = self.fleet.remove_replica(victim.index)
        self._cooldown_until = now + self.cfg.scale_cooldown_s
        self._calm_evals = 0
        self._m_events.labels(direction=SCALE_DOWN).inc()
        decision.update(
            action=SCALE_DOWN,
            reason=f"calm for {self.cfg.scale_down_idle_evals} evals",
            replica=victim.index,
            rerouted=reroute["rerouted"],
        )
        self.actions.append(decision)
        flight.note("serve.scale_down", replica=victim.index, rerouted=reroute["rerouted"])
        log.info("scale-down: drained replica %d (%d rerouted)", victim.index, reroute["rerouted"])
        return decision

    # ---- lifecycle ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.scale_interval_s):
                try:
                    self.evaluate()
                except Exception:
                    log.exception("autoscaler tick failed; retrying next period")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=30)
            self._thread = None

    # ---- audit ----

    def replica_seconds(self) -> float:
        """The integral so far, with the tail since the last evaluation."""
        with self._lock:
            total = self._replica_seconds
            if self._last_t is not None:
                live = sum(1 for r in self.fleet.router.replicas if r.alive)
                total += live * max(0.0, self._clock() - self._last_t)
            return total

    def audit(self) -> dict:
        """JSON-safe verdict: ticks, every action taken, the cost integral,
        the band."""
        with self._lock:
            actions = list(self.actions)
            evaluations = self._evaluations
        return {
            "evaluations": evaluations,
            "scale_ups": sum(1 for a in actions if a["action"] == SCALE_UP),
            "scale_downs": sum(1 for a in actions if a["action"] == SCALE_DOWN),
            "actions": actions,
            "replica_seconds": round(self.replica_seconds(), 3),
            "band": [self.cfg.min_replicas, self.cfg.max_replicas],
            "live": sum(1 for r in self.fleet.router.replicas if r.alive),
        }
