"""Deterministic fault plans: what breaks, where, and when.

The counterpart of ``fedcrack_tpu.chaos.plan``, pure Python over seeded
``random``: the same seed and arguments give the same schedule as the JAX
package's. A :class:`FaultPlan` is bookkeeping only; the hooks in
:mod:`fedcrack_tpu_torch.chaos.inject` consult it at fixed points and act
on what it returns. Faults are one-shot: the first hook that matches a
fault consumes it (:meth:`FaultPlan.take`), so a retried call or a
replayed round does not trip the same failure twice, which is what makes
bounded-retry recovery testable. Every fault handed out is noted in the
flight recorder (``obs/flight``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs import flight

# ---- fault kinds (the JAX package's strings) ----
# Transport plane: the client hooks of transport/client.py.
CRASH_BEFORE_UPLOAD = "crash_before_upload"    # dies before TrainDone is sent
CRASH_DURING_UPLOAD = "crash_during_upload"    # dies after send, before the reply
CRASH_AFTER_UPLOAD = "crash_after_upload"      # dies on the first call after reporting
STRAGGLER_DELAY = "straggler_delay"            # sleeps delay_s before reporting
NETWORK_FLAP = "network_flap"                  # next `count` RPCs fail UNAVAILABLE
CORRUPT_PAYLOAD = "corrupt_payload"            # TrainDone weights bytes mangled
TRUNCATE_PAYLOAD = "truncate_payload"          # TrainDone weights cut in half
NAN_UPDATE = "nan_update"                      # TrainDone weights re-encoded with NaNs
STALE_REPLAY = "stale_replay"                  # TrainDone re-tagged with round-1
# One payload bit flipped inside an encoded, CRC'd update frame: the
# server's frame decode must reject it before any reconstruction.
CORRUPT_COMPRESSED_FRAME = "corrupt_compressed_frame"
# The client's real trained weights scaled by a large finite factor:
# finite and shape-correct, so sanitation accepts it; the health ledger's
# flush-time anomaly score is what flags it.
SCALED_UPDATE = "scaled_update"
# Secure-aggregation masker dropout: the client dies after its masking
# seed entered the frozen roster and before its own masked upload, the
# window the seed-recovery step exists for.
SECAGG_DROPOUT = "secagg_dropout"

# Mesh plane: the slot driver's fault_injector (parallel/driver.py).
MESH_DEVICE_FAIL = "mesh_device_fail"          # round dispatch raises (preemption)
MESH_NONFINITE = "mesh_nonfinite"              # round output poisoned with NaNs

# Serving plane: the batcher hook (serve/batcher.py chaos=). `round` is
# the 0-based batch index within the bucket worker.
SERVE_SWAP_MIDFLIGHT = "serve_swap_midflight"  # install a new model while a batch is in flight
SERVE_DEVICE_LOSS = "serve_device_loss"        # batch dispatch raises (device loss)

# Video-stream plane: the per-stream tile cache is wiped before the target
# frame is served, so that frame falls back to a full-tile re-run. `round`
# is the 0-based frame index within the stream (chaos.inject.StreamChaos).
SERVE_STREAM_RESET = "serve_stream_reset"

# Scenario-harness kinds: a dead process runs no hook, so the harness
# consumes these from the plan itself and does the damage (kills a fleet
# replica, races a crash against a scale-down, kills the shadow lane or an
# edge aggregator). The plan still schedules and records them, so a
# scenario can assert that the fault really fired. `round` is the replica
# index for the fleet kinds; `client` carries the edge id.
SERVE_REPLICA_CRASH = "serve_replica_crash"
REPLICA_CRASH_DURING_SCALE = "replica_crash_during_scale"
SHADOW_REPLICA_CRASH = "shadow_replica_crash"
EDGE_AGGREGATOR_CRASH = "edge_aggregator_crash"  # edge tier dies mid-round, restarts from statefile

# A straggler storm: one seeded heavy-tail STRAGGLER_DELAY per (client,
# iteration) plus one marker the drill consumes (FaultPlan.storm).
STRAGGLER_STORM = "straggler_storm"

CLIENT_KINDS = frozenset(
    {
        CRASH_BEFORE_UPLOAD,
        CRASH_DURING_UPLOAD,
        CRASH_AFTER_UPLOAD,
        STRAGGLER_DELAY,
        NETWORK_FLAP,
        CORRUPT_PAYLOAD,
        TRUNCATE_PAYLOAD,
        NAN_UPDATE,
        STALE_REPLAY,
        CORRUPT_COMPRESSED_FRAME,
        SCALED_UPDATE,
        SECAGG_DROPOUT,
    }
)
MESH_KINDS = frozenset({MESH_DEVICE_FAIL, MESH_NONFINITE})
SERVE_KINDS = frozenset({SERVE_SWAP_MIDFLIGHT, SERVE_DEVICE_LOSS})
TREE_KINDS = frozenset({EDGE_AGGREGATOR_CRASH})
STORM_KINDS = frozenset({STRAGGLER_STORM})
FLEET_KINDS = frozenset(
    {SERVE_REPLICA_CRASH, REPLICA_CRASH_DURING_SCALE, SHADOW_REPLICA_CRASH}
)
STREAM_KINDS = frozenset({SERVE_STREAM_RESET})
ALL_KINDS = (
    CLIENT_KINDS
    | MESH_KINDS
    | SERVE_KINDS
    | TREE_KINDS
    | STORM_KINDS
    | FLEET_KINDS
    | STREAM_KINDS
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure.

    ``round`` is the protocol round (1-based) for client faults and the
    driver round index (0-based) for mesh faults — each plane's natural
    numbering. ``client`` is the target cname (None for mesh faults).
    """

    kind: str
    round: int
    client: str | None = None
    delay_s: float = 0.0     # STRAGGLER_DELAY: how long to stall
    count: int = 1           # NETWORK_FLAP: how many consecutive RPCs fail

    def __post_init__(self) -> None:
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")


class FaultPlan:
    """A consumable schedule of :class:`Fault` s.

    Each injected client owns its own hook object and consumes faults on
    its own thread; a serve hook is shared by a batcher's bucket workers,
    so :meth:`take` runs under a lock. The plan records everything it
    fired in ``triggered`` (order of consumption), so scenario tests can
    assert that the schedule actually ran instead of silently matching
    nothing.
    """

    def __init__(self, faults: Iterable[Fault] = ()):
        self.pending: list[Fault] = list(faults)
        self.triggered: list[Fault] = []
        self._lock = make_lock("chaos.plan")

    def __len__(self) -> int:
        return len(self.pending)

    def take(
        self,
        kind: str,
        *,
        client: str | None = None,
        round: int | None = None,
    ) -> Fault | None:
        """Consume and return the first pending fault matching ``kind``,
        ``client`` and ``round``; None when nothing matches. A fault with
        ``client=None`` matches any client; every fault pins a round, so a
        hook point that cannot see one (``round=None`` — e.g. an enroll
        message) never matches."""
        with self._lock:
            for i, f in enumerate(self.pending):
                if f.kind != kind:
                    continue
                if f.client is not None and f.client != client:
                    continue
                if round is None or f.round != round:
                    continue
                del self.pending[i]
                self.triggered.append(f)
                break
            else:
                return None
        # Every fault handed out lands in the flight ring, so a red run's
        # dump shows the injections that preceded it.
        flight.note("chaos.fault", fault=f.kind, client=f.client, round=f.round)
        return f

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_rounds: int,
        clients: Iterable[str],
        kinds: Iterable[str] | None = None,
        n_faults: int = 3,
        max_delay_s: float = 0.5,
    ) -> "FaultPlan":
        """A seeded random schedule over the given rounds x clients — the
        long-horizon soak's input. Client kinds draw a (client, round) pair;
        mesh kinds draw a 0-based round. Same seed, same schedule."""
        rng = random.Random(seed)
        kind_pool = sorted(kinds if kinds is not None else CLIENT_KINDS)
        names = sorted(clients)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(kind_pool)
            if kind in MESH_KINDS or kind in SERVE_KINDS or kind in STREAM_KINDS:
                # These planes use a 0-based index (driver round / batch /
                # frame).
                faults.append(Fault(kind=kind, round=rng.randrange(n_rounds)))
            else:
                faults.append(
                    Fault(
                        kind=kind,
                        round=rng.randint(1, n_rounds),
                        client=rng.choice(names) if names else None,
                        delay_s=round(rng.uniform(0.05, max_delay_s), 3),
                        count=rng.randint(1, 2),
                    )
                )
        return cls(faults)

    @classmethod
    def storm(
        cls,
        seed: int,
        *,
        clients: Iterable[str],
        n_iterations: int,
        tail_alpha: float = 1.2,
        scale_s: float = 0.04,
        cap_s: float = 0.6,
        gust_p: float = 0.25,
        gust_floor: float = 0.5,
    ) -> "FaultPlan":
        """A seeded straggler storm: one heavy-tail
        STRAGGLER_DELAY per (client, iteration), drawn from a MIXTURE —
        with probability ``gust_p`` a "storm gust" uniform in
        ``[gust_floor, 1] * cap_s`` (a client effectively down for the
        round), otherwise the Pareto body ``min(cap_s, scale_s *
        Pareto(tail_alpha))``. The gust component keeps the per-round MAX
        over any real cohort near ``cap_s`` with high probability — the
        wall a sync barrier serializes on — while the K fastest draws
        (what a buffered flush waits for) stay near ``scale_s``; a pure
        Pareto tail has the same expectations but seed-to-seed variance
        that would make A/B artifacts flaky. Plus one STRAGGLER_STORM
        marker fault (round 1) the drill consumes so the artifact proves
        the storm fired. Same seed, same schedule — the sync and buffered
        arms of an A/B replay identical delays: the sync arm reads
        iteration r as its protocol round r, the buffered arm as the
        client's r-th pull→train→push loop."""
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        if tail_alpha <= 0 or scale_s <= 0 or cap_s <= 0:
            raise ValueError(
                "tail_alpha, scale_s and cap_s must be positive, got "
                f"{tail_alpha}/{scale_s}/{cap_s}"
            )
        if not 0.0 <= gust_p <= 1.0 or not 0.0 < gust_floor <= 1.0:
            raise ValueError(
                f"gust_p in [0, 1] and gust_floor in (0, 1] required, got "
                f"{gust_p}/{gust_floor}"
            )
        names = sorted(clients)
        if not names:
            raise ValueError("storm needs at least one client")
        faults = [Fault(kind=STRAGGLER_STORM, round=1)]
        for name in names:
            # Per-client stream seeded from (seed, name): a client's delay
            # sequence is independent of cohort size or of the other
            # clients' draw order.
            rng = random.Random(f"{seed}/{name}")
            for it in range(1, n_iterations + 1):
                if rng.random() < gust_p:
                    delay = cap_s * rng.uniform(gust_floor, 1.0)
                else:
                    delay = min(cap_s, scale_s * rng.paretovariate(tail_alpha))
                faults.append(
                    Fault(
                        kind=STRAGGLER_DELAY,
                        round=it,
                        client=name,
                        delay_s=round(delay, 4),
                    )
                )
        return cls(faults)
