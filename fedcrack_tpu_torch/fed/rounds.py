"""The federation round state machine, as a pure transition function.

The counterpart of ``fedcrack_tpu.fed.rounds``: the reference
server's protocol (fl_server.py:45-207) as ``transition(state, event) ->
(new_state, reply)`` over an immutable :class:`ServerState`. Time is a
field of every event (no clock, no threads), so a transport only feeds it.

Status codes keep the reference's vocabulary: ``SW`` (enrolled), ``CTW``
(enrollment closed, late client), ``RESP_ACY`` (update accepted, round
still open), ``RESP_ARY`` (round complete, new weights attached),
``WAIT``/``NOT_WAIT`` (version poll) and ``FIN``; ``REJECTED`` refuses
explicitly. The JAX package's fixes over the reference hold here too: the
round average is broadcast; the update buffer resets every round; a stale
round gets ``REJECTED`` (a late report of a closed round is re-synced with
``NOT_WAIT`` and logged, never averaged); a deadline shrinks the cohort to
the clients that reported, and a deadline with no report re-opens
enrollment; a restarted cohort member (or one dropped by a deadline)
re-enrolls; the log sink is capped per upload and in total and open to
cohort members only; the round closes at a K-of-N quorum; every upload
passes the sanitation gate (decodes, leaf count, shapes, finite) before
the fold; the health ledger scores each flush, and its scores can
quarantine a client out of the fold. A compressed update frame
(``compress/frames.py``) is CRC-checked, pinned to the current model
version, reconstructed against the broadcast weights and validated like a
raw blob, whatever ``sanitize_updates`` says; the round's history counts
its wire bytes and codec. Under ``FedConfig.mode == "buffered"`` the
pulls, the uploads and the passage of time go to FedBuff's handlers
(``fed/buffered.py``) instead of the round barrier.

The server's arithmetic (decode, ledger, fold, FedOpt, encode) runs on the
host in float32 numpy, as the JAX package's does; the server holds no
device state. What the port does not run yet raises at
:func:`initial_state`: secure aggregation and DP noise.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from fedcrack_tpu_torch.compress import frames as wire_frames
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import aggregation as _aggregation
from fedcrack_tpu_torch.fed.algorithms import apply_server_opt, make_server_optimizer
from fedcrack_tpu_torch.fed.pytree import tree_map
from fedcrack_tpu_torch.fed.serialization import (
    tree_from_bytes,
    tree_to_bytes,
    validate_update,
)
from fedcrack_tpu_torch.health import ledger as _health_ledger

# ---- status codes (reference vocabulary) ----
SW = "SW"                # enrolled in this session's cohort
CTW = "CTW"              # enrollment closed; late client turned away
RESP_ACY = "RESP_ACY"    # update accepted; round still collecting
RESP_ARY = "RESP_ARY"    # round aggregated; new weights attached
WAIT = "WAIT"            # poll: round not finished
NOT_WAIT = "NOT_WAIT"    # poll: new round ready; weights attached
FIN = "FIN"              # federation finished
REJECTED = "REJECTED"    # explicit refusal (stale round / unknown client)

PHASE_ENROLL = "enroll"
PHASE_RUNNING = "running"
PHASE_FINISHED = "finished"


# ---- events (client requests + time) ----
@dataclass(frozen=True)
class Ready:
    """Registration request (reference 'R', fl_server.py:152-157).
    ``secagg_seed`` is the client's masking seed, sent in band at enroll;
    the server keeps it only under ``config.secagg``."""
    cname: str
    now: float
    secagg_seed: int | None = None


@dataclass(frozen=True)
class PullWeights:
    """Global-weights fetch (reference UpdateReq type 'P', fl_server.py:159-161)."""
    cname: str
    now: float


@dataclass(frozen=True)
class TrainingNotice:
    """Client began local fit (reference 'T', fl_server.py:162-169)."""
    cname: str
    now: float


@dataclass(frozen=True)
class LogChunk:
    """Client ships a log chunk (reference 'L', fl_server.py:170-175).
    ``offset`` is the chunk's byte position in the file: a resent chunk
    overwrites itself, and ``offset=0`` restarts the upload."""
    cname: str
    title: str
    data: bytes
    now: float
    offset: int = 0


@dataclass(frozen=True)
class TrainDone:
    """Local weights for ``round`` (reference 'D', fl_server.py:176-196).
    ``trace_ctx`` is the sender's wire span context; the transition never
    reads it, the transport links it to the flush span."""
    cname: str
    round: int
    blob: bytes
    num_samples: int
    now: float
    trace_ctx: str = ""


@dataclass(frozen=True)
class VersionPoll:
    """Is the next round ready? (reference VersionReq, fl_server.py:197-207)."""
    cname: str
    model_version: int
    round: int
    now: float


@dataclass(frozen=True)
class Tick:
    """Pure passage of time (enrollment window close, round deadline)."""
    now: float


Event = Ready | PullWeights | TrainingNotice | LogChunk | TrainDone | VersionPoll | Tick


@dataclass(frozen=True)
class Reply:
    status: str
    # config-map payload mirrored from the reference's ReadyRep/UpdateRep
    config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    blob: bytes | None = None
    title: str | None = None


@dataclass(frozen=True)
class ServerState:
    config: FedConfig
    global_blob: bytes                       # serialized model variables (float32)
    phase: str = PHASE_ENROLL
    enroll_opened_at: float | None = None
    cohort: frozenset[str] = frozenset()
    current_round: int = 1
    model_version: int = 0
    round_started_at: float | None = None
    # client -> (weights blob, sample count), for the current round only
    received: Mapping[str, tuple[bytes, int]] = dataclasses.field(default_factory=dict)
    # client log sink: "cname/title" -> accumulated bytes
    logs: Mapping[str, bytes] = dataclasses.field(default_factory=dict)
    history: tuple[dict, ...] = ()
    # FedOpt state (a tuple of numpy trees); None for plain FedAvg, set at
    # the first aggregation.
    server_opt_state: Any = None
    # Float32 numpy tree that uploads decode against, so the server's math
    # stays full precision whatever the wire dtype.
    template: Any = None
    # The blob broadcast to clients: global_blob for a float32 wire, or its
    # bfloat16 re-encoding when config.wire_dtype == "bfloat16".
    wire_blob: bytes = b""
    # Rounds that expired with zero reports and re-opened enrollment.
    failed_rounds: int = 0
    # Cohort members dropped by a deadline shrink; a departed member that
    # restarts may re-admit itself via Ready.
    departed: frozenset[str] = frozenset()
    # Updates refused for this round (cname -> reason), folded into the
    # round's history entry at aggregation.
    rejected: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # Per client this round: the bytes that crossed the wire and the codec.
    wire_bytes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    codecs: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # Buffered mode only (fed/buffered.py), empty in sync mode: the version
    # each client last pulled (its next upload's base), the accepted but
    # unflushed updates, and the broadcast blobs of the last max_staleness
    # versions (stale framed deltas decode against them). The statefile
    # keeps all three, so a server killed mid-buffer resumes bit-exactly.
    pulled: Mapping[str, int] = dataclasses.field(default_factory=dict)
    buffer: tuple = ()
    base_blobs: Mapping[int, bytes] = dataclasses.field(default_factory=dict)
    # Per-client health ledger (health/ledger.py), changed only through
    # its pure helpers.
    ledger: Mapping[str, dict] = dataclasses.field(default_factory=dict)
    # Masking seeds received at enroll under config.secagg.
    secagg_seeds: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def broadcast_blob(self) -> bytes:
        return self.wire_blob or self.global_blob

    def _replace(self, **kw) -> "ServerState":
        return dataclasses.replace(self, **kw)


# One-entry memo of the decoded round base (the broadcast tree every
# upload's ledger norm is taken against), keyed on the broadcast bytes
# themselves (identity, then equality), never on a hash: a collision
# between two servers' blobs in this process-wide memo would score an
# update against the wrong base. Concurrent servers in one process at
# worst thrash the entry and decode again.
_ROUND_BASE_MEMO: dict = {}


def _decoded_round_base(state: ServerState):
    blob = state.broadcast_blob
    hit = _ROUND_BASE_MEMO.get("base")
    if (
        hit is not None
        and hit[0] == state.model_version
        and (hit[1] is blob or hit[1] == blob)
    ):
        return hit[2]
    tree = tree_from_bytes(blob, template=state.template)
    _ROUND_BASE_MEMO["base"] = (state.model_version, blob, tree)
    return tree


def decode_and_validate_update(
    blob: bytes,
    num_samples: int,
    *,
    template: Any,
    base_fn,
    base_version: int,
    sanitize: bool,
) -> tuple[bytes, int, str, str | None, float | None]:
    """The upload acceptance gate. Returns ``(blob, wire_len, codec_name,
    problem, norm)``: ``problem`` is the reason to reject (never
    aggregate) or None; on acceptance ``blob`` is the full tree's msgpack
    bytes (re-encoded for a frame) and ``norm`` the update's L2 distance
    to ``base_fn()`` (the decoded broadcast tree; a callable so callers
    keep their memo), None where nothing was decoded.

    A compressed frame is CRC-checked, pinned to ``base_version``,
    reconstructed against ``base_fn()`` and validated, whatever
    ``sanitize`` says: a CRC-valid frame can still carry a poisoned
    trainer's NaNs. A raw blob is validated when ``sanitize`` is on.
    """
    wire_len = len(blob)
    codec_name = "null"
    problem = None
    norm = None
    if wire_frames.is_frame(blob):
        if template is None:
            problem = "compressed frame rejected: server has no decode template"
        else:
            try:
                tree, frame = wire_frames.decode_update(
                    blob,
                    template=template,
                    base=base_fn(),
                    expected_base_version=base_version,
                )
            except ValueError as e:
                problem = f"compressed frame rejected: {e}"
            else:
                codec_name = frame.codec
                # The reconstruction is validated as a tree and encoded
                # once, for storage, only when it passes.
                problem = validate_update(tree, template)
                if problem is None:
                    blob = tree_to_bytes(tree)
                    norm = _health_ledger.update_norm(tree, base_fn())
        if problem is None and num_samples < 0:
            problem = f"negative sample count {num_samples}"
    elif sanitize:
        if num_samples < 0:
            problem = f"negative sample count {num_samples}"
        elif template is not None:
            problem = validate_update(blob, template)
            if problem is None:
                norm = _health_ledger.update_norm(
                    tree_from_bytes(blob, template=template), base_fn()
                )
    if problem is not None:
        norm = None
    return blob, wire_len, codec_name, problem, norm


def drop_log(state: ServerState, cname: str, title: str) -> ServerState:
    """Forget an accumulated upload (called after a transport flushes it
    to disk, so server memory does not grow with every upload)."""
    key = f"{cname}/{title}"
    if key not in state.logs:
        return state
    logs = dict(state.logs)
    del logs[key]
    return state._replace(logs=logs)


def _wire_cast(config: FedConfig) -> str | None:
    return "bfloat16" if config.wire_dtype == "bfloat16" else None


def _refuse_unported(config: FedConfig) -> None:
    if config.secagg:
        raise NotImplementedError(
            "secagg=True is not ported yet: privacy/secagg.py, ROADMAP Queue 1 item 3"
        )
    if config.dp_noise_multiplier > 0.0:
        raise NotImplementedError(
            "dp_noise_multiplier > 0 is not ported yet: the privacy accountant "
            "(privacy/accountant.py), ROADMAP Queue 1 item 3"
        )


def _host_numpy(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, np.generic):
        return np.asarray(leaf)
    return leaf


def initial_state(config: FedConfig, global_variables: Any) -> ServerState:
    """Server boot: serialize the initial global model (numpy or torch
    leaves); raises ``NotImplementedError`` for a configuration this
    machine does not run."""
    _refuse_unported(config)
    cast = _wire_cast(config)
    blob = tree_to_bytes(global_variables)
    wire_blob = tree_to_bytes(global_variables, cast_dtype=cast) if cast else b""
    return ServerState(
        config=config,
        global_blob=blob,
        template=tree_map(_host_numpy, global_variables),
        wire_blob=wire_blob,
        # Buffered mode decodes stale deltas against retained broadcasts;
        # version 0's is the boot blob.
        base_blobs={0: wire_blob or blob} if config.mode == "buffered" else {},
    )


def _ready_config(state: ServerState, status: str) -> dict[str, Any]:
    """The handshake config map (reference keys, fl_server.py:69-75) plus
    the round's training hyperparameters, which configure the cohort in
    band; the same keys as the JAX package's map."""
    return {
        "state": status,
        "model_version": state.model_version,
        "current_round": state.current_round,
        "max_train_round": state.config.max_rounds,
        "model_type": state.config.model_type,
        "local_epochs": state.config.local_epochs,
        "learning_rate": state.config.learning_rate,
        "fedprox_mu": state.config.fedprox_mu,
        "pos_weight": state.config.pos_weight,
        "wire_dtype": state.config.wire_dtype,
        "update_codec": state.config.update_codec,
        "topk_fraction": state.config.topk_fraction,
        "mode": state.config.mode,
        "secagg": state.config.secagg,
        "secagg_bits": state.config.secagg_bits,
    }


def quorum_target(quorum_fraction: float, cohort_size: int) -> int:
    """K of the K-of-N barrier: ceil(quorum_fraction * N), at least one.
    The epsilon keeps float products like 0.6 * 5 = 3.0000000000000004
    from ceiling into an extra required client."""
    return max(1, math.ceil(quorum_fraction * cohort_size - 1e-9))


def _quorum_target(state: ServerState) -> int:
    return quorum_target(state.config.quorum_fraction, len(state.cohort))


def _barrier_met(state: ServerState) -> bool:
    return (
        state.phase == PHASE_RUNNING
        and bool(state.cohort)
        and len(state.received) >= _quorum_target(state)
    )


def _start_running(state: ServerState, now: float) -> ServerState:
    return state._replace(phase=PHASE_RUNNING, round_started_at=now)


def _advance_time(state: ServerState, now: float) -> ServerState:
    """Apply pure time effects: enrollment close, round deadline."""
    # A restored state carries no timestamps: both windows re-arm from the
    # first event the server sees.
    if state.phase == PHASE_RUNNING and state.round_started_at is None:
        state = state._replace(round_started_at=now)
    if (
        state.phase == PHASE_ENROLL
        and state.cohort
        and state.enroll_opened_at is None
    ):
        state = state._replace(enroll_opened_at=now)
    if (
        state.phase == PHASE_ENROLL
        and state.enroll_opened_at is not None
        and now - state.enroll_opened_at >= state.config.registration_window_s
        and state.cohort
    ):
        state = _start_running(state, now)
        # fast clients may have reported while enrollment was still open
        if _barrier_met(state):
            state = _aggregate(state, now)
    if state.config.mode == "buffered":
        # The buffer is the quorum: the deadline becomes FedBuff's flush
        # backstop, and there is no cohort to shrink.
        from fedcrack_tpu_torch.fed.buffered import BufferedAggregator

        return BufferedAggregator.advance_time(state, now)
    if (
        state.phase == PHASE_RUNNING
        and state.config.round_deadline_s > 0
        and state.round_started_at is not None
        # both time windows close at the boundary instant
        and now - state.round_started_at >= state.config.round_deadline_s
        and len(state.received) < _quorum_target(state)
    ):
        if state.received:
            # Aggregate over who reported; the missing clients leave the
            # cohort but are remembered, so a restart can re-admit them.
            reported = frozenset(state.received.keys())
            state = state._replace(
                cohort=reported,
                departed=state.departed | (state.cohort - reported),
            )
            state = _aggregate(state, now)
        else:
            # Every enrolled client died before reporting: re-open
            # enrollment at the same round, global weights kept.
            state = state._replace(
                phase=PHASE_ENROLL,
                cohort=frozenset(),
                departed=state.departed | state.cohort,
                enroll_opened_at=None,
                round_started_at=None,
                failed_rounds=state.failed_rounds + 1,
            )
    return state


def apply_fedopt(state: ServerState, avg: Any) -> tuple[Any, Any]:
    """The FedOpt server step on an aggregated tree. Returns ``(avg,
    opt_state)``; plain FedAvg passes ``avg`` through untouched."""
    opt_state = state.server_opt_state
    tx = make_server_optimizer(
        state.config.server_optimizer,
        state.config.server_lr,
        state.config.server_momentum,
    )
    if tx is not None and "params" in avg:
        current = tree_from_bytes(state.global_blob, template=state.template)
        if opt_state is None:
            opt_state = tx.init(current["params"])
        new_params, opt_state = apply_server_opt(
            current["params"], avg["params"], tx, opt_state
        )
        avg = dict(avg)
        avg["params"] = new_params  # BN stats keep the plain average
    return avg, opt_state


def _aggregate(state: ServerState, now: float) -> ServerState:
    """Score the round's updates in the health ledger, leave out the
    quarantined ones, fold the rest through the configured algebra in
    sorted client order, apply FedOpt, and advance round and version."""
    names = sorted(state.received.keys())
    counts = [state.received[n][1] for n in names]
    # Decode against the float32 template, whatever the wire dtype.
    trees = [
        tree_from_bytes(state.received[n][0], template=state.template)
        for n in names
    ]
    new_ledger, scores = _health_ledger.observe_flush(
        state.ledger,
        list(zip(names, trees)),
        _decoded_round_base(state),
    )
    quarantined = _aggregation.quarantine_set(
        scores, names, state.config.quarantine_z
    )
    for qname in quarantined:
        new_ledger = _health_ledger.record_quarantine(new_ledger, qname)
    triples = [
        (n, c, t)
        for n, c, t in zip(names, counts, trees)
        if n not in quarantined
    ]
    avg = _aggregation.fold(_aggregation.from_config(state.config), triples)
    avg, opt_state = apply_fedopt(state, avg)
    new_blob = tree_to_bytes(avg)
    cast = _wire_cast(state.config)
    new_wire_blob = tree_to_bytes(avg, cast_dtype=cast) if cast else b""
    new_round = state.current_round + 1
    finished = new_round > state.config.max_rounds
    entry = {
        "round": state.current_round,
        "clients": names,
        "samples": counts,
        "completed_at": now,
        "wall_clock_s": (
            now - state.round_started_at if state.round_started_at is not None else None
        ),
        # bytes that crossed the wire, and after decode (equal for raw blobs)
        "bytes_received": sum(
            state.wire_bytes.get(n, len(state.received[n][0])) for n in names
        ),
        "decoded_bytes_received": sum(len(state.received[n][0]) for n in names),
        "codecs": {n: state.codecs.get(n, "null") for n in names},
        "bytes_broadcast": len(new_wire_blob or new_blob),
        "quorum": _quorum_target(state),
        "cohort_size": len(state.cohort),
        "rejected": dict(state.rejected),
        # name -> the robust-z score that left it out of the fold
        "quarantined": quarantined,
    }
    return state._replace(
        ledger=new_ledger,
        global_blob=new_blob,
        wire_blob=new_wire_blob,
        current_round=new_round,
        model_version=state.model_version + 1,
        received={},
        rejected={},
        wire_bytes={},
        codecs={},
        round_started_at=now,
        phase=PHASE_FINISHED if finished else PHASE_RUNNING,
        history=state.history + (entry,),
        server_opt_state=opt_state,
    )


def transition(state: ServerState, event: Event) -> tuple[ServerState, Reply]:
    """The protocol. Dispatch mirrors the reference's manage_request table
    (fl_server.py:152-207)."""
    state = _advance_time(state, event.now)

    match event:
        case Tick():
            return state, Reply(status=state.phase)

        case Ready(cname=cname, now=now):
            if state.config.secagg and event.secagg_seed is not None:
                # Idempotent across re-enrolls.
                state = state._replace(
                    secagg_seeds={
                        **state.secagg_seeds, cname: int(event.secagg_seed)
                    }
                )
            if state.phase == PHASE_FINISHED:
                return state, Reply(status=FIN, config=_ready_config(state, FIN))
            if state.phase == PHASE_RUNNING:
                if cname in state.cohort:
                    # A restarted cohort member: re-sync it with the current
                    # round and drop its pre-crash report, so a barrier
                    # completed by the stale blob cannot advance the round
                    # underneath it.
                    if cname in state.received:
                        received = dict(state.received)
                        del received[cname]
                        wire = {
                            k: v for k, v in state.wire_bytes.items() if k != cname
                        }
                        codecs = {
                            k: v for k, v in state.codecs.items() if k != cname
                        }
                        state = state._replace(
                            received=received, wire_bytes=wire, codecs=codecs
                        )
                    return state, Reply(status=SW, config=_ready_config(state, SW))
                if cname in state.departed:
                    # Dropped by a deadline shrink, now back: re-admit.
                    state = state._replace(
                        cohort=state.cohort | {cname},
                        departed=state.departed - {cname},
                    )
                    return state, Reply(status=SW, config=_ready_config(state, SW))
                # enrollment closed: late client turned away (fl_server.py:78-81)
                return state, Reply(status=CTW, config=_ready_config(state, CTW))
            opened = state.enroll_opened_at if state.enroll_opened_at is not None else now
            # Cohort and departed stay disjoint.
            state = state._replace(
                enroll_opened_at=opened,
                cohort=state.cohort | {cname},
                departed=state.departed - {cname},
            )
            # target cohort reached: close enrollment early
            if len(state.cohort) >= state.config.cohort_size:
                state = _start_running(state, now)
            return state, Reply(status=SW, config=_ready_config(state, SW))

        case PullWeights(cname=cname):
            # The current global: after round R, the round-R average. The
            # config map names its version, the base a buffered client's
            # upload is pinned to.
            if state.config.mode == "buffered":
                from fedcrack_tpu_torch.fed.buffered import BufferedAggregator

                state = BufferedAggregator.record_pull(state, cname)
            return state, Reply(
                status="OK",
                blob=state.broadcast_blob,
                title="parameters",
                config=_ready_config(state, "OK"),
            )

        case TrainingNotice():
            return state, Reply(status="OK", title="T")

        case LogChunk(cname=cname, title=title, data=data, offset=offset):
            # Only cohort members may write into the sink, or anyone could
            # fill the total cap and deny legitimate uploads.
            if cname not in state.cohort:
                return state, Reply(
                    status=REJECTED, title="log upload: not in cohort"
                )
            key = f"{cname}/{title}"
            logs = dict(state.logs)
            buf = logs.get(key, b"")
            if offset > len(buf):
                return state, Reply(
                    status=REJECTED,
                    title=f"log chunk gap: offset {offset}, have {len(buf)}",
                )
            new_buf = buf[:offset] + data
            per_cap = state.config.log_max_mb_per_upload * 1024 * 1024
            if per_cap > 0 and len(new_buf) > per_cap:
                return state, Reply(
                    status=REJECTED,
                    title=(
                        f"log upload {title!r} over per-upload cap: "
                        f"{len(new_buf)} > {per_cap} bytes"
                    ),
                )
            total_cap = state.config.log_max_mb_total * 1024 * 1024
            total = len(new_buf) + sum(
                len(v) for k, v in logs.items() if k != key
            )
            if total_cap > 0 and total > total_cap:
                return state, Reply(
                    status=REJECTED,
                    title=(
                        f"log sink over total cap: {total} > {total_cap} bytes"
                    ),
                )
            logs[key] = new_buf
            return state._replace(logs=logs), Reply(status="OK", title=title)

        case TrainDone(cname=cname, round=rnd, blob=blob, num_samples=ns, now=now):
            if state.phase == PHASE_FINISHED:
                return state, Reply(
                    status=FIN,
                    blob=state.broadcast_blob,
                    config=_ready_config(state, FIN),
                )
            if state.config.mode == "buffered":
                # No round matching: the version the client pulled gates
                # and weighs its update.
                from fedcrack_tpu_torch.fed.buffered import BufferedAggregator

                return BufferedAggregator.offer(state, event)
            if cname not in state.cohort:
                # Ledger-feed only for names already seen (an unknown-name
                # flood must not grow the ledger).
                if cname in state.ledger:
                    state = state._replace(
                        ledger=_health_ledger.record_offer(
                            state.ledger, cname, outcome="rejected",
                            reason_class="not_in_cohort", round=rnd,
                        )
                    )
                return state, Reply(
                    status=REJECTED, config={"reason": "not in cohort"}
                )
            if rnd < state.current_round:
                # A report for a closed round (a straggler past the quorum
                # or deadline, or a replay): never averaged; logged, and the
                # sender re-synced with the current round and weights.
                reason = f"stale round {rnd} (server at {state.current_round})"
                rejected = dict(state.rejected)
                rejected[cname] = reason
                state = state._replace(
                    rejected=rejected,
                    ledger=_health_ledger.record_offer(
                        state.ledger, cname, outcome="resync",
                        num_samples=ns, round=rnd,
                        staleness=state.current_round - rnd,
                    ),
                )
                return state, Reply(
                    status=NOT_WAIT,
                    blob=state.broadcast_blob,
                    config=_ready_config(state, NOT_WAIT),
                )
            if rnd != state.current_round:
                # A future round: a protocol violation.
                state = state._replace(
                    ledger=_health_ledger.record_offer(
                        state.ledger, cname, outcome="rejected",
                        reason_class="stale", round=rnd,
                    )
                )
                return state, Reply(
                    status=REJECTED,
                    config={
                        "reason": "stale round",
                        "client_round": rnd,
                        "server_round": state.current_round,
                    },
                )
            blob, wire_len, codec_name, problem, norm = decode_and_validate_update(
                blob,
                ns,
                template=state.template,
                base_fn=lambda: _decoded_round_base(state),
                base_version=state.model_version,
                sanitize=state.config.sanitize_updates,
            )
            if problem is not None:
                # Refused before it can touch the fold; recorded in the
                # round's history entry.
                rejected = dict(state.rejected)
                rejected[cname] = problem
                state = state._replace(
                    rejected=rejected,
                    ledger=_health_ledger.record_offer(
                        state.ledger, cname, outcome="rejected",
                        reason_class="sanitation", num_samples=ns,
                        wire_len=wire_len, round=rnd,
                    ),
                )
                return state, Reply(
                    status=REJECTED,
                    config={
                        "reason": f"update rejected: {problem}",
                        "client_round": rnd,
                    },
                )
            # Updates arriving while enrollment is open are kept but never
            # trigger aggregation: the cohort is not final yet.
            received = dict(state.received)
            received[cname] = (blob, ns)
            wire = dict(state.wire_bytes)
            wire[cname] = wire_len
            codecs = dict(state.codecs)
            codecs[cname] = codec_name
            state = state._replace(
                received=received, wire_bytes=wire, codecs=codecs,
                ledger=_health_ledger.record_offer(
                    state.ledger, cname, outcome="accepted", num_samples=ns,
                    wire_len=wire_len, round=rnd, norm=norm,
                ),
            )
            if _barrier_met(state):
                state = _aggregate(state, now)
                if cname in state.history[-1]["quarantined"]:
                    # The barrier-closing client was quarantined out of the
                    # fold it triggered: re-sync it instead of a RESP_ARY
                    # that claims its update was averaged.
                    return state, Reply(
                        status=NOT_WAIT,
                        blob=state.broadcast_blob,
                        config=_ready_config(state, NOT_WAIT),
                    )
                status = FIN if state.phase == PHASE_FINISHED else RESP_ARY
                return state, Reply(
                    status=status,
                    blob=state.broadcast_blob,
                    config=_ready_config(state, status),
                )
            return state, Reply(status=RESP_ACY, config=_ready_config(state, RESP_ACY))

        case VersionPoll(model_version=mv):
            if state.phase == PHASE_FINISHED:
                # FIN carries the final average
                return state, Reply(
                    status=FIN,
                    blob=state.broadcast_blob,
                    config=_ready_config(state, FIN),
                )
            if state.model_version > mv:
                return state, Reply(
                    status=NOT_WAIT,
                    blob=state.broadcast_blob,
                    config=_ready_config(state, NOT_WAIT),
                )
            return state, Reply(status=WAIT, config=_ready_config(state, WAIT))

    raise TypeError(f"unknown event {event!r}")
