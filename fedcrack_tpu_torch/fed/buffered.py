"""FedBuff: buffered-asynchronous aggregation.

The counterpart of ``fedcrack_tpu.fed.buffered``. The server accepts
updates as they arrive, weights each by the polynomial staleness decay
``(1 + s)^-alpha`` (FedAsync), holds them in a K-sized buffer and flushes
a new global version at K. Clients loop pull -> train -> push; a slow
client's update lands late and down-weighted, never blocking the others.
``fed.rounds.transition`` dispatches ``PullWeights``, ``TrainDone`` and the
passage of time here when ``FedConfig.mode == "buffered"``, over the same
immutable ``ServerState``.

What holds, as in the JAX package:

- every accepted update passes the shared acceptance gate
  (``rounds.decode_and_validate_update``), decoded against the base the
  client pulled: the server records each client's pulled version and
  keeps the last ``max_staleness`` broadcasts, so a stale framed delta
  reconstructs against its own base or is resynced;
- the flush sorts the buffer by ``(cname, seq)``, so the new global is a
  function of the buffer's contents, never of arrival order;
- ``buffer_k == cohort_size`` with ``staleness_alpha == 0`` is bit for bit
  a sync FedAvg round: each weight ``ns * 1.0`` is ``ns`` as the same
  Python float, the fold is the same host ``fedavg`` over the same decoded
  trees, and FedOpt is the shared ``rounds.apply_fedopt``;
- the buffer, the pulled versions and the retained bases live on
  ``ServerState`` and in the statefile, so a server killed mid-buffer
  resumes with the accepted updates and flushes the same next global.

Each flush appends a history entry with ``updates_per_sec``,
``buffer_fill``, the per-update ``staleness`` and ``global_version``;
:func:`async_summary` reduces a history to staleness percentiles.
"""

from __future__ import annotations

import numpy as np

from fedcrack_tpu_torch.fed import aggregation as _aggregation
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.fed.pytree import tree_map
from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
from fedcrack_tpu_torch.health import ledger as _health_ledger

MODE_BUFFERED = "buffered"


def staleness_weight(staleness: int, alpha: float) -> float:
    """The FedAsync decay ``(1 + staleness)^-alpha``, a Python float.
    ``alpha == 0`` gives exactly 1.0 for every staleness, which keeps the
    sync degeneration bit-exact."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if alpha < 0.0:
        raise ValueError(f"staleness alpha must be >= 0, got {alpha}")
    return float((1.0 + float(staleness)) ** (-float(alpha)))


def _entry_sort_key(entry: dict) -> tuple:
    """The flush order ``(cname, seq)``; ``seq`` counts a client's own
    entries in the current buffer, so the key does not depend on how
    different clients' uploads interleaved."""
    return (entry["cname"], entry["seq"])


def buffer_entry_to_wire(e: dict) -> list:
    """A buffer entry as the statefile's nine-field row."""
    return [
        e["cname"], int(e["seq"]), e["blob"], int(e["ns"]),
        int(e["staleness"]), float(e["weight"]), int(e["base_version"]),
        int(e["wire_len"]), e["codec"],
    ]


def buffer_entry_from_wire(row) -> dict:
    return {
        "cname": str(row[0]),
        "seq": int(row[1]),
        "blob": bytes(row[2]),
        "ns": int(row[3]),
        "staleness": int(row[4]),
        "weight": float(row[5]),
        "base_version": int(row[6]),
        "wire_len": int(row[7]),
        "codec": str(row[8]),
    }


def decode_buffer(buffer, template) -> tuple:
    """The buffer sorted by ``(cname, seq)`` and decoded against
    ``template``: ``(entries, counts, effective weights, trees)``, aligned."""
    if not buffer:
        raise RuntimeError("fold of an empty buffer")
    entries = sorted(buffer, key=_entry_sort_key)
    trees = [tree_from_bytes(e["blob"], template=template) for e in entries]
    counts = [e["ns"] for e in entries]
    eff = [e["ns"] * e["weight"] for e in entries]
    return entries, counts, eff, trees


def fold_buffer(buffer, template) -> tuple:
    """The staleness-weighted sorted FedAvg of the buffer, with effective
    weight ``ns * staleness_weight``. Returns ``(avg, entries, counts,
    eff, trees)``."""
    entries, counts, eff, trees = decode_buffer(buffer, template)
    triples = [(e["cname"], w, t) for e, w, t in zip(entries, eff, trees)]
    avg = _aggregation.fold(_aggregation.FedAvg(), triples)
    return avg, entries, counts, eff, trees


# Decoded retained bases for the accept path: version -> (blob, tree),
# keyed on the version and the blob bytes themselves (identity, then
# equality), so servers sharing this process-wide memo at worst decode
# again. Pruned to the caller's retained window on every miss.
_BASE_TREE_MEMO: dict = {}


def _decoded_base(state: R.ServerState, version: int, blob: bytes):
    hit = _BASE_TREE_MEMO.get(version)
    if hit is not None and (hit[0] is blob or hit[0] == blob):
        return hit[1]
    tree = tree_from_bytes(blob, template=state.template)
    _BASE_TREE_MEMO[version] = (blob, tree)
    for v in sorted(_BASE_TREE_MEMO):
        if v not in state.base_blobs:
            del _BASE_TREE_MEMO[v]
    return tree


class BufferedAggregator:
    """The buffered-mode handlers, pure transitions over ``ServerState``
    (``rounds.transition`` is their only caller). State: ``pulled``
    (client -> the version it last pulled), ``buffer`` (accepted, not yet
    flushed entries: ``cname, seq, blob, ns, staleness, weight,
    base_version, wire_len, codec``) and ``base_blobs`` (version -> the
    broadcast blob, for the last ``max_staleness`` versions)."""

    @staticmethod
    def record_pull(state: R.ServerState, cname: str) -> R.ServerState:
        """Remember the version ``cname`` now holds: its next upload's base
        and the anchor of its staleness."""
        pulled = dict(state.pulled)
        pulled[cname] = state.model_version
        return state._replace(pulled=pulled)

    @staticmethod
    def offer(state: R.ServerState, event: R.TrainDone) -> tuple[R.ServerState, R.Reply]:
        """One upload: decoded against the base the client pulled,
        staleness-gated and weighted, buffered, and flushed at
        ``buffer_k``. A sanitation failure is REJECTED; a too-stale or
        base-less update is recorded in ``rejected`` and its sender
        resynced with the current global (NOT_WAIT), never averaged."""
        cname, ns, now = event.cname, event.num_samples, event.now
        if cname not in state.cohort:
            if cname in state.ledger:
                state = state._replace(
                    ledger=_health_ledger.record_offer(
                        state.ledger, cname, outcome="rejected",
                        reason_class="not_in_cohort", round=state.current_round,
                    )
                )
            return state, R.Reply(status=R.REJECTED, config={"reason": "not in cohort"})
        cfg = state.config
        base_version = state.pulled.get(cname)
        if base_version is None:
            # Nothing to decode or weigh this update against: the client
            # pulls fresh and trains again.
            return BufferedAggregator._resync(
                state, cname, "no recorded base version (pull before push)"
            )
        staleness = state.model_version - int(base_version)
        if staleness > cfg.max_staleness:
            return BufferedAggregator._resync(
                state,
                cname,
                f"too stale: base version {base_version} is {staleness} "
                f"behind (max_staleness={cfg.max_staleness})",
                staleness=staleness,
            )
        base_blob = state.base_blobs.get(int(base_version))
        if base_blob is None:
            # Inside the window but not retained (a config change, or a
            # snapshot older than the buffered fields): treated as too stale.
            return BufferedAggregator._resync(
                state, cname, f"base version {base_version} no longer retained"
            )
        blob, wire_len, codec_name, problem, norm = R.decode_and_validate_update(
            event.blob,
            ns,
            template=state.template,
            base_fn=lambda: _decoded_base(state, int(base_version), base_blob),
            base_version=int(base_version),
            sanitize=cfg.sanitize_updates,
        )
        if problem is not None:
            rejected = dict(state.rejected)
            rejected[cname] = problem
            state = state._replace(
                rejected=rejected,
                ledger=_health_ledger.record_offer(
                    state.ledger, cname, outcome="rejected",
                    reason_class="sanitation", num_samples=ns,
                    wire_len=wire_len, round=state.current_round,
                    staleness=staleness,
                ),
            )
            return state, R.Reply(
                status=R.REJECTED, config={"reason": f"update rejected: {problem}"}
            )
        seq = sum(1 for e in state.buffer if e["cname"] == cname)
        entry = {
            "cname": cname,
            "seq": seq,
            "blob": blob,
            "ns": int(ns),
            "staleness": int(staleness),
            "weight": staleness_weight(staleness, cfg.staleness_alpha),
            "base_version": int(base_version),
            "wire_len": int(wire_len),
            "codec": codec_name,
        }
        state = state._replace(
            buffer=state.buffer + (entry,),
            ledger=_health_ledger.record_offer(
                state.ledger, cname, outcome="accepted", num_samples=ns,
                wire_len=wire_len, round=state.current_round,
                staleness=staleness, norm=norm,
            ),
        )
        if state.phase == R.PHASE_RUNNING and len(state.buffer) >= cfg.buffer_k:
            state = BufferedAggregator.flush(state, now)
            # The reply carries the new global: the sender now holds it.
            state = BufferedAggregator.record_pull(state, cname)
            if cname in state.history[-1]["quarantined"]:
                # Quarantined out of the flush it triggered: NOT_WAIT, so a
                # top-k sender rolls its residual back.
                return state, R.Reply(
                    status=R.NOT_WAIT,
                    blob=state.broadcast_blob,
                    config=R._ready_config(state, R.NOT_WAIT),
                )
            status = R.FIN if state.phase == R.PHASE_FINISHED else R.RESP_ARY
            return state, R.Reply(
                status=status,
                blob=state.broadcast_blob,
                config=R._ready_config(state, status),
            )
        return state, R.Reply(status=R.RESP_ACY, config=R._ready_config(state, R.RESP_ACY))

    @staticmethod
    def _resync(
        state: R.ServerState, cname: str, reason: str, staleness: int = 0
    ) -> tuple[R.ServerState, R.Reply]:
        """Record the refusal and hand the sender the current global."""
        rejected = dict(state.rejected)
        rejected[cname] = reason
        state = state._replace(
            rejected=rejected,
            ledger=_health_ledger.record_offer(
                state.ledger, cname, outcome="resync",
                round=state.current_round, staleness=staleness,
            ),
        )
        state = BufferedAggregator.record_pull(state, cname)
        return state, R.Reply(
            status=R.NOT_WAIT,
            blob=state.broadcast_blob,
            config=R._ready_config(state, R.NOT_WAIT),
        )

    @staticmethod
    def flush(state: R.ServerState, now: float) -> R.ServerState:
        """Fold the buffer into a new global version.

        The ledger scores the decoded trees against the current global and
        may quarantine entries out of the fold; the kept entries fold
        through the configured algebra in ``(cname, seq)`` order with
        weight ``ns * staleness_weight``. The mean is then anchored on the
        current global, ``(1 - mix) * current + mix * mean``, with ``mix``
        the sample-weighted mean staleness weight of the kept entries, so a
        stale-dominated flush cannot replace the global. An all-fresh
        buffer has ``mix == 1.0`` exactly and skips the anchor. FedOpt and
        the history's shape follow ``rounds._aggregate``.
        """
        entries, counts, eff, trees = decode_buffer(state.buffer, state.template)
        new_ledger, scores = _health_ledger.observe_flush(
            state.ledger,
            [(e["cname"], t) for e, t in zip(entries, trees)],
            tree_from_bytes(state.global_blob, template=state.template),
        )
        quarantined = _aggregation.quarantine_set(
            scores, [e["cname"] for e in entries], state.config.quarantine_z
        )
        for qname in sorted(quarantined):
            new_ledger = _health_ledger.record_quarantine(new_ledger, qname)
        keep = [i for i, e in enumerate(entries) if e["cname"] not in quarantined]
        avg = _aggregation.fold(
            _aggregation.from_config(state.config),
            [(entries[i]["cname"], eff[i], trees[i]) for i in keep],
        )
        kept_counts = [counts[i] for i in keep]
        kept_eff = [eff[i] for i in keep]
        mix = 1.0
        total_ns = float(sum(kept_counts))
        if any(c > 0 for c in kept_counts):
            mix = float(sum(kept_eff)) / total_ns
        if mix < 1.0:
            current = tree_from_bytes(state.global_blob, template=state.template)
            old, new = np.float32(1.0 - mix), np.float32(mix)
            avg = tree_map(
                lambda c, u: old * np.asarray(c, np.float32) + new * np.asarray(u, np.float32),
                current,
                avg,
            )
        avg, opt_state = R.apply_fedopt(state, avg)
        new_blob = tree_to_bytes(avg)
        cast = R._wire_cast(state.config)
        new_wire_blob = tree_to_bytes(avg, cast_dtype=cast) if cast else b""
        new_version = state.model_version + 1
        new_round = state.current_round + 1
        finished = new_round > state.config.max_rounds
        wall = now - state.round_started_at if state.round_started_at is not None else None
        entry = {
            "round": state.current_round,
            "mode": MODE_BUFFERED,
            "clients": [e["cname"] for e in entries],
            "samples": counts,
            "staleness": [e["staleness"] for e in entries],
            "weights": [e["weight"] for e in entries],
            "mix": mix,
            "buffer_fill": len(entries),
            "global_version": new_version,
            "completed_at": now,
            "wall_clock_s": wall,
            "updates_per_sec": len(entries) / wall if wall is not None and wall > 0 else None,
            "bytes_received": sum(e["wire_len"] for e in entries),
            "decoded_bytes_received": sum(len(e["blob"]) for e in entries),
            "codecs": [e["codec"] for e in entries],
            "bytes_broadcast": len(new_wire_blob or new_blob),
            "cohort_size": len(state.cohort),
            "rejected": dict(state.rejected),
            # name -> the robust-z score that left it out of the fold; the
            # lists above keep what the buffer held.
            "quarantined": quarantined,
        }
        # The retained window: the new broadcast joins, versions more than
        # max_staleness behind leave.
        bases = {
            v: b
            for v, b in sorted(state.base_blobs.items())
            if new_version - v <= state.config.max_staleness
        }
        bases[new_version] = new_wire_blob or new_blob
        return state._replace(
            ledger=new_ledger,
            global_blob=new_blob,
            wire_blob=new_wire_blob,
            current_round=new_round,
            model_version=new_version,
            buffer=(),
            rejected={},
            base_blobs=bases,
            round_started_at=now,
            phase=R.PHASE_FINISHED if finished else R.PHASE_RUNNING,
            history=state.history + (entry,),
            server_opt_state=opt_state,
        )

    @staticmethod
    def advance_time(state: R.ServerState, now: float) -> R.ServerState:
        """Buffered time effects, after the shared enrollment machinery: a
        buffer that filled while enrollment was open flushes once running,
        and ``round_deadline_s`` becomes the flush backstop (a partial
        buffer older than the deadline flushes; an empty one re-arms)."""
        cfg = state.config
        if state.phase != R.PHASE_RUNNING:
            return state
        if state.buffer and len(state.buffer) >= cfg.buffer_k:
            return BufferedAggregator.flush(state, now)
        if (
            cfg.round_deadline_s > 0
            and state.round_started_at is not None
            and now - state.round_started_at >= cfg.round_deadline_s
        ):
            if state.buffer:
                return BufferedAggregator.flush(state, now)
            return state._replace(round_started_at=now)
        return state


def async_summary(history: tuple) -> dict:
    """A buffered history's headline numbers: accepted updates, global
    versions, the staleness distribution (through a seeded reservoir,
    exact below its capacity) and the mean buffer fill. Sync entries (no
    ``buffer_fill``) are skipped."""
    from fedcrack_tpu_torch.obs.metrics import StreamingPercentiles

    stale = StreamingPercentiles(seed=0)
    updates = 0
    fills = []
    versions = 0
    for h in history:
        if "buffer_fill" not in h:
            continue
        versions += 1
        fills.append(h["buffer_fill"])
        for s in h.get("staleness", ()):
            stale.add(float(s))
            updates += 1
    return {
        "accepted_updates": updates,
        "global_versions": versions,
        "mean_buffer_fill": (sum(fills) / len(fills)) if fills else None,
        "staleness": stale.summary(),
    }
