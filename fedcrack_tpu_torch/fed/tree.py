"""The hierarchical aggregation tree: edge tiers between the cohort and
the root.

The counterpart of ``fedcrack_tpu.fed.tree``. Each edge aggregator owns a
shard of the round's cohort, runs the same acceptance gate
(``rounds.decode_and_validate_update``) and K-of-N quorum
(``rounds.quorum_target``) as the root, reduces its shard to one
sample-weighted partial FedAvg and sends that single blob upward. The
root holds one blob per edge, not one per client; at any instant the
process holds at most one edge's leaf fan-in plus the root's edge fan-in.

A sample-weighted FedAvg of sample-weighted partials, each weighted by its
sample sum, is the flat FedAvg of the leaves up to float re-association;
the tree's own trajectory is a pure function of the cohort seed.

Each edge can keep its in-flight round in an atomic statefile, byte for
byte the JAX package's, so a killed edge resumes the same round with the
updates it had accepted. The edge-to-root hop can re-encode the partial
with a codec (``update_codec``): a partial is a delta against the same
base the leaves trained from, so the root's frame decode accepts it as
it is. In buffered mode the edge keeps a FedBuff buffer one tier down and
flushes a staleness-weighted partial.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Any, Callable, Sequence

import numpy as np

from fedcrack_tpu_torch.ckpt.statefile import _plain
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import aggregation as _aggregation
from fedcrack_tpu_torch.fed import buffered as _buffered
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.fed.algorithms import sample_cohort
from fedcrack_tpu_torch.fed.rounds import decode_and_validate_update, quorum_target
from fedcrack_tpu_torch.fed.serialization import packb, tree_from_bytes, tree_to_bytes, unpackb
from fedcrack_tpu_torch.health import ledger as _health_ledger
from fedcrack_tpu_torch.ioutils import atomic_write_bytes
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY

log = logging.getLogger("fedcrack.fed.tree")


def _edge_updates_counter():
    return REGISTRY.counter(
        "edge_updates_total",
        "leaf uploads at the edge tier by outcome",
        labels=("result",),
    )


def _edge_wire_counter():
    return REGISTRY.counter(
        "edge_wire_bytes_total",
        "wire bytes at the edge tier (in = leaf uploads, up = partials "
        "pushed toward the root)",
        labels=("direction",),
    )


EDGE_STATE_FORMAT = 1


def partition_cohort(cohort: Sequence[int], n_edges: int) -> list[np.ndarray]:
    """The cohort split into contiguous shards, ``np.array_split`` style
    (the first ``len % n_edges`` edges take one extra leaf), so the same
    cohort always lands on the same edges."""
    if n_edges <= 0:
        raise ValueError(f"n_edges must be positive, got {n_edges}")
    arr = np.asarray(cohort, np.int64)
    if arr.size == 0:
        raise ValueError("empty cohort")
    return [s for s in np.array_split(arr, min(n_edges, arr.size))]


class EdgeAggregator:
    """One edge: gathers its shard's updates for the root's current
    round through the shared gate, holds at most its leaf fan-in of
    decoded blobs, and reduces them to one partial for the hop up.

    The edge keeps no round counter of its own and broadcasts nothing:
    the round and base come down from the root (``begin_round``), and its
    leaves train next on the root's broadcast, never on the partial.
    ``state_path`` snapshots the in-flight round after every event;
    :meth:`restore` resumes it."""

    def __init__(
        self,
        edge_id: str,
        template: Any,
        *,
        quorum_fraction: float = 1.0,
        sanitize: bool = True,
        state_path: str = "",
        update_codec: str = "null",
        topk_fraction: float = 0.01,
        mode: str = "sync",
        buffer_k: int = 2,
        staleness_alpha: float = 0.5,
        max_staleness: int = 4,
        aggregation: str = "fedavg",
    ):
        if not 0.0 < quorum_fraction <= 1.0:
            raise ValueError(f"quorum_fraction must be in (0, 1], got {quorum_fraction}")
        if update_codec not in ("null", "int8", "topk_delta"):
            raise ValueError(f"unknown update_codec {update_codec!r}")
        if aggregation != "fedavg":
            # A robust combine does not compose over tiers: a trimmed mean
            # of per-edge trimmed partials is not the cohort's trimmed
            # mean, and the root has lost the per-leaf geometry it would
            # need. Robust folds run where the whole cohort is visible.
            raise ValueError(
                f"edge tier only supports aggregation='fedavg', got "
                f"{aggregation!r}: a trimmed/robust partial of a partial "
                "is not a robust total — run robust combines at the root "
                "(FedConfig.aggregation)"
            )
        if mode not in ("sync", "buffered"):
            raise ValueError(f"mode must be 'sync' or 'buffered', got {mode!r}")
        if buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")
        if staleness_alpha < 0.0 or max_staleness < 0:
            raise ValueError(
                "staleness_alpha and max_staleness must be >= 0, got "
                f"{staleness_alpha}/{max_staleness}"
            )
        self.edge_id = edge_id
        self.template = template
        self.quorum_fraction = quorum_fraction
        self.sanitize = sanitize
        self.state_path = state_path
        self.update_codec = update_codec
        self.topk_fraction = topk_fraction
        self.mode = mode
        self.buffer_k = int(buffer_k)
        self.staleness_alpha = float(staleness_alpha)
        self.max_staleness = int(max_staleness)
        self.buffer: list[dict] = []
        # Buffered mode: version -> the root's broadcast blob, kept within
        # the max_staleness window so stale deltas still decode, and one
        # decoded tree per kept version.
        self.bases: dict[int, bytes] = {}
        self._base_trees: dict[int, Any] = {}
        self.round = 0
        self.base_version = -1
        self.base_blob = b""
        self.leaves: frozenset[str] = frozenset()
        self.received: dict[str, tuple[bytes, int]] = {}
        self.rejected: dict[str, str] = {}
        self.wire_bytes: dict[str, int] = {}
        self.ledger: dict[str, dict] = {}
        # The most decoded blobs this edge ever held at once (at most its
        # leaf fan-in) and the wire bytes in and up.
        self.peak_resident_blobs = 0
        self.bytes_in = 0
        self.bytes_up = 0
        self._base_tree = None
        # One codec for the edge's lifetime: top-k's error-feedback
        # residual carries across rounds.
        self._codec = None
        # Trace links of accepted offers and the last flush's own wire
        # context (sent up with the partial); never persisted.
        self.trace_links: dict[str, str] = {}
        self.last_partial_ctx: str = ""
        self._flush_seq = 0

    # -- round lifecycle --

    def begin_round(self, round_idx: int, base_blob: bytes, base_version: int, leaves: Sequence[Any]) -> None:
        """Arm the edge for one root round: its shard of leaf names and the
        root's broadcast base, which framed leaf deltas decode against."""
        self.round = int(round_idx)
        self.base_blob = bytes(base_blob)
        self.base_version = int(base_version)
        self.leaves = frozenset(str(x) for x in leaves)
        if not self.leaves:
            raise ValueError(f"edge {self.edge_id}: empty leaf shard")
        self.received = {}
        self.rejected = {}
        self.wire_bytes = {}
        self._base_tree = None
        if self.mode == "buffered":
            # The buffer is not per-round state: it survives.
            self._retain_base()
        self._persist()

    def advance_base(self, round_idx: int, base_blob: bytes, base_version: int) -> None:
        """Buffered mode: the root published a new global. New deltas pin
        to it; the old base stays within ``max_staleness`` and the buffer
        carries across."""
        if self.mode != "buffered":
            raise RuntimeError("advance_base is a buffered-mode call")
        self.round = int(round_idx)
        self.base_blob = bytes(base_blob)
        self.base_version = int(base_version)
        self._base_tree = None
        self._retain_base()
        self._persist()

    def _retain_base(self) -> None:
        self.bases = {
            v: b for v, b in sorted(self.bases.items()) if self.base_version - v <= self.max_staleness
        }
        self.bases[self.base_version] = self.base_blob
        self._base_trees = {v: t for v, t in sorted(self._base_trees.items()) if v in self.bases}

    def _decoded_retained_base(self, version: int):
        tree = self._base_trees.get(version)
        if tree is None:
            tree = tree_from_bytes(self.bases[version], template=self.template)
            self._base_trees[version] = tree
        return tree

    def _decoded_base(self):
        if self._base_tree is None:
            self._base_tree = tree_from_bytes(self.base_blob, template=self.template)
        return self._base_tree

    @property
    def quorum(self) -> int:
        return quorum_target(self.quorum_fraction, len(self.leaves))

    def quorum_met(self) -> bool:
        return len(self.received) >= self.quorum

    def _stamp_trace(self, cname: str, trace_ctx: str) -> None:
        # An unparseable context is no link, never an error.
        if trace_ctx and tracing.TraceContext.from_wire(trace_ctx) is not None:
            self.trace_links[cname] = trace_ctx

    def _emit_flush_span(self, cnames: list[str]) -> str:
        """One ``edge.flush_partial`` span linking the flushed leaves'
        contexts; returns (and keeps as ``last_partial_ctx``) the flush's
        own wire context for the hop up, so the root links the edge as it
        links a client."""
        self._flush_seq += 1
        ectx = tracing.TraceContext(
            tracing.version_trace(self.base_version),
            f"edge:{self.edge_id}:flush:{self._flush_seq}",
        )
        links = []
        for name in cnames:
            wire = self.trace_links.pop(name, None)
            if wire is not None:
                links.append(wire)
        with tracing.span(
            "edge.flush_partial",
            trace=ectx.trace,
            ctx=ectx.to_wire(),
            links=sorted(links),
            edge=self.edge_id,
            buffer_fill=len(cnames),
        ):
            pass
        self.last_partial_ctx = ectx.to_wire()
        return self.last_partial_ctx

    def offer(self, cname: str, blob: bytes, num_samples: int, trace_ctx: str = "") -> tuple[bool, str | None]:
        """One leaf's upload through the root's gate: a corrupt frame, a
        wrong-shape tree or a NaN update is rejected here, recorded and
        never averaged. Returns ``(accepted, rejection_reason)``."""
        if cname not in self.leaves:
            return False, f"{cname} not in this edge's shard"
        if cname in self.received:
            return False, f"duplicate upload from {cname}"
        decoded, wire_len, _codec, problem, norm = decode_and_validate_update(
            blob,
            num_samples,
            template=self.template,
            base_fn=self._decoded_base,
            base_version=self.base_version,
            sanitize=self.sanitize,
        )
        self.bytes_in += wire_len
        _edge_wire_counter().labels(direction="in").inc(wire_len)
        if problem is not None:
            self.rejected[cname] = problem
            self.ledger = _health_ledger.record_offer(
                self.ledger, cname, outcome="rejected", reason_class="sanitation",
                num_samples=num_samples, wire_len=wire_len, round=self.round,
            )
            _edge_updates_counter().labels(result="rejected").inc()
            self._persist()
            return False, problem
        _edge_updates_counter().labels(result="accepted").inc()
        self.received[cname] = (decoded, int(num_samples))
        self.wire_bytes[cname] = wire_len
        self.ledger = _health_ledger.record_offer(
            self.ledger, cname, outcome="accepted", num_samples=num_samples,
            wire_len=wire_len, round=self.round, norm=norm,
        )
        self._stamp_trace(cname, trace_ctx)
        self.peak_resident_blobs = max(self.peak_resident_blobs, len(self.received))
        self._persist()
        return True, None

    def offer_buffered(
        self,
        cname: str,
        blob: bytes,
        num_samples: int,
        base_version: int,
        trace_ctx: str = "",
    ) -> tuple[bool, str | None]:
        """Buffered mode's upload: gated against the base the leaf trained
        on (``base_version``, kept in the window), weighted by the root's
        staleness decay and appended to the buffer. A future, too stale or
        no longer kept base is refused and recorded."""
        if self.mode != "buffered":
            return False, "edge is not in buffered mode"
        if cname not in self.leaves:
            return False, f"{cname} not in this edge's shard"
        staleness = self.base_version - int(base_version)
        if staleness < 0:
            return self._refuse(
                cname, f"future base version {base_version} (edge at {self.base_version})",
                reason_class="stale",
            )
        if staleness > self.max_staleness:
            return self._refuse(
                cname,
                f"too stale: base version {base_version} is {staleness} "
                f"behind (max_staleness={self.max_staleness})",
                reason_class="stale", staleness=staleness,
            )
        if int(base_version) not in self.bases:
            return self._refuse(
                cname, f"base version {base_version} no longer retained",
                reason_class="stale", staleness=staleness,
            )
        decoded, wire_len, codec_name, problem, norm = decode_and_validate_update(
            blob,
            num_samples,
            template=self.template,
            base_fn=lambda: self._decoded_retained_base(int(base_version)),
            base_version=int(base_version),
            sanitize=self.sanitize,
        )
        self.bytes_in += wire_len
        _edge_wire_counter().labels(direction="in").inc(wire_len)
        if problem is not None:
            return self._refuse(
                cname, problem, reason_class="sanitation", num_samples=num_samples,
                wire_len=wire_len, staleness=staleness,
            )
        _edge_updates_counter().labels(result="accepted").inc()
        self.ledger = _health_ledger.record_offer(
            self.ledger, cname, outcome="accepted", num_samples=num_samples,
            wire_len=wire_len, round=self.round, staleness=staleness, norm=norm,
        )
        self._stamp_trace(cname, trace_ctx)
        self.buffer.append({
            "cname": cname,
            "seq": sum(1 for e in self.buffer if e["cname"] == cname),
            "blob": decoded,
            "ns": int(num_samples),
            "staleness": int(staleness),
            "weight": _buffered.staleness_weight(staleness, self.staleness_alpha),
            "base_version": int(base_version),
            "wire_len": int(wire_len),
            "codec": codec_name,
        })
        self.peak_resident_blobs = max(self.peak_resident_blobs, len(self.buffer))
        self._persist()
        return True, None

    def _refuse(
        self,
        cname: str,
        reason: str,
        *,
        reason_class: str = "other",
        num_samples: int = 0,
        wire_len: int = 0,
        staleness: int = 0,
    ) -> tuple[bool, str]:
        self.rejected[cname] = reason
        self.ledger = _health_ledger.record_offer(
            self.ledger, cname, outcome="rejected", reason_class=reason_class,
            num_samples=num_samples, wire_len=wire_len, round=self.round, staleness=staleness,
        )
        _edge_updates_counter().labels(result="rejected").inc()
        self._persist()
        return False, reason

    def buffer_ready(self) -> bool:
        return len(self.buffer) >= self.buffer_k

    def _encode_up(self, blob: bytes, **kwargs) -> bytes:
        """The partial as the hop up sends it: re-encoded by the edge's
        codec against the current base, or as it is for ``"null"``."""
        if self.update_codec != "null":
            if self._codec is None:
                from fedcrack_tpu_torch.compress import get_codec

                self._codec = get_codec(
                    self.update_codec, topk_fraction=self.topk_fraction, client_tag=self.edge_id
                )
            blob = self._codec.encode_update(
                blob, self.base_blob, round=self.round, base_version=self.base_version, **kwargs
            )
        self.bytes_up += len(blob)
        _edge_wire_counter().labels(direction="up").inc(len(blob))
        REGISTRY.counter("edge_flushes_total", "edge-tier partial aggregations pushed up").inc()
        return blob

    def flush_partial(self) -> tuple[bytes, int, dict]:
        """The buffer as one staleness-weighted partial: the root flush's
        sorted ``(cname, seq)`` fold, weighted ``ns * (1 + s)^-alpha``.
        Returns ``(blob_or_frame, total_samples, info)``: the effective
        weight rounded to the wire's integer sample count (at least 1),
        and the per-update staleness and weights. Under top-k the
        error-feedback residual decays by the flush's mean staleness
        weight. The partial is not anchored on the base: the parent tier
        weighs it by its reduced effective sample count."""
        if self.mode != "buffered":
            raise RuntimeError("flush_partial is a buffered-mode call")
        if not self.buffer:
            raise RuntimeError(f"edge {self.edge_id}: flush of an empty buffer")
        avg, entries, counts, eff, trees = _buffered.fold_buffer(self.buffer, self.template)
        self.ledger, _scores = _health_ledger.observe_flush(
            self.ledger, [(e["cname"], t) for e, t in zip(entries, trees)], self._decoded_base()
        )
        total_eff = float(sum(eff))
        total_ns = float(sum(counts))
        decay = total_eff / total_ns if total_ns > 0 else 1.0
        blob = self._encode_up(
            tree_to_bytes(avg), **({"ef_decay": decay} if self.update_codec == "topk_delta" else {})
        )
        flush_ctx = self._emit_flush_span([e["cname"] for e in entries])
        info = {
            "clients": [e["cname"] for e in entries],
            "staleness": [e["staleness"] for e in entries],
            "weights": [e["weight"] for e in entries],
            "buffer_fill": len(entries),
            "effective_samples": total_eff,
            "trace_ctx": flush_ctx,
        }
        self.buffer = []
        self._persist()
        return blob, max(1, int(round(total_eff))), info

    def partial(self) -> tuple[bytes, int]:
        """The shard's sample-weighted partial FedAvg as one upload for the
        parent tier: ``(blob_or_frame, total_samples)``. Weighting partials
        by their sample sums makes the tree the flat weighted mean."""
        if not self.received:
            raise RuntimeError(f"edge {self.edge_id}: no accepted updates to aggregate")
        names = sorted(self.received)
        trees = [tree_from_bytes(self.received[n][0], template=self.template) for n in names]
        counts = [self.received[n][1] for n in names]
        self.ledger, _scores = _health_ledger.observe_flush(
            self.ledger, list(zip(names, trees)), self._decoded_base()
        )
        avg = _aggregation.fold(_aggregation.FedAvg(), list(zip(names, counts, trees)))
        blob = self._encode_up(tree_to_bytes(avg))
        self._emit_flush_span(list(names))
        return blob, int(sum(counts))

    def end_round(self) -> None:
        """Release the round's decoded blobs once the partial is up."""
        self.received = {}
        self.wire_bytes = {}
        self._base_tree = None
        self._persist()

    # -- the edge statefile --

    def _persist(self) -> None:
        if not self.state_path:
            return
        # The JAX package's key order (msgpack keeps insertion order);
        # every inner map is sorted, so the bytes depend on the state only.
        payload = {
            "format": EDGE_STATE_FORMAT,
            "edge_id": self.edge_id,
            "round": self.round,
            "base_version": self.base_version,
            "base_blob": self.base_blob,
            "leaves": sorted(self.leaves),
            "received": {name: [blob, int(ns)] for name, (blob, ns) in sorted(self.received.items())},
            "rejected": {k: v for k, v in sorted(self.rejected.items())},
            "wire_bytes": {k: int(v) for k, v in sorted(self.wire_bytes.items())},
            # The buffer's knobs restore from the file, so a resumed
            # buffer flushes when and as the original would have.
            "mode": self.mode,
            "buffer_k": int(self.buffer_k),
            "staleness_alpha": float(self.staleness_alpha),
            "max_staleness": int(self.max_staleness),
            "buffer": [
                _buffered.buffer_entry_to_wire(e)
                for e in sorted(self.buffer, key=lambda e: (e["cname"], e["seq"]))
            ],
            "bases": {str(int(v)): b for v, b in sorted(self.bases.items())},
            "ledger": _health_ledger.ledger_to_wire(self.ledger),
        }
        atomic_write_bytes(self.state_path, packb(_plain(payload), sort_keys=False))

    @classmethod
    def restore(
        cls,
        state_path: str,
        template: Any,
        *,
        quorum_fraction: float = 1.0,
        sanitize: bool = True,
        update_codec: str = "null",
        topk_fraction: float = 0.01,
        buffer_k: int = 2,
        staleness_alpha: float = 0.5,
        max_staleness: int = 4,
    ) -> "EdgeAggregator | None":
        """A killed edge from its statefile: the same round and base with
        the accepted updates. None for a missing or unreadable file (the
        edge then begins the round afresh and the root's quorum and
        deadline absorb the loss). The buffer's knobs come from the file;
        the arguments only fill in for a file that lacks them."""
        try:
            with open(state_path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            log.exception("edge statefile %s unreadable", state_path)
            return None
        try:
            payload = unpackb(blob)
            if payload.get("format") != EDGE_STATE_FORMAT:
                raise ValueError(f"unknown edge statefile format {payload.get('format')!r}")
            edge = cls(
                str(payload["edge_id"]),
                template,
                quorum_fraction=quorum_fraction,
                sanitize=sanitize,
                state_path=state_path,
                update_codec=update_codec,
                topk_fraction=topk_fraction,
                mode=str(payload.get("mode", "sync")),
                buffer_k=int(payload.get("buffer_k", buffer_k)),
                staleness_alpha=float(payload.get("staleness_alpha", staleness_alpha)),
                max_staleness=int(payload.get("max_staleness", max_staleness)),
            )
            edge.round = int(payload["round"])
            edge.base_version = int(payload["base_version"])
            edge.base_blob = bytes(payload["base_blob"])
            edge.leaves = frozenset(str(x) for x in payload["leaves"])
            edge.received = {name: (bytes(pair[0]), int(pair[1])) for name, pair in payload["received"].items()}
            edge.rejected = dict(payload.get("rejected", {}))
            edge.wire_bytes = {k: int(v) for k, v in payload.get("wire_bytes", {}).items()}
            edge.buffer = [_buffered.buffer_entry_from_wire(e) for e in payload.get("buffer", [])]
            edge.bases = {int(v): bytes(b) for v, b in payload.get("bases", {}).items()}
            edge.ledger = _health_ledger.ledger_from_wire(payload.get("ledger", []))
            edge.peak_resident_blobs = max(len(edge.received), len(edge.buffer))
            return edge
        except Exception:
            log.exception("edge statefile %s corrupt; starting fresh", state_path)
            return None


@dataclasses.dataclass
class TreeRunResult:
    """What :func:`run_tree_federation` shows, in numbers."""

    state: Any                      # the root's final ServerState
    n_clients: int
    cohort_size: int
    n_edges: int
    rounds: int
    root_peak_blobs: int            # max |root.received|: at most n_edges
    edge_peak_blobs: int            # max over edges: at most the leaf fan-in
    max_leaf_fan_in: int
    leaf_updates: int               # leaf uploads offered
    leaf_rejections: int
    bytes_at_root: int              # wire bytes the root received
    bytes_flat_equiv: int           # what a flat root would have received
    global_sha256: str              # of the final global blob
    cohorts: list[list[int]]        # each round's seeded cohort


def run_tree_federation(
    variables: Any,
    make_update: Callable[[int, int, bytes, int], tuple[bytes, int]],
    *,
    n_clients: int,
    cohort_size: int,
    n_rounds: int,
    n_edges: int,
    cohort_seed: int = 0,
    quorum_fraction: float = 1.0,
    edge_quorum_fraction: float = 1.0,
    update_codec: str = "null",
    topk_fraction: float = 0.01,
    sanitize: bool = True,
    state_dir: str = "",
) -> TreeRunResult:
    """A federation through a two-level tree, in process. The root is the
    round machine (``rounds.transition``) whose cohort is the edges; each
    edge an :class:`EdgeAggregator` over its shard of the round's seeded
    cohort; each leaf ``make_update(client_idx, round_idx, base_blob,
    base_version) -> (blob, n_samples)``.

    Edges run one after another and release their blobs after the hop up,
    so the process holds at most ``max(leaf fan-in) + root fan-in``
    decoded updates. With a deterministic ``make_update`` the whole
    trajectory is a function of ``cohort_seed``."""
    if cohort_size < n_edges:
        # Some edge would get no shard and the root's barrier over n_edges
        # could never close.
        raise ValueError(
            f"cohort_size={cohort_size} < n_edges={n_edges}: every edge "
            "needs at least one leaf (shrink the tree's fan-out)"
        )
    cfg = FedConfig(
        max_rounds=n_rounds,
        cohort_size=n_edges,
        quorum_fraction=quorum_fraction,
        sanitize_updates=sanitize,
        registration_window_s=3600.0,
        update_codec=update_codec,
        topk_fraction=topk_fraction,
    )
    state = R.initial_state(cfg, variables)
    now = 0.0
    for e in range(n_edges):
        now += 1e-3
        state, rep = R.transition(state, R.Ready(cname=f"edge-{e}", now=now))
        assert rep.status == R.SW, rep.status
    assert state.phase == R.PHASE_RUNNING

    edges = [
        EdgeAggregator(
            f"edge-{e}",
            state.template,
            quorum_fraction=edge_quorum_fraction,
            sanitize=sanitize,
            state_path=os.path.join(state_dir, f"edge-{e}.msgpack") if state_dir else "",
            update_codec=update_codec,
            topk_fraction=topk_fraction,
        )
        for e in range(n_edges)
    ]

    root_peak = edge_peak = max_fan_in = 0
    leaf_updates = leaf_rejections = bytes_at_root = bytes_flat = 0
    cohorts: list[list[int]] = []
    for r in range(n_rounds):
        round_no = state.current_round
        base_blob = state.broadcast_blob
        base_version = state.model_version
        cohort = sample_cohort(n_clients, cohort_size, r, cohort_seed)
        cohorts.append([int(x) for x in cohort])
        shards = partition_cohort(cohort, n_edges)
        for e, edge in enumerate(edges):
            shard = [f"client-{int(i)}" for i in shards[e]]
            max_fan_in = max(max_fan_in, len(shard))
            edge.begin_round(round_no, base_blob, base_version, shard)
            for idx, name in zip(shards[e], shard):
                blob, ns = make_update(int(idx), r, base_blob, base_version)
                leaf_updates += 1
                bytes_flat += len(blob)
                accepted, _reason = edge.offer(name, blob, ns)
                if not accepted:
                    leaf_rejections += 1
            edge_peak = max(edge_peak, edge.peak_resident_blobs)
            if not edge.quorum_met():
                # A live root's deadline would shrink around a silent edge;
                # in process that is an error, not a stall.
                raise RuntimeError(
                    f"edge-{e} missed quorum round {round_no}: {len(edge.received)}/{edge.quorum}"
                )
            partial_blob, total = edge.partial()
            bytes_at_root += len(partial_blob)
            now += 1e-3
            state, rep = R.transition(
                state,
                R.TrainDone(cname=edge.edge_id, round=round_no, blob=partial_blob, num_samples=total, now=now),
            )
            if rep.status == R.REJECTED:
                raise RuntimeError(f"root rejected edge-{e}'s partial: {rep.config}")
            # The reply that closed the barrier already emptied `received`:
            # its peak was then the e + 1 edges that had reported.
            closed = rep.status in (R.RESP_ARY, R.FIN)
            root_peak = max(root_peak, e + 1 if closed else len(state.received))
            edge.end_round()
        if state.current_round == round_no:
            raise RuntimeError(f"root round {round_no} failed to close")

    return TreeRunResult(
        state=state,
        n_clients=n_clients,
        cohort_size=cohort_size,
        n_edges=n_edges,
        rounds=n_rounds,
        root_peak_blobs=root_peak,
        edge_peak_blobs=edge_peak,
        max_leaf_fan_in=max_fan_in,
        leaf_updates=leaf_updates,
        leaf_rejections=leaf_rejections,
        bytes_at_root=bytes_at_root,
        bytes_flat_equiv=bytes_flat,
        global_sha256=hashlib.sha256(state.global_blob).hexdigest(),
        cohorts=cohorts,
    )
