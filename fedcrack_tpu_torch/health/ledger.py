"""Per-client update ledger and robust anomaly scoring.

The counterpart of the pure helpers of ``fedcrack_tpu.health.ledger``
(``new_record`` through ``observe_flush``), which the round machine calls
at its acceptance gate and at each flush. The ledger is the bounded
rolling record of what each client did at the gate (offers, accepts,
rejects by class, resyncs, samples, wire bytes) plus the update geometry
sanitation cannot see: each accepted update's L2 distance to the round
base, and at each flush its cosine to the cohort-mean update.

Anomaly score: at each flush a robust z-score over the cohort's norms and
cosines, ``z = |x - median| / (1.4826 * MAD + eps)`` per signal, the max of
the two, capped at :data:`SCORE_CAP`; ``eps`` scales with the median so
honest float jitter never flags. Every helper is a pure function over
plain dicts (copy-on-write, like the round machine), and trees are
flattened in the JAX package's leaf order, so both packages score the
same trees alike. :func:`export_anomaly_metrics` publishes the scores as
bounded-cardinality gauges, and :func:`ledger_to_wire` /
:func:`ledger_from_wire` give the statefile's canonical rows; the JSONL
export of the JAX module is not ported yet.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np

from fedcrack_tpu_torch.fed.pytree import tree_leaves

# Rolling window of per-flush (norm, cosine) samples kept per client: the
# record must stay O(1) per client.
LEDGER_WINDOW = 8
# Robust-z alert threshold: the classic |z| >= 3.5 outlier cutoff
# (Iglewicz & Hoaglin).
ANOMALY_ALERT = 3.5
# Scores are capped so a zero-MAD cohort cannot mint astronomically large
# (but still finite) exposition values.
SCORE_CAP = 1e6
# Per-client metric children: clients past this many (in sorted order)
# share the '_overflow' label, so a large cohort cannot mint unbounded
# time series.
MAX_CLIENT_LABELS = 32

_REJECT_KEYS = ("not_in_cohort", "stale", "sanitation", "other")
_OUTCOMES = ("accepted", "rejected", "resync")


def new_record() -> dict:
    """One client's empty ledger record (a fixed key set, in the JAX
    package's order)."""
    return {
        "offers": 0,
        "accepted": 0,
        "resyncs": 0,
        "samples": 0,
        "wire_bytes": 0,
        "rejected": {},            # reason class -> count
        "last_round": 0,
        "last_staleness": 0,
        "norms": [],               # last LEDGER_WINDOW update L2 norms
        "cosines": [],             # last LEDGER_WINDOW cosines-to-cohort-mean
        "anomaly": 0.0,            # robust z at the most recent flush
        "flags": 0,                # flushes where anomaly >= ANOMALY_ALERT
        # Flushes this client was excluded from by the ledger-coupled
        # quarantine (FedConfig.quarantine_z). A quarantined update passed
        # the acceptance gate (its offer is already counted "accepted");
        # quarantine is a flush-time fold decision, not a gate verdict.
        "quarantined": 0,
    }


def _flat(tree: Any) -> np.ndarray:
    leaves = [np.asarray(leaf, np.float32).ravel() for leaf in tree_leaves(tree)]
    return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)


def update_norm(tree: Any, base_tree: Any) -> float:
    """L2 norm of (update - base) over every leaf — the gate-time geometry
    sample. Deterministic: pure numpy over the decoded trees, rounded to 6
    places as the JAX package persists it."""
    delta = _flat(tree) - _flat(base_tree)
    return round(float(np.linalg.norm(delta)), 6)


def record_offer(
    ledger: Mapping[str, dict],
    cname: str,
    *,
    outcome: str,
    reason_class: str | None = None,
    num_samples: int = 0,
    wire_len: int = 0,
    staleness: int = 0,
    round: int = 0,
    norm: float | None = None,
) -> dict:
    """Fold one gate verdict into the ledger (copy-on-write; the input
    mapping is never mutated). ``outcome`` is 'accepted' | 'rejected' |
    'resync'; rejected offers carry a bounded ``reason_class``, never the
    raw reason string."""
    if outcome not in _OUTCOMES:
        raise ValueError(f"unknown ledger outcome {outcome!r}")
    out = dict(ledger)
    rec = dict(out.get(cname) or new_record())
    rec["offers"] += 1
    rec["last_round"] = int(round)
    if outcome == "accepted":
        rec["accepted"] += 1
        rec["samples"] += max(0, int(num_samples))
        rec["wire_bytes"] += max(0, int(wire_len))
        rec["last_staleness"] = int(staleness)
        if norm is not None:
            # np.round, not round(): the `round` kwarg shadows the builtin.
            rec["norms"] = (
                list(rec["norms"]) + [float(np.round(float(norm), 6))]
            )[-LEDGER_WINDOW:]
    elif outcome == "resync":
        rec["resyncs"] += 1
    else:
        key = reason_class if reason_class in _REJECT_KEYS else "other"
        rejected = dict(rec["rejected"])
        rejected[key] = rejected.get(key, 0) + 1
        rec["rejected"] = rejected
    out[cname] = rec
    return out


def record_quarantine(ledger: Mapping[str, dict], cname: str) -> dict:
    """Fold one flush-time quarantine decision into the ledger (copy-on-
    write): the named client's accepted-but-excluded counter. Called by the
    round machines right after :func:`observe_flush` hands them the scores
    that crossed ``FedConfig.quarantine_z``."""
    out = dict(ledger)
    rec = dict(out.get(cname) or new_record())
    rec["quarantined"] = int(rec.get("quarantined", 0)) + 1
    out[cname] = rec
    return out


def cohort_geometry(
    items: Iterable[tuple[str, Any]], base_tree: Any
) -> list[tuple[str, float, float]]:
    """Per-update (name, norm, cosine-to-cohort-mean-delta) over one flush's
    decoded trees, all against one base (the global the flush averages onto).
    Deterministic: items are processed in the given order but the mean is
    order-independent; callers pass the fold's sorted order."""
    items = list(items)
    if not items:
        return []
    base = _flat(base_tree)
    deltas = [_flat(tree) - base for _, tree in items]
    mean = np.mean(np.stack(deltas), axis=0)
    mean_norm = float(np.linalg.norm(mean))
    out = []
    for (name, _), delta in zip(items, deltas):
        norm = float(np.linalg.norm(delta))
        if norm > 0.0 and mean_norm > 0.0:
            cos = float(np.dot(delta, mean) / (norm * mean_norm))
        else:
            # A zero update agrees perfectly with a zero mean and carries no
            # direction against a non-zero one.
            cos = 1.0 if norm == mean_norm else 0.0
        out.append((name, round(norm, 6), round(max(-1.0, min(1.0, cos)), 6)))
    return out


def robust_z(values: list[float]) -> list[float]:
    """Median/MAD z-scores, eps-guarded and capped (see module docstring).
    A 0- or 1-element window scores 0.0 — there is no cohort to deviate
    from."""
    if len(values) < 2:
        return [0.0] * len(values)
    arr = np.asarray(values, np.float64)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    denom = 1.4826 * mad + max(1e-6, 1e-3 * abs(med))
    return [
        round(min(SCORE_CAP, abs(v - med) / denom), 6) for v in arr.tolist()
    ]


def observe_flush(
    ledger: Mapping[str, dict],
    items: Iterable[tuple[str, Any]],
    base_tree: Any,
) -> tuple[dict, dict]:
    """The per-flush geometry pass: cosines vs the cohort-mean update,
    robust-z anomaly scores across THIS flush's updates, windows appended.
    Returns ``(new_ledger, {cname: score})``. One client may contribute
    several buffered entries to a flush; its score is the max over them."""
    geometry = cohort_geometry(items, base_tree)
    if not geometry:
        return dict(ledger), {}
    z_norm = robust_z([g[1] for g in geometry])
    z_cos = robust_z([g[2] for g in geometry])
    scores: dict[str, float] = {}
    cosines: dict[str, list[float]] = {}
    for (name, _norm, cos), zn, zc in zip(geometry, z_norm, z_cos):
        score = round(max(zn, zc), 6)
        scores[name] = max(score, scores.get(name, 0.0))
        cosines.setdefault(name, []).append(cos)
    out = dict(ledger)
    for name in sorted(scores):
        rec = dict(out.get(name) or new_record())
        rec["cosines"] = (list(rec["cosines"]) + cosines[name])[-LEDGER_WINDOW:]
        rec["anomaly"] = scores[name]
        if scores[name] >= ANOMALY_ALERT:
            rec["flags"] += 1
        out[name] = rec
    return out, scores


# ---- persistence: the statefile's canonical rows ----

def ledger_to_wire(ledger: Mapping[str, dict]) -> list:
    """Canonical wire rows, sorted by client name, with the JAX package's
    fixed positional field order: the statefile bytes stay a pure function
    of the state."""
    rows = []
    for name in sorted(ledger):
        rec = ledger[name]
        rows.append([
            str(name),
            int(rec["offers"]),
            int(rec["accepted"]),
            int(rec["resyncs"]),
            int(rec["samples"]),
            int(rec["wire_bytes"]),
            int(rec["last_round"]),
            int(rec["last_staleness"]),
            float(rec["anomaly"]),
            int(rec["flags"]),
            [[k, int(rec["rejected"][k])] for k in sorted(rec["rejected"])],
            [float(x) for x in rec["norms"]],
            [float(x) for x in rec["cosines"]],
            # The 14th field; rows of 13 fields (written before the
            # quarantine counter existed) are read too.
            int(rec.get("quarantined", 0)),
        ])
    return rows


def ledger_from_wire(rows: Iterable) -> dict:
    """The ledger of :func:`ledger_to_wire`'s rows."""
    out: dict[str, dict] = {}
    for row in rows or []:
        rec = new_record()
        (
            name, rec["offers"], rec["accepted"], rec["resyncs"],
            rec["samples"], rec["wire_bytes"], rec["last_round"],
            rec["last_staleness"], rec["anomaly"], rec["flags"],
            rejected, norms, cosines,
        ) = row[:13]
        if len(row) > 13:
            rec["quarantined"] = int(row[13])
        rec["rejected"] = {str(k): int(v) for k, v in rejected}
        rec["norms"] = [float(x) for x in norms]
        rec["cosines"] = [float(x) for x in cosines]
        rec["anomaly"] = float(rec["anomaly"])
        out[str(name)] = rec
    return out


def client_label(cname: str, rank: int) -> str:
    """The bounded label of the client at ``rank`` in the sorted ledger:
    its own name under :data:`MAX_CLIENT_LABELS`, '_overflow' past it."""
    return str(cname) if rank < MAX_CLIENT_LABELS else "_overflow"


def export_anomaly_metrics(ledger: Mapping[str, dict], registry=None) -> None:
    """Set the anomaly gauges from the ledger: one child per client
    (bounded by :func:`client_label`, the overflow child taking the max)
    and the unlabeled maximum."""
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    per_client = reg.gauge(
        "fed_client_anomaly_score_ratio",
        "robust z-score (median/MAD over the flush cohort's update norm and "
        "cosine-to-mean) of each client's latest flushed update; >= 3.5 "
        "flags an outlier sanitation cannot see",
        labels=("client",),
    )
    values: dict[str, float] = {}
    for rank, name in enumerate(sorted(ledger)):
        label = client_label(name, rank)
        score = float(ledger[name].get("anomaly", 0.0))
        values[label] = max(score, values.get(label, 0.0))
    for label in sorted(values):
        per_client.labels(client=label).set(values[label])
    reg.gauge(
        "fed_client_anomaly_max_ratio",
        "max per-client anomaly score at the latest flush (unlabeled "
        "ceiling series)",
    ).set(max(values.values()) if values else 0.0)
