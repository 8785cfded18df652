"""Mid-round durable server state: the statefile.

The counterpart of ``fedcrack_tpu.ckpt.statefile``, byte for byte. The
whole dynamic ``ServerState`` (phase, cohort, the received updates,
FedBuff's buffer, pulled versions and retained bases, the ledger, the
FedOpt moments) is one msgpack map written through
``ioutils.atomic_write_bytes`` (temp file, fsync, atomic rename), so the
file on disk is always a complete snapshot. A statefile written by either
package loads in the other and re-encodes to the same bytes:

- the map keeps the JAX package's insertion order (``format, phase,
  cohort, ..., privacy_steps``), not sorted keys as the weight blob does;
  bytes are bin, str is str, floats are float64, integers take the
  smallest encoding, and a tuple is an array, as ``msgpack.packb(...,
  use_bin_type=True)`` writes them;
- every map inside is sorted by key, so the bytes are a function of the
  state and never of arrival order;
- the FedOpt moments are the weight blob of flax's state-dict view of
  the optax state: ``{'0': {'trace': m}, '1': {}}`` for FedAvgM,
  ``{'0': m, '1': v}`` for FedAdam and FedYogi. The port's state is the
  tuple ``(m,)`` or ``(m, v)``; moments that do not fit the configured
  optimizer are logged and restart from zero;
- the privacy plane's maps close it: the enroll-time masking seeds, the
  frozen masking roster and the DP accountant's per-client step counts
  (epsilon is recomputed from the steps, never stored).

Not persisted: the monotonic timestamps (the restored state re-arms them
at its first event) and the config (the booting server's wins; the
decode template and the bfloat16 broadcast copy are rebuilt through
``initial_state``).
"""

from __future__ import annotations

import logging
from typing import Any

from fedcrack_tpu_torch.fed.serialization import packb, tree_from_bytes, tree_to_bytes, unpackb
from fedcrack_tpu_torch.ioutils import atomic_write_bytes

log = logging.getLogger("fedcrack.ckpt.statefile")

STATE_FORMAT = 1
_MOMENTUM = ("momentum", "fedavgm")


def _plain(obj: Any) -> Any:
    """``obj`` as msgpack's non-strict packer sees it: a tuple is a list
    and a subclass of a builtin (a numpy float64) its base type. Anything
    else (a numpy float32, an array) raises, as msgpack does."""
    if obj is None or obj is True or obj is False:
        return obj
    for base in (int, float, str, bytes):
        if isinstance(obj, base):
            return obj if type(obj) is base else base(obj)
    if isinstance(obj, dict):
        return {_plain(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _moments_to_state_dict(kind: str, opt_state: tuple) -> dict:
    """The port's optimizer tuple in flax's state-dict view of the optax
    state the JAX package keeps."""
    if kind in _MOMENTUM:
        (m,) = opt_state
        return {"0": {"trace": m}, "1": {}}
    m, v = opt_state
    return {"0": m, "1": v}


def _restore_tuple(state: Any, n: int) -> list:
    # flax's tuple restore: exactly n entries keyed "0".."n-1".
    if len(state) != n:
        raise ValueError(f"expected {n} optimizer states, got {len(state)}")
    return [state[str(i)] for i in range(n)]


def _restore_fields(state: Any, fields: set) -> dict:
    # flax's namedtuple restore: exactly the named fields.
    if set(state.keys()) != fields:
        raise ValueError(f"optimizer state fields {set(state.keys())} != {fields}")
    return state


def _restore_tree(target: Any, state: Any) -> Any:
    # flax's dict restore: every target key present (extra keys ignored);
    # leaves are taken as stored.
    if isinstance(target, dict):
        missing = set(map(str, target)).difference(state.keys())
        if missing:
            raise ValueError(f"optimizer state lacks keys {sorted(missing)}")
        return {k: _restore_tree(v, state[str(k)]) for k, v in target.items()}
    return state


def _moments_from_state_dict(kind: str, params: Any, state: Any) -> tuple:
    """The inverse of :func:`_moments_to_state_dict`, checked against the
    configured optimizer's layout as flax's ``from_state_dict`` checks it."""
    if kind in _MOMENTUM:
        top = _restore_tuple(state, 2)
        trace = _restore_fields(top[0], {"trace"})["trace"]
        _restore_fields(top[1], set())
        return (_restore_tree(params, trace),)
    m, v = _restore_tuple(state, 2)
    return (_restore_tree(params, m), _restore_tree(params, v))


def server_state_to_bytes(state: Any) -> bytes:
    """The statefile bytes of a ``ServerState`` (msgpack, no pickle)."""
    from fedcrack_tpu_torch.fed import buffered as _buffered
    from fedcrack_tpu_torch.health import ledger as _health_ledger

    opt_blob = None
    if state.server_opt_state is not None:
        opt_blob = tree_to_bytes(
            _moments_to_state_dict(state.config.server_optimizer, state.server_opt_state)
        )
    payload = {
        "format": STATE_FORMAT,
        "phase": state.phase,
        "cohort": sorted(state.cohort),
        "departed": sorted(state.departed),
        "current_round": int(state.current_round),
        "model_version": int(state.model_version),
        "failed_rounds": int(state.failed_rounds),
        "global_blob": state.global_blob,
        "received": {name: [blob, int(ns)] for name, (blob, ns) in sorted(state.received.items())},
        "logs": dict(state.logs),
        "history": [dict(h) for h in state.history],
        "rejected": dict(state.rejected),
        "wire_bytes": {name: int(n) for name, n in sorted(state.wire_bytes.items())},
        "codecs": {name: c for name, c in sorted(state.codecs.items())},
        "opt_state": opt_blob,
        "buffer": [
            _buffered.buffer_entry_to_wire(e)
            for e in sorted(state.buffer, key=lambda e: (e["cname"], e["seq"]))
        ],
        "pulled": {name: int(v) for name, v in sorted(state.pulled.items())},
        # str keys: msgpack readers refuse int map keys by default.
        "base_blobs": {str(int(v)): b for v, b in sorted(state.base_blobs.items())},
        "ledger": _health_ledger.ledger_to_wire(state.ledger),
        "secagg_seeds": {name: int(s) for name, s in sorted(state.secagg_seeds.items())},
        "secagg_roster": {name: int(s) for name, s in sorted(state.secagg_roster.items())},
        "privacy_steps": {name: int(t) for name, t in sorted(state.privacy_steps.items())},
    }
    return packb(_plain(payload), sort_keys=False)


def server_state_from_bytes(blob: bytes, config: Any) -> Any:
    """A live ``ServerState`` under ``config``; the derived fields (the
    float32 template, the bfloat16 broadcast copy) come from
    ``initial_state``, so a wire-dtype change between runs leaves no stale
    broadcast."""
    from fedcrack_tpu_torch.fed import buffered as _buffered
    from fedcrack_tpu_torch.fed import rounds as R
    from fedcrack_tpu_torch.fed.algorithms import make_server_optimizer
    from fedcrack_tpu_torch.health import ledger as _health_ledger

    payload = unpackb(blob)
    if payload.get("format") != STATE_FORMAT:
        raise ValueError(f"unknown statefile format {payload.get('format')!r}")
    variables = tree_from_bytes(payload["global_blob"])
    state = R.initial_state(config, variables)
    opt_state = None
    if payload.get("opt_state") is not None:
        tx = make_server_optimizer(config.server_optimizer, config.server_lr, config.server_momentum)
        if tx is not None and "params" in variables:
            try:
                opt_state = _moments_from_state_dict(
                    config.server_optimizer,
                    tx.init(variables["params"])[0],
                    tree_from_bytes(payload["opt_state"]),
                )
            except (ValueError, KeyError, TypeError):
                log.warning(
                    "statefile optimizer moments do not match the configured "
                    "server optimizer %r; restarting moments from zero",
                    config.server_optimizer,
                )
    phase = payload["phase"]
    if payload["current_round"] > config.max_rounds:
        phase = R.PHASE_FINISHED
    return state._replace(
        phase=phase,
        cohort=frozenset(payload["cohort"]),
        departed=frozenset(payload["departed"]),
        current_round=payload["current_round"],
        model_version=payload["model_version"],
        failed_rounds=payload["failed_rounds"],
        received={name: (bytes(pair[0]), int(pair[1])) for name, pair in payload["received"].items()},
        logs={k: bytes(v) for k, v in payload["logs"].items()},
        history=tuple(payload["history"]),
        rejected=dict(payload.get("rejected", {})),
        wire_bytes={k: int(v) for k, v in payload.get("wire_bytes", {}).items()},
        codecs=dict(payload.get("codecs", {})),
        buffer=tuple(_buffered.buffer_entry_from_wire(e) for e in payload.get("buffer", [])),
        pulled={k: int(v) for k, v in payload.get("pulled", {}).items()},
        base_blobs=(
            {int(v): bytes(b) for v, b in payload.get("base_blobs", {}).items()}
            # A snapshot older than the buffered fields, restored under a
            # buffered config, must still decode current-version deltas:
            # seed the window with the restored global at its version.
            or (
                {int(payload["model_version"]): state.broadcast_blob}
                if config.mode == "buffered"
                else {}
            )
        ),
        ledger=_health_ledger.ledger_from_wire(payload.get("ledger", [])),
        secagg_seeds={k: int(v) for k, v in payload.get("secagg_seeds", {}).items()},
        secagg_roster={k: int(v) for k, v in payload.get("secagg_roster", {}).items()},
        privacy_steps={k: int(v) for k, v in payload.get("privacy_steps", {}).items()},
        server_opt_state=opt_state,
        enroll_opened_at=None,
        round_started_at=None,
    )


def save_state_file(path: str, state: Any) -> int:
    """One atomic, fsync'd snapshot; the previous one survives any crash
    up to the rename. Returns the bytes written."""
    blob = server_state_to_bytes(state)
    atomic_write_bytes(path, blob)
    return len(blob)


def load_state_file(path: str, config: Any) -> Any | None:
    """The latest snapshot, or None for a missing, unreadable or corrupt
    file (logged, never fatal)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return None
    except OSError:
        log.exception("statefile %s unreadable", path)
        return None
    try:
        return server_state_from_bytes(blob, config)
    except Exception:
        log.exception("statefile %s corrupt; starting from the boot state", path)
        return None
