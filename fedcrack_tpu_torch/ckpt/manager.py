"""The round checkpointer: what a coordinator keeps across a restart.

The counterpart of ``fedcrack_tpu.ckpt.manager`` with the same interface
(``FedCheckpoint``, ``FedCheckpointer``, ``save_server_state``,
``restore_server_state``) and a format of its own: the JAX package writes
orbax steps, which are JAX's, so the port neither reads nor writes them.
Its layout under ``directory/``, one step per ``model_version``:

- ``<version>/variables.msgpack``: the weight tree as the port's msgpack
  blob (``fed/serialization.tree_to_bytes``);
- ``<version>/meta.json``: ``current_round``, ``model_version`` and the
  history, in the history's own key order;
- ``<version>/logs.msgpack``: the client log uploads, capped per step
  as the JAX package caps them (largest dropped first);
- ``<version>/opt_state.msgpack``: the FedOpt moments, the list of the
  optimizer's state trees as one blob (absent for plain FedAvg).

No pickle and no ``torch.save``. Each file is written with
``ioutils.atomic_write_bytes`` into a hidden staging directory that is
renamed to ``<version>`` when complete, so a step on disk is always whole;
beyond ``max_to_keep`` the oldest steps are removed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Mapping

from fedcrack_tpu_torch.fed.serialization import packb, tree_from_bytes, tree_to_bytes, unpackb
from fedcrack_tpu_torch.ioutils import atomic_write_bytes

log = logging.getLogger("fedcrack.ckpt")

# Cap on the client-uploaded log bytes carried per step: the logs ride
# along so a restart does not lose half-finished uploads, but a large
# upload must not be multiplied across every retained step.
DEFAULT_MAX_LOG_BYTES = 16 * 1024 * 1024

_VARIABLES, _META, _LOGS, _OPT = "variables.msgpack", "meta.json", "logs.msgpack", "opt_state.msgpack"


@dataclasses.dataclass(frozen=True)
class FedCheckpoint:
    """What a coordinator needs to resume a federation."""

    current_round: int
    model_version: int
    variables: Any
    history: tuple[dict, ...] = ()
    # Client-uploaded log chunks: "cname/title" -> bytes.
    logs: Mapping[str, bytes] = dataclasses.field(default_factory=dict)
    # The FedOpt moments, a tuple of trees (None for plain FedAvg).
    server_opt_state: Any = None


class FedCheckpointer:
    """Steps keyed by ``model_version``, which the round machine bumps
    exactly once per aggregation, so the latest step is the latest round.
    Holds no open resources: every call reads the directory afresh, so a
    reader in another process sees each step once its rename lands."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3,
                 max_log_bytes: int = DEFAULT_MAX_LOG_BYTES):
        self._dir = os.path.abspath(os.fspath(directory))
        self._max_to_keep = max_to_keep
        self._max_log_bytes = max_log_bytes
        os.makedirs(self._dir, exist_ok=True)

    def _capped_logs(self, logs: Mapping[str, bytes]) -> dict[str, bytes]:
        """Drop the largest first until the total fits the per-step cap."""
        out = dict(logs)
        total = sum(len(v) for v in out.values())
        if total <= self._max_log_bytes:
            return out
        for k in sorted(out, key=lambda k: len(out[k]), reverse=True):
            if total <= self._max_log_bytes:
                break
            total -= len(out[k])
            log.warning(
                "dropping log buffer %r (%d bytes) from the checkpoint: total log bytes exceed the "
                "%d-byte per-checkpoint cap (the upload itself is unaffected)",
                k, len(out[k]), self._max_log_bytes,
            )
            del out[k]
        return out

    def _versions(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self._dir) if name.isdigit())

    def _path(self, version: int, name: str) -> str:
        return os.path.join(self._dir, str(int(version)), name)

    def save(self, ckpt: FedCheckpoint) -> None:
        version = int(ckpt.model_version)
        staging = os.path.join(self._dir, f".{version}.tmp.{os.getpid()}")
        shutil.rmtree(staging, ignore_errors=True)
        meta = {
            "current_round": int(ckpt.current_round),
            "model_version": version,
            "history": list(ckpt.history),
        }
        atomic_write_bytes(os.path.join(staging, _VARIABLES), tree_to_bytes(ckpt.variables))
        logs = self._capped_logs(ckpt.logs)
        if logs:
            atomic_write_bytes(os.path.join(staging, _LOGS), packb(logs, sort_keys=False))
        if ckpt.server_opt_state is not None:
            atomic_write_bytes(os.path.join(staging, _OPT), tree_to_bytes(list(ckpt.server_opt_state)))
        atomic_write_bytes(os.path.join(staging, _META), json.dumps(meta).encode("utf-8"))
        final = os.path.join(self._dir, str(version))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(staging, final)
        if self._max_to_keep:  # None keeps every step, as in orbax
            for old in self._versions()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)), ignore_errors=True)

    def latest_version(self) -> int | None:
        versions = self._versions()
        return versions[-1] if versions else None

    def restore(self, template: Any | None = None) -> FedCheckpoint | None:
        """The latest step; ``template`` (a matching variables tree) sets
        the leaves' dtypes, else they come back as decoded (host numpy)."""
        step = self.latest_version()
        if step is None:
            return None
        with open(self._path(step, _META), "rb") as f:
            meta = json.loads(f.read())
        with open(self._path(step, _VARIABLES), "rb") as f:
            variables = tree_from_bytes(f.read(), template=template)
        logs = {}
        if os.path.exists(self._path(step, _LOGS)):
            with open(self._path(step, _LOGS), "rb") as f:
                logs = unpackb(f.read())
        return FedCheckpoint(
            current_round=int(meta["current_round"]),
            model_version=int(meta["model_version"]),
            variables=variables,
            history=tuple(meta.get("history", [])),
            logs=logs,
        )

    def restore_opt_state(self, opt_template: Any) -> Any | None:
        """The latest step's FedOpt moments in ``opt_template``'s structure
        (``tx.init(params)``); None when the step holds none or they do not
        fit the template (another optimizer wrote them)."""
        step = self.latest_version()
        if step is None or not os.path.exists(self._path(step, _OPT)):
            return None
        with open(self._path(step, _OPT), "rb") as f:
            blob = f.read()
        try:
            return tuple(tree_from_bytes(blob, template=list(opt_template)))
        except ValueError:
            log.debug("server opt_state in step %s does not match the current optimizer structure", step)
            return None

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""

    def __enter__(self) -> "FedCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_server_state(ckptr: FedCheckpointer, state: Any) -> None:
    """Persist a ``fed.rounds.ServerState`` after an aggregation."""
    ckptr.save(
        FedCheckpoint(
            current_round=state.current_round,
            model_version=state.model_version,
            variables=tree_from_bytes(state.global_blob),
            history=state.history,
            logs=state.logs,
            server_opt_state=state.server_opt_state,
        )
    )


def restore_server_state(ckptr: FedCheckpointer, config: Any, template: Any | None = None) -> Any | None:
    """A resumable ``ServerState`` from the latest step, or None.

    Enrollment re-opens (the old cohort's streams died with the old
    process) but the round, model version, weights, history, logs and
    FedOpt moments carry over. As in the JAX package, the privacy maps
    (seeds, roster, the accountant's steps) are not in a step: only the
    statefile keeps them."""
    from fedcrack_tpu_torch.fed import rounds as R
    from fedcrack_tpu_torch.fed.algorithms import make_server_optimizer

    ckpt = ckptr.restore(template)
    if ckpt is None:
        return None
    phase = R.PHASE_FINISHED if ckpt.current_round > config.max_rounds else R.PHASE_ENROLL
    opt_state = None
    tx = make_server_optimizer(config.server_optimizer, config.server_lr, config.server_momentum)
    if tx is not None:
        opt_state = ckptr.restore_opt_state(tx.init(ckpt.variables["params"]))
        if opt_state is None:
            log.warning(
                "no FedOpt moments restored for server_optimizer=%r: the server optimizer restarts "
                "from zero moments",
                config.server_optimizer,
            )
    # Through initial_state, so the derived fields (the float32 template,
    # the bfloat16 broadcast copy) are rebuilt as at a fresh boot.
    fresh = R.initial_state(config, ckpt.variables)
    return fresh._replace(
        phase=phase,
        current_round=ckpt.current_round,
        model_version=ckpt.model_version,
        history=ckpt.history,
        logs=ckpt.logs,
        server_opt_state=opt_state,
        # Buffered mode keys the retained-base window by version: the
        # restored global is the broadcast of the restored version.
        base_blobs={int(ckpt.model_version): fresh.broadcast_blob} if config.mode == "buffered" else {},
    )
