"""Fault-plan hooks for the transport client and the serving plane.

The counterpart of ``fedcrack_tpu.chaos.inject``. Injection points, each a
``None`` check when no plan is attached:

- :class:`ClientChaos` plugs into
  :class:`fedcrack_tpu_torch.transport.client.FedClient` (``chaos=``).
  ``before_send`` runs inside the retry loop right before each RPC;
  ``after_reply`` runs on the reply before it is returned. Between them
  they express every client-side fault: crashes before, during and after
  the weight upload, straggler sleeps, transient UNAVAILABLE flaps (which
  the retry schedule must ride out) and the payload poisonings that the
  server's update sanitation must catch.
- :class:`ServeChaos` is the ``chaos=`` hook of
  :class:`fedcrack_tpu_torch.serve.batcher.MicroBatcher` (and, through
  it, of every replica of a ``ServeFleet``): a swap installed while a batch
  is in flight, and a device lost under a batch.
- :class:`StreamChaos` is the ``chaos=`` hook of the video sessions
  (``serve/stream.py``): a mid-stream reset of the tile cache.
- :class:`MeshChaos` is the ``fault_injector`` of the slot driver
  (``parallel.driver.run_mesh_federation``): a device failure before a
  round attempt, or NaNs poured over its output, each absorbed by a
  bounded replay.

A server kill is deliberately not a hook: a dead process cannot run one.
The harnesses call ``transport.service.ServerThread.kill`` and boot a
fresh ``FedServer`` over the same statefile, so the recovery path under
test is the statefile restore itself.

Injected crashes surface as :class:`InjectedCrash`, an ordinary exception
escaping the client session. The injected flap, ``InjectedRpcError``, is a
``grpc.RpcError`` and lives in ``transport/faults.py``; this package
reaches it lazily and imports without grpc.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fedcrack_tpu_torch.chaos.plan import (
    CORRUPT_COMPRESSED_FRAME,
    CORRUPT_PAYLOAD,
    CRASH_AFTER_UPLOAD,
    CRASH_BEFORE_UPLOAD,
    CRASH_DURING_UPLOAD,
    MESH_DEVICE_FAIL,
    MESH_NONFINITE,
    NAN_UPDATE,
    NETWORK_FLAP,
    SCALED_UPDATE,
    SECAGG_DROPOUT,
    SERVE_DEVICE_LOSS,
    SERVE_STREAM_RESET,
    SERVE_SWAP_MIDFLIGHT,
    STALE_REPLAY,
    STRAGGLER_DELAY,
    TRUNCATE_PAYLOAD,
    FaultPlan,
)

# SCALED_UPDATE's amplification: a scaled real update lies far outside any
# honest cohort's norm spread, and float32 stays finite for any realistic
# weight magnitude.
SCALE_FACTOR = 1000.0

class InjectedCrash(Exception):
    """The planned death of a client process (raised out of the session)."""


class InjectedDeviceFailure(Exception):
    """A planned device loss (raised out of a served batch)."""


def _round_of(msg) -> int | None:
    """The protocol round a ``wire.ClientMessage`` speaks about, if any."""
    if msg.kind in ("done", "training", "poll"):
        return int(msg.msg.round)
    return None


def _as_array(leaf):
    """A decoded leaf as the JAX package's ``np.asarray`` sees it. A
    bfloat16 wire leaf stays a CPU ``torch.bfloat16`` tensor here (an
    ``ml_dtypes`` array of kind ``V`` there), so neither package poisons
    or scales it."""
    return leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _is_float(arr) -> bool:
    return isinstance(arr, np.ndarray) and arr.dtype.kind == "f"


def _rewrite_frame(blob: bytes, int8_scales, topk_values, first_only: bool) -> bytes:
    """Decode an FCWF frame, rewrite each int8 leaf's scales with
    ``int8_scales(scales_bytes) -> bytes`` and each top-k leaf's float32
    value region with ``topk_values(n) -> bytes`` (only the first leaf that
    has one with ``first_only``), and re-frame it with a fresh CRC."""
    from fedcrack_tpu_torch.compress import decode_frame, encode_frame

    frame = decode_frame(blob)
    leaves = [dict(spec) for spec in frame.leaves]
    payload = bytearray(frame.payload)
    off, done = 0, False
    for spec in leaves:
        n = 1
        for s in spec.get("shape") or []:
            n *= int(s)
        if spec.get("enc") == "int8":
            if not (first_only and done) and spec.get("scales"):
                spec["scales"] = int8_scales(spec["scales"])
                done = True
            off += n
        else:  # topk: k int32 indices then k float32 values
            k = int(spec.get("k", 0))
            if not (first_only and done) and k:
                payload[off + 4 * k : off + 8 * k] = topk_values(bytes(payload[off + 4 * k : off + 8 * k]))
                done = True
            off += 8 * k
    return encode_frame(frame.codec, frame.round, frame.base_version, leaves, bytes(payload))


def _poison_weights(blob: bytes, mode: str) -> bytes:
    """``blob`` (raw msgpack or an FCWF frame) poisoned the way ``mode``
    says; byte-equal to the JAX package's on the same input."""
    from fedcrack_tpu_torch.compress import is_frame

    if mode == CORRUPT_COMPRESSED_FRAME:
        if not is_frame(blob):
            # A raw blob has no checksum, and one flipped bit in a float is
            # valid msgpack that sanitation would pass into FedAvg: on a
            # null-codec cohort the fault degrades to the structural
            # mangle, which the decode gate always rejects.
            return _poison_weights(blob, CORRUPT_PAYLOAD)
        # One flipped bit inside the frame body, past the magic and CRC
        # header: it still looks like a frame, so only the CRC can catch it.
        pos = min(max(8, (3 * len(blob)) // 4), len(blob) - 1)
        return blob[:pos] + bytes([blob[pos] ^ 0x10]) + blob[pos + 1 :]
    if mode == TRUNCATE_PAYLOAD:
        return blob[: max(1, len(blob) // 2)]
    if mode == CORRUPT_PAYLOAD:
        # The msgpack structure (leading map and key bytes), not a float
        # byte, so the server's decode fails instead of landing garbage.
        return bytes(b ^ 0xFF for b in blob[:8]) + blob[8:]
    if mode == NAN_UPDATE:
        from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_unflatten
        from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes

        if is_frame(blob):
            # Poison inside the frame and re-frame it: a CRC-valid frame
            # whose reconstruction is non-finite, which validate_update
            # must refuse (the CRC failure is CORRUPT_COMPRESSED_FRAME).
            return _rewrite_frame(
                blob,
                lambda scales: np.full(len(scales) // 4, np.inf, np.float32).tobytes(),
                lambda values: np.full(len(values) // 4, np.nan, np.float32).tobytes(),
                first_only=True,
            )
        # The first leaf in the JAX package's flatten order: dicts by
        # sorted key (fed/pytree.py walks trees that way).
        leaves, treedef = tree_flatten(tree_from_bytes(blob))
        leaves = [_as_array(leaf) for leaf in leaves]
        if leaves and _is_float(leaves[0]):
            leaves[0] = np.full_like(leaves[0], np.nan)
        return tree_to_bytes(tree_unflatten(treedef, leaves))
    if mode == SCALED_UPDATE:
        from fedcrack_tpu_torch.fed.pytree import tree_map
        from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes

        if is_frame(blob):
            # int8 leaves amplify through their dequant scales, top-k
            # leaves through their float value region; the frame stays
            # CRC-valid and decodes to the scaled reconstruction.
            return _rewrite_frame(
                blob,
                lambda scales: (np.frombuffer(scales, np.float32) * np.float32(SCALE_FACTOR)).tobytes(),
                lambda values: (np.frombuffer(values, np.float32) * np.float32(SCALE_FACTOR)).tobytes(),
                first_only=False,
            )
        def scaled(leaf):
            arr = _as_array(leaf)
            return arr * np.asarray(SCALE_FACTOR, arr.dtype) if _is_float(arr) else arr

        return tree_to_bytes(tree_map(scaled, tree_from_bytes(blob)))
    raise ValueError(f"not a payload poison: {mode}")


class ClientChaos:
    """Per-client fault hook; attach one instance per injected FedClient."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._flap_left = 0
        self._crash_armed = False

    def before_send(self, cname: str, msg) -> None:
        """May raise (crash or flap), sleep (straggler), or change ``msg``
        in place (payload poisons). Runs inside the retry loop: a raised
        flap takes the except-path a real UNAVAILABLE would."""
        if self._crash_armed:
            raise InjectedCrash(f"{cname}: crash after upload")
        rnd = _round_of(msg)
        fault = self.plan.take(NETWORK_FLAP, client=cname, round=rnd)
        if fault is not None:
            self._flap_left = fault.count
        if self._flap_left > 0:
            from fedcrack_tpu_torch.transport.faults import InjectedRpcError

            self._flap_left -= 1
            raise InjectedRpcError(f"{cname}: injected flap")
        if msg.kind != "done":
            return
        if self.plan.take(CRASH_BEFORE_UPLOAD, client=cname, round=rnd) is not None:
            raise InjectedCrash(f"{cname}: crash before upload (round {rnd})")
        if self.plan.take(SECAGG_DROPOUT, client=cname, round=rnd) is not None:
            # The seed is in the frozen roster and every survivor masked
            # against it: dying here forces the server's seed recovery.
            raise InjectedCrash(f"{cname}: secagg masker dropout (round {rnd})")
        fault = self.plan.take(STRAGGLER_DELAY, client=cname, round=rnd)
        if fault is not None:
            time.sleep(fault.delay_s)
        for mode in (CORRUPT_PAYLOAD, TRUNCATE_PAYLOAD, NAN_UPDATE, CORRUPT_COMPRESSED_FRAME, SCALED_UPDATE):
            if self.plan.take(mode, client=cname, round=rnd) is not None:
                msg.msg.weights = _poison_weights(msg.msg.weights, mode)
        if self.plan.take(STALE_REPLAY, client=cname, round=rnd) is not None:
            msg.msg.round = max(1, int(msg.msg.round) - 1)

    def after_reply(self, cname: str, msg, reply) -> None:
        """Crash after the server processed the upload: ``during`` dies
        here (the client never learns its report landed), ``after`` arms a
        crash for the next call (the client knew, then died)."""
        if msg.kind != "done":
            return
        rnd = _round_of(msg)
        if self.plan.take(CRASH_DURING_UPLOAD, client=cname, round=rnd) is not None:
            raise InjectedCrash(f"{cname}: crash during upload (round {rnd})")
        if self.plan.take(CRASH_AFTER_UPLOAD, client=cname, round=rnd) is not None:
            self._crash_armed = True


class MeshChaos:
    """``fault_injector`` for the slot driver's bounded-retry round loop."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __call__(self, round_idx: int, attempt: int):
        """Called before each attempt of round ``round_idx``. Raises for a
        device failure; returns a ``(variables, metrics) -> (variables,
        metrics)`` poison for silent corruption; None for a clean attempt.
        Faults are one-shot, so the replay after a failure runs clean."""
        if self.plan.take(MESH_DEVICE_FAIL, round=round_idx) is not None:
            raise InjectedDeviceFailure(f"injected device failure (round {round_idx}, attempt {attempt})")
        if self.plan.take(MESH_NONFINITE, round=round_idx) is not None:
            return _nan_poison
        return None


class ServeChaos:
    """``chaos=`` hook of :class:`fedcrack_tpu_torch.serve.batcher.MicroBatcher`.

    Called as ``on_batch(bucket, batch_index, attempt)`` between the
    worker's weights snapshot and the dispatch, the window where a hot swap
    or a device loss is most dangerous:

    - ``SERVE_SWAP_MIDFLIGHT`` (``round == batch_index``) calls
      ``swap_hook()`` (typically ``manager.poll_once``), installing a new
      model after the in-flight batch took its snapshot; the batch must
      still answer entirely from that snapshot.
    - ``SERVE_DEVICE_LOSS`` raises :class:`InjectedDeviceFailure`; the
      batcher retries the batch with a fresh snapshot and drops no request.

    Faults fire only on ``attempt`` 0, so the retry runs clean.
    """

    def __init__(self, plan: FaultPlan, swap_hook=None):
        self.plan = plan
        self.swap_hook = swap_hook

    def on_batch(self, bucket: int, batch_index: int, attempt: int) -> None:
        if attempt > 0:
            return
        if self.plan.take(SERVE_SWAP_MIDFLIGHT, round=batch_index) is not None:
            if self.swap_hook is not None:
                self.swap_hook()
        if self.plan.take(SERVE_DEVICE_LOSS, round=batch_index) is not None:
            raise InjectedDeviceFailure(
                f"injected serving device loss (bucket {bucket}, batch {batch_index}, attempt {attempt})"
            )


class StreamChaos:
    """``chaos=`` hook of the video sessions (``serve/stream.py``).

    Called as ``on_frame(stream_id, frame_index, session)`` at the top of
    each frame, before the snapshot is pinned or any tile is hashed.
    ``SERVE_STREAM_RESET`` (``round == frame_index``, 0-based) calls
    ``session.reset()``: the tile cache is dropped mid-stream, so the frame
    is served as a full re-run. A reset changes latency, never bytes.
    """

    def __init__(self, plan: FaultPlan, manager=None):
        self.plan = plan
        self.manager = manager

    def on_frame(self, stream_id: str, frame_index: int, session) -> None:
        if self.plan.take(SERVE_STREAM_RESET, round=frame_index) is not None:
            session.reset()
            if self.manager is not None:
                self.manager.record_reset()


def _nan_poison(variables, metrics):
    """Every floating leaf of the round's output replaced by NaNs, on its
    device."""
    from fedcrack_tpu_torch.fed.pytree import tree_map

    def nanify(tree):
        return tree_map(
            lambda a: torch.full_like(a, float("nan")) if isinstance(a, torch.Tensor) and a.is_floating_point()
            else (np.full_like(a, np.nan) if isinstance(a, np.ndarray) and a.dtype.kind == "f" else a),
            tree,
        )

    return nanify(variables), nanify(metrics)
