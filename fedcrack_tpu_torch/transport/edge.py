"""The edge tier's gRPC half toward the root.

The counterpart of ``fedcrack_tpu.transport.edge``. An edge speaks down to
its leaves as an aggregator (``fed.tree.EdgeAggregator``) and up to the
root as an ordinary protocol client: it enrolls under its edge id, pulls
the round base and reports its shard's partial as one ``TrainDone`` whose
``sample_count`` is the shard's sample sum, so the root's sample-weighted
FedAvg needs no change. The messages are ``transport/wire.py``'s; a relay
of either package talks to a ``FedServer`` of either package.

Unlike the JAX package's, whose channels keep grpc's 4 MiB default, the
channel carries messages up to ``FedConfig``'s default ``max_message_mb``
(512), so a relay moves a full-width model's blob.
"""

from __future__ import annotations

from typing import Any, Callable

from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.transport import wire
from fedcrack_tpu_torch.transport.codec import decode_scalar_map, encode_scalar_map


def raw_caller(port: int, host: str = "127.0.0.1", timeout_s: float = 10.0) -> tuple[Any, Callable]:
    """A one-message-per-call client on the shared bidi method: returns
    ``(channel, call)`` where ``call(ClientMessage) -> ServerMessage``.
    No retries; a failed call raises."""
    import grpc

    from fedcrack_tpu_torch.transport.service import METHOD, SERVICE_NAME, channel_options

    channel = grpc.insecure_channel(f"{host}:{port}", options=channel_options(FedConfig.max_message_mb))
    method = channel.stream_stream(
        f"/{SERVICE_NAME}/{METHOD}",
        request_serializer=wire.ClientMessage.encode,
        response_deserializer=wire.ServerMessage.decode,
    )

    def call(msg: wire.ClientMessage) -> wire.ServerMessage:
        return next(iter(method(iter([msg]), timeout=timeout_s, wait_for_ready=True)))

    return channel, call


class EdgeRelay:
    """The edge-to-root session: enroll, pull the round base, push the
    partial, adopt the root's new global. The root's cohort is the edge
    ids, so quorum, the deadline, the statefile and the gate apply to
    edges as they do to clients."""

    def __init__(self, edge_id: str, port: int, host: str = "127.0.0.1", timeout_s: float = 10.0):
        self.edge_id = edge_id
        self._channel, self._call = raw_caller(port, host, timeout_s)

    def _send(self, body) -> wire.ServerMessage:
        return self._call(wire.ClientMessage(cname=self.edge_id, msg=body))

    def enroll(self) -> dict:
        """Join the root's cohort; returns the handshake map
        (``current_round``, ``model_version``, the codec knobs)."""
        rep = self._send(wire.ReadyReq())
        if rep.status != R.SW:
            raise RuntimeError(f"edge {self.edge_id} not enrolled at root: {rep.status}")
        return dict(decode_scalar_map(rep.config))

    def pull(self) -> bytes:
        """The root's broadcast blob: the base the leaves train on and
        framed deltas decode against."""
        return self._send(wire.PullReq()).weights

    def push_partial(
        self, round_idx: int, blob: bytes, total_samples: int, trace_ctx: str = ""
    ) -> tuple[str, bytes, dict]:
        """Report the shard's partial for ``round_idx``. Returns ``(status,
        new_global_or_empty, config)``; RESP_ARY and FIN carry the root's
        average, the leaves' next base. ``trace_ctx``, the edge flush
        span's wire context, rides as ``__trace`` so the root links the
        edge as it links a client."""
        metrics: dict = {}
        if trace_ctx:
            encode_scalar_map(metrics, {"__trace": trace_ctx})
        rep = self._send(wire.TrainDone(
            round=int(round_idx), weights=blob, sample_count=int(total_samples), metrics=metrics
        ))
        return rep.status, rep.weights, dict(decode_scalar_map(rep.config))

    def poll(self, model_version: int, round_idx: int) -> tuple[str, bytes, dict]:
        """A version poll (WAIT until the round closes)."""
        rep = self._send(wire.VersionPoll(model_version=int(model_version), round=int(round_idx)))
        return rep.status, rep.weights, dict(decode_scalar_map(rep.config))

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "EdgeRelay":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
