"""Wire messages <-> round-machine events.

The counterpart of ``fedcrack_tpu.transport.codec``: every inbound
``ClientMessage`` becomes exactly one ``fed.rounds`` event (stamped with
the server clock) and every ``Reply`` one ``ServerMessage``. The protocol
lives in ``fed/rounds.py``; nothing here inspects state.
"""

from __future__ import annotations

from typing import Any, Mapping

from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.native import crc32c
from fedcrack_tpu_torch.transport import wire


def encode_scalar_map(target: dict, values: Mapping[str, Any]) -> None:
    """Fill a ``map<string, Scalar>`` from a dict: bool, int, float, str
    and bytes values; anything else raises ``TypeError``."""
    for key, val in values.items():
        if not isinstance(val, (bool, int, float, str, bytes)):
            raise TypeError(f"unsupported scalar {key}={val!r} ({type(val).__name__})")
        target[key] = val


def decode_scalar_map(source: Mapping[str, Any]) -> dict[str, Any]:
    return dict(source)


def event_from_message(msg: wire.ClientMessage, now: float) -> R.Event:
    """One inbound message -> one state-machine event."""
    kind = msg.kind
    cname = msg.cname
    body = msg.msg
    if kind == "ready":
        # The client's masking seed rides the enroll config under
        # "__secagg_seed"; anything but an int degrades to "no seed".
        seed = body.config.get("__secagg_seed")
        secagg_seed = seed if type(seed) is int else None
        return R.Ready(cname=cname, now=now, secagg_seed=secagg_seed)
    if kind == "pull":
        return R.PullWeights(cname=cname, now=now)
    if kind == "training":
        return R.TrainingNotice(cname=cname, now=now)
    if kind == "log":
        if body.crc32c is not None:
            got = crc32c(body.data)
            if got != body.crc32c:
                raise ValueError(
                    f"log chunk checksum mismatch for {body.title!r} at "
                    f"offset {body.offset}: computed {got:#010x}, "
                    f"declared {body.crc32c:#010x}"
                )
        return R.LogChunk(cname=cname, title=body.title, data=body.data, now=now, offset=body.offset)
    if kind == "done":
        # The push's trace context rides the metrics map under "__trace";
        # anything but a string degrades to "no context", never to a lost
        # upload.
        trace = body.metrics.get("__trace")
        return R.TrainDone(
            cname=cname,
            round=body.round,
            blob=body.weights,
            num_samples=body.sample_count,
            now=now,
            trace_ctx=trace if isinstance(trace, str) else "",
        )
    if kind == "poll":
        return R.VersionPoll(cname=cname, model_version=body.model_version, round=body.round, now=now)
    raise ValueError(f"empty or unknown ClientMessage (oneof={kind!r})")


def message_from_reply(reply: R.Reply) -> wire.ServerMessage:
    out = wire.ServerMessage(status=reply.status)
    if reply.config:
        encode_scalar_map(out.config, reply.config)
    if reply.blob is not None:
        out.weights = reply.blob
    if reply.title is not None:
        out.title = reply.title
    return out
