"""The port's hand-written protobuf codec (transport/wire.py) and its
message <-> event mapping (transport/codec.py), held against the JAX
package's generated ``transport_pb2`` and ``transport.codec`` on the CPU.

A message without a map is byte-equal to ``SerializeToString``; every
message round-trips both ways (port bytes -> ``FromString`` -> the same
message, and ``SerializeToString`` bytes -> the port's decode); unknown
fields are skipped, as protobuf skips them.
"""

import math

import pytest

from fedcrack_tpu.transport import codec as jcodec
from fedcrack_tpu.transport import transport_pb2 as pb
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.transport import codec as tcodec
from fedcrack_tpu_torch.transport import wire as W

pytestmark = pytest.mark.torch_port

I32_MIN, I32_MAX, I64_MIN, I64_MAX = -(2**31), 2**31 - 1, -(2**63), 2**63 - 1


def _pb_client(kind, cname="c", token="", **fields):
    m = pb.ClientMessage(cname=cname, token=token)
    getattr(m, kind).SetInParent()
    for k, v in fields.items():
        setattr(getattr(m, kind), k, v)
    return m


# (pb message, port message), no maps: byte-equal both ways.
PLAIN = {
    "empty": (pb.ClientMessage(), W.ClientMessage()),
    "names_only": (pb.ClientMessage(cname="client-ä", token="tok"), W.ClientMessage("client-ä", "tok")),
    "ready_empty": (_pb_client("ready"), W.ClientMessage("c", msg=W.ReadyReq())),
    "pull": (_pb_client("pull", token="t"), W.ClientMessage("c", "t", W.PullReq())),
    "training": (_pb_client("training", round=3), W.ClientMessage("c", msg=W.TrainingNotice(3))),
    "training_zero": (_pb_client("training", round=0), W.ClientMessage("c", msg=W.TrainingNotice(0))),
    "training_negative": (_pb_client("training", round=I32_MIN), W.ClientMessage("c", msg=W.TrainingNotice(I32_MIN))),
    "log_full": (_pb_client("log", title="events.tb", data=b"\x00\xff" * 200, offset=2**40, last=True,
                            crc32c=0xFFFFFFFF),
                 W.ClientMessage("c", msg=W.LogChunk("events.tb", b"\x00\xff" * 200, 2**40, True, 0xFFFFFFFF))),
    "log_crc_zero_is_present": (_pb_client("log", title="t", crc32c=0),
                                W.ClientMessage("c", msg=W.LogChunk("t", crc32c=0))),
    "log_no_crc": (_pb_client("log", data=b"d", offset=-1), W.ClientMessage("c", msg=W.LogChunk(data=b"d", offset=-1))),
    "done": (_pb_client("done", round=I32_MAX, weights=b"w" * 70000, sample_count=I64_MIN),
             W.ClientMessage("c", msg=W.TrainDone(I32_MAX, b"w" * 70000, I64_MIN))),
    "done_empty": (_pb_client("done"), W.ClientMessage("c", msg=W.TrainDone())),
    "poll": (_pb_client("poll", model_version=7, round=-2), W.ClientMessage("c", msg=W.VersionPoll(7, -2))),
    "server": (pb.ServerMessage(status="RESP_ARY", weights=b"\x81" * 300, title="parameters"),
               W.ServerMessage("RESP_ARY", {}, b"\x81" * 300, "parameters")),
    "server_empty": (pb.ServerMessage(), W.ServerMessage()),
}


def _pb_decode(port_msg, data):
    return (pb.ClientMessage if isinstance(port_msg, W.ClientMessage) else pb.ServerMessage).FromString(data)


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_messages_without_a_map_are_byte_equal_and_round_trip(case):
    want, port = PLAIN[case]
    data = want.SerializeToString()
    assert port.encode() == data
    assert type(port).decode(data) == port
    assert _pb_decode(port, port.encode()) == want


SCALARS = {"i": 3, "neg": -5, "big": I64_MAX, "small": I64_MIN, "zero": 0, "f": 0.5, "nf": -0.0,
           "inf": math.inf, "s": "SW", "empty": "", "unicode": "ü", "t": True, "false": False,
           "b": b"\x00\x01", "nob": b""}


@pytest.mark.parametrize("where", ["server.config", "ready.config", "done.metrics"])
def test_scalar_maps_round_trip_both_ways(where):
    if where == "server.config":
        want = pb.ServerMessage(status="SW", weights=b"x")
        jcodec.encode_scalar_map(want.config, SCALARS)
        port = W.ServerMessage("SW", dict(SCALARS), b"x")
    else:
        kind, field = where.split(".")
        want = _pb_client(kind, token="tok")
        jcodec.encode_scalar_map(getattr(getattr(want, kind), field), SCALARS)
        body = W.ReadyReq(dict(SCALARS)) if kind == "ready" else W.TrainDone(metrics=dict(SCALARS))
        if kind == "done":
            want.done.round, want.done.weights, body.round, body.weights = 2, b"w", 2, b"w"
        port = W.ClientMessage("c", "tok", body)
    assert type(port).decode(want.SerializeToString()) == port
    assert _pb_decode(port, port.encode()) == want
    decoded = type(port).decode(port.encode())
    values = decoded.config if where == "server.config" else getattr(decoded.msg, where.split(".")[1])
    assert values == SCALARS and all(type(values[k]) is type(v) for k, v in SCALARS.items())


def test_an_unset_scalar_decodes_to_none_as_in_jax():
    m = pb.ServerMessage(status="OK")
    m.config["none"].SetInParent()
    m.config["x"].as_int = 1
    got = W.ServerMessage.decode(m.SerializeToString())
    assert got.config == jcodec.decode_scalar_map(m.config) == {"none": None, "x": 1}
    assert tcodec.decode_scalar_map(got.config) == {"none": None, "x": 1}


def _field(number, wire_type, payload):
    out = bytearray()
    W._varint((number << 3) | wire_type, out)
    if wire_type == 2:
        W._varint(len(payload), out)
    return bytes(out) + payload


UNKNOWN = [
    _field(99, 0, b"\x96\x01"),                 # varint
    _field(15, 1, b"\x01" * 8),                 # fixed64
    _field(2047, 2, b"anything"),               # length-delimited
    _field(12, 5, b"\x00" * 4),                 # fixed32
    _field(13, 3, _field(1, 0, b"\x05")) + bytes([(13 << 3) | 4]),   # a group
    _field(1, 0, b"\x07"),                      # cname with the wrong wire type
]


@pytest.mark.parametrize("extra", range(len(UNKNOWN)))
def test_unknown_fields_are_skipped_as_protobuf_skips_them(extra):
    want = _pb_client("done", cname="c", token="t", round=2, weights=b"w", sample_count=5)
    data = UNKNOWN[extra] + want.SerializeToString() + UNKNOWN[extra]
    parsed = pb.ClientMessage.FromString(data)
    parsed.DiscardUnknownFields()
    assert parsed == want
    assert W.ClientMessage.decode(data) == W.ClientMessage("c", "t", W.TrainDone(2, b"w", 5))
    msg = _field(6, 2, W.TrainDone(2, b"w", 5).encode() + UNKNOWN[extra])
    parsed = pb.ClientMessage.FromString(msg)
    parsed.DiscardUnknownFields()
    got = W.ClientMessage.decode(msg).msg
    assert (got.round, got.weights, got.sample_count) == \
        (parsed.done.round, parsed.done.weights, parsed.done.sample_count)


def test_repeated_fields_merge_and_oneof_last_member_wins_as_in_protobuf():
    a = _field(6, 2, W.TrainDone(round=2).encode())
    b = _field(6, 2, W.TrainDone(weights=b"w").encode())
    for data in (a + b, _field(7, 2, W.VersionPoll(1, 1).encode()) + a + b):
        assert W.ClientMessage.decode(data).msg == W.TrainDone(2, b"w")
        assert pb.ClientMessage.FromString(data).done == pb.TrainDone(round=2, weights=b"w")
    data = a + _field(3, 2, b"")
    assert W.ClientMessage.decode(data).kind == pb.ClientMessage.FromString(data).WhichOneof("msg") == "pull"
    twice = _field(1, 2, b"x") + _field(1, 2, b"yz")
    assert W.ServerMessage.decode(twice).status == pb.ServerMessage.FromString(twice).status == "yz"


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x08", b"\x0a\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01",
                                  b"\x0a\x02\xff\xfe", b"\x00\x01", b"\x0e\x01"])
def test_malformed_input_raises_where_protobuf_does(data):
    from google.protobuf.message import DecodeError as PbDecodeError

    with pytest.raises(PbDecodeError):
        pb.ServerMessage.FromString(data)
    with pytest.raises(W.DecodeError):
        W.ServerMessage.decode(data)


def test_encoder_refuses_what_protobuf_refuses():
    for bad in (W.TrainingNotice(2**31), W.VersionPoll(model_version=-(2**31) - 1), W.TrainDone(sample_count=2**63)):
        with pytest.raises(ValueError):
            bad.encode()
    with pytest.raises(ValueError):
        pb.TrainingNotice(round=2**31)
    with pytest.raises(TypeError):
        W.ServerMessage(config={"x": [1]}).encode()
    with pytest.raises(TypeError):
        tcodec.encode_scalar_map({}, {"x": None})
    with pytest.raises(TypeError):
        jcodec.encode_scalar_map(pb.ServerMessage().config, {"x": None})


EVENTS = {
    "ready": lambda m: (m.ready.SetInParent(), m.ready.config["current_round"].__setattr__("as_int", 0)),
    "ready_seed": lambda m: m.ready.config["__secagg_seed"].__setattr__("as_int", 77),
    "ready_bad_seed": lambda m: m.ready.config["__secagg_seed"].__setattr__("as_string", "77"),
    "pull": lambda m: m.pull.SetInParent(),
    "training": lambda m: m.training.__setattr__("round", 2),
    "log": lambda m: (m.log.__setattr__("title", "t"), m.log.__setattr__("data", b"abc"),
                      m.log.__setattr__("offset", 3)),
    "log_crc_ok": lambda m: (m.log.__setattr__("data", b"abc"), m.log.__setattr__("crc32c", 0x364B3FB7)),
    "log_crc_bad": lambda m: (m.log.__setattr__("data", b"abc"), m.log.__setattr__("crc32c", 1)),
    "done": lambda m: (m.done.__setattr__("round", 1), m.done.__setattr__("weights", b"w"),
                       m.done.__setattr__("sample_count", 9)),
    "done_trace": lambda m: (m.done.__setattr__("round", 1),
                             m.done.metrics["__trace"].__setattr__("as_string", "fedtr-v0#push:c:r1"),
                             m.done.metrics["loss"].__setattr__("as_double", 0.5)),
    "done_bad_trace": lambda m: m.done.metrics["__trace"].__setattr__("as_int", 5),
    "poll": lambda m: (m.poll.__setattr__("model_version", 1), m.poll.__setattr__("round", 2)),
    "empty": lambda m: None,
}


def _event(codec, data, now):
    try:
        return codec.event_from_message(data, now)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(EVENTS))
def test_events_from_messages_match_jax(case):
    m = pb.ClientMessage(cname="c", token="t")
    EVENTS[case](m)
    want = _event(jcodec, m, 1.5)
    got = _event(tcodec, W.ClientMessage.decode(m.SerializeToString()), 1.5)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)


def test_replies_to_messages_match_jax():
    from fedcrack_tpu.fed import rounds as JR

    for kw in (dict(status="RESP_ARY", config={"current_round": 2, "lr": 0.1, "codec": "int8", "secagg": False},
                    blob=b"W", title="p"),
               dict(status="REJECTED", config={"reason": "stale round", "client_round": 1}),
               dict(status="OK", blob=b""), dict(status="WAIT")):
        want = jcodec.message_from_reply(JR.Reply(**kw))
        got = tcodec.message_from_reply(TR.Reply(**kw))
        assert W.ServerMessage.decode(want.SerializeToString()) == got
        assert pb.ServerMessage.FromString(got.encode()) == want
