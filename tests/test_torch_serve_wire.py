"""The serving plane's messages in the port's hand-written protobuf codec
(``transport/wire.py``), held against the JAX package's generated
``transport_pb2`` on the CPU.

Each ``ServePlane`` message encodes byte-equal to ``SerializeToString``
and decodes what it writes, with ``crc32c`` present (zero included) and
absent, ``float`` fields at 0.0, -0.0, values that round in single
precision, values past its range and NaN, every member of
``StreamRequest``'s oneof, and unknown fields skipped.
"""

import math
import struct

import pytest

from fedcrack_tpu.transport import transport_pb2 as pb
from fedcrack_tpu_torch.transport import wire as W

pytestmark = pytest.mark.torch_port

U64_MAX, I32_MIN, I32_MAX, I64_MIN = 2**64 - 1, -(2**31), 2**31 - 1, -(2**63)
# Doubles that round in single precision, one under its smallest normal,
# and one past its range.
FLOATS = [0.1, 1 / 3, 0.5, 1e-42, 3.5e38, 123456.789]


def _pb_stream(kind, stream_id="s", **fields):
    m = pb.StreamRequest(stream_id=stream_id)
    getattr(m, kind).SetInParent()
    for k, v in fields.items():
        setattr(getattr(m, kind), k, v)
    return m


CASES = {
    "predict_empty": (pb.PredictRequest(), W.PredictRequest()),
    "predict_full": (
        pb.PredictRequest(client_id="cam-ä", request_id=U64_MAX, height=600, width=400, channels=3,
                          image=b"\x00\xff" * 3000, offset=2**40, last=True, crc32c=0xFFFFFFFF,
                          threshold=0.3, deadline_ms=250.0),
        W.PredictRequest("cam-ä", U64_MAX, 600, 400, 3, b"\x00\xff" * 3000, 2**40, True, 0xFFFFFFFF, 0.3, 250.0),
    ),
    "predict_crc_zero_is_present": (pb.PredictRequest(request_id=1, crc32c=0),
                                    W.PredictRequest(request_id=1, crc32c=0)),
    "predict_negative_dims": (pb.PredictRequest(height=I32_MIN, width=-1, channels=I32_MAX, offset=I64_MIN),
                              W.PredictRequest(height=I32_MIN, width=-1, channels=I32_MAX, offset=I64_MIN)),
    "predict_negative_zero": (pb.PredictRequest(threshold=-0.0), W.PredictRequest(threshold=-0.0)),
    "response_ok": (
        pb.PredictResponse(request_id=7, status="OK", mask=b"\xff" * 1000, model_version=2,
                           latency_ms=5.25, queue_ms=0.125, height=20, width=50),
        W.PredictResponse(7, "OK", b"\xff" * 1000, 2, 5.25, 0.125, 20, 50),
    ),
    "response_rejected": (
        pb.PredictResponse(request_id=3, status="REJECTED", title="image chunk checksum mismatch"),
        W.PredictResponse(3, "REJECTED", title="image chunk checksum mismatch"),
    ),
    "response_empty": (pb.PredictResponse(), W.PredictResponse()),
    "stream_open": (_pb_stream("open", height=512, width=768, channels=3, threshold=0.5, track=True,
                               smooth_alpha=0.25),
                    W.StreamRequest("s", W.StreamOpen(512, 768, 3, 0.5, True, 0.25))),
    "stream_open_empty": (_pb_stream("open", stream_id=""), W.StreamRequest("", W.StreamOpen())),
    "stream_frame": (_pb_stream("frame", frame_id=U64_MAX, image=b"\x01" * 5000, offset=4096, last=True,
                                crc32c=0x1234),
                     W.StreamRequest("s", W.StreamFrame(U64_MAX, b"\x01" * 5000, 4096, True, 0x1234))),
    "stream_frame_no_crc": (_pb_stream("frame", frame_id=2, image=b"ab"),
                            W.StreamRequest("s", W.StreamFrame(2, b"ab"))),
    "stream_close": (_pb_stream("close", stream_id="cam-1"), W.StreamRequest("cam-1", W.StreamClose())),
    "stream_none": (pb.StreamRequest(stream_id="x"), W.StreamRequest("x")),
    "stream_response": (
        pb.StreamResponse(frame_id=9, status="OK", mask=b"\x00\xff" * 99, model_version=I32_MAX,
                          latency_ms=12.5, height=512, width=768, title="OPENED", tiles_total=12,
                          tiles_computed=4, cache_hits=8, full_rerun=True, tracks_json='[{"id": 1}]'),
        W.StreamResponse(9, "OK", b"\x00\xff" * 99, I32_MAX, 12.5, 512, 768, "OPENED", 12, 4, 8, True,
                         '[{"id": 1}]'),
    ),
    "stream_response_empty": (pb.StreamResponse(), W.StreamResponse()),
}
# A message as decoded: floats rounded to single precision.
DECODED = {
    "predict_full": W.PredictRequest("cam-ä", U64_MAX, 600, 400, 3, b"\x00\xff" * 3000, 2**40, True, 0xFFFFFFFF,
                                     struct.unpack("<f", struct.pack("<f", 0.3))[0], 250.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_messages_byte_equal_and_round_trip(case):
    want, port = CASES[case]
    data = want.SerializeToString()
    assert port.encode() == data
    assert type(port).decode(data) == DECODED.get(case, port)
    assert type(want).FromString(port.encode()) == want


@pytest.mark.parametrize("value", FLOATS + [-v for v in FLOATS] + [1e-50, 1e40, -1e40, math.inf, -math.inf])
def test_float_fields_round_like_protobuf(value):
    for want, port in (
        (pb.PredictRequest(threshold=value, deadline_ms=value), W.PredictRequest(threshold=value, deadline_ms=value)),
        (pb.PredictResponse(latency_ms=value, queue_ms=value), W.PredictResponse(latency_ms=value, queue_ms=value)),
        (_pb_stream("open", threshold=value, smooth_alpha=value),
         W.StreamRequest("s", W.StreamOpen(threshold=value, smooth_alpha=value))),
        (pb.StreamResponse(latency_ms=value), W.StreamResponse(latency_ms=value)),
    ):
        data = want.SerializeToString()
        assert port.encode() == data
        got = type(port).decode(data)
        assert type(want).FromString(port.encode()) == want
        back = got.encode()
        assert back == data
    decoded = W.PredictRequest.decode(pb.PredictRequest(threshold=value).SerializeToString()).threshold
    assert decoded == pb.PredictRequest(threshold=value).threshold  # the same single-precision value


def test_float_nan_and_zero_presence():
    nan = W.PredictResponse(latency_ms=math.nan).encode()
    assert nan == pb.PredictResponse(latency_ms=math.nan).SerializeToString()
    assert math.isnan(W.PredictResponse.decode(nan).latency_ms)
    assert W.PredictRequest(threshold=0.0).encode() == b""  # implicit presence
    assert W.PredictRequest(threshold=1e-50).encode() == b""  # rounds to +0.0 in single precision
    assert W.PredictRequest(threshold=-0.0).encode() == b"\x55\x00\x00\x00\x80"  # -0.0 has a bit set
    with pytest.raises(TypeError):
        W.PredictRequest(threshold="0.5").encode()


def test_oneof_last_member_wins_and_repeated_member_merges():
    first = _pb_stream("open", height=4).SerializeToString()
    frame = _pb_stream("frame", frame_id=5).SerializeToString()
    got = W.StreamRequest.decode(first + frame)
    assert got.kind == "frame" and got.msg == W.StreamFrame(5)
    assert pb.StreamRequest.FromString(first + frame).WhichOneof("msg") == "frame"
    merged = W.StreamRequest.decode(first + _pb_stream("open", width=9).SerializeToString())
    assert merged.msg == W.StreamOpen(height=4, width=9)
    assert [W.StreamRequest("s", m).kind for m in (W.StreamOpen(), W.StreamFrame(), W.StreamClose(), None)] == [
        "open", "frame", "close", None]


def test_unknown_fields_skipped_and_bad_input_raises():
    # Field 99 (varint), 98 (fixed64), 97 (bytes) and 96 (fixed32) are not in the schema.
    extra = b"\x98\x06\x01" + b"\x91\x06" + b"\x00" * 8 + b"\x8a\x06\x02ab" + b"\x85\x06" + b"\x00" * 4
    for want, port in (CASES["predict_full"], CASES["response_ok"], CASES["stream_frame"],
                       CASES["stream_response"]):
        data = want.SerializeToString()
        assert type(port).decode(extra + data + extra) == type(port).decode(data)
    # A known field sent with another wire type is skipped too (threshold as a varint).
    assert W.PredictRequest.decode(b"\x50\x05").threshold == 0.0
    with pytest.raises(W.DecodeError):
        W.PredictRequest.decode(b"\x0a\x05ab")  # truncated
    with pytest.raises(ValueError):
        W.PredictRequest(request_id=-1).encode()
    with pytest.raises(ValueError):
        W.PredictRequest(crc32c=2**32).encode()
