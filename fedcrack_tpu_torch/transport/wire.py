"""The federation's protobuf messages, encoded and decoded by hand.

The schema is ``transport.proto`` beside this file (the JAX package's
schema): the federation's ``Scalar``, ``ClientMessage`` with its ``msg``
oneof, ``ServerMessage`` with its config map, ``ReadyReq``, ``PullReq``,
``TrainingNotice``, ``LogChunk`` (with ``optional fixed32 crc32c``),
``TrainDone`` and ``VersionPoll``; and the serving plane's
``PredictRequest``, ``PredictResponse``, ``StreamOpen``, ``StreamFrame``,
``StreamClose``, and ``StreamRequest`` (``stream_id`` beside its ``msg``
oneof) and ``StreamResponse``. The messages are plain dataclasses and the
codec is proto3's binary format written out:

- fields in field-number order, a oneof member at its own number;
- implicit presence: a scalar at its default (0, "", b"", False) is not
  written, nor a ``float`` whose single-precision bits are all zero (so
  -0.0 is written and 1e-50 is not); a set oneof member and a set
  ``optional`` field always are;
- ``int32``/``int64`` as two's-complement varints (a negative value takes
  ten bytes), ``uint64`` as a plain varint, ``sint64`` zigzag, ``double``,
  ``fixed32`` and ``float`` (IEEE single, wire type 5, a value past its
  range rounding to an infinity) little-endian;
- a ``map<string, Scalar>`` is a repeated entry message (key 1, value 2)
  in the dict's order. Its values are Python values, ``bool``, ``int``,
  ``float``, ``str``, ``bytes``, or ``None`` for a Scalar with nothing
  set, standing for ``as_bool``, ``as_int``, ``as_double``,
  ``as_string`` and ``as_bytes``.

Decoding skips unknown fields of every wire type (and a known field
sent with another wire type), merges a repeated message field into one
(the last scalar wins), and raises :class:`DecodeError` on malformed
input. So a message without a map is
byte for byte what ``SerializeToString`` writes, and either side reads
the other's bytes.

The codec is written by hand because the port imports nothing of
``google`` (protobuf), which keeps its dependencies to torch, numpy and
grpc. That rule is the one reason: protobuf itself would serve, through a
module generated from this schema under a proto package of its own, so
that it cannot collide with the JAX package's in the descriptor pool.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Any

_I32 = (-(2**31), 2**31 - 1)
_I64 = (-(2**63), 2**63 - 1)
_U64 = (0, 2**64 - 1)
_U32 = (0, 2**32 - 1)


class DecodeError(ValueError):
    """Bytes that are no valid message of the schema."""


# ---- primitives ----

def _varint(v: int, out: bytearray) -> None:
    v &= 0xFFFFFFFFFFFFFFFF
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _key(number: int, wire_type: int, out: bytearray) -> None:
    _varint((number << 3) | wire_type, out)


def _check(v: int, bounds: tuple[int, int], what: str) -> int:
    if type(v) is bool or not isinstance(v, int):
        raise TypeError(f"{what} must be an int, got {type(v).__name__}")
    if not bounds[0] <= v <= bounds[1]:
        raise ValueError(f"value out of range for {what}: {v}")
    return v


def _put_int(number: int, v: int, bounds: tuple[int, int], what: str, out: bytearray) -> None:
    if _check(v, bounds, what):
        _key(number, 0, out)
        _varint(v, out)


def _put_len(number: int, data: bytes, out: bytearray, always: bool = False) -> None:
    if data or always:
        _key(number, 2, out)
        _varint(len(data), out)
        out += data


def _put_str(number: int, s: str, out: bytearray) -> None:
    if not isinstance(s, str):
        raise TypeError(f"field {number} must be a str, got {type(s).__name__}")
    _put_len(number, s.encode("utf-8"), out)


def _put_bytes(number: int, b: bytes, out: bytearray) -> None:
    if not isinstance(b, (bytes, bytearray)):
        raise TypeError(f"field {number} must be bytes, got {type(b).__name__}")
    _put_len(number, bytes(b), out)


def _put_bool(number: int, b: bool, out: bytearray) -> None:
    if b:
        _key(number, 0, out)
        out.append(1)


def _f32_bits(v: float) -> bytes:
    """``v`` as IEEE single, as protobuf stores a ``float`` field: round to
    nearest, overflow to an infinity of ``v``'s sign."""
    if type(v) is bool or not isinstance(v, (int, float)):
        raise TypeError(f"float field must be a number, got {type(v).__name__}")
    try:
        return struct.pack("<f", v)
    except OverflowError:
        return struct.pack("<f", math.copysign(math.inf, v))


def _put_float(number: int, v: float, out: bytearray) -> None:
    bits = _f32_bits(v)
    if bits != b"\0\0\0\0":
        _key(number, 5, out)
        out += bits


def _put_fixed32(number: int, v: int | None, what: str, out: bytearray) -> None:
    """An ``optional fixed32``: written whenever it is set (not None)."""
    if v is not None:
        _key(number, 5, out)
        out += struct.pack("<I", _check(v, _U32, what))


def _float(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v))[0]


class _Reader:
    """Walks one message's fields: ``(number, wire_type, value)`` where the
    value is an int (varint, fixed32, fixed64) or bytes (length-delimited)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def varint(self) -> int:
        shift = result = 0
        while True:
            if self.pos >= len(self.data):
                raise DecodeError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result & 0xFFFFFFFFFFFFFFFF
            shift += 7
            if shift >= 70:
                raise DecodeError("varint longer than ten bytes")

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.data):
            raise DecodeError("truncated field")
        chunk = bytes(self.data[self.pos:end])
        self.pos = end
        return chunk

    def _skip_group(self, number: int) -> None:
        while True:
            if self.pos >= len(self.data):
                raise DecodeError("unterminated group")
            key = self.varint()
            if key & 7 == 4:
                if key >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return
            self._value(key)

    def _value(self, key: int) -> Any:
        wire_type = key & 7
        if wire_type == 0:
            return self.varint()
        if wire_type == 1:
            return struct.unpack("<Q", self.take(8))[0]
        if wire_type == 2:
            return self.take(self.varint())
        if wire_type == 5:
            return struct.unpack("<I", self.take(4))[0]
        if wire_type == 3:
            self._skip_group(key >> 3)
            return None
        raise DecodeError(f"invalid wire type {wire_type}")

    def fields(self):
        while self.pos < len(self.data):
            key = self.varint()
            number = key >> 3
            if number == 0:
                raise DecodeError("field number 0")
            yield number, key & 7, self._value(key)


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _text(v: bytes) -> str:
    try:
        return v.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not valid UTF-8 ({e})") from e


def _parse(data: bytes, schema: dict) -> None:
    """Feed each field of ``data`` to ``schema[number] = (wire_type,
    setter)``; a field the schema lacks, or one with another wire type,
    is skipped as an unknown field, as protobuf does."""
    for number, wt, v in _Reader(data).fields():
        spec = schema.get(number)
        if spec is not None and spec[0] == wt:
            spec[1](v)


# ---- Scalar and map<string, Scalar> ----

def _encode_scalar(value: Any) -> bytes:
    out = bytearray()
    if value is None:
        return b""
    if isinstance(value, bool):
        _key(4, 0, out)
        out.append(1 if value else 0)
    elif isinstance(value, int):
        _check(value, _I64, "as_int")
        _key(1, 0, out)
        _varint((value << 1) ^ (value >> 63), out)
    elif isinstance(value, float):
        _key(2, 1, out)
        out += struct.pack("<d", value)
    elif isinstance(value, str):
        _put_len(3, value.encode("utf-8"), out, always=True)
    elif isinstance(value, (bytes, bytearray)):
        _put_len(5, bytes(value), out, always=True)
    else:
        raise TypeError(f"unsupported scalar {value!r} ({type(value).__name__})")
    return bytes(out)


def _decode_scalar(data: bytes) -> Any:
    value = [None]

    def put(fn):
        return lambda v: value.__setitem__(0, fn(v))

    _parse(data, {
        1: (0, put(lambda v: (v >> 1) ^ -(v & 1))),
        2: (1, put(lambda v: struct.unpack("<d", struct.pack("<Q", v))[0])),
        3: (2, put(_text)),
        4: (0, put(bool)),
        5: (2, put(bytes)),
    })
    return value[0]


def _put_map(number: int, values: dict, out: bytearray) -> None:
    for key, value in values.items():
        entry = bytearray()
        _put_str(1, key, entry)
        _put_len(2, _encode_scalar(value), entry, always=True)
        _put_len(number, bytes(entry), out, always=True)


def _map_entry(target: dict):
    """A setter that adds one map entry to ``target`` (the last of a
    repeated key wins)."""

    def put(data: bytes) -> None:
        entry = {"key": "", "value": b""}
        _parse(data, {
            1: (2, lambda v: entry.__setitem__("key", _text(v))),
            # a repeated value field merges
            2: (2, lambda v: entry.__setitem__("value", entry["value"] + v)),
        })
        target[entry["key"]] = _decode_scalar(entry["value"])

    return put


def _setter(obj: Any, name: str, fn=lambda v: v):
    return lambda v: setattr(obj, name, fn(v))


# ---- messages ----

@dataclass
class ReadyReq:
    config: dict = field(default_factory=dict)

    def encode(self) -> bytes:
        out = bytearray()
        _put_map(1, self.config, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ReadyReq":
        msg = cls()
        _parse(data, {1: (2, _map_entry(msg.config))})
        return msg


@dataclass
class PullReq:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "PullReq":
        _parse(data, {})
        return cls()


@dataclass
class TrainingNotice:
    round: int = 0

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.round, _I32, "TrainingNotice.round", out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "TrainingNotice":
        msg = cls()
        _parse(data, {1: (0, _setter(msg, "round", lambda v: _signed(v, 32)))})
        return msg


@dataclass
class LogChunk:
    title: str = ""
    data: bytes = b""
    offset: int = 0
    last: bool = False
    crc32c: int | None = None  # optional: None when absent

    def encode(self) -> bytes:
        out = bytearray()
        _put_str(1, self.title, out)
        _put_bytes(2, self.data, out)
        _put_int(3, self.offset, _I64, "LogChunk.offset", out)
        _put_bool(4, self.last, out)
        if self.crc32c is not None:
            _key(5, 5, out)
            out += struct.pack("<I", _check(self.crc32c, (0, 2**32 - 1), "LogChunk.crc32c"))
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "LogChunk":
        msg = cls()
        _parse(data, {
            1: (2, _setter(msg, "title", _text)),
            2: (2, _setter(msg, "data")),
            3: (0, _setter(msg, "offset", lambda v: _signed(v, 64))),
            4: (0, _setter(msg, "last", bool)),
            5: (5, _setter(msg, "crc32c")),
        })
        return msg


@dataclass
class TrainDone:
    round: int = 0
    weights: bytes = b""
    sample_count: int = 0
    metrics: dict = field(default_factory=dict)

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.round, _I32, "TrainDone.round", out)
        _put_bytes(2, self.weights, out)
        _put_int(3, self.sample_count, _I64, "TrainDone.sample_count", out)
        _put_map(4, self.metrics, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "TrainDone":
        msg = cls()
        _parse(data, {
            1: (0, _setter(msg, "round", lambda v: _signed(v, 32))),
            2: (2, _setter(msg, "weights")),
            3: (0, _setter(msg, "sample_count", lambda v: _signed(v, 64))),
            4: (2, _map_entry(msg.metrics)),
        })
        return msg


@dataclass
class VersionPoll:
    model_version: int = 0
    round: int = 0

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.model_version, _I32, "VersionPoll.model_version", out)
        _put_int(2, self.round, _I32, "VersionPoll.round", out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "VersionPoll":
        msg = cls()
        _parse(data, {
            1: (0, _setter(msg, "model_version", lambda v: _signed(v, 32))),
            2: (0, _setter(msg, "round", lambda v: _signed(v, 32))),
        })
        return msg


def _decode_oneof(data: bytes, schema: dict, members: dict):
    """Parse ``data`` with ``schema`` plus the oneof ``members`` (number ->
    (name, type)); returns the decoded set member or None. A repeated
    member merges; another member replaces it."""
    oneof = {"member": None, "payload": b""}

    def member(number):
        def put(v: bytes) -> None:
            same = oneof["member"] == number
            oneof["payload"] = oneof["payload"] + v if same else v
            oneof["member"] = number

        return put

    _parse(data, {**schema, **{number: (2, member(number)) for number in members}})
    if oneof["member"] is None:
        return None
    return members[oneof["member"]][1].decode(oneof["payload"])


# The ``msg`` oneof of ClientMessage: field number -> (name, type).
ONEOF = {
    2: ("ready", ReadyReq),
    3: ("pull", PullReq),
    4: ("training", TrainingNotice),
    5: ("log", LogChunk),
    6: ("done", TrainDone),
    7: ("poll", VersionPoll),
}
_ONEOF_NUMBER = {cls: (number, name) for number, (name, cls) in ONEOF.items()}


@dataclass
class ClientMessage:
    """Client -> server envelope; ``msg`` is the one set member of the
    oneof (or None), and :attr:`kind` its field name."""

    cname: str = ""
    token: str = ""
    msg: ReadyReq | PullReq | TrainingNotice | LogChunk | TrainDone | VersionPoll | None = None

    @property
    def kind(self) -> str | None:
        return None if self.msg is None else _ONEOF_NUMBER[type(self.msg)][1]

    def encode(self) -> bytes:
        out = bytearray()
        _put_str(1, self.cname, out)
        if self.msg is not None:
            number, _ = _ONEOF_NUMBER[type(self.msg)]
            _put_len(number, self.msg.encode(), out, always=True)
        _put_str(8, self.token, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ClientMessage":
        msg = cls()
        msg.msg = _decode_oneof(data, {
            1: (2, _setter(msg, "cname", _text)),
            8: (2, _setter(msg, "token", _text)),
        }, ONEOF)
        return msg


@dataclass
class ServerMessage:
    """Server -> client envelope."""

    status: str = ""
    config: dict = field(default_factory=dict)
    weights: bytes = b""
    title: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        _put_str(1, self.status, out)
        _put_map(2, self.config, out)
        _put_bytes(3, self.weights, out)
        _put_str(4, self.title, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ServerMessage":
        msg = cls()
        _parse(data, {
            1: (2, _setter(msg, "status", _text)),
            2: (2, _map_entry(msg.config)),
            3: (2, _setter(msg, "weights")),
            4: (2, _setter(msg, "title", _text)),
        })
        return msg


# ---- the serving plane (service ServePlane) ----

@dataclass
class PredictRequest:
    """One chunk of an image to segment; the chunks of one image share a
    ``request_id`` and the last one carries ``last``."""

    client_id: str = ""
    request_id: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    image: bytes = b""
    offset: int = 0
    last: bool = False
    crc32c: int | None = None  # optional: None when absent
    threshold: float = 0.0
    deadline_ms: float = 0.0

    def encode(self) -> bytes:
        out = bytearray()
        _put_str(1, self.client_id, out)
        _put_int(2, self.request_id, _U64, "PredictRequest.request_id", out)
        _put_int(3, self.height, _I32, "PredictRequest.height", out)
        _put_int(4, self.width, _I32, "PredictRequest.width", out)
        _put_int(5, self.channels, _I32, "PredictRequest.channels", out)
        _put_bytes(6, self.image, out)
        _put_int(7, self.offset, _I64, "PredictRequest.offset", out)
        _put_bool(8, self.last, out)
        _put_fixed32(9, self.crc32c, "PredictRequest.crc32c", out)
        _put_float(10, self.threshold, out)
        _put_float(11, self.deadline_ms, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "PredictRequest":
        msg = cls()
        _parse(data, {
            1: (2, _setter(msg, "client_id", _text)),
            2: (0, _setter(msg, "request_id")),
            3: (0, _setter(msg, "height", lambda v: _signed(v, 32))),
            4: (0, _setter(msg, "width", lambda v: _signed(v, 32))),
            5: (0, _setter(msg, "channels", lambda v: _signed(v, 32))),
            6: (2, _setter(msg, "image")),
            7: (0, _setter(msg, "offset", lambda v: _signed(v, 64))),
            8: (0, _setter(msg, "last", bool)),
            9: (5, _setter(msg, "crc32c")),
            10: (5, _setter(msg, "threshold", _float)),
            11: (5, _setter(msg, "deadline_ms", _float)),
        })
        return msg


@dataclass
class PredictResponse:
    request_id: int = 0
    status: str = ""
    mask: bytes = b""
    model_version: int = 0
    latency_ms: float = 0.0
    queue_ms: float = 0.0
    height: int = 0
    width: int = 0
    title: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.request_id, _U64, "PredictResponse.request_id", out)
        _put_str(2, self.status, out)
        _put_bytes(3, self.mask, out)
        _put_int(4, self.model_version, _I32, "PredictResponse.model_version", out)
        _put_float(5, self.latency_ms, out)
        _put_float(6, self.queue_ms, out)
        _put_int(7, self.height, _I32, "PredictResponse.height", out)
        _put_int(8, self.width, _I32, "PredictResponse.width", out)
        _put_str(9, self.title, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "PredictResponse":
        msg = cls()
        _parse(data, {
            1: (0, _setter(msg, "request_id")),
            2: (2, _setter(msg, "status", _text)),
            3: (2, _setter(msg, "mask")),
            4: (0, _setter(msg, "model_version", lambda v: _signed(v, 32))),
            5: (5, _setter(msg, "latency_ms", _float)),
            6: (5, _setter(msg, "queue_ms", _float)),
            7: (0, _setter(msg, "height", lambda v: _signed(v, 32))),
            8: (0, _setter(msg, "width", lambda v: _signed(v, 32))),
            9: (2, _setter(msg, "title", _text)),
        })
        return msg


@dataclass
class StreamOpen:
    height: int = 0
    width: int = 0
    channels: int = 0
    threshold: float = 0.0
    track: bool = False
    smooth_alpha: float = 0.0

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.height, _I32, "StreamOpen.height", out)
        _put_int(2, self.width, _I32, "StreamOpen.width", out)
        _put_int(3, self.channels, _I32, "StreamOpen.channels", out)
        _put_float(4, self.threshold, out)
        _put_bool(5, self.track, out)
        _put_float(6, self.smooth_alpha, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "StreamOpen":
        msg = cls()
        _parse(data, {
            1: (0, _setter(msg, "height", lambda v: _signed(v, 32))),
            2: (0, _setter(msg, "width", lambda v: _signed(v, 32))),
            3: (0, _setter(msg, "channels", lambda v: _signed(v, 32))),
            4: (5, _setter(msg, "threshold", _float)),
            5: (0, _setter(msg, "track", bool)),
            6: (5, _setter(msg, "smooth_alpha", _float)),
        })
        return msg


@dataclass
class StreamFrame:
    frame_id: int = 0
    image: bytes = b""
    offset: int = 0
    last: bool = False
    crc32c: int | None = None  # optional: None when absent

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.frame_id, _U64, "StreamFrame.frame_id", out)
        _put_bytes(2, self.image, out)
        _put_int(3, self.offset, _I64, "StreamFrame.offset", out)
        _put_bool(4, self.last, out)
        _put_fixed32(5, self.crc32c, "StreamFrame.crc32c", out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "StreamFrame":
        msg = cls()
        _parse(data, {
            1: (0, _setter(msg, "frame_id")),
            2: (2, _setter(msg, "image")),
            3: (0, _setter(msg, "offset", lambda v: _signed(v, 64))),
            4: (0, _setter(msg, "last", bool)),
            5: (5, _setter(msg, "crc32c")),
        })
        return msg


@dataclass
class StreamClose:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "StreamClose":
        _parse(data, {})
        return cls()


# The ``msg`` oneof of StreamRequest: field number -> (name, type).
STREAM_ONEOF = {
    2: ("open", StreamOpen),
    3: ("frame", StreamFrame),
    4: ("close", StreamClose),
}
_STREAM_ONEOF_NUMBER = {cls: (number, name) for number, (name, cls) in STREAM_ONEOF.items()}


@dataclass
class StreamRequest:
    """One message of a video session; ``msg`` is the one set member of
    the oneof (or None), and :attr:`kind` its field name."""

    stream_id: str = ""
    msg: StreamOpen | StreamFrame | StreamClose | None = None

    @property
    def kind(self) -> str | None:
        return None if self.msg is None else _STREAM_ONEOF_NUMBER[type(self.msg)][1]

    def encode(self) -> bytes:
        out = bytearray()
        _put_str(1, self.stream_id, out)
        if self.msg is not None:
            number, _ = _STREAM_ONEOF_NUMBER[type(self.msg)]
            _put_len(number, self.msg.encode(), out, always=True)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "StreamRequest":
        msg = cls()
        msg.msg = _decode_oneof(data, {1: (2, _setter(msg, "stream_id", _text))}, STREAM_ONEOF)
        return msg


@dataclass
class StreamResponse:
    frame_id: int = 0
    status: str = ""
    mask: bytes = b""
    model_version: int = 0
    latency_ms: float = 0.0
    height: int = 0
    width: int = 0
    title: str = ""
    tiles_total: int = 0
    tiles_computed: int = 0
    cache_hits: int = 0
    full_rerun: bool = False
    tracks_json: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        _put_int(1, self.frame_id, _U64, "StreamResponse.frame_id", out)
        _put_str(2, self.status, out)
        _put_bytes(3, self.mask, out)
        _put_int(4, self.model_version, _I32, "StreamResponse.model_version", out)
        _put_float(5, self.latency_ms, out)
        _put_int(6, self.height, _I32, "StreamResponse.height", out)
        _put_int(7, self.width, _I32, "StreamResponse.width", out)
        _put_str(8, self.title, out)
        _put_int(9, self.tiles_total, _I32, "StreamResponse.tiles_total", out)
        _put_int(10, self.tiles_computed, _I32, "StreamResponse.tiles_computed", out)
        _put_int(11, self.cache_hits, _I32, "StreamResponse.cache_hits", out)
        _put_bool(12, self.full_rerun, out)
        _put_str(13, self.tracks_json, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "StreamResponse":
        msg = cls()
        i32 = lambda v: _signed(v, 32)  # noqa: E731
        _parse(data, {
            1: (0, _setter(msg, "frame_id")),
            2: (2, _setter(msg, "status", _text)),
            3: (2, _setter(msg, "mask")),
            4: (0, _setter(msg, "model_version", i32)),
            5: (5, _setter(msg, "latency_ms", _float)),
            6: (0, _setter(msg, "height", i32)),
            7: (0, _setter(msg, "width", i32)),
            8: (2, _setter(msg, "title", _text)),
            9: (0, _setter(msg, "tiles_total", i32)),
            10: (0, _setter(msg, "tiles_computed", i32)),
            11: (0, _setter(msg, "cache_hits", i32)),
            12: (0, _setter(msg, "full_rerun", bool)),
            13: (2, _setter(msg, "tracks_json", _text)),
        })
        return msg
