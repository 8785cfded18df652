"""TensorBoard event files (scalars and histograms), written without
TensorFlow or protobuf.

The counterpart of ``fedcrack_tpu.obs.tb``, byte for byte: the reference
wrote TensorBoard files every round through its Keras callback, and the
JSONL metrics sink (obs/metrics.py) tees its numeric fields into one of
these files. The writer speaks the TFRecord + Event wire format directly.

Format notes (stable since TF 1.x):

- A file is a sequence of TFRecords: ``uint64 len | uint32 masked_crc(len)
  | data | uint32 masked_crc(data)``, CRC32C (Castagnoli) with TF's mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8)``, from the port's compiled
  CRC32C (``native/crc32c.cpp``).
- Each record is a serialized ``Event`` proto; scalars ride
  ``Event{wall_time(1:double), step(2:int64), summary(5){value(1){
  tag(1:string), simple_value(2:float)}}}``, hand-encoded below (the
  message is tiny and frozen — a protobuf dependency would be overkill).
- The first record is ``Event{wall_time, file_version="brain.Event:2"}``.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time

from fedcrack_tpu_torch.native import crc32c

_MASK_DELTA = 0xA282EAD8
# Filename uniquifier: same-second writers on one host (e.g. a co-located
# server and client both pointed at the same --tb-dir) must never append
# into one file — interleaved records corrupt each other's CRC framing.
_FILE_COUNTER = itertools.count()


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _field_double(number: int, value: float) -> bytes:
    return _varint((number << 3) | 1) + struct.pack("<d", value)


def _field_float(number: int, value: float) -> bytes:
    return _varint((number << 3) | 5) + struct.pack("<f", value)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    summary_value = (
        _field_bytes(1, tag.encode("utf-8")) + _field_float(2, float(value))
    )
    summary = _field_bytes(1, summary_value)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _packed_doubles(number: int, values) -> bytes:
    return _field_bytes(number, b"".join(struct.pack("<d", float(v)) for v in values))


def _histo_event(
    tag: str, histo: "HistoData", step: int, wall_time: float
) -> bytes:
    """Event{wall_time, step, summary{value{tag(1), histo(5)}}} where histo is
    TF's HistogramProto: min(1:double), max(2), num(3), sum(4),
    sum_squares(5), bucket_limit(6: packed double), bucket(7: packed double)
    — the wire shape Keras' histogram_freq=1 callback writes."""
    proto = (
        _field_double(1, histo.min)
        + _field_double(2, histo.max)
        + _field_double(3, histo.num)
        + _field_double(4, histo.sum)
        + _field_double(5, histo.sum_squares)
        + _packed_doubles(6, histo.bucket_limit)
        + _packed_doubles(7, histo.bucket)
    )
    summary_value = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(5, proto)
    summary = _field_bytes(1, summary_value)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


class HistoData:
    """Bucketized distribution in TF HistogramProto shape. ``bucket[i]``
    counts values in ``(bucket_limit[i-1], bucket_limit[i]]``; the arrays are
    equal-length, as TensorBoard's event_accumulator requires."""

    __slots__ = ("min", "max", "num", "sum", "sum_squares", "bucket_limit", "bucket")

    def __init__(self, values, bins: int = 30):
        import numpy as np

        flat = np.asarray(values, dtype=np.float64).reshape(-1)
        flat = flat[np.isfinite(flat)]
        self.num = float(flat.size)
        if flat.size == 0:
            self.min = self.max = self.sum = self.sum_squares = 0.0
            self.bucket_limit = [0.0]
            self.bucket = [0.0]
            return
        self.min = float(flat.min())
        self.max = float(flat.max())
        self.sum = float(flat.sum())
        self.sum_squares = float(np.square(flat).sum())
        if self.min == self.max:
            # Degenerate distribution: one bucket holding everything, its
            # upper edge nudged so the (lo, hi] interval is non-empty.
            self.bucket_limit = [self.max + max(1e-12, abs(self.max) * 1e-7)]
            self.bucket = [self.num]
            return
        counts, edges = np.histogram(flat, bins=bins, range=(self.min, self.max))
        self.bucket_limit = [float(e) for e in edges[1:]]
        self.bucket = [float(c) for c in counts]


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Append-only TB scalar writer; thread-safe, one event file per logdir.

    ``SummaryWriter(d).add_scalar("round/loss", 0.12, step=3)`` produces a
    file TensorBoard's scalars dashboard loads directly.
    """

    def __init__(self, logdir: str | os.PathLike):
        logdir = os.fspath(logdir)
        os.makedirs(logdir, exist_ok=True)
        name = (
            # TensorBoard's file-naming convention: creation time, host, pid
            # fedlint: disable=DET001 -- wall-clock creation time in the name
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            f".{os.getpid()}.{next(_FILE_COUNTER)}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        # fedlint: disable=DET001 -- TB displays events on a wall-clock axis
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        record = (
            header
            + struct.pack("<I", _masked_crc(header))
            + event
            + struct.pack("<I", _masked_crc(event))
        )
        with self._lock:
            self._f.write(record)
            self._f.flush()

    def add_scalar(
        self, tag: str, value: float, step: int, wall_time: float | None = None
    ) -> None:
        self._write(
            _scalar_event(
                # fedlint: disable=DET001 -- TB's wall-time display axis
                tag, value, step, time.time() if wall_time is None else wall_time
            )
        )

    def add_histogram(
        self,
        tag: str,
        values,
        step: int,
        wall_time: float | None = None,
        bins: int = 30,
    ) -> None:
        """Log the distribution of ``values`` (any array-like; flattened,
        non-finite entries dropped)."""
        self._write(
            _histo_event(
                tag,
                HistoData(values, bins=bins),
                step,
                # fedlint: disable=DET001 -- TB's wall-time display axis
                time.time() if wall_time is None else wall_time,
            )
        )

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_scalars(path: str | os.PathLike) -> list[tuple[str, float, int]]:
    """Minimal event-file reader: ``[(tag, value, step), ...]``. Verifies
    record CRCs."""
    out = []
    for step, value in _summary_values(path):
        tag, val = "", None
        for number, wire, payload in _parse_fields(value):
            if number == 1 and wire == 2:
                tag = payload.decode("utf-8")
            elif number == 2 and wire == 5:  # simple_value
                (val,) = struct.unpack("<f", payload)
        if val is not None:
            out.append((tag, val, step))
    return out


def read_histograms(path: str | os.PathLike) -> list[tuple[str, dict, int]]:
    """Histogram counterpart of :func:`read_scalars`:
    ``[(tag, {min,max,num,sum,sum_squares,bucket_limit,bucket}, step), ...]``.
    Verifies record CRCs like the scalar reader."""
    out = []
    for step, value in _summary_values(path):
        tag, histo = "", None
        for number, wire, payload in _parse_fields(value):
            if number == 1 and wire == 2:
                tag = payload.decode("utf-8")
            elif number == 5 and wire == 2:  # histo
                histo = _parse_histo(payload)
        if histo is not None:
            out.append((tag, histo, step))
    return out


def _parse_histo(buf: bytes) -> dict:
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    out = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0, "sum_squares": 0.0,
           "bucket_limit": [], "bucket": []}
    for number, wire, value in _parse_fields(buf):
        if number in names and wire == 1:
            (out[names[number]],) = struct.unpack("<d", value)
        elif number in (6, 7) and wire == 2:  # packed double
            key = "bucket_limit" if number == 6 else "bucket"
            out[key] = [
                struct.unpack_from("<d", value, i)[0]
                for i in range(0, len(value), 8)
            ]
    return out


def _summary_values(path: str | os.PathLike):
    """The one event walker both readers share: yields ``(step, bytes)`` per
    Summary.Value in file order. The event's step field may be encoded
    before or after the summary, so values are collected per event and
    yielded with the event's final step."""
    for event in _records(path):
        step = 0
        values = []
        for number, wire, value in _parse_fields(event):
            if number == 2 and wire == 0:
                step = value
            elif number == 5 and wire == 2:  # summary
                for n2, w2, v2 in _parse_fields(value):
                    if n2 == 1 and w2 == 2:  # Summary.Value
                        values.append(v2)
        for v in values:
            yield step, v


def _records(path: str | os.PathLike):
    """CRC-verified TFRecord payloads of an event file."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != len_crc:
            raise ValueError(f"corrupt length CRC at byte {pos}")
        event = data[pos + 12 : pos + 12 + length]
        (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(event) != data_crc:
            raise ValueError(f"corrupt event CRC at byte {pos}")
        pos += 12 + length + 4
        yield event


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value = buf[pos : pos + size]
            pos += size
        elif wire == 5:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield number, wire, value
