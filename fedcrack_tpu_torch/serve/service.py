"""The gRPC front door of the serving plane.

The counterpart of ``fedcrack_tpu.serve.service``: the ``fedcrack.ServePlane``
service with its two bidi-streaming RPCs, bound by hand like the control
plane's ``FedControl`` (``transport/service.py``), with the port's wire codec
(``transport/wire.py``) as (de)serializer, so clients of either package
talk to it.

``Predict``: an image streams in as framed chunks (offset/last, optional
CRC32C per chunk); on the last chunk it is assembled and routed:

- exact bucket shape: the batcher (or the fleet's router), the hot path;
- smaller than a bucket: zero-padded into the smallest bucket that holds
  it, through the batcher, the output cropped;
- larger than every bucket: tiled sliding-window inference, pinned to one
  weights snapshot for the whole request.

The response carries the thresholded uint8 mask, the model version and the
queue and total latency. ``StreamPredict`` runs open/frames/close video
sessions through a :class:`~fedcrack_tpu_torch.serve.stream.StreamSessionManager`.
Every request gets exactly one response; a malformed one is ``REJECTED``
with a reason, a shed one ``RESOURCE_EXHAUSTED``, and the stream stays up.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Any, AsyncIterator

import grpc
import numpy as np

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.native import crc32c
from fedcrack_tpu_torch.serve.router import LoadShedError
from fedcrack_tpu_torch.serve.stream import tracks_to_json
from fedcrack_tpu_torch.transport import wire
from fedcrack_tpu_torch.transport.service import channel_options

log = logging.getLogger("fedcrack_torch.serve")

SERVE_SERVICE_NAME = "fedcrack.ServePlane"
PREDICT_METHOD = "Predict"
PREDICT_PATH = f"/{SERVE_SERVICE_NAME}/{PREDICT_METHOD}"
STREAM_METHOD = "StreamPredict"
STREAM_PATH = f"/{SERVE_SERVICE_NAME}/{STREAM_METHOD}"

OK = "OK"
REJECTED = "REJECTED"
# Admission control refused the request before queueing it: distinct from
# REJECTED (a malformed request), a status the client backs off on.
SHED = "RESOURCE_EXHAUSTED"

# Per-stream assembly caps: chunks accumulate until `last`, so a stream of
# never-finishing requests hits a ceiling on buffered bytes AND on open
# request entries (empty chunks would never trip the byte cap).
MAX_PENDING_BYTES = 256 * 1024 * 1024
MAX_PENDING_REQUESTS = 1024


@dataclasses.dataclass
class _Pending:
    height: int
    width: int
    channels: int
    threshold: float
    deadline_ms: float
    chunks: bytearray = dataclasses.field(default_factory=bytearray)


def _reject(request_id: int, reason: str) -> wire.PredictResponse:
    return wire.PredictResponse(request_id=request_id, status=REJECTED, title=reason)


class ServeService:
    """The Predict and StreamPredict handlers over one engine, a batcher
    (or the fleet's router) and a weights source."""

    def __init__(self, engine: Any, batcher: Any, weights: Any, stream_manager: Any = None):
        self.engine = engine
        self.batcher = batcher
        self.weights = weights
        # None leaves StreamPredict registered but loudly rejecting.
        self.stream_manager = stream_manager
        self._lock = make_lock("serve.service.stats")
        self.tiled_served = 0
        self.rejected = 0
        self.shed = 0

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    # ---- request assembly ----

    def _validate_chunk(self, msg: wire.PredictRequest, pending: dict) -> str | None:
        if msg.height <= 0 or msg.width <= 0:
            return f"bad dimensions {msg.height}x{msg.width}"
        if msg.channels != 3:
            return f"channels must be 3 (RGB), got {msg.channels}"
        if msg.crc32c is not None:
            got = crc32c(msg.image)
            if got != msg.crc32c:
                return (
                    f"image chunk checksum mismatch at offset {msg.offset}: "
                    f"computed {got:#010x}, declared {msg.crc32c:#010x}"
                )
        total = sum(len(p.chunks) for p in pending.values())
        if total + len(msg.image) > MAX_PENDING_BYTES:
            return "per-stream pending image bytes exceed the assembly cap"
        if msg.request_id not in pending and len(pending) >= MAX_PENDING_REQUESTS:
            return "per-stream open request entries exceed the assembly cap"
        return None

    def _assemble(self, p: _Pending) -> np.ndarray | str:
        want = p.height * p.width * p.channels
        if len(p.chunks) != want:
            return f"image bytes {len(p.chunks)} != {p.height}x{p.width}x{p.channels}"
        return np.frombuffer(bytes(p.chunks), np.uint8).reshape(p.height, p.width, p.channels)

    # ---- routing ----

    async def _serve_one(self, request_id: int, image: np.ndarray, p: _Pending) -> wire.PredictResponse:
        h, w, _ = image.shape
        threshold = p.threshold if 0.0 < p.threshold < 1.0 else 0.5
        deadline = p.deadline_ms if p.deadline_ms > 0 else None
        bucket = self.engine.bucket_for(h, w)
        t0 = time.monotonic()
        if bucket is not None:
            canvas = image
            if (h, w) != (bucket, bucket):
                canvas = np.zeros((bucket, bucket, 3), np.uint8)
                canvas[:h, :w] = image
            fut = self.batcher.submit(canvas, deadline_ms=deadline)
            res = await asyncio.wrap_future(fut)
            probs = res.probs[:h, :w]
            version = res.model_version
            queue_ms, latency_ms = res.queue_ms, res.latency_ms
        else:
            # The tiled path pins ONE snapshot for the whole request.
            version, variables = self.weights.snapshot()
            probs = await asyncio.to_thread(self.engine.predict_tiled, variables, image)
            queue_ms = 0.0
            latency_ms = (time.monotonic() - t0) * 1e3
            self._count("tiled_served")
        mask = ((probs[..., 0] > threshold).astype(np.uint8) * 255).tobytes()
        return wire.PredictResponse(
            request_id=request_id,
            status=OK,
            mask=mask,
            model_version=version,
            latency_ms=latency_ms,
            queue_ms=queue_ms,
            height=h,
            width=w,
        )

    # ---- the Predict handler ----

    async def predict_session(
        self, request_iterator: AsyncIterator[wire.PredictRequest], context
    ) -> AsyncIterator[wire.PredictResponse]:
        pending: dict[int, _Pending] = {}
        # Request ids already REJECTED mid-assembly: exactly ONE response
        # goes out per request, so the later chunks of a dead request are
        # swallowed until its `last` chunk retires the id.
        dead: set[int] = set()
        async for msg in request_iterator:
            if msg.request_id in dead:
                if msg.last:
                    dead.discard(msg.request_id)
                continue
            bad = self._validate_chunk(msg, pending)
            if bad is None:
                p = pending.get(msg.request_id)
                if p is None:
                    p = _Pending(msg.height, msg.width, msg.channels, msg.threshold, msg.deadline_ms)
                    pending[msg.request_id] = p
                if msg.offset != len(p.chunks):
                    bad = f"chunk offset {msg.offset} != received {len(p.chunks)}"
            if bad is not None:
                pending.pop(msg.request_id, None)
                if not msg.last:
                    dead.add(msg.request_id)
                self._count("rejected")
                yield _reject(msg.request_id, bad)
                continue
            p.chunks.extend(msg.image)
            if not msg.last:
                continue
            del pending[msg.request_id]
            image = self._assemble(p)
            if isinstance(image, str):
                self._count("rejected")
                yield _reject(msg.request_id, image)
                continue
            try:
                yield await self._serve_one(msg.request_id, image, p)
            except LoadShedError as e:
                # Admission control fired: a loud RESOURCE_EXHAUSTED with
                # the shed reason, never a silent drop or a stall.
                self._count("shed")
                yield wire.PredictResponse(request_id=msg.request_id, status=SHED, title=str(e))
            except Exception as e:  # a failed batch errors THIS request only
                log.exception("predict failed for request %d", msg.request_id)
                self._count("rejected")
                yield _reject(msg.request_id, repr(e))

    # ---- the StreamPredict handler ----

    def _stream_reject(self, title: str, frame_id: int = 0) -> wire.StreamResponse:
        self._count("rejected")
        return wire.StreamResponse(frame_id=frame_id, status=REJECTED, title=title)

    async def stream_session(
        self, request_iterator: AsyncIterator[wire.StreamRequest], context
    ) -> AsyncIterator[wire.StreamResponse]:
        """Open/frames/close video sessions over one bidi stream. Every
        open, every completed frame and every close gets exactly one
        response; frames of a stream are served in arrival order. Sessions
        opened on this call close when it ends, so a dropped connection
        cannot leak slots toward ``stream_max_sessions``."""
        opened: dict[str, Any] = {}      # stream_id -> StreamSession
        frames: dict[str, dict] = {}     # stream_id -> in-flight chunk state
        try:
            async for msg in request_iterator:
                sid = msg.stream_id
                kind = msg.kind
                if self.stream_manager is None:
                    yield self._stream_reject("video serving not enabled")
                    continue
                if kind == "open":
                    o = msg.msg
                    if o.channels not in (0, 3):
                        bad = f"channels must be 3 (RGB), got {o.channels}"
                    elif sid in opened:
                        bad = f"stream {sid!r} is already open on this call"
                    else:
                        bad = None
                    if bad is None:
                        try:
                            opened[sid] = self.stream_manager.open(
                                sid,
                                height=o.height,
                                width=o.width,
                                track=o.track,
                                smooth_alpha=o.smooth_alpha,
                                threshold=o.threshold,
                            )
                        except ValueError as e:
                            bad = str(e)
                    if bad is not None:
                        yield self._stream_reject(bad)
                        continue
                    yield wire.StreamResponse(status=OK, title="OPENED", height=o.height, width=o.width)
                elif kind == "frame":
                    f = msg.msg
                    session = opened.get(sid)
                    if session is None:
                        yield self._stream_reject(f"stream {sid!r} is not open", f.frame_id)
                        continue
                    if f.crc32c is not None:
                        got = crc32c(f.image)
                        if got != f.crc32c:
                            frames.pop(sid, None)
                            yield self._stream_reject(
                                f"frame chunk checksum mismatch at offset {f.offset}: "
                                f"computed {got:#010x}, declared {f.crc32c:#010x}",
                                f.frame_id,
                            )
                            continue
                    st = frames.get(sid)
                    if st is None or st["frame_id"] != f.frame_id:
                        st = {"frame_id": f.frame_id, "chunks": bytearray()}
                        frames[sid] = st
                    if f.offset != len(st["chunks"]):
                        frames.pop(sid, None)
                        yield self._stream_reject(
                            f"chunk offset {f.offset} != received {len(st['chunks'])}", f.frame_id
                        )
                        continue
                    st["chunks"].extend(f.image)
                    if not f.last:
                        continue
                    frames.pop(sid, None)
                    want = session.height * session.width * 3
                    if len(st["chunks"]) != want:
                        yield self._stream_reject(
                            f"frame bytes {len(st['chunks'])} != {session.height}x{session.width}x3",
                            f.frame_id,
                        )
                        continue
                    image = np.frombuffer(bytes(st["chunks"]), np.uint8).reshape(
                        session.height, session.width, 3
                    )
                    try:
                        result = await asyncio.to_thread(session.process_frame, image)
                    except Exception as e:  # errors THIS frame only
                        log.exception("stream frame failed (%s, frame %d)", sid, f.frame_id)
                        yield self._stream_reject(repr(e), f.frame_id)
                        continue
                    self.stream_manager.record(result)
                    yield wire.StreamResponse(
                        frame_id=f.frame_id,
                        status=OK,
                        mask=result.mask_bytes(session.threshold),
                        model_version=result.model_version,
                        latency_ms=result.latency_ms,
                        height=session.height,
                        width=session.width,
                        tiles_total=result.tiles_total,
                        tiles_computed=result.tiles_computed,
                        cache_hits=result.cache_hits,
                        full_rerun=result.full_rerun,
                        tracks_json=tracks_to_json(result.tracks) if session.tracker is not None else "",
                    )
                elif kind == "close":
                    if opened.pop(sid, None) is None:
                        yield self._stream_reject(f"stream {sid!r} is not open")
                        continue
                    self.stream_manager.close(sid)
                    frames.pop(sid, None)
                    yield wire.StreamResponse(status=OK, title="CLOSED")
                else:
                    yield self._stream_reject("empty StreamRequest")
        finally:
            if self.stream_manager is not None:
                for sid in opened:
                    self.stream_manager.close(sid)


class ServeServer:
    """Binds a :class:`ServeService` on an asyncio gRPC server."""

    def __init__(self, service: ServeService, host: str = "127.0.0.1", port: int = 8890,
                 max_message_mb: int = 64):
        self.service = service
        self._host = host
        self._port = port
        self._max_message_mb = max_message_mb
        self._server: grpc.aio.Server | None = None
        self.bound_port: int | None = None

    async def start(self) -> int:
        """Bind and serve; returns the bound port (port 0: an ephemeral one)."""
        server = grpc.aio.server(options=channel_options(self._max_message_mb))
        predict = grpc.stream_stream_rpc_method_handler(
            self.service.predict_session,
            request_deserializer=wire.PredictRequest.decode,
            response_serializer=wire.PredictResponse.encode,
        )
        stream = grpc.stream_stream_rpc_method_handler(
            self.service.stream_session,
            request_deserializer=wire.StreamRequest.decode,
            response_serializer=wire.StreamResponse.encode,
        )
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                SERVE_SERVICE_NAME, {PREDICT_METHOD: predict, STREAM_METHOD: stream}
            ),
        ))
        self.bound_port = server.add_insecure_port(f"{self._host}:{self._port}")
        await server.start()
        self._server = server
        log.info("serving plane on %s:%s", self._host, self.bound_port)
        return self.bound_port

    async def stop(self, grace: float = 1.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)


class ServeServerThread:
    """Runs a :class:`ServeServer` on its own asyncio loop in a daemon
    thread: the in-process harness for tests and the chip smoke."""

    def __init__(self, server: ServeServer):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.port: int | None = None
        self._started = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.port = self.loop.run_until_complete(self.server.start())
        except BaseException as e:  # surfaced by __enter__
            self._error = e
            self._started.set()
            return
        self._started.set()
        self.loop.run_forever()

    def __enter__(self) -> "ServeServerThread":
        self._thread.start()
        if not self._started.wait(timeout=30) or self._error is not None:
            raise RuntimeError("serve server failed to start") from self._error
        return self

    def __exit__(self, *exc) -> None:
        fut = asyncio.run_coroutine_threadsafe(self.server.stop(grace=0.5), self.loop)
        try:
            fut.result(timeout=10)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=10)
