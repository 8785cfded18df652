"""The gRPC control-plane server.

The counterpart of ``fedcrack_tpu.transport.service``: an asyncio gRPC
server whose only shared state is the immutable ``ServerState``, advanced
under one lock, so the round machine has a single writer. The service is
bound by hand (no generated code): one stream-stream method handler under
``/fedcrack.FedControl/Session`` with the port's own wire codec
(``transport/wire.py``) as its serializer, so clients of either package
talk to it. Send and receive caps are both raised to ``max_message_mb``.

Around the round machine it keeps the JAX package's server duties: the
startup check that the largest weight message fits the cap, the shared
auth token (constant-time compare, checked before any protocol work),
TLS and mTLS, the per-round ``eval_fn`` with best-model retention, the log
sink's flush to ``logs_dir``, the ``metrics`` hook, the metric registry,
and a ``fed.flush`` span per aggregation linked to the trace contexts of
the uploads it averaged. With ``FedConfig.state_path`` it resumes from the
mid-round statefile at boot and snapshots the state off the serving path
whenever membership, the held updates, FedBuff's buffer, the pulled
versions or the privacy maps change. With ``checkpointer=`` (a
``ckpt.FedCheckpointer``) it resumes from the latest round checkpoint at
boot, a statefile at the same or a newer model version winning, and saves
a step off the serving path after each version bump.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import hmac
import json
import logging
import math
import os
import re
import threading
import time
from typing import Any, AsyncIterator, Callable

import grpc

from fedcrack_tpu_torch.ckpt import load_state_file, restore_server_state, save_server_state, save_state_file
from fedcrack_tpu_torch.compress import FRAME_OVERHEAD_BYTES, encoded_bytes_model
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.fed.pytree import tree_leaves
from fedcrack_tpu_torch.health import ledger as _health_ledger
from fedcrack_tpu_torch.ioutils import atomic_write_bytes
from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import DEFAULT_VERSIONS_BUCKETS, REGISTRY
from fedcrack_tpu_torch.transport import wire
from fedcrack_tpu_torch.transport.codec import event_from_message, message_from_reply

log = logging.getLogger("fedcrack.server")

SERVICE_NAME = "fedcrack.FedControl"
METHOD = "Session"


def _reason_class(reason: str) -> str:
    """A rejection message as a bounded label value (one time series per
    class, never per message)."""
    r = reason.lower()
    if "not in cohort" in r:
        return "not_in_cohort"
    if "stale" in r:
        return "stale"
    if "rejected" in r or "frame" in r:
        return "sanitation"
    return "other"


def _wire_bytes_counter():
    return REGISTRY.counter(
        "fed_wire_bytes_total",
        "weight bytes crossing the control plane (up = client uploads, "
        "down = broadcast pulls)",
        labels=("direction",),
    )


def observe_transition(
    prev: R.ServerState,
    state: R.ServerState,
    event: R.Event,
    reply: R.Reply,
    wall_s: float,
) -> None:
    """One transition as metric-registry updates and flight-recorder
    events: update outcomes, wire bytes up and down, and per version
    publish the flush's wall and the ledger's anomaly gauges. A projection
    of the transitions the history records, so the two cannot drift."""
    if isinstance(event, R.TrainDone):
        flight.note(
            "fed.update",
            cname=event.cname,
            round=event.round,
            status=reply.status,
            bytes=len(event.blob),
        )
        updates = REGISTRY.counter(
            "fed_updates_total",
            "client updates by outcome: accepted into the round, resynced "
            "(NOT_WAIT, never averaged), or rejected by reason",
            labels=("result",),
        )
        _wire_bytes_counter().labels(direction="up").inc(len(event.blob))
        if reply.status in (R.RESP_ACY, R.RESP_ARY) or (
            # The upload that closes the final round is answered FIN.
            reply.status == R.FIN
            and state.model_version != prev.model_version
        ):
            updates.labels(result="accepted").inc()
        elif reply.status == R.NOT_WAIT:
            updates.labels(result="resync").inc()
            REGISTRY.counter(
                "fed_resyncs_total",
                "NOT_WAIT resyncs: uploads refused past quorum close or "
                "past max_staleness, sender handed the current global",
            ).inc()
        elif reply.status == R.REJECTED:
            reason = _reason_class(str(reply.config.get("reason", "")))
            updates.labels(result=f"rejected_{reason}").inc()
    elif isinstance(event, R.PullWeights) and reply.blob:
        _wire_bytes_counter().labels(direction="down").inc(len(reply.blob))
    REGISTRY.gauge(
        "fed_buffer_fill_total",
        "accepted-but-unflushed updates in the FedBuff buffer (0 in sync mode)",
    ).set(len(state.buffer))
    if state.config.mode == "buffered" and state.config.buffer_k > 0:
        REGISTRY.gauge(
            "fed_buffer_fill_ratio",
            "buffer fill as a fraction of buffer_k (1.0 = flush imminent)",
        ).set(len(state.buffer) / state.config.buffer_k)
    if state.model_version != prev.model_version:
        flight.note(
            "fed.flush",
            version=state.model_version,
            round=prev.current_round,
            wall_s=round(wall_s, 6),
        )
        REGISTRY.counter(
            "fed_global_versions_total",
            "global model version publishes (sync aggregations + buffered "
            "flushes)",
        ).inc(state.model_version - prev.model_version)
        REGISTRY.counter(
            "fed_rounds_total",
            "completed aggregations (one history entry each)",
        ).inc()
        REGISTRY.histogram(
            "fed_flush_seconds",
            "wall clock of the version-publishing transition (the sorted "
            "fold + FedOpt step + re-serialization)",
        ).observe(wall_s)
        entry = state.history[-1] if state.history else {}
        staleness = entry.get("staleness")
        if isinstance(staleness, (list, tuple)):
            hist = REGISTRY.histogram(
                "fed_update_staleness_versions",
                "staleness (model versions behind the global) of each "
                "update at the flush that averaged it",
                buckets=DEFAULT_VERSIONS_BUCKETS,
            )
            for v in staleness:
                hist.observe(float(v))
        try:
            _health_ledger.export_anomaly_metrics(state.ledger)
        except Exception:  # telemetry never breaks the protocol
            log.exception("anomaly metric export failed (non-fatal)")


def _safe_component(name: str) -> str:
    """One path component from an untrusted wire string: separators and
    parent references become underscores. Injective: a name the cleaning
    changed (or one that looks like a cleaned name) gets a suffix hashed
    from the original, so 'a/b' and 'a_b' never share a file."""
    cleaned = name.replace("\\", "_").replace("/", "_").replace("..", "_")
    cleaned = cleaned.strip() or "_"
    cleaned = cleaned.lstrip(".") or "_"
    if cleaned != name or re.search(r"\.[0-9a-f]{8}(?:[0-9a-f]{8})?$", cleaned):
        digest = hashlib.sha256(name.encode("utf-8", "surrogatepass")).hexdigest()[:16]
        cleaned = f"{cleaned}.{digest}"
    return cleaned


def _load_best(path: str) -> dict | None:
    """The best-model sidecar of an existing best file, so a restarted
    server never replaces a better model on disk; ignored when its sha256
    does not match the model file (a crash between the two renames)."""
    side = f"{path}.json"
    try:
        with open(side, encoding="utf-8") as f:
            entry = json.load(f)
        with open(path, "rb") as f:
            blob = f.read()
    except (OSError, ValueError):
        return None
    if entry.get("sha256") != hashlib.sha256(blob).hexdigest():
        log.warning("best-model sidecar %s does not match %s; ignoring", side, path)
        return None
    loss = entry.get("loss")
    if not isinstance(loss, (int, float)) or not math.isfinite(loss):
        return None
    return entry


def _write_best(path: str, blob: bytes, entry: dict) -> None:
    """The best global model (msgpack bytes) and a JSON sidecar with the
    eval that earned it and the blob's sha256, each written atomically."""
    atomic_write_bytes(path, blob)
    payload = json.dumps({**entry, "sha256": hashlib.sha256(blob).hexdigest()}, sort_keys=True)
    atomic_write_bytes(f"{path}.json", payload.encode("utf-8"))


def channel_options(max_message_mb: int) -> list[tuple[str, int]]:
    cap = max_message_mb * 1024 * 1024
    return [
        ("grpc.max_send_message_length", cap),
        ("grpc.max_receive_message_length", cap),
    ]


def frame_budget(template: Any, config: FedConfig) -> int:
    """Worst-case upload bytes under ``config.update_codec``: the codec's
    pre-zlib model, the frame's overhead, and 64 bytes per leaf for
    manifest keys and zlib's expansion on incompressible payloads."""
    leaf_sizes = [int(leaf.size) for leaf in tree_leaves(template)]
    return (
        encoded_bytes_model(leaf_sizes, config.update_codec, topk_fraction=config.topk_fraction)
        + FRAME_OVERHEAD_BYTES
        + 64 * len(leaf_sizes)
    )


class FedServer:
    """Owns the round state machine and serves it over gRPC."""

    def __init__(
        self,
        config: FedConfig,
        global_variables: Any,
        clock: Callable[[], float] = time.monotonic,
        tick_period_s: float = 1.0,
        checkpointer: Any | None = None,
        metrics: Any | None = None,
        eval_fn: Callable[[bytes], dict] | None = None,
    ):
        self.config = config
        self.state = R.initial_state(config, global_variables)
        self._checkpointer = checkpointer
        if checkpointer is not None:
            # The latest round checkpoint: round, version, weights, history
            # and logs carry over, and enrollment re-opens.
            resumed = restore_server_state(checkpointer, config, global_variables)
            if resumed is not None:
                log.info(
                    "resuming from checkpoint: round %d, model_version %d",
                    resumed.current_round, resumed.model_version,
                )
                self.state = resumed
        self._state_path = config.state_path or None
        if self._state_path is not None:
            # Resume from the statefile unless it is older than the boot or
            # checkpoint state; at an equal version it wins, since only it
            # carries the round's received updates and the buffer.
            mid = load_state_file(self._state_path, config)
            if mid is not None and mid.model_version >= self.state.model_version:
                log.info(
                    "resuming mid-round state: round %d, phase %s, %d update(s) "
                    "received, %d buffered",
                    mid.current_round, mid.phase, len(mid.received), len(mid.buffer),
                )
                self.state = mid
        # The largest message either way (the broadcast down, the worst-case
        # upload up) must fit the gRPC cap, or the federation would boot and
        # die on its first weight transfer: fail here instead.
        cap = config.max_message_mb * 1024 * 1024
        budget = max(
            len(self.state.global_blob),
            len(self.state.broadcast_blob),
            frame_budget(self.state.template, config),
        )
        if budget > cap:
            raise ValueError(
                f"max_message_mb={config.max_message_mb} cannot carry this "
                f"model: worst-case weight message is {budget} bytes "
                f"({budget / (1024 * 1024):.1f} MiB) under "
                f"update_codec={config.update_codec!r} — raise "
                "max_message_mb (server and clients must agree)"
            )
        self._metrics = metrics
        # eval_fn(global_blob) -> {"loss": ..., ...} on each new global.
        self._eval_fn = eval_fn
        self.eval_history: list[dict] = []
        self.best_eval: dict | None = _load_best(config.best_path) if config.best_path else None
        self._best_lock = asyncio.Lock()
        self._clock = clock
        self._tick_period_s = tick_period_s
        self._lock = asyncio.Lock()
        # Statefile snapshots coalesce, latest wins: _apply parks the newest
        # state in _state_pending and each queued save writes whatever is
        # newest when it runs (or nothing). The lock serializes the writes;
        # only the event loop touches _state_pending.
        self._state_lock = asyncio.Lock()
        self._state_pending: R.ServerState | None = None
        # Checkpoint saves run one at a time, in version order (tasks start
        # in creation order and the lock wakes waiters first in, first out).
        self._ckpt_lock = asyncio.Lock()
        # The checkpoint steps written: version and ms (read by the chip smoke).
        self.checkpoints: collections.deque[dict] = collections.deque(maxlen=1024)
        # The latest snapshots written: version, buffered updates, bytes and
        # ms to encode and write them (read by the chip smoke).
        self.snapshots: collections.deque[dict] = collections.deque(maxlen=1024)
        self._bg_tasks: set[asyncio.Task] = set()
        # The wire trace context of each client's latest accepted upload,
        # linked from the flush span that averages it.
        self._trace_links: dict[str, str] = {}
        self._server: grpc.aio.Server | None = None
        self._tick_task: asyncio.Task | None = None
        self.bound_port: int | None = None
        self.finished = asyncio.Event()
        # Host seconds spent in transitions, per round: the server's share
        # of a round's wall (read by the chip smoke).
        self.transition_s: dict[int, float] = {}
        if self.state.phase == R.PHASE_FINISHED:
            # A restore can land on FINISHED: nothing is left to wait for.
            self.finished.set()

    @staticmethod
    def _persist_sig(state: R.ServerState) -> tuple:
        """What a snapshot must not miss: membership, phase, round and
        version, which updates are held, and in buffered mode which are
        buffered and what each client pulled. Log chunks are left out (a
        snapshot per chunk would amplify disk writes); they ride along
        with the next change."""
        return (
            state.phase,
            state.current_round,
            state.model_version,
            tuple(sorted(state.received)),
            state.cohort,
            state.departed,
            state.failed_rounds,
            tuple(sorted(state.rejected)),
            tuple(sorted((e["cname"], e["seq"]) for e in state.buffer)),
            tuple(sorted(state.pulled.items())),
            tuple(sorted(state.secagg_seeds.items())),
            tuple(sorted(state.secagg_roster.items())),
            tuple(sorted(state.privacy_steps.items())),
        )

    # -- state advancement (the only writer, under the lock) --

    def _spawn(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _apply(self, event: R.Event) -> R.Reply:
        async with self._lock:
            prev_state = self.state
            prev_sig = self._persist_sig(prev_state) if self._state_path else None
            t_apply = time.perf_counter()
            self.state, reply = R.transition(self.state, event)
            apply_s = time.perf_counter() - t_apply
            rnd = prev_state.current_round
            self.transition_s[rnd] = self.transition_s.get(rnd, 0.0) + apply_s
            if self.state.phase == R.PHASE_FINISHED:
                self.finished.set()
            state = self.state
            if (
                isinstance(event, R.TrainDone)
                and event.trace_ctx
                and reply.status in (R.RESP_ACY, R.RESP_ARY, R.FIN)
                and tracing.TraceContext.from_wire(event.trace_ctx) is not None
            ):
                self._trace_links[event.cname] = event.trace_ctx
        try:
            observe_transition(prev_state, state, event, reply, apply_s)
        except Exception:  # telemetry never breaks the protocol
            log.exception("metric observation failed; protocol unaffected")
        if self._state_path and self._persist_sig(state) != prev_sig:
            # Off the serving path: a stalled disk must not freeze the
            # protocol, and a failed save must not swallow the reply.
            self._state_pending = state
            self._spawn(self._save_state_file())
        if state.model_version != prev_state.model_version:
            # A zero-length marker on the version-lineage trace with the
            # deterministic context flush:vV, linked to the wire contexts
            # of the uploads it averaged.
            entry = state.history[-1] if state.history else {}
            links = []
            for cname in entry.get("clients", ()):
                ctx = self._trace_links.pop(cname, None)
                if ctx is not None:
                    links.append(ctx)
            fctx = tracing.flush_context(state.model_version)
            with tracing.span(
                "fed.flush",
                trace=fctx.trace,
                ctx=fctx.to_wire(),
                links=sorted(links),
                version=state.model_version,
                round=prev_state.current_round,
                apply_s=round(apply_s, 6),
            ):
                pass
            if self._metrics is not None:
                # One record per round, off the event loop.
                self._spawn(asyncio.to_thread(
                    self._metrics.log, "round", bytes_per_round=entry.get("bytes_received"), **entry
                ))
            if self._eval_fn is not None:
                self._spawn(self._run_eval(state))
            if self._checkpointer is not None:
                # Off the serving path: the reply that closed the round must
                # not wait for the disk, and a failed save must not swallow it.
                self._spawn(self._save_checkpoint(state))
        return reply

    async def _save_checkpoint(self, state: R.ServerState) -> None:
        async with self._ckpt_lock:
            try:
                t0 = time.perf_counter()
                await asyncio.to_thread(save_server_state, self._checkpointer, state)
            except Exception:
                log.exception("checkpoint save failed for model_version %d", state.model_version)
                return
            self.checkpoints.append({"model_version": state.model_version,
                                     "ms": 1e3 * (time.perf_counter() - t0)})

    async def _save_state_file(self) -> None:
        async with self._state_lock:
            state = self._state_pending
            if state is None:
                return  # an earlier task already wrote a newer snapshot
            self._state_pending = None
            try:
                t0 = time.perf_counter()
                n_bytes = await asyncio.to_thread(save_state_file, self._state_path, state)
                ms = 1e3 * (time.perf_counter() - t0)
            except Exception:
                log.exception("statefile save failed for round %d", state.current_round)
                return
            self.snapshots.append({
                "model_version": state.model_version, "buffered": len(state.buffer), "bytes": n_bytes, "ms": ms,
            })

    async def _run_eval(self, state: R.ServerState) -> None:
        """Evaluate the round's new global off the serving path; keep the
        best by eval loss under ``config.best_path``."""
        rnd = state.history[-1]["round"] if state.history else state.current_round
        try:
            result = await asyncio.to_thread(self._eval_fn, state.global_blob)
        except Exception:
            log.exception("server-side eval failed for round %s", rnd)
            return
        entry = {"round": rnd, "model_version": state.model_version, **result}
        self.eval_history.append(entry)
        log.info("global model eval: %s", entry)
        if self._metrics is not None:
            await asyncio.to_thread(self._metrics.log, "server_eval", **entry)
        if self.config.best_path and "loss" in result:
            # Compare and write under one lock; a non-finite loss never
            # qualifies (NaN would compare False against every later loss).
            loss = result["loss"]
            async with self._best_lock:
                if math.isfinite(loss) and (self.best_eval is None or loss < self.best_eval["loss"]):
                    try:
                        await asyncio.to_thread(_write_best, self.config.best_path, state.global_blob, entry)
                    except Exception:
                        log.exception("best-model save failed for round %s", rnd)
                    else:
                        self.best_eval = entry

    async def _tick_forever(self) -> None:
        """Drives the pure time effects: enrollment close, round deadlines."""
        while True:
            await asyncio.sleep(self._tick_period_s)
            await self._apply(R.Tick(now=self._clock()))

    # -- gRPC plumbing --

    async def _session(
        self, request_iterator: AsyncIterator[wire.ClientMessage], context
    ) -> AsyncIterator[wire.ServerMessage]:
        token = self.config.auth_token
        async for msg in request_iterator:
            if token and not hmac.compare_digest(msg.token.encode("utf-8"), token.encode("utf-8")):
                # Authentication precedes all protocol work, and the stream
                # ends: an unauthenticated peer cannot keep one RPC open.
                yield wire.ServerMessage(status=R.REJECTED, title="unauthenticated")
                return
            try:
                # Off the event loop: a log chunk's CRC over a large upload
                # must not stall the other streams and the ticks.
                event = await asyncio.to_thread(event_from_message, msg, now=self._clock())
            except (ValueError, TypeError) as e:
                yield wire.ServerMessage(status=R.REJECTED, title=str(e))
                continue
            reply = await self._apply(event)
            if (
                isinstance(event, R.LogChunk)
                and msg.msg.last
                and reply.status == "OK"  # a rejected chunk never flushes
                and self.config.logs_dir
            ):
                await self._flush_log(event.cname, event.title)
            log.debug("%s -> %s", type(event).__name__, reply.status)
            yield message_from_reply(reply)

    async def _flush_log(self, cname: str, title: str) -> None:
        data = self.state.logs.get(f"{cname}/{title}")
        if data is None:
            return
        path = os.path.join(self.config.logs_dir, _safe_component(cname), _safe_component(title))

        def write() -> None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)

        try:
            await asyncio.to_thread(write)
            log.info("log upload %s/%s -> %s (%d bytes)", cname, title, path, len(data))
        except OSError:
            log.exception("failed to flush log upload %s/%s", cname, title)
            return
        async with self._lock:
            # Drop the flushed buffer, unless a fresh upload of the same
            # title already started.
            if self.state.logs.get(f"{cname}/{title}") == data:
                self.state = R.drop_log(self.state, cname, title)

    def _build(self) -> grpc.aio.Server:
        if self.config.tls_ca and not (self.config.tls_cert and self.config.tls_key):
            # tls_ca alone is a client configuration: a server given it
            # would bind plaintext while mTLS is believed on.
            raise ValueError(
                "server has tls_ca but no tls_cert/tls_key: client-cert "
                "enforcement (mTLS) requires the server's own TLS identity"
            )
        server = grpc.aio.server(options=channel_options(self.config.max_message_mb))
        handler = grpc.stream_stream_rpc_method_handler(
            self._session,
            request_deserializer=wire.ClientMessage.decode,
            response_serializer=wire.ServerMessage.encode,
        )
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, {METHOD: handler}),)
        )
        address = f"{self.config.host}:{self.config.port}"
        if self.config.tls_cert and self.config.tls_key:
            with open(self.config.tls_key, "rb") as f:
                key = f.read()
            with open(self.config.tls_cert, "rb") as f:
                cert = f.read()
            ca = None
            if self.config.tls_ca:
                with open(self.config.tls_ca, "rb") as f:
                    ca = f.read()
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=ca, require_client_auth=ca is not None
            )
            self.bound_port = server.add_secure_port(address, creds)
        else:
            self.bound_port = server.add_insecure_port(address)
        return server

    async def start(self) -> int:
        """Bind and serve; returns the bound port (port 0: an ephemeral one)."""
        self._server = self._build()
        await self._server.start()
        self._tick_task = asyncio.create_task(self._tick_forever())
        log.info("serving on %s:%s", self.config.host, self.bound_port)
        return self.bound_port

    async def stop(self, grace: float = 1.0) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()
        if self._bg_tasks:
            await asyncio.gather(*tuple(self._bg_tasks), return_exceptions=True)
        if self._server is not None:
            await self._server.stop(grace)

    async def serve_until_finished(self, extra_grace_s: float | None = None) -> R.ServerState:
        """Serve until the round machine reaches FIN, linger so every client
        can learn FIN and pull the final weights, then stop."""
        if extra_grace_s is None:
            extra_grace_s = max(5.0, 2.0 * self.config.poll_period_s + 5.0)
        await self.start()
        await self.finished.wait()
        await asyncio.sleep(extra_grace_s)
        await self.stop()
        return self.state


class ServerThread:
    """Runs a :class:`FedServer` on its own asyncio loop in a daemon thread:
    the in-process harness for tests and the chip smoke."""

    def __init__(self, server: FedServer):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.port: int | None = None
        self._started = threading.Event()
        self._error: BaseException | None = None
        self._killed = False
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

    def __enter__(self) -> "ServerThread":
        self._thread.start()
        if not self._started.wait(timeout=10) or self._error is not None:
            raise RuntimeError("server failed to start") from self._error
        return self

    def kill(self) -> None:
        """A process death mid-federation, the chaos harness's server kill:
        the gRPC port closes with zero grace (in-flight client calls fail as
        they would against a SIGKILLed process) and the loop stops without
        draining background tasks, so no goodbye state is written. What
        survives is what the atomic statefile writer had already renamed.
        The context exit of a killed thread is a no-op; a fresh
        ``FedServer`` over the same statefile models the restart."""
        if self._killed:
            return
        self._killed = True

        def die() -> None:
            async def seq() -> None:
                try:
                    if self.server._server is not None:
                        # The port must really close, so the restarted
                        # server can bind it again.
                        await self.server._server.stop(0)
                finally:
                    self.loop.stop()

            asyncio.ensure_future(seq())

        self.loop.call_soon_threadsafe(die)
        self._thread.join(timeout=10)

    def __exit__(self, *exc) -> None:
        if self._killed:
            return
        fut = asyncio.run_coroutine_threadsafe(self.server.stop(grace=0.5), self.loop)
        try:
            fut.result(timeout=10)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=10)

    @property
    def state(self) -> R.ServerState:
        return self.server.state
