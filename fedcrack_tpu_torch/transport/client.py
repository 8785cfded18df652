"""The federated client.

The counterpart of ``fedcrack_tpu.transport.client``: enroll -> pull ->
announce -> local fit -> encode and upload -> poll until the round
closes, a small loop around an injected ``train_fn(blob, round, hparams)
-> (blob, n_samples, metrics)``; against a FedBuff server
(``mode="buffered"``) the continuous pull -> train -> push loop instead.
``train.federated.make_train_fn`` plugs in unchanged, and its fit runs on
the card.

Each control message is one short call on the shared bidi method. A
transient channel error retries with jittered exponential backoff within
a per-call time budget; a code no retry can fix (``NON_RETRYABLE_CODES``)
surfaces at once. The upload codec is the one the server advertises at
enroll (``update_codec``), one instance per session, and a top-k residual
is rolled back when the server resyncs an upload it never averaged.
Secure aggregation and the chaos hooks are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import inspect
import logging
import os
import random
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import grpc

from fedcrack_tpu_torch.compress import get_codec
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.native import crc32c
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.transport import wire
from fedcrack_tpu_torch.transport.service import METHOD, SERVICE_NAME, channel_options

log = logging.getLogger("fedcrack.client")

# train_fn(weights_blob, round[, hparams]) -> (weights_blob, sample_count,
# metrics); a third parameter receives the server's in-band training
# hyperparameters from the enroll handshake.
TrainFn = Callable[..., tuple[bytes, int, dict[str, float]]]

# Log uploads go in chunks of this many bytes.
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024

# gRPC codes a retry can never fix: the request itself is wrong or the
# peer has decided about this caller.
NON_RETRYABLE_CODES = frozenset(
    {
        grpc.StatusCode.INVALID_ARGUMENT,
        grpc.StatusCode.UNIMPLEMENTED,
        grpc.StatusCode.PERMISSION_DENIED,
        grpc.StatusCode.UNAUTHENTICATED,
        grpc.StatusCode.FAILED_PRECONDITION,
        grpc.StatusCode.OUT_OF_RANGE,
    }
)


def default_cname() -> str:
    """A fresh unique client name."""
    return f"client-{uuid.uuid4().hex[:8]}"


@dataclass
class SessionResult:
    cname: str
    rounds_completed: int = 0
    final_weights: bytes | None = None
    enrolled: bool = False
    history: list[dict] = field(default_factory=list)


class FedClient:
    def __init__(
        self,
        config: FedConfig,
        train_fn: TrainFn,
        cname: str | None = None,
        port: int | None = None,
        poll_period_s: float | None = None,
        max_retries: int = 5,
        call_timeout_s: float = 300.0,
        retry_budget_s: float = 120.0,
        upload_paths: Sequence[str] = (),
        chaos: Any | None = None,
    ):
        if chaos is not None:
            raise NotImplementedError(
                "FedClient(chaos=...) is not ported yet: the chaos/ hooks, ROADMAP Queue 1 item 5"
            )
        self.config = config
        self.train_fn = train_fn
        try:
            n_params = len(inspect.signature(train_fn).parameters)
        except (TypeError, ValueError):
            n_params = 2
        self._train_takes_hparams = n_params >= 3
        # The server's hyperparameters from the enroll handshake.
        self.server_hparams: dict[str, Any] = {}
        # The upload codec; the negotiated one replaces it at enroll.
        self.codec = get_codec("null")
        # Files shipped to the server's log sink after the final round.
        self.upload_paths = tuple(upload_paths)
        self.cname = cname or default_cname()
        self.port = port if port is not None else config.port
        self.poll_period_s = poll_period_s if poll_period_s is not None else config.poll_period_s
        self.max_retries = max_retries
        self.call_timeout_s = call_timeout_s
        # However the attempts and backoff are set, one call spends at most
        # this much wall clock retrying.
        self.retry_budget_s = retry_budget_s
        # Per-client jitter: backoff sleeps spread over [0.5, 1.5) x the
        # nominal delay so a cohort does not stampede back in lockstep.
        self._jitter = random.Random(self.cname)

    # -- wire helpers --

    def _connect(self) -> tuple[grpc.Channel, Any]:
        target = f"{self.config.host}:{self.port}"
        options = channel_options(self.config.max_message_mb)
        if self.config.tls_ca:
            # TLS, verifying the server against the configured root; with
            # tls_cert/tls_key the client presents its own certificate (mTLS).
            with open(self.config.tls_ca, "rb") as f:
                ca = f.read()
            key = cert = None
            if self.config.tls_cert and self.config.tls_key:
                with open(self.config.tls_key, "rb") as f:
                    key = f.read()
                with open(self.config.tls_cert, "rb") as f:
                    cert = f.read()
            creds = grpc.ssl_channel_credentials(root_certificates=ca, private_key=key, certificate_chain=cert)
            channel = grpc.secure_channel(target, creds, options=options)
        else:
            if self.config.auth_token and not self.config.allow_insecure_token:
                # A client encrypts only through tls_ca: a server's config
                # file (auth_token + tls_cert/tls_key) would otherwise ship
                # the secret in cleartext.
                raise ValueError(
                    "auth_token over a plaintext client channel: set tls_ca "
                    "to verify the server over TLS, or allow_insecure_token "
                    "for loopback/testing"
                )
            channel = grpc.insecure_channel(target, options=options)
        method = channel.stream_stream(
            f"/{SERVICE_NAME}/{METHOD}",
            request_serializer=wire.ClientMessage.encode,
            response_deserializer=wire.ServerMessage.decode,
        )
        return channel, method

    def _call(self, method, msg: wire.ClientMessage) -> wire.ServerMessage:
        delay = 0.2
        deadline = time.monotonic() + self.retry_budget_s
        for attempt in range(self.max_retries):
            try:
                # wait_for_ready rides out a server still starting up.
                for resp in method(iter([msg]), timeout=self.call_timeout_s, wait_for_ready=True):
                    return resp
                raise RuntimeError("stream closed without a reply")
            except grpc.RpcError as e:
                code = e.code()
                if code in NON_RETRYABLE_CODES:
                    raise
                sleep_s = delay * (0.5 + self._jitter.random())
                if attempt == self.max_retries - 1 or time.monotonic() + sleep_s > deadline:
                    raise
                log.warning("rpc failed (%s); retrying in %.1fs", code, sleep_s)
                REGISTRY.counter(
                    "client_retries_total",
                    "transient-RPC retries spent by the transport client "
                    "(non-retryable codes surface immediately, uncounted)",
                ).inc()
                time.sleep(sleep_s)
                delay = min(delay * 2, 5.0)
        raise AssertionError("unreachable")

    def _msg(self, body: Any) -> wire.ClientMessage:
        return wire.ClientMessage(cname=self.cname, token=self.config.auth_token, msg=body)

    def _count_wire(self, direction: str, n_bytes: int, codec: str | None = None) -> None:
        """Weight bytes moved, uploads labeled with their codec."""
        if n_bytes:
            REGISTRY.counter(
                "client_wire_bytes_total",
                "weight bytes moved by the transport client, by direction and codec",
                labels=("direction", "codec"),
            ).labels(direction=direction, codec=codec or "raw").inc(n_bytes)

    def _count_resync(self) -> None:
        REGISTRY.counter(
            "client_resyncs_total",
            "NOT_WAIT resyncs absorbed (upload never averaged; codec "
            "cross-round state rolled back)",
        ).inc()

    def _train(self, weights: bytes, current_round: int):
        if self._train_takes_hparams:
            return self.train_fn(weights, current_round, self.server_hparams)
        return self.train_fn(weights, current_round)

    # -- the session --

    def run_session(self) -> SessionResult:
        result = SessionResult(cname=self.cname)
        channel, method = self._connect()
        try:
            # Phase 1: enroll
            with tracing.span("client.enroll", cname=self.cname):
                rep = self._call(method, self._msg(wire.ReadyReq(config={"current_round": 0})))
            cfg = dict(rep.config)
            if rep.status != R.SW:
                log.info("%s not enrolled: %s", self.cname, rep.status)
                return result
            result.enrolled = True
            current_round = int(cfg["current_round"])
            max_rounds = int(cfg["max_train_round"])
            model_version = int(cfg["model_version"])
            self.server_hparams = {
                k: cfg[k]
                for k in ("local_epochs", "learning_rate", "fedprox_mu", "wire_dtype",
                          "update_codec", "topk_fraction")
                if k in cfg
            }
            # The server's codec, one instance for the whole session (the
            # top-k residual is cross-round state).
            self.codec = get_codec(
                str(cfg.get("update_codec", "null") or "null"),
                topk_fraction=float(cfg.get("topk_fraction", 0.01) or 0.01),
                client_tag=self.cname,
            )
            if bool(cfg.get("secagg", False)):
                raise NotImplementedError(
                    "the server runs secure aggregation, which is not ported yet: "
                    "privacy/secagg.py, ROADMAP Queue 1 item 3"
                )
            if str(cfg.get("mode", "sync") or "sync") == "buffered":
                return self._run_buffered(method, result, max_rounds=max_rounds)

            # Phase 2: pull the global weights
            with tracing.span("client.pull", trace=tracing.version_trace(model_version), cname=self.cname):
                weights = self._call(method, self._msg(wire.PullReq())).weights
            self._count_wire("down", len(weights))

            while True:
                # One trace per update lifecycle, keyed on the base version.
                trace = tracing.version_trace(model_version)
                # Phase 3: announce training
                self._call(method, self._msg(wire.TrainingNotice(round=current_round)))
                # Phase 4: local fit on the round base
                round_base = weights
                train_ctx = tracing.TraceContext(trace, f"train:{self.cname}:r{current_round}")
                with tracing.span("client.train", trace=trace, cname=self.cname, round=current_round,
                                  ctx=train_ctx.to_wire()) as train_span:
                    weights, n_samples, metrics = self._train(weights, current_round)
                # Phase 5: report. The upload is the codec's encoding against
                # the round base; the frame pins base_version server-side.
                upload = self.codec.encode_update(
                    weights, round_base, round=current_round, base_version=model_version
                )
                result.history.append({"round": current_round, "upload_bytes": len(upload), **metrics})
                rep = self._push(method, upload, current_round, n_samples, metrics, trace, train_span,
                                 f"r{current_round}")
                if rep.status == R.NOT_WAIT:
                    # NOT_WAIT on the upload's own reply: the round closed
                    # without it, so the codec gets its cross-round mass back.
                    # (A NOT_WAIT from the poll below means it was averaged.)
                    self.codec.rollback_last()
                    self._count_resync()
                if rep.status == R.RESP_ACY:
                    rep = self._poll(method, model_version, current_round)
                if rep.status == R.REJECTED:
                    raise RuntimeError(f"server rejected update: {dict(rep.config)}")
                # RESP_ARY / NOT_WAIT / FIN carry the round average
                if rep.weights:
                    weights = rep.weights
                result.rounds_completed = current_round
                cfg = dict(rep.config)
                if rep.status == R.FIN or current_round >= max_rounds:
                    result.final_weights = weights
                    self._upload_all(method)
                    return result
                current_round = int(cfg["current_round"])
                model_version = int(cfg["model_version"])
        finally:
            channel.close()

    def _run_buffered(self, method, result: SessionResult, max_rounds: int) -> SessionResult:
        """FedBuff's client loop: pull the current global (the reply's
        config names its version, the base the upload is pinned to),
        train, push, repeat, never waiting for a round to close. A
        ``NOT_WAIT`` reply to a push is a resync (too stale, never
        averaged: the codec rolls back); ``REJECTED`` fails loudly; ``FIN``
        carries the final global."""
        push_seq = 0
        while True:
            with tracing.span("client.pull", trace="buffered", cname=self.cname):
                rep = self._call(method, self._msg(wire.PullReq()))
            weights = rep.weights
            self._count_wire("down", len(weights))
            pcfg = dict(rep.config)
            base_version = int(pcfg.get("model_version", 0))
            current_round = int(pcfg.get("current_round", 1))
            # Many pushes per client: the trace keys on the pulled version,
            # the push sequence keeps each upload's context unique.
            trace = tracing.version_trace(base_version)
            if current_round > max_rounds:
                # The federation finished since the last push: the blob is
                # the final global.
                result.final_weights = weights
                self._upload_all(method)
                return result
            push_seq += 1
            train_ctx = tracing.TraceContext(trace, f"train:{self.cname}:n{push_seq}")
            with tracing.span("client.train", trace=trace, cname=self.cname, round=current_round,
                              ctx=train_ctx.to_wire()) as train_span:
                trained, n_samples, metrics = self._train(weights, current_round)
            upload = self.codec.encode_update(
                trained, weights, round=current_round, base_version=base_version
            )
            rep = self._push(method, upload, current_round, n_samples, metrics, trace, train_span,
                             f"n{push_seq}")
            result.history.append({
                "round": current_round,
                "base_version": base_version,
                "upload_bytes": len(upload),
                "status": rep.status,
                **metrics,
            })
            if rep.status == R.NOT_WAIT:
                self.codec.rollback_last()
                self._count_resync()
            elif rep.status == R.REJECTED:
                raise RuntimeError(f"server rejected update: {dict(rep.config)}")
            elif rep.status in (R.RESP_ACY, R.RESP_ARY):
                result.rounds_completed += 1
            if rep.status == R.FIN:
                result.final_weights = rep.weights or weights
                self._upload_all(method)
                return result

    def _push(self, method, upload: bytes, rnd: int, n_samples: int, metrics: dict, trace: str,
              train_span, tag: str) -> wire.ServerMessage:
        """Send one encoded update in the ``client.push`` span, a child of
        the fit's span; ``tag`` makes its wire context unique."""
        done = wire.TrainDone(
            round=rnd,
            weights=upload,
            sample_count=n_samples,
            metrics={k: float(v) for k, v in metrics.items()},
        )
        push_ctx = tracing.TraceContext(trace, f"push:{self.cname}:{tag}")
        if tracing.current() is not None:
            done.metrics["__trace"] = push_ctx.to_wire()
        self._count_wire("up", len(upload), self.codec.name)
        with tracing.span("client.push", trace=trace, parent=train_span.span_id if train_span else None,
                          cname=self.cname, upload_bytes=len(upload), codec=self.codec.name,
                          ctx=push_ctx.to_wire()):
            return self._call(method, self._msg(done))

    # -- chunked file upload --

    def _upload_all(self, method) -> None:
        """Best effort: a failed log upload never fails the session."""
        for path in self.upload_paths:
            try:
                self.upload_file(path, method=method)
            except (OSError, grpc.RpcError, RuntimeError):
                log.warning("log upload failed for %s", path, exc_info=True)

    def upload_file(
        self,
        path: str,
        title: str | None = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        method=None,
    ) -> None:
        """Stream a file to the server's log sink in CRC32C-framed chunks;
        the final chunk carries ``last=True`` so the server flushes it to
        ``logs_dir``."""
        channel = None
        if method is None:
            channel, method = self._connect()
        try:
            title = title or os.path.basename(path)
            size = os.path.getsize(path)
            offset = 0
            with open(path, "rb") as f:
                while True:
                    data = f.read(chunk_bytes)
                    last = offset + len(data) >= size
                    chunk = wire.LogChunk(title=title, data=data, offset=offset, last=last, crc32c=crc32c(data))
                    rep = self._call(method, self._msg(chunk))
                    if rep.status != "OK":
                        raise RuntimeError(
                            f"log upload of {path!r} rejected at offset {offset}: {rep.title}"
                        )
                    offset += len(data)
                    if last:
                        break
        finally:
            if channel is not None:
                channel.close()

    def _poll(self, method, model_version: int, current_round: int) -> wire.ServerMessage:
        """Version-poll until the round closes."""
        while True:
            time.sleep(self.poll_period_s)
            rep = self._call(method, self._msg(wire.VersionPoll(model_version=model_version, round=current_round)))
            if rep.status != R.WAIT:
                return rep
