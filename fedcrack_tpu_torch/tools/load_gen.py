"""Closed- and open-loop load generator for the serving plane.

The counterpart of ``fedcrack_tpu.tools.load_gen``. It drives
``fedcrack.ServePlane/Predict`` (``serve/service.py``) with synthetic crack
images and prints one JSON summary: completed, rejected, shed and dropped
counts, client-side latency percentiles (p50/p95/p99 through the bounded
reservoir the server uses), throughput, traffic per size, and the model
versions observed, which is how a harness proves a live hot swap landed
mid-run. Requests are the port's wire messages (``transport/wire.py``) on
a channel from ``transport/serve_client.py``, so clients and servers of
either package talk to it.

Modes:

- **closed** (default): ``concurrency`` workers, each with its own stream
  and one request in flight: latency at a fixed multiprogramming level.
- **open**: requests injected on the arrival schedule at ``rate_rps``
  whatever the completions, dealt round-robin over ``concurrency``
  streams (the server answers one request per stream at a time): the
  overload probe. A server that falls behind shows it as latency or loud
  sheds, never as drops.

Arrival profiles (open mode): ``const`` keeps a fixed rate; ``ramp`` steps
it through 0.25x/0.5x/1x/2x of ``rate_rps`` and ``diurnal`` replays a
compressed day (0.2x/1x/1.8x/0.8x), both with seeded Poisson gaps and
equal request counts per phase. The summary counts shed requests
(``RESOURCE_EXHAUSTED``) apart from rejects and never as drops, and gives
p50/p95/p99 per phase. ``video`` is a session profile instead: seeded
correlated frames over StreamPredict beside closed-loop stills, every
``audit_every``-th frame byte-compared with the stateless Predict.

``--swap-statefile``/``--swap-after`` publish new weights (a statefile at
``--swap-version``, ``serve.hot_swap.publish_statefile``) after the N-th
completion. Those weights are the port's seeded init
(``models.resunet.init_variables`` from ``torch.Generator().manual_seed
(--swap-seed)``), which is not the JAX package's seeded init
(``jax.random.key``): the two packages' load generators publish different
models for the same seed.

``--metrics-url`` polls the server's Prometheus endpoint through the run;
the summary's ``fleet`` block gives the ``serve_fleet_replicas`` track
and whether it varied.

``--out-dir`` writes the served masks as ``mask_<request id>.png`` for
``tools/quantify.py --pred-dir``; the summary then maps each written
mask's request id to the model version that answered it
(``mask_versions``).

    python -m fedcrack_tpu_torch.tools.load_gen --target 127.0.0.1:8890 --requests 256 --sizes 128,256
"""

from __future__ import annotations

import json
import threading
import time
from queue import Empty, Queue
from typing import Sequence

import numpy as np

from fedcrack_tpu_torch.obs.metrics import StreamingPercentiles

_STOP = object()

# (phase name, rate multiplier) sequences for the seeded arrival profiles.
RAMP_PHASES = (
    ("ramp_0.25x", 0.25),
    ("ramp_0.5x", 0.5),
    ("ramp_1x", 1.0),
    ("ramp_2x", 2.0),
)
DIURNAL_PHASES = (
    ("diurnal_night", 0.2),
    ("diurnal_morning", 1.0),
    ("diurnal_peak", 1.8),
    ("diurnal_evening", 0.8),
)
PROFILES = ("const", "ramp", "diurnal", "video")


def arrival_schedule(
    profile: str, n: int, rate_rps: float, seed: int = 0
) -> tuple[list[float], list[int], list[dict]]:
    """Seeded send schedule for ``n`` open-loop requests.

    Returns ``(offsets_s, phase_of, phase_meta)``: per-request send offsets
    from the run start (strictly non-decreasing), each request's phase
    index, and per-phase metadata (name, target rate, request count). Same
    (profile, n, rate_rps, seed) -> same schedule, so a shed-count artifact
    is replayable. ``const`` uses fixed periods;
    ``ramp``/``diurnal`` draw exponential inter-arrival gaps (Poisson
    arrivals) at each phase's target rate from one seeded rng."""
    import random

    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
    if profile == "video":
        raise ValueError(
            "video is a session profile (StreamPredict), not an arrival "
            "schedule; run_load dispatches it before scheduling"
        )
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if profile == "const":
        period = 1.0 / rate_rps
        offsets = [i * period for i in range(n)]
        return (
            offsets,
            [0] * n,
            [{"phase": "const", "target_rps": rate_rps, "requests": n}],
        )
    phases = RAMP_PHASES if profile == "ramp" else DIURNAL_PHASES
    per = [n // len(phases)] * len(phases)
    per[-1] += n - sum(per)
    rng = random.Random(f"load_gen/{profile}/{seed}")
    offsets: list[float] = []
    phase_of: list[int] = []
    meta: list[dict] = []
    t = 0.0
    for pi, ((name, mult), count) in enumerate(zip(phases, per)):
        rate = rate_rps * mult
        meta.append(
            {"phase": name, "target_rps": round(rate, 3), "requests": count}
        )
        for _ in range(count):
            offsets.append(t)
            phase_of.append(pi)
            t += rng.expovariate(rate)
    return offsets, phase_of, meta


def make_images(
    n: int, sizes: Sequence[int], seed: int = 0
) -> list[np.ndarray]:
    """n uint8 RGB crack images cycling through ``sizes``: request i gets
    size ``sizes[i % len(sizes)]``. Byte-equal to the JAX package's."""
    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    per_size: dict[int, list[np.ndarray]] = {}
    for si, size in enumerate(sizes):
        count = len(range(si, n, len(sizes)))
        if not count:
            continue
        imgs_f, msks_f = synth_crack_batch(count, img_size=size, seed=seed + si)
        imgs_u8, _ = to_uint8_transport(imgs_f, msks_f)
        per_size[size] = list(imgs_u8)
    out = []
    for i in range(n):
        size = sizes[i % len(sizes)]
        out.append(per_size[size].pop())
    return out


def make_frame_sequence(
    n_frames: int, size: int, motion_fraction: float, seed: int = 0
) -> list[np.ndarray]:
    """A seeded correlated video sequence: frame 0 is a synthetic crack
    image, each later frame copies its predecessor and rewrites a contiguous
    row band of ``motion_fraction * size`` rows at a moving offset — the
    motion band a vehicle-mounted camera produces. ``motion_fraction`` 0 is
    a static camera (all frames byte-identical), 1.0 rewrites the whole
    frame every time (zero exploitable coherence). Same (n_frames, size,
    motion_fraction, seed) -> same bytes."""
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    if not 0.0 <= motion_fraction <= 1.0:
        raise ValueError(
            f"motion_fraction must be in [0, 1], got {motion_fraction}"
        )
    rng = np.random.default_rng(seed)
    base = make_images(1, (size,), seed)[0]
    frames = [base]
    band = int(round(motion_fraction * size))
    for t in range(1, n_frames):
        f = frames[-1].copy()
        if band > 0:
            r0 = (t * band) % max(1, size - band + 1)
            f[r0 : r0 + band] = rng.integers(
                0, 256, (band, size, 3), dtype=np.uint8
            )
        frames.append(f)
    return frames


def _request_chunks(
    request_id: int,
    image: np.ndarray,
    *,
    threshold: float,
    deadline_ms: float,
    chunk_bytes: int,
    crc: bool,
):
    """LogChunk-style framing of one image (offset/last + optional CRC32C)."""
    from fedcrack_tpu_torch.native import crc32c
    from fedcrack_tpu_torch.transport import wire

    h, w, c = image.shape
    blob = image.tobytes()
    n = max(1, chunk_bytes)
    for off in range(0, len(blob), n):
        piece = blob[off : off + n]
        msg = wire.PredictRequest(
            client_id="load_gen",
            request_id=request_id,
            height=h,
            width=w,
            channels=c,
            image=piece,
            offset=off,
            last=off + n >= len(blob),
            threshold=threshold,
            deadline_ms=deadline_ms,
        )
        if crc:
            msg.crc32c = crc32c(piece)
        yield msg


class _Collector:
    """Thread-safe result aggregation shared by all workers."""

    def __init__(self, phase_meta: list[dict] | None = None):
        from fedcrack_tpu_torch.transport.serve_client import OK, SHED

        self._ok, self._shed = OK, SHED
        self.lock = threading.Lock()
        self.latency = StreamingPercentiles(8192)
        self.completed = 0
        self.rejected = 0
        self.shed = 0
        self.deadline_missed = 0
        self.per_size: dict[str, int] = {}
        self.versions: dict[str, int] = {}
        self.server_latency = StreamingPercentiles(8192)
        self.masks: list[tuple[int, int, int, bytes]] = []
        self.mask_versions: dict[str, int] = {}
        # Per-phase accounting (ramp / diurnal): one slot per phase of
        # the arrival schedule — completions, sheds and a client-side
        # latency reservoir each.
        self.phases = [
            {
                "meta": m,
                "completed": 0,
                "shed": 0,
                "rejected": 0,
                "latency": StreamingPercentiles(4096),
            }
            for m in (phase_meta or [])
        ]

    def record(
        self,
        resp,
        latency_s: float,
        keep_mask: bool,
        phase: int | None = None,
    ):
        with self.lock:
            slot = (
                self.phases[phase]
                if phase is not None and phase < len(self.phases)
                else None
            )
            if resp.status == self._shed:
                # A shed is a LOUD answer, not a drop: counted apart from
                # rejects so an artifact can say "admission control fired
                # N times" instead of "N requests failed".
                self.shed += 1
                if slot is not None:
                    slot["shed"] += 1
                return
            if resp.status != self._ok:
                self.rejected += 1
                if slot is not None:
                    slot["rejected"] += 1
                return
            self.completed += 1
            self.latency.add(latency_s * 1e3)
            self.server_latency.add(resp.latency_ms)
            if slot is not None:
                slot["completed"] += 1
                slot["latency"].add(latency_s * 1e3)
            key = f"{resp.height}x{resp.width}"
            self.per_size[key] = self.per_size.get(key, 0) + 1
            v = str(resp.model_version)
            self.versions[v] = self.versions.get(v, 0) + 1
            if keep_mask:
                self.masks.append(
                    (int(resp.request_id), resp.height, resp.width, resp.mask)
                )
                self.mask_versions[str(int(resp.request_id))] = int(resp.model_version)

    def per_phase_summary(self) -> list[dict] | None:
        with self.lock:
            if not self.phases:
                return None
            out = []
            for slot in self.phases:
                s = slot["latency"].summary()
                out.append(
                    {
                        **slot["meta"],
                        "completed": slot["completed"],
                        "shed": slot["shed"],
                        "rejected": slot["rejected"],
                        "latency_ms": {
                            k: s[k] for k in ("count", "p50", "p95", "p99")
                        },
                    }
                )
            return out


class _MetricsSampler:
    """Poll a /metrics endpoint through a load run.

    Samples ``serve_fleet_replicas`` (and the rolling p95 gauge when
    present) every ``interval_s`` on a daemon thread. Scrape failures are
    counted, never raised — a load run must not die because the metrics
    port lagged. The summary's ``replicas_varied`` flag is the elastic
    smoke's proof that the fleet actually resized mid-run."""

    def __init__(self, url: str, interval_s: float = 0.5):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.url = url
        self.interval_s = interval_s
        self.samples: list[dict] = []
        self.errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = time.perf_counter()

    def sample_once(self) -> None:
        from fedcrack_tpu_torch.obs.promexp import sample_value, scrape

        try:
            parsed = scrape(self.url, timeout_s=self.interval_s + 5.0)
        except Exception:
            with self._lock:
                self.errors += 1
            return
        replicas = sample_value(parsed, "serve_fleet_replicas")
        p95_s = sample_value(parsed, "serve_rolling_p95_seconds")
        with self._lock:
            self.samples.append(
                {
                    "t_s": round(time.perf_counter() - self._t0, 3),
                    "replicas": int(replicas) if replicas is not None else None,
                    "p95_ms": round(p95_s * 1e3, 3) if p95_s is not None else None,
                }
            )

    def start(self) -> None:
        if self._thread is not None:
            return
        self._t0 = time.perf_counter()

        def loop():
            self.sample_once()  # t=0 baseline before traffic lands
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
        self.sample_once()  # final state after the run drained

    def summary(self) -> dict:
        with self._lock:
            samples = list(self.samples)
            errors = self.errors
        track = [s["replicas"] for s in samples if s["replicas"] is not None]
        return {
            "url": self.url,
            "interval_s": self.interval_s,
            "samples": len(samples),
            "scrape_errors": errors,
            "replicas_min": min(track) if track else None,
            "replicas_max": max(track) if track else None,
            "replicas_first": track[0] if track else None,
            "replicas_last": track[-1] if track else None,
            "replicas_varied": bool(track) and min(track) != max(track),
            "track": samples,
        }


def _frame_chunks(stream_id, frame_id, image, *, chunk_bytes, crc):
    """LogChunk-style framing of one video frame over StreamRequest."""
    from fedcrack_tpu_torch.native import crc32c
    from fedcrack_tpu_torch.transport import wire

    blob = image.tobytes()
    n = max(1, chunk_bytes)
    for off in range(0, len(blob), n):
        piece = blob[off : off + n]
        f = wire.StreamFrame(
            frame_id=frame_id,
            image=piece,
            offset=off,
            last=off + n >= len(blob),
        )
        if crc:
            f.crc32c = crc32c(piece)
        yield wire.StreamRequest(stream_id=stream_id, msg=f)


def _predict_once(predict_stub, rid: int, image: np.ndarray, opts: dict):
    """One stateless Predict of ``image`` on a fresh RPC (the identity-audit
    reference call); returns the PredictResponse or None."""
    msgs = list(
        _request_chunks(
            rid,
            image,
            threshold=opts["threshold"],
            deadline_ms=0.0,
            chunk_bytes=opts["chunk_bytes"],
            crc=opts["crc"],
        )
    )
    try:
        return next(predict_stub(iter(msgs)))
    except StopIteration:
        return None


class _VideoStats:
    """Thread-safe aggregation across video stream workers."""

    def __init__(self):
        self.lock = threading.Lock()
        self.frames_sent = 0
        self.frames_completed = 0
        self.frames_rejected = 0
        self.tiles_total = 0
        self.tiles_computed = 0
        self.cache_hits = 0
        self.full_reruns = 0
        self.open_failed = 0
        self.versions: dict[str, int] = {}
        self.latency = StreamingPercentiles(8192)
        # Wire-level byte-identity audit: sampled frames re-served through
        # the STATELESS Predict RPC and compared mask-for-mask. Masks are
        # only comparable when both answers came from the SAME model
        # version (a hot swap between the two calls legitimately changes
        # the output) — those samples count as version_skipped, not failed.
        self.audit = {
            "checked": 0,
            "matched": 0,
            "mismatched": 0,
            "version_skipped": 0,
        }

    def summary(self, streams: int, frames_per_stream: int, mf: float) -> dict:
        with self.lock:
            t, c = self.tiles_total, self.tiles_computed
            audit = dict(self.audit)
            audit["ok"] = audit["mismatched"] == 0
            return {
                "streams": streams,
                "frames_per_stream": frames_per_stream,
                "motion_fraction": mf,
                "frames_sent": self.frames_sent,
                "frames_completed": self.frames_completed,
                "frames_rejected": self.frames_rejected,
                "dropped": (
                    self.frames_sent
                    - self.frames_completed
                    - self.frames_rejected
                ),
                "open_failed": self.open_failed,
                "tiles_total": t,
                "tiles_computed": c,
                "cache_hits": self.cache_hits,
                "full_reruns": self.full_reruns,
                "hit_ratio": round(self.cache_hits / t, 4) if t else 0.0,
                "effective_speedup": round(t / c, 3) if c else 1.0,
                "frame_latency_ms": self.latency.summary(),
                "versions_observed": dict(self.versions),
                "audit": audit,
            }


def _video_stream(
    channel,
    stream_id: str,
    frames: list[np.ndarray],
    stats: _VideoStats,
    opts: dict,
    audit_every: int,
    on_complete,
) -> None:
    """Drive one StreamPredict session: open, feed every frame in order,
    close. Every ``audit_every``-th completed frame is re-served through the
    stateless Predict RPC on the same channel and byte-compared."""
    from fedcrack_tpu_torch.transport import wire
    from fedcrack_tpu_torch.transport.serve_client import OK, predict_stub, stream_stub

    size = frames[0].shape[0]
    send_q: Queue = Queue()

    def request_iter():
        while True:
            item = send_q.get()
            if item is _STOP:
                return
            yield from item

    responses = stream_stub(channel)(request_iter())
    predict = predict_stub(channel)
    try:
        send_q.put(
            [
                wire.StreamRequest(
                    stream_id=stream_id,
                    msg=wire.StreamOpen(
                        height=size,
                        width=size,
                        channels=3,
                        threshold=opts["threshold"],
                        track=opts.get("track", False),
                    ),
                )
            ]
        )
        try:
            ack = next(responses)
        except StopIteration:
            with stats.lock:
                stats.open_failed += 1
            return
        if ack.status != OK:
            with stats.lock:
                stats.open_failed += 1
            return
        for fi, frame in enumerate(frames):
            with stats.lock:
                stats.frames_sent += 1
            t0 = time.perf_counter()
            send_q.put(
                list(
                    _frame_chunks(
                        stream_id,
                        fi + 1,
                        frame,
                        chunk_bytes=opts["chunk_bytes"],
                        crc=opts["crc"],
                    )
                )
            )
            try:
                resp = next(responses)
            except StopIteration:
                return  # server ended the stream; unsent frames are drops
            lat_ms = (time.perf_counter() - t0) * 1e3
            with stats.lock:
                if resp.status != OK:
                    stats.frames_rejected += 1
                    continue
                stats.frames_completed += 1
                stats.tiles_total += resp.tiles_total
                stats.tiles_computed += resp.tiles_computed
                stats.cache_hits += resp.cache_hits
                if resp.full_rerun:
                    stats.full_reruns += 1
                v = str(resp.model_version)
                stats.versions[v] = stats.versions.get(v, 0) + 1
                stats.latency.add(lat_ms)
            if audit_every > 0 and fi % audit_every == 0:
                ref = _predict_once(predict, fi + 1, frame, opts)
                with stats.lock:
                    if ref is None or ref.status != OK:
                        pass  # audit reference failed; not a stream defect
                    elif ref.model_version != resp.model_version:
                        stats.audit["version_skipped"] += 1
                    else:
                        stats.audit["checked"] += 1
                        if ref.mask == resp.mask:
                            stats.audit["matched"] += 1
                        else:
                            stats.audit["mismatched"] += 1
            if on_complete is not None:
                on_complete()
        send_q.put(
            [wire.StreamRequest(stream_id=stream_id, msg=wire.StreamClose())]
        )
        try:
            next(responses)  # close ack
        except StopIteration:
            pass
    finally:
        send_q.put(_STOP)


def _closed_worker(
    stub, jobs: Queue, collector: _Collector, opts: dict, on_complete
) -> None:
    """One worker = one stream, one request in flight at a time."""

    send_q: Queue = Queue()

    def request_iter():
        while True:
            item = send_q.get()
            if item is _STOP:
                return
            yield from item

    responses = stub(request_iter())
    try:
        while True:
            try:
                request_id, image = jobs.get_nowait()
            except Empty:
                break
            t0 = time.perf_counter()
            send_q.put(
                list(
                    _request_chunks(
                        request_id,
                        image,
                        threshold=opts["threshold"],
                        deadline_ms=opts["deadline_ms"],
                        chunk_bytes=opts["chunk_bytes"],
                        crc=opts["crc"],
                    )
                )
            )
            try:
                resp = next(responses)
            except StopIteration:
                break  # server ended the stream; remaining jobs count as dropped
            collector.record(resp, time.perf_counter() - t0, opts["keep_masks"])
            if on_complete is not None:
                on_complete()
    finally:
        send_q.put(_STOP)


def _open_stream(
    stub,
    jobs: list,                # [(rid, image, offset_s)] for THIS stream
    t_start: float,
    collector: _Collector,
    opts: dict,
    phase_of: list[int],
    on_complete,
) -> None:
    """One open-loop stream: a sender injects its slice of the arrival
    schedule at ABSOLUTE offsets from the shared run start, a receiver
    drains. The server handles one request per stream at a time, so
    open-loop overload pressure comes from running SEVERAL of these in
    parallel (``concurrency`` streams) — one stream alone is throttled to
    the service latency, whatever the nominal rate."""
    send_q: Queue = Queue()
    t_sent: dict[int, float] = {}
    lock = threading.Lock()

    def request_iter():
        while True:
            item = send_q.get()
            if item is _STOP:
                return
            yield from item

    responses = stub(request_iter())

    def receiver():
        for _ in range(len(jobs)):
            try:
                resp = next(responses)
            except StopIteration:
                return
            rid = int(resp.request_id)
            with lock:
                t0 = t_sent.pop(rid, None)
            lat = (time.perf_counter() - t0) if t0 is not None else 0.0
            collector.record(
                resp,
                lat,
                opts["keep_masks"],
                phase=phase_of[rid] if rid < len(phase_of) else None,
            )
            if on_complete is not None:
                on_complete()

    rx = threading.Thread(target=receiver, daemon=True)
    rx.start()
    for rid, image, offset in jobs:
        t_target = t_start + offset
        now = time.perf_counter()
        if now < t_target:
            time.sleep(t_target - now)
        with lock:
            t_sent[rid] = time.perf_counter()
        send_q.put(
            list(
                _request_chunks(
                    rid,
                    image,
                    threshold=opts["threshold"],
                    deadline_ms=opts["deadline_ms"],
                    chunk_bytes=opts["chunk_bytes"],
                    crc=opts["crc"],
                )
            )
        )
    rx.join(timeout=opts["timeout_s"])
    send_q.put(_STOP)


def _open_loop(
    make_stub,
    images: list,
    collector: _Collector,
    opts: dict,
    offsets: list[float],
    phase_of: list[int],
    on_complete,
    n_streams: int = 1,
) -> None:
    """Open-loop injection over ``n_streams`` parallel streams: requests
    are dealt round-robin (each keeps its ABSOLUTE schedule offset, so the
    aggregate arrival process matches the profile), and each stream runs an
    independent sender/receiver pair."""
    n_streams = max(1, n_streams)
    per_stream: list[list] = [[] for _ in range(n_streams)]
    for rid, image in enumerate(images):
        per_stream[rid % n_streams].append((rid, image, offsets[rid]))
    t_start = time.perf_counter()
    threads = [
        threading.Thread(
            target=_open_stream,
            args=(make_stub(), jobs, t_start, collector, opts, phase_of, on_complete),
            daemon=True,
        )
        for jobs in per_stream
        if jobs
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + opts["timeout_s"]
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


def run_load(
    target: str,
    *,
    mode: str = "closed",
    n_requests: int = 64,
    concurrency: int = 4,
    rate_rps: float = 50.0,
    profile: str = "const",
    sizes: Sequence[int] = (128,),
    seed: int = 0,
    threshold: float = 0.5,
    deadline_ms: float = 0.0,
    chunk_bytes: int = 1 << 20,
    crc: bool = True,
    timeout_s: float = 300.0,
    keep_masks: bool = False,
    max_message_mb: int = 64,
    on_complete=None,
    streams: int = 2,
    frames_per_stream: int = 16,
    motion_fraction: float = 0.1,
    video_size: int = 320,
    audit_every: int = 4,
    track: bool = False,
    metrics_url: str | None = None,
    metrics_interval_s: float = 0.5,
) -> dict:
    """Drive the endpoint; returns the JSON-safe summary (see module doc).
    ``on_complete()`` fires after every completed request — harnesses hook
    swap triggers on it.

    ``--profile video`` is a SESSION profile, not an arrival
    schedule: ``streams`` StreamPredict sessions each feed
    ``frames_per_stream`` seeded correlated frames (``motion_fraction``
    controls the moving row band) while ``n_requests`` ordinary still
    requests run closed-loop through the same front door — mixed traffic
    over one router. Every ``audit_every``-th frame is also served through
    the stateless Predict RPC and byte-compared (the wire-level identity
    audit); the ``video`` summary block carries cache hit ratio, effective
    speedup (tiles_total/tiles_computed) and the audit verdict."""
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
    sampler = None
    if metrics_url:
        sampler = _MetricsSampler(metrics_url, metrics_interval_s)
        sampler.start()
    if profile == "video":
        return _attach_fleet(sampler, _run_video_load(
            target,
            n_requests=n_requests,
            concurrency=concurrency,
            sizes=sizes,
            seed=seed,
            threshold=threshold,
            deadline_ms=deadline_ms,
            chunk_bytes=chunk_bytes,
            crc=crc,
            timeout_s=timeout_s,
            keep_masks=keep_masks,
            max_message_mb=max_message_mb,
            on_complete=on_complete,
            streams=streams,
            frames_per_stream=frames_per_stream,
            motion_fraction=motion_fraction,
            video_size=video_size,
            audit_every=audit_every,
            track=track,
        ))
    if profile != "const" and mode != "open":
        raise ValueError(
            f"profile {profile!r} needs open-loop injection (--mode open); "
            "closed-loop pacing is completion-driven"
        )
    images = make_images(n_requests, sizes, seed)
    offsets, phase_of, phase_meta = arrival_schedule(
        profile, n_requests, rate_rps, seed
    )
    collector = _Collector(phase_meta if mode == "open" else None)
    opts = {
        "threshold": threshold,
        "deadline_ms": deadline_ms,
        "chunk_bytes": chunk_bytes,
        "crc": crc,
        "timeout_s": timeout_s,
        "keep_masks": keep_masks,
    }
    from fedcrack_tpu_torch.transport.serve_client import predict_stub, serve_channel

    t_start = time.perf_counter()
    channel = serve_channel(target, max_message_mb)
    try:
        stub = predict_stub(channel)
        if mode == "closed":
            jobs: Queue = Queue()
            for rid, image in enumerate(images):
                jobs.put((rid, image))
            workers = [
                threading.Thread(
                    target=_closed_worker,
                    args=(stub, jobs, collector, opts, on_complete),
                    daemon=True,
                )
                for _ in range(max(1, concurrency))
            ]
            for w in workers:
                w.start()
            deadline = time.monotonic() + timeout_s
            for w in workers:
                w.join(timeout=max(0.0, deadline - time.monotonic()))
        else:
            _open_loop(
                lambda: predict_stub(channel),
                images,
                collector,
                opts,
                offsets,
                phase_of,
                on_complete,
                n_streams=max(1, concurrency),
            )
    finally:
        channel.close()
    wall_s = time.perf_counter() - t_start

    with collector.lock:
        completed = collector.completed
        rejected = collector.rejected
        shed = collector.shed
        per_size = dict(collector.per_size)
        versions = dict(collector.versions)
    return _attach_fleet(sampler, {
        "mode": mode,
        "target": target,
        "n_requests": n_requests,
        "completed": completed,
        "rejected": rejected,
        "shed": shed,
        "dropped": n_requests - completed - rejected - shed,
        "wall_s": round(wall_s, 3),
        "throughput_rps": round(completed / wall_s, 3) if wall_s > 0 else None,
        "concurrency": concurrency,
        "rate_rps": rate_rps if mode == "open" else None,
        "profile": profile,
        "per_phase": collector.per_phase_summary(),
        "sizes": list(sizes),
        "per_size": per_size,
        "versions_observed": versions,
        "latency_ms": collector.latency.summary(),
        "server_latency_ms": collector.server_latency.summary(),
        "masks": collector.masks if keep_masks else None,
        "mask_versions": dict(collector.mask_versions) if keep_masks else None,
    })


def _attach_fleet(sampler: _MetricsSampler | None, summary: dict) -> dict:
    """Stop the metrics sampler (if any) and attach its ``fleet`` block."""
    if sampler is not None:
        sampler.stop()
        summary["fleet"] = sampler.summary()
    else:
        summary["fleet"] = None
    return summary


def _run_video_load(
    target: str,
    *,
    n_requests: int,
    concurrency: int,
    sizes: Sequence[int],
    seed: int,
    threshold: float,
    deadline_ms: float,
    chunk_bytes: int,
    crc: bool,
    timeout_s: float,
    keep_masks: bool,
    max_message_mb: int,
    on_complete,
    streams: int,
    frames_per_stream: int,
    motion_fraction: float,
    video_size: int,
    audit_every: int,
    track: bool,
) -> dict:
    """The ``--profile video`` driver: ``streams`` video sessions plus
    ``n_requests`` closed-loop stills through the same server/channel."""
    from fedcrack_tpu_torch.transport.serve_client import predict_stub, serve_channel

    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    if frames_per_stream < 1:
        raise ValueError(
            f"frames_per_stream must be >= 1, got {frames_per_stream}"
        )
    if video_size < 1:
        raise ValueError(f"video_size must be >= 1, got {video_size}")
    sequences = [
        make_frame_sequence(
            frames_per_stream, video_size, motion_fraction, seed + si
        )
        for si in range(streams)
    ]
    still_images = make_images(n_requests, sizes, seed) if n_requests else []
    collector = _Collector()
    stats = _VideoStats()
    opts = {
        "threshold": threshold,
        "deadline_ms": deadline_ms,
        "chunk_bytes": chunk_bytes,
        "crc": crc,
        "timeout_s": timeout_s,
        "keep_masks": keep_masks,
        "track": track,
    }
    t_start = time.perf_counter()
    channel = serve_channel(target, max_message_mb)
    try:
        video_threads = [
            threading.Thread(
                target=_video_stream,
                args=(
                    channel,
                    f"video-{si}",
                    sequences[si],
                    stats,
                    opts,
                    audit_every,
                    on_complete,
                ),
                daemon=True,
            )
            for si in range(streams)
        ]
        still_threads = []
        if still_images:
            stub = predict_stub(channel)
            jobs: Queue = Queue()
            for rid, image in enumerate(still_images):
                jobs.put((rid, image))
            still_threads = [
                threading.Thread(
                    target=_closed_worker,
                    args=(stub, jobs, collector, opts, on_complete),
                    daemon=True,
                )
                for _ in range(max(1, concurrency))
            ]
        for t in video_threads + still_threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        for t in video_threads + still_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        channel.close()
    wall_s = time.perf_counter() - t_start

    with collector.lock:
        completed = collector.completed
        rejected = collector.rejected
        shed = collector.shed
        per_size = dict(collector.per_size)
        versions = dict(collector.versions)
    video = stats.summary(streams, frames_per_stream, motion_fraction)
    frames_done = video["frames_completed"]
    # Effective img/s: completed frames scaled by the work a stateless
    # server would have done for them (tiles_total / tiles_computed) —
    # the ~1/(changed-tile-fraction) model, measured on the wire.
    video["frames_per_s"] = (
        round(frames_done / wall_s, 3) if wall_s > 0 else None
    )
    video["effective_frames_per_s"] = (
        round(frames_done * video["effective_speedup"] / wall_s, 3)
        if wall_s > 0
        else None
    )
    return {
        "mode": "video",
        "target": target,
        "n_requests": n_requests,
        "completed": completed,
        "rejected": rejected,
        "shed": shed,
        "dropped": n_requests - completed - rejected - shed,
        "wall_s": round(wall_s, 3),
        "throughput_rps": round(completed / wall_s, 3) if wall_s > 0 else None,
        "concurrency": concurrency,
        "rate_rps": None,
        "profile": "video",
        "per_phase": None,
        "sizes": list(sizes),
        "per_size": per_size,
        "versions_observed": versions,
        "latency_ms": collector.latency.summary(),
        "server_latency_ms": collector.server_latency.summary(),
        "masks": collector.masks if keep_masks else None,
        "mask_versions": dict(collector.mask_versions) if keep_masks else None,
        "video": video,
    }


def write_masks(masks, out_dir: str) -> int:
    """Dump (request_id, h, w, bytes) masks as PNGs for tools/quantify.py
    --pred-dir; returns how many were written."""
    import os

    import cv2

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for rid, h, w, blob in masks:
        mask = np.frombuffer(blob, np.uint8).reshape(h, w)
        cv2.imwrite(os.path.join(out_dir, f"mask_{rid:05d}.png"), mask)
        n += 1
    return n


def main(argv=None) -> int:
    """``python -m fedcrack_tpu_torch.tools.load_gen``: prints the summary
    as one JSON line; exits 0 when no request (and no video frame) was
    dropped and the video audit held."""
    import argparse

    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile

    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.load_gen", description=__doc__)
    p.add_argument("--target", default="127.0.0.1:8890", help="host:port")
    p.add_argument("--mode", choices=["closed", "open"], default="closed")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--rate-rps", type=float, default=50.0)
    p.add_argument(
        "--profile",
        choices=list(PROFILES),
        default="const",
        help="open-loop arrival profile: const (fixed rate), ramp "
        "(0.25x->2x rate steps), diurnal (compressed-day replay); seeded. "
        "'video' is a session profile instead: StreamPredict sessions with "
        "seeded correlated frames mixed with closed-loop stills",
    )
    p.add_argument(
        "--streams", type=int, default=2,
        help="video profile: concurrent StreamPredict sessions",
    )
    p.add_argument(
        "--frames", type=int, default=16,
        help="video profile: frames per stream",
    )
    p.add_argument(
        "--motion-fraction", type=float, default=0.1,
        help="video profile: fraction of frame rows rewritten per frame "
        "(0 = static camera, 1 = zero frame coherence)",
    )
    p.add_argument(
        "--video-size", type=int, default=320,
        help="video profile: square frame edge in px (multi-tile frames "
        "need this larger than the server's largest bucket)",
    )
    p.add_argument(
        "--audit-every", type=int, default=4,
        help="video profile: byte-compare every Nth frame against the "
        "stateless Predict RPC (0 disables the identity audit)",
    )
    p.add_argument(
        "--track", action="store_true",
        help="video profile: enable server-side crack-track continuity",
    )
    p.add_argument(
        "--metrics-url",
        help="poll this Prometheus endpoint during the run and report the "
        "serve_fleet_replicas track (min/max/varied) in the summary's "
        "'fleet' block",
    )
    p.add_argument(
        "--metrics-interval-s", type=float, default=0.5,
        help="seconds between --metrics-url scrapes",
    )
    p.add_argument("--sizes", default="128", help="comma-separated request sizes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--deadline-ms", type=float, default=0.0)
    p.add_argument("--timeout-s", type=float, default=300.0)
    p.add_argument("--out-dir", help="write served masks as PNGs here")
    p.add_argument(
        "--swap-statefile",
        help="publish new weights to this statefile mid-run (live hot-swap smoke)",
    )
    p.add_argument("--swap-after", type=int, default=0,
                   help="publish the swap after N completed requests")
    p.add_argument("--swap-version", type=int, default=1000)
    p.add_argument("--swap-seed", type=int, default=1)
    p.add_argument("--img-size", type=int, default=128,
                   help="model config size for --swap-statefile weights init")
    p.add_argument(
        "--swap-config",
        help="FedConfig JSON whose model section shapes the --swap-statefile "
        "weights (the published tree must match the SERVED model; overrides "
        "--img-size)",
    )
    args = p.parse_args(argv)

    sizes = tuple(int(s) for s in args.sizes.split(",") if s.strip())

    swap_state = {"fired": False, "count": 0}
    swap_lock = threading.Lock()
    swap_blob = None
    if args.swap_statefile:
        # Encode the swap weights before the run: serializing a full model
        # at trigger time costs seconds under load.
        import torch

        from fedcrack_tpu_torch.configs import FedConfig, ModelConfig
        from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
        from fedcrack_tpu_torch.models.resunet import init_variables

        if args.swap_config:
            with open(args.swap_config) as f:
                swap_model = FedConfig.from_json(f.read()).model
        else:
            swap_model = ModelConfig(img_size=args.img_size)
        swap_blob = tree_to_bytes(init_variables(torch.Generator().manual_seed(args.swap_seed), swap_model))

    def on_complete():
        with swap_lock:
            swap_state["count"] += 1
            fire = not swap_state["fired"] and swap_state["count"] >= args.swap_after > 0
            if fire:
                swap_state["fired"] = True
        if fire:
            publish_statefile(args.swap_statefile, model_version=args.swap_version, blob=swap_blob)

    summary = run_load(
        args.target,
        mode=args.mode,
        n_requests=args.requests,
        concurrency=args.concurrency,
        rate_rps=args.rate_rps,
        profile=args.profile,
        sizes=sizes,
        seed=args.seed,
        threshold=args.threshold,
        deadline_ms=args.deadline_ms,
        timeout_s=args.timeout_s,
        keep_masks=bool(args.out_dir),
        on_complete=on_complete if args.swap_statefile else None,
        streams=args.streams,
        frames_per_stream=args.frames,
        motion_fraction=args.motion_fraction,
        video_size=args.video_size,
        audit_every=args.audit_every,
        track=args.track,
        metrics_url=args.metrics_url,
        metrics_interval_s=args.metrics_interval_s,
    )
    masks = summary.pop("masks", None)
    if args.out_dir and masks:
        summary["masks_written"] = write_masks(masks, args.out_dir)
    summary["swap_published"] = swap_state["fired"] if args.swap_statefile else None
    print(json.dumps(summary), flush=True)
    video = summary.get("video")
    video_ok = video is None or (
        video["dropped"] == 0
        and video["open_failed"] == 0
        and video["audit"]["ok"]
    )
    return 0 if summary["dropped"] == 0 and video_ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
