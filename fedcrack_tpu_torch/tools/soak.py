"""The concurrent mini-soak: every plane at once, watched live.

``python -m fedcrack_tpu_torch.tools.soak --duration 10 --out soak.json``

The counterpart of ``fedcrack_tpu.tools.soak``. A **buffered federation**
(a FedBuff root, real FedClients looping pull -> train -> push through the
compressed transport), an **edge-tier shard** (a buffered EdgeAggregator
and a raw relay feeding the same root), a **serve plane** (the reference
bucket engine on ``device``, the micro-batcher, and a hot-swap manager
polling the federation's LIVE statefile: the models being served are the
models being trained) and a **driver leg** (a small
``run_mesh_federation`` session), all running CONCURRENTLY under a
rolling chaos schedule:

- a seeded straggler storm (``FaultPlan.storm``) delaying every client's
  pushes with heavy-tail draws,
- periodic CORRUPT_COMPRESSED_FRAME / STALE_REPLAY poisons (rejected
  loudly; the poisoned client dies and is restarted, like a pod),
- one mid-soak server **kill -> restart on the same port** over the
  durable statefile, with clients riding the restart on their retry
  budgets.

The soak watches itself through the telemetry plane: it exports the
process registry on an ephemeral ``/metrics`` port, SCRAPES ITS OWN
ENDPOINT mid-run and at the end (five instrumented planes: fed, serve,
driver, edge, transport client), records correlated trace spans to JSONL,
runs the SLO watchdog, and finishes with the invariant audit:

- **zero torn versions**: per-batch served model versions never go back,
  and every served version was published (the initial weights or a
  recorded hot swap);
- **EF mass conserved**: a top-k error-feedback twin runs beside the
  chaos and checks, per encode, that the codec's accumulator equals the
  conservation-implied remainder, then drains on a quiet tail;
- **statefile restores bit-identical**: the final statefile round-trips
  through load -> save to the same bytes;
- **watermarks steady**: RSS and device-memory leak sentries marked after
  warmup stay inside their slack;
- the watchdog, the ledger's conservation and the canary's evaluations.

The clients' "fit" is seeded noise on the weights and the driver leg's
round program is a host stub, as in the JAX soak: the soak is about the
protocol planes, and what it puts on the card is the serve plane's
forward, the canary and the drift probes under live hot swaps.

Differences from the JAX soak, by design: the JAX audit's recompile
sentry has no counterpart (the port runs eagerly, so there is no program
cache to grow), so the audit has no ``recompiles_since_warmup``,
``clean`` is the conjunction of the other arms, and the default SLO
rules leave out ``zero_serve_recompiles`` (:func:`soak_rules`); the span
sink does not rotate (the port's recorder writes one file); glibc's mmap
threshold is pinned before the leak sentry's mark
(``obs.sentries.pin_mmap_threshold``); ``device`` picks the card (CUDA
unless given) and ``model_config`` the served and trained model (None:
the JAX soak's tiny one). The soak is embedded in no benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from fedcrack_tpu_torch.configs import FedConfig, ModelConfig, ServeConfig

JOIN_S = 30.0

# The JAX soak's model: a few kilobytes of weights.
SOAK_MODEL = dict(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))


class _SoakStop(Exception):
    """Raised inside a client train_fn when the wall expires: unwinds the
    session thread without waiting on the server."""


def _perturb_tree(tree, rng: np.random.Generator, scale: float = 1e-3):
    """A cheap deterministic 'local fit': base + seeded noise per float
    leaf, walked in the JAX package's leaf order (byte-equal to the JAX
    soak's on the same tree and generator)."""
    from fedcrack_tpu_torch.fed.pytree import tree_map

    return tree_map(
        lambda leaf: np.asarray(leaf)
        + rng.normal(0.0, scale, np.shape(leaf)).astype(np.asarray(leaf).dtype)
        if np.issubdtype(np.asarray(leaf).dtype, np.floating)
        else np.asarray(leaf),
        tree,
    )


def _ef_conservation_leg(template, stop: threading.Event, out: dict, seed: int) -> None:
    """The error-feedback mass audit: drive a TopKDeltaCodec twin with
    seeded deltas WHILE the soak's real traffic contends for the GIL, and
    verify after every encode that the codec's residual mass equals the
    conservation-implied remainder (|delta + prior residual| split exactly
    into |transmitted| + |residual|). Then feed zero deltas and require the
    accumulator to drain."""
    from fedcrack_tpu_torch.compress.codecs import TopKDeltaCodec
    from fedcrack_tpu_torch.compress.frames import decode_update
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes

    rng = np.random.default_rng(seed + 777)
    codec = TopKDeltaCodec(fraction=0.25)
    base_tree = tree_from_bytes(tree_to_bytes(template), template=template)
    base_blob = tree_to_bytes(base_tree)
    violations = 0
    checks = 0
    mirror = None  # an independent residual mirror

    def leaves(t):
        return [np.asarray(x, np.float64) for x in tree_leaves(t)]

    base_leaves = leaves(base_tree)
    while not stop.is_set() and checks < 200:
        trained = _perturb_tree(base_tree, rng, scale=1e-2)
        delta = [t - b for t, b in zip(leaves(trained), base_leaves)]
        if mirror is None:
            mirror = [np.zeros_like(d) for d in delta]
        eff = [d + m for d, m in zip(delta, mirror)]
        frame = codec.encode_update(
            tree_to_bytes(trained), base_blob, round=checks + 1, base_version=0
        )
        decoded, _ = decode_update(frame, template, base_tree)
        kept = [t - b for t, b in zip(leaves(decoded), base_leaves)]
        mirror = [e - k for e, k in zip(eff, kept)]
        implied = float(sum(np.abs(m).sum() for m in mirror))
        got = float(codec.residual_mass())
        checks += 1
        if not np.isclose(got, implied, rtol=1e-5, atol=1e-7):
            violations += 1
        time.sleep(0.02)
    # Quiet tail: zero deltas must drain the accumulator toward zero.
    drain = [codec.residual_mass()]
    for i in range(12):
        codec.encode_update(base_blob, base_blob, round=1000 + i, base_version=0)
        drain.append(codec.residual_mass())
    out["checks"] = checks
    out["violations"] = violations
    out["drain_start_mass"] = round(drain[0], 9)
    out["drain_end_mass"] = round(drain[-1], 9)
    out["drained"] = drain[-1] <= drain[0] * 0.05 + 1e-12


def soak_rules() -> list:
    """The built-in SLO rule set without ``zero_serve_recompiles``: that
    rule reads the JAX soak's recompile-sentry gauge, which the port does
    not export, so it could never be determinate here."""
    from fedcrack_tpu_torch.obs.watchdog import default_rules

    return [r for r in default_rules() if r.metric != "serve_recompiles_total"]


def run_soak(
    duration_s: float = 8.0,
    seed: int = 0,
    workdir: str | None = None,
    n_clients: int = 3,
    buffer_k: int = 2,
    staleness_alpha: float = 0.5,
    max_staleness: int = 8,
    update_codec: str = "topk_delta",
    topk_fraction: float = 0.25,
    kill_restart: bool = True,
    rss_slack_bytes: int = 256 * 1024 * 1024,
    slo_rules: str | None = None,
    *,
    device=None,
    model_config: ModelConfig | None = None,
) -> dict:
    """Run the concurrent mini-soak for ``duration_s`` of traffic wall
    (warmup excluded) and return the audit artifact.

    SLO rules (``slo_rules`` = a configs/slo_*.json path, default the
    built-in set) are evaluated DURING the run, a breach dumps the flight
    ring and fails the audit, and the span JSONL is stitched into
    end-to-end update-lifecycle chains (client -> root -> serve under one
    trace id), the artifact's ``tracing`` arm. ``device`` is where the
    serve plane and the driver leg's staging run (CUDA unless given);
    ``model_config`` the model (None: the JAX soak's)."""
    import torch

    from fedcrack_tpu_torch.chaos.inject import ClientChaos
    from fedcrack_tpu_torch.chaos.plan import (
        CORRUPT_COMPRESSED_FRAME,
        STALE_REPLAY,
        Fault,
        FaultPlan,
    )
    from fedcrack_tpu_torch.ckpt import load_state_file, save_state_file
    from fedcrack_tpu_torch.fed import rounds as R
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu_torch.fed.tree import EdgeAggregator
    from fedcrack_tpu_torch.health import ledger as health_ledger
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.health.drift import (
        DriftMonitor,
        export_drift_metrics,
        write_drift_json,
    )
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs import flight
    from fedcrack_tpu_torch.obs import spans as tracing
    from fedcrack_tpu_torch.obs.metrics import MetricsLogger, read_metrics
    from fedcrack_tpu_torch.obs.promexp import MetricsExporter, sample_value, scrape
    from fedcrack_tpu_torch.obs.registry import REGISTRY
    from fedcrack_tpu_torch.obs.sentries import LeakSentry, pin_mmap_threshold
    from fedcrack_tpu_torch.obs.watchdog import Watchdog, load_rules
    from fedcrack_tpu_torch.parallel import make_mesh, run_mesh_federation
    from fedcrack_tpu_torch.parallel.slots import resolve_device
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager
    from fedcrack_tpu_torch.transport.client import FedClient
    from fedcrack_tpu_torch.transport.edge import raw_caller
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    device = resolve_device(device)
    ctx = tempfile.TemporaryDirectory(prefix="soak_") if workdir is None else None
    base_dir = ctx.name if ctx is not None else workdir
    os.makedirs(base_dir, exist_ok=True)
    state_path = os.path.join(base_dir, "server_state.msgpack")
    spans_path = os.path.join(base_dir, "spans.jsonl")
    serve_metrics_path = os.path.join(base_dir, "serve_metrics.jsonl")
    metrics_dump_path = os.path.join(base_dir, "metrics.prom")
    flight_path = os.path.join(base_dir, "flight.json")
    stitched_path = os.path.join(base_dir, "trace_stitched.json")
    tracing.install(spans_path)
    flight.install(path=flight_path)
    watchdog = Watchdog(load_rules(slo_rules) if slo_rules else soak_rules())

    if model_config is None:
        model_config = ModelConfig(**SOAK_MODEL)
    template = init_variables(torch.Generator().manual_seed(seed), model_config)
    names = [f"c{i}" for i in range(n_clients)]
    edge_id = "edge-0"
    cfg = FedConfig(
        max_rounds=100_000,  # the soak is wall-bounded, never round-bounded
        cohort_size=n_clients + 1,  # + the edge shard
        mode="buffered",
        buffer_k=buffer_k,
        staleness_alpha=staleness_alpha,
        max_staleness=max_staleness,
        registration_window_s=10.0,
        round_deadline_s=2.0,  # partial-flush liveness backstop
        port=0,
        state_path=state_path,
        update_codec=update_codec,
        topk_fraction=topk_fraction,
    )

    # ---- serve plane (warmed up BEFORE the traffic wall starts) ----
    serve_config = ServeConfig(
        bucket_sizes=(16,), max_batch=4, max_delay_ms=5.0, tile_overlap=4
    )
    engine = InferenceEngine(model_config, serve_config, device=device)
    serve_metrics = MetricsLogger(serve_metrics_path)
    # Health plane: canary IoU per installed version (evaluated from the
    # manager's poll thread AFTER each pointer flip, never on the serving
    # path) + serve-side drift against a frozen install-time profile
    # (observed from the load loop's consumer thread).
    canary = CanaryEvaluator(engine, metrics=serve_metrics)
    manager = ModelVersionManager(
        engine,
        template,
        initial_version=0,
        state_path=state_path,
        poll_s=0.15,
        template=template,
        canary=canary,
    )
    engine.warmup(manager.snapshot()[1])
    # The canary reference and the frozen drift profile both pin to the
    # BOOT weights, after warmup.
    canary.evaluate(0, manager.snapshot()[1])
    drift_monitor = DriftMonitor(
        reference=DriftMonitor.capture_reference(engine, manager.snapshot()[1])
    )
    batcher = MicroBatcher(engine, manager, metrics=serve_metrics)
    manager.start()  # hot-swap poller: the federation's statefile IS the feed

    # ---- leak sentries: steady state begins after warmup ----
    # Every thread churns weight blobs and trees; with glibc's dynamic mmap
    # threshold their freed blocks stay in per-thread heaps and RSS climbs
    # with the churn at any width past a few kilobytes (sentries.py).
    pin_mmap_threshold()
    leak_sentry = LeakSentry(rss_slack_bytes=rss_slack_bytes)
    leak_sentry.mark()

    # ---- the /metrics endpoint the soak scrapes ITSELF through ----
    exporter = MetricsExporter(REGISTRY)
    exporter.start()
    # Pre-traffic baseline: the process registry is shared, so every number
    # the artifact reports from a scrape is a DELTA over this snapshot.
    pre_scrape = scrape(exporter.url)
    pre_accepted = sample_value(
        pre_scrape, "fed_updates_total", {"result": "accepted"}
    ) or 0.0

    # ---- rolling chaos schedule (seeded) ----
    plan = FaultPlan.storm(
        seed,
        clients=names,
        n_iterations=200,
        tail_alpha=1.1,
        scale_s=0.02,
        cap_s=0.5,
    )
    storm_fired = plan.take("straggler_storm", round=1) is not None
    for r in range(3, 200, 9):
        plan.pending.append(
            Fault(kind=CORRUPT_COMPRESSED_FRAME, client=names[0], round=r)
        )
    for r in range(5, 200, 11):
        plan.pending.append(
            Fault(kind=STALE_REPLAY, client=names[-1], round=r)
        )

    stop = threading.Event()
    counters = {"client_restarts": 0, "client_errors": []}
    counters_lock = threading.Lock()

    def make_train_fn(cname: str, idx: int):
        it = {"n": 0}
        rng = np.random.default_rng((seed, idx))

        def train(weights_bytes: bytes, rnd: int):
            if stop.is_set():
                raise _SoakStop()
            it["n"] += 1
            tree = tree_from_bytes(weights_bytes, template=template)
            trained = _perturb_tree(tree, rng)
            return tree_to_bytes(trained), 8 + idx, {"loss": 1.0 / it["n"]}

        return train

    port_ref = {"port": None}

    def client_loop(cname: str, idx: int) -> None:
        """Run sessions until the wall; a poisoned or killed session is
        restarted with a fresh FedClient (operators restart pods)."""
        first = True
        while not stop.is_set():
            if not first:
                with counters_lock:
                    counters["client_restarts"] += 1
            first = False
            try:
                client = FedClient(
                    cfg,
                    make_train_fn(cname, idx),
                    cname=cname,
                    port=port_ref["port"],
                    max_retries=6,
                    call_timeout_s=10.0,
                    retry_budget_s=8.0,
                    chaos=ClientChaos(plan),
                )
                client.run_session()
            except _SoakStop:
                return
            except Exception as e:
                if stop.is_set():
                    return
                with counters_lock:
                    counters["client_errors"].append(f"{cname}: {e!r}")
                time.sleep(0.1)

    edge_stats = {"flushes": 0, "accepted": 0, "resyncs": 0, "errors": []}

    def edge_loop() -> None:
        """The edge-tier shard: two synthetic leaves fold into a buffered
        EdgeAggregator whose partials relay up to the SAME root."""
        from fedcrack_tpu_torch.transport import wire
        from fedcrack_tpu_torch.transport.codec import decode_scalar_map, encode_scalar_map

        edge = EdgeAggregator(
            edge_id,
            template,
            mode="buffered",
            buffer_k=2,
            staleness_alpha=staleness_alpha,
            max_staleness=max_staleness,
            state_path=os.path.join(base_dir, "edge_state.msgpack"),
        )
        rng = np.random.default_rng((seed, 99))
        channel = call = None
        enrolled = False
        leaf_it = 0
        while not stop.is_set():
            try:
                if call is None:
                    channel, call = raw_caller(port_ref["port"])
                if not enrolled:
                    rep = call(wire.ClientMessage(cname=edge_id, msg=wire.ReadyReq()))
                    if rep.status != R.SW:
                        time.sleep(0.1)
                        continue
                    enrolled = True
                rep = call(wire.ClientMessage(cname=edge_id, msg=wire.PullReq()))
                pcfg = decode_scalar_map(rep.config)
                version = int(pcfg.get("model_version", 0))
                rnd = int(pcfg.get("current_round", 1))
                if version != edge.base_version:
                    if edge.base_version < 0:
                        edge.begin_round(rnd, rep.weights, version, ["l0", "l1"])
                    else:
                        edge.advance_base(rnd, rep.weights, version)
                base_tree = tree_from_bytes(edge.base_blob, template=template)
                for leaf in ("l0", "l1"):
                    leaf_it += 1
                    leaf_ctx = tracing.TraceContext(
                        tracing.version_trace(edge.base_version),
                        f"train:{leaf}:n{leaf_it}",
                    )
                    with tracing.span(
                        "client.train",
                        trace=leaf_ctx.trace,
                        cname=leaf,
                        ctx=leaf_ctx.to_wire(),
                    ):
                        blob = tree_to_bytes(_perturb_tree(base_tree, rng))
                    ok, _why = edge.offer_buffered(
                        leaf, blob, 4 + leaf_it % 3, edge.base_version,
                        trace_ctx=leaf_ctx.to_wire(),
                    )
                    edge_stats["accepted"] += bool(ok)
                if edge.buffer_ready():
                    partial, total, info = edge.flush_partial()
                    # The edge flush's wire context rides the hop up like
                    # any client push's: the root re-parents it onto the
                    # flush that folds this partial.
                    metrics: dict = {}
                    encode_scalar_map(metrics, {"__trace": info["trace_ctx"]})
                    prep = call(wire.ClientMessage(cname=edge_id, msg=wire.TrainDone(
                        round=rnd, weights=partial, sample_count=total, metrics=metrics)))
                    edge_stats["flushes"] += 1
                    if prep.status == R.NOT_WAIT:
                        edge_stats["resyncs"] += 1
                time.sleep(0.05)
            except Exception as e:
                # Server restart mid-soak: drop the channel, re-dial the
                # (same) port. A dead channel is the EXPECTED fault here.
                if stop.is_set():
                    return
                edge_stats["errors"].append(repr(e))
                if channel is not None:
                    channel.close()
                channel = call = None
                time.sleep(0.2)

    load_stats = {"submitted": 0, "completed": 0, "failed": 0}
    versions_seen: set[int] = set()

    def load_loop() -> None:
        """Closed-loop serve traffic: small bursts of bucket-shaped
        requests; every future is awaited (zero-drop accounting)."""
        rng = np.random.default_rng((seed, 7))
        while not stop.is_set():
            futures = []
            for _ in range(4):
                img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                futures.append((img, batcher.submit(img, deadline_ms=250.0)))
                load_stats["submitted"] += 1
            for img, f in futures:
                try:
                    res = f.result(timeout=10.0)
                    load_stats["completed"] += 1
                    versions_seen.add(res.model_version)
                    # Drift profiling happens HERE, after the future
                    # resolved, on this consumer thread, never inside the
                    # batcher (the hot path pays nothing for it).
                    drift_monitor.observe(img, res.probs)
                except Exception:
                    load_stats["failed"] += 1
            time.sleep(0.01)

    driver_stats: dict = {}

    def driver_leg() -> None:
        """A small concurrent run_mesh_federation session: the driver
        plane's counters and spans land in the registry the scrape reads.
        The round program is a host stub over the staged tensors: the
        DRIVER machinery (staging, records, telemetry) is what this leg
        exercises."""
        try:
            mesh = make_mesh(1, 1, device=device)

            def round_fn(variables, images, masks, active, n_samples):
                return variables, {"loss": torch.zeros((1,), dtype=torch.float32, device=images.device)}

            def data_fn(r):
                images = np.zeros((1, 1, 1, 8, 8, 3), np.uint8)
                masks = np.zeros((1, 1, 1, 8, 8, 1), np.uint8)
                return (
                    images, masks,
                    np.ones(1, np.float32), np.ones(1, np.float32),
                )

            t0 = time.perf_counter()
            _, records = run_mesh_federation(round_fn, template, data_fn, 3, mesh)
            driver_stats["rounds"] = len(records)
            driver_stats["wall_s"] = round(time.perf_counter() - t0, 4)
        except Exception as e:
            driver_stats["error"] = repr(e)

    ef_out: dict = {}

    # ---- boot the root and unleash ----
    server = FedServer(cfg, template, tick_period_s=0.05)
    st = ServerThread(server)
    st.__enter__()
    port_ref["port"] = st.port
    threads = [
        threading.Thread(target=client_loop, args=(n, i), name=f"soak-{n}")
        for i, n in enumerate(names)
    ]
    threads.append(threading.Thread(target=edge_loop, name="soak-edge"))
    threads.append(threading.Thread(target=load_loop, name="soak-load"))
    threads.append(threading.Thread(target=driver_leg, name="soak-driver"))
    threads.append(
        threading.Thread(
            target=_ef_conservation_leg,
            args=(template, stop, ef_out, seed),
            name="soak-ef",
        )
    )
    t_start = time.monotonic()
    deadline = t_start + duration_s
    for t in threads:
        t.start()

    mid_scrape_families = 0
    kill_event: dict = {"killed": False}
    st_current = st
    last_watchdog_eval = 0.0
    try:
        # Mid-soak: scrape our own endpoint while everything is in flight.
        while time.monotonic() < deadline:
            remaining = deadline - time.monotonic()
            if time.monotonic() - last_watchdog_eval >= 0.5:
                # The SLO watchdog rides the run: rules evaluated over the
                # live registry every ~0.5 s; a breach dumps the flight
                # ring at once (Watchdog.enforce); the verdict lands below.
                last_watchdog_eval = time.monotonic()
                watchdog.enforce()
            if kill_restart and not kill_event["killed"] and (
                time.monotonic() - t_start >= duration_s * 0.45
            ):
                held_port = st_current.port
                t_kill = time.monotonic()
                st_current.kill()
                server2 = FedServer(
                    dataclasses.replace(cfg, port=held_port),
                    template,
                    tick_period_s=0.05,
                )
                restored_version = server2.state.model_version
                st_current = ServerThread(server2).__enter__()
                kill_event.update(
                    killed=True,
                    restart_s=round(time.monotonic() - t_kill, 4),
                    restored_version=restored_version,
                    restored_buffer=len(server2.state.buffer),
                )
                continue
            if mid_scrape_families == 0 and time.monotonic() - t_start > min(
                2.0, duration_s / 3
            ):
                mid_scrape_families = len(scrape(exporter.url))
                leak_sentry.sample()
                continue
            time.sleep(min(0.1, max(0.01, remaining)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=JOIN_S)
        hung = [t.name for t in threads if t.is_alive()]
        st_current.__exit__(None, None, None)
        manager.stop()
        batcher.close()
    traffic_wall_s = time.monotonic() - t_start

    # ---- final scrape + dump ----
    exposition = REGISTRY.exposition()
    with open(metrics_dump_path, "w", encoding="utf-8") as f:
        f.write(exposition)
    parsed = scrape(exporter.url)
    # One final watchdog pass over the REAL scrape (the text a dashboard
    # would read), then the verdict.
    watchdog.enforce(parsed)
    watchdog_audit = watchdog.audit()
    exporter.stop()
    final_state = st_current.state
    tracing.uninstall()

    # ---- invariant audit ----
    plane_prefixes = ("fed_", "serve_", "driver_", "edge_", "client_")
    planes_covered = {
        p.rstrip("_"): any(name.startswith(p) for name in parsed)
        for p in plane_prefixes
    }
    # Torn versions: serve_batch records land in batch order (one bucket =
    # one worker); versions must never go back and every served version
    # must be published.
    batch_records = read_metrics(serve_metrics_path, kind="serve_batch")
    batch_versions = [int(rec["model_version"]) for rec in batch_records]
    torn = sum(
        1 for a, b in zip(batch_versions, batch_versions[1:]) if b < a
    )
    # A dead serve plane must not audit clean: "zero torn" is vacuous over
    # zero batches, so the audit requires traffic served (and zero loud
    # failures).
    serve_healthy = (
        load_stats["completed"] > 0
        and load_stats["failed"] == 0
        and len(batch_versions) > 0
    )
    published = {0} | {s["to_version"] for s in manager.swaps}
    unpublished_served = sorted(set(batch_versions) - published)
    # Statefile: load -> save must reproduce the file byte for byte
    # (canonical snapshot; arrival order must not leak into the bytes).
    with open(state_path, "rb") as f:
        state_bytes = f.read()
    resaved = os.path.join(base_dir, "server_state.resaved.msgpack")
    save_state_file(resaved, load_state_file(state_path, cfg))
    with open(resaved, "rb") as f:
        resaved_bytes = f.read()
    statefile_ok = state_bytes == resaved_bytes
    leak = leak_sentry.summary()
    # ---- health plane: artifacts + audit arms ----
    ledger_path = os.path.join(base_dir, "ledger.jsonl")
    canary_path = os.path.join(base_dir, "canary.json")
    drift_path = os.path.join(base_dir, "drift.json")
    health_ledger.write_ledger_jsonl(final_state.ledger, ledger_path)
    canary_audit = canary.audit()
    with open(canary_path, "w", encoding="utf-8") as f:
        json.dump(
            {"history": canary.history, "audit": canary_audit},
            f, indent=1, sort_keys=True,
        )
        f.write("\n")
    drift_psis = drift_monitor.compare()
    export_drift_metrics(drift_psis)
    write_drift_json(
        drift_path,
        reference=drift_monitor.reference,
        current=drift_monitor.profile(),
        psis=drift_psis,
    )
    ledger_conservation = health_ledger.conservation(final_state.ledger)
    audit = {
        "torn_versions": int(torn),
        "unpublished_served_versions": unpublished_served,
        "zero_torn_versions": torn == 0 and not unpublished_served,
        "serve_healthy": serve_healthy,
        "ef": ef_out,
        "ef_mass_conserved": (
            ef_out.get("violations") == 0
            and bool(ef_out.get("drained"))
            and ef_out.get("checks", 0) > 0
        ),
        "statefile_restore_bit_identical": statefile_ok,
        "watermarks": leak,
        "watermarks_steady": bool(leak.get("steady")),
        "hung_threads": hung,
        # The machine-checked SLO verdict.
        "watchdog_clean": bool(watchdog_audit["clean"]),
        # Every gate verdict the chaos produced is in the ledger exactly
        # once (offers == accepted + rejected + resyncs, across the
        # mid-soak kill -> restart via the statefile), and every canary
        # evaluation is a finite unit-interval IoU.
        "ledger_conservation": ledger_conservation,
        "ledger_conserved": (
            ledger_conservation["clients"] > 0
            and not ledger_conservation["violations"]
        ),
        "canary_steady": (
            canary_audit["evals"] > 0 and bool(canary_audit["all_finite_unit"])
        ),
    }
    audit["clean"] = (
        audit["zero_torn_versions"]
        and audit["serve_healthy"]
        and audit["ef_mass_conserved"]
        and audit["statefile_restore_bit_identical"]
        and audit["watermarks_steady"]
        and not hung
        and audit["watchdog_clean"]
        and audit["ledger_conserved"]
        and audit["canary_steady"]
    )

    from fedcrack_tpu_torch.obs.spans import read_spans, span_files
    from fedcrack_tpu_torch.tools.trace_stitch import stitch_files, summarize

    span_records = [
        rec for path in span_files(spans_path) for rec in read_spans(path)
    ]
    span_names: dict[str, int] = {}
    for rec in span_records:
        span_names[rec["name"]] = span_names.get(rec["name"], 0) + 1

    # Stitch the span file into end-to-end update lifecycles: in this
    # one-process harness the planes share a JSONL, but the joins are the
    # wire-context / version joins a multi-process deployment stitches
    # across per-process files.
    stitched = stitch_files([spans_path])
    with open(stitched_path, "w", encoding="utf-8") as f:
        json.dump(stitched, f, indent=1, sort_keys=True, default=str)
    tracing_summary = summarize(stitched)

    artifact = {
        "config": {
            "duration_s": duration_s,
            "seed": seed,
            "n_clients": n_clients,
            "buffer_k": buffer_k,
            "staleness_alpha": staleness_alpha,
            "max_staleness": max_staleness,
            "update_codec": update_codec,
            "kill_restart": kill_restart,
        },
        "traffic_wall_s": round(traffic_wall_s, 3),
        "storm_fired": storm_fired,
        "federation": {
            "global_versions": int(final_state.model_version),
            "flushes": len(final_state.history),
            # a delta over the pre-traffic baseline
            "accepted_updates_scraped": (
                (sample_value(parsed, "fed_updates_total", {"result": "accepted"}) or 0.0)
                - pre_accepted
            ),
            "client_restarts": counters["client_restarts"],
            "client_errors": counters["client_errors"][:8],
            "kill_restart": kill_event,
        },
        "edge": {k: v if k != "errors" else v[:4] for k, v in edge_stats.items()},
        "serve": {
            **load_stats,
            "versions_seen": sorted(versions_seen),
            "swaps": len(manager.swaps),
            "latency_ms": batcher.latency.summary(),
            "deadline_missed": batcher.stats()["deadline_missed"],
        },
        "driver": driver_stats,
        "scrape": {
            "families": len(parsed),
            "mid_soak_families": mid_scrape_families,
            "planes_covered": planes_covered,
            "all_planes_covered": all(planes_covered.values()),
            "exposition_bytes": len(exposition),
        },
        "spans": {"total": len(span_records), "by_name": dict(sorted(span_names.items()))},
        "tracing": tracing_summary,
        "watchdog": watchdog_audit,
        "health": {
            "ledger_clients": ledger_conservation["clients"],
            "flagged_clients": sorted(
                name
                for name, rec in final_state.ledger.items()
                if rec.get("flags", 0)
            ),
            "canary": canary_audit,
            "drift_psi": drift_psis,
        },
        "audit": audit,
        "paths": {
            "metrics_dump": metrics_dump_path,
            "spans": spans_path,
            "statefile": state_path,
            "flight": flight_path,
            "stitched_trace": stitched_path,
            "ledger": ledger_path,
            "canary": canary_path,
            "drift": drift_path,
        },
    }
    if not audit["clean"] and not any(
        d["reason"].startswith("watchdog") for d in (flight.current().dumps if flight.current() else [])
    ):
        # A failed audit ships its flight record even when no watchdog
        # rule breached (a torn version or a leak): the dump is the red
        # run's last seconds of history.
        flight.dump("soak audit failed")
    flight.uninstall()
    if ctx is not None:
        # Keep nothing from a temp workdir (the artifact embeds the
        # numbers); a named workdir keeps its dumps.
        artifact["paths"] = {}
        ctx.cleanup()
    return artifact


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fedcrack_tpu_torch.tools.soak", description=__doc__
    )
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--buffer-k", type=int, default=2)
    p.add_argument("--codec", default="topk_delta")
    p.add_argument("--no-kill", action="store_true",
                   help="skip the mid-soak server kill -> restart")
    p.add_argument("--slo-rules", default="",
                   help="SLO watchdog rule file (configs/slo_*.json); "
                   "empty = the built-in set without zero_serve_recompiles")
    p.add_argument("--workdir", default="",
                   help="keep dumps (metrics.prom, spans.jsonl, flight.json, "
                   "trace_stitched.json) here; empty = temp dir, dumps "
                   "discarded")
    p.add_argument("--out", default="", help="write the audit artifact JSON here")
    p.add_argument("--device", default=None,
                   help="the serve plane's device (default: cuda)")
    args = p.parse_args(argv)
    artifact = run_soak(
        duration_s=args.duration,
        seed=args.seed,
        n_clients=args.clients,
        buffer_k=args.buffer_k,
        update_codec=args.codec,
        kill_restart=not args.no_kill,
        workdir=args.workdir or None,
        slo_rules=args.slo_rules or None,
        device=args.device,
    )
    payload = json.dumps(artifact, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload)
        print(f"wrote {args.out}")
        print(json.dumps(artifact["audit"], indent=1, sort_keys=True))
    else:
        print(payload)
    if artifact["watchdog"]["breaches"]:
        # The breach -> flight dump -> exit code contract (the dump landed
        # the moment the first breaching evaluation ran).
        from fedcrack_tpu_torch.obs.watchdog import BREACH_EXIT

        return BREACH_EXIT
    return 0 if artifact["audit"]["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
