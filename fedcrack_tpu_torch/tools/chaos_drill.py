"""The chaos drills: scripted faults, each recovery checked and timed.

``python -m fedcrack_tpu_torch.tools.chaos_drill --out drill.json [--rounds N]``

The counterpart of ``fedcrack_tpu.tools.chaos_drill``. Each drill stages
one fault through a ``chaos.FaultPlan`` (so the artifact shows that it
fired), drives the recovery over real loopback gRPC or on a tiny serving
stack, and returns its verdicts beside its timings:

- ``kill_restart``: a coordinator killed mid-round resumes from its
  statefile; ``restore_s`` (dead process to resumed state machine),
  ``kill_to_recover_s`` (kill to the interrupted round's aggregation) and
  ``session_s``;
- ``corrupt_frame``: a bit-flipped int8 frame refused on its CRC, the
  round closing at quorum on the clean frames;
- ``edge_crash``: an edge of the aggregation tree killed after two of its
  three leaves and restored from its statefile;
- ``straggler_storm``: sync rounds against FedBuff under one heavy-tail
  delay schedule, rates scraped from ``/metrics``;
- ``buffered_kill``: a FedBuff server killed mid-buffer flushes the same
  bytes as an unkilled twin;
- ``replica_crash`` and ``elastic_fleet``: a serving replica killed under
  load (and racing a scale-down), a shadow lane killed mid-staging;
- ``stream_reset``: a video session's tile cache dropped mid-stream;
- ``scaled_update`` and ``robust_aggregation``: an amplified update that
  the gate accepts, flagged by the ledger, cliffing the canary, breaching
  the watchdog's rules, and held off by the robust folds;
- ``secagg_dropout``: a masker lost in the recovery window;
- ``dp_replay``: a DP-SGD round of the slot plane killed by a device
  failure and retried, bit-identical to an unkilled run.

The serving drills and ``dp_replay`` run a tiny seeded model on
``device`` (CUDA unless given); everything else is host work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as R
from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes

# The serving drills' tiny model (the JAX drills' widths).
TINY_MODEL = dict(img_size=16, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))


def _vars(value: float):
    return {"params": {"w": np.full((4, 4), value, np.float32)}}


def _raw_caller(port: int):
    """A one-message-per-call client (``transport.edge.raw_caller``)."""
    from fedcrack_tpu_torch.transport.edge import raw_caller

    return raw_caller(port)


# The message builders import the transport's wire codec when called:
# the transport package loads grpc.


def _message(cname: str, kind: str, **fields):
    from fedcrack_tpu_torch.transport import wire

    return wire.ClientMessage(cname=cname, msg=getattr(wire, kind)(**fields))


def _ready(cname: str):
    return _message(cname, "ReadyReq")


def _upload(cname: str, rnd: int, blob: bytes, ns: int):
    return _message(cname, "TrainDone", round=rnd, weights=blob, sample_count=ns)


def _done(cname: str, rnd: int, value: float, ns: int):
    return _upload(cname, rnd, tree_to_bytes(_vars(value)), ns)


def _poll(cname: str, model_version: int, rnd: int):
    return _message(cname, "VersionPoll", model_version=model_version, round=rnd)


def _pull(cname: str):
    return _message(cname, "PullReq")


def _tiny_model(seed: int, **over):
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import init_variables

    cfg = ModelConfig(**{**TINY_MODEL, **over})
    return cfg, init_variables(torch.Generator().manual_seed(seed), cfg)


def _scaled(tree, factor: float):
    """Every float leaf of ``tree`` times ``factor`` in its own dtype."""
    from fedcrack_tpu_torch.fed.pytree import tree_map

    return tree_map(
        lambda a: a * np.asarray(factor, np.asarray(a).dtype) if np.asarray(a).dtype.kind == "f" else a, tree
    )


def _wait_for_statefile(path: str, config: FedConfig, pred, timeout_s: float = 10.0):
    """Poll the snapshot until ``pred(state)`` holds: a kill must land
    after the update it relies on is durable."""
    from fedcrack_tpu_torch.ckpt import load_state_file

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        state = load_state_file(path, config)
        if state is not None and pred(state):
            return state
        time.sleep(0.01)
    raise TimeoutError(f"statefile {path} never satisfied the predicate")


def _workdir(workdir: str | None, prefix: str):
    ctx = tempfile.TemporaryDirectory(prefix=prefix) if workdir is None else None
    return ctx, (ctx.name if ctx is not None else workdir)


def run_kill_restart_drill(rounds: int = 3, workdir: str | None = None) -> dict:
    """A 2-client round whose coordinator is killed with A's update
    received and B's still training; a fresh coordinator on the same
    statefile takes B's update and must average both exactly, then the
    remaining rounds run to FIN with a gapless history."""
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    ctx, base = _workdir(workdir, "chaos_drill_")
    try:
        cfg = FedConfig(
            max_rounds=rounds,
            cohort_size=2,
            registration_window_s=5.0,
            round_deadline_s=60.0,  # a backstop; the drill never waits it out
            port=0,
            state_path=os.path.join(base, "server_state.msgpack"),
        )
        t_session = time.perf_counter()
        server1 = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
        with ServerThread(server1) as st1:
            channel, call = _raw_caller(st1.port)
            assert call(_ready("a")).status == R.SW
            assert call(_ready("b")).status == R.SW
            assert call(_done("a", 1, 1.0, 10)).status == R.RESP_ACY
            channel.close()
            _wait_for_statefile(cfg.state_path, cfg, lambda s: "a" in s.received)
            t_kill = time.perf_counter()
            st1.kill()

        server2 = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
        resumed = server2.state
        t_restored = time.perf_counter()
        if not (
            resumed.phase == R.PHASE_RUNNING
            and resumed.current_round == 1
            and "a" in resumed.received
            and resumed.cohort == frozenset({"a", "b"})
        ):
            raise RuntimeError(
                f"restart did not resume the round: phase={resumed.phase} "
                f"round={resumed.current_round} received={sorted(resumed.received)}"
            )
        with ServerThread(server2) as st2:
            channel, call = _raw_caller(st2.port)
            rep = call(_done("b", 1, 3.0, 30))
            t_recovered = time.perf_counter()
            if rep.status != R.RESP_ARY:
                raise RuntimeError(f"recovery aggregation failed: {rep.status}")
            # A's update restored from disk: (10 * 1 + 30 * 3) / 40 = 2.5.
            got = tree_from_bytes(rep.weights)["params"]["w"]
            avg_exact = bool(np.allclose(got, 2.5, atol=1e-6))
            for rnd in range(2, rounds + 1):
                call(_done("a", rnd, 1.0, 10))
                rep = call(_done("b", rnd, 3.0, 30))
            channel.close()
            state = st2.state
        history_rounds = [h["round"] for h in state.history]
        return {
            "rounds": rounds,
            "restore_s": round(t_restored - t_kill, 4),
            "kill_to_recover_s": round(t_recovered - t_kill, 4),
            "session_s": round(time.perf_counter() - t_session, 4),
            "resumed_mid_round": True,
            "received_preserved": True,
            "recovered_avg_exact": avg_exact,
            "finished": state.phase == R.PHASE_FINISHED,
            "history_rounds": history_rounds,
            "history_gapless": history_rounds == list(range(1, len(history_rounds) + 1)),
        }
    finally:
        if ctx is not None:
            ctx.cleanup()


def run_corrupt_frame_drill() -> dict:
    """CORRUPT_COMPRESSED_FRAME: three clients upload int8 frames and one
    frame takes a bit-flip. The server must refuse it on the CRC before
    any reconstruction, record it in the round's ``rejected`` map, and
    close at 2-of-3 quorum with exactly the weighted mean of what the two
    clean frames decode to (the int8 encode is seeded)."""
    from fedcrack_tpu_torch.chaos.inject import _poison_weights
    from fedcrack_tpu_torch.chaos.plan import CORRUPT_COMPRESSED_FRAME
    from fedcrack_tpu_torch.compress import decode_update, get_codec, is_frame
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    cfg = FedConfig(
        max_rounds=1,
        cohort_size=3,
        quorum_fraction=2.0 / 3.0,
        registration_window_s=5.0,
        round_deadline_s=60.0,
        update_codec="int8",
        port=0,
    )
    server = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
    base_blob = server.state.broadcast_blob

    def frame_of(cname: str, value: float) -> bytes:
        return get_codec("int8", client_tag=cname).encode_update(
            tree_to_bytes(_vars(value)), base_blob, round=1, base_version=0
        )

    def framed(cname: str, value: float, ns: int, corrupt: bool):
        frame = frame_of(cname, value)
        assert is_frame(frame)
        if corrupt:
            frame = _poison_weights(frame, CORRUPT_COMPRESSED_FRAME)
        return _upload(cname, 1, frame, ns)

    t0 = time.perf_counter()
    with ServerThread(server) as st:
        channel, call = _raw_caller(st.port)
        for c in ("a", "b", "c"):
            assert call(_ready(c)).status == R.SW
        # The corrupt frame lands first: a rejection, not a stale resync.
        rej = call(framed("c", 9.0, 20, corrupt=True))
        rep_a = call(framed("a", 1.0, 10, corrupt=False))
        rep_b = call(framed("b", 3.0, 30, corrupt=False))
        t_quorum = time.perf_counter()
        channel.close()
        state = st.state
    got = tree_from_bytes(rep_b.weights)["params"]["w"]
    base_tree = tree_from_bytes(base_blob)
    dec = {}
    for cname, value in (("a", 1.0), ("b", 3.0)):
        tree, _ = decode_update(frame_of(cname, value), template=base_tree, base=base_tree, expected_base_version=0)
        dec[cname] = np.asarray(tree["params"]["w"], np.float32)
    want = (10 * dec["a"] + 30 * dec["b"]) / 40
    entry = state.history[0] if state.history else {}
    return {
        "corrupt_rejected": rej.status == R.REJECTED,
        "reject_reason_is_checksum": "checksum" in entry.get("rejected", {}).get("c", ""),
        "quorum_reached": rep_a.status == R.RESP_ACY and rep_b.status in (R.RESP_ARY, R.FIN),
        "clean_clients_aggregated": entry.get("clients") == ["a", "b"],
        "codecs": entry.get("codecs"),
        "wire_bytes_received": entry.get("bytes_received"),
        "decoded_bytes_received": entry.get("decoded_bytes_received"),
        "avg_matches_decoded_frames": bool(np.allclose(got, want, atol=1e-5)),
        "reject_to_quorum_s": round(t_quorum - t0, 4),
    }


def run_edge_crash_drill(workdir: str | None = None) -> dict:
    """EDGE_AGGREGATOR_CRASH: a 2-edge tree under a gRPC root, edge-0
    killed after two of its three leaves and restored from its statefile.
    It must resume the same round with both updates, take the third leaf,
    and push a partial that is exactly the weighted mean of all three; the
    root's average must be exactly the weighted mean of both partials."""
    from fedcrack_tpu_torch.chaos.plan import EDGE_AGGREGATOR_CRASH, Fault, FaultPlan
    from fedcrack_tpu_torch.fed.tree import EdgeAggregator
    from fedcrack_tpu_torch.transport.edge import EdgeRelay
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    ctx, base = _workdir(workdir, "edge_crash_drill_")
    try:
        cfg = FedConfig(
            max_rounds=1,
            cohort_size=2,  # the root's cohort is the two edges
            registration_window_s=5.0,
            round_deadline_s=60.0,
            port=0,
        )
        plan = FaultPlan([Fault(kind=EDGE_AGGREGATOR_CRASH, round=1, client="edge-0")])
        t0 = time.perf_counter()
        root = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
        template = root.state.template
        with ServerThread(root) as st:
            relay0 = EdgeRelay("edge-0", st.port)
            relay1 = EdgeRelay("edge-1", st.port)
            h0 = relay0.enroll()
            relay1.enroll()
            base_blob = relay0.pull()
            base_version = int(h0["model_version"])
            round_no = int(h0["current_round"])

            state_path = os.path.join(base, "edge-0.msgpack")
            edge0 = EdgeAggregator("edge-0", template, quorum_fraction=1.0, state_path=state_path)
            edge0.begin_round(round_no, base_blob, base_version, ["a", "b", "c"])
            assert edge0.offer("a", tree_to_bytes(_vars(1.0)), 10)[0]
            assert edge0.offer("b", tree_to_bytes(_vars(2.0)), 10)[0]
            # The kill, with leaf c still training: the durable state is
            # whatever the atomic writer had renamed.
            assert plan.take(EDGE_AGGREGATOR_CRASH, client="edge-0", round=round_no)
            t_kill = time.perf_counter()
            del edge0

            restored = EdgeAggregator.restore(state_path, template, quorum_fraction=1.0)
            t_restored = time.perf_counter()
            if restored is None or sorted(restored.received) != ["a", "b"]:
                raise RuntimeError("edge restart did not resume from its statefile")
            resumed_mid_round = restored.round == round_no and restored.base_version == base_version
            assert restored.offer("c", tree_to_bytes(_vars(6.0)), 20)[0]
            assert restored.quorum_met()
            partial0, total0 = restored.partial()
            status0, _, _ = relay0.push_partial(round_no, partial0, total0)

            edge1 = EdgeAggregator("edge-1", template, quorum_fraction=1.0)
            edge1.begin_round(round_no, base_blob, base_version, ["d"])
            assert edge1.offer("d", tree_to_bytes(_vars(8.0)), 40)[0]
            partial1, total1 = edge1.partial()
            status1, new_global, _ = relay1.push_partial(round_no, partial1, total1)
            t_recovered = time.perf_counter()
            relay0.close()
            relay1.close()
            state = st.state
        # edge-0: (10 * 1 + 10 * 2 + 20 * 6) / 40 = 3.75; the root:
        # (40 * 3.75 + 40 * 8) / 80 = 5.875.
        p0 = tree_from_bytes(partial0)["params"]["w"]
        got = tree_from_bytes(new_global)["params"]["w"]
        entry = state.history[0] if state.history else {}
        return {
            "fault_fired": [f.kind for f in plan.triggered] == [EDGE_AGGREGATOR_CRASH],
            "resumed_mid_round": bool(resumed_mid_round),
            "received_preserved": True,
            "edge_partial_exact": bool(np.allclose(p0, 3.75, atol=1e-6)),
            "root_round_closed": status0 == R.RESP_ACY and status1 in (R.RESP_ARY, R.FIN),
            "root_avg_exact": bool(np.allclose(got, 5.875, atol=1e-6)),
            "root_clients": entry.get("clients"),
            "root_cohort_size": entry.get("cohort_size"),
            "restore_s": round(t_restored - t_kill, 4),
            "kill_to_recover_s": round(t_recovered - t_kill, 4),
            "session_s": round(time.perf_counter() - t0, 4),
        }
    finally:
        if ctx is not None:
            ctx.cleanup()


def run_straggler_storm_drill(
    seed: int = 0,
    n_clients: int = 6,
    versions: int = 3,
    buffer_k: int = 2,
    staleness_alpha: float = 0.5,
) -> dict:
    """STRAGGLER_STORM: sync rounds against FedBuff under one seeded
    heavy-tail delay schedule (``FaultPlan.storm``; both arms replay the
    same per-(client, iteration) delays). The sync arm runs ``versions``
    barrier rounds, each as slow as its slowest client; the buffered arm
    then runs for the same wall clock, flushing on the ``buffer_k``
    fastest arrivals. Each arm's accepted updates and global versions are
    the deltas of a scrape of ``/metrics`` before and after, held against
    the protocol history; buffered must beat sync on both rates."""
    import threading

    from fedcrack_tpu_torch.chaos.plan import STRAGGLER_DELAY, STRAGGLER_STORM, FaultPlan
    from fedcrack_tpu_torch.fed.buffered import async_summary
    from fedcrack_tpu_torch.obs.promexp import MetricsExporter, sample_value, scrape
    from fedcrack_tpu_torch.obs.registry import REGISTRY
    from fedcrack_tpu_torch.transport.codec import decode_scalar_map
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    def fed_counters(url: str) -> dict:
        # A family is absent until its first bump: absent reads 0.
        parsed = scrape(url)
        return {
            "accepted": sample_value(parsed, "fed_updates_total", {"result": "accepted"}) or 0.0,
            "versions": sample_value(parsed, "fed_global_versions_total") or 0.0,
        }

    names = [f"c{i}" for i in range(n_clients)]
    # One schedule for both arms. The delays are read without consuming
    # them; the storm marker is consumed, so `triggered` shows it fired.
    plan = FaultPlan.storm(
        seed,
        clients=names,
        n_iterations=versions * 4,
        # Heavy enough that a round's max over the cohort dwarfs the K
        # fastest draws.
        tail_alpha=1.1,
        scale_s=0.03,
        cap_s=0.8,
    )
    assert plan.take(STRAGGLER_STORM, round=1) is not None
    delays = {(f.client, f.round): f.delay_s for f in plan.pending if f.kind == STRAGGLER_DELAY}

    def run_sync(url: str) -> dict:
        cfg = FedConfig(
            max_rounds=versions, cohort_size=n_clients, registration_window_s=5.0, round_deadline_s=60.0, port=0
        )
        server = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
        errors: list[str] = []

        def client(name: str):
            channel, call = _raw_caller(server_thread.port)
            try:
                assert call(_ready(name)).status == R.SW
                rnd, mv = 1, 0
                for it in range(1, versions + 1):
                    time.sleep(delays[(name, it)])
                    rep = call(_done(name, rnd, 1.0 + it, 10))
                    if rep.status == R.RESP_ACY:
                        # The barrier: poll until the slowest client lands.
                        while True:
                            time.sleep(0.01)
                            rep = call(_poll(name, mv, rnd))
                            if rep.status != R.WAIT:
                                break
                    if rep.status == R.FIN:
                        return
                    c = decode_scalar_map(rep.config)
                    rnd, mv = int(c["current_round"]), int(c["model_version"])
            except Exception as e:  # recorded in the artifact
                errors.append(f"{name}: {e!r}")
            finally:
                channel.close()

        pre = fed_counters(url)
        t0 = time.perf_counter()
        with ServerThread(server) as server_thread:
            threads = [threading.Thread(target=client, args=(n,)) for n in names]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            wall = time.perf_counter() - t0
            state = server_thread.state
        post = fed_counters(url)
        n_accepted = int(post["accepted"] - pre["accepted"])
        n_versions = int(post["versions"] - pre["versions"])
        return {
            "wall_s": round(wall, 4),
            "accepted_updates": n_accepted,
            "global_versions": n_versions,
            "updates_per_sec": round(n_accepted / wall, 3),
            "versions_per_min": round(n_versions / wall * 60.0, 3),
            "scrape_matches_history": (
                n_accepted == sum(len(h["clients"]) for h in state.history)
                and n_versions == int(state.model_version)
            ),
            "errors": errors,
        }

    def run_buffered(window_s: float, url: str) -> dict:
        cfg = FedConfig(
            # A horizon the window never reaches: the drill measures a
            # sustained rate over window_s.
            max_rounds=100_000,
            cohort_size=n_clients,
            mode="buffered",
            buffer_k=buffer_k,
            staleness_alpha=staleness_alpha,
            max_staleness=8,
            registration_window_s=5.0,
            round_deadline_s=60.0,
            port=0,
        )
        server = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
        errors: list[str] = []
        stop = threading.Event()
        n_sched = versions * 4

        def client(name: str):
            channel, call = _raw_caller(server_thread.port)
            try:
                assert call(_ready(name)).status == R.SW
                it = 0
                while not stop.is_set():
                    it += 1
                    rep = call(_pull(name))
                    c = decode_scalar_map(rep.config)
                    # The same schedule, cycled past the sync arm's horizon.
                    time.sleep(delays[(name, (it - 1) % n_sched + 1)])
                    if stop.is_set():
                        return
                    call(_done(name, int(c["current_round"]), 1.0 + it, 10))
            except Exception as e:
                errors.append(f"{name}: {e!r}")
            finally:
                channel.close()

        pre = fed_counters(url)
        with ServerThread(server) as server_thread:
            threads = [threading.Thread(target=client, args=(n,)) for n in names]
            for t in threads:
                t.start()
            time.sleep(window_s)
            # Measure at the window's edge, between two equal scrapes, so
            # the deltas and the history describe the same instant.
            for _ in range(200):
                post = fed_counters(url)
                state = server_thread.state
                if fed_counters(url) == post:
                    break
            stop.set()
            for t in threads:
                t.join(timeout=60)
        summary = async_summary(state.history)
        n_accepted = int(post["accepted"] - pre["accepted"])
        n_versions = int(post["versions"] - pre["versions"])
        return {
            "wall_s": round(window_s, 4),
            "accepted_updates": n_accepted,
            "global_versions": n_versions,
            "updates_per_sec": round(n_accepted / window_s, 3),
            "versions_per_min": round(n_versions / window_s * 60.0, 3),
            "scrape_matches_history": (
                n_accepted == int(summary["accepted_updates"]) + len(state.buffer)
                and n_versions == int(state.model_version)
            ),
            "staleness": summary["staleness"],
            "mean_buffer_fill": summary["mean_buffer_fill"],
            "errors": errors,
        }

    with MetricsExporter(REGISTRY) as exporter:
        sync = run_sync(exporter.url)
        buffered = run_buffered(sync["wall_s"], exporter.url)
    return {
        "rates_scraped_from_registry": True,
        "seed": seed,
        "n_clients": n_clients,
        "versions": versions,
        "buffer_k": buffer_k,
        "staleness_alpha": staleness_alpha,
        "storm_fired": [f.kind for f in plan.triggered] == [STRAGGLER_STORM],
        "sync": sync,
        "buffered": buffered,
        "buffered_gt_sync_updates_per_sec": buffered["updates_per_sec"] > sync["updates_per_sec"],
        "buffered_gt_sync_versions_per_min": buffered["versions_per_min"] > sync["versions_per_min"],
    }


def run_buffered_kill_drill(workdir: str | None = None) -> dict:
    """A 3-client FedBuff server (``buffer_k=3``) killed with two updates
    buffered and restarted on its statefile; the third update must flush
    the same next global, byte for byte, as an unkilled twin's."""
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    ctx, base = _workdir(workdir, "buffered_kill_drill_")
    try:
        def cfg_for(state_path: str) -> FedConfig:
            return FedConfig(
                max_rounds=1,
                cohort_size=3,
                mode="buffered",
                buffer_k=3,
                staleness_alpha=0.5,
                max_staleness=4,
                registration_window_s=5.0,
                round_deadline_s=60.0,
                port=0,
                state_path=state_path,
            )

        def drive(call):
            for c in ("a", "b", "c"):
                assert call(_ready(c)).status == R.SW
            for c in ("a", "b", "c"):
                call(_pull(c))

        cfg1 = cfg_for(os.path.join(base, "twin.msgpack"))
        with ServerThread(FedServer(cfg1, _vars(0.0), tick_period_s=0.02)) as st:
            channel, call = _raw_caller(st.port)
            drive(call)
            call(_done("a", 1, 1.0, 10))
            call(_done("b", 1, 3.0, 30))
            rep = call(_done("c", 1, 6.0, 20))
            channel.close()
            twin_status = rep.status
            twin_blob = bytes(rep.weights)
            twin_version = st.state.model_version

        cfg2 = cfg_for(os.path.join(base, "killed.msgpack"))
        with ServerThread(FedServer(cfg2, _vars(0.0), tick_period_s=0.02)) as st:
            channel, call = _raw_caller(st.port)
            drive(call)
            call(_done("a", 1, 1.0, 10))
            call(_done("b", 1, 3.0, 30))
            channel.close()
            # Both entries and c's pull record must be durable first.
            _wait_for_statefile(cfg2.state_path, cfg2, lambda s: len(s.buffer) == 2 and "c" in s.pulled)
            t_kill = time.perf_counter()
            st.kill()

        server3 = FedServer(cfg2, _vars(0.0), tick_period_s=0.02)
        resumed = server3.state
        t_restored = time.perf_counter()
        if not (
            len(resumed.buffer) == 2
            and sorted(e["cname"] for e in resumed.buffer) == ["a", "b"]
            and resumed.pulled.get("c") == 0
        ):
            raise RuntimeError(
                f"restart did not resume the buffer: "
                f"{[e['cname'] for e in resumed.buffer]} pulled={dict(resumed.pulled)}"
            )
        with ServerThread(server3) as st:
            channel, call = _raw_caller(st.port)
            rep = call(_done("c", 1, 6.0, 20))
            t_recovered = time.perf_counter()
            channel.close()
            killed_blob = bytes(rep.weights)
            killed_version = st.state.model_version
        return {
            "resumed_mid_buffer": True,
            "twin_flush_status": twin_status,
            "recovered_flush_status": rep.status,
            "global_version_identical": killed_version == twin_version,
            "global_blob_bit_identical": killed_blob == twin_blob,
            "restore_s": round(t_restored - t_kill, 4),
            "kill_to_recover_s": round(t_recovered - t_kill, 4),
        }
    finally:
        if ctx is not None:
            ctx.cleanup()


class _SlowBatches:
    """A batcher chaos hook that stretches every dispatch, so a backlog
    is queued on a replica when it is killed (a tiny model would drain
    its queue first and the reroute would go untested)."""

    def __init__(self, sleep_s: float):
        self.sleep_s = sleep_s

    def on_batch(self, bucket, batch_index, attempt):
        time.sleep(self.sleep_s)


def _burst(fleet, img, n: int) -> list:
    """``n`` requests submitted from four threads, as front-door traffic
    arrives; returns their futures."""
    import threading

    futures = []
    lock = threading.Lock()

    def submit_some(k):
        for _ in range(k):
            f = fleet.submit(img)
            with lock:
                futures.append(f)

    threads = [threading.Thread(target=submit_some, args=(n // 4,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futures


def run_replica_crash_drill(device=None) -> dict:
    """SERVE_REPLICA_CRASH: a 2-replica fleet under a threaded burst loses
    a replica with requests still queued on it. The router drains that
    queue to the survivor with the original futures, so every accepted
    request answers; then a fleet swap on the survivor lands untorn."""
    from fedcrack_tpu_torch.chaos.plan import SERVE_REPLICA_CRASH, Fault, FaultPlan
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet

    model_config, v0 = _tiny_model(0)
    _, v1 = _tiny_model(1)
    serve_config = ServeConfig(bucket_sizes=(16,), max_batch=4, max_delay_ms=30.0, tile_overlap=4, replicas=2)
    plan = FaultPlan([Fault(kind=SERVE_REPLICA_CRASH, round=1)])
    fleet = ServeFleet(model_config, serve_config, v0, initial_version=0, chaos=_SlowBatches(0.08), device=device)
    img = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    t_start = time.perf_counter()
    try:
        n_burst = 24
        futures = _burst(fleet, img, n_burst)
        fault = plan.take(SERVE_REPLICA_CRASH, round=1)
        assert fault is not None
        victim = 1
        t_kill = time.perf_counter()
        reroute = fleet.router.kill_replica(victim)
        answered = len([f.result(timeout=60) for f in futures])
        installed = fleet.install(1, v1)
        post = [fleet.submit(img) for _ in range(4)]
        post_versions = sorted({f.result(timeout=60).model_version for f in post})
        stats = fleet.router.stats()
        return {
            "replicas": serve_config.replicas,
            "burst": n_burst,
            "fault_fired": fault.kind,
            "victim": victim,
            "rerouted": reroute["rerouted"],
            "reroute_failed": reroute["failed"],
            "answered": answered,
            "dropped": n_burst - answered,
            "zero_dropped": answered == n_burst,
            "live_after_kill": stats["live"],
            "swap_installed": installed,
            "post_swap_versions": post_versions,
            "swap_landed_untorn": installed and post_versions == [1],
            "swap_pause_ms": (fleet.manager.last_swap or {}).get("pause_ms"),
            "kill_to_drained_s": round(time.perf_counter() - t_kill, 3),
            "drill_s": round(time.perf_counter() - t_start, 3),
        }
    finally:
        fleet.close()


def run_elastic_fleet_drill(device=None) -> dict:
    """REPLICA_CRASH_DURING_SCALE and SHADOW_REPLICA_CRASH.

    A: a 3-replica fleet under a burst; the autoscaler's scale-down
    (draining the highest replica) races a crash of another replica, and
    every accepted request must still answer with its original future.

    B: the shadow lane is killed while a candidate stages under live
    traffic. Every production request answers, nothing is shed for the
    shadow's sake, and the verdict degrades to a rollback."""
    import threading

    from fedcrack_tpu_torch.chaos.plan import REPLICA_CRASH_DURING_SCALE, SHADOW_REPLICA_CRASH, Fault, FaultPlan
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    model_config, v0 = _tiny_model(0)
    _, v1 = _tiny_model(1)
    serve_config = ServeConfig(
        bucket_sizes=(16,),
        max_batch=4,
        max_delay_ms=30.0,
        tile_overlap=4,
        replicas=3,
        min_replicas=1,
        max_replicas=3,
        scale_cooldown_s=0.0,
        scale_down_idle_evals=1,
        shadow_fraction=0.5,
        shadow_min_samples=64,
    )
    plan = FaultPlan([
        Fault(kind=REPLICA_CRASH_DURING_SCALE, round=1),
        Fault(kind=SHADOW_REPLICA_CRASH, round=0),
    ])
    fleet = ServeFleet(model_config, serve_config, v0, initial_version=0, chaos=_SlowBatches(0.05), device=device)
    auto = FleetAutoscaler(fleet)
    img = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    t_start = time.perf_counter()
    # A calm exposition: three idle replicas, so the autoscaler drains one
    # when the drill says.
    calm = {
        "serve_fleet_replicas": {"type": "gauge", "help": "", "samples": {(): 3.0}},
        "serve_rolling_p95_seconds": {"type": "gauge", "help": "", "samples": {(): 0.0}},
        "serve_router_queue_depth_total": {"type": "gauge", "help": "", "samples": {(("bucket", "16"),): 0.0}},
    }
    try:
        # ---- A: a crash racing a scale-down ----
        n_burst = 24
        futures = _burst(fleet, img, n_burst)
        fault = plan.take(REPLICA_CRASH_DURING_SCALE, round=1)
        assert fault is not None
        crash_victim = fault.round  # a replica index, as SERVE_REPLICA_CRASH's
        t_race = time.perf_counter()
        barrier = threading.Barrier(2)

        def scale_down():
            barrier.wait()
            auto.evaluate(calm)  # calm and idle_evals=1: drains replica 2

        def crash():
            barrier.wait()
            fleet.router.kill_replica(crash_victim)

        racers = [threading.Thread(target=scale_down), threading.Thread(target=crash)]
        for t in racers:
            t.start()
        for t in racers:
            t.join()
        answered = len([f.result(timeout=60) for f in futures])
        live_after = len(fleet.router.live_replicas())
        scale_actions = [a["action"] for a in auto.actions]
        race_s = round(time.perf_counter() - t_race, 3)

        # ---- B: a dying shadow lane ----
        ctrl = ShadowController(fleet)
        stop_pump = threading.Event()
        prod_results: list = []
        prod_errors: list = []

        def pump():
            while not stop_pump.is_set():
                try:
                    prod_results.append(fleet.submit(img).result(timeout=30))
                except Exception as e:  # any shed or failure breaks the claim
                    prod_errors.append(repr(e))

        pump_threads = [threading.Thread(target=pump) for _ in range(2)]
        for t in pump_threads:
            t.start()

        def kill_shadow():
            # Wait for the mirror to answer once, then kill its lane.
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                mirror = fleet.router._shadow
                if mirror is not None and mirror.completed() >= 1:
                    break
                time.sleep(0.01)
            assert plan.take(SHADOW_REPLICA_CRASH, round=0) is not None
            mirror = fleet.router._shadow
            if mirror is not None:
                mirror._batcher.close()

        killer = threading.Thread(target=kill_shadow)
        killer.start()
        verdict = ctrl.stage(1, v1, wait_s=4.0)
        killer.join(timeout=15)
        stop_pump.set()
        for t in pump_threads:
            t.join(timeout=15)
        shed = sum(fleet.router.shed_counts().values())
        return {
            "burst": n_burst,
            "fault_fired": [f.kind for f in plan.triggered],
            "crash_victim": crash_victim,
            "answered": answered,
            "dropped": n_burst - answered,
            "zero_dropped": answered == n_burst,
            "live_after_race": live_after,
            "scale_actions": scale_actions,
            "shadow_verdict": verdict["verdict"],
            "shadow_reasons": verdict["reasons"],
            "shadow_completed": verdict["completed"],
            "shadow_failures": verdict["shadow_failures"],
            "production_answered_during_shadow": len(prod_results),
            "production_errors_during_shadow": prod_errors,
            "production_unperturbed": not prod_errors,
            "shed_total": shed,
            "rollback_not_promote": verdict["verdict"] == "rollback",
            "race_s": race_s,
            "drill_s": round(time.perf_counter() - t_start, 3),
        }
    finally:
        fleet.close()


def run_stream_reset_drill(device=None) -> dict:
    """SERVE_STREAM_RESET: a video session on a tiny engine loses its tile
    cache before frame 4 of 8. The reset frame must be a full re-run,
    every frame byte-equal to stateless ``predict_tiled`` on the same
    weights, and every frame answered."""
    from fedcrack_tpu_torch.chaos.inject import StreamChaos
    from fedcrack_tpu_torch.chaos.plan import SERVE_STREAM_RESET, Fault, FaultPlan
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager
    from fedcrack_tpu_torch.tools.load_gen import make_frame_sequence

    model_config, v0 = _tiny_model(0, img_size=32)
    serve_config = ServeConfig(bucket_sizes=(16, 32), max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    engine = InferenceEngine(model_config, serve_config, device=device)
    variables = engine.prepare(v0)

    class _Static:
        def snapshot(self):
            return 0, variables

    n_frames, reset_at = 8, 4
    plan = FaultPlan([Fault(kind=SERVE_STREAM_RESET, round=reset_at)])
    manager = StreamSessionManager(
        engine, _Static(), chaos=StreamChaos(plan, manager=None), registry=MetricsRegistry()
    )
    manager.chaos.manager = manager
    frames = make_frame_sequence(n_frames, 64, 0.1, seed=7)
    session = manager.open("drill", height=64, width=64)
    t_start = time.perf_counter()
    wrong_bytes = answered = 0
    reset_frame = None
    per_frame = []
    for fi, frame in enumerate(frames):
        result = session.process_frame(frame)
        manager.record(result)
        answered += 1
        identical = result.probs.tobytes() == engine.predict_tiled(variables, frame).tobytes()
        if not identical:
            wrong_bytes += 1
        if fi == reset_at:
            reset_frame = {
                "frame": fi,
                "full_rerun": result.full_rerun,
                "tiles_computed": result.tiles_computed,
                "tiles_total": result.tiles_total,
                "cache_hits": result.cache_hits,
            }
        per_frame.append(
            {"frame": fi, "hits": result.cache_hits, "computed": result.tiles_computed, "identical": identical}
        )
    manager.close("drill")
    fired = [f.kind for f in plan.triggered]
    stats = manager.stats()
    return {
        "frames": n_frames,
        "reset_at": reset_at,
        "fault_fired": SERVE_STREAM_RESET in fired,
        "resets_recorded": session.totals["resets"],
        "answered": answered,
        "dropped": n_frames - answered,
        "zero_dropped": answered == n_frames,
        "wrong_bytes": wrong_bytes,
        "zero_wrong_bytes": wrong_bytes == 0,
        "reset_frame": reset_frame,
        "reset_was_full_rerun": bool(
            reset_frame and reset_frame["full_rerun"] and reset_frame["tiles_computed"] == reset_frame["tiles_total"]
        ),
        "per_frame": per_frame,
        "hit_ratio": stats["hit_ratio"],
        "effective_speedup": stats["effective_speedup"],
        "drill_s": round(time.perf_counter() - t_start, 3),
    }


def _canary_stack(device):
    """The tiny serving stack both scaled-update drills share: an engine
    on ``device``, a canary on a private registry, and a version manager
    booted on the seeded weights with the canary's reference taken."""
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    model_config, v0 = _tiny_model(0)
    serve_config = ServeConfig(bucket_sizes=(16,), max_batch=4, max_delay_ms=30.0, tile_overlap=4)
    reg = MetricsRegistry()
    engine = InferenceEngine(model_config, serve_config, device=device)
    canary = CanaryEvaluator(engine, registry=reg)
    manager = ModelVersionManager(engine, v0, initial_version=0, canary=canary)
    engine.warmup(manager.snapshot()[1])
    ref = canary.evaluate(0, manager.snapshot()[1])
    return v0, reg, canary, manager, ref


def run_scaled_update_drill(device=None) -> dict:
    """SCALED_UPDATE (Blanchard et al.'s threat model): a client's update
    amplified by ``SCALE_FACTOR``, finite and shape-correct.

    1. Ledger: in a 3-client gRPC round the server accepts it and FedAvg
       drags the global, but the flush's robust z-score flags the client
       past ``ANOMALY_ALERT`` while the honest clients stay below.
    2. Canary and watchdog: a tiny serving stack swaps in the seeded
       weights dragged by the same factor; the canary's IoU cliffs, the
       rules of ``configs/slo_health.json`` breach on both signals (the
       canary floor and the exported anomaly ceiling), the flight ring
       dumps, and the artifact records the ``BREACH_EXIT`` contract.

    The eager port has no recompile sentry, so ``recompiles_since_warmup``
    reads -1, as the JAX drill reports where the sentry is unsupported."""
    from fedcrack_tpu_torch.chaos import inject
    from fedcrack_tpu_torch.chaos.inject import _poison_weights
    from fedcrack_tpu_torch.chaos.plan import SCALED_UPDATE, Fault, FaultPlan
    from fedcrack_tpu_torch.health import ledger as health_ledger
    from fedcrack_tpu_torch.obs import flight
    from fedcrack_tpu_torch.obs.watchdog import BREACH_EXIT, Watchdog, load_rules
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    # ---- 1: the gate accepts, the ledger flags ----
    plan = FaultPlan([Fault(kind=SCALED_UPDATE, round=1, client="c")])
    cfg = FedConfig(max_rounds=1, cohort_size=3, registration_window_s=5.0, round_deadline_s=60.0, port=0)
    server = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
    t0 = time.perf_counter()
    with ServerThread(server) as st:
        channel, call = _raw_caller(st.port)
        for c in ("a", "b", "c"):
            assert call(_ready(c)).status == R.SW
        # The poisoned upload lands first, so its RESP_ACY cannot be a
        # round-closing reply.
        fault = plan.take(SCALED_UPDATE, client="c", round=1)
        assert fault is not None
        rep_c = call(_upload("c", 1, _poison_weights(tree_to_bytes(_vars(1.1)), SCALED_UPDATE), 10))
        rep_a = call(_done("a", 1, 1.0, 10))
        rep_b = call(_done("b", 1, 1.2, 10))
        channel.close()
        state = st.state
    entry = state.history[0] if state.history else {}
    # Equal sample counts: the plain mean (1.0 + 1.2 + 1.1 * SCALE) / 3.
    got_avg = float(np.mean(tree_from_bytes(rep_b.weights)["params"]["w"]))
    drag = (1.0 + 1.2 + 1.1 * inject.SCALE_FACTOR) / 3.0
    scores = {name: state.ledger.get(name, {}).get("anomaly", 0.0) for name in ("a", "b", "c")}
    ledger_part = {
        "fault_fired": fault.kind,
        "poisoned_accepted": rep_c.status == R.RESP_ACY,
        "honest_accepted": rep_a.status == R.RESP_ACY and rep_b.status in (R.RESP_ARY, R.FIN),
        "poisoned_in_history_clients": entry.get("clients") == ["a", "b", "c"],
        "nothing_rejected": entry.get("rejected", {}) == {},
        "global_dragged_avg": round(got_avg, 4),
        "global_drag_matches_fedavg": bool(np.isclose(got_avg, drag, rtol=1e-5)),
        "anomaly_scores": {k: round(v, 3) for k, v in scores.items()},
        "alert_threshold": health_ledger.ANOMALY_ALERT,
        "poisoned_flagged": scores["c"] >= health_ledger.ANOMALY_ALERT,
        "honest_below_alert": max(scores["a"], scores["b"]) < health_ledger.ANOMALY_ALERT,
        "flagged_flushes": state.ledger.get("c", {}).get("flags", 0),
        "round_s": round(time.perf_counter() - t0, 4),
    }

    # ---- 2: the dragged global cliffs the canary; the watchdog fires ----
    v0, reg, canary, manager, ref = _canary_stack(device)
    # The serving view of 1's FedAvg: every float leaf dragged by the mean
    # of (1, 1, SCALE_FACTOR).
    installed = manager.install(1, _scaled(v0, (1.0 + 1.0 + inject.SCALE_FACTOR) / 3.0))
    assert installed and canary.last is not None
    post = canary.last

    # Both signals in one registry: 1's anomaly gauges and the canary IoU.
    health_ledger.export_anomaly_metrics(state.ledger, registry=reg)
    rules_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir, "configs", "slo_health.json"
    )
    ring = flight.current()
    installed_ring = False
    if ring is None:  # called directly; main() installs its own
        ring = flight.install(
            path=os.path.join(tempfile.gettempdir(), "scaled_update_drill.flight.json"), hooks=False
        )
        installed_ring = True
    try:
        dumps_before = len(ring.dumps)
        watchdog = Watchdog(load_rules(rules_path), registry=reg)
        report = watchdog.enforce()
        audit = watchdog.audit()
        dumped = ring.dumps[dumps_before:]
    finally:
        if installed_ring:
            flight.uninstall()
    breached_rules = sorted({b["rule"] for b in report["breaches"]})
    return {
        "ledger": ledger_part,
        "canary": {
            "reference_iou": ref["iou"],
            "poisoned_iou": post["iou"],
            "iou_cliff": post["iou"] < 0.5 <= ref["iou"],
            "swap_still_installed": installed,
            "recompiles_since_warmup": -1,
        },
        "watchdog": {
            "rules": audit["rules"],
            "breached": breached_rules,
            "both_signals_breached": breached_rules == ["canary_iou_floor", "client_anomaly_ceiling"],
            "flight_dumped": bool(dumped),
            "flight_dump_reason": dumped[0]["reason"] if dumped else None,
            "breach_exit_code": BREACH_EXIT,
            "would_exit": BREACH_EXIT if audit["breaches"] else 0,
        },
    }


def run_robust_aggregation_drill(device=None) -> dict:
    """The SCALED_UPDATE round as four gRPC arms that differ only in
    ``FedConfig.aggregation`` / ``quarantine_z``: ``fedavg`` (dragged),
    ``trimmed_mean`` (beta 0.34 trims the amplified tail), ``krum`` (f=1
    selects an honest update) and ``fedavg_quarantine`` (z 3.5 excludes
    the poisoned closer and resyncs it with NOT_WAIT and the clean
    global). Each arm's combine, applied to an honest/honest/x
    ``SCALE_FACTOR`` cohort, scales the seeded weights of one tiny
    serving stack: FedAvg cliffs the canary, every robust arm holds it.
    Then a colluding minority (5 honest, 2 identical amplified) across
    fedavg, trimmed_mean, krum, multi_krum and quarantine, whose
    quarantine ledger goes through ``tools.health_report``."""
    from fedcrack_tpu_torch.chaos import inject
    from fedcrack_tpu_torch.chaos.inject import _poison_weights
    from fedcrack_tpu_torch.chaos.plan import SCALED_UPDATE, Fault, FaultPlan
    from fedcrack_tpu_torch.fed import aggregation as A
    from fedcrack_tpu_torch.health import ledger as health_ledger
    from fedcrack_tpu_torch.tools.health_report import build_report, validate_report
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    t0 = time.perf_counter()

    def run_arm(clients, poisoned_names, order, **agg_kwargs):
        """One gRPC round: ``clients`` is {name: (value, ns)}, uploads land
        in ``order`` (the last closes the barrier), and each poisoned name
        ships its update amplified through a consumed plan fault."""
        plan = FaultPlan([Fault(kind=SCALED_UPDATE, round=1, client=n) for n in sorted(poisoned_names)])
        cfg = FedConfig(
            max_rounds=1,
            cohort_size=len(clients),
            registration_window_s=5.0,
            round_deadline_s=60.0,
            port=0,
            **agg_kwargs,
        )
        replies = {}
        with ServerThread(FedServer(cfg, _vars(0.0), tick_period_s=0.02)) as st:
            channel, call = _raw_caller(st.port)
            for c in order:
                assert call(_ready(c)).status == R.SW
            for c in order:
                value, ns = clients[c]
                if c in poisoned_names:
                    assert plan.take(SCALED_UPDATE, client=c, round=1) is not None
                    msg = _upload(c, 1, _poison_weights(tree_to_bytes(_vars(value)), SCALED_UPDATE), ns)
                else:
                    msg = _done(c, 1, value, ns)
                replies[c] = call(msg)
            channel.close()
            state = st.state
        closer = replies[order[-1]]
        # A quarantined closer gets NOT_WAIT without the aggregate: read
        # the broadcast then.
        blob = closer.weights if closer.weights else state.broadcast_blob
        return {
            "state": state,
            "entry": state.history[0] if state.history else {},
            "replies": replies,
            "global_avg": float(np.mean(tree_from_bytes(blob)["params"]["w"])),
        }

    # ---- 1: four arms, 3 clients, 1 poisoned ----
    clients3 = {"a": (1.0, 10), "b": (1.2, 10), "c": (1.1, 10)}
    honest_mean = (1.0 * 10 + 1.2 * 10) / 20.0
    arm_specs = {
        # The poisoned client first in the combine arms; last in the
        # quarantine arm, so its NOT_WAIT resync crosses the wire.
        "fedavg": dict(order=("c", "a", "b")),
        "trimmed_mean": dict(order=("c", "a", "b"), aggregation="trimmed_mean", trim_fraction=0.34),
        "krum": dict(order=("c", "a", "b"), aggregation="krum", byzantine_f=1),
        "fedavg_quarantine": dict(order=("a", "b", "c"), quarantine_z=3.5),
    }
    arms = {}
    raw = {}
    for name, spec in arm_specs.items():
        spec = dict(spec)
        order = spec.pop("order")
        r = run_arm(clients3, {"c"}, order, **spec)
        raw[name] = r
        arms[name] = {
            "aggregation": spec.get("aggregation", "fedavg"),
            "quarantine_z": spec.get("quarantine_z", 0.0),
            "global_avg": round(r["global_avg"], 4),
            "drag": round(abs(r["global_avg"] - honest_mean), 4),
            "quarantined": {k: round(v, 3) for k, v in r["entry"].get("quarantined", {}).items()},
        }
    fedavg_drag = abs(raw["fedavg"]["global_avg"] - honest_mean)
    for name in ("trimmed_mean", "krum", "fedavg_quarantine"):
        d = abs(raw[name]["global_avg"] - honest_mean)
        arms[name]["drag_reduction_vs_fedavg"] = round(fedavg_drag / max(d, 1e-9), 1)
    q = raw["fedavg_quarantine"]
    arms["fedavg_quarantine"].update({
        "poisoned_reply": q["replies"]["c"].status,
        "poisoned_resynced_not_wait": q["replies"]["c"].status == R.NOT_WAIT,
        "clean_global_attached": bool(q["replies"]["c"].weights),
        "ledger_quarantined_count": q["state"].ledger.get("c", {}).get("quarantined", 0),
        "honest_not_quarantined": all(
            q["state"].ledger.get(n, {}).get("quarantined", 0) == 0 for n in ("a", "b")
        ),
    })

    # ---- 2: each arm's serving factor through one tiny serve stack ----
    def arm_factor(algebra):
        triples = [
            ("a", 10, {"w": np.float32([1.0])}),
            ("b", 10, {"w": np.float32([1.0])}),
            ("c", 10, {"w": np.float32([1.0 * inject.SCALE_FACTOR])}),
        ]
        return float(A.fold(algebra, triples)["w"][0])

    factors = {
        "fedavg": arm_factor(A.FedAvg()),
        "trimmed_mean": arm_factor(A.TrimmedMean(0.34)),
        "krum": arm_factor(A.Krum(1)),
        # Quarantine excludes c before the fold: the honest mean, 1.0.
        "fedavg_quarantine": 1.0,
    }
    v0, _reg, canary, manager, ref = _canary_stack(device)
    for version, name in enumerate(arms, start=1):
        installed = manager.install(version, _scaled(v0, factors[name]))
        assert installed and canary.last is not None
        arms[name]["canary_iou"] = round(float(canary.last["iou"]), 6)
        arms[name]["serve_factor"] = round(factors[name], 4)

    # ---- 3: a colluding minority (7 clients, 2 identical colluders) ----
    honest7 = {"h1": (1.0, 10), "h2": (1.05, 10), "h3": (1.1, 10), "h4": (1.15, 10), "h5": (1.2, 10)}
    clients7 = dict(honest7, p1=(1.1, 10), p2=(1.1, 10))
    order7 = ("p1", "p2", "h1", "h2", "h3", "h4", "h5")
    honest_mean7 = sum(v for v, _ in honest7.values()) / len(honest7)
    colluding_specs = {
        "fedavg": {},
        # floor(0.3 * 7) = 2 trimmed per coordinate end: both colluders.
        "trimmed_mean": dict(aggregation="trimmed_mean", trim_fraction=0.3),
        "krum": dict(aggregation="krum", byzantine_f=2),
        "multi_krum": dict(aggregation="multi_krum", byzantine_f=2),
        "fedavg_quarantine": dict(quarantine_z=3.5),
    }
    colluding = {}
    q7_state = None
    for name, spec in colluding_specs.items():
        r = run_arm(clients7, {"p1", "p2"}, order7, **spec)
        colluding[name] = {
            "global_avg": round(r["global_avg"], 4),
            "drag": round(abs(r["global_avg"] - honest_mean7), 4),
            "quarantined": sorted(r["entry"].get("quarantined", {})),
        }
        if name == "fedavg_quarantine":
            q7_state = r["state"]
    colluders_beaten = {name: bool(colluding[name]["drag"] <= 0.25) for name in colluding if name != "fedavg"}

    # ---- 4: the exclusion shows in the health report ----
    with tempfile.TemporaryDirectory() as tmp:
        ledger_path = os.path.join(tmp, "ledger.jsonl")
        health_ledger.write_ledger_jsonl(q7_state.ledger, ledger_path)
        report = build_report(ledger_path)
        violations = validate_report(report)
    robust_arm_names = ("trimmed_mean", "krum", "fedavg_quarantine")
    return {
        "scale_factor": inject.SCALE_FACTOR,
        "honest_mean": honest_mean,
        "reference_iou": round(float(ref["iou"]), 6),
        "arms": arms,
        "fedavg_cliffed": arms["fedavg"]["canary_iou"] < 0.5,
        "robust_arms_hold": all(arms[n]["canary_iou"] >= 0.9 for n in robust_arm_names),
        "drag_reduced_10x": all(arms[n]["drag_reduction_vs_fedavg"] >= 10.0 for n in robust_arm_names),
        "colluding": {
            "n_clients": len(clients7),
            "colluders": ["p1", "p2"],
            "honest_mean": honest_mean7,
            "fedavg_drag": colluding["fedavg"]["drag"],
            "arms": colluding,
            "colluders_beaten": colluders_beaten,
        },
        "health_report": {
            "schema_violations": violations,
            "quarantines": report["summary"]["quarantines"],
            "quarantined_clients": report["summary"]["quarantined_clients"],
            "exclusion_visible": report["summary"]["quarantined_clients"] == ["p1", "p2"],
        },
        "drill_s": round(time.perf_counter() - t0, 4),
    }


def run_secagg_dropout_drill() -> dict:
    """SECAGG_DROPOUT: three ``FedClient`` sessions under secure
    aggregation, and ``c`` dies after its seed froze into the masking
    roster and before its own upload. The round must close at quorum by
    seed recovery, and the unmasked average must equal the survivors'
    weighted fixed-point mean bit for bit."""
    import threading

    from fedcrack_tpu_torch.chaos.inject import ClientChaos, InjectedCrash
    from fedcrack_tpu_torch.chaos.plan import SECAGG_DROPOUT, Fault, FaultPlan
    from fedcrack_tpu_torch.privacy.secagg import fixed_point_decode, weighted_fixed_sum
    from fedcrack_tpu_torch.transport.client import FedClient
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    def fake_train(inc: float, ns: int):
        def train_fn(blob: bytes, rnd: int):
            tree = tree_from_bytes(blob)
            tree["params"]["w"] = tree["params"]["w"] + np.float32(inc)
            return tree_to_bytes(tree), ns, {"loss": float(rnd)}

        return train_fn

    cfg = FedConfig(
        max_rounds=1,
        cohort_size=3,
        registration_window_s=5.0,
        round_deadline_s=2.0,
        quorum_fraction=0.67,
        poll_period_s=0.05,
        secagg=True,
        port=0,
    )
    plan = FaultPlan([Fault(kind=SECAGG_DROPOUT, round=1, client="c")])
    server = FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    t0 = time.perf_counter()
    errors: dict[str, BaseException] = {}
    results: dict[str, object] = {}

    def run(client, name: str) -> None:
        try:
            results[name] = client.run_session()
        except InjectedCrash as e:
            errors[name] = e

    with ServerThread(server) as st:
        clients = {
            "a": FedClient(cfg, fake_train(1.0, 10), cname="a", port=st.port),
            "b": FedClient(cfg, fake_train(3.0, 30), cname="b", port=st.port),
            "c": FedClient(cfg, fake_train(5.0, 20), cname="c", port=st.port, chaos=ClientChaos(plan)),
        }
        threads = [threading.Thread(target=run, args=(cl, n)) for n, cl in clients.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        state = st.state

    entry = state.history[0] if state.history else {}
    secagg_info = entry.get("secagg") or {}
    # The survivors' closed-form mean, through the same fixed-point path.
    surv_ns = [10, 30]
    want = fixed_point_decode(
        weighted_fixed_sum([_vars(1.0), _vars(3.0)], surv_ns, cfg.secagg_bits),
        sum(surv_ns),
        cfg.secagg_bits,
        _vars(0.0),
    )
    got = tree_from_bytes(state.global_blob)
    return {
        "fault_fired": [f.kind for f in plan.triggered] == [SECAGG_DROPOUT],
        "dropper_crashed": "c" in errors and "c" not in results,
        "survivors_completed": all(n in results and results[n].rounds_completed == 1 for n in ("a", "b")),
        "round_closed": state.phase == R.PHASE_FINISHED and len(state.history) == 1,
        "maskers": secagg_info.get("maskers"),
        "recovered": secagg_info.get("recovered"),
        "dropout_recovered": secagg_info.get("recovered") == ["c"],
        "exact_average_bit_for_bit": bool(np.array_equal(got["params"]["w"], want["params"]["w"])),
        "torn_rounds": int(state.failed_rounds),
        "drill_s": round(time.perf_counter() - t0, 4),
    }


def run_dp_replay_drill(device=None) -> dict:
    """A slot-plane round with DP-SGD on (clip 1.0, noise multiplier 1.1)
    is killed by an injected device failure at round 0 and retried under
    ``max_round_retries``: the retried federation must equal an unkilled
    one bit for bit. The noise's round seed is the round program's
    per-dispatch counter, which the driver restores on the replay with
    ``codec_state``; this drill is the proof that a retried DP round never
    draws its noise twice."""
    import torch

    from fedcrack_tpu_torch.chaos.inject import MeshChaos
    from fedcrack_tpu_torch.chaos.plan import MESH_DEVICE_FAIL, Fault, FaultPlan
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.parallel import build_federated_round, make_mesh, run_mesh_federation, stack_client_data

    tiny = ModelConfig(**TINY_MODEL)
    steps, batch = 2, 2
    mesh = make_mesh(1, 1, device=device)
    t0 = time.perf_counter()

    def data_fn(r: int):
        images, masks = stack_client_data([synth_crack_batch(steps * batch, img_size=16, seed=r)], steps, batch)
        return images, masks, np.ones(1, np.float32), np.full(1, float(steps * batch), np.float32)

    def build():
        return build_federated_round(mesh, tiny, learning_rate=1e-3, local_epochs=1,
                                     dp_clip_norm=1.0, dp_noise_multiplier=1.1, dp_seed=42)

    init = init_variables(torch.Generator().manual_seed(0), tiny)
    v_clean, _ = run_mesh_federation(build(), init, data_fn, 2, mesh)
    plan = FaultPlan([Fault(kind=MESH_DEVICE_FAIL, round=0)])
    v_chaos, records = run_mesh_federation(build(), init, data_fn, 2, mesh, max_round_retries=1,
                                           fault_injector=MeshChaos(plan))
    identical = all(torch.equal(a, b) for a, b in zip(tree_leaves(v_clean), tree_leaves(v_chaos)))
    return {
        "fault_fired": not plan.pending and len(plan.triggered) == 1,
        "retries_round_0": int(records[0].retries),
        "replay_bit_identical": bool(identical),
        "rounds": len(records),
        "drill_s": round(time.perf_counter() - t0, 4),
    }


def main(argv=None, *, device=None) -> int:
    """Run every drill and write the artifact to ``--out``; any drill that
    raises fails the command, with the flight recorder's ring dumped
    beside the artifact."""
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.chaos_drill", description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    from fedcrack_tpu_torch.obs import flight

    # Fault injections, transitions and spans all feed the ring, so a
    # failing drill ships its last moments beside the traceback.
    flight_path = os.path.abspath(f"{args.out}.flight.json")
    flight.install(path=flight_path)
    try:
        artifact = {
            "generated_by": "fedcrack_tpu_torch.tools.chaos_drill",
            "kill_restart": run_kill_restart_drill(rounds=args.rounds),
            "corrupt_frame": run_corrupt_frame_drill(),
            "edge_crash": run_edge_crash_drill(),
            "straggler_storm": run_straggler_storm_drill(),
            "buffered_kill": run_buffered_kill_drill(),
            "replica_crash": run_replica_crash_drill(device),
            "elastic_fleet": run_elastic_fleet_drill(device),
            "scaled_update": run_scaled_update_drill(device),
            "robust_aggregation": run_robust_aggregation_drill(device),
            "stream_reset": run_stream_reset_drill(device),
            "secagg_dropout": run_secagg_dropout_drill(),
            "dp_replay": run_dp_replay_drill(device),
        }
    except BaseException:
        flight.dump("chaos drill failed")
        print(f"drill failed; flight record at {flight_path}", file=sys.stderr)
        raise
    finally:
        flight.uninstall()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(json.dumps(artifact["kill_restart"]), flush=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
