"""FedAvg over a real loopback gRPC channel: the port's FedServer and
FedClient (transport/) held against the JAX package's on the CPU.

A session of port clients against the port server ends on the same global
bytes as the same session on the JAX package; a JAX client completes a
session against the port server and a port client against the JAX server;
the auth token, a late client, a dead client, a chunked log upload with a
corrupt chunk, codec negotiation, FedBuff sessions (peers of either
package, a deliberately stale client), a server resuming mid-buffer from
either package's statefile, the flush span's trace links and the
eval and metrics hooks work as the JAX package's do; and a session of
``make_train_fn`` clients at a few-layer width gives the globals that
driving ``fed.rounds.transition`` in process gives. Every server binds
port 0 and stops in ``finally``; every wait is bounded.
"""

import threading

import numpy as np
import pytest

from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed import serialization as tser

pytestmark = pytest.mark.torch_port

SESSION = dict(max_rounds=3, cohort_size=2, registration_window_s=5.0, poll_period_s=0.02,
               host="127.0.0.1", port=0)
JOIN_S = 60


def _vars(value: float, n: int = 4):
    return {"params": {"w": np.full((n, n), value, np.float32)}}


def _fake_train(ser, increment: float, samples: int):
    """tests/test_transport.py's constant trainer, on one package's blob."""

    def train_fn(blob: bytes, rnd: int):
        tree = ser.tree_from_bytes(blob)
        tree["params"]["w"] = tree["params"]["w"] + increment
        return ser.tree_to_bytes(tree), samples, {"loss": float(rnd)}

    return train_fn


def _packages(server_pkg):
    if server_pkg == "jax":
        from fedcrack_tpu.transport import FedServer
        from fedcrack_tpu.transport.service import ServerThread

        return FedServer, ServerThread, JaxFedConfig
    from fedcrack_tpu_torch.transport import FedServer
    from fedcrack_tpu_torch.transport.service import ServerThread

    return FedServer, ServerThread, FedConfig


def _client(pkg, cfg_kw, train, cname, port, **kw):
    if pkg == "jax":
        from fedcrack_tpu.transport import FedClient

        return FedClient(JaxFedConfig(**cfg_kw), train, cname=cname, port=port, **kw)
    from fedcrack_tpu_torch.transport import FedClient

    return FedClient(FedConfig(**cfg_kw), train, cname=cname, port=port, **kw)


def _run_clients(clients):
    """Each client's run_session in its own thread; an exception is the
    client's result."""
    results = [None] * len(clients)

    def run(i, c):
        try:
            results[i] = c.run_session()
        except Exception as e:  # the caller asserts on it
            results[i] = e

    threads = [threading.Thread(target=run, args=(i, c), daemon=True) for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a client session did not finish"
    return results


def _session(server_pkg, client_pkgs, cfg_kw=None, variables=None, trains=None, server_kw=None):
    """One federation: a server of ``server_pkg`` and one client per entry
    of ``client_pkgs`` (named a, b, ...). Returns (state, results, server)."""
    cfg_kw = {**SESSION, **(cfg_kw or {})}
    FedServer, ServerThread, Config = _packages(server_pkg)
    server = FedServer(Config(**cfg_kw), _vars(0.0) if variables is None else variables, tick_period_s=0.02,
                       **(server_kw or {}))
    st = ServerThread(server)
    with st:
        clients = []
        for i, pkg in enumerate(client_pkgs):
            ser = jser if pkg == "jax" else tser
            train = trains[i] if trains else _fake_train(ser, 1.0 + 2 * i, 10 + 20 * i)
            clients.append(_client(pkg, cfg_kw, train, "abcdefgh"[i], st.port))
        results = _run_clients(clients)
        state = st.state
    return state, results, server


def _assert_completed(state, results, rounds=3):
    for r in results:
        assert not isinstance(r, Exception), r
        assert r.enrolled and r.rounds_completed == rounds
        assert r.final_weights == state.broadcast_blob
    assert state.phase == "finished" and state.model_version == rounds


def test_port_session_ends_on_the_jax_sessions_global_bytes():
    state, results, _ = _session("torch", ["torch", "torch"])
    _assert_completed(state, results)
    want, jresults, _ = _session("jax", ["jax", "jax"])
    _assert_completed(want, jresults)
    assert state.global_blob == want.global_blob
    # (10 (w + 1) + 30 (w + 3)) / 40 = w + 2.5 each round
    np.testing.assert_array_equal(tser.tree_from_bytes(state.global_blob)["params"]["w"], np.full((4, 4), 7.5))
    strip = ("completed_at", "wall_clock_s")
    assert [{k: v for k, v in h.items() if k not in strip} for h in state.history] == \
        [{k: v for k, v in h.items() if k not in strip} for h in want.history]


@pytest.mark.parametrize("server_pkg,client_pkgs", [("torch", ["jax", "torch"]), ("jax", ["torch", "torch"])])
def test_peers_of_either_package_interoperate(server_pkg, client_pkgs):
    state, results, _ = _session(server_pkg, client_pkgs)
    _assert_completed(state, results)
    np.testing.assert_array_equal(jser.tree_from_bytes(state.global_blob)["params"]["w"], np.full((4, 4), 7.5))


def test_auth_token_gates_every_message():
    from fedcrack_tpu_torch.transport import FedServer
    from fedcrack_tpu_torch.transport.service import ServerThread

    kw = {**SESSION, "cohort_size": 1, "max_rounds": 1, "auth_token": "s3crét-käy", "allow_insecure_token": True}
    with ServerThread(FedServer(FedConfig(**kw), _vars(0.0), tick_period_s=0.02)) as st:
        bad = _client("torch", {**kw, "auth_token": "wrong"}, _fake_train(tser, 1.0, 10), "bad", st.port)
        anon = _client("jax", {**kw, "auth_token": ""}, _fake_train(jser, 1.0, 10), "anon", st.port)
        good = _client("torch", kw, _fake_train(tser, 1.0, 10), "good", st.port)
        r_bad, r_anon, r_good = _run_clients([bad, anon]) + _run_clients([good])
        assert st.state.cohort == frozenset({"good"})
    assert not r_bad.enrolled and not r_anon.enrolled
    assert r_good.enrolled and r_good.rounds_completed == 1
    with pytest.raises(ValueError, match="plaintext"):
        _client("torch", {**kw, "allow_insecure_token": False}, None, "x", 1)._connect()


def test_late_client_turned_away():
    from fedcrack_tpu_torch.transport import FedServer
    from fedcrack_tpu_torch.transport.service import ServerThread

    with ServerThread(FedServer(FedConfig(**SESSION), _vars(0.0), tick_period_s=0.02)) as st:
        early = [_client("torch", SESSION, _fake_train(tser, 1.0, 10), n, st.port) for n in "ab"]
        results = _run_clients(early)
        late = _client("jax", SESSION, _fake_train(jser, 1.0, 10), "late", st.port).run_session()
    assert all(r.enrolled for r in results)
    assert not late.enrolled and late.rounds_completed == 0


def test_dead_client_mid_round_cohort_shrinks():
    class DiesAfterRound1(Exception):
        pass

    def dying(blob, rnd):
        if rnd >= 2:
            raise DiesAfterRound1()
        return _fake_train(tser, 1.0, 10)(blob, rnd)

    state, results, _ = _session("torch", ["torch", "torch"], cfg_kw=dict(max_rounds=2, round_deadline_s=2.5),
                                 trains=[_fake_train(tser, 1.0, 10), dying])
    assert isinstance(results[1], DiesAfterRound1)
    assert not isinstance(results[0], Exception) and results[0].rounds_completed == 2
    assert state.phase == "finished" and state.cohort == frozenset({"a"})
    assert state.departed == frozenset({"b"}) and state.history[-1]["clients"] == ["a"]


def test_chunked_log_upload_and_a_corrupt_chunk(tmp_path):
    from fedcrack_tpu_torch.transport import FedServer, wire
    from fedcrack_tpu_torch.transport.service import ServerThread

    payload = np.random.default_rng(0).integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    path = tmp_path / "events.tb"
    path.write_bytes(payload)
    kw = {**SESSION, "cohort_size": 2, "max_rounds": 1, "logs_dir": str(tmp_path / "sink")}
    with ServerThread(FedServer(FedConfig(**kw), _vars(0.0), tick_period_s=0.02)) as st:
        port = _client("torch", kw, _fake_train(tser, 1.0, 10), "a", st.port)
        jax = _client("jax", kw, _fake_train(jser, 1.0, 10), "b", st.port)
        _run_clients([port, jax])
        port.upload_file(str(path), chunk_bytes=3000)
        jax.upload_file(str(path), title="from_jax", chunk_bytes=4096)
        channel, method = port._connect()
        try:
            bad = wire.LogChunk(title="bad", data=b"abc", crc32c=1, last=True)
            rep = port._call(method, port._msg(bad))
        finally:
            channel.close()
    assert (tmp_path / "sink" / "a" / "events.tb").read_bytes() == payload
    assert (tmp_path / "sink" / "b" / "from_jax").read_bytes() == payload
    assert rep.status == TR.REJECTED and "log chunk checksum mismatch" in rep.title
    assert not (tmp_path / "sink" / "a" / "bad").exists()


@pytest.mark.parametrize("codec", ["int8", "topk_delta"])
def test_codec_negotiation_shrinks_uploads(codec):
    """The server advertises the codec; port and JAX clients upload frames
    that decode to a full tree; the history counts the frames' wire bytes,
    and the port's globals equal the JAX server's on the same session."""
    cfg = dict(update_codec=codec, topk_fraction=0.05, max_rounds=2)
    variables = _vars(0.0, n=64)
    globals_ = {}
    for server_pkg in ("torch", "jax"):
        state, results, _ = _session(server_pkg, ["torch", "jax"], cfg_kw=cfg, variables=variables)
        _assert_completed(state, results, rounds=2)
        dense = len(jser.tree_to_bytes(variables))
        for r in results:
            assert all(h["upload_bytes"] < dense / 4 for h in r.history)
        for h in state.history:
            assert h["codecs"] == {"a": codec, "b": codec}
            assert h["bytes_received"] < h["decoded_bytes_received"] / 4
        globals_[server_pkg] = state.global_blob
    assert globals_["torch"] == globals_["jax"]


def test_flush_span_links_the_uploads_trace_contexts(tmp_path):
    from fedcrack_tpu_torch.obs import spans

    path = tmp_path / "spans.jsonl"
    spans.install(str(path))
    try:
        state, results, _ = _session("torch", ["torch", "torch"], cfg_kw=dict(max_rounds=2))
    finally:
        spans.uninstall()
    _assert_completed(state, results, rounds=2)
    flushes = spans.read_spans(str(path), name="fed.flush")
    assert [f["version"] for f in flushes] == [1, 2]
    assert flushes[0]["ctx"] == "fedtr-v0#flush:v1"
    assert flushes[0]["links"] == ["fedtr-v0#push:a:r1", "fedtr-v0#push:b:r1"]
    assert flushes[1]["links"] == ["fedtr-v1#push:a:r2", "fedtr-v1#push:b:r2"]
    assert {s["name"] for s in spans.read_spans(str(path))} >= {"client.enroll", "client.pull", "client.train",
                                                                 "client.push", "fed.flush"}


def test_eval_best_model_and_metrics_hooks(tmp_path):
    from fedcrack_tpu.transport.service import _load_best as jax_load_best

    class Metrics:
        def __init__(self):
            self.records = []

        def log(self, kind, **fields):
            self.records.append((kind, fields))

    losses = {1: 0.5, 2: 0.7, 3: 0.2}

    def eval_fn(blob):
        w = float(tser.tree_from_bytes(blob)["params"]["w"][0, 0])
        return {"loss": losses[round(w / 2.5)], "w": w}

    metrics = Metrics()
    best = str(tmp_path / "best.msgpack")
    state, results, server = _session("torch", ["torch", "torch"], cfg_kw=dict(best_path=best),
                                      server_kw=dict(eval_fn=eval_fn, metrics=metrics))
    _assert_completed(state, results)
    assert [(e["round"], e["loss"]) for e in server.eval_history] == [(1, 0.5), (2, 0.7), (3, 0.2)]
    assert server.best_eval["round"] == 3
    assert open(best, "rb").read() == state.global_blob
    assert jax_load_best(best)["loss"] == 0.2  # the JAX package reads the port's best pair
    rounds = [f for kind, f in metrics.records if kind == "round"]
    assert [r["round"] for r in rounds] == [1, 2, 3]
    assert all(r["bytes_per_round"] == r["bytes_received"] for r in rounds)
    assert sorted(r["round"] for kind, r in metrics.records if kind == "server_eval") == [1, 2, 3]


def test_startup_frame_budget_refuses_a_cap_that_cannot_carry_the_model():
    from fedcrack_tpu.transport import FedServer as JaxFedServer
    from fedcrack_tpu_torch.transport import FedServer

    big = _vars(0.0, n=600)  # 1.44 MB dense
    for codec in ("null", "int8"):
        kw = dict(max_message_mb=1, update_codec=codec)
        with pytest.raises(ValueError) as want:
            JaxFedServer(JaxFedConfig(**kw), big)
        with pytest.raises(ValueError) as got:
            FedServer(FedConfig(**kw), big)
        assert str(got.value) == str(want.value)
    FedServer(FedConfig(max_message_mb=2), big)


def test_unported_paths_raise_not_implemented_naming_their_roadmap_item(tmp_path):
    from fedcrack_tpu_torch.transport import FedClient, FedServer

    with pytest.raises(NotImplementedError, match="ckpt/manager.py, ROADMAP Queue 1 item 5$"):
        FedServer(FedConfig(), _vars(0.0), checkpointer=object())
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5$"):
        FedClient(FedConfig(), _fake_train(tser, 1.0, 1), chaos=object())


BUFFERED = dict(max_rounds=3, cohort_size=2, mode="buffered", buffer_k=2, staleness_alpha=0.5, max_staleness=4)


@pytest.mark.parametrize("codec", ["null", "int8"])
@pytest.mark.parametrize("server_pkg,client_pkgs", [("torch", ["torch", "torch"]), ("torch", ["jax", "torch"]),
                                                    ("jax", ["torch", "torch"])])
def test_buffered_sessions_between_peers_of_either_package(server_pkg, client_pkgs, codec):
    """tests/test_buffered.py's two-client FedBuff session over a real
    socket, raw uploads or int8 frames: both clients run the continuous
    pull -> train -> push loop until FIN, the server flushes three
    versions, and every flush entry carries the async fields."""
    from fedcrack_tpu.fed.buffered import async_summary as jax_summary
    from fedcrack_tpu_torch.fed.buffered import async_summary
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    before = REGISTRY.values()
    state, results, _ = _session(server_pkg, client_pkgs, cfg_kw={**BUFFERED, "update_codec": codec})
    for r in results:
        assert not isinstance(r, Exception), r
        assert r.enrolled and r.final_weights and r.rounds_completed >= 1
        assert all(h["status"] in ("RESP_ACY", "RESP_ARY", "FIN", "NOT_WAIT") for h in r.history)
    assert (state.phase, state.model_version, len(state.history)) == ("finished", 3, 3)
    for entry in state.history:
        assert entry["mode"] == "buffered" and entry["buffer_fill"] == 2
        assert "staleness" in entry and "updates_per_sec" in entry and entry["codecs"] == [codec, codec]
    assert async_summary(state.history) == jax_summary(state.history)
    assert async_summary(state.history)["accepted_updates"] == 6
    if server_pkg == "torch":
        after = REGISTRY.values()
        grew = after["fed_update_staleness_versions"][()] - before.get("fed_update_staleness_versions", {}).get((), 0)
        assert grew == 6 and after["fed_buffer_fill_total"][()] == 0.0


def _raw_caller(port, cname):
    """One port client's channel and a call of a single message on it."""
    from fedcrack_tpu_torch.transport import FedClient

    client = FedClient(FedConfig(**SESSION), _fake_train(tser, 0.0, 0), cname=cname, port=port)
    channel, method = client._connect()
    return channel, lambda body: client._call(method, client._msg(body))


def _done(rnd, value, ns):
    from fedcrack_tpu_torch.transport import wire

    return wire.TrainDone(round=rnd, weights=tser.tree_to_bytes(_vars(value)), sample_count=ns)


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_buffered_deliberately_stale_client(server_pkg):
    """a advances the global alone (K=1) while b sits on the v0 broadcast;
    b's late push is accepted with staleness 1 and weight 0.5."""
    from fedcrack_tpu_torch.transport import wire

    FedServer, ServerThread, Config = _packages(server_pkg)
    cfg = {**SESSION, **BUFFERED, "buffer_k": 1, "staleness_alpha": 1.0, "max_rounds": 4}
    with ServerThread(FedServer(Config(**cfg), _vars(0.0), tick_period_s=0.02)) as st:
        channels, calls = zip(*(_raw_caller(st.port, c) for c in "ab"))
        for call in calls:
            assert call(wire.ReadyReq(config={"current_round": 0})).status == TR.SW
        for call in calls:
            assert call(wire.PullReq()).status == "OK"
        assert calls[0](_done(1, 2.0, 10)).status == TR.RESP_ARY  # v1
        assert calls[1](_done(1, 4.0, 10)).status == TR.RESP_ARY  # trained on v0
        for channel in channels:
            channel.close()
        state = st.state
    assert (state.history[-1]["staleness"], state.history[-1]["weights"]) == ([1], [0.5])
    np.testing.assert_array_equal(jser.tree_from_bytes(state.global_blob)["params"]["w"], np.full((4, 4), 3.0))


def _wait_for(predicate, what, timeout_s=30.0):
    import time

    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_server_stop_writes_the_pending_snapshot(tmp_path):
    """The snapshot of the last event before a ``ServerThread`` stops is
    on disk after the stop, with no wait in between."""
    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.transport import wire

    path = str(tmp_path / "state.msgpack")
    cfg = FedConfig(**{**SESSION, **BUFFERED, "state_path": path})
    FedServer, ServerThread, _ = _packages("torch")
    server = FedServer(cfg, _vars(0.0), tick_period_s=0.02)
    with ServerThread(server) as st:
        channel, call = _raw_caller(st.port, "a")
        call(wire.ReadyReq(config={"current_round": 0}))
        call(wire.PullReq())
        assert call(_done(1, 1.0, 10)).status == TR.RESP_ACY
        channel.close()
    state = load_state_file(path, cfg)
    assert [(e["cname"], e["seq"]) for e in state.buffer] == [("a", 0)] and state.pulled == {"a": 0}
    assert server.snapshots[-1]["buffered"] == 1 and server.snapshots[-1]["bytes"] == len(open(path, "rb").read())


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_server_resumes_mid_buffer_from_either_packages_statefile(tmp_path, writer, reader):
    """A buffered server is stopped with one update in its buffer, after
    its snapshot is on disk; a server of the other package boots from the
    same state_path with the buffer intact and flushes the global an
    uninterrupted in-process run of the same uploads flushes, byte for
    byte."""
    from fedcrack_tpu.ckpt import load_state_file as jax_load
    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.transport import wire

    path = str(tmp_path / "state.msgpack")
    cfg = dict(SESSION, **BUFFERED, state_path=path)

    def serve(pkg):
        FedServer, ServerThread, Config = _packages(pkg)
        return ServerThread(FedServer(Config(**cfg), _vars(0.0), tick_period_s=0.02)), Config

    st, config = serve(writer)
    with st:
        channels, calls = zip(*(_raw_caller(st.port, c) for c in "ab"))
        for call in calls:
            call(wire.ReadyReq(config={"current_round": 0}))
            call(wire.PullReq())
        assert calls[0](_done(1, 1.0, 10)).status == TR.RESP_ACY
        _wait_for(lambda: (s := load_state_file(path, FedConfig(**cfg))) is not None and len(s.buffer) == 1,
                  "the mid-buffer snapshot")
        for channel in channels:
            channel.close()
    load = load_state_file if reader == "torch" else jax_load
    assert len(load(path, _packages(reader)[2](**cfg)).buffer) == 1
    st, config = serve(reader)
    with st:
        assert len(st.state.buffer) == 1 and st.state.pulled == {"a": 0, "b": 0}
        channel, call = _raw_caller(st.port, "b")
        assert call(_done(1, 3.0, 30)).status == TR.RESP_ARY
        channel.close()
        resumed = st.state
    replay = TR.initial_state(FedConfig(**cfg), _vars(0.0))
    for event in (TR.Ready("a", now=0.0), TR.Ready("b", now=0.0), TR.PullWeights("a", now=0.0),
                  TR.PullWeights("b", now=0.0),
                  TR.TrainDone("a", round=1, blob=tser.tree_to_bytes(_vars(1.0)), num_samples=10, now=1.0),
                  TR.TrainDone("b", round=1, blob=tser.tree_to_bytes(_vars(3.0)), num_samples=30, now=2.0)):
        replay, _ = TR.transition(replay, event)
    assert resumed.model_version == replay.model_version == 1
    assert resumed.global_blob == replay.global_blob


def test_make_train_fn_session_matches_in_process_transition():
    """Two ``make_train_fn(device="cpu")`` clients at a few-layer width
    over gRPC: each round's global is byte-equal to driving
    ``fed.rounds.transition`` in process with a second set of the same
    clients (chip_smoke.drive_federation, phase 7's loop)."""
    import torch

    import chip_smoke
    from fedcrack_tpu_torch.configs import DataConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.train.federated import make_train_fn
    from torch_port_helpers import TINY_KW

    imgs, msks = synth_crack_batch(8, 32, seed=3)
    shards = {"a": slice(0, 4), "b": slice(4, 8)}
    cfg = FedConfig(model=ModelConfig(**TINY_KW), data=DataConfig(img_size=32, batch_size=2))
    server_kw = dict(max_rounds=2, cohort_size=2, local_epochs=1)
    global0 = init_variables(torch.Generator().manual_seed(4), cfg.model)

    def clients():
        return {name: make_train_fn(cfg, ArrayDataset(imgs[sl], msks[sl], batch_size=2, seed=i), 2, seed=i,
                                    device="cpu")[0]
                for i, (name, sl) in enumerate(sorted(shards.items()))}

    ref = clients()
    want = chip_smoke.drive_federation(
        TR, tser, FedConfig(**server_kw), global0,
        lambda name, blob, rnd, hp: ref[name](blob, rnd, hp)[:2], sorted(shards))
    fits = clients()
    published = []  # every global the server publishes, through its eval hook
    state, results, _ = _session("torch", ["torch", "torch"], cfg_kw=server_kw, variables=global0,
                                 trains=[fits["a"], fits["b"]],
                                 server_kw=dict(eval_fn=lambda blob: published.append(blob) or {}))
    _assert_completed(state, results, rounds=2)
    assert sorted(published) == sorted(r["blob"] for r in want["rounds"])
    assert state.global_blob == want["state"].global_blob
    assert [h["samples"] for h in state.history] == [h["samples"] for h in want["state"].history] == [[4, 4]] * 2
    for r in results:
        assert [h["round"] for h in r.history] == [1, 2] and all(np.isfinite(h["loss"]) for h in r.history)


def test_metric_registry_exposition_matches_jax():
    from fedcrack_tpu.obs.registry import DEFAULT_VERSIONS_BUCKETS as JAX_BUCKETS
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from fedcrack_tpu_torch.obs.registry import DEFAULT_VERSIONS_BUCKETS, MetricsRegistry

    assert DEFAULT_VERSIONS_BUCKETS == JAX_BUCKETS
    regs = (JaxRegistry(), MetricsRegistry())
    for reg in regs:
        reg.counter("fed_updates_total", "updates\nby outcome", labels=("result",)).labels(result='a"b').inc(3)
        reg.gauge("fed_client_anomaly_max_ratio", "max").set(float("inf"))
        h = reg.histogram("fed_flush_seconds", "flush")
        for v in (0.0004, 0.2, 7.0, 99.0):
            h.observe(v)
        reg.histogram("fed_update_staleness_versions", buckets=DEFAULT_VERSIONS_BUCKETS).observe(3)
        with pytest.raises(ValueError):
            reg.counter("BadName")
        with pytest.raises(ValueError):
            reg.gauge("fed_updates_total")
    assert regs[1].exposition() == regs[0].exposition()
    assert regs[1].values() == regs[0].values()


def test_server_metrics_and_flight_ring_follow_the_session(tmp_path):
    from fedcrack_tpu_torch.health import ledger
    from fedcrack_tpu_torch.obs import flight
    from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

    before = REGISTRY.values()
    ring = flight.install(path=str(tmp_path / "dump.json"))
    try:
        state, results, _ = _session("torch", ["torch", "torch"], cfg_kw=dict(max_rounds=2))
        path = flight.dump("end of session")
    finally:
        flight.uninstall()
    _assert_completed(state, results, rounds=2)
    after = REGISTRY.values()

    def grew(name, key=()):
        return after[name].get(key, 0.0) - before.get(name, {}).get(key, 0.0)

    assert grew("fed_updates_total", ("accepted",)) == 4 and grew("fed_rounds_total") == 2
    assert grew("fed_wire_bytes_total", ("up",)) == 4 * len(tser.tree_to_bytes(_vars(0.0)))
    kinds = [e["kind"] for e in ring.snapshot()]
    assert kinds.count("fed.update") == 4 and kinds.count("fed.flush") == 2
    import json

    dump = json.load(open(path))
    assert dump["reason"] == "end of session" and "fed_rounds_total" in dump["metrics_exposition"]
    reg = MetricsRegistry()
    ledger.export_anomaly_metrics({f"c{i:02d}": {"anomaly": float(i)} for i in range(40)}, registry=reg)
    values = reg.values()
    assert values["fed_client_anomaly_max_ratio"][()] == 39.0
    assert len(values["fed_client_anomaly_score_ratio"]) == 33  # 32 clients and '_overflow'
    assert values["fed_client_anomaly_score_ratio"][("_overflow",)] == 39.0
