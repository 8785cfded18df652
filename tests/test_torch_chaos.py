"""The port's chaos plane (``fedcrack_tpu_torch/chaos/``) held against the
JAX package's on the CPU.

- Fault schedules: ``FaultPlan.generate`` and ``FaultPlan.storm`` give the
  same faults as the JAX package's for the same seeds and arguments.
- Poisoned payloads: ``_poison_weights`` is byte-equal to the JAX
  package's for every mode, on raw msgpack blobs (float32 and bfloat16
  wires) and on int8 and top-k frames.
- Scenarios: the transport-plane scenarios of tests/test_chaos.py (the
  crash phases, quorum and straggler, poisoned and stale uploads, the flap
  and the retry budget, the server kill and restart with and without live
  clients, the statefile kill between write and rename) run on each
  package's own ``FedServer`` and ``FedClient`` under the same plan, the
  two packages side by side in threads; each must pass the JAX test's
  checks, and the two round histories (rounds, clients, samples, rejected
  clients and their reasons, quorum, cohort size) and final globals must
  be equal. Every thread joins with a timeout, so no scenario can hang the
  suite.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]

JOIN_S = 60


def _package(name: str):
    """One package's chaos scenario surface, under the same names."""
    if name == "jax":
        import fedcrack_tpu.chaos as C
        from fedcrack_tpu import ioutils
        from fedcrack_tpu.ckpt import load_state_file, save_state_file
        from fedcrack_tpu.configs import FedConfig
        from fedcrack_tpu.fed import rounds as R
        from fedcrack_tpu.fed import serialization as ser
        from fedcrack_tpu.transport import FedClient, FedServer
        from fedcrack_tpu.transport import transport_pb2 as pb
        from fedcrack_tpu.transport.client import NON_RETRYABLE_CODES
        from fedcrack_tpu.transport.service import METHOD, SERVICE_NAME, ServerThread

        def ready(cname):
            m = pb.ClientMessage(cname=cname)
            m.ready.SetInParent()
            return m

        def done(cname, rnd, blob, ns):
            m = pb.ClientMessage(cname=cname)
            m.done.round, m.done.weights, m.done.sample_count = rnd, blob, ns
            return m

        codec = (pb.ClientMessage.SerializeToString, pb.ServerMessage.FromString)
    else:
        import fedcrack_tpu_torch.chaos as C
        from fedcrack_tpu_torch import ioutils
        from fedcrack_tpu_torch.ckpt import load_state_file, save_state_file
        from fedcrack_tpu_torch.configs import FedConfig
        from fedcrack_tpu_torch.fed import rounds as R
        from fedcrack_tpu_torch.fed import serialization as ser
        from fedcrack_tpu_torch.transport import FedClient, FedServer, wire
        from fedcrack_tpu_torch.transport.client import NON_RETRYABLE_CODES
        from fedcrack_tpu_torch.transport.service import METHOD, SERVICE_NAME, ServerThread

        def ready(cname):
            return wire.ClientMessage(cname=cname, msg=wire.ReadyReq())

        def done(cname, rnd, blob, ns):
            return wire.ClientMessage(cname=cname, msg=wire.TrainDone(round=rnd, weights=blob, sample_count=ns))

        codec = (wire.ClientMessage.encode, wire.ServerMessage.decode)

    def caller(port):
        import grpc

        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        method = channel.stream_stream(f"/{SERVICE_NAME}/{METHOD}", request_serializer=codec[0],
                                       response_deserializer=codec[1])
        return channel, lambda m: next(iter(method(iter([m]), timeout=10, wait_for_ready=True)))

    return types.SimpleNamespace(
        name=name, C=C, R=R, ser=ser, ioutils=ioutils, FedConfig=FedConfig, FedClient=FedClient,
        FedServer=FedServer, ServerThread=ServerThread, load_state_file=load_state_file,
        save_state_file=save_state_file, NON_RETRYABLE_CODES=NON_RETRYABLE_CODES, caller=caller,
        ready=ready, done=done,
    )


def _vars(value: float):
    return {"params": {"w": np.full((4, 4), value, np.float32)}}


def _fake_train(P, increment: float, samples: int):
    def train_fn(blob: bytes, rnd: int):
        tree = P.ser.tree_from_bytes(blob)
        tree["params"]["w"] = tree["params"]["w"] + increment
        return P.ser.tree_to_bytes(tree), samples, {"loss": float(rnd)}

    return train_fn


def _cfg(P, **over):
    """tests/test_chaos.py's ``cfg`` fixture, in package ``P``."""
    kw = dict(max_rounds=3, cohort_size=2, registration_window_s=5.0, poll_period_s=0.05,
              round_deadline_s=2.5, host="127.0.0.1", port=0)
    kw.update(over)
    return P.FedConfig(**kw)


def _run_clients(clients, keys=None):
    keys = keys or [c.cname for c in clients]
    res = {}

    def run(c, key):
        try:
            res[key] = c.run_session()
        except Exception as e:  # noqa: BLE001 (the exception is the result)
            res[key] = e

    threads = [threading.Thread(target=run, args=(c, k), daemon=True) for c, k in zip(clients, keys)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "scenario hung past the wall-clock bound"
    return res


def _chaos_client(P, cfg, port, cname, faults, train=None, **kw):
    return P.FedClient(cfg, train or _fake_train(P, 1.0, 10), cname=cname, port=port,
                       chaos=P.C.ClientChaos(P.C.FaultPlan(faults)), **kw)


def _both(scenario, *args):
    """``scenario(P, *args)`` for the JAX package and the port at once, in
    two threads; returns ``{"jax": ..., "port": ...}`` or raises the first
    failure."""
    out, errors = {}, {}

    def run(name):
        try:
            out[name] = scenario(_package(name), *args)
        except BaseException as e:  # noqa: BLE001 (re-raised on the test's thread)
            errors[name] = e

    threads = [threading.Thread(target=run, args=(n,), daemon=True) for n in ("jax", "port")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * JOIN_S)
        assert not t.is_alive(), "scenario hung past the wall-clock bound"
    for name, e in errors.items():
        raise AssertionError(f"{name} package: {e!r}") from e
    return out


def _history(state):
    return [
        {k: (sorted(h[k]) if k == "clients" else h[k])
         for k in ("round", "clients", "samples", "rejected", "quorum", "cohort_size") if k in h}
        for h in state.history
    ]


def _final(P, state):
    return np.asarray(P.ser.tree_from_bytes(state.global_blob)["params"]["w"], np.float32)


def _assert_same(out):
    assert out["port"]["history"] == out["jax"]["history"]
    np.testing.assert_array_equal(out["port"]["final"], out["jax"]["final"])


# ---- fault schedules and poisoned payloads ----


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_generate_and_storm_schedules_equal_jax(seed):
    import fedcrack_tpu.chaos.plan as J
    import fedcrack_tpu_torch.chaos.plan as T

    assert T.ALL_KINDS == J.ALL_KINDS and T.CLIENT_KINDS == J.CLIENT_KINDS
    for kinds in (None, T.ALL_KINDS, T.SERVE_KINDS | T.STREAM_KINDS, T.MESH_KINDS):
        kw = dict(n_rounds=5, clients=["b", "a", "c"], n_faults=12, max_delay_s=0.7)
        got = T.FaultPlan.generate(seed, kinds=kinds, **kw).pending
        want = J.FaultPlan.generate(seed, kinds=kinds, **kw).pending
        assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in want]
    got = T.FaultPlan.storm(seed, clients=["c1", "c0"], n_iterations=6).pending
    want = J.FaultPlan.storm(seed, clients=["c1", "c0"], n_iterations=6).pending
    assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in want]
    with pytest.raises(ValueError, match="unknown fault kind"):
        T.Fault("no_such_kind", round=1)
    with pytest.raises(ValueError, match="n_iterations"):
        T.FaultPlan.storm(seed, clients=["a"], n_iterations=0)


def test_take_is_one_shot_and_noted_in_the_flight_ring():
    from fedcrack_tpu_torch.chaos import NETWORK_FLAP, SERVE_DEVICE_LOSS, Fault, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.obs import flight

    plan = FaultPlan([Fault(NETWORK_FLAP, round=2, client="a"), Fault(SERVE_DEVICE_LOSS, round=0)])
    ring = flight.install(hooks=False)
    try:
        assert plan.take(NETWORK_FLAP, client="b", round=2) is None
        assert plan.take(NETWORK_FLAP, client="a", round=None) is None
        assert plan.take(NETWORK_FLAP, client="a", round=2).kind == NETWORK_FLAP
        assert plan.take(NETWORK_FLAP, client="a", round=2) is None  # one-shot
        assert plan.take(SERVE_DEVICE_LOSS, client="anyone", round=0) is not None
        assert [e["fault"] for e in ring.snapshot() if e["kind"] == "chaos.fault"] == [NETWORK_FLAP,
                                                                                       SERVE_DEVICE_LOSS]
    finally:
        flight.uninstall()
    assert len(plan) == 0 and len(plan.triggered) == 2
    # MeshChaos, the slot driver's hook, takes its faults the same way:
    # one-shot, so the replay after a fault runs clean.
    import torch

    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, MESH_NONFINITE
    from fedcrack_tpu_torch.chaos.inject import InjectedDeviceFailure

    mesh_plan = FaultPlan([Fault(MESH_DEVICE_FAIL, round=1), Fault(MESH_NONFINITE, round=2)])
    chaos = MeshChaos(mesh_plan)
    assert chaos(0, 0) is None
    with pytest.raises(InjectedDeviceFailure, match="round 1"):
        chaos(1, 0)
    assert chaos(1, 1) is None
    variables, metrics = chaos(2, 0)({"w": torch.ones(2), "n": torch.ones(2, dtype=torch.int32)},
                                     {"loss": torch.zeros(3)})
    assert torch.isnan(variables["w"]).all() and torch.isnan(metrics["loss"]).all()
    assert torch.equal(variables["n"], torch.ones(2, dtype=torch.int32))
    assert chaos(2, 1) is None and len(mesh_plan) == 0


def _blobs():
    """Raw msgpack trees (float32 and bfloat16 wires, a non-float leaf) and
    int8 and top-k frames, each made by the JAX package."""
    from fedcrack_tpu.compress import get_codec
    from fedcrack_tpu.fed.serialization import tree_to_bytes

    rng = np.random.default_rng(3)
    base = {"params": {"b": rng.normal(0, 1, (7,)).astype(np.float32),
                       "a": {"kernel": rng.normal(0, 1, (3, 3, 2, 5)).astype(np.float32)}},
            "batch_stats": {"mean": rng.normal(0, 1, (5,)).astype(np.float32),
                            "count": np.arange(3, dtype=np.int32)}}
    trained = {"params": {"b": base["params"]["b"] + 0.5, "a": {"kernel": base["params"]["a"]["kernel"] * 1.1}},
               "batch_stats": {"mean": base["batch_stats"]["mean"] - 0.25, "count": base["batch_stats"]["count"]}}
    float_only = {k: {n: v for n, v in t.items() if n != "count"} for k, t in trained.items()}
    out = {"f32": tree_to_bytes(trained), "f32_floats": tree_to_bytes(float_only),
           "bf16": tree_to_bytes(float_only, cast_dtype="bfloat16")}
    for codec in ("int8", "topk_delta"):
        out[codec] = get_codec(codec, topk_fraction=0.3, client_tag="c").encode_update(
            tree_to_bytes(float_only), tree_to_bytes({k: {n: v for n, v in t.items() if n != "count"}
                                                      for k, t in base.items()}), round=2, base_version=1)
    return out


@pytest.mark.parametrize("mode", ["corrupt_payload", "truncate_payload", "corrupt_compressed_frame",
                                  "nan_update", "scaled_update"])
def test_poisoned_blobs_byte_equal_jax(mode):
    from fedcrack_tpu.chaos.inject import _poison_weights as jax_poison
    from fedcrack_tpu.compress import is_frame
    from fedcrack_tpu_torch.chaos.inject import _poison_weights

    # Left alone by both packages: a first leaf (sorted key order) that is
    # an int counter, and bfloat16 wire leaves (not a numpy float kind).
    unchanged = {("nan_update", "f32"), ("nan_update", "bf16"), ("scaled_update", "bf16")}
    blobs = _blobs()
    assert is_frame(blobs["int8"]) and is_frame(blobs["topk_delta"])
    for name, blob in blobs.items():
        want = jax_poison(blob, mode)
        assert _poison_weights(blob, mode) == want, name
        assert (want == blob) == ((mode, name) in unchanged), name
    with pytest.raises(ValueError, match="not a payload poison"):
        _poison_weights(blobs["f32"], "network_flap")


# ---- transport plane: client crash phases ----


def _crash_before_upload(P):
    cfg = _cfg(P)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server) as st:
        a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=st.port)
        b = _chaos_client(P, cfg, st.port, "b", [P.C.Fault(P.C.CRASH_BEFORE_UPLOAD, round=2, client="b")])
        res = _run_clients([a, b])
        state = st.state
    assert isinstance(res["b"], P.C.InjectedCrash)
    assert res["a"].rounds_completed == 3
    assert state.phase == P.R.PHASE_FINISHED and state.cohort == frozenset({"a"})
    assert state.history[0]["clients"] == ["a", "b"]
    return {"history": _history(state), "final": _final(P, state)}


def test_crash_before_upload_deadline_rescues():
    _assert_same(_both(_crash_before_upload))


def _crash_around_upload(P, kind):
    cfg = _cfg(P, round_deadline_s=30.0)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server) as st:
        a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=st.port)
        b1 = _chaos_client(P, cfg, st.port, "b", [P.C.Fault(kind, round=1, client="b")])
        res = {}

        def run(c, key):
            try:
                res[key] = c.run_session()
            except Exception as e:  # noqa: BLE001
                res[key] = e

        ta = threading.Thread(target=run, args=(a, "a"), daemon=True)
        tb = threading.Thread(target=run, args=(b1, "b1"), daemon=True)
        ta.start()
        tb.start()
        tb.join(JOIN_S)
        assert not tb.is_alive(), "crashing client hung"
        assert isinstance(res["b1"], P.C.InjectedCrash)
        r_b2 = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="b", port=st.port).run_session()
        ta.join(JOIN_S)
        assert not ta.is_alive(), "surviving client hung"
        state = st.state
    assert not isinstance(res["a"], Exception), res["a"]
    assert r_b2.enrolled and r_b2.rounds_completed == 3
    assert state.phase == P.R.PHASE_FINISHED and state.cohort == frozenset({"a", "b"})
    assert [h["round"] for h in state.history] == [1, 2, 3]
    assert all(h["clients"] == ["a", "b"] for h in state.history)
    return {"history": _history(state), "final": _final(P, state)}


@pytest.mark.parametrize("kind", ["crash_during_upload", "crash_after_upload"])
def test_crash_around_upload_restart_rejoins(kind):
    _assert_same(_both(_crash_around_upload, kind))


# ---- transport plane: quorum and straggler ----


def _quorum_straggler(P):
    cfg = _cfg(P, cohort_size=3, quorum_fraction=2.0 / 3.0, round_deadline_s=30.0, max_rounds=2)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server) as st:
        fast = [P.FedClient(cfg, _fake_train(P, 1.0, 8), cname=n, port=st.port) for n in ("a", "b")]
        slow = _chaos_client(P, cfg, st.port, "c", [P.C.Fault(P.C.STRAGGLER_DELAY, round=1, client="c", delay_s=1.0)],
                             train=_fake_train(P, 5.0, 8))
        res = _run_clients(fast + [slow])
        state = st.state
    for n in ("a", "b", "c"):
        assert not isinstance(res[n], Exception), res[n]
    assert res["a"].rounds_completed == 2 and res["b"].rounds_completed == 2
    assert res["c"].enrolled and res["c"].final_weights is not None
    h1 = state.history[0]
    assert state.phase == P.R.PHASE_FINISHED and h1["quorum"] == 2 and h1["cohort_size"] == 3
    assert h1["clients"] == ["a", "b"]
    assert np.all(np.isfinite(_final(P, state)))
    # Round 1 is the fast clients' alone; round 2's quorum races the
    # straggler's resync, so only round 1 is compared across packages.
    return {"history": _history(state)[:1], "final": np.asarray(P.ser.tree_from_bytes(
        res["a"].final_weights)["params"]["w"]).shape}


def test_quorum_closes_round_and_straggler_resyncs():
    out = _both(_quorum_straggler)
    assert out["port"] == out["jax"] or (out["port"]["history"] == out["jax"]["history"]
                                         and out["port"]["final"] == out["jax"]["final"])


# ---- transport plane: poisoned payloads ----


def _poisoned(P, kind):
    # The poisoned upload must reach the sanitation gate; on a loaded host
    # a deadline shrink can drop b first ("not in cohort"), which proves
    # nothing about sanitation, so that race is retried (as the JAX test does).
    cfg = _cfg(P, registration_window_s=30.0)
    for attempt in range(3):
        server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
        with P.ServerThread(server) as st:
            a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=st.port)
            b = _chaos_client(P, cfg, st.port, "b", [P.C.Fault(kind, round=2, client="b")],
                              train=_fake_train(P, 3.0, 10))
            res = _run_clients([a, b])
            state = st.state
        if not (attempt < 2 and isinstance(res["b"], RuntimeError) and "not in cohort" in str(res["b"])):
            break
    assert isinstance(res["b"], RuntimeError) and "update rejected" in str(res["b"])
    assert res["a"].rounds_completed == 3 and state.phase == P.R.PHASE_FINISHED
    np.testing.assert_allclose(_final(P, state), 4.0, atol=1e-5)
    return {"history": _history(state), "final": _final(P, state)}


@pytest.mark.parametrize("kind,reason_frag", [("corrupt_payload", "undecodable"),
                                              ("truncate_payload", "undecodable"),
                                              ("nan_update", "non-finite")])
def test_poisoned_update_rejected_and_never_averaged(kind, reason_frag):
    out = _both(_poisoned, kind)
    _assert_same(out)
    rejected = {k: v for h in out["port"]["history"] for k, v in h["rejected"].items()}
    assert "b" in rejected and reason_frag in rejected["b"]


def _stale_replay(P):
    cfg = _cfg(P, round_deadline_s=30.0)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server) as st:
        a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=st.port)
        b = _chaos_client(P, cfg, st.port, "b", [P.C.Fault(P.C.STALE_REPLAY, round=2, client="b")])
        res = _run_clients([a, b])
        state = st.state
    assert not isinstance(res["a"], Exception) and not isinstance(res["b"], Exception), res
    assert res["a"].rounds_completed == 3 and state.phase == P.R.PHASE_FINISHED
    assert [h["round"] for h in state.history] == [1, 2, 3]
    assert any("stale round" in h["rejected"].get("b", "") for h in state.history)
    np.testing.assert_allclose(_final(P, state), 3.0, atol=1e-5)
    return {"history": _history(state), "final": _final(P, state)}


def test_stale_replay_resynced_never_averaged():
    _assert_same(_both(_stale_replay))


# ---- transport plane: network flap and the retry budget ----


def _flap(P):
    cfg = _cfg(P, round_deadline_s=30.0)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server) as st:
        a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=st.port)
        b = _chaos_client(P, cfg, st.port, "b", [P.C.Fault(P.C.NETWORK_FLAP, round=2, client="b", count=2)])
        res = _run_clients([a, b])
        state = st.state
    assert not isinstance(res["b"], Exception), res["b"]
    assert res["a"].rounds_completed == 3 and res["b"].rounds_completed == 3
    assert state.phase == P.R.PHASE_FINISHED and all(h["clients"] == ["a", "b"] for h in state.history)
    return {"history": _history(state), "final": _final(P, state)}


def test_network_flap_ridden_out_by_retries():
    _assert_same(_both(_flap))


def test_retry_budget_and_nonretryable_codes():
    """Mirror of the JAX test: a non-retryable code surfaces after one
    attempt; a retryable one runs ``max_retries`` attempts with jittered
    backoff; a tight ``retry_budget_s`` stops long before ``max_retries``;
    and the injected flap is retryable."""
    import grpc

    P = _package("port")

    class FakeErr(grpc.RpcError):
        def __init__(self, code):
            self._code = code

        def code(self):
            return self._code

    calls = {"n": 0}

    def failing_method(it, timeout=None, wait_for_ready=None):
        calls["n"] += 1
        raise FakeErr(failing_method.code)

    cfg = P.FedConfig(port=0)
    client = P.FedClient(cfg, _fake_train(P, 1.0, 1), cname="x", max_retries=5)
    assert grpc.StatusCode.INVALID_ARGUMENT in P.NON_RETRYABLE_CODES
    assert P.C.InjectedRpcError().code() not in P.NON_RETRYABLE_CODES
    failing_method.code = grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError):
        client._call(failing_method, client._msg(None))
    assert calls["n"] == 1
    calls["n"] = 0
    failing_method.code = grpc.StatusCode.UNAVAILABLE
    short = P.FedClient(cfg, _fake_train(P, 1.0, 1), cname="x", max_retries=3)
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError):
        short._call(failing_method, short._msg(None))
    assert calls["n"] == 3 and 0.1 < time.monotonic() - t0 < 10.0
    calls["n"] = 0
    tight = P.FedClient(cfg, _fake_train(P, 1.0, 1), cname="x", max_retries=50, retry_budget_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError):
        tight._call(failing_method, tight._msg(None))
    assert time.monotonic() - t0 < 5.0 and calls["n"] < 50


# ---- transport plane: mid-round server kill and restart ----


def _kill_restart(P, tmp_path):
    cfg = _cfg(P, round_deadline_s=30.0, state_path=str(tmp_path / P.name / "server_state.msgpack"))
    (tmp_path / P.name).mkdir()
    blob = lambda v: P.ser.tree_to_bytes(_vars(v))  # noqa: E731
    server1 = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    with P.ServerThread(server1) as st1:
        ch, call = P.caller(st1.port)
        assert call(P.ready("a")).status == P.R.SW and call(P.ready("b")).status == P.R.SW
        assert call(P.done("a", 1, blob(1.0), 10)).status == P.R.RESP_ACY
        assert call(P.done("b", 1, blob(3.0), 30)).status == P.R.RESP_ARY
        history_prefix = [dict(h) for h in st1.state.history]
        assert call(P.done("a", 2, blob(2.0), 10)).status == P.R.RESP_ACY
        ch.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = P.load_state_file(cfg.state_path, cfg)
            if s is not None and "a" in s.received and s.current_round == 2:
                break
            time.sleep(0.01)
        else:
            raise AssertionError("statefile never captured the mid-round update")
        st1.kill()
    server2 = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    assert server2.state.phase == P.R.PHASE_RUNNING and server2.state.current_round == 2
    assert server2.state.cohort == frozenset({"a", "b"}) and set(server2.state.received) == {"a"}
    assert [dict(h) for h in server2.state.history] == history_prefix
    with P.ServerThread(server2) as st2:
        ch, call = P.caller(st2.port)
        rep = call(P.done("b", 2, blob(4.0), 30))
        assert rep.status == P.R.RESP_ARY
        np.testing.assert_allclose(P.ser.tree_from_bytes(rep.weights)["params"]["w"], 3.5, atol=1e-6)
        call(P.done("a", 3, blob(1.0), 10))
        assert call(P.done("b", 3, blob(1.0), 30)).status == P.R.FIN
        ch.close()
        state = st2.state
    assert state.phase == P.R.PHASE_FINISHED and [h["round"] for h in state.history] == [1, 2, 3]
    assert state.history[0] == history_prefix[0]
    return {"history": _history(state), "final": _final(P, state)}


def test_server_kill_restart_resumes_same_round(tmp_path):
    _assert_same(_both(_kill_restart, tmp_path))


def _kill_restart_live(P, tmp_path):
    (tmp_path / P.name).mkdir()
    state_path = str(tmp_path / P.name / "server_state.msgpack")
    cfg = _cfg(P, round_deadline_s=30.0, state_path=state_path, max_rounds=2)
    slow_gate, reported = threading.Event(), threading.Event()

    def train_b(blob, rnd):
        if rnd == 2:
            reported.set()
            slow_gate.wait(JOIN_S)
        return _fake_train(P, 3.0, 30)(blob, rnd)

    server1 = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    st1 = P.ServerThread(server1)
    st1.__enter__()
    port = st1.port
    try:
        a = P.FedClient(cfg, _fake_train(P, 1.0, 10), cname="a", port=port)
        b = P.FedClient(cfg, train_b, cname="b", port=port)
        res = {}

        def run(c):
            try:
                res[c.cname] = c.run_session()
            except Exception as e:  # noqa: BLE001
                res[c.cname] = e

        threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in (a, b)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline:
            s = P.load_state_file(state_path, cfg)
            if s is not None and s.current_round == 2 and "a" in s.received and reported.is_set():
                break
            time.sleep(0.01)
        else:
            raise AssertionError("never reached the mid-round kill point")
        st1.kill()
        server2 = P.FedServer(dataclasses.replace(cfg, port=port), _vars(0.0), tick_period_s=0.05)
        assert server2.state.current_round == 2 and set(server2.state.received) == {"a"}
        with P.ServerThread(server2) as st2:
            slow_gate.set()
            for t in threads:
                t.join(JOIN_S)
            assert not any(t.is_alive() for t in threads), "clients hung"
            state = st2.state
    finally:
        slow_gate.set()
        st1.kill()  # a no-op once killed
    assert not isinstance(res["a"], Exception) and not isinstance(res["b"], Exception), res
    assert state.phase == P.R.PHASE_FINISHED and [h["round"] for h in state.history] == [1, 2]
    np.testing.assert_allclose(_final(P, state), 5.0, atol=1e-5)
    return {"history": _history(state), "final": _final(P, state)}


def test_server_kill_restart_with_live_clients(tmp_path):
    _assert_same(_both(_kill_restart_live, tmp_path))


def test_killed_server_thread_exit_is_a_no_op_and_frees_the_port():
    P = _package("port")
    cfg = _cfg(P)
    st = P.ServerThread(P.FedServer(cfg, _vars(0.0), tick_period_s=0.05))
    with st:
        port = st.port
        st.kill()
        assert not st._thread.is_alive()
    st.kill()
    # The port is free again: a fresh server binds it.
    with P.ServerThread(P.FedServer(dataclasses.replace(cfg, port=port), _vars(0.0), tick_period_s=0.05)) as again:
        assert again.port == port


# ---- torn-write safety ----


def test_statefile_kill_between_write_and_rename(tmp_path):
    import os

    P = _package("port")
    cfg = _cfg(P, state_path=str(tmp_path / "state.msgpack"))
    state = P.R.initial_state(cfg, _vars(0.0))
    state, _ = P.R.transition(state, P.R.Ready("a", now=0.0))
    P.save_state_file(cfg.state_path, state)
    with open(f"{cfg.state_path}.tmp.{os.getpid()}", "wb") as f:
        f.write(b"\x00garbage: killed before rename")
    restored = P.load_state_file(cfg.state_path, cfg)
    assert restored is not None and restored.cohort == frozenset({"a"})
    real_replace = os.replace

    def exploding_replace(src, dst):
        raise OSError("injected kill at rename")

    os.replace = exploding_replace
    try:
        with pytest.raises(OSError):
            P.ioutils.atomic_write_bytes(cfg.state_path, b"new bytes")
    finally:
        os.replace = real_replace
    assert P.load_state_file(cfg.state_path, cfg).cohort == frozenset({"a"})
    # The same file, read by the JAX package, is the same state.
    J = _package("jax")
    assert J.load_state_file(cfg.state_path, _cfg(J, state_path=cfg.state_path)).cohort == frozenset({"a"})


# ---- serving plane (tests/test_serve.py's chaos tests) ----


@pytest.fixture(scope="module")
def serve_stack():
    import torch

    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from torch_port_helpers import TINY_KW, port_config

    cfg = port_config(dict(TINY_KW, img_size=16))
    kw = dict(bucket_sizes=(16,), max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    engine = InferenceEngine(cfg, ServeConfig(**kw), device="cpu")
    return engine, *(init_variables(torch.Generator().manual_seed(s), cfg) for s in (0, 1))


def _serve_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)


def test_swap_midflight_batch_answers_from_its_snapshot(serve_stack):
    """Mirror of tests/test_serve.py's straddle test: the swap lands between
    the in-flight batch's snapshot and its dispatch; that batch is entirely
    version 0, byte-equal to version 0's cold outputs, the next is 1."""
    from fedcrack_tpu_torch.chaos import SERVE_SWAP_MIDFLIGHT, Fault, FaultPlan, ServeChaos
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    engine, var0, var1 = serve_stack
    imgs = _serve_images(4, seed=9)
    mgr = ModelVersionManager(engine, var0)
    chaos = ServeChaos(FaultPlan([Fault(kind=SERVE_SWAP_MIDFLIGHT, round=0)]), swap_hook=lambda: mgr.install(1, var1))
    with MicroBatcher(engine, mgr, max_delay_ms=200.0, chaos=chaos) as b:
        batch = [f.result(timeout=60) for f in [b.submit(i) for i in imgs]]
        after = b.submit(imgs[0]).result(timeout=60)
    mgr.stop()
    assert {r.model_version for r in batch} == {0}
    cold0 = engine.predict_bucket(engine.prepare(var0), imgs)
    for i, r in enumerate(batch):
        np.testing.assert_array_equal(r.probs, cold0[i])
    assert after.model_version == 1 and mgr.version == 1
    np.testing.assert_array_equal(after.probs, engine.predict_bucket(engine.prepare(var1), imgs[:1])[0])


def test_injected_device_loss_drops_nothing(serve_stack):
    """Mirror of tests/test_serve.py's device-loss test: one injected loss,
    one clean retry, nothing dropped, answers byte-equal to the cold ones."""
    from fedcrack_tpu_torch.chaos import SERVE_DEVICE_LOSS, Fault, FaultPlan, ServeChaos
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    engine, var0, _ = serve_stack
    mgr = ModelVersionManager(engine, var0)
    chaos = ServeChaos(FaultPlan([Fault(kind=SERVE_DEVICE_LOSS, round=0)]))
    imgs = _serve_images(4, seed=10)
    with MicroBatcher(engine, mgr, max_delay_ms=200.0, chaos=chaos) as b:
        results = [f.result(timeout=60) for f in [b.submit(i) for i in imgs]]
        stats = b.stats()
    mgr.stop()
    assert len(results) == 4 and stats["completed"] == 4 and stats["failed"] == 0
    assert stats["batch_retries"] == 1
    cold0 = engine.predict_bucket(engine.prepare(var0), imgs)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.probs, cold0[i])
