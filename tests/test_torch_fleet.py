"""The port's serve fleet (``serve/fleet.py``) and its batcher's fleet
surface (``serve/batcher.py``) held against the JAX package's on the CPU,
at the JAX fleet tests' tiny model (buckets 16 and 32).

- The zero-torn fleet swap: before ``install`` every answer on every
  replica is v0, after it v1; the answers equal the JAX ``ServeFleet``'s on
  the same weights and requests within 1e-4 (the probabilities' limit of
  tests/test_torch_serve.py).
- A batch that snapshotted before a commit answers from its snapshot
  (the swap lands from inside ``predict_bucket``: the JAX test's chaos
  hook is not ported, and this is the same window).
- The statefile poll swaps every replica, and so does a round checkpoint
  (``ckpt_dir=``); a refused quant gate serves the reference program
  bitwise, as the JAX fleet refuses the same build.
- ``add_replica`` (via ``grow_slot``), a scale-up landing between a
  swap's prepare and its commit, ``remove_replica``, the swap-pause
  histogram and the replicas gauge; the quantized fleet's gate record
  equals the JAX fleet's.
- ``MicroBatcher.stats()`` has the JAX batcher's keys and, on the same
  latency sequence, its percentiles.
- Under the lock-order monitor, a fleet scenario (dispatch, swap, grow,
  drain) records an acyclic lock-order graph.
"""

import time

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKETS = (16, 32)
PROB_TOL = 1e-4


def _serve_kw(**over):
    kw = dict(bucket_sizes=BUCKETS, max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    kw.update(over)
    return kw


def _port_engine(engine_cls=None, **over):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    return (engine_cls or InferenceEngine)(port_config(TINY_KW), ServeConfig(**_serve_kw(**over)), device="cpu")


@pytest.fixture(scope="module")
def stack():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine

    var0, var1 = jax_variables(TINY_KW, seed=0), jax_variables(TINY_KW, seed=1)
    return {
        "var0": var0,
        "var1": var1,
        "engine": _port_engine(),
        "engine_q": _port_engine(quant="int8", kernel_plane="fused_int8"),
        "jax_engine": JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw())),
    }


def _fleet(stack, *, quant="none", engine=None, replicas=2, **over):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet

    if engine is None:
        engine = stack["engine_q"] if quant == "int8" else stack["engine"]
    chaos = over.pop("chaos", None)
    kw = dict(quant=quant, replicas=replicas, **over)
    if quant == "int8":
        kw["kernel_plane"] = "fused_int8"
    return ServeFleet(port_config(TINY_KW), ServeConfig(**_serve_kw(**kw)), stack["var0"], shared_engine=engine,
                      warmup=False, chaos=chaos)


def _jax_fleet(stack, *, quant="none", replicas=2, **over):
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.fleet import ServeFleet as JaxFleet

    cfg = JaxServeConfig(**_serve_kw(quant=quant, replicas=replicas, **over))
    engine = stack["jax_engine"] if quant == "none" else None
    return JaxFleet(jax_config(TINY_KW), cfg, stack["var0"], shared_engine=engine, warmup=False)


def _img(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


def _results(fleet, images):
    return [f.result(timeout=120) for f in [fleet.submit(img) for img in images]]


def test_fleet_swap_zero_torn_and_answers_match_jax(stack):
    images = [_img(16 if i % 2 else 32, seed=i) for i in range(9)]
    fleet, jfleet = _fleet(stack, replicas=3), _jax_fleet(stack, replicas=3)
    try:
        pre, jpre = _results(fleet, images), _results(jfleet, images)
        assert {r.model_version for r in pre} == {r.model_version for r in jpre} == {0}
        assert fleet.install(1, stack["var1"]) and jfleet.install(1, stack["var1"])
        post, jpost = _results(fleet, images), _results(jfleet, images)
        assert {r.model_version for r in post} == {1}, "torn versions"
        for got, want in zip(pre + post, jpre + jpost):
            assert got.probs.shape == want.probs.shape
            np.testing.assert_allclose(got.probs, np.asarray(want.probs), rtol=0, atol=PROB_TOL)
        assert fleet.manager.last_swap["pause_ms"] >= 0 and fleet.manager.last_swap["replicas"] == 3
        assert fleet.stats()["replica_versions"] == [1, 1, 1]
        assert not fleet.install(1, stack["var1"]) and not fleet.install(0, stack["var1"])
        served = fleet.stats()["router"]["per_replica"]
        assert sum(s["completed"] for s in served.values()) == 18
    finally:
        fleet.close()
        jfleet.close()


def test_straddling_batch_answers_from_its_snapshot(stack):
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    holder, fired = {}, []

    class SwapMidBatch(InferenceEngine):
        def predict_bucket(self, variables, images_u8):
            # The batch's snapshot is taken; the fleet-wide commit lands now.
            if not fired and "fleet" in holder:
                fired.append(True)
                assert holder["fleet"].install(1, stack["var1"])
            return super().predict_bucket(variables, images_u8)

    fleet = _fleet(stack, engine=_port_engine(SwapMidBatch))
    holder["fleet"] = fleet
    try:
        res = fleet.submit(_img(16)).result(timeout=60)
        assert fired and res.model_version == 0 and fleet.manager.version == 1
        want = stack["engine"].predict_bucket(stack["engine"].prepare(stack["var0"]), _img(16)[None])[0]
        np.testing.assert_array_equal(res.probs, want)
        assert fleet.submit(_img(16)).result(timeout=60).model_version == 1
    finally:
        fleet.close()


def test_fleet_poll_installs_from_statefile(stack, tmp_path):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile

    state = str(tmp_path / "state.bin")
    fleet = ServeFleet(port_config(TINY_KW), ServeConfig(**_serve_kw(replicas=2)), stack["var0"],
                       shared_engine=stack["engine"], state_path=state, template=stack["var0"], warmup=False)
    try:
        assert not fleet.manager.poll_once()
        publish_statefile(state, stack["var1"], model_version=7)
        assert fleet.manager.poll_once() and fleet.manager.version == 7
        assert [fleet.manager.snapshot_for(i)[0] for i in range(2)] == [7, 7]
        assert not fleet.manager.poll_once()
        assert fleet.submit(_img(32)).result(timeout=60).model_version == 7
    finally:
        fleet.close()


def test_fleet_poll_installs_from_checkpoint_dir(stack, tmp_path):
    """``ckpt_dir=``: the newest round checkpoint swaps every replica, a
    statefile at a higher version wins over it, and the answers after the
    swap equal the JAX fleet's on the same weights."""
    from fedcrack_tpu_torch import ckpt as TC
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile

    ckpt_dir, state = str(tmp_path / "ckpt"), str(tmp_path / "state.bin")
    fleet = ServeFleet(port_config(TINY_KW), ServeConfig(**_serve_kw(replicas=2)), stack["var0"],
                       shared_engine=stack["engine"], ckpt_dir=ckpt_dir, state_path=state, template=stack["var0"],
                       warmup=False)
    try:
        assert not fleet.manager.poll_once()
        with TC.FedCheckpointer(ckpt_dir) as ckptr:
            ckptr.save(TC.FedCheckpoint(4, 3, stack["var1"]))
        assert fleet.manager.poll_once() and fleet.manager.version == 3
        assert [fleet.manager.snapshot_for(i)[0] for i in range(2)] == [3, 3]
        images = [_img(32, seed=s) for s in range(3)]
        got = _results(fleet, images)
        jax_fleet = _jax_fleet(stack)
        try:
            jax_fleet.install(3, stack["var1"])
            want = _results(jax_fleet, images)
        finally:
            jax_fleet.close()
        for g, w in zip(got, want):
            assert g.model_version == w.model_version == 3
            np.testing.assert_allclose(g.probs, np.asarray(w.probs), rtol=0, atol=PROB_TOL)
        publish_statefile(state, stack["var0"], model_version=5)
        assert fleet.manager.poll_once() and fleet.manager.version == 5
    finally:
        fleet.close()


def test_quantized_fleet_gate_matches_jax_and_serves_quantized(stack):
    from fedcrack_tpu_torch.obs.registry import REGISTRY
    from fedcrack_tpu_torch.serve.quant import QuantizedVariables

    fleet, jfleet = _fleet(stack, quant="int8"), _jax_fleet(stack, quant="int8")
    try:
        gate, jgate = fleet.manager.last_quant_gate, jfleet.manager.last_quant_gate
        assert gate["passed"] and jgate["passed"]
        assert gate["per_bucket"].keys() == jgate["per_bucket"].keys()
        assert gate["iou"] == pytest.approx(jgate["iou"], abs=1e-3)
        assert isinstance(fleet.manager.snapshot_for(0)[1], QuantizedVariables)
        assert REGISTRY.gauge("serve_quant_iou_ratio", "").value == pytest.approx(gate["iou"])
        info = REGISTRY.gauge("serve_kernel_plane_info", "", labels=("plane", "requested"))
        assert info.labels(plane="fused_int8", requested="fused_int8").value == 1
        before = stack["engine_q"].quantized_forwards
        res = fleet.submit(_img(16, seed=3)).result(timeout=60)
        jres = jfleet.submit(_img(16, seed=3)).result(timeout=60)
        np.testing.assert_allclose(res.probs, np.asarray(jres.probs), rtol=0, atol=PROB_TOL)
        assert stack["engine_q"].quantized_forwards == before + 1
    finally:
        fleet.close()
        jfleet.close()


def test_refused_gate_serves_the_reference_program(stack, monkeypatch):
    import torch

    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.quant import QuantizedVariables

    real = tq.quantize_for_plane

    def zero(node):
        if tq._is_qleaf(node):
            return {k: (torch.zeros_like(v) if k != tq.SKEY else v) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: zero(v) for k, v in node.items()}
        return node

    monkeypatch.setattr(tq, "quantize_for_plane", lambda v, p: tq.QuantizedVariables(zero(real(v, p).tree)))
    fleet = _fleet(stack, quant="int8")
    try:
        assert fleet.manager.last_quant_gate["passed"] is False
        _, payload = fleet.manager.snapshot_for(0)
        assert not isinstance(payload, QuantizedVariables)
        engine = stack["engine_q"]
        img = _img(16, seed=5)
        want = engine.predict_bucket(engine.prepare(stack["var0"]), img[None])[0]
        np.testing.assert_array_equal(fleet.submit(img).result(timeout=60).probs, want)
        # A grown replica replays the refusal: no quantized payload appears.
        replica = fleet.add_replica(warm=False)
        assert not isinstance(fleet.manager.snapshot_for(replica.index)[1], QuantizedVariables)
    finally:
        fleet.close()


def test_add_remove_replica_and_grow_slot(stack):
    from fedcrack_tpu_torch.serve.fleet import Replica

    fleet = _fleet(stack, replicas=1)
    try:
        replica = fleet.add_replica(warm=True)
        assert replica.index == 1 and len(fleet.router.replicas) == 2
        v, payload = fleet.manager.snapshot_for(1)
        assert v == 0 and payload is fleet.manager.snapshot_for(0)[1]  # the shared engine's payload
        assert {r.model_version for r in _results(fleet, [_img(16, s) for s in range(8)])} == {0}
        assert fleet.install(1, stack["var1"])
        assert {r.model_version for r in _results(fleet, [_img(16, s) for s in range(8)])} == {1}
        with pytest.raises(ValueError, match="grow_slot expects index 2"):
            fleet.manager.grow_slot(Replica(5, fleet.engine, fleet.manager))
        # Every replica serves from the fleet's one engine.
        other = Replica(2, _port_engine(), fleet.manager)
        try:
            with pytest.raises(ValueError, match="must share the fleet's engine"):
                fleet.manager.grow_slot(other)
        finally:
            other.batcher.close()
        assert fleet.manager.slot_versions() == [1, 1]
        out = fleet.remove_replica(1)
        assert out["failed"] == 0 and not out["already_dead"]
        assert [r.index for r in fleet.router.live_replicas()] == [0]
        assert fleet.remove_replica(1)["already_dead"]
    finally:
        fleet.close()


def test_grow_slot_between_prepare_and_commit_gets_the_new_payload(stack):
    # A scale-up that lands while a swap prepares joins at the old version
    # and is flipped by the commit; one that lands after the commit joins at
    # the new version. Either way its label matches its payload.
    fleet = _fleet(stack, replicas=1)
    manager = fleet.manager
    prepare = manager._prepare_payload
    grown = []

    def prepare_then_grow(host_variables):
        out = prepare(host_variables)
        replica = fleet.add_replica(warm=False)
        grown.append((replica.index, manager.snapshot_for(replica.index)))
        return out

    manager._prepare_payload = prepare_then_grow
    try:
        old_payload = manager.snapshot_for(0)[1]
        assert fleet.install(1, stack["var1"])
        (index, (v_joined, p_joined)), = grown
        assert index == 1 and v_joined == 0 and p_joined is old_payload
        new_payload = manager.snapshot_for(0)[1]
        assert new_payload is not old_payload
        assert manager.snapshot_for(1) == (1, new_payload)
        assert manager.last_swap["replicas"] == 2
        manager._prepare_payload = prepare
        late = fleet.add_replica(warm=False)
        assert manager.snapshot_for(late.index) == (1, new_payload)
        results = _results(fleet, [_img(16, s) for s in range(12)])
        assert {r.model_version for r in results} == {1}
        engine = stack["engine"]
        want = engine.predict_bucket(engine.prepare(stack["var1"]), np.stack([_img(16, s) for s in range(4)]))
        for r, w in zip(results[:4], want):
            np.testing.assert_allclose(r.probs, w, rtol=0, atol=PROB_TOL)
    finally:
        manager._prepare_payload = prepare
        fleet.close()


def test_remove_replica_with_backlog_drops_nothing(stack):
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    class SlowBatches(InferenceEngine):
        def predict_bucket(self, variables, images_u8):
            time.sleep(0.05)
            return super().predict_bucket(variables, images_u8)

    fleet = _fleet(stack, engine=_port_engine(SlowBatches), replicas=2)
    try:
        futures = [fleet.submit(_img(16, seed=i)) for i in range(16)]
        out = fleet.remove_replica(1)
        results = [f.result(timeout=120) for f in futures]
        assert len(results) == 16 and out["failed"] == 0
        assert sum(1 for r in fleet.router.replicas if r.alive) == 1
    finally:
        fleet.close()


def test_swap_pause_histogram_and_replicas_gauge(stack):
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    fleet = _fleet(stack, replicas=3)
    try:
        gauge = REGISTRY.gauge("serve_fleet_replicas", "")
        hist = REGISTRY.histogram("serve_fleet_swap_pause_seconds", "")
        assert gauge.value == 3
        before = hist.snapshot()["count"]
        assert fleet.install(1, stack["var1"])
        assert hist.snapshot()["count"] == before + 1
        fleet.router.kill_replica(2)
        assert gauge.value == 2
        fleet.add_replica(warm=False)
        assert gauge.value == 3
    finally:
        fleet.close()


def test_unported_fleet_options_raise_naming_their_item(stack):
    """``ServeFleet(chaos=)``, once refused, now runs. Mirror of
    tests/test_fleet.py::test_replica_crash_reroutes_queued_requests: a
    slow-batch hook on every replica, a ``SERVE_REPLICA_CRASH`` consumed
    from the plan while a backlog is queued, zero accepted requests
    dropped, the swap landing on the survivor. Then a ``ServeChaos``
    device loss on a fleet: retried, nothing dropped, answers equal to the
    engine's, and the hook reaches a replica grown later."""
    import time

    from fedcrack_tpu_torch.chaos import SERVE_DEVICE_LOSS, SERVE_REPLICA_CRASH, Fault, FaultPlan, ServeChaos

    class SlowBatches:
        def on_batch(self, bucket, batch_index, attempt):
            time.sleep(0.08)

    plan = FaultPlan([Fault(kind=SERVE_REPLICA_CRASH, round=1)])
    fleet = _fleet(stack, replicas=2, chaos=SlowBatches())
    try:
        img = _img(16)
        futs = [fleet.submit(img) for _ in range(16)]
        assert plan.take(SERVE_REPLICA_CRASH, round=1) is not None
        out = fleet.router.kill_replica(1)
        assert out["failed"] == 0
        assert len([f.result(timeout=120) for f in futs]) == 16  # zero dropped
        assert out["rerouted"] > 0, "kill landed after the queue drained"
        assert fleet.router.live_replicas()[0].index == 0
        assert fleet.install(1, stack["var1"])
        assert fleet.submit(img).result(timeout=60).model_version == 1
        assert fleet.router.kill_replica(1)["already_dead"] is True
    finally:
        fleet.close()

    chaos = ServeChaos(FaultPlan([Fault(kind=SERVE_DEVICE_LOSS, round=0)]))
    fleet = _fleet(stack, replicas=1, chaos=chaos)
    try:
        images = [_img(16, seed=i) for i in range(3)]
        results = _results(fleet, images)
        assert [f.kind for f in chaos.plan.triggered] == [SERVE_DEVICE_LOSS]
        per_replica = fleet.stats()["router"]["per_replica"]
        assert sum(r["completed"] for r in per_replica.values()) == 3
        assert sum(r["failed"] for r in per_replica.values()) == 0
        assert fleet.replicas[0].batcher.stats()["batch_retries"] == 1
        engine = stack["engine"]
        for img, r in zip(images, results):
            np.testing.assert_array_equal(r.probs, engine.predict_bucket(engine.prepare(stack["var0"]), img[None])[0])
        grown = fleet.add_replica(warm=False)
        assert grown.batcher._chaos is chaos
    finally:
        fleet.close()


def test_fleet_manager_probes_each_commit_with_the_canary(stack):
    """``FleetVersionManager(canary=)``: one probe pass per committed
    version, on the payload every replica serves; the records equal a
    canary run by hand on the same payloads."""
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.fleet import FleetVersionManager, Replica

    engine = stack["engine"]
    canary = CanaryEvaluator(engine, registry=MetricsRegistry())
    manager = FleetVersionManager(ServeConfig(**_serve_kw(replicas=2)), canary=canary)
    replicas = [Replica(i, engine, manager) for i in range(2)]
    manager.attach_replicas(replicas, stack["var0"])
    try:
        assert manager.install(1, stack["var0"]) and manager.install(3, stack["var1"])
        assert not manager.install(2, stack["var1"])
        assert manager.slot_versions() == [3, 3]
    finally:
        for r in replicas:
            r.batcher.close()
    by_hand = CanaryEvaluator(engine, registry=MetricsRegistry())
    for version, var in ((1, stack["var0"]), (3, stack["var1"])):
        by_hand.evaluate(version, engine.prepare(var))
    assert canary.history == by_hand.history and [h["version"] for h in canary.history] == [1, 3]


class _FakeEngine:
    """The batcher's engine surface, answering zeros at once."""

    def __init__(self, serve_config):
        self.serve_config = serve_config
        self.bucket_sizes = tuple(serve_config.bucket_sizes)
        self.max_batch = serve_config.max_batch

    def predict_bucket(self, variables, images_u8):
        return np.zeros(images_u8.shape[:3] + (1,), np.float32)


def test_batcher_stats_keys_and_percentiles_match_jax():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.batcher import MicroBatcher as JaxBatcher
    from fedcrack_tpu.serve.batcher import StaticWeights as JaxStatic
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

    rng = np.random.default_rng(0)
    latencies = rng.gamma(2.0, 3.0, 5000).tolist()  # past the reservoir's 4096
    stats = []
    for batcher_cls, static, cfg in ((MicroBatcher, StaticWeights, ServeConfig),
                                     (JaxBatcher, JaxStatic, JaxServeConfig)):
        with batcher_cls(_FakeEngine(cfg(**_serve_kw())), static(None, version=3)) as b:
            for v in latencies:  # the reservoirs alone, before any request
                b.latency.add(v)
                b.queue_latency.add(v / 2)
            reservoirs = b.stats()
            for f in [b.submit(_img(16, s)) for s in range(5)]:
                assert f.result(timeout=60).model_version == 3
            assert b.outstanding() == 0 and b.queued() == 0 and b.queued_by_bucket() == {16: 0, 32: 0}
            stats.append((reservoirs, b.stats()))
    (got, got_served), (want, want_served) = stats
    assert set(got) == set(want) == set(got_served)
    for key in ("latency_ms", "queue_ms"):
        assert got[key] == want[key], key  # count, min, mean, max, p50, p95, p99
    for key in ("submitted", "completed", "failed", "batches", "per_bucket", "versions_served", "swap_gaps_ms"):
        assert got_served[key] == want_served[key], key


def test_batcher_drain_and_resubmit_keep_futures(stack):
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights, _Request
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    class SlowBatches(InferenceEngine):
        def predict_bucket(self, variables, images_u8):
            time.sleep(1.0)
            return super().predict_bucket(variables, images_u8)

    engine = _port_engine(SlowBatches)
    payload = engine.prepare(stack["var0"])
    a = MicroBatcher(engine, StaticWeights(payload), max_delay_ms=50.0)
    b = MicroBatcher(engine, StaticWeights(payload, version=4))
    try:
        futures = [a.submit(_img(16, s)) for s in range(6)]
        deadline = time.monotonic() + 10.0
        while a.queued() != 2 and time.monotonic() < deadline:
            time.sleep(0.01)  # until the first batch of 4 is on the engine and 2 wait
        assert a.outstanding() == 6 and a.queued() == 2 and a.queued_by_bucket() == {16: 2, 32: 0}
        left = a.drain()
        assert [r.future for r in left] == futures[4:]  # the original futures, unanswered
        for req in left:
            b.resubmit(req)
        results = [f.result(timeout=60) for f in futures]
        assert [r.model_version for r in results] == [0] * 4 + [4] * 2
        # As in the JAX batcher, the drained requests stay counted on the
        # dead replica, which the router no longer reads.
        assert a.outstanding() == 2 and b.outstanding() == 0
        with pytest.raises(RuntimeError):
            a.submit(_img(16))
        with pytest.raises(ValueError):
            b.resubmit(_Request(image=_img(48), t_submit=0.0, deadline_s=None))
    finally:
        b.close()
        a.close()


def _acyclic(edges) -> bool:
    graph: dict[str, set] = {}
    for u, v in edges:
        graph.setdefault(u, set()).add(v)
    state: dict[str, int] = {}

    def visit(n) -> bool:
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and not visit(m)):
                return False
        state[n] = 2
        return True

    return all(visit(n) for n in list(graph) if n not in state)


def test_fleet_lock_order_graph_is_acyclic(stack):
    from fedcrack_tpu_torch.analysis import sanitizers
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler

    monitor = sanitizers.install_monitor()
    try:
        fleet = _fleet(stack, replicas=2, min_replicas=1, max_replicas=3)
        auto = FleetAutoscaler(fleet)
        try:
            _results(fleet, [_img(16, s) for s in range(6)])
            assert fleet.install(1, stack["var1"])
            fleet.add_replica(warm=False)
            _results(fleet, [_img(32, s) for s in range(6)])
            auto.evaluate()
            fleet.remove_replica(2)
            assert {r.model_version for r in _results(fleet, [_img(16, s) for s in range(4)])} == {1}
        finally:
            fleet.close()
        edges = monitor.edges()
    finally:
        sanitizers.uninstall_monitor()
    assert ("serve.router.dispatch", "serve.batcher.stats") in edges  # the nesting is real
    assert _acyclic(edges), sorted(edges)
    assert not _acyclic(edges | {("serve.batcher.stats", "serve.router.dispatch")})
