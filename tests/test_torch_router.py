"""The port's fleet router (``serve/router.py``) held against the JAX
package's on the CPU, with the same scripted replicas, latencies and clock.

- ``FleetRouter._pick``: the same least-outstanding picks (ties to the
  lowest index, buckets filtered) over a scripted sequence of outstanding
  counts, and the same error when no live replica serves a bucket.
- ``shed_reason`` / ``submit``: the same shed reasons and details, shed
  counts and admitted dispatches over a script of queue depths and
  latencies, and the same ``refresh_gauges`` reads.
- ``RollingPercentiles``: the same percentiles and counts over a latency
  sequence that crosses window rotations of a scripted clock.
- The shadow hook: the mirror sees what the JAX router's sees (admitted
  requests only; attach replaces), and a failing mirror is logged and
  never fails the request.
- ``kill_replica``: the drained requests reroute to survivors with their
  original futures, with the JAX router's accounting; on real batchers a
  backlog survives the kill with zero drops.

Host logic: exact equality throughout.
"""

import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from fedcrack_tpu.serve import router as JR
from fedcrack_tpu_torch.serve import router as TR

pytestmark = pytest.mark.torch_port


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One scripted clock behind both routers' ``time`` module name."""
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(JR, "time", fake)
    monkeypatch.setattr(TR, "time", fake)
    return c


class _Request:
    def __init__(self, size):
        self.image = np.zeros((size, size, 3), np.uint8)
        self.future = Future()


class _Batcher:
    """A scripted batcher: outstanding and queued counts are set by the
    test; ``submit`` answers at once with the given latency."""

    def __init__(self, buckets, log):
        self.engine = types.SimpleNamespace(bucket_sizes=tuple(buckets))
        self.n_outstanding = 0
        self.queue = {s: 0 for s in buckets}
        self.latency_ms = 1.0
        self.log = log
        self.drained: list = []
        self.closed = False

    def outstanding(self):
        return self.n_outstanding

    def queued(self):
        return sum(self.queue.values())

    def queued_by_bucket(self):
        return dict(self.queue)

    def submit(self, image_u8, deadline_ms=None):
        if self.closed:
            raise RuntimeError("batcher is closed")
        fut = Future()
        self.log.append(("submit", image_u8.shape[0], deadline_ms))
        fut.set_result(types.SimpleNamespace(latency_ms=self.latency_ms))
        return fut

    def drain(self):
        self.closed = True
        return list(self.drained)

    def resubmit(self, req):
        self.log.append(("resubmit", id(req)))


def _replicas(buckets_per_replica):
    log = []
    return [types.SimpleNamespace(index=i, alive=True, batcher=_Batcher(b, log))
            for i, b in enumerate(buckets_per_replica)], log


def _config(**over):
    kw = dict(queue_bound=0, slo_p95_ms=0.0)
    kw.update(over)
    return types.SimpleNamespace(**kw)


def _pair(buckets, **cfg):
    """A JAX and a port router over twin scripted fleets."""
    (jrep, jlog), (trep, tlog) = _replicas(buckets), _replicas(buckets)
    return (JR.FleetRouter(jrep, _config(**cfg)), jrep, jlog), (TR.FleetRouter(trep, _config(**cfg)), trep, tlog)


def test_pick_matches_jax_over_a_script(clock):
    buckets = [(16, 32), (16, 32), (32,), (16, 32)]
    (jr, jrep, _), (tr, trep, _) = _pair(buckets)
    rng = np.random.default_rng(0)
    for step in range(200):
        counts = rng.integers(0, 4, len(buckets))
        alive = rng.random(len(buckets)) > 0.2
        for reps in (jrep, trep):
            for r, n, a in zip(reps, counts, alive):
                r.batcher.n_outstanding, r.alive = int(n), bool(a)
        for size in (16, 32):
            try:
                want = jr._pick(size).index
            except RuntimeError as e:
                with pytest.raises(RuntimeError, match=str(e)):
                    tr._pick(size)
                continue
            assert tr._pick(size).index == want, (step, size)


def test_shed_reasons_and_dispatch_match_jax(clock):
    buckets = [(16, 32), (16, 32)]
    (jr, jrep, jlog), (tr, trep, tlog) = _pair(buckets, queue_bound=6, slo_p95_ms=40.0)
    rng = np.random.default_rng(1)
    outcomes = ([], [])
    for step in range(300):
        clock.t += float(rng.uniform(0.0, 0.8))
        queue16, queue32 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        latency = float(rng.gamma(2.0, 15.0))
        outstanding = rng.integers(0, 5, 2)
        for out, router, reps in ((outcomes[0], jr, jrep), (outcomes[1], tr, trep)):
            for r, n in zip(reps, outstanding):
                r.batcher.queue = {16: queue16 // 2, 32: queue32}
                r.batcher.n_outstanding = int(n)
                r.batcher.latency_ms = latency
            try:
                router.submit(np.zeros((16, 16, 3), np.uint8), deadline_ms=5.0)
                out.append(("admitted",))
            except (JR.LoadShedError, TR.LoadShedError) as e:
                out.append((type(e).__name__, e.reason, e.detail, str(e)))
            out.append(router.shed_reason())
    assert outcomes[0] == outcomes[1]
    assert {o[1] for o in outcomes[1] if o and o[0] == "LoadShedError"} == {TR.SHED_QUEUE_BOUND, TR.SHED_P95_SLO}
    assert jlog == tlog
    assert jr.shed_counts() == tr.shed_counts()
    assert jr.refresh_gauges() == tr.refresh_gauges()
    assert jr.rolling.percentile(95.0) == tr.rolling.percentile(95.0)


def test_rolling_percentiles_match_jax_across_rotations(clock):
    jp, tp = JR.RollingPercentiles(window_s=5.0, capacity=64), TR.RollingPercentiles(window_s=5.0, capacity=64)
    rng = np.random.default_rng(2)
    for step in range(400):
        clock.t += float(rng.exponential(0.1))
        v = float(rng.lognormal(2.0, 1.0))
        jp.add(v)
        tp.add(v)
        if step % 7 == 0:
            for q in (0.0, 50.0, 95.0, 99.0, 100.0):
                assert tp.percentile(q) == jp.percentile(q), (step, q)
            assert tp.count() == jp.count()
    clock.t += 100.0  # a rotation per read, once a window has passed
    assert tp.percentile(95.0) == jp.percentile(95.0) is not None
    clock.t += 100.0  # two rotations later, every window is empty
    assert tp.percentile(95.0) is None and jp.percentile(95.0) is None and tp.count() == 0
    with pytest.raises(ValueError):
        TR.RollingPercentiles(window_s=0.0)


def test_p95_probe_arms_at_min_samples(clock):
    (jr, _, _), (tr, _, _) = _pair([(16,)], slo_p95_ms=50.0)
    assert TR.MIN_SHED_SAMPLES == JR.MIN_SHED_SAMPLES
    for router in (jr, tr):
        for _ in range(TR.MIN_SHED_SAMPLES - 1):
            router.rolling.add(500.0)
    assert jr.shed_reason() is None and tr.shed_reason() is None
    jr.rolling.add(500.0)
    tr.rolling.add(500.0)
    assert tr.shed_reason() == jr.shed_reason() == (TR.SHED_P95_SLO, "rolling p95 500.0 ms > SLO 50.0 ms")


def test_kill_replica_reroutes_original_futures_like_jax(clock):
    buckets = [(16, 32), (16,), (32,)]
    results = []
    for mod in (JR, TR):
        reps, log = _replicas(buckets)
        router = mod.FleetRouter(reps, _config())
        drained = [_Request(16), _Request(32), _Request(16), _Request(32)]
        reps[0].batcher.drained = drained
        reps[1].batcher.n_outstanding, reps[2].batcher.n_outstanding = 1, 0
        out = router.kill_replica(0)
        assert out == {"rerouted": 4, "failed": 0, "already_dead": False}
        assert [e[1] for e in log if e[0] == "resubmit"] == [id(r) for r in drained]  # the objects themselves
        again = router.kill_replica(0)
        # With no survivor for bucket 32, its drained request fails loudly.
        reps[2].batcher.drained = [_Request(32), _Request(16)]
        lost = router.kill_replica(1)
        reps[1].batcher.drained = []
        last = router.kill_replica(2)
        results.append((out, again, lost, last, [d.future.done() for d in reps[2].batcher.drained]))
    assert results[0] == results[1]
    assert results[1][3] == {"rerouted": 0, "failed": 2, "already_dead": False}


def test_kill_replica_on_real_batchers_drops_nothing():
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

    class SlowEngine:
        serve_config = ServeConfig(bucket_sizes=(16, 32), max_batch=4, max_delay_ms=5.0, tile_overlap=4)
        bucket_sizes = (16, 32)
        max_batch = 4

        def predict_bucket(self, variables, images_u8):
            time.sleep(0.05)
            return np.full(images_u8.shape[:3] + (1,), variables, np.float32)

    engine = SlowEngine()
    reps = [types.SimpleNamespace(index=i, alive=True, batcher=MicroBatcher(engine, StaticWeights(float(i))))
            for i in range(2)]
    router = TR.FleetRouter(reps, engine.serve_config)
    try:
        futures = [router.submit(np.zeros((16, 16, 3), np.uint8)) for _ in range(24)]
        out = router.kill_replica(1)
        results = [f.result(timeout=60) for f in futures]
        assert len(results) == 24 and out["failed"] == 0 and out["rerouted"] > 0
        assert router.stats()["live"] == 1
        assert router.submit(np.zeros((32, 32, 3), np.uint8)).result(timeout=60).probs.shape == (32, 32, 1)
    finally:
        for r in reps:
            r.batcher.close()


def test_shadow_mirror_sees_admitted_requests_and_never_fails_one(clock, caplog):
    class Mirror:
        def __init__(self, fail=False):
            self.seen, self.fail = [], fail

        def observe(self, image_u8):
            self.seen.append(image_u8.shape[0])
            if self.fail:
                raise ValueError("shadow lane down")

    (jr, jrep, jlog), (tr, trep, tlog) = _pair([(16, 32)], queue_bound=2)
    mirrors = []
    for router, reps in ((jr, jrep), (tr, trep)):
        mirror = Mirror()
        router.attach_shadow(mirror)
        router.submit(np.zeros((16, 16, 3), np.uint8))
        router.submit(np.zeros((32, 32, 3), np.uint8))
        reps[0].batcher.queue = {16: 2, 32: 0}  # the queue bound sheds the next one
        with pytest.raises((JR.LoadShedError, TR.LoadShedError)):
            router.submit(np.zeros((16, 16, 3), np.uint8))
        reps[0].batcher.queue = {16: 0, 32: 0}
        failing = Mirror(fail=True)
        router.attach_shadow(failing)  # attach replaces
        fut = router.submit(np.zeros((32, 32, 3), np.uint8))
        assert fut.result(timeout=1).latency_ms == 1.0
        mirrors.append((mirror.seen, failing.seen))
    assert mirrors[0] == mirrors[1] == ([16, 32], [32])
    assert jlog == tlog
    assert any("shadow mirror failed" in r.getMessage() and r.exc_info for r in caplog.records)
