"""The port's fleet autoscaler (``serve/autoscaler.py``) held against the
JAX package's on the CPU: the autoscaler cases of tests/test_elastic.py,
each run through both packages with the same fleet script and an injected
clock. Decisions and audits are equal (host logic: exact).

- Construction refuses a disarmed band.
- Queue pressure scales up; the cooldown blocks the next action; the p95
  trigger fires without queue depth; only ``scale_down_idle_evals``
  consecutive calm evaluations drain the newest replica, a gust resetting
  the count.
- At ``max_replicas`` the fleet never grows.
- The production signal path reads the registry's own exposition.
- Shedding is the backstop: a paced burst sheds on a static fleet and not
  on the autoscaled one, which grows first.
"""

import time

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

KW = dict(TINY_KW, img_size=16)
BUCKETS = (16,)


def _serve_kw(**over):
    kw = dict(bucket_sizes=BUCKETS, max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def stack():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    return {
        "var0": jax_variables(KW, seed=0),
        "engine": InferenceEngine(port_config(KW), ServeConfig(**_serve_kw()), device="cpu"),
        "jax_engine": JaxEngine(jax_config(KW), JaxServeConfig(**_serve_kw())),
    }


def _fleets(stack, **over):
    """A port and a JAX fleet on the same config and weights."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.fleet import ServeFleet as JaxFleet
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet

    port = ServeFleet(port_config(KW), ServeConfig(**_serve_kw(**over)), stack["var0"],
                      shared_engine=stack["engine"], warmup=False)
    ref = JaxFleet(jax_config(KW), JaxServeConfig(**_serve_kw(**over)), stack["var0"],
                   shared_engine=stack["jax_engine"], warmup=False)
    return port, ref


def _parsed(live, p95_s, queued_by_bucket):
    """A synthetic parse_prometheus_text result (tests/test_elastic.py's)."""
    return {
        "serve_fleet_replicas": {"type": "gauge", "help": "", "samples": {(): float(live)}},
        "serve_rolling_p95_seconds": {"type": "gauge", "help": "", "samples": {(): float(p95_s)}},
        "serve_router_queue_depth_total": {
            "type": "gauge", "help": "",
            "samples": {(("bucket", str(b)),): float(n) for b, n in queued_by_bucket.items()},
        },
    }


def _run_script(stack, script, **over):
    """``script``: (clock advance, parsed signals) pairs through a port and
    a JAX autoscaler; returns both decision lists, audits and live sets."""
    from fedcrack_tpu.serve.autoscaler import FleetAutoscaler as JaxAutoscaler
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler

    port, ref = _fleets(stack, **over)
    out = []
    try:
        for fleet, cls in ((port, FleetAutoscaler), (ref, JaxAutoscaler)):
            now = [1000.0]
            auto = cls(fleet, clock=lambda: now[0])
            decisions = []
            for advance, parsed in script:
                now[0] += advance
                decisions.append(auto.evaluate(parsed))
            out.append((decisions, auto.audit(), [r.alive for r in fleet.router.replicas]))
    finally:
        port.close()
        ref.close()
    return out


def test_autoscaler_requires_armed_band(stack):
    from fedcrack_tpu.serve.autoscaler import FleetAutoscaler as JaxAutoscaler
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler

    port, ref = _fleets(stack, replicas=1)
    try:
        with pytest.raises(ValueError, match="armed band"):
            FleetAutoscaler(port)
        with pytest.raises(ValueError, match="armed band"):
            JaxAutoscaler(ref)
    finally:
        port.close()
        ref.close()


def test_scale_up_cooldown_p95_and_calm_scale_down_match_jax(stack):
    from fedcrack_tpu_torch.serve.autoscaler import SCALE_DOWN, SCALE_UP

    pressure, live3 = _parsed(1, 0.0, {16: 5}), _parsed(3, 0.0, {16: 0})
    script = [
        (0.0, pressure),                         # scale up
        (1.0, pressure),                         # cooldown
        (10.0, _parsed(2, 0.190, {16: 0})),      # the p95 trigger
        (10.0, live3), (0.5, _parsed(3, 0.0, {16: 2})), (0.5, live3), (0.5, live3),
        (0.5, live3),                            # three calm in a row: scale down
        (0.5, live3),                            # cooldown again
        (20.0, _parsed(2, 0.050, {16: 0})),      # p95 inside the band: steady
        (1.0, _parsed(2, 0.0, {16: 8})),         # queue pressure at 2 live: 4 per replica
    ]
    (got, audit, alive), (want, jaudit, jalive) = _run_script(
        stack, script, replicas=1, min_replicas=1, max_replicas=3, scale_cooldown_s=10.0,
        scale_up_queue_depth=4, scale_down_idle_evals=3, slo_p95_ms=200.0)
    assert got == want
    assert audit == jaudit and alive == jalive
    assert [d["action"] for d in got] == [SCALE_UP, None, SCALE_UP, None, None, None, None, SCALE_DOWN, None,
                                          None, SCALE_UP]
    assert got[1]["reason"] == "cooldown" and "p95" in got[2]["reason"] and got[7]["replica"] == 2
    assert audit["scale_ups"] == 3 and audit["scale_downs"] == 1 and audit["replica_seconds"] > 0
    assert alive == [True, True, False, True]


def test_at_max_replicas_never_grows(stack):
    (got, audit, alive), (want, jaudit, jalive) = _run_script(
        stack, [(0.0, _parsed(2, 0.0, {16: 99})), (100.0, _parsed(2, 0.0, {16: 99}))],
        replicas=2, min_replicas=1, max_replicas=2)
    assert got == want and audit == jaudit and alive == jalive == [True, True]
    assert got[0]["action"] is None and got[0]["reason"].startswith("at max_replicas: ")


def test_autoscaler_reads_its_own_exposition(stack):
    from fedcrack_tpu.serve.autoscaler import FleetAutoscaler as JaxAutoscaler
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler

    port, ref = _fleets(stack, replicas=2, min_replicas=1, max_replicas=2)
    try:
        sig, jsig = FleetAutoscaler(port).read_signals(), JaxAutoscaler(ref).read_signals()
        assert sig == jsig == {"live": 2, "p95_ms": 0.0, "queued": 0}
    finally:
        port.close()
        ref.close()


def test_shed_is_the_backstop_static_sheds_autoscaled_does_not(stack):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.router import LoadShedError

    class SlowBatches(InferenceEngine):
        """Every batch takes 60 ms of wall time and no CPU, so the test
        measures the control loop, not the host's load; a scale-up warms
        at once, as a warm program does."""

        def predict_bucket(self, variables, images_u8):
            time.sleep(0.06)
            return np.zeros(images_u8.shape[:3] + (1,), np.float32)

        def warmup(self, variables):
            pass

    engine = SlowBatches(port_config(KW), ServeConfig(**_serve_kw()), device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(40)]

    def paced_burst(fleet):
        sheds, futures = 0, []
        for img in images:
            try:
                futures.append(fleet.submit(img))
            except LoadShedError:
                sheds += 1
            time.sleep(0.01)
        return sheds, len([f.result(timeout=60) for f in futures])

    def fleet(**over):
        return ServeFleet(port_config(KW), ServeConfig(**_serve_kw(replicas=1, queue_bound=6, **over)),
                          stack["var0"], shared_engine=engine, warmup=False)

    static = fleet()
    try:
        static_sheds, static_done = paced_burst(static)
    finally:
        static.close()
    assert static_sheds > 0 and static_done == 40 - static_sheds
    elastic = fleet(min_replicas=1, max_replicas=3, scale_interval_s=0.01, scale_cooldown_s=0.05,
                    scale_up_queue_depth=2)
    auto = FleetAutoscaler(elastic)
    auto.start()
    try:
        elastic_sheds, elastic_done = paced_burst(elastic)
    finally:
        auto.stop()
        elastic.close()
    assert elastic_sheds == 0 and elastic_done == 40
    assert auto.audit()["scale_ups"] >= 1
