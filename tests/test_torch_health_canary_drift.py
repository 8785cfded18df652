"""The port's canary evaluator (``health/canary.py``) and drift monitor
(``health/drift.py``) held against the JAX package's on the CPU.

- ``psi`` equals the JAX function on seeded count vectors and agrees with
  its closed form; a PSI of a profile with itself is 0.
- ``DriftMonitor``: profiles, comparisons, ``write_drift_json`` bytes and
  the ``serve_drift_psi_ratio`` gauges equal the JAX monitor's on the same
  (images, probabilities), crack_fraction included; ``capture_reference``
  through an engine stand-in gives the JAX profile.
- ``CanaryEvaluator`` on a fake engine: the JAX records (reference, same
  masks, a cliff), gauge and audit. On tiny CPU engines of both packages
  with the same weights: a reference, a re-install and a regression; the
  records agree within chip_smoke phase 15's flip bound (a per-bucket IoU
  may move only by the probe pixels within the two engines' largest
  probability distance of 0.5).
- A raising canary never fails or blocks an install of the port's
  ``ModelVersionManager`` or ``FleetVersionManager``; a stale install
  never reaches it.
"""

import json
import math
import types

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

import chip_smoke

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("seed", range(4))
def test_psi_matches_jax(seed):
    from fedcrack_tpu.health.drift import psi as jax_psi
    from fedcrack_tpu_torch.health.drift import psi

    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 50, 10), rng.integers(0, 50, 10)
    a[rng.integers(0, 10)] = 0
    assert psi(a, b) == jax_psi(a, b)
    assert psi(a, a) == 0.0
    assert psi(a, b, eps=1e-2) == jax_psi(a, b, eps=1e-2)


def test_psi_closed_form():
    from fedcrack_tpu_torch.health.drift import psi

    ref, cur = np.array([0.5, 0.5]), np.array([0.9, 0.1])
    expected = (0.9 - 0.5) * math.log(0.9 / 0.5) + (0.1 - 0.5) * math.log(0.1 / 0.5)
    assert psi(ref, cur) == pytest.approx(expected, rel=1e-2)
    assert psi(ref, cur) == psi(cur, ref)
    with pytest.raises(ValueError):
        psi(np.ones(3), np.ones(4))
    assert math.isfinite(psi(np.array([1.0, 0.0]), np.array([0.0, 1.0])))


def _traffic(seed: int):
    """Seeded (images, probabilities) batches at two sizes, with crack
    blobs in the probabilities so the crack_fraction signal moves."""
    rng = np.random.default_rng(seed)
    out = []
    for size, n in ((16, 3), (24, 2), (16, 1)):
        images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        probs = rng.random((n, size, size, 1)).astype(np.float32) ** (1 + seed)
        probs[:, 2:6, 3:9] = 0.97
        out.append((images, probs))
    out.append((out[0][0][0], out[0][1][0]))  # an unbatched [S, S, 3] request
    return out


def test_drift_monitor_profiles_comparisons_and_json_match_jax(tmp_path):
    from fedcrack_tpu.health import drift as jd
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from fedcrack_tpu_torch.health import drift as td
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry

    ref_t, ref_j = td.DriftMonitor(), jd.DriftMonitor()
    for images, probs in _traffic(0):
        ref_t.observe(images, probs)
        ref_j.observe(images, probs)
    assert ref_t.profile() == ref_j.profile()
    assert "crack_fraction" in ref_t.profile()["buckets"]["16"]["hist"]
    live_t, live_j = td.DriftMonitor(ref_t.profile()), jd.DriftMonitor(ref_j.profile())
    for images, probs in _traffic(1)[:2]:
        live_t.observe(images, probs)
        live_j.observe(images, probs)
    psis = live_t.compare()
    assert psis == live_j.compare() and set(psis) == {f"{s}/{k}" for s in (16, 24) for k in td.SIGNALS}
    assert psis["16/confidence"] > 0 and live_t.compare({}) == {}
    for mod, mon, path in ((td, live_t, tmp_path / "port.json"), (jd, live_j, tmp_path / "jax.json")):
        mod.write_drift_json(str(path), reference=mon.reference, current=mon.profile(), psis=mon.compare())
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    for mod in (td, jd):
        mod.write_drift_json(str(tmp_path / f"{mod.__name__}.json"), reference=None, current=None, psis=None)
    assert (tmp_path / "fedcrack_tpu_torch.health.drift.json").read_bytes() == \
        (tmp_path / "fedcrack_tpu.health.drift.json").read_bytes()
    reg, jreg = MetricsRegistry(), JaxRegistry()
    td.export_drift_metrics(psis, registry=reg)
    jd.export_drift_metrics(psis, registry=jreg)
    assert reg.exposition() == jreg.exposition()


class _ProbeEngine:
    """An engine stand-in whose probabilities are a seeded function of the
    probe batch and the weights (a float level)."""

    bucket_sizes = (16, 24)
    max_batch = 3
    serve_config = types.SimpleNamespace(quant_probe_batch=4, quant_probe_seed=2)

    def predict_bucket(self, level, images_u8):
        x = images_u8.astype(np.float32).mean(axis=-1, keepdims=True) / 255.0
        return np.clip(x * float(level), 0.0, 1.0)


def test_capture_reference_matches_jax():
    from fedcrack_tpu.health.drift import DriftMonitor as JaxMonitor
    from fedcrack_tpu_torch.health.drift import DriftMonitor

    engine = _ProbeEngine()
    assert DriftMonitor.capture_reference(engine, 1.3) == JaxMonitor.capture_reference(engine, 1.3)
    assert DriftMonitor.capture_reference(engine, 1.3, n=2, seed=5) == \
        JaxMonitor.capture_reference(engine, 1.3, n=2, seed=5)


class _LevelEngine:
    """The JAX canary test's engine: every probe pixel equals the weights'
    level."""

    bucket_sizes = (8,)
    max_batch = 2
    serve_config = types.SimpleNamespace(quant_probe_batch=2, quant_probe_seed=0)

    def predict_bucket(self, level, images_u8):
        return np.full((images_u8.shape[0],) + images_u8.shape[1:3], float(level), np.float32)


def test_canary_reference_then_regression_matches_jax():
    from fedcrack_tpu.health.canary import CanaryEvaluator as JaxCanary
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry

    reg, jreg = MetricsRegistry(), JaxRegistry()
    canary, jcanary = CanaryEvaluator(_LevelEngine(), registry=reg), JaxCanary(_LevelEngine(), registry=jreg)
    for version, level in ((0, 0.8), (1, 0.9), (2, 0.2)):
        assert canary.evaluate(version, level) == jcanary.evaluate(version, level)
    assert canary.history == jcanary.history
    assert [h["iou"] for h in canary.history] == [1.0, 1.0, 0.0]
    assert canary.audit() == jcanary.audit() and canary.audit()["min_iou"] == 0.0
    assert reg.values()["model_canary_iou_ratio"] == jreg.values()["model_canary_iou_ratio"]


def test_canary_on_cpu_engines_matches_jax_within_the_flip_bound():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.health.canary import CanaryEvaluator as JaxCanary
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    kw = dict(bucket_sizes=(16, 32), max_batch=4, tile_overlap=4)
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**kw), device="cpu")
    jengine = JaxEngine(jax_config(TINY_KW), JaxServeConfig(**kw))
    var = {0: jax_variables(TINY_KW, seed=0), 2: jax_variables(TINY_KW, seed=1)}
    var[1] = var[0]
    canary, jcanary = CanaryEvaluator(engine, registry=MetricsRegistry()), JaxCanary(jengine, registry=JaxRegistry())
    payloads = {v: engine.prepare(w) for v, w in var.items()}
    jpayloads = {v: jengine.prepare(w) for v, w in var.items()}
    for v in (0, 1, 2):
        got, want = canary.evaluate(v, payloads[v]), jcanary.evaluate(v, jpayloads[v])
        assert {k: got[k] for k in ("version", "reference_version", "probe_batch", "probe_seed")} == \
            {k: want[k] for k in ("version", "reference_version", "probe_batch", "probe_seed")}
    assert canary.history[1]["iou"] == jcanary.history[1]["iou"] == 1.0
    # The regression, held to the bound on both engines' probe probabilities.
    names = {"prod": 0, "cand": 2}
    probes = chip_smoke.probe_probs(engine, {n: payloads[v] for n, v in names.items()})
    jprobes = {size: (batch, {n: np.asarray(jengine.predict_bucket(jpayloads[v], batch)) for n, v in names.items()})
               for size, (batch, _) in probes.items()}
    got, want = (chip_smoke.verdict_numbers(p, "prod", "cand") for p in (probes, jprobes))
    assert {k: round(v, 6) for k, v in got["per_bucket"].items()} == \
        {int(k): v for k, v in canary.history[2]["per_bucket"].items()}
    assert got["iou"] == canary.history[2]["iou"] and want["iou"] == jcanary.history[2]["iou"]
    bound = chip_smoke.check_flip_bound("canary", jprobes, probes, want, got, "prod", "cand")
    assert bound["max_prob_distance"] < 1e-4
    assert canary.audit()["evals"] == 3 and canary.audit()["all_finite_unit"]


class _Boom:
    def __init__(self):
        self.calls = []

    def evaluate(self, version, device_variables):
        self.calls.append(version)
        raise RuntimeError("canary exploded")


def test_raising_canary_never_blocks_either_manager():
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import FleetVersionManager, Replica
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    cfg = ServeConfig(bucket_sizes=(16,), max_batch=2, max_delay_ms=30.0, tile_overlap=4)
    engine = InferenceEngine(port_config(TINY_KW), cfg, device="cpu")
    v0 = jax_variables(TINY_KW, seed=0)
    boom = _Boom()
    mgr = ModelVersionManager(engine, v0, canary=boom)
    assert mgr.install(1, v0) is True and mgr.version == 1
    assert mgr.install(1, v0) is False  # a stale version never reaches the canary
    assert boom.calls == [1]

    fboom = _Boom()
    fleet_mgr = FleetVersionManager(cfg, canary=fboom)
    replicas = [Replica(0, engine, fleet_mgr)]
    fleet_mgr.attach_replicas(replicas, v0)
    try:
        assert fleet_mgr.install(4, v0) is True and fleet_mgr.version == 4
        assert fleet_mgr.install(3, v0) is False
        assert fleet_mgr.slot_versions() == [4] and fboom.calls == [4]
        fut = replicas[0].batcher.submit(np.zeros((16, 16, 3), np.uint8))
        assert fut.result(timeout=60).model_version == 4
    finally:
        replicas[0].batcher.close()


def test_canary_history_is_capped_and_logged():
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry

    logged = []
    metrics = types.SimpleNamespace(log=lambda kind, **rec: logged.append((kind, json.dumps(rec, sort_keys=True))))
    canary = CanaryEvaluator(_LevelEngine(), registry=MetricsRegistry(), history_cap=2, metrics=metrics)
    for v in range(4):
        canary.evaluate(v, 0.9 if v % 2 else 0.1)
    assert [h["version"] for h in canary.history] == [2, 3] and canary.reference_version == 0
    assert [k for k, _ in logged] == ["canary_eval"] * 4 and canary.last == canary.history[-1]
