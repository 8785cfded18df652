"""The port's shadow-lane progressive delivery (``serve/shadow.py``) on the
CPU, mirroring the JAX package's shadow tests (tests/test_elastic.py) at
the same tiny model, and held against the JAX controller.

- No wire path from the shadow lane to a client: while a candidate with
  other weights is staged under live traffic, every production answer
  carries the production version, the lane is never one of the router's
  replicas, and it is torn down with the verdict.
- Promote is the two-phase fleet commit: a re-publish of the production
  weights (IoU 1.0, PSI 0) installs on every replica.
- Rollback never installs and is remembered: ``poll_once`` skips the
  rejected version on the statefile and stages the next one.
- ``ShadowMirror``: the count-based stride, and a dead lane's failures
  counted and swallowed.
- The verdict records of a script (a re-publish, zeroed weights, other
  weights) equal the JAX ``ShadowController``'s on the same weights, the
  IoU and PSI within chip_smoke phase 15's flip bound of the two engines'
  probe probabilities.
- ``python -m fedcrack_tpu_torch.serve --shadow-fraction 0.5`` is in
  tests/test_torch_serve_cli.py.
"""

import threading

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

import chip_smoke

pytestmark = pytest.mark.torch_port

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
        "var0": jax_variables(TINY_KW, seed=0),
        "var1": jax_variables(TINY_KW, seed=1),
        "engine": InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw()), device="cpu"),
        "jax_engine": JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw())),
    }


def _fleet(stack, state_path=None, **over):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.fleet import ServeFleet

    return ServeFleet(port_config(TINY_KW), ServeConfig(**_serve_kw(**over)), stack["var0"],
                      shared_engine=stack["engine"], warmup=False, state_path=state_path)


def _production(fleet):
    """Production's payload on replica 0, as the controller reads it."""
    return fleet.manager.snapshot_for(0)[1]


def _img(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (16, 16, 3), dtype=np.uint8)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def _pump(fleet, versions, errors, stop):
    i = 0
    while not stop.is_set():
        try:
            versions.append(fleet.submit(_img(seed=i)).result(timeout=60).model_version)
        except Exception as e:  # surfaced by the test's assert
            errors.append(e)
        i += 1


def test_shadow_isolation_no_wire_path_to_clients(stack):
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    fleet = _fleet(stack, replicas=1, shadow_fraction=1.0, shadow_min_samples=2)
    ctrl = ShadowController(fleet)
    versions, errors, stop = [], [], threading.Event()
    t = threading.Thread(target=_pump, args=(fleet, versions, errors, stop), daemon=True)
    t.start()
    try:
        record = ctrl.stage(7, stack["var1"], wait_s=10.0)
    finally:
        stop.set()
        t.join(timeout=30)
        fleet.close()
    assert not errors
    assert versions and set(versions) == {0}
    assert len(fleet.router.replicas) == 1
    assert fleet.router._shadow is None
    assert record["completed"] >= 2 and record["shadow_failures"] == 0
    assert record["shadow_p95_ms"] is not None and record["latency_factor"] is not None


def test_shadow_promote_installs_fleet_wide(stack):
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    fleet = _fleet(stack, replicas=2, shadow_fraction=1.0, shadow_min_samples=2)
    ctrl = ShadowController(fleet)
    versions, errors, stop = [], [], threading.Event()
    t = threading.Thread(target=_pump, args=(fleet, versions, errors, stop), daemon=True)
    t.start()
    try:
        record = ctrl.stage(1, stack["var0"], wait_s=10.0)
    finally:
        stop.set()
        t.join(timeout=30)
    try:
        assert not errors
        assert record["verdict"] == "promote" and record["installed"]
        assert record["reasons"] == [] and record["iou"] == 1.0 and record["psi_max"] == 0.0
        assert fleet.manager.version == 1 and fleet.manager.slot_versions() == [1, 1]
        assert fleet.submit(_img()).result(timeout=60).model_version == 1
        assert ctrl.audit()["promoted"] == 1 and ctrl.audit()["staged"] == 1
    finally:
        fleet.close()


def test_shadow_rollback_never_installs_and_is_remembered(stack, tmp_path):
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    state = str(tmp_path / "state.bin")
    fleet = _fleet(stack, state_path=state, replicas=1, shadow_fraction=1.0, shadow_min_samples=2)
    ctrl = ShadowController(fleet)
    try:
        publish_statefile(state, _zeros(stack["var0"]), model_version=5)
        record = ctrl.poll_once()
        assert record["verdict"] == "rollback" and not record["installed"]
        assert record["iou"] < ctrl.cfg.shadow_iou_floor
        assert record["psi_max"] > ctrl.cfg.shadow_psi_ceiling
        assert any(r.startswith("canary iou") for r in record["reasons"])
        assert fleet.manager.version == 0 and 5 in ctrl._rejected
        assert ctrl.poll_once() is None  # never staged again
        publish_statefile(state, stack["var0"], model_version=6)
        assert ctrl.poll_once()["version"] == 6
        audit = ctrl.audit()
        assert (audit["staged"], audit["rolled_back"]) == (2, 2)  # v6: no traffic mirrored
        assert fleet.manager.version == 0
    finally:
        fleet.close()


def test_shadow_mirror_sampling_stride_and_failure_containment(stack):
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights
    from fedcrack_tpu_torch.serve.shadow import ShadowMirror

    engine = stack["engine"]
    batcher = MicroBatcher(engine, StaticWeights(engine.prepare(stack["var0"]), 3))
    mirror = ShadowMirror(batcher, 0.25)
    assert mirror.stride == 4
    try:
        for i in range(8):
            mirror.observe(_img(seed=i))
        snap = mirror.snapshot()
        assert snap["seen"] == 8 and snap["mirrored"] == 2
    finally:
        batcher.close()
    dead = ShadowMirror(batcher, 1.0)  # a closed lane: submit raises
    dead.observe(_img())
    dead.observe(_img())
    assert dead.snapshot()["failures"] == 2 and dead.completed() == 0
    with pytest.raises(ValueError):
        ShadowMirror(batcher, 0.0)


def test_controller_needs_a_shadow_fraction(stack):
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    fleet = _fleet(stack, replicas=1)
    try:
        with pytest.raises(ValueError, match="shadow_fraction > 0"):
            ShadowController(fleet)
    finally:
        fleet.close()


def test_verdicts_match_the_jax_controller(stack):
    """The same script through both controllers, no traffic: equal verdicts,
    reasons and record keys; IoU and PSI within the flip bound."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.fleet import ServeFleet as JaxFleet
    from fedcrack_tpu.serve.shadow import ShadowController as JaxController
    from fedcrack_tpu_torch.serve.shadow import ShadowController

    over = dict(replicas=1, shadow_fraction=0.5, shadow_min_samples=1)
    fleet = _fleet(stack, **over)
    jfleet = JaxFleet(jax_config(TINY_KW), JaxServeConfig(**_serve_kw(**over)), stack["var0"],
                      shared_engine=stack["jax_engine"], warmup=False)
    ctrl, jctrl = ShadowController(fleet), JaxController(jfleet)
    script = [(1, stack["var0"]), (5, _zeros(stack["var0"])), (7, stack["var1"])]
    try:
        for version, var in script:
            got, want = ctrl.stage(version, var, wait_s=0.05), jctrl.stage(version, var, wait_s=0.05)
            assert set(got) == set(want)
            same = ("version", "baseline_version", "verdict", "iou_floor", "psi_ceiling", "latency_ceiling",
                    "mirrored", "completed", "shadow_failures", "installed", "latency_factor", "shadow_p95_ms",
                    "trace")
            assert {k: got[k] for k in same} == {k: want[k] for k in same}, version
            assert [r.split(" ")[0:2] for r in got["reasons"]] == [r.split(" ")[0:2] for r in want["reasons"]]
            names = {"prod": (_production(fleet), _production(jfleet)),
                     "cand": (stack["engine"].prepare(var), stack["jax_engine"].prepare(var))}
            probes = chip_smoke.probe_probs(stack["engine"], {n: w[0] for n, w in names.items()})
            jprobes = {size: (batch, {n: np.asarray(stack["jax_engine"].predict_bucket(w[1], batch))
                                      for n, w in names.items()})
                       for size, (batch, _) in probes.items()}
            chip_smoke.check_flip_bound(f"v{version}", jprobes, probes,
                                        {"per_bucket": {s: want["iou"] for s in BUCKETS}, "psi": want["psi"]},
                                        {"per_bucket": {s: got["iou"] for s in BUCKETS}, "psi": got["psi"]},
                                        "prod", "cand")
        assert [v["verdict"] for v in ctrl.verdicts] == ["rollback", "rollback", "rollback"]
        assert ctrl.verdicts[0]["iou"] == 1.0 and ctrl.verdicts[0]["psi_max"] == 0.0
        assert ctrl.audit()["rolled_back"] == jctrl.audit()["rolled_back"] == 3
    finally:
        fleet.close()
        jfleet.close()
