"""The statefile watcher of the port's serving plane
(``serve/hot_swap.py``) held against the JAX package's on the CPU.

- ``publish_statefile`` writes the JAX package's bytes;
  ``read_statefile_weights`` reads a statefile the JAX package's server
  wrote (and its ``publish_statefile``) to the same version and bitwise
  the same weights, and gives None where the JAX reader does.
- ``ModelVersionManager(state_path=...)``: ``poll_once`` installs a newer
  version on a CPU engine (``fused_int8``, plain kernels), never regresses,
  survives a corrupt file; the poll thread installs a live publish; the
  served program equals a cold install of the same weights bitwise.
- The install's quant gate passes and refuses exactly where the JAX
  package's fleet manager (its install-time gate) does on the same
  weights and floor.
- ``WeightSourceWatcher`` over a statefile and a checkpoint directory
  picks the version and weights the JAX watcher picks over the same
  publishes (each package's checkpoints written by its own
  checkpointer); ``ModelVersionManager(ckpt_dir=...)`` installs the
  newest checkpoint as a cold install of it would serve.
"""

import os
import threading
import time

import numpy as np
import pytest

from fedcrack_tpu.ckpt import statefile as JS
from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu.serve import hot_swap as JH
from fedcrack_tpu_torch.ckpt import statefile as TS
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.serve import hot_swap as TH
from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKET = 32


def _serve_kw(**over):
    kw = dict(bucket_sizes=(BUCKET,), max_batch=4, max_delay_ms=10.0, tile_overlap=4, quant="int8")
    kw.update(over)
    return kw


def _engine(**over):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw(kernel_plane="fused_int8", **over)),
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    return jax_variables(TINY_KW, seed=0), jax_variables(TINY_KW, seed=1)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, BUCKET, BUCKET, 3), dtype=np.uint8)


def _leaves_equal(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(np.asarray(x).tobytes() == np.asarray(y).tobytes() for x, y in zip(la, lb))


@pytest.mark.parametrize("version", [0, 7, 300, 70000])
def test_publish_statefile_bytes_equal_jax(tmp_path, weights, version):
    var = weights[0]
    paths = [str(tmp_path / f"{who}.msgpack") for who in ("port", "jax", "port_blob")]
    TH.publish_statefile(paths[0], var, model_version=version)
    JH.publish_statefile(paths[1], var, model_version=version)
    TH.publish_statefile(paths[2], model_version=version, blob=jser.tree_to_bytes(var))
    got = [open(p, "rb").read() for p in paths]
    assert got[0] == got[1] == got[2]


def test_read_statefile_weights_on_jax_written_files(tmp_path, weights):
    var0, var1 = weights
    # A JAX server's statefile one round in, and the JAX harness's publish.
    state = JR.initial_state(JaxFedConfig(max_rounds=2, cohort_size=1), var0)
    state, _ = JR.transition(state, JR.Ready(cname="a", now=0.0))
    state, rep = JR.transition(state, JR.TrainDone(cname="a", round=1, blob=jser.tree_to_bytes(var1),
                                                   num_samples=4, now=1.0))
    assert rep.status == JR.RESP_ARY
    server_file, published = str(tmp_path / "server.msgpack"), str(tmp_path / "published.msgpack")
    JS.save_state_file(server_file, state)
    JH.publish_statefile(published, var1, model_version=12)
    for path, version in ((server_file, 1), (published, 12)):
        for template in (None, var0):
            got = TH.read_statefile_weights(path, template=template)
            want = JH.read_statefile_weights(path, template=template)
            assert got[0] == want[0] == version
            assert _leaves_equal(got[1], want[1]) and _leaves_equal(got[1], var1)


@pytest.mark.parametrize("content", [None, b"", b"\x00garbage", b"\x81\xa6format\x02"])
def test_unreadable_statefile_reads_as_none_in_both(tmp_path, content):
    path = tmp_path / "state.msgpack"
    if content is not None:
        path.write_bytes(content)
    assert TH.read_statefile_weights(str(path)) is None
    assert JH.read_statefile_weights(str(path)) is None


def test_poll_once_installs_newer_versions_only(tmp_path, weights):
    from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload

    var0, var1 = weights
    engine = _engine()
    path = str(tmp_path / "server_state.msgpack")
    mgr = TH.ModelVersionManager(engine, var0, initial_version=5, state_path=path, template=var0)
    assert mgr.poll_once() is False  # no file yet
    TH.publish_statefile(path, var1, model_version=3)
    assert mgr.poll_once() is False and mgr.version == 5  # older: never regress
    TH.publish_statefile(path, var1, model_version=9)
    assert mgr.poll_once() is True and mgr.version == 9
    assert mgr.poll_once() is False
    assert mgr.last_swap["to_version"] == 9 and mgr.last_quant_gate["passed"]
    imgs = _images(2, 11)
    cold, _ = prepare_gated_payload(engine, var1, engine.serve_config)
    np.testing.assert_array_equal(engine.predict_bucket(mgr.snapshot()[1], imgs), engine.predict_bucket(cold, imgs))
    assert mgr.swap_context(9) == "fedtr-v8#swap:v9" and mgr.swap_context(5) is None
    with open(path, "wb") as f:
        f.write(b"\x00 not a statefile")
    assert mgr.poll_once() is False and mgr.version == 9
    mgr.stop()


def test_poll_thread_installs_a_live_publish(tmp_path, weights):
    var0, var1 = weights
    path = str(tmp_path / "state.msgpack")
    mgr = TH.ModelVersionManager(_engine(), var0, state_path=path, poll_s=0.05, template=var0)
    with mgr:
        TH.publish_statefile(path, var1, model_version=1)
        done = threading.Event()
        for _ in range(400):
            if mgr.version == 1:
                done.set()
                break
            threading.Event().wait(0.05)
        assert done.is_set(), "the poll thread never installed the published model"
    assert mgr.last_swap["to_version"] == 1 and mgr._thread is None


def test_poll_once_follows_a_buffered_federation_statefile(tmp_path, weights):
    """Each flush of an in-process buffered server, saved as its
    statefile, is the next version the watcher installs."""
    var0, var1 = weights
    cfg = FedConfig(max_rounds=2, cohort_size=2, registration_window_s=3600.0, mode="buffered", buffer_k=2,
                    staleness_alpha=0.5)
    path = str(tmp_path / "state.msgpack")
    mgr = TH.ModelVersionManager(_engine(), var0, state_path=path, template=var0)
    state = TR.initial_state(cfg, var0)
    now = 0.0
    for c in "ab":
        state, _ = TR.transition(state, TR.Ready(cname=c, now=now))
    for rnd in (1, 2):
        for c in "ab":
            now += 1.0
            state, _ = TR.transition(state, TR.PullWeights(cname=c, now=now))
        for c in "ab":
            now += 1.0
            state, _ = TR.transition(state, TR.TrainDone(cname=c, round=rnd, blob=jser.tree_to_bytes(var1),
                                                         num_samples=4, now=now))
        TS.save_state_file(path, state)
        assert mgr.poll_once() and mgr.version == state.model_version == rnd
    assert state.phase == TR.PHASE_FINISHED and os.path.exists(path)


@pytest.mark.parametrize("snapped,floor", [(True, 1.0), (False, 1.0), (False, 0.5)])
def test_gate_refuses_exactly_where_the_jax_fleet_gate_refuses(tmp_path, weights, snapped, floor):
    """The same weights through the port's statefile install and the JAX
    package's fleet install (its install-time gate). The seed-0 weights
    read a probe IoU of 0.996815 in both packages: refused at floor 1.0,
    passed at 0.5; snapped to the int8 grid they read 1.0 and pass."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve import ServeFleet
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.serve import quant as tq

    var0, var1 = weights
    if snapped:
        var0 = tq.dequantize_variables(tq.quantize_for_plane(var0, "fused_int8").tree)
    path = str(tmp_path / "state.msgpack")
    TH.publish_statefile(path, var0, model_version=1)
    mgr = TH.ModelVersionManager(_engine(quant_iou_floor=floor), var1, state_path=path, template=var1)
    assert mgr.poll_once()
    jcfg = JaxServeConfig(**_serve_kw(quant_iou_floor=floor, replicas=1))
    fleet = ServeFleet(jax_config(TINY_KW), jcfg, var1, shared_engine=JaxEngine(jax_config(TINY_KW), jcfg),
                       state_path=path, template=var1, warmup=False)
    try:
        assert fleet.manager.poll_once() and fleet.manager.version == 1
        want = fleet.manager.last_quant_gate
    finally:
        fleet.close()
    got = mgr.last_quant_gate
    assert got["passed"] == want["passed"] == (snapped or floor < 1.0)
    assert got["iou"] == want["iou"] == (1.0 if snapped else 0.996815)
    assert mgr.last_swap["quantized"] == got["passed"]
    assert isinstance(mgr.snapshot()[1], tq.QuantizedVariables) == got["passed"]


@pytest.mark.parametrize("state_version,ckpt_versions", [
    (None, ()), (None, (1, 4)), (3, (1, 4)), (4, (1, 4)), (6, (1, 4)), (2, ()),
], ids=["nothing", "ckpt_only", "ckpt_newer", "equal", "statefile_newer", "statefile_only"])
def test_watcher_picks_the_highest_version_like_jax(tmp_path, weights, state_version, ckpt_versions):
    """The statefile and the checkpoint directory, each published to the
    same versions for both packages: for every floor the two watchers
    return the same version and bitwise the same weights (the statefile
    first at an equal version), or both None."""
    from fedcrack_tpu import ckpt as JC
    from fedcrack_tpu_torch import ckpt as TC

    var0, var1 = weights
    picks = {}
    for who, H, C in (("port", TH, TC), ("jax", JH, JC)):
        root = tmp_path / who
        root.mkdir()
        state_path = str(root / "state.msgpack")
        if state_version is not None:
            H.publish_statefile(state_path, var0, model_version=state_version)
        with C.FedCheckpointer(root / "ckpt") as ckptr:
            for v in ckpt_versions:
                ckptr.save(C.FedCheckpoint(v + 1, v, var1 if v % 2 == 0 else var0))
        watcher = H.WeightSourceWatcher(ckpt_dir=str(root / "ckpt"), state_path=state_path, template=var0)
        picks[who] = [watcher.best_available(floor) for floor in range(-1, 7)]
        if who == "jax":
            watcher.close()
    for got, want in zip(picks["port"], picks["jax"]):
        assert (got is None) == (want is None)
        if want is not None:
            assert got[0] == want[0] and _leaves_equal(got[1], want[1])
    assert TH.WeightSourceWatcher(ckpt_dir=str(tmp_path / "missing")).best_available(-1) is None


def test_manager_installs_the_newest_checkpoint(tmp_path, weights):
    from fedcrack_tpu_torch import ckpt as TC
    from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload

    var0, var1 = weights
    engine = _engine()
    mgr = TH.ModelVersionManager(engine, var0, ckpt_dir=str(tmp_path / "ckpt"), template=var0)
    assert mgr.poll_once() is False  # no directory yet
    with TC.FedCheckpointer(tmp_path / "ckpt") as ckptr:
        TC.save_server_state(ckptr, TR.initial_state(FedConfig(), var1)._replace(model_version=2, current_round=3))
    assert mgr.poll_once() is True and mgr.version == 2 and mgr.last_quant_gate["passed"]
    assert mgr.poll_once() is False
    imgs = _images(2, 12)
    cold, _ = prepare_gated_payload(engine, var1, engine.serve_config)
    np.testing.assert_array_equal(engine.predict_bucket(mgr.snapshot()[1], imgs), engine.predict_bucket(cold, imgs))


def test_manager_probes_each_installed_version_with_the_canary(weights):
    """``canary=``: after each flip the poll thread's install probes the
    installed payload (quantized here); the records equal a canary run
    by hand on the same payloads, and a stale install never reaches it."""
    from fedcrack_tpu_torch.health.canary import CanaryEvaluator
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve import quant as tq

    engine = _engine()
    canary = CanaryEvaluator(engine, registry=MetricsRegistry())
    mgr = TH.ModelVersionManager(engine, weights[0], canary=canary)
    assert mgr.install(1, weights[0]) and mgr.install(2, weights[1])
    assert not mgr.install(2, weights[0])
    by_hand = CanaryEvaluator(engine, registry=MetricsRegistry())
    for version, var in ((1, weights[0]), (2, weights[1])):
        by_hand.evaluate(version, engine.prepare_quantized(tq.quantize_for_plane(var, engine.kernel_plane)))
    assert canary.history == by_hand.history
    assert [h["version"] for h in canary.history] == [1, 2] and canary.reference_version == 1
    assert canary.history[0]["iou"] == 1.0 and canary.history[1]["iou"] < 1.0


def test_watcher_close_releases_its_checkpointer_and_is_idempotent(tmp_path, weights):
    """Like the JAX watcher, the port's holds one checkpointer once it has
    read the directory; ``close`` releases it, a second ``close`` is a no-op,
    and a later read opens a new one. Stopping a manager closes its watcher,
    as the JAX manager's ``stop`` does."""
    from fedcrack_tpu import ckpt as JC
    from fedcrack_tpu_torch import ckpt as TC

    var0, var1 = weights
    for who, H, C in (("port", TH, TC), ("jax", JH, JC)):
        with C.FedCheckpointer(tmp_path / who) as ckptr:
            ckptr.save(C.FedCheckpoint(2, 1, var1))
        watcher = H.WeightSourceWatcher(ckpt_dir=str(tmp_path / who), template=var0)
        assert watcher._ckptr is None
        assert watcher.best_available(0)[0] == 1
        assert watcher._ckptr is not None
        watcher.close()
        assert watcher._ckptr is None
        watcher.close()
        assert watcher.best_available(0)[0] == 1 and watcher._ckptr is not None
        watcher.close()
    mgr = TH.ModelVersionManager(_engine(), var0, ckpt_dir=str(tmp_path / "port"), template=var0, poll_s=0.05)
    mgr.start()
    deadline = time.monotonic() + 30
    while mgr.version != 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert mgr.version == 1 and mgr._watcher._ckptr is not None
    mgr.stop()
    assert mgr._watcher._ckptr is None
