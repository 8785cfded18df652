"""The port's load generator (``tools/load_gen.py``) held against the JAX
package's on the CPU.

- ``arrival_schedule`` (const, ramp, diurnal), ``make_images`` and
  ``make_frame_sequence`` are equal to the JAX package's, byte for byte,
  for the same seeds; the validation errors match.
- Closed, open and video runs against the port's ``ServeServer`` (its
  fleet on a tiny CPU engine): every request answered, zero drops, both
  sizes; the kept masks equal the engine in process and carry their
  versions; the video audit holds.
- An open-loop ramp against a slow fleet with a queue bound: sheds are
  counted apart from drops and rejects, per phase, as the server counted
  them.
- The port's ``run_load`` against a JAX ``ServeServer`` answers the same
  masks as the JAX ``run_load`` against the same server.
- ``_MetricsSampler`` reports a replica gauge that varied.
- ``main``: ``--out-dir`` masks and ``--swap-statefile`` with the port's
  seeded init, published mid-run and served.
"""

import json
import os
import time

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKETS = (16, 32)


def _serve_kw(**over):
    kw = dict(bucket_sizes=BUCKETS, max_batch=4, max_delay_ms=2.0, tile_overlap=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("profile,n,rate,seed", [
    ("const", 10, 20.0, 3), ("ramp", 40, 10.0, 7), ("ramp", 41, 3.5, 8), ("diurnal", 21, 5.0, 0),
    ("diurnal", 7, 50.0, 11),
])
def test_arrival_schedule_matches_jax(profile, n, rate, seed):
    from fedcrack_tpu.tools.load_gen import arrival_schedule as jax_schedule
    from fedcrack_tpu_torch.tools.load_gen import arrival_schedule

    assert arrival_schedule(profile, n, rate, seed) == jax_schedule(profile, n, rate, seed)


def test_arrival_schedule_validation_matches_jax():
    from fedcrack_tpu.tools.load_gen import arrival_schedule as jax_schedule
    from fedcrack_tpu_torch.tools.load_gen import arrival_schedule

    for args in (("sawtooth", 10, 5.0), ("video", 10, 5.0), ("ramp", 0, 5.0), ("ramp", 10, 0.0)):
        with pytest.raises(ValueError) as got:
            arrival_schedule(*args)
        with pytest.raises(ValueError) as want:
            jax_schedule(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,sizes,seed", [(5, (16, 32), 0), (9, (32, 16, 24), 4), (1, (48,), 2)])
def test_make_images_byte_equal_jax(n, sizes, seed):
    from fedcrack_tpu.tools.load_gen import make_images as jax_images
    from fedcrack_tpu_torch.tools.load_gen import make_images

    got, want = make_images(n, sizes, seed), jax_images(n, sizes, seed)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape and a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("frames,size,motion,seed", [(4, 40, 0.1, 0), (3, 24, 0.0, 1), (3, 24, 1.0, 2)])
def test_make_frame_sequence_byte_equal_jax(frames, size, motion, seed):
    from fedcrack_tpu.tools.load_gen import make_frame_sequence as jax_frames
    from fedcrack_tpu_torch.tools.load_gen import make_frame_sequence

    got, want = make_frame_sequence(frames, size, motion, seed), jax_frames(frames, size, motion, seed)
    assert [f.tobytes() for f in got] == [np.asarray(f).tobytes() for f in want]
    with pytest.raises(ValueError):
        make_frame_sequence(0, size, motion)
    with pytest.raises(ValueError):
        make_frame_sequence(2, size, 1.5)


@pytest.fixture(scope="module")
def port_server():
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeServerThread, ServeService
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager

    var0 = jax_variables(TINY_KW, seed=0)
    cfg = ServeConfig(**_serve_kw(replicas=2))
    engine = InferenceEngine(port_config(TINY_KW), cfg, device="cpu")
    fleet = ServeFleet(port_config(TINY_KW), cfg, var0, shared_engine=engine, warmup=False)
    service = ServeService(engine, fleet.router, fleet.manager,
                           stream_manager=StreamSessionManager(engine, fleet.manager, max_sessions=4))
    with ServeServerThread(ServeServer(service, port=0)) as thread:
        yield {"port": thread.port, "fleet": fleet, "engine": engine, "var0": var0}
    fleet.close()


def _mask(engine, payload, image):
    return ((engine.predict_image(payload, image)[..., 0] > 0.5).astype(np.uint8) * 255).tobytes()


def test_closed_run_against_the_port_server(port_server):
    from fedcrack_tpu_torch.tools.load_gen import make_images, run_load

    summary = run_load(f"127.0.0.1:{port_server['port']}", mode="closed", n_requests=12, concurrency=3,
                       sizes=(16, 32, 20), seed=1, keep_masks=True)
    assert summary["completed"] == 12 and summary["dropped"] == summary["rejected"] == summary["shed"] == 0
    assert summary["per_size"] == {"16x16": 4, "32x32": 4, "20x20": 4}
    assert summary["latency_ms"]["count"] == 12 and summary["latency_ms"]["p99"] >= summary["latency_ms"]["p50"] > 0
    version = port_server["fleet"].manager.version
    assert summary["versions_observed"] == {str(version): 12}
    assert summary["mask_versions"] == {str(i): version for i in range(12)}
    images = make_images(12, (16, 32, 20), 1)
    payload = port_server["fleet"].manager.snapshot()[1]
    for rid, h, w, blob in summary["masks"]:
        assert (h, w) == images[rid].shape[:2] and blob == _mask(port_server["engine"], payload, images[rid])
    opened = run_load(f"127.0.0.1:{port_server['port']}", mode="open", n_requests=8, rate_rps=200.0,
                      sizes=(16,), seed=2, timeout_s=60.0)
    assert opened["completed"] == 8 and opened["dropped"] == 0 and opened["per_phase"][0]["completed"] == 8
    with pytest.raises(ValueError):
        run_load(f"127.0.0.1:{port_server['port']}", mode="closed", profile="ramp")


def test_video_profile_against_the_port_server(port_server):
    from fedcrack_tpu_torch.tools.load_gen import run_load

    summary = run_load(f"127.0.0.1:{port_server['port']}", profile="video", n_requests=4, concurrency=2,
                       sizes=(32,), seed=0, streams=2, frames_per_stream=4, motion_fraction=0.1, video_size=48,
                       audit_every=2)
    assert summary["mode"] == "video" and summary["completed"] == 4 and summary["dropped"] == 0
    video = summary["video"]
    assert video["frames_completed"] == 8 and video["dropped"] == 0 and video["open_failed"] == 0
    assert video["audit"]["checked"] > 0 and video["audit"]["ok"]
    assert video["hit_ratio"] > 0 and video["effective_speedup"] > 1.0


def test_open_ramp_sheds_apart_from_drops():
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeServerThread, ServeService
    from fedcrack_tpu_torch.tools.load_gen import run_load

    class SlowBatches(InferenceEngine):
        def predict_bucket(self, variables, images_u8):
            time.sleep(0.25)
            return super().predict_bucket(variables, images_u8)

    cfg = ServeConfig(**_serve_kw(replicas=2, queue_bound=2))
    engine = SlowBatches(port_config(TINY_KW), cfg, device="cpu")
    fleet = ServeFleet(port_config(TINY_KW), cfg, jax_variables(TINY_KW, seed=0), shared_engine=engine,
                       warmup=False)
    server = ServeServer(ServeService(engine, fleet.router, fleet.manager), port=0)
    try:
        with ServeServerThread(server) as thread:
            summary = run_load(f"127.0.0.1:{thread.port}", mode="open", profile="ramp", n_requests=32,
                               rate_rps=120.0, concurrency=8, sizes=(16,), seed=0, timeout_s=120.0)
    finally:
        fleet.close()
    assert summary["shed"] > 0 and summary["dropped"] == 0 and summary["rejected"] == 0
    assert summary["completed"] + summary["shed"] == 32
    assert server.service.shed == summary["shed"]
    phases = summary["per_phase"]
    assert [p["phase"] for p in phases] == ["ramp_0.25x", "ramp_0.5x", "ramp_1x", "ramp_2x"]
    assert sum(p["shed"] for p in phases) == summary["shed"]
    assert sum(p["completed"] for p in phases) == summary["completed"]


def test_port_load_gen_against_a_jax_server():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve import MicroBatcher, ModelVersionManager, ServeServer, ServeServerThread, ServeService
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu.tools.load_gen import run_load as jax_run_load
    from fedcrack_tpu_torch.tools.load_gen import run_load

    engine = JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw()))
    mgr = ModelVersionManager(engine, jax_variables(TINY_KW, seed=2))
    batcher = MicroBatcher(engine, mgr, max_delay_ms=2.0)
    try:
        with ServeServerThread(ServeServer(ServeService(engine, batcher, mgr), port=0)) as thread:
            target = f"127.0.0.1:{thread.port}"
            got = run_load(target, n_requests=10, concurrency=2, sizes=(16, 32), seed=3, keep_masks=True)
            want = jax_run_load(target, n_requests=10, concurrency=2, sizes=(16, 32), seed=3, keep_masks=True)
    finally:
        batcher.close()
    for key in ("completed", "rejected", "shed", "dropped", "per_size", "versions_observed", "n_requests"):
        assert got[key] == want[key], key
    assert set(got) - set(want) == {"mask_versions"} and set(want) <= set(got)
    assert sorted((rid, h, w, bytes(b)) for rid, h, w, b in got["masks"]) == \
        sorted((rid, h, w, bytes(b)) for rid, h, w, b in want["masks"])


def test_metrics_sampler_reports_replica_variation():
    from fedcrack_tpu_torch.obs.promexp import MetricsExporter
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.tools.load_gen import _MetricsSampler

    registry = MetricsRegistry()
    gauge = registry.gauge("serve_fleet_replicas", "live replica workers")
    p95 = registry.gauge("serve_rolling_p95_seconds", "rolling p95")
    exporter = MetricsExporter(registry)
    url = f"http://127.0.0.1:{exporter.start()}/metrics"
    try:
        sampler = _MetricsSampler(url, interval_s=0.05)
        gauge.set(1)
        p95.set(0.0125)
        sampler.sample_once()
        gauge.set(3)
        sampler.sample_once()
        summary = sampler.summary()
        assert (summary["replicas_min"], summary["replicas_max"], summary["replicas_first"],
                summary["replicas_last"]) == (1, 3, 1, 3)
        assert summary["replicas_varied"] and summary["scrape_errors"] == 0 and summary["samples"] == 2
        assert summary["track"][0]["p95_ms"] == 12.5
    finally:
        exporter.stop()
    sampler.sample_once()  # the port is closed: counted, never raised
    assert sampler.summary()["scrape_errors"] == 1
    with pytest.raises(ValueError):
        _MetricsSampler(url, interval_s=0.0)


def test_main_writes_masks_and_publishes_the_swap(tmp_path, capsys):
    import cv2
    import torch

    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.hot_swap import read_statefile_weights
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeServerThread, ServeService
    from fedcrack_tpu_torch.tools import load_gen

    state = str(tmp_path / "state.bin")
    cfg = ServeConfig(**_serve_kw(replicas=1, swap_poll_s=0.05))
    engine = InferenceEngine(port_config(TINY_KW), cfg, device="cpu")
    fleet = ServeFleet(port_config(TINY_KW), cfg, jax_variables(TINY_KW, seed=0), shared_engine=engine,
                       warmup=False, state_path=state)
    swap_config = tmp_path / "fed.json"
    swap_config.write_text(json.dumps({"model": {**TINY_KW, "encoder_features": list(TINY_KW["encoder_features"]),
                                                 "decoder_features": list(TINY_KW["decoder_features"])},
                                       "data": {"img_size": TINY_KW["img_size"]}}))
    out_dir = tmp_path / "masks"
    fleet.manager.start()
    try:
        with ServeServerThread(ServeServer(ServeService(engine, fleet.router, fleet.manager), port=0)) as thread:
            rc = load_gen.main(["--target", f"127.0.0.1:{thread.port}", "--requests", "60", "--concurrency", "2",
                                "--sizes", "16,32", "--out-dir", str(out_dir), "--swap-statefile", state,
                                "--swap-after", "5", "--swap-version", "3", "--swap-seed", "4",
                                "--swap-config", str(swap_config)])
    finally:
        fleet.close()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["completed"] == 60 and summary["swap_published"] is True
    assert summary["masks_written"] == 60 and len(os.listdir(out_dir)) == 60
    assert set(summary["versions_observed"]) == {"0", "3"}
    assert sorted(summary["mask_versions"].values()) == sorted(
        int(v) for v, n in summary["versions_observed"].items() for _ in range(n))
    version, published = read_statefile_weights(state)
    want = tree_to_bytes(init_variables(torch.Generator().manual_seed(4), port_config(TINY_KW)))
    assert version == 3 and tree_to_bytes(published) == want
    mask = cv2.imread(str(out_dir / "mask_00001.png"), cv2.IMREAD_GRAYSCALE)
    assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0, 255}
