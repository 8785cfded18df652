"""``python -m fedcrack_tpu_torch.serve`` (``serve/__main__.py``) on the
CPU, held against ``python -m fedcrack_tpu.serve``.

- ``build_parser``: the same option strings, destinations, types,
  choices and defaults as the JAX package's.
- ``resolve_config``: the same ``ServeConfig`` and ``ModelConfig`` for the
  same argv and config file.
- ``main(argv, device="cpu")`` in a subprocess (JAX, flax and the JAX
  package blocked there) serves from a ``--weights`` file through the
  fleet with the quant gate: it prints its ``SERVING`` line, answers one
  Predict with the mask of the port engine in process, and on SIGTERM
  prints ``serve_stats`` and exits 0.
- With ``--shadow-fraction 0.5`` the same command stages each statefile
  publish through the shadow lane under live Predict traffic: a re-publish
  of the served weights is promoted, zeroed weights are rolled back and
  never staged again, no answer carries the rolled-back version, and
  ``serve_stats["shadow"]`` counts both verdicts.
- ``resolve_initial_weights`` picks ``--weights``, the statefile, the
  newest round checkpoint of ``--ckpt-dir`` and the seed in the JAX
  command's order, to the same version and weights.
- ``--compute-dtype bfloat16`` serves the bfloat16 reference program.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import grpc
import jax
import numpy as np
import pytest

from fedcrack_tpu_torch.native import crc32c
from fedcrack_tpu_torch.transport import wire as W
from torch_port_helpers import TINY_KW, jax_variables, port_config

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = {
    "model": {**TINY_KW, "encoder_features": list(TINY_KW["encoder_features"]),
              "decoder_features": list(TINY_KW["decoder_features"])},
    "data": {"img_size": TINY_KW["img_size"]},
    "serve": {"bucket_sizes": [16, 32], "max_batch": 4, "tile_overlap": 4, "quant": "int8",
              "kernel_plane": "fused_int8", "max_delay_ms": 2.0},
}


def _describe(parser):
    return [(a.option_strings, a.dest, a.type, a.choices, a.default, a.nargs) for a in parser._actions]


def test_build_parser_matches_jax():
    from fedcrack_tpu.serve.__main__ import build_parser as jax_parser
    from fedcrack_tpu_torch.serve.__main__ import build_parser

    assert _describe(build_parser()) == _describe(jax_parser())


@pytest.mark.parametrize("argv", [
    [],
    ["--buckets", "64, 128,", "--max-batch", "2", "--max-delay-ms", "1.5", "--tile-overlap", "8",
     "--swap-poll-s", "0.3", "--host", "0.0.0.0", "--port", "0", "--replicas", "2", "--quant", "int8",
     "--quant-iou-floor", "0.9", "--slo-p95-ms", "250", "--queue-bound", "64", "--stream-cache-tiles", "0",
     "--stream-max-sessions", "3", "--min-replicas", "1", "--max-replicas", "4", "--scale-interval-s", "0.2",
     "--scale-cooldown-s", "1"],
    ["--compute-dtype", "bfloat16", "--shadow-fraction", "0.25", "--replicas", "1", "--min-replicas", "1",
     "--max-replicas", "1"],
], ids=["defaults", "every_override", "refused_values"])
@pytest.mark.parametrize("with_file", [False, True], ids=["flags", "config_file"])
def test_resolve_config_matches_jax(argv, with_file, tmp_path):
    import dataclasses

    from fedcrack_tpu.serve import __main__ as jax_main
    from fedcrack_tpu_torch.serve import __main__ as port_main

    if with_file:
        path = tmp_path / "serve.json"
        path.write_text(json.dumps(TINY_CONFIG))
        argv = ["--config", str(path)] + argv
    model, serve = port_main.resolve_config(port_main.build_parser().parse_args(argv))
    jmodel, jserve = jax_main.resolve_config(jax_main.build_parser().parse_args(argv))
    assert dataclasses.asdict(serve) == dataclasses.asdict(jserve)
    assert dataclasses.asdict(model) == dataclasses.asdict(jmodel)


@pytest.mark.parametrize("argv, quant", [
    (["--compute-dtype", "bfloat16"], "none"),
], ids=["bf16"])
def test_refusals_name_their_items(argv, quant, tmp_path):
    """``--compute-dtype bfloat16``, once refused, now serves: the command
    runs the bfloat16 reference program, and its Predict mask equals a
    bfloat16 engine's in process."""
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    variables = jax_variables(TINY_KW, seed=0)
    weights = tmp_path / "w.msgpack"
    weights.write_bytes(tree_to_bytes(variables))
    serve = dict(TINY_CONFIG["serve"], quant=quant, kernel_plane="reference")
    config = tmp_path / "serve.json"
    config.write_text(json.dumps(dict(TINY_CONFIG, serve=serve)))
    proc, log, log_path, line = _start_child(tmp_path, "--config", str(config), "--weights", str(weights),
                                             "--port", "0", *argv)
    try:
        assert line is not None, log_path.read_text()[-4000:]
        assert f" quant={quant}" in line
        port = int(line.split()[1].rsplit(":", 1)[1])
        image = np.random.default_rng(8).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        request = W.PredictRequest(request_id=1, height=32, width=32, channels=3, image=image.tobytes(), last=True,
                                   crc32c=crc32c(image.tobytes()))
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            grpc.channel_ready_future(channel).result(timeout=60)
            stub = channel.stream_stream("/fedcrack.ServePlane/Predict", request_serializer=W.PredictRequest.encode,
                                         response_deserializer=W.PredictResponse.decode)
            (response,) = list(stub(iter([request]), timeout=60))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**serve, compute_dtype="bfloat16"), device="cpu")
    reference = engine.prepare(variables)
    want = (engine.predict_image(reference, image)[..., 0] > 0.5).astype(np.uint8) * 255
    assert response.status == "OK" and response.mask == want.tobytes()


@pytest.mark.parametrize("sources", [("ckpt",), ("state", "ckpt"), ("weights", "state", "ckpt"), ()],
                         ids=["ckpt_dir", "statefile_first", "weights_first", "seed"])
def test_resolve_initial_weights_matches_jax(tmp_path, sources):
    """``--weights``, then the statefile, then the newest round checkpoint
    of ``--ckpt-dir`` (each package reading its own checkpoints), then the
    seed: both commands pick the same source, version and weights."""
    import argparse

    from fedcrack_tpu import ckpt as JC
    from fedcrack_tpu.fed.serialization import tree_to_bytes
    from fedcrack_tpu.serve.__main__ import resolve_initial_weights as jax_resolve
    from fedcrack_tpu_torch import ckpt as TC
    from fedcrack_tpu_torch.serve.__main__ import resolve_initial_weights

    template, state_w, ckpt_w, file_w = (jax_variables(TINY_KW, seed=s) for s in (0, 1, 2, 3))
    picks = {}
    for who, C, resolve in (("port", TC, resolve_initial_weights), ("jax", JC, jax_resolve)):
        root = tmp_path / who
        root.mkdir()
        args = argparse.Namespace(weights=None, state_path=None, ckpt_dir=str(root / "missing"))
        if "weights" in sources:
            args.weights = str(root / "w.msgpack")
            (root / "w.msgpack").write_bytes(tree_to_bytes(file_w))
        if "state" in sources:
            from fedcrack_tpu.serve.hot_swap import publish_statefile

            args.state_path = str(root / "state.msgpack")
            publish_statefile(args.state_path, state_w, model_version=4)
        if "ckpt" in sources:
            args.ckpt_dir = str(root / "ckpt")
            with C.FedCheckpointer(args.ckpt_dir) as ckptr:
                ckptr.save(C.FedCheckpoint(7, 6, ckpt_w))
        picks[who] = resolve(args, template, 0)
    want = file_w if "weights" in sources else state_w if "state" in sources else ckpt_w if sources else template
    for version, tree in picks.values():
        assert version == picks["jax"][0] == {"ckpt": 6, "state": 4, "weights": 0}.get(sources[0] if sources else "", 0)
        assert [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)] == \
               [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(want)]


CHILD = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "fedcrack_tpu", "msgpack", "ml_dtypes", "google"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
from fedcrack_tpu_torch.serve.__main__ import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


def test_main_serves_a_request_and_stops_on_sigterm(tmp_path):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    variables = jax_variables(TINY_KW, seed=0)
    weights = tmp_path / "w.msgpack"
    weights.write_bytes(tree_to_bytes(variables))
    config = tmp_path / "serve.json"
    config.write_text(json.dumps(TINY_CONFIG))
    log_path = tmp_path / "serve.log"
    log = open(log_path, "w", encoding="utf-8")  # the child's; the test reads its own handle
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD.format(root=ROOT), "--config", str(config), "--weights", str(weights),
         "--port", "0", "--metrics-path", str(tmp_path / "m.jsonl"), "--state-path", str(tmp_path / "s.bin"),
         "--compile-cache-dir", str(tmp_path / "unused")],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    try:
        deadline = time.monotonic() + 120
        line = None
        while line is None and time.monotonic() < deadline and proc.poll() is None:
            line = next((ln for ln in log_path.read_text().splitlines() if ln.startswith("SERVING ")), None)
            time.sleep(0.1)
        assert line is not None, log_path.read_text()[-4000:]
        assert " quant=int8" in line and " version=0" in line and "buckets=16,32" in line
        port = int(line.split()[1].rsplit(":", 1)[1])
        image = np.random.default_rng(7).integers(0, 256, (20, 24, 3), dtype=np.uint8)
        request = W.PredictRequest(request_id=5, height=20, width=24, channels=3, image=image.tobytes(), last=True,
                                   crc32c=crc32c(image.tobytes()))
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            grpc.channel_ready_future(channel).result(timeout=60)
            stub = channel.stream_stream("/fedcrack.ServePlane/Predict", request_serializer=W.PredictRequest.encode,
                                         response_deserializer=W.PredictResponse.decode)
            (response,) = list(stub(iter([request]), timeout=60))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log.close()
    text = log_path.read_text()
    assert "compile-cache-dir" in text and "unused" in text
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**TINY_CONFIG["serve"]), device="cpu")
    payload = engine.prepare_quantized(tq.quantize_for_plane(variables, "fused_int8"))
    want = (engine.predict_image(payload, image)[..., 0] > 0.5).astype(np.uint8) * 255
    assert response.status == "OK" and response.model_version == 0 and response.request_id == 5
    assert response.mask == want.tobytes()
    stats_lines = [ln for ln in text.splitlines() if ln.startswith('{"serve_stats"')]
    assert len(stats_lines) == 1, text[-4000:]
    stats = json.loads(stats_lines[0])["serve_stats"]
    assert stats["quant_gate"]["passed"] and stats["replica_versions"] == [0]
    assert stats["router"]["per_replica"]["0"]["completed"] == 1


def _start_child(tmp_path, *args):
    log_path = tmp_path / "serve.log"
    log = open(log_path, "w", encoding="utf-8")
    proc = subprocess.Popen([sys.executable, "-c", CHILD.format(root=ROOT), *args], cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    deadline = time.monotonic() + 120
    line = None
    while line is None and time.monotonic() < deadline and proc.poll() is None:
        line = next((ln for ln in log_path.read_text().splitlines() if ln.startswith("SERVING ")), None)
        time.sleep(0.1)
    return proc, log, log_path, line


def test_main_with_shadow_fraction_stages_each_publish(tmp_path):
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile

    variables = jax_variables(TINY_KW, seed=0)
    def zero(tree):
        return {k: zero(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}

    zeros = zero(variables)
    weights, config, state = tmp_path / "w.msgpack", tmp_path / "serve.json", str(tmp_path / "s.bin")
    weights.write_bytes(tree_to_bytes(variables))
    config.write_text(json.dumps(TINY_CONFIG))
    proc, log, log_path, line = _start_child(
        tmp_path, "--config", str(config), "--weights", str(weights), "--state-path", state, "--port", "0",
        "--shadow-fraction", "0.5", "--swap-poll-s", "0.1", "--metrics-path", str(tmp_path / "m.jsonl"))
    versions, errors, stop = [], [], threading.Event()
    try:
        assert line is not None, log_path.read_text()[-4000:]
        assert " replicas=1 quant=int8" in line
        port = int(line.split()[1].rsplit(":", 1)[1])

        def pump():
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                grpc.channel_ready_future(channel).result(timeout=60)
                stub = channel.stream_stream("/fedcrack.ServePlane/Predict",
                                             request_serializer=W.PredictRequest.encode,
                                             response_deserializer=W.PredictResponse.decode)
                rid = 0
                while not stop.is_set():
                    image = np.random.default_rng(rid).integers(0, 256, (16, 16, 3), dtype=np.uint8)
                    request = W.PredictRequest(request_id=rid, height=16, width=16, channels=3,
                                               image=image.tobytes(), last=True)
                    try:
                        (r,) = list(stub(iter([request]), timeout=60))
                        versions.append((r.status, r.model_version))
                    except Exception as e:  # surfaced by the asserts below
                        errors.append(e)
                    rid += 1

        thread = threading.Thread(target=pump, daemon=True)
        thread.start()

        def wait_for(pred, what):
            deadline = time.monotonic() + 90
            while not pred():
                assert time.monotonic() < deadline and proc.poll() is None, (what, log_path.read_text()[-4000:])
                time.sleep(0.05)

        publish_statefile(state, variables, model_version=2)
        wait_for(lambda: any(v == 2 for _, v in versions), "version 2 served")
        publish_statefile(state, zeros, model_version=3)
        wait_for(lambda: "shadow verdict v3: rollback" in log_path.read_text(), "version 3 rolled back")
        n = len(versions)
        wait_for(lambda: len(versions) > n + 8, "traffic after the rollback")
        stop.set()
        thread.join(timeout=60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    text = log_path.read_text()
    assert not errors and {s for s, _ in versions} == {"OK"}
    assert {v for _, v in versions} == {0, 2}
    stats = json.loads(next(ln for ln in text.splitlines() if ln.startswith('{"serve_stats"')))["serve_stats"]
    shadow = stats["shadow"]
    assert (shadow["staged"], shadow["promoted"], shadow["rolled_back"]) == (2, 1, 1)
    promoted, rolled = shadow["verdicts"]
    assert (promoted["version"], promoted["verdict"], promoted["installed"]) == (2, "promote", True)
    # The candidate runs the reference program against quantized
    # production: its canary IoU is the quant gate's on the same weights.
    assert promoted["iou"] == stats["quant_gate"]["iou"] >= 0.98 and promoted["completed"] >= 16
    assert (rolled["version"], rolled["verdict"], rolled["installed"]) == (3, "rollback", False)
    assert any(r.startswith("canary iou") for r in rolled["reasons"])
    assert [s["to_version"] for s in stats["swaps"]] == [2] and stats["replica_versions"] == [2]


def test_main_pins_the_mmap_threshold_before_anything_else(monkeypatch):
    """The serve command pins glibc's mmap threshold first thing (a long
    serve fleet churns multi-MB weight trees); a recorder takes the call
    here, in the test process."""
    from fedcrack_tpu_torch.obs import sentries
    from fedcrack_tpu_torch.serve.__main__ import main

    calls = []
    monkeypatch.setattr(sentries, "pin_mmap_threshold", lambda: calls.append(True) or True)
    with pytest.raises(SystemExit):
        main(["--no-such-flag"], device="cpu")
    assert calls == [True]


def test_kernel_compiles_gauge_counts_builds_and_loads_after_the_mark(tmp_path, monkeypatch):
    """``serve_recompiles_total`` reads the kernel libraries loaded (each
    built first where its cache held none) since ``watch_kernel_compiles``
    marked the count: a load after the mark reads 1, a second load of the
    same library nothing more."""
    import ctypes

    from fedcrack_tpu_torch.kernels import build
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.engine import watch_kernel_compiles

    reg = MetricsRegistry()
    watch_kernel_compiles(reg)
    assert reg.get("serve_recompiles_total").value == 0
    lib = build.KernelLibrary("fake", {})
    monkeypatch.setattr(lib, "build", lambda: "libc.so.6")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    lib.load()
    lib.load()
    assert reg.get("serve_recompiles_total").value == 1


def test_default_slo_rules_over_the_serve_commands_metrics(tmp_path, capsys):
    """The standalone watchdog with ``configs/slo_default.json`` over the
    serve command's ``/metrics``: ``zero_serve_recompiles`` is determinate
    and reads 0 (no kernel library loaded after the warm-up), no
    rule breaches, and the rules left indeterminate are those whose
    metrics a serve process does not export in either package: the
    federation root's staleness and accepted updates, and the leak
    sentries' RSS watermark."""
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.obs import watchdog
    from fedcrack_tpu_torch.obs.promexp import scrape

    variables = jax_variables(TINY_KW, seed=0)
    weights, config = tmp_path / "w.msgpack", tmp_path / "serve.json"
    weights.write_bytes(tree_to_bytes(variables))
    config.write_text(json.dumps(TINY_CONFIG))
    proc, log, log_path, line = _start_child(tmp_path, "--config", str(config), "--weights", str(weights),
                                             "--port", "0", "--metrics-port", "-1")
    try:
        assert line is not None, log_path.read_text()[-4000:]
        port = int(line.split()[1].rsplit(":", 1)[1])
        url = f"http://127.0.0.1:{line.rsplit('metrics_port=', 1)[1].split()[0]}/metrics"
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            grpc.channel_ready_future(channel).result(timeout=60)
            stub = channel.stream_stream("/fedcrack.ServePlane/Predict", request_serializer=W.PredictRequest.encode,
                                         response_deserializer=W.PredictResponse.decode)
            for rid in range(3):
                image = np.random.default_rng(rid).integers(0, 256, (16, 16, 3), dtype=np.uint8)
                request = W.PredictRequest(request_id=rid, height=16, width=16, channels=3, image=image.tobytes(),
                                           last=True)
                assert [r.status for r in stub(iter([request]), timeout=60)] == ["OK"]
        assert scrape(url)["serve_recompiles_total"]["samples"] == {(): 0.0}
        capsys.readouterr()
        rc = watchdog.main(["--rules", os.path.join(ROOT, "configs", "slo_default.json"), "--url", url,
                            "--interval", "1.1", "--count", "2"])
        printed = capsys.readouterr().out
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    audit = json.loads(printed[printed.index("{"):])
    assert audit["breaches"] == [] and audit["evaluations"] == 2 and audit["rules_evaluated"] == 6
    assert audit["never_determinate"] == ["rss_watermark_ceiling", "staleness_p99_versions", "updates_per_sec_floor"]
    assert rc == 1  # not clean: only for the rules a serve process cannot evaluate
