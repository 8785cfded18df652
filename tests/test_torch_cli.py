"""The port's command lines (server.py, client.py, train/centralized.py)
on the CPU, at small widths, held against the JAX package and against the
port's own in-process federation.

- ``server.build_config`` gives the JAX package's ``FedConfig`` (and the
  same parsed flags) for the same argv and config file.
- A server ``main`` and two client ``main``s run in threads on 127.0.0.1
  with ``device="cpu"`` over an image directory written here; the final
  global in the server's statefile is byte-equal to
  ``chip_smoke.cli_in_process_drive`` of the same shards, seeds and
  initial weights (chip_smoke.py phase 13 makes the same check with one
  process per client on the card).
- ``train_centralized`` of both packages for one epoch from the same
  initial tree (each package's ``create_train_state`` patched to load it):
  history within the rtol 1e-4 of ``test_local_fit_matches_jax``.
- A client ``main`` with ``--predict-dir`` after a one-round session
  writes ``pred_*.png`` and ``overlay_*.png`` at the model's size and logs
  a report equal to ``quantify_mask`` over the written masks.
- The flags whose modules are not ported raise ``NotImplementedError``
  naming their ROADMAP item.
"""

import argparse
import json
import logging
import os
import threading

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_variables

import chip_smoke

pytestmark = pytest.mark.torch_port

TINY_CONFIG = {
    "model": {**TINY_KW, "encoder_features": list(TINY_KW["encoder_features"]),
              "decoder_features": list(TINY_KW["decoder_features"])},
    "data": {"img_size": 32, "batch_size": 4, "num_workers": 2, "prefetch": 1},
    "local_epochs": 1,
    "poll_period_s": 0.05,
}


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train = chip_smoke.write_pairs(str(root / "train"), 17, 48, seed=13)
    held = chip_smoke.write_pairs(str(root / "eval"), 6, 48, seed=14)
    config = str(root / "fed.json")
    with open(config, "w", encoding="utf-8") as f:
        json.dump(TINY_CONFIG, f)
    return train, held, config


@pytest.mark.parametrize("argv", [
    [],
    ["--rounds", "3", "--cohort", "4", "--port", "0", "--host", "127.0.0.1", "--registration-window", "2.5",
     "--round-deadline", "30", "--quorum-fraction", "0.75", "--state-path", "s.bin", "--seed", "7",
     "--fedprox-mu", "0.01", "--pos-weight", "3", "--wire-dtype", "bfloat16", "--update-codec", "int8",
     "--max-message-mb", "64", "--metrics", "m.jsonl", "--tb-dir", "tb", "--logs-dir", "logs",
     "--init-weights", "w.msgpack", "--best-path", "best.msgpack", "--metrics-port", "-1",
     "--spans-path", "spans.jsonl", "--eval-synthetic", "8"],
    ["--mode", "buffered", "--buffer-k", "3", "--staleness-alpha", "0.25", "--max-staleness", "2",
     "--aggregation", "trimmed_mean", "--trim-fraction", "0.2", "--quarantine-z", "3.5",
     "--server-optimizer", "fedadam", "--server-lr", "0.01", "--server-momentum", "0.5",
     "--topk-fraction", "0.05", "--auth-token", "s3cret", "--allow-insecure-token"],
    ["--aggregation", "krum", "--byzantine-f", "1", "--cohort", "5", "--dp-clip-norm", "1.5",
     "--dp-noise-multiplier", "0.8", "--dp-sample-rate", "0.02", "--dp-delta", "1e-6",
     "--dp-steps-per-round", "4", "--dp-seed", "9", "--dp-epsilon-budget", "8", "--ckpt-dir", "ck",
     "--privacy-summary", "p.json"],
    ["--secagg", "--secagg-bits", "20", "--eval-image-dir", "ei", "--eval-mask-dir", "em"],
], ids=["defaults", "sync_flags", "buffered_robust", "privacy_flags", "secagg"])
@pytest.mark.parametrize("with_file", [False, True], ids=["flags", "config_file"])
def test_build_config_matches_jax(argv, with_file, tmp_path):
    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu_torch import server

    if with_file:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({**TINY_CONFIG, "max_rounds": 9, "cohort_size": 3, "learning_rate": 5e-4,
                                    "unknown_key": 1}))
        argv = ["--config", str(path), *argv]
    got_cfg, got_args = server.build_config(argv)
    want_cfg, want_args = jax_server.build_config(argv)
    assert json.loads(got_cfg.to_json()) == json.loads(want_cfg.to_json())
    assert vars(got_args) == vars(want_args)


def _serving_port(records: list, timeout: float = 60.0) -> int:
    import re
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for msg in list(records):
            found = re.search(r"serving on [^:\s]+:(\d+)", msg)
            if found:
                return int(found.group(1))
        time.sleep(0.05)
    raise AssertionError("the server did not report its port")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_server_and_client_mains_match_the_in_process_drive(image_dirs, tmp_path):
    from fedcrack_tpu_torch import client, server
    from fedcrack_tpu_torch.ckpt.statefile import server_state_from_bytes
    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu_torch.obs import read_metrics, read_scalars, read_spans

    (image_dir, mask_dir), (eval_image_dir, eval_mask_dir), config = image_dirs
    global0 = jax_variables(TINY_KW, seed=5)
    init = tmp_path / "init.msgpack"
    init.write_bytes(tree_to_bytes(global0))
    p = {k: str(tmp_path / v) for k, v in (("state", "state.bin"), ("metrics", "server.jsonl"), ("tb", "tb"),
                                             ("spans", "spans.jsonl"), ("best", "best.msgpack"))}
    server_argv = ["--config", config, "--host", "127.0.0.1", "--port", "0", "--rounds", "2", "--cohort", "2",
                   "--registration-window", "60", "--init-weights", str(init), "--state-path", p["state"],
                   "--metrics", p["metrics"], "--tb-dir", p["tb"], "--spans-path", p["spans"],
                   "--best-path", p["best"], "--eval-image-dir", eval_image_dir, "--eval-mask-dir", eval_mask_dir]
    codes, errors = {}, []

    def run(label, fn, argv):
        try:
            codes[label] = fn(argv, device="cpu")
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append((label, e))

    capture = _Capture()
    service_log = logging.getLogger("fedcrack.server")
    level = service_log.level
    service_log.addHandler(capture)
    service_log.setLevel(logging.INFO)
    threads = [threading.Thread(target=run, args=("server", server.main, server_argv), daemon=True)]
    try:
        threads[0].start()
        port = _serving_port(capture.messages)
        for i, name in enumerate(chip_smoke.CLI_NAMES):
            argv = ["--config", config, "--host", "127.0.0.1", "--port", str(port), "--name", name,
                    "--image-dir", image_dir, "--mask-dir", mask_dir, "--num-clients", "2", "--client-index", str(i),
                    "--transport-dtype", "uint8", "--metrics", str(tmp_path / f"{name}.jsonl")]
            threads.append(threading.Thread(target=run, args=(name, client.main, argv), daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(timeout=240)
    finally:
        service_log.removeHandler(capture)
        service_log.setLevel(level)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert codes == {"server": 0, "client_0": 0, "client_1": 0}

    server_cfg, _ = server.build_config(server_argv)
    with open(p["state"], "rb") as f:
        state = server_state_from_bytes(f.read(), server_cfg)
    assert len(state.history) == 2 and state.model_version == 2
    assert [h["samples"] for h in state.history] == [[8, 8], [8, 8]]
    client_cfg = FedConfig.from_json(open(config, encoding="utf-8").read())
    drive = chip_smoke.cli_in_process_drive(server_cfg, client_cfg, image_dir, mask_dir, global0, device="cpu")
    assert drive["state"].global_blob == state.global_blob

    assert sorted(r["kind"] for r in read_metrics(p["metrics"])) == ["round", "round", "server_eval", "server_eval"]
    for name in chip_smoke.CLI_NAMES:
        recs = read_metrics(tmp_path / f"{name}.jsonl")
        assert [r["kind"] for r in recs] == ["local_fit", "local_fit", "session"]
        assert [r["num_samples"] for r in recs[:2]] == [8, 8] and recs[2]["rounds_completed"] == 2
    (tb_file,) = os.listdir(p["tb"])
    assert {t for t, _, _ in read_scalars(os.path.join(p["tb"], tb_file))} >= {"round/bytes_per_round"}
    assert [s["version"] for s in read_spans(p["spans"], "fed.flush")] == [1, 2]
    with open(p["best"], "rb") as f:
        tree_from_bytes(f.read(), template=global0)


def _pin_initial_tree(monkeypatch, module, tree, load):
    """Make ``module.create_train_state`` start from ``tree``."""
    make = module.create_train_state

    def create(*args, **kwargs):
        return load(make(*args, **kwargs), tree)

    monkeypatch.setattr(module, "create_train_state", create)


def test_train_centralized_matches_jax(image_dirs, tmp_path, monkeypatch):
    """One epoch of each package's trainer on the same image directory
    (its command line's datasets) from the same initial tree."""
    from fedcrack_tpu.configs import ModelConfig as JaxModelConfig
    from fedcrack_tpu.fed.serialization import tree_from_bytes as jax_from_bytes
    from fedcrack_tpu.train import centralized as jc
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.train import centralized as tc

    (image_dir, mask_dir), _, _ = image_dirs
    start = jax_variables(TINY_KW, seed=8)

    def jax_load(state, tree):
        import jax

        return state.replace(params=jax.tree.map(jax.numpy.asarray, tree["params"]),
                             batch_stats=jax.tree.map(jax.numpy.asarray, tree["batch_stats"]))

    _pin_initial_tree(monkeypatch, jc, start, jax_load)
    _pin_initial_tree(monkeypatch, tc, start, lambda st, tree: st.replace_variables(tree))
    args = argparse.Namespace(synthetic=0, image_dir=image_dir, mask_dir=mask_dir, batch=4, seed=2,
                              train_samples=12, split_seed=1337, transport_dtype="uint8")
    runs = {}
    for name, mod, cfg, kw in (("jax", jc, JaxModelConfig(**TINY_KW), {}),
                               ("port", tc, ModelConfig(**TINY_KW), {"device": "cpu"})):
        train, val = mod._build_datasets(args, cfg)
        out_dir = str(tmp_path / name)
        _, history = mod.train_centralized(train, val, model_config=cfg, epochs=1, out_dir=out_dir, seed=2,
                                           log_fn=lambda _: None, pos_weight=2.0, **kw)
        runs[name] = (history, out_dir)
    (got,), (want,) = runs["port"][0], runs["jax"][0]
    assert set(got) == set(want)
    assert got["epoch"] == want["epoch"] == 0
    assert got["train_num_steps"] == want["train_num_steps"] == 3
    assert got["val_num_batches"] == want["val_num_batches"] == 1
    for k in sorted(set(got) - {"epoch", "train_num_steps", "val_num_batches"}):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for name in ("best.msgpack", "final.msgpack"):
        with open(os.path.join(runs["port"][1], name), "rb") as f:
            port_tree = tree_from_bytes(f.read())
        with open(os.path.join(runs["jax"][1], name), "rb") as f:
            jax_tree = jax_from_bytes(f.read())
        assert set(port_tree) == set(jax_tree) == {"params", "batch_stats"}


def test_centralized_main_writes_checkpoints_and_metrics(tmp_path):
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.obs import read_metrics
    from fedcrack_tpu_torch.train import centralized

    out = tmp_path / "out"
    argv = ["--synthetic", "10", "--epochs", "2", "--batch", "4", "--img-size", "32", "--out-dir", str(out),
            "--metrics", str(tmp_path / "m.jsonl"), "--tb-dir", str(tmp_path / "tb")]
    # The full-width model at 32 px is the command line's only model: one
    # step of it on the CPU is the cost of this test.
    assert centralized.main(argv, device="cpu") == 0
    epochs = read_metrics(tmp_path / "m.jsonl", "epoch")
    assert [e["epoch"] for e in epochs] == [0, 1] and all(np.isfinite(e["val_loss"]) for e in epochs)
    for name in ("best.msgpack", "final.msgpack"):
        assert set(tree_from_bytes((out / name).read_bytes())) == {"params", "batch_stats"}
    with pytest.raises(SystemExit):
        centralized.main(["--synthetic", "1"], device="cpu")


@pytest.mark.parametrize("entry,argv,item", [
    ("server", ["--ckpt-dir", "ckpt"], "item 5"),
    ("server", ["--dp-clip-norm", "1.0"], "item 3"),
    ("server", ["--dp-seed", "3"], "item 3"),
    ("server", ["--secagg"], "item 3"),
    ("server", ["--privacy-summary", "p.json"], "item 3"),
    ("client", ["--dp-clip-norm", "1.0", "--synthetic", "4"], "item 3"),
    ("client", ["--dp-seed", "2", "--synthetic", "4"], "item 3"),
], ids=["ckpt_dir", "server_dp_clip", "server_dp_seed", "secagg", "privacy_summary", "client_dp_clip",
        "client_dp_seed"])
def test_unported_flags_refuse_naming_their_item(entry, argv, item, tmp_path):
    import importlib

    main = importlib.import_module(f"fedcrack_tpu_torch.{entry}").main
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        main(argv, device="cpu")


def test_client_predict_dir_writes_masks_and_report(image_dirs, tmp_path):
    import cv2

    from fedcrack_tpu_torch import client, server
    from fedcrack_tpu_torch.tools.quantify import quantify_mask

    (image_dir, mask_dir), _, config = image_dirs
    server_argv = ["--config", config, "--host", "127.0.0.1", "--port", "0", "--rounds", "1", "--cohort", "1",
                   "--registration-window", "60"]
    pred = tmp_path / "pred"
    codes, errors = {}, []

    def run(label, fn, argv):
        try:
            codes[label] = fn(argv, device="cpu")
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append((label, e))

    capture = _Capture()
    loggers = [logging.getLogger("fedcrack.server"), logging.getLogger()]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(capture)
        lg.setLevel(logging.INFO)
    threads = [threading.Thread(target=run, args=("server", server.main, server_argv), daemon=True)]
    try:
        threads[0].start()
        port = _serving_port(capture.messages)
        argv = ["--config", config, "--host", "127.0.0.1", "--port", str(port), "--image-dir", image_dir,
                "--mask-dir", mask_dir, "--transport-dtype", "uint8", "--predict-dir", str(pred)]
        threads.append(threading.Thread(target=run, args=("client", client.main, argv), daemon=True))
        threads[-1].start()
        for t in threads:
            t.join(timeout=240)
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(capture)
            lg.setLevel(level)
    assert not errors and codes == {"server": 0, "client": 0}, errors
    # chip_smoke.py phase 13's check of the second client's output.
    report = chip_smoke.check_predict_dir(str(pred), "\n".join(capture.messages), 32)
    assert [r["image"] for r in report] == list(range(8))
    mask = cv2.imread(str(pred / "pred_003.png"), cv2.IMREAD_GRAYSCALE)
    assert report[3]["contours"] == quantify_mask(mask).contour_count
    with pytest.raises(AssertionError, match="--predict-dir image 0"):
        chip_smoke.check_predict_dir(str(pred), "\n".join(capture.messages), 64)


def test_client_sharding_rules(image_dirs):
    """``--num-clients > 1`` needs ``--client-index``; the shards of the
    command line's filter are disjoint and cover the split's train side."""
    from fedcrack_tpu_torch import client
    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.data.pipeline import list_pairs, reference_split

    (image_dir, mask_dir), _, config = image_dirs
    with pytest.raises(SystemExit):
        client.main(["--config", config, "--synthetic", "4", "--num-clients", "2"], device="cpu")
    cfg = FedConfig.from_json(open(config, encoding="utf-8").read())
    pairs = list_pairs(image_dir, mask_dir)
    shards = [client.local_shard(cfg, 3, i)(pairs) for i in range(3)]
    assert sorted(sum(shards, [])) == sorted(reference_split(pairs, cfg.data.train_samples, cfg.data.split_seed)[0])
