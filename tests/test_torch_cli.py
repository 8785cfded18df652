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
- The privacy flags and ``--ckpt-dir``: a DP federation (``--dp-*`` on
  the clients, the accountant, ``--privacy-summary`` and ``--ckpt-dir`` on
  the server) whose every upload is byte-equal to the JAX package's
  ``dp_update_host`` on the recorded (trained, base) pair and whose
  summary file and history epsilons are the JAX server's on the same
  uploads; a server restarted on the checkpoint directory resumes past
  the last round; a secagg federation whose global is the JAX server's
  unmask of the same masked uploads and the fixed-point mean of the
  clients' plaintext trees.
"""

import argparse
import json
import logging
import os
import threading

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, flat_tree, jax_variables

import chip_smoke

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def mmap_pins(monkeypatch):
    """The server and client ``main``s pin glibc's mmap threshold for their
    process; here they run in the test process, so a recorder takes the
    call and the test process's allocator is left as it was."""
    from fedcrack_tpu_torch.obs import sentries

    calls = []
    monkeypatch.setattr(sentries, "pin_mmap_threshold", lambda: calls.append(True) or True)
    return calls


@pytest.mark.parametrize("command", ["server", "client"])
def test_main_pins_the_mmap_threshold_once_before_anything_else(command, mmap_pins):
    import importlib

    main = importlib.import_module(f"fedcrack_tpu_torch.{command}").main
    with pytest.raises(SystemExit):
        main(["--no-such-flag"], device="cpu")
    assert mmap_pins == [True]

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


def _run_federation(server_argv, clients, timeout=240):
    """``server.main`` and one ``client.main`` per ``(name, argv)`` of
    ``clients`` in threads named after them, the clients pointed at the
    server's port; returns the exit codes and the captured log lines."""
    from fedcrack_tpu_torch import client, server

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
        for name, argv in clients:
            argv = [*argv, "--host", "127.0.0.1", "--port", str(port), "--name", name]
            threads.append(threading.Thread(target=run, args=(name, client.main, argv), name=name, daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(capture)
            lg.setLevel(level)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return codes, capture.messages


@pytest.fixture
def recorded(monkeypatch):
    """Per client thread, each fit's (round, base blob, trained blob) and
    each upload's (round, bytes, samples)."""
    from fedcrack_tpu_torch import client
    from fedcrack_tpu_torch.transport.client import FedClient

    fits, uploads = {}, {}
    make = client.make_train_fn

    def make_recording(*args, **kwargs):
        train_fn, holder = make(*args, **kwargs)

        def fit(blob, rnd, hparams):
            out, n_samples, metrics = train_fn(blob, rnd, hparams)
            fits.setdefault(threading.current_thread().name, []).append((rnd, blob, out))
            return out, n_samples, metrics

        return fit, holder

    push = FedClient._push

    def push_recording(self, method, upload, rnd, n_samples, *args, **kwargs):
        uploads.setdefault(self.cname, []).append((rnd, upload, n_samples))
        return push(self, method, upload, rnd, n_samples, *args, **kwargs)

    monkeypatch.setattr(client, "make_train_fn", make_recording)
    monkeypatch.setattr(FedClient, "_push", push_recording)
    return fits, uploads


def _jax_replay(config, uploads, seeds=None):
    """The JAX package's round machine fed the recorded uploads, round by
    round in client order."""
    from fedcrack_tpu.fed import rounds as JR

    state = JR.initial_state(config, jax_variables(TINY_KW, seed=5))
    names = sorted(uploads)
    for name in names:
        state, _ = JR.transition(state, JR.Ready(name, now=0.0, secagg_seed=(seeds or {}).get(name)))
    now = 1.0
    for i in range(len(uploads[names[0]])):
        for name in names:
            rnd, blob, ns = uploads[name][i]
            state, reply = JR.transition(state, JR.TrainDone(name, round=rnd, blob=blob, num_samples=ns, now=now))
            assert reply.status in (JR.RESP_ACY, JR.RESP_ARY, JR.FIN), reply
            now += 1.0
    return state


def _client_argv(config, image_dir, mask_dir, i, *extra):
    return ["--config", config, "--image-dir", image_dir, "--mask-dir", mask_dir, "--num-clients", "2",
            "--client-index", str(i), "--transport-dtype", "uint8", *extra]


def test_dp_clients_and_server_privacy_summary_and_ckpt_dir_match_jax(image_dirs, tmp_path, recorded):
    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.fed.rounds import privacy_summary
    from fedcrack_tpu.privacy.dpsgd import dp_update_host
    from fedcrack_tpu_torch import server
    from fedcrack_tpu_torch.ckpt import FedCheckpointer, load_state_file
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes

    (image_dir, mask_dir), _, config = image_dirs
    fits, uploads = recorded
    init = tmp_path / "init.msgpack"
    init.write_bytes(tree_to_bytes(jax_variables(TINY_KW, seed=5)))
    summary, ckpt_dir, state_path = (str(tmp_path / n) for n in ("privacy.json", "ckpt", "state.bin"))
    server_argv = ["--config", config, "--host", "127.0.0.1", "--port", "0", "--rounds", "2", "--cohort", "2",
                   "--registration-window", "60", "--init-weights", str(init), "--dp-clip-norm", "1.0",
                   "--dp-noise-multiplier", "1.1", "--dp-steps-per-round", "2", "--privacy-summary", summary,
                   "--ckpt-dir", ckpt_dir, "--state-path", state_path]
    dp = ["--dp-clip-norm", "0.05", "--dp-noise-multiplier", "0.5", "--dp-seed", "4"]
    codes, _ = _run_federation(server_argv, [(n, _client_argv(config, image_dir, mask_dir, i, *dp))
                                             for i, n in enumerate(chip_smoke.CLI_NAMES)])
    assert codes == {"server": 0, "client_0": 0, "client_1": 0}
    for name in chip_smoke.CLI_NAMES:
        assert [u[0] for u in uploads[name]] == [f[0] for f in fits[name]] == [1, 2]
        for (rnd, base, trained), (_, upload, _) in zip(fits[name], uploads[name]):
            want_base = jser.tree_from_bytes(base)
            private = dp_update_host(jser.tree_from_bytes(trained, template=want_base), want_base, clip_norm=0.05,
                                     noise_multiplier=0.5, dp_seed=4, cname=name, round_idx=rnd)
            assert upload == jser.tree_to_bytes(private), (name, rnd)
            assert upload != trained
    jcfg, _ = jax_server.build_config(server_argv)
    want = _jax_replay(jcfg, uploads)
    with open(summary, "rb") as f:
        assert f.read() == json.dumps(privacy_summary(want), sort_keys=True, indent=2).encode("utf-8")
    state = load_state_file(state_path, server.build_config(server_argv)[0])
    assert [h["epsilon"] for h in state.history] == [h["epsilon"] for h in want.history]
    assert dict(state.privacy_steps) == dict(want.privacy_steps) == {"client_0": 4, "client_1": 4}
    assert FedCheckpointer(ckpt_dir).latest_version() == 2

    # A restart on the checkpoint directory alone resumes past the last
    # round and finishes at once, with the history but not the DP spend
    # (only the statefile keeps it), as the JAX server does.
    os.remove(state_path)
    os.remove(summary)
    codes, messages = _run_federation(server_argv, [])
    assert codes == {"server": 0}
    assert any("resuming from checkpoint: round 3, model_version 2" in m for m in messages)
    assert any("federation finished: 2 rounds" in m for m in messages)
    with open(summary, encoding="utf-8") as f:
        resumed = json.load(f)
    assert resumed["dp"]["clients"] == {} and resumed["dp"]["enabled"] is True


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_private_train_fn_matches_the_jax_clients_privatization(wire):
    """The client's DP wrapper on a float32 and a bfloat16 wire: the base
    and trained blobs decode, the trained tree in the base's dtypes, and
    the re-encoded upload is the JAX client's bytes for the same blobs."""
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.privacy.dpsgd import dp_update_host
    from fedcrack_tpu_torch.client import private_train_fn
    from fedcrack_tpu_torch.configs import FedConfig

    cast = "bfloat16" if wire == "bfloat16" else None
    base_tree, trained_tree = jax_variables(TINY_KW, seed=1), jax_variables(TINY_KW, seed=2)
    base_blob = jser.tree_to_bytes(base_tree, cast_dtype=cast)
    trained_blob = jser.tree_to_bytes(trained_tree, cast_dtype=cast)
    cfg = FedConfig(dp_clip_norm=0.5, dp_noise_multiplier=0.3, dp_seed=9)
    private = private_train_fn(lambda blob, rnd, hparams: (trained_blob, 8, {"loss": 1.0}), cfg, "c")
    for rnd in (1, 2):
        upload, n_samples, metrics = private(base_blob, rnd, {})
        base = jser.tree_from_bytes(base_blob)
        want = dp_update_host(jser.tree_from_bytes(trained_blob, template=base), base, clip_norm=0.5,
                              noise_multiplier=0.3, dp_seed=9, cname="c", round_idx=rnd)
        assert upload == jser.tree_to_bytes(want) and (n_samples, metrics) == (8, {"loss": 1.0})


def test_secagg_federation_global_is_the_fixed_point_mean_of_the_plaintexts(image_dirs, tmp_path, recorded):
    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu.fed.rounds import privacy_summary
    from fedcrack_tpu_torch import server
    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu_torch.privacy import secagg

    (image_dir, mask_dir), _, config = image_dirs
    fits, uploads = recorded
    init = tmp_path / "init.msgpack"
    global0 = jax_variables(TINY_KW, seed=5)
    init.write_bytes(tree_to_bytes(global0))
    client_config = tmp_path / "client.json"
    client_config.write_text(json.dumps({**TINY_CONFIG, "secagg": True}))
    summary, state_path = str(tmp_path / "privacy.json"), str(tmp_path / "state.bin")
    server_argv = ["--config", config, "--host", "127.0.0.1", "--port", "0", "--rounds", "1", "--cohort", "2",
                   "--registration-window", "60", "--init-weights", str(init), "--secagg", "--privacy-summary",
                   summary, "--state-path", state_path]
    codes, _ = _run_federation(server_argv, [(n, _client_argv(str(client_config), image_dir, mask_dir, i))
                                             for i, n in enumerate(chip_smoke.CLI_NAMES)])
    assert codes == {"server": 0, "client_0": 0, "client_1": 0}
    state = load_state_file(state_path, server.build_config(server_argv)[0])
    names = list(chip_smoke.CLI_NAMES)
    assert all(secagg.is_masked_blob(uploads[n][0][1]) for n in names)
    assert state.history[-1]["secagg"] == {"maskers": names, "recovered": [], "bits": 24}
    assert state.history[-1]["codecs"] == {n: "secagg" for n in names}
    assert dict(state.secagg_roster) == {n: secagg.client_seed(n) for n in names}
    plain = [tree_from_bytes(fits[n][0][2]) for n in names]
    ns = [uploads[n][0][2] for n in names]
    mean = secagg.fixed_point_decode(secagg.weighted_fixed_sum(plain, ns), sum(ns), 24, global0)
    assert state.global_blob == tree_to_bytes(mean)
    jcfg, _ = jax_server.build_config(server_argv)
    want = _jax_replay(jcfg, uploads, seeds={n: secagg.client_seed(n) for n in names})
    assert want.global_blob == state.global_blob
    with open(summary, "rb") as f:
        assert f.read() == json.dumps(privacy_summary(want), sort_keys=True, indent=2).encode("utf-8")


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


# ---- configs/c6_s2d_layout.json through the command lines ----

C6 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "c6_s2d_layout.json")


@pytest.mark.parametrize("argv", [[], ["--rounds", "2", "--cohort", "2", "--port", "0"]], ids=["file", "flags"])
def test_build_config_matches_jax_for_c6(argv):
    """``--config configs/c6_s2d_layout.json``: both packages' server
    ``build_config`` give the same ``FedConfig`` (layouts, bf16, 8 mesh
    slots) and flags. ``train.centralized`` takes no ``--config`` in
    either package."""
    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu.train import centralized as jax_centralized
    from fedcrack_tpu_torch import server
    from fedcrack_tpu_torch.train import centralized

    got_cfg, got_args = server.build_config(["--config", C6, *argv])
    want_cfg, want_args = jax_server.build_config(["--config", C6, *argv])
    assert (got_cfg.model.stem_layout, got_cfg.model.res_layout, got_cfg.mesh_clients) == ("s2d", "packed", 8)
    assert json.loads(got_cfg.to_json()) == json.loads(want_cfg.to_json())
    assert vars(got_args) == vars(want_args)
    for main in (centralized.main, jax_centralized.main):
        with pytest.raises(SystemExit):
            main(["--config", C6])


def test_client_fit_runs_the_c6_layout_model(tmp_path):
    """A tiny-width copy of c6 through both packages' server
    ``build_config`` and ``make_train_fn`` (the client's fit): the port's
    model runs the space-to-depth stem and the packed residuals, two bf16
    steps land within the bounds of tests/test_torch_bf16.py's
    command-line test of JAX's fit, and the fit is bit-equal to the same
    fit with the reference layouts (oneDNN, tests/test_torch_layouts.py)."""
    import dataclasses

    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxDataset
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.train.federated import make_train_fn as jax_make_train_fn
    from fedcrack_tpu_torch import server
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import PackedResConv, S2DStemConv
    from fedcrack_tpu_torch.train.federated import make_train_fn

    with open(C6, encoding="utf-8") as f:
        tiny = dict(json.load(f), local_epochs=1)
    tiny["model"] = dict(tiny["model"], **TINY_CONFIG["model"])
    tiny["data"] = dict(tiny["data"], img_size=32, batch_size=4)
    path = tmp_path / "c6_tiny.json"
    path.write_text(json.dumps(tiny))
    cfg, _ = server.build_config(["--config", str(path)])
    jcfg, _ = jax_server.build_config(["--config", str(path)])
    imgs, msks = synth_crack_batch(8, 32, seed=5)
    variables = jax_variables(TINY_KW, seed=2)
    blob = jser.tree_to_bytes(variables)
    fits = {}
    for name, c in (("c6", cfg), ("reference", dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, stem_layout="reference", res_layout="reference")))):
        train_fn, holder = make_train_fn(c, ArrayDataset(imgs, msks, batch_size=4, shuffle=False), 4, device="cpu")
        model = holder["state"].model
        assert isinstance(model.stem_conv, S2DStemConv) == (name == "c6")
        assert isinstance(model.enc0_res, PackedResConv) == (name == "c6")
        fits[name] = train_fn(blob, 1, {})
    assert fits["c6"][0] == fits["reference"][0]
    jtrain_fn, _ = jax_make_train_fn(jcfg, JaxDataset(imgs, msks, batch_size=4, shuffle=False), 4)
    want, jn, jmetrics = jtrain_fn(blob, 1)
    got, n, metrics = fits["c6"]
    assert n == jn == 8
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=2.0 ** -8)
    g = dict(flat_tree(jser.tree_from_bytes(got)))
    w = dict(flat_tree(jser.tree_from_bytes(want)))
    start = dict(flat_tree(variables))
    for key, value in w.items():
        if key[0] == "params":
            bound = 2 * cfg.learning_rate * 1.0014 + float(np.spacing(np.abs(start[key]).max() + 1e-3))
            assert np.abs(g[key] - start[key]).max() <= bound, key
            assert np.abs(value - start[key]).max() <= bound, key
