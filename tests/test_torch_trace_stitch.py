"""``tools/trace_stitch`` in the port, held against the JAX package's on
the CPU, over span files written by both packages.

- Mirror of tests/test_tracing.py's stitcher tests: two per-process files
  carrying one lifecycle stitch into one complete chain, a missing stage
  breaks completeness without breaking the stitch, and the command line's
  exit codes; the port's result equals the JAX stitcher's on the same
  files.
- A real lifecycle across the packages: a JAX ``FedClient`` (its spans in
  one file, written by the JAX package's recorder) trains and pushes to a
  port ``FedServer`` whose flush, the statefile hot swap of a port
  ``ModelVersionManager`` and the first ``MicroBatcher`` batch on the new
  version write another file through the port's recorder. The port's
  stitcher joins the two into one complete ``client -> fed -> serve``
  chain under one trace id, as the JAX stitcher does.
"""

import json

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, port_config

pytestmark = pytest.mark.torch_port


def _write_spans(path, records):
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _synthetic_chain_files(tmp_path, *, break_stage=None):
    """tests/test_tracing.py's two per-process files."""
    trace = "fedtr-v4"
    client = [
        {"name": "client.train", "trace": trace, "span": 1, "parent": None,
         "t": 0.0, "dur_s": 0.5, "ctx": f"{trace}#train:c0:r5"},
        {"name": "client.push", "trace": trace, "span": 2, "parent": 1,
         "t": 0.5, "dur_s": 0.1, "ctx": f"{trace}#push:c0:r5"},
    ]
    serverside = [
        {"name": "fed.flush", "trace": trace, "span": 1, "parent": None,
         "t": 0.7, "dur_s": 0.0, "version": 5, "round": 5,
         "ctx": f"{trace}#flush:v5", "links": [f"{trace}#push:c0:r5"]},
        {"name": "serve.swap", "trace": trace, "span": 2, "parent": None,
         "t": 0.9, "dur_s": 0.02, "to_version": 5, "installed": True,
         "ctx": f"{trace}#swap:v5", "remote_parent": f"{trace}#flush:v5"},
        {"name": "serve.batch", "trace": trace, "span": 3, "parent": None,
         "t": 1.0, "dur_s": 0.01, "model_version": 5,
         "remote_parent": f"{trace}#swap:v5"},
    ]
    if break_stage is not None:
        serverside = [r for r in serverside if r["name"] != break_stage]
    tag = break_stage or "whole"
    a, b = tmp_path / f"client_{tag}.jsonl", tmp_path / f"server_{tag}.jsonl"
    _write_spans(a, client)
    _write_spans(b, serverside)
    return [str(a), str(b)]


def test_stitch_joins_per_process_files_into_a_complete_chain(tmp_path):
    from fedcrack_tpu.tools import trace_stitch as J
    from fedcrack_tpu_torch.tools.trace_stitch import load_records, stitch, summarize

    paths = _synthetic_chain_files(tmp_path)
    stitched = stitch(load_records(paths))
    assert stitched == J.stitch(J.load_records(paths))
    assert stitched["complete"] and stitched["n_complete"] == 1
    chain = stitched["best"]
    assert chain["trace"] == "fedtr-v4" and chain["planes_crossed"] == ["client", "fed", "serve"]
    assert len(chain["files"]) == 2
    assert chain["upstream"][0]["train"]["name"] == "client.train"
    assert chain["swap"]["name"] == "serve.swap" and chain["first_batch"]["name"] == "serve.batch"
    summary = summarize(stitched)
    assert summary == J.summarize(stitched) and summary["complete"] and summary["trace"] == "fedtr-v4"
    assert summary["stages"] == ["client.push", "client.train", "fed.flush", "serve.batch", "serve.swap"]
    broken_paths = _synthetic_chain_files(tmp_path, break_stage="serve.swap")
    broken = stitch(load_records(broken_paths))
    assert broken == J.stitch(J.load_records(broken_paths))
    assert not broken["complete"] and broken["best"]["first_batch"] is not None


def test_stitch_cli_exit_codes(tmp_path, capsys):
    from fedcrack_tpu_torch.tools import trace_stitch

    paths = _synthetic_chain_files(tmp_path)
    out_json = str(tmp_path / "stitched.json")
    assert trace_stitch.main(paths + ["--require", "client.push,fed.flush,serve.swap,serve.batch",
                                      "--json", out_json]) == 0
    assert json.load(open(out_json))["n_complete"] == 1
    assert json.loads(capsys.readouterr().out)["complete"]
    assert trace_stitch.main(paths + ["--require", "edge.flush_partial"]) == 1
    capsys.readouterr()
    assert trace_stitch.main(paths + ["--trace", "fedtr-v9"]) == 1
    capsys.readouterr()
    assert trace_stitch.main(_synthetic_chain_files(tmp_path, break_stage="serve.batch")) == 1


def test_real_lifecycle_across_both_packages_stitches_complete(tmp_path):
    import torch

    from fedcrack_tpu.configs import FedConfig as JaxFedConfig
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.obs import spans as jax_tracing
    from fedcrack_tpu.tools import trace_stitch as J
    from fedcrack_tpu.transport import FedClient as JaxFedClient
    from fedcrack_tpu_torch.configs import FedConfig, ServeConfig
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs import spans as tracing
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager
    from fedcrack_tpu_torch.tools.trace_stitch import stitch_files, summarize
    from fedcrack_tpu_torch.transport import FedServer
    from fedcrack_tpu_torch.transport.service import ServerThread

    cfg = port_config(dict(TINY_KW, img_size=16))
    global0 = init_variables(torch.Generator().manual_seed(0), cfg)
    client_path, server_path = tmp_path / "client.jsonl", tmp_path / "server.jsonl"
    state_path = str(tmp_path / "state.bin")

    def train_fn(blob, rnd):
        tree = jser.tree_from_bytes(blob)
        tree["params"]["head"]["bias"] = tree["params"]["head"]["bias"] + np.float32(0.01)
        return jser.tree_to_bytes(tree), 4, {"loss": 0.5}

    jax_tracing.install(str(client_path))
    tracing.install(str(server_path))
    try:
        server = FedServer(FedConfig(max_rounds=1, cohort_size=1, poll_period_s=0.05, host="127.0.0.1", port=0,
                                     state_path=state_path), global0, tick_period_s=0.05)
        with ServerThread(server) as st:
            client = JaxFedClient(JaxFedConfig(max_rounds=1, cohort_size=1, poll_period_s=0.05, host="127.0.0.1"),
                                  train_fn, cname="c0", port=st.port)
            result = client.run_session()
            assert result.rounds_completed == 1 and st.state.model_version == 1
        engine = InferenceEngine(cfg, ServeConfig(bucket_sizes=(16,), max_batch=2, tile_overlap=4), device="cpu")
        manager = ModelVersionManager(engine, global0, state_path=state_path, template=global0)
        assert manager.poll_once() and manager.version == 1
        with MicroBatcher(engine, manager) as batcher:
            answer = batcher.submit(np.zeros((16, 16, 3), np.uint8)).result(timeout=60)
        assert answer.model_version == 1
    finally:
        jax_tracing.uninstall()
        tracing.uninstall()
    paths = [str(client_path), str(server_path)]
    stitched = stitch_files(paths)
    summary = summarize(stitched)
    assert summary == J.summarize(J.stitch_files(paths))
    assert stitched["complete"] and summary["trace"] == "fedtr-v0"
    assert summary["planes_crossed"] == ["client", "fed", "serve"]
    assert summary["stages"] == ["client.push", "client.train", "fed.flush", "serve.batch", "serve.swap"]
    assert stitched["best"]["files"] == sorted(paths)
