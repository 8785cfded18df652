"""The port's ``tools/measure_baseline`` on the CPU at a tiny width: its
rows carry the JAX tool's keys (read from the JAX tool's source with
``ast``: the JAX mesh rows fail on this container's JAX, so that tool is
not run), c2 and c4 run over the port's gRPC in process, c5 on a ``(4,
2)`` mesh in bfloat16, and c3q's mesh round agrees with its host twin.

The presets are shrunk to ``stem 4, encoder (8,), decoder (8, 4)`` at 32
px through the tool's ``_load_preset``; the flags are the tool's own.
"""

import ast
import dataclasses
import json
import os

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--device", "cpu", "--samples", "32", "--epochs", "1", "--rounds", "1", "--mesh-steps", "1",
              "--mesh-img", "32", "--epochs-quality", "1"]


@pytest.fixture(autouse=True)
def _tiny_presets(monkeypatch):
    from fedcrack_tpu_torch.tools import measure_baseline

    real = measure_baseline._load_preset

    def tiny(name):
        cfg = real(name)
        model = dataclasses.replace(cfg.model, img_size=32, stem_features=4, encoder_features=(8,),
                                    decoder_features=(8, 4))
        return dataclasses.replace(cfg, model=model, data=dataclasses.replace(cfg.data, img_size=32))

    monkeypatch.setattr(measure_baseline, "_load_preset", tiny)


def _jax_keys():
    """Per JAX ``measure_*`` function: the keys of the row dict it returns
    (a ``**quality`` spread resolved to ``_eval_quality``'s keys) and, per
    nested dict, its literal keys."""
    with open(os.path.join(ROOT, "fedcrack_tpu", "tools", "measure_baseline.py"), encoding="utf-8") as f:
        module = ast.parse(f.read())
    fns = {n.name: n for n in module.body if isinstance(n, ast.FunctionDef)}

    def returned(fn):
        return [n for n in ast.walk(fns[fn]) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1].value

    quality = {k.value for k in returned("_eval_quality").keys}
    out = {}
    for name in ("measure_c1", "measure_c2", "measure_mesh", "measure_c3_mesh_program_quality"):
        d = returned(name)
        top, nested = set(), {}
        for k, v in zip(d.keys, d.values):
            if k is None:
                top |= quality
                continue
            top.add(k.value)
            if isinstance(v, ast.Dict):
                nested[k.value] = {kk.value for kk in v.keys if kk is not None}
        out[name] = (top, nested)
    hw = [n for n in ast.walk(fns["_hardware"]) if isinstance(n, ast.Return)][0].value
    out["_hardware"] = {k.value for k in hw.keys}
    return out


def _check_row(row, want):
    top, nested = want
    assert set(row) == top, sorted(set(row) ^ top)
    for key, literal in nested.items():
        assert literal <= set(row[key]), (key, sorted(literal - set(row[key])))


def _run(tmp_path, configs):
    from fedcrack_tpu_torch.tools import measure_baseline

    out = tmp_path / "baseline.json"
    assert measure_baseline.main(["--configs", configs, "--out", str(out)] + TINY_FLAGS) == 0
    with open(out, encoding="utf-8") as f:
        return json.load(f)


def test_mesh_and_centralized_rows_carry_the_jax_keys(tmp_path):
    """c1, c3 on (8, 1) and c5 on (4, 2) in bfloat16: every key of the JAX
    rows, the artifact's schema, finite quality, the CPU named as such."""
    want = _jax_keys()
    artifact = _run(tmp_path, "c1,c3,c5")
    assert set(artifact) == {"generated_by", "hardware", "rows"}
    assert artifact["generated_by"] == "fedcrack_tpu_torch.tools.measure_baseline"
    assert want["_hardware"] <= set(artifact["hardware"])
    assert artifact["hardware"] == {"platform": "cpu", "device_kind": "cpu", "n_devices": 1, "power_limit": None}
    c1, c3, c5 = artifact["rows"]
    _check_row(c1, want["measure_c1"])
    for row in (c3, c5):
        _check_row(row, want["measure_mesh"])
    assert [r["config"] for r in artifact["rows"]] == ["c1_single_client_cpu", "c3_eight_client_mesh",
                                                       "c5_bf16_batch_dp"]
    assert (c3["workload"]["clients"], c3["workload"]["batch_dp"]) == (8, 1)
    assert (c5["workload"]["clients"], c5["workload"]["batch_dp"], c5["workload"]["compute_dtype"]) == (
        4, 2, "bfloat16")
    for row in artifact["rows"]:
        assert all(isinstance(row[k], float) and 0.0 <= row[k] < 1e3 for k in ("val_loss", "pixel_acc", "iou"))


def test_grpc_rows_carry_the_jax_keys(tmp_path):
    """c2 and c4 over the port's gRPC server and clients in process: two
    clients enrolled, the round's bytes counted both ways, the final
    global evaluated."""
    want = _jax_keys()
    artifact = _run(tmp_path, "c2,c4")
    c2, c4 = artifact["rows"]
    for row in (c2, c4):
        _check_row(row, want["measure_c2"])
        assert row["workload"]["clients"] == 2
        assert row["control_plane_bytes"]["received_per_round"] > 0
        assert row["val_loss"] is not None
    assert (c2["config"], c4["config"], c4["workload"]["partition"], c4["workload"]["fedprox_mu"]) == (
        "c2_two_client_grpc", "c4_noniid_fedprox", "skew", 0.01)


def test_c3q_mesh_round_agrees_with_its_host_twin(tmp_path):
    """The mesh round's steps are the host twin's ``train_step``s, so the
    two finals differ only in the fold's rounding: quality equal, every
    leaf but the BN-fed biases within 1e-5."""
    artifact = _run(tmp_path, "c3q")
    (row,) = artifact["rows"]
    _check_row(row, _jax_keys()["measure_c3_mesh_program_quality"])
    assert row["quality_equal"] is True
    assert row["max_abs_param_diff_other_leaves"] <= 1e-5


def test_defaults_to_cuda_and_raises_without_it(tmp_path):
    import torch

    from fedcrack_tpu_torch.tools import measure_baseline

    if torch.cuda.is_available():
        return  # decided at run time; chip_smoke.py runs the tool on the card
    with pytest.raises(RuntimeError, match="cuda"):
        measure_baseline.main(["--configs", "c3", "--out", str(tmp_path / "a.json"), "--mesh-img", "32"])
