"""The ledger's JSONL export (``health/ledger.py``) and the joined health
report (``tools/health_report.py``) held against the JAX package's on the
CPU.

- The same round scripts through both packages' round machines leave
  ledgers whose ``write_ledger_jsonl`` files are byte-equal, whichever
  package writes; ``read_ledger_jsonl`` and ``conservation`` agree, a
  broken ledger included.
- ``build_report`` and ``validate_report`` agree on the same artifacts:
  the ledger with quarantines and rejects, a canary history, a drift
  comparison and a privacy summary, and on each broken variant.
- ``main`` exits 0 on a clean report and 1 on a violation, printing or
  writing the same document as the JAX command.
"""

import json

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port


def _tree(v: float):
    return {"params": {"w": np.full((4, 4), float(v), np.float32)}}


def _drive(pkg: str, values: dict, quarantine: bool):
    """Two FedAvg rounds of ``values``' clients through ``pkg``'s round
    machine, each with a NaN upload (a sanitation reject) before the
    valid ones and a late re-upload (a resync); returns its ledger."""
    if pkg == "jax":
        from fedcrack_tpu.configs import FedConfig
        from fedcrack_tpu.fed import rounds as R
        from fedcrack_tpu.fed.serialization import tree_to_bytes
    else:
        from fedcrack_tpu_torch.configs import FedConfig
        from fedcrack_tpu_torch.fed import rounds as R
        from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    cfg = FedConfig(cohort_size=len(values), max_rounds=3, registration_window_s=100.0,
                    **({"quarantine_z": 3.5} if quarantine else {}))
    state = R.initial_state(cfg, _tree(0.0))
    names = sorted(values)
    for i, name in enumerate(names):
        state, _ = R.transition(state, R.Ready(name, now=0.1 * i))
    for rnd in (1, 2):
        nan = tree_to_bytes(_tree(float("nan")))
        state, _ = R.transition(state, R.TrainDone(names[-1], round=rnd, blob=nan, num_samples=4, now=rnd))
        for i, name in enumerate(names):
            blob = tree_to_bytes(_tree(values[name] * rnd))
            state, _ = R.transition(state, R.TrainDone(name, round=rnd, blob=blob, num_samples=4 + i,
                                                       now=rnd + 0.1 * i))
        state, _ = R.transition(state, R.TrainDone(names[0], round=rnd, blob=blob, num_samples=4, now=rnd + 0.5))
    return state.ledger


SCRIPTS = {
    "honest": ({"a": 1.0, "b": 1.2, "c": 0.9}, False),
    "scaled": ({"a": 1.0, "b": 1.1, "c": 1.05, "d": 900.0}, True),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_ledger_jsonl_bytes_and_conservation_match_jax(script, tmp_path):
    from fedcrack_tpu.health import ledger as jl
    from fedcrack_tpu_torch.health import ledger as tl

    values, quarantine = SCRIPTS[script]
    ours, theirs = _drive("port", values, quarantine), _drive("jax", values, quarantine)
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax", "port_of_jax")}
    assert tl.write_ledger_jsonl(ours, paths["port"]) == jl.write_ledger_jsonl(theirs, paths["jax"]) == len(values)
    tl.write_ledger_jsonl(theirs, paths["port_of_jax"])
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["port"] == blobs["jax"] == blobs["port_of_jax"]
    assert tl.read_ledger_jsonl(paths["jax"]) == jl.read_ledger_jsonl(paths["jax"])
    assert tl.conservation(ours) == jl.conservation(theirs) == {"clients": len(values), "violations": []}
    assert sum(sum(r["rejected"].values()) for r in ours.values()) >= 1
    broken = tl.read_ledger_jsonl(paths["port"])
    broken["a"]["offers"] += 1
    assert tl.conservation(broken) == jl.conservation(broken) == {"clients": len(values), "violations": ["a"]}


CANARY = {
    "history": [
        {"version": 0, "iou": 1.0, "per_bucket": {"128": 1.0, "256": 1.0}, "reference_version": 0,
         "probe_batch": 4, "probe_seed": 0},
        {"version": 2, "iou": 0.991, "per_bucket": {"128": 0.993, "256": 0.991}, "reference_version": 0,
         "probe_batch": 4, "probe_seed": 0},
    ],
    "audit": {"evals": 2, "reference_version": 0, "min_iou": 0.991, "all_finite_unit": True},
}
PRIVACY = {
    "dp": {"enabled": True, "clip_norm": 1.0, "noise_multiplier": 1.1, "sample_rate": 0.01, "delta": 1e-5,
           "epsilon_budget": 8.0, "clients": {"a": {"steps": 4, "epsilon": 0.31}, "b": {"steps": 8, "epsilon": 0.44}},
           "max_epsilon": 0.44},
    "secagg": {"enabled": False, "bits": 32, "roster_size": 0},
}


def _artifacts(tmp_path, ledger):
    from fedcrack_tpu_torch.health.drift import DriftMonitor, write_drift_json
    from fedcrack_tpu_torch.health.ledger import write_ledger_jsonl

    rng = np.random.default_rng(1)
    ref, cur = DriftMonitor(), DriftMonitor()
    for mon, power in ((ref, 1.0), (cur, 2.0)):
        for size in (16, 32):
            mon.observe(rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8),
                        (rng.random((2, size, size, 1)) ** power).astype(np.float32))
    paths = {k: str(tmp_path / v) for k, v in (("ledger", "ledger.jsonl"), ("canary", "canary.json"),
                                                ("drift", "drift.json"), ("privacy", "privacy.json"))}
    write_ledger_jsonl(ledger, paths["ledger"])
    write_drift_json(paths["drift"], reference=ref.profile(), current=cur.profile(), psis=cur.compare(ref.profile()))
    for key, doc in (("canary", CANARY), ("privacy", PRIVACY)):
        with open(paths[key], "w", encoding="utf-8") as f:
            json.dump(doc, f)
    return paths


def _without_origin(report):
    return {k: v for k, v in report.items() if k != "generated_by"}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_build_and_validate_report_match_jax(script, tmp_path):
    from fedcrack_tpu.tools import health_report as jh
    from fedcrack_tpu_torch.tools import health_report as th

    values, quarantine = SCRIPTS[script]
    paths = _artifacts(tmp_path, _drive("port", values, quarantine))
    args = (paths["ledger"], paths["canary"], paths["drift"], paths["privacy"])
    got, want = th.build_report(*args), jh.build_report(*args)
    assert got["generated_by"] == "fedcrack_tpu_torch.tools.health_report"
    assert _without_origin(got) == _without_origin(want)
    assert th.validate_report(got) == jh.validate_report(want) == []
    assert got["drift"]["signals"] == ["confidence", "crack_fraction", "entropy", "input"]
    if quarantine:
        assert got["summary"]["quarantines"] >= 1 and got["summary"]["quarantined_clients"] == ["d"]
        assert got["summary"]["flagged_clients"] == ["d"]
    bare = th.build_report(paths["ledger"])
    assert (bare["canary"], bare["drift"], bare["privacy"]) == (None, None, None)
    assert _without_origin(bare) == _without_origin(jh.build_report(paths["ledger"]))


def _break(report, path, value):
    out = json.loads(json.dumps(report))
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return out


BREAKS = {
    "conservation": (("clients", "a", "offers"), 99),
    "quarantined_type": (("clients", "a", "quarantined"), "2"),
    "norm_nan": (("clients", "a", "norms"), [1.0, float("nan")]),
    "canary_iou": (("canary", "history", 1, "iou"), 1.5),
    "canary_missing": (("canary", "history"), None),
    "psi_nan": (("drift", "psi", "16/input"), float("nan")),
    "psi_key": (("drift", "psi", "nobucket"), 0.1),
    "max_epsilon": (("privacy", "dp", "max_epsilon"), 99.0),
    "enabled_int": (("privacy", "dp", "enabled"), 1),
    "epsilon_nan": (("privacy", "dp", "clients", "a", "epsilon"), float("nan")),
    "secagg_missing": (("privacy", "secagg"), None),
    "summary_type": (("summary", "offers"), 1.5),
}


@pytest.mark.parametrize("name", sorted(BREAKS))
def test_validate_report_violations_match_jax(name, tmp_path):
    from fedcrack_tpu.tools import health_report as jh
    from fedcrack_tpu_torch.tools import health_report as th

    paths = _artifacts(tmp_path, _drive("port", *SCRIPTS["honest"]))
    report = th.build_report(paths["ledger"], paths["canary"], paths["drift"], paths["privacy"])
    broken = _break(report, *BREAKS[name])
    got = th.validate_report(broken)
    assert got and got == jh.validate_report(broken)


def test_main_exit_codes_and_output_match_jax(tmp_path, capsys):
    from fedcrack_tpu.tools import health_report as jh
    from fedcrack_tpu_torch.tools import health_report as th

    paths = _artifacts(tmp_path, _drive("port", *SCRIPTS["scaled"]))
    argv = ["--ledger", paths["ledger"], "--canary", paths["canary"], "--drift", paths["drift"],
            "--privacy", paths["privacy"]]
    runs = {}
    for label, mod in (("port", th), ("jax", jh)):
        out = str(tmp_path / f"{label}.json")
        assert mod.main(argv + ["--out", out]) == 0
        printed = capsys.readouterr().out.splitlines()
        assert printed[0] == f"wrote {out}"
        runs[label] = (json.loads(open(out, encoding="utf-8").read()), "\n".join(printed[1:]))
    assert _without_origin(runs["port"][0]) == _without_origin(runs["jax"][0])
    assert runs["port"][1] == runs["jax"][1]
    assert th.main(argv) == 0
    assert _without_origin(json.loads(capsys.readouterr().out)) == _without_origin(runs["jax"][0])
    bad = dict(PRIVACY, dp=dict(PRIVACY["dp"], max_epsilon=99.0))
    with open(paths["privacy"], "w", encoding="utf-8") as f:
        json.dump(bad, f)
    assert th.main(argv) == jh.main(argv) == 1
    assert "SCHEMA privacy.dp.max_epsilon 99.0 != per-client max 0.44" in capsys.readouterr().err
