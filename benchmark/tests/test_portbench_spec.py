"""BENCHMARK.json and the files it names: present, well-formed, within the
contract's limits, and extensible by adding files only."""

import json
import os
import re
import time

import pytest
import torch

from benchmark import harness
from conftest import ROOT, read, with_pending, write

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module", params=["committed", "with_pending"])
def spec(request):
    """BENCHMARK.json, and BENCHMARK.json with the pending cells added."""
    spec = harness.load_spec(ROOT)
    return spec if request.param == "committed" else with_pending(spec)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= len(spec["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_names_units_and_lines(spec):
    named = spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)), group
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")


def test_every_named_file_loads(spec, tmp_path):
    write(tmp_path / "BENCHMARK.json", spec)
    os.symlink(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    for c in spec["configs"]:
        cfg = read(os.path.join(ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        ctx = harness.context(str(tmp_path), w["name"], 1, torch.device("cpu"))
        assert harness.driver(ctx).compare
        assert ctx.limits
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")).read)


def test_every_config_used_and_every_cell_reports(spec):
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(spec, w["name"], True)


def test_per_layer_moves_is_reported_by_each_of_its_cells(spec):
    for m in spec["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.cell_metrics(spec, cell, False)}, (m["name"], cell)


def test_shares_of_a_peak_are_percent(spec):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_is_found_with_no_code_edit(small_root):
    """A later change adds a cell by adding data: a traffic file, a limits
    file and the cell's entry."""
    b = os.path.join(small_root, "benchmark")
    write(os.path.join(b, "traffic", "photos-c2-square.json"),
          {"driver": "photos", "callers": 2, "pool": 2, "shapes": [[64, 64]], "check_per_caller": 1,
           "check_within": 2, "profile_per_caller": 1})
    write(os.path.join(b, "limits", "photos-square.json"), {"max_prob_gap": 2e-5})
    spec = read(os.path.join(small_root, "BENCHMARK.json"))
    spec["workloads"].append({"name": "photos-square", "config": "resunet-int8-fused", "traffic": "photos-c2-square",
                              "chips": 1, "why": "square photos"})
    for m in spec["end_to_end"]:
        if m["name"] in ("serve_mpix_per_s", "photo_p95_ms"):
            m["workloads"].append("photos-square")
    write(os.path.join(small_root, "BENCHMARK.json"), spec)
    result, checks, _ = harness.run_cell(small_root, "photos-square", 7, 0.5, False, torch.device("cpu"),
                                         time.perf_counter())
    assert result["correct"], checks
    assert set(result["metrics"]) == {"serve_mpix_per_s", "photo_p95_ms", "setup_s"}
    assert result["attempted"] > 0
