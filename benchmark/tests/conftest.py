"""Fixtures of the benchmark's own tests.

Run them from the root of the repository, apart from the repository's
test suite (whose root conftest loads the JAX package):

    python -m pytest benchmark/tests --confcutdir=benchmark -q

Tests marked ``card`` need a CUDA card and skip without one.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SMALL = {"stem_features": 8, "encoder_features": [16, 16, 16], "decoder_features": [16, 16, 16, 8]}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def read(path):
    with open(path) as f:
        return json.load(f)


def with_pending(spec: dict) -> dict:
    """``spec`` with the cells of ``benchmark/pending.json`` added, as a
    later change that proves them adds them."""
    pending = read(os.path.join(ROOT, "benchmark", "pending.json"))
    out = dict(spec)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in spec[group]}
        out[group] = list(spec[group]) + [e for e in pending[group] if e["name"] not in names]
    return out


def checkout(tmp_path):
    """A copy of the benchmark's files, its BENCHMARK.json with the
    pending cells added."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    write(root / "BENCHMARK.json", with_pending(read(os.path.join(ROOT, "BENCHMARK.json"))))
    return root


@pytest.fixture
def full_root(tmp_path):
    """The benchmark at its own sizes, pending cells included."""
    return str(checkout(tmp_path))


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark's data at a size the CPU runs in seconds:
    narrow widths, 32-pixel tiles, few callers, clients and steps. The
    limits are set for this size from its own readings (the tests note
    them); the code is the repository's."""
    root = checkout(tmp_path)
    b = root / "benchmark"
    c = read(b / "configs" / "resunet-int8-fused.json")
    c["model"].update(SMALL)
    c["serve"].update({"bucket_sizes": [32], "tile_overlap": 8, "max_batch": 4, "max_delay_ms": 2.0})
    write(b / "configs" / "resunet-int8-fused.json", c)
    c = read(b / "configs" / "resunet-f32-fed8.json")
    c["fed"]["model"].update(SMALL, img_size=32)
    c["fed"]["data"].update(img_size=32, batch_size=4)
    c["fed"]["mesh_clients"] = 2
    write(b / "configs" / "resunet-f32-fed8.json", c)
    write(b / "traffic" / "photos-c4.json", {"driver": "photos", "callers": 2, "pool": 2,
                                             "shapes": [[48, 64], [64, 48]], "check_per_caller": 1,
                                             "check_within": 2, "profile_per_caller": 1})
    write(b / "traffic" / "patches-c8.json", {"driver": "patches", "callers": 3, "pool": 4, "size": 32,
                                              "check_per_caller": 2, "check_within": 3, "profile_per_caller": 1})
    write(b / "traffic" / "rounds-s2.json", {"driver": "rounds", "pool": 48, "steps": 2, "check_rounds": 3,
                                             "profile_rounds": 1})
    # Readings at this size on the CPU (seeds 1, 2, 3, 2**31 + 7, 2**31 +
    # 4242), the program's highest and the TF32 control's lowest: serving
    # max_prob_gap 3.0e-7 and 2.1e-4; the rounds' loss_gap 6.7e-7 and
    # 9.9e-4, grad1_gap 3.8e-6 and 3.5e-2, change3_gap 2.8e-3 and 4.6e-2.
    write(b / "limits" / "photos-tiled-c4.json", {"max_prob_gap": 2e-5})
    write(b / "limits" / "patches-c8.json", {"max_prob_gap": 2e-5})
    write(b / "limits" / "fed8-round-256.json", {"loss_gap": 5e-5, "grad1_gap": 1e-3, "change3_gap": 1.5e-2})
    return str(root)
