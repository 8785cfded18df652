"""Nothing of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "torch", "numpy", "benchmark", "math"}, (path, tops)
        assert not any(name.startswith("benchmark.") and not name.startswith("benchmark.reference")
                       for name in _imports(path)), path


def test_top_level_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    import types

    monkeypatch.setitem(sys.modules, "fedcrack_tpu_torch_probe", types.ModuleType("fedcrack_tpu_torch_probe"))
    assert "fedcrack_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fedcrack_tpu.probe", types.ModuleType("fedcrack_tpu.probe"))
    assert "fedcrack_tpu" in harness.forbidden_modules()


def test_loading_every_module_leaves_no_forbidden_name():
    code = (
        "import sys, os, importlib, glob\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness, run, calibrate, faults, trace\n"
        "from benchmark.drivers import photos, patches, rounds\n"
        f"for p in glob.glob(os.path.join({BENCH!r}, 'metrics', '*.py')): harness.load_module(p)\n"
        "import fedcrack_tpu_torch.serve.engine, fedcrack_tpu_torch.serve.batcher\n"
        "import fedcrack_tpu_torch.parallel.driver, fedcrack_tpu_torch.parallel.fedavg_mesh\n"
        "import fedcrack_tpu_torch.kernels.forward\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fed8-round-256", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
