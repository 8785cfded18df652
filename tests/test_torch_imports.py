"""The port stands alone: ``fedcrack_tpu_torch/`` and ``chip_smoke.py``
import neither JAX (nor flax/optax) nor anything of ``fedcrack_tpu``, and
the port's entry points run on CUDA unless told otherwise.
"""

import ast
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fedcrack_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fedcrack_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_package_imports():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter where
    ``import jax`` (and the JAX package) would raise."""
    modules = []
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            modules.append("chip_smoke")
            continue
        mod = rel[:-3].replace(os.sep, ".")
        modules.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') and sys.modules[m] is not None\n"
        "               for m in sys.modules)\n"
        "print('ok', len(" + repr(modules) + "))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_engine_defaults_to_cuda_and_raises_without_it():
    import torch

    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    if torch.cuda.is_available():
        engine = InferenceEngine(serve_config=ServeConfig())
        assert engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(serve_config=ServeConfig())
    assert InferenceEngine(serve_config=ServeConfig(), device="cpu").device.type == "cpu"


def test_model_defaults_to_cuda_and_raises_without_it():
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import ResUNet

    cfg = ModelConfig(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
    if torch.cuda.is_available():
        assert next(ResUNet(cfg).parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ResUNet(cfg)
    assert next(ResUNet(cfg, device="cpu").parameters()).device.type == "cpu"
    assert next(ResUNet(cfg, device="meta").parameters()).device.type == "meta"


def test_chip_smoke_refuses_to_run_without_cuda():
    """No result line and a non-zero exit where there is no CUDA device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # decided at run time, never at import
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.train.federated import make_train_fn
    from fedcrack_tpu_torch.train.local import create_train_state

    cfg = ModelConfig(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
    fed = FedConfig(model=cfg, data=DataConfig(img_size=32))
    if torch.cuda.is_available():
        assert create_train_state(torch.Generator(), cfg).device.type == "cuda"
        assert make_train_fn(fed, [], 2)[1]["state"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_fn(fed, [], 2)
    assert create_train_state(torch.Generator(), cfg, device="cpu").device.type == "cpu"
