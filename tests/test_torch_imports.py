"""The port stands alone: ``fedcrack_tpu_torch/`` and ``chip_smoke.py``
import neither JAX (nor flax/optax) nor anything of ``fedcrack_tpu``, nor
msgpack, ml_dtypes or protobuf's ``google``: the port brings its own
msgpack codec, bfloat16 cast and protobuf wire codec. The card's machine
has msgpack, ml_dtypes and grpc installed, which would hide such an
import there, so the check is made here. ``grpc`` is allowed in the
transport (``fedcrack_tpu_torch/transport/``) and in ``chip_smoke.py``
only, so the rest of the port imports without it. The port's entry
points run on CUDA unless told otherwise.
"""

import ast
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fedcrack_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fedcrack_tpu", "msgpack", "ml_dtypes", "grpc",
             "google")
# grpc is allowed in these files only.
TRANSPORT = os.path.join(PACKAGE, "transport")
GRPC_ALLOWED = ("grpc",)


def _port_sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _grpc_allowed(path):
    return path.startswith(TRANSPORT + os.sep) or os.path.basename(path) == "chip_smoke.py"


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
        forbidden = set(FORBIDDEN) - (set(GRPC_ALLOWED) if _grpc_allowed(path) else set())
        bad = sorted(set(_imported_roots(path)) & forbidden)
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    assert any("grpc" in _imported_roots(p) for p in sources if p.startswith(TRANSPORT))


def _module(path):
    rel = os.path.relpath(path, ROOT)
    if rel == "chip_smoke.py":
        return "chip_smoke"
    mod = rel[:-3].replace(os.sep, ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def _import_blocked(modules, blocked):
    """Import ``modules`` in a fresh interpreter where each of ``blocked``
    would raise on import; returns the completed process."""
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') and sys.modules[m] is not None\n"
        "               for m in sys.modules)\n"
        "print('ok', len(" + repr(modules) + "))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter where
    ``import jax`` (and the JAX package) would raise: all but the
    transport and the smoke with grpc blocked too, and those in a second
    interpreter where only grpc is allowed."""
    sources = list(_port_sources())
    rest = [_module(p) for p in sources if not _grpc_allowed(p)]
    with_grpc = [_module(p) for p in sources if _grpc_allowed(p)]
    assert "fedcrack_tpu_torch.transport.service" in with_grpc and "fedcrack_tpu_torch" in rest
    for modules, blocked in ((rest, FORBIDDEN), (with_grpc, tuple(m for m in FORBIDDEN if m not in GRPC_ALLOWED))):
        out = _import_blocked(modules, blocked)
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
