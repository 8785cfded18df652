"""The port stands alone: ``fedcrack_tpu_torch/`` and ``chip_smoke.py``
import neither JAX (nor flax/optax) nor anything of ``fedcrack_tpu``, nor
msgpack, ml_dtypes or protobuf's ``google``: the port brings its own
msgpack codec, bfloat16 cast and protobuf wire codec. The card's machine
has msgpack, ml_dtypes and grpc installed, which would hide such an
import there, so the check is made here. ``grpc`` is allowed in the
transport (``fedcrack_tpu_torch/transport/``), in the serving front door
(``fedcrack_tpu_torch/serve/service.py``) and in ``chip_smoke.py`` only,
so the rest of the port imports without it: the fleet, router, stream
sessions, autoscaler, shadow controller, canary and drift monitors, the
serve command's module level, the tools (``load_gen`` reaches the
front door through ``transport/serve_client.py``), the privacy plane, the
round checkpointer, the chaos plane and the watch layer, the aggregation
tree and the chaos drills (the drills reach grpc through the transport
only), and the slot and spatial planes with ``tools.refscale_federation``
and ``tools.measure_baseline`` included, the multi-process plane
``parallel.multihost``, the fedlint engine (``analysis/`` and
``tools/fedlint.py``, the standard library and the port only) and the
concurrent soak (``tools/soak.py``, which reaches grpc through the
transport and the serving front door). The port's entry points run on CUDA unless told
otherwise, every refusal of a part not yet ported names the ROADMAP item
that lifts it, and ``h5py`` is imported only lazily by the Keras h5
bridge (``tools/h5_import.py``, ``tools/h5_export.py``).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fedcrack_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fedcrack_tpu", "msgpack", "ml_dtypes", "grpc",
             "google")
# grpc is allowed in these files only.
TRANSPORT = os.path.join(PACKAGE, "transport")
SERVE_FRONT_DOOR = os.path.join(PACKAGE, "serve", "service.py")
GRPC_ALLOWED = ("grpc",)
COMMAND_LINE_MODULES = (
    "fedcrack_tpu_torch.server", "fedcrack_tpu_torch.client", "fedcrack_tpu_torch.train.centralized",
    "fedcrack_tpu_torch.data", "fedcrack_tpu_torch.data.sharding", "fedcrack_tpu_torch.native",
    "fedcrack_tpu_torch.obs", "fedcrack_tpu_torch.obs.tb", "fedcrack_tpu_torch.obs.promexp",
    "fedcrack_tpu_torch.obs.metrics", "fedcrack_tpu_torch.serve.__main__", "fedcrack_tpu_torch.serve.fleet",
    "fedcrack_tpu_torch.serve.router", "fedcrack_tpu_torch.serve.stream", "fedcrack_tpu_torch.serve.autoscaler",
    "fedcrack_tpu_torch.serve.shadow", "fedcrack_tpu_torch.health.canary", "fedcrack_tpu_torch.health.drift",
    "fedcrack_tpu_torch.tools", "fedcrack_tpu_torch.tools.quantify", "fedcrack_tpu_torch.tools.load_gen",
    "fedcrack_tpu_torch.tools.health_report",
)
# The privacy plane and the round checkpointer: no JAX, flax, orbax, optax,
# msgpack or fedcrack_tpu, and no grpc either.
PRIVACY_AND_CHECKPOINT_MODULES = (
    "fedcrack_tpu_torch.privacy", "fedcrack_tpu_torch.privacy.accountant", "fedcrack_tpu_torch.privacy.dpsgd",
    "fedcrack_tpu_torch.privacy.secagg", "fedcrack_tpu_torch.ckpt", "fedcrack_tpu_torch.ckpt.manager",
)
# The chaos plane and the watch layer: no grpc either (the injected flap,
# a grpc.RpcError, lives in transport/faults.py and is loaded lazily).
CHAOS_AND_WATCH_MODULES = (
    "fedcrack_tpu_torch.chaos", "fedcrack_tpu_torch.chaos.plan", "fedcrack_tpu_torch.chaos.inject",
    "fedcrack_tpu_torch.obs.sentries", "fedcrack_tpu_torch.obs.watchdog", "fedcrack_tpu_torch.tools.trace_stitch",
)
# The aggregation tree and the chaos drills: no grpc at import either (the
# edge relay, transport/edge.py, is the transport's).
TREE_AND_DRILL_MODULES = ("fedcrack_tpu_torch.fed.tree", "fedcrack_tpu_torch.tools.chaos_drill")
# The slot plane (several clients per round on one card), the spatial
# plane and their tools: no grpc either (measure_baseline's gRPC rows reach
# the transport only when they run).
SLOT_PLANE_MODULES = (
    "fedcrack_tpu_torch.parallel", "fedcrack_tpu_torch.parallel.slots", "fedcrack_tpu_torch.parallel.fedavg_mesh",
    "fedcrack_tpu_torch.parallel.driver", "fedcrack_tpu_torch.parallel.spatial", "fedcrack_tpu_torch.compress.mesh",
    "fedcrack_tpu_torch.tools.refscale_federation", "fedcrack_tpu_torch.tools.measure_baseline",
    "fedcrack_tpu_torch.parallel.multihost",
)


# The fedlint engine and the concurrent soak: no grpc at import either
# (the soak reaches the transport and the serving plane inside run_soak).
ANALYSIS_AND_SOAK_MODULES = (
    "fedcrack_tpu_torch.analysis", "fedcrack_tpu_torch.analysis.engine", "fedcrack_tpu_torch.analysis.rules",
    "fedcrack_tpu_torch.analysis.rules.locks", "fedcrack_tpu_torch.analysis.rules.kernel_plane",
    "fedcrack_tpu_torch.analysis.rules.trace", "fedcrack_tpu_torch.tools.fedlint", "fedcrack_tpu_torch.tools.soak",
)
# The lint engine and its command line are host code over ``ast``: the
# standard library and the port only, no torch, numpy or grpc.
ANALYSIS = os.path.join(PACKAGE, "analysis")
FEDLINT = os.path.join(PACKAGE, "tools", "fedlint.py")


# h5py is allowed in the Keras h5 bridge only, and only inside its
# functions: the card's machine does not promise it.
H5PY_ALLOWED = (os.path.join(PACKAGE, "tools", "h5_import.py"), os.path.join(PACKAGE, "tools", "h5_export.py"))


def _port_sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _grpc_allowed(path):
    return (path.startswith(TRANSPORT + os.sep) or path == SERVE_FRONT_DOOR
            or os.path.basename(path) == "chip_smoke.py")


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
    assert "fedcrack_tpu_torch.serve.service" in with_grpc
    assert "fedcrack_tpu_torch.transport.serve_client" in with_grpc
    # The command lines and their data and telemetry, and the serving
    # fleet, import without grpc: only their sessions and the serving front
    # door reach it.
    assert set(COMMAND_LINE_MODULES) <= set(rest)
    assert set(PRIVACY_AND_CHECKPOINT_MODULES) <= set(rest)
    assert set(CHAOS_AND_WATCH_MODULES) <= set(rest)
    assert set(TREE_AND_DRILL_MODULES) <= set(rest)
    assert set(SLOT_PLANE_MODULES) <= set(rest)
    assert set(ANALYSIS_AND_SOAK_MODULES) <= set(rest)
    assert "fedcrack_tpu_torch.transport.faults" in with_grpc
    assert "fedcrack_tpu_torch.transport.edge" in with_grpc
    for modules, blocked in ((rest, FORBIDDEN), (with_grpc, tuple(m for m in FORBIDDEN if m not in GRPC_ALLOWED))):
        out = _import_blocked(modules, blocked)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("ok")


def test_analysis_and_fedlint_import_only_the_standard_library_and_the_port():
    """``analysis/`` and ``tools/fedlint.py`` keep their own copy of the
    lint engine: they import the standard library and the port, and never
    ``fedcrack_tpu.analysis`` (which is JAX-free, but the JAX package's)."""
    paths = [p for p in _port_sources() if p.startswith(ANALYSIS + os.sep) or p == FEDLINT]
    assert len(paths) >= 19
    for path in paths:
        rel = os.path.relpath(path, ROOT)
        roots = set(_imported_roots(path))
        assert roots <= set(sys.stdlib_module_names) | {"fedcrack_tpu_torch"}, (rel, sorted(roots))
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n == "fedcrack_tpu.analysis" or n.startswith("fedcrack_tpu.analysis.") for n in names), \
                os.path.relpath(path, ROOT)


def _not_implemented_raises(source):
    """``(line, message, abstract)`` for every ``raise NotImplementedError``
    in ``source``: the message's string constants joined (f-string parts
    included), and whether the raise is a bare one that makes up a whole
    method body (an abstract method, not a refusal)."""
    tree = ast.parse(source)
    abstract = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            body = [n for n in fn.body if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
            if len(body) == 1 and isinstance(body[0], ast.Raise):
                abstract.add(id(body[0]))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        name = exc.func if isinstance(exc, ast.Call) else exc
        if getattr(name, "id", getattr(name, "attr", None)) != "NotImplementedError":
            continue
        parts = [n.value for n in ast.walk(exc) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        yield node.lineno, "".join(parts), not isinstance(exc, ast.Call) and id(node) in abstract


def test_every_not_implemented_error_names_a_roadmap_item():
    """Each ``NotImplementedError`` the port raises as a refusal names the
    ROADMAP item that lifts it ("ROADMAP Queue 1 item N", an item
    ROADMAP.md has); a bare one may only be an abstract method's body.
    ROADMAP Queue 1 items 4 and 8.1 have landed: no refusal names them,
    and none is left."""
    import re

    probe = ("class A:\n    def f(self):\n        raise NotImplementedError\n"
             "def g(n):\n    raise NotImplementedError(f'{n} waits: ROADMAP Queue 1 item 9')\n"
             "def h():\n    x = 1\n    raise NotImplementedError\n")
    assert sorted(_not_implemented_raises(probe)) == [
        (3, "", True), (5, " waits: ROADMAP Queue 1 item 9", False), (8, "", False)]
    roadmap = open(os.path.join(ROOT, "ROADMAP.md"), encoding="utf-8").read()
    refusals = []
    for path in _port_sources():
        for line, msg, abstract in _not_implemented_raises(open(path, encoding="utf-8").read()):
            where = f"{os.path.relpath(path, ROOT)}:{line}"
            if abstract:
                continue
            item = re.search(r"ROADMAP Queue 1 item (\d+)(\.\d+)?", msg)
            assert item, f"{where} raises NotImplementedError without naming a ROADMAP item: {msg!r}"
            assert f"**Item {item.group(1)} " in roadmap, where
            assert item.group(0)[len("ROADMAP Queue 1 item "):] not in ("4", "8.1"), where
            refusals.append(where)
    assert refusals == []


def test_h5py_only_lazily_in_the_h5_tools():
    """``h5py`` is imported only by ``tools/h5_import.py`` and
    ``tools/h5_export.py``, inside functions (never at module level), so
    every other module, and those two, import without it."""
    seen = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        top = set(_imported_roots_of(tree.body))
        roots = set(_imported_roots(path))
        assert "h5py" not in top, f"{os.path.relpath(path, ROOT)} imports h5py at module level"
        if "h5py" in roots:
            assert path in H5PY_ALLOWED, f"{os.path.relpath(path, ROOT)} imports h5py"
            seen.append(path)
    assert seen and set(seen) <= set(H5PY_ALLOWED)
    out = _import_blocked(["fedcrack_tpu_torch.tools.h5_import", "fedcrack_tpu_torch.tools.h5_export"],
                          FORBIDDEN + ("h5py",))
    assert out.returncode == 0, out.stderr


def _imported_roots_of(statements):
    for node in statements:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, (ast.If, ast.Try)):
            yield from _imported_roots_of(node.body)
            for handler in getattr(node, "handlers", []):
                yield from _imported_roots_of(handler.body)
            yield from _imported_roots_of(node.orelse)


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


def test_command_lines_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    """Each ``main`` trains or evaluates on CUDA unless given ``device``.
    (The server's and client's pin of glibc's mmap threshold is recorded,
    not made, in this test process.)"""
    import torch

    from fedcrack_tpu_torch import client, server
    from fedcrack_tpu_torch.obs import sentries

    monkeypatch.setattr(sentries, "pin_mmap_threshold", lambda: True)
    from fedcrack_tpu_torch.train import centralized

    if torch.cuda.is_available():
        return  # decided at run time; chip_smoke.py runs them on the card
    with pytest.raises(RuntimeError, match="cuda"):
        centralized.main(["--synthetic", "4", "--epochs", "1", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        client.main(["--synthetic", "4"])
    with pytest.raises(RuntimeError, match="cuda"):
        server.main(["--eval-synthetic", "4", "--port", "0"])


def test_quantify_tool_defaults_to_cuda_and_raises_without_it(tmp_path):
    """``tools.quantify.main --weights`` predicts on CUDA unless given
    ``device``; ``--pred-dir`` needs no model and no device."""
    import torch

    from fedcrack_tpu_torch.tools import quantify

    if torch.cuda.is_available():
        return  # decided at run time; chip_smoke.py runs the tools on the card
    weights = tmp_path / "w.msgpack"
    weights.write_bytes(b"")
    with pytest.raises(RuntimeError, match="cuda"):
        quantify.main(["--weights", str(weights), "--synthetic", "2", "--img-size", "32"])


def test_slot_plane_defaults_to_cuda_and_raises_without_it(tmp_path):
    """``make_mesh`` (and so every round builder and the driver) and
    ``tools.refscale_federation`` run on CUDA unless given ``device``."""
    import torch

    from fedcrack_tpu_torch.parallel import make_mesh
    from fedcrack_tpu_torch.tools import refscale_federation

    if torch.cuda.is_available():
        assert make_mesh(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        refscale_federation.main(["--out", str(tmp_path / "a.json"), "--samples", "16", "--img", "32"])
    assert make_mesh(2, device="cpu").device.type == "cpu"


def test_cross_process_meshes_default_to_cuda_and_raise_without_it():
    """``make_mesh(..., group=)``, ``make_spatial_mesh(..., group=)`` and
    ``global_mesh_devices`` take this process's CUDA device unless told
    otherwise; without CUDA they raise before touching a process group,
    and on the CPU without a process group they raise too."""
    from fedcrack_tpu_torch.parallel import global_mesh_devices, make_mesh, make_spatial_mesh
    from fedcrack_tpu_torch.parallel.multihost import WORLD

    if torch.cuda.is_available():
        assert global_mesh_devices()[0][1].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(4, 2, group=WORLD)
    with pytest.raises(RuntimeError, match="cuda"):
        make_spatial_mesh(4, group=WORLD)
    with pytest.raises(RuntimeError, match="cuda"):
        global_mesh_devices()
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_spatial_mesh(4, device="cpu", group=WORLD)
