"""The Keras h5 bridge (``fedcrack_tpu_torch/tools/h5_import.py`` and
``h5_export.py``) held against the JAX package's on the CPU.

The reference's ``crack_segmentation.h5`` is not in the repo and is not
fetched: the files here are written by the JAX exporter, by the port's
exporter and, where ``tensorflow`` is installed (``importorskip``, as the
JAX tests do), by Keras itself from the reference architecture
(``tests/test_h5_import.py::build_keras_resunet``) with random weights.

- Both packages read the same layers and import each file into
  byte-equal trees; both exporters write equal groups, datasets and
  attributes; export then import is exact; both command lines write
  byte-equal msgpack files and equal h5 datasets.
- The mismatch messages are the JAX package's.
- Imported weights run every layout: the port's ``s2d`` + ``packed``
  forward is held against the port's reference layout (``torch.equal``
  on oneDNN, tests/test_torch_layouts.py), not against the JAX package's
  ``s2d`` pin, which fails on the installed JAX.
- The port's forward on Keras weights against Keras's own prediction at
  the JAX test's atol 2e-5 / rtol 1e-4.
"""

import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, flat_tree, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port


def _random_variables(seed):
    """Random params and positive statistics in the flax layout (numpy)."""
    variables = jax_variables(TINY_KW, seed=seed)
    rng = np.random.default_rng(seed)

    def perturb(node, stats=False):
        if isinstance(node, dict):
            return {k: perturb(v, stats) for k, v in node.items()}
        x = rng.normal(0.1, 0.4, node.shape).astype(np.float32)
        return np.abs(x) + np.float32(0.25) if stats else x

    return {"params": perturb(variables["params"]), "batch_stats": perturb(variables["batch_stats"], True)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """h5 files of the same random weights from the JAX and the port
    exporters."""
    from fedcrack_tpu.tools.h5_export import export_resunet_h5 as jax_export
    from fedcrack_tpu_torch.tools.h5_export import export_resunet_h5

    root = tmp_path_factory.mktemp("h5")
    variables = _random_variables(3)
    jax_export(variables, str(root / "jax.h5"), jax_config(TINY_KW))
    export_resunet_h5(variables, str(root / "port.h5"), port_config(TINY_KW))
    return variables, {"jax_export": str(root / "jax.h5"), "port_export": str(root / "port.h5")}


@pytest.fixture(scope="module")
def keras_h5(tmp_path_factory):
    """The reference architecture in Keras, random weights (statistics
    included), saved as a legacy full-model h5."""
    pytest.importorskip("tensorflow")
    from test_h5_import import build_keras_resunet, randomize_weights

    model = build_keras_resunet(jax_config(TINY_KW))
    randomize_weights(model)
    path = tmp_path_factory.mktemp("keras") / "crack_segmentation.h5"
    model.save(path)
    return model, str(path)


def _source(name, files, request):
    if name == "keras":
        return request.getfixturevalue("keras_h5")[1]
    return files[1][name]


def _assert_trees_bytes_equal(got, want):
    g, w = dict(flat_tree(got)), dict(flat_tree(want))
    assert set(g) == set(w)
    for path, value in w.items():
        assert g[path].dtype == value.dtype == np.float32, path
        assert g[path].tobytes() == value.tobytes(), path


SOURCES = ["keras", "jax_export", "port_export"]


@pytest.mark.parametrize("source", SOURCES)
def test_read_keras_h5_matches_jax(source, files, request):
    from fedcrack_tpu.tools.h5_import import read_keras_h5 as jax_read
    from fedcrack_tpu_torch.tools.h5_import import read_keras_h5

    path = _source(source, files, request)
    got, want = read_keras_h5(path), jax_read(path)
    assert [(l.name, l.kind) for l in got] == [(l.name, l.kind) for l in want]
    kinds = [l.kind for l in got]
    assert (kinds.count("separable"), kinds.count("convT"), kinds.count("bn"), kinds.count("conv")) == (2, 4, 7, 5)
    for a, b in zip(got, want):
        assert sorted(a.weights) == sorted(b.weights)
        for k in b.weights:
            assert a.weights[k].tobytes() == b.weights[k].tobytes(), (a.name, k)


@pytest.mark.parametrize("source", SOURCES)
def test_import_byte_equal_to_jax(source, files, request):
    """Each file into both packages' importers: byte-equal trees; an
    exporter's file gives back the tree it was written from."""
    from fedcrack_tpu.tools.h5_import import import_resunet_h5 as jax_import
    from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5

    path = _source(source, files, request)
    got = import_resunet_h5(path, port_config(TINY_KW))
    _assert_trees_bytes_equal(got, jax_import(path, jax_config(TINY_KW)))
    if source != "keras":
        _assert_trees_bytes_equal(got, files[0])
    # The layouts never reach the importer.
    c6 = port_config(dict(TINY_KW, stem_layout="s2d", res_layout="packed", compute_dtype="bfloat16"))
    _assert_trees_bytes_equal(import_resunet_h5(path, c6), got)


def _h5_contents(path):
    """Every group's and dataset's name, attributes (decoded), and each
    dataset's dtype, shape and bytes."""
    import h5py

    out = {}

    def attrs(obj):
        return {k: [x.decode() if isinstance(x, bytes) else str(x) for x in np.atleast_1d(v)]
                for k, v in obj.attrs.items()}

    with h5py.File(path, "r") as f:
        out["/"] = attrs(f)

        def visit(name, obj):
            entry = {"attrs": attrs(obj)}
            if isinstance(obj, h5py.Dataset):
                data = obj[()]
                entry.update(dtype=str(data.dtype), shape=data.shape, data=data.tobytes())
            out[name] = entry

        f.visititems(visit)
    return out


def test_export_groups_datasets_and_attributes_equal_to_jax(files):
    jax_file, port_file = _h5_contents(files[1]["jax_export"]), _h5_contents(files[1]["port_export"])
    assert list(port_file) == list(jax_file)
    assert port_file == jax_file
    assert port_file["model_weights"]["attrs"]["layer_names"][-1] == "head"


def test_round_trip_exact_and_through_the_model(files):
    """Export then import is exact; the imported tree loads into the
    port's ``ResUNet`` and back byte for byte, and trains (one step,
    finite loss)."""
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5
    from fedcrack_tpu_torch.train import local

    variables, paths = files
    back = import_resunet_h5(paths["port_export"], port_config(TINY_KW))
    _assert_trees_bytes_equal(back, variables)
    model = from_flax_variables(back, ResUNet(port_config(TINY_KW), device="cpu"))
    _assert_trees_bytes_equal(to_flax_variables(model), variables)
    state = local.create_train_state(torch.Generator().manual_seed(0), port_config(TINY_KW),
                                     device="cpu").replace_variables(back)
    _, metrics = local.train_step(state, synth_crack_batch(4, 32, seed=0), local.snapshot_params(state))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("tool", ["h5_import", "h5_export"])
def test_command_lines_write_what_jax_writes(tool, files, tmp_path):
    """``main`` of each package with the same arguments (``--config`` a
    FedConfig file carrying the tiny model): the import writes byte-equal
    msgpack files, the export h5 files with equal contents."""
    import importlib

    from fedcrack_tpu.configs import DataConfig, FedConfig
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(FedConfig(model=jax_config(TINY_KW), data=DataConfig(img_size=32)).to_json())
    port_main = importlib.import_module(f"fedcrack_tpu_torch.tools.{tool}").main
    jax_main = importlib.import_module(f"fedcrack_tpu.tools.{tool}").main
    if tool == "h5_import":
        src, suffix = files[1]["jax_export"], ".msgpack"
    else:
        src, suffix = str(tmp_path / "in.msgpack"), ".h5"
        (tmp_path / "in.msgpack").write_bytes(tree_to_bytes(files[0]))
    outs = [str(tmp_path / f"{who}{suffix}") for who in ("port", "jax")]
    for main, out in zip((port_main, jax_main), outs):
        assert main([src, out, "--config", str(cfg_path)]) == 0
    if tool == "h5_import":
        got = open(outs[0], "rb").read()
        assert got == open(outs[1], "rb").read()
        assert got == tree_to_bytes(files[0])
    else:
        assert _h5_contents(outs[0]) == _h5_contents(outs[1]) == _h5_contents(files[1]["jax_export"])


def test_mismatch_messages_are_jax_s(files, tmp_path):
    """A wrong stem width (shape), a deeper model (layer count) on import,
    and an export config with fewer blocks than the weights: the same
    ``ValueError`` text from both packages."""
    from fedcrack_tpu.tools.h5_export import export_resunet_h5 as jax_export
    from fedcrack_tpu.tools.h5_import import import_resunet_h5 as jax_import
    from fedcrack_tpu_torch.tools.h5_export import export_resunet_h5
    from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5

    variables, paths = files
    cases = [
        (import_resunet_h5, jax_import, (paths["jax_export"],), dict(TINY_KW, stem_features=8), "shape mismatch"),
        (import_resunet_h5, jax_import, (paths["jax_export"],),
         dict(TINY_KW, encoder_features=(8, 8), decoder_features=(8, 8, 4)), "count mismatch"),
        (export_resunet_h5, jax_export, (variables, str(tmp_path / "x.h5")), dict(TINY_KW, decoder_features=(8,)),
         "unconsumed"),
    ]
    for port_fn, jax_fn, args, kw, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            port_fn(*args, port_config(kw))
        with pytest.raises(ValueError) as want:
            jax_fn(*args, jax_config(kw))
        assert str(got.value) == str(want.value)


def test_without_h5py_the_tools_raise_naming_it(files, monkeypatch):
    from fedcrack_tpu_torch.tools.h5_export import export_resunet_h5
    from fedcrack_tpu_torch.tools.h5_import import read_keras_h5

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        read_keras_h5(files[1]["jax_export"])
    with pytest.raises(ImportError, match="h5py"):
        export_resunet_h5(files[0], "unused.h5", port_config(TINY_KW))


@pytest.mark.parametrize("img", [128, 256])
def test_layouts_on_imported_keras_weights(img, keras_h5):
    """Keras weights imported at 32 px run unchanged at larger crops in
    every layout: the port's ``s2d`` + ``packed`` logits are
    ``torch.equal`` to its reference layout's on random and synthetic
    crack inputs (JAX's own ``s2d`` pin on imported weights fails on the
    installed JAX, so the port is not held to it)."""
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5

    variables = import_resunet_h5(keras_h5[1], port_config(TINY_KW))
    ref = from_flax_variables(variables, ResUNet(port_config(dict(TINY_KW, img_size=img)), device="cpu"))
    s2d = from_flax_variables(variables, ResUNet(port_config(dict(TINY_KW, img_size=img, stem_layout="s2d",
                                                                  res_layout="packed")), device="cpu"))
    rand = np.random.default_rng(11).uniform(0, 1, (2, img, img, 3)).astype(np.float32)
    fixture, _ = synth_crack_batch(2, img, seed=5)
    with torch.no_grad():
        for x in (rand, fixture):
            x = torch.from_numpy(np.ascontiguousarray(x))
            assert torch.equal(s2d(x), ref(x))


def test_forward_on_keras_weights_matches_keras(keras_h5):
    """The port's ``ResUNet`` on imported Keras weights against Keras's
    prediction (the JAX test's atol 2e-5, rtol 1e-4 on probabilities)."""
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5

    model, path = keras_h5
    net = from_flax_variables(import_resunet_h5(path, port_config(TINY_KW)), ResUNet(port_config(TINY_KW),
                                                                                     device="cpu"))
    images = np.random.RandomState(7).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = model.predict(images, verbose=0)
    with torch.no_grad():
        got = torch.sigmoid(net(torch.from_numpy(images))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
