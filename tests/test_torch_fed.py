"""The port's aggregation (fed/algorithms.py, fed/aggregation.py) and one
whole sync round (train/federated.py) held against the JAX package.

FedAvg on float32 numpy trees: within one float32 ulp of the JAX host path
(its native accumulate rounds ``acc + w·x`` once, as the port does; the
final scale is one multiply on both sides). On any other tree (torch
tensors, bfloat16, float64) bitwise equal to the JAX package's ``jnp``
path (weights normalized in float32 first, the product and the sum each
rounded). The whole round: two clients
train from the same global tree through each package's ``make_train_fn``
(JAX fed by ``tree_to_bytes`` blobs), the server folds the sorted triples
through ``fold(FedAvg())``, and the new global is evaluated; the trees are
held by the rules of tests/test_torch_train.py. Both packages' clients take
and return msgpack blobs; a bfloat16 upload follows the in-band
``wire_dtype``.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    LR,
    TINY_KW,
    assert_trained_trees_close,
    flat_tree,
    jax_config,
    jax_variables,
    port_config,
)

pytestmark = pytest.mark.torch_port


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _client_trees(k, seed):
    rng = np.random.default_rng(seed)
    base = jax_variables(TINY_KW, seed=seed)
    return [_tree_map(lambda v: (v + rng.normal(0, 1e-3, v.shape)).astype(np.float32), base)
            for _ in range(k)]


def _nested_equal_ulp(got, want, maxulp=1):
    g, w = dict(flat_tree(got)), dict(flat_tree(want))
    assert set(g) == set(w)
    for path in w:
        assert g[path].dtype == np.float32
        np.testing.assert_array_max_ulp(g[path], w[path], maxulp=maxulp)


@pytest.mark.parametrize(
    "weights", [None, [64.0, 32.0, 32.0], [3.0, 5.0, 7.0], [0.0, 0.0, 0.0]],
    ids=["unweighted", "pow2_weights", "odd_weights", "zero_gate"],
)
def test_fold_fedavg_matches_jax(weights):
    """``fold(FedAvg)`` over sorted triples; all-zero weights fall back to
    the unweighted mean (the JAX weight gate)."""
    from fedcrack_tpu.fed.aggregation import FedAvg as JaxFedAvg
    from fedcrack_tpu.fed.aggregation import fold as jax_fold
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold

    trees = _client_trees(3, seed=1)
    ws = weights or [1, 1, 1]
    triples = [(f"client{i}", w, t) for i, (w, t) in enumerate(zip(ws, trees))]
    want = jax_fold(JaxFedAvg(), triples)
    got = fold(FedAvg(), triples)
    _nested_equal_ulp(got, want)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("weights", [None, [3.0, 5.0]], ids=["unweighted", "weighted"])
def test_fedavg_matches_jax_and_tensor_path(weights):
    """numpy trees against JAX's host path; tensor trees (the device path)
    bitwise equal to JAX's ``jnp`` path on the same values as jax arrays,
    which is the path the JAX package takes for device trees."""
    import jax.numpy as jnp

    from fedcrack_tpu.fed.algorithms import fedavg as jax_fedavg
    from fedcrack_tpu_torch.fed.algorithms import fedavg

    trees = _client_trees(2, seed=2)
    got = fedavg(trees, weights)
    _nested_equal_ulp(got, jax_fedavg(trees, weights))
    on_tensors = fedavg([_tree_map(torch.from_numpy, t) for t in trees], weights)
    on_device = jax_fedavg([_tree_map(jnp.asarray, t) for t in trees], weights)
    for path, _ in flat_tree(got):
        leaf = _at(on_tensors, path)
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
        assert leaf.numpy().tobytes() == np.asarray(_at(on_device, path)).tobytes(), path


@pytest.mark.parametrize("kind", ["bfloat16", "float64", "tensor"])
@pytest.mark.parametrize("weights", [None, [3.0, 5.0, 7.0], [0.1, 0.7, 0.2]], ids=["unweighted", "counts", "fractions"])
def test_fedavg_on_non_float32_trees_is_bitwise_jax(kind, weights):
    """Trees that are not all float32 numpy take the JAX package's ``jnp``
    path in both packages: bfloat16 leaves (the port's are CPU tensors, the
    JAX package's jax arrays), float64 numpy (the JAX package, without x64,
    returns float32 there; the port keeps float64 and holds the same
    float32 values), and float32 tensors against jax arrays. Bitwise."""
    import jax.numpy as jnp

    from fedcrack_tpu.fed.algorithms import fedavg as jax_fedavg
    from fedcrack_tpu_torch.fed.algorithms import fedavg

    rng = np.random.default_rng(4)
    base = [_tree_map(lambda v: v + rng.normal(0, 0.5, v.shape), jax_variables(TINY_KW, seed=5)) for _ in range(3)]
    if kind == "bfloat16":
        port = [_tree_map(lambda v: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16), t) for t in base]
        ref = [_tree_map(lambda v: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16), t) for t in port]
    elif kind == "float64":
        port = ref = base
    else:
        port = [_tree_map(lambda v: torch.from_numpy(v.astype(np.float32)), t) for t in base]
        ref = [_tree_map(lambda v: jnp.asarray(v.astype(np.float32)), t) for t in base]
    got, want = fedavg(port, weights), jax_fedavg(ref, weights)
    for path, _ in flat_tree(base[0]):
        g, w = _at(got, path), np.asarray(_at(want, path))
        if kind == "float64":
            assert g.dtype == np.float64 and np.array_equal(g.astype(np.float32).astype(np.float64), g)
            g = g.astype(np.float32)
        else:
            assert isinstance(g, torch.Tensor) and str(g.dtype) == f"torch.{w.dtype.name}"
            g = g.float().numpy()
            w = w.astype(np.float32)
        assert g.tobytes() == w.tobytes(), path


def test_fedavg_cancellation_stays_within_an_ulp_of_jax():
    """Clients of opposite sign and unequal weights: where a separately
    rounded product would drift tens of ulps, the single rounding holds."""
    from fedcrack_tpu.fed.algorithms import fedavg as jax_fedavg
    from fedcrack_tpu_torch.fed.algorithms import fedavg

    rng = np.random.default_rng(3)
    a = rng.normal(0, 1e-3, (4096,)).astype(np.float32)
    b = (-a * 0.9 + rng.normal(0, 1e-6, a.shape)).astype(np.float32)
    got = fedavg([{"w": a}, {"w": b}], [3.0, 5.0])["w"]
    np.testing.assert_array_max_ulp(got, np.asarray(jax_fedavg([{"w": a}, {"w": b}], [3.0, 5.0])["w"]), maxulp=1)


def test_fedavg_refuses_what_jax_refuses():
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold
    from fedcrack_tpu_torch.fed.algorithms import fedavg

    t = {"w": np.ones(3, np.float32)}
    with pytest.raises(ValueError):
        fedavg([])
    with pytest.raises(ValueError):
        fedavg([t, t], [1.0])
    with pytest.raises(ValueError):
        fedavg([t, t], [1.0, -2.0])
    with pytest.raises(ValueError):
        fedavg([t, {"v": np.ones(3, np.float32)}])
    with pytest.raises(ValueError):
        fold(FedAvg(), [])


def test_fedprox_penalty_matches_jax():
    import jax

    from fedcrack_tpu.fed.algorithms import fedprox_penalty as jax_prox
    from fedcrack_tpu_torch.fed.algorithms import fedprox_penalty
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict

    params = jax_variables(TINY_KW, seed=4)["params"]
    rng = np.random.default_rng(5)
    anchor = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    want = float(jax_prox(params, anchor, 0.3))
    got = float(fedprox_penalty(flax_to_state_dict({"params": params}),
                                flax_to_state_dict({"params": anchor}), 0.3))
    assert got == pytest.approx(want, rel=1e-5)
    assert want > 0


def test_one_sync_round_two_clients_matches_jax():
    """The slice's entry points end to end: two clients x one round
    (2 epochs x 2 steps each, FedProx on, crack pixels up-weighted), each
    fed the round's global as a msgpack blob and answering with one, the
    ordered FedAvg fold over sorted client names, then evaluate."""
    import jax

    from fedcrack_tpu.configs import DataConfig as JaxDataConfig
    from fedcrack_tpu.configs import FedConfig as JaxFedConfig
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    from fedcrack_tpu.fed.aggregation import FedAvg as JaxFedAvg
    from fedcrack_tpu.fed.aggregation import fold as jax_fold
    from fedcrack_tpu.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu.train import federated as jfed
    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold
    from fedcrack_tpu_torch.train import federated as tfed
    from fedcrack_tpu_torch.train import local as tl

    hparams = {"local_epochs": 2, "fedprox_mu": 0.1, "pos_weight": 2.0}
    global0 = jax_variables(TINY_KW, seed=6)
    imgs, msks = synth_crack_batch(12, 32, seed=7)
    shards = {"client_a": slice(0, 4), "client_b": slice(4, 8)}
    held_out = (imgs[8:], msks[8:])

    jax_cfg = JaxFedConfig(model=jax_config(TINY_KW), data=JaxDataConfig(img_size=32))
    port_cfg = FedConfig(model=port_config(TINY_KW), data=DataConfig(img_size=32))
    jax_triples, port_triples = [], []
    for i, (name, sl) in enumerate(sorted(shards.items())):
        jfn, jholder = jfed.make_train_fn(jax_cfg, JaxArrayDataset(imgs[sl], msks[sl], batch_size=2, seed=i),
                                          batch_size=2, seed=i)
        blob, jn, jmetrics = jfn(tree_to_bytes(global0), 0, hparams)
        trained = tree_from_bytes(blob, jholder["state"].variables)
        jax_triples.append((name, jn, jax.tree_util.tree_map(np.asarray, trained)))
        tfn, tholder = tfed.make_train_fn(port_cfg, ArrayDataset(imgs[sl], msks[sl], batch_size=2, seed=i),
                                          batch_size=2, seed=i, device="cpu")
        tblob, tn, tmetrics = tfn(tser.tree_to_bytes(global0), 0, hparams)
        assert isinstance(tblob, bytes)
        tree = tser.tree_from_bytes(tblob, template=tholder["state"].variables)
        assert tn == jn == 4  # two steps of the last epoch x batch 2
        for k in ("loss", "pixel_acc", "iou"):
            np.testing.assert_allclose(tmetrics[k], jmetrics[k], rtol=1e-4, err_msg=f"{name} {k}")
        assert_trained_trees_close(tree, jax_triples[-1][2], global0, steps=4)
        port_triples.append((name, tn, tree))

    want = jax_fold(JaxFedAvg(), jax_triples)
    got = fold(FedAvg(), port_triples)
    assert_trained_trees_close(got, want, global0, steps=4)

    js = jl.create_train_state(jax.random.key(0), jax_config(TINY_KW), LR).replace_variables(want)
    ts = tl.create_train_state(torch.Generator().manual_seed(0), port_config(TINY_KW), LR,
                               device="cpu").replace_variables(got)
    jeval = jl.evaluate(js, JaxArrayDataset(*held_out, batch_size=2, shuffle=False))
    teval = tl.evaluate(ts, ArrayDataset(*held_out, batch_size=2, shuffle=False))
    assert teval["num_batches"] == jeval["num_batches"] == 2
    # Eval mode reads the running means, which carry the BatchNorm-fed
    # biases' noise (see above): 1e-3 relative on the loss.
    np.testing.assert_allclose(teval["loss"], jeval["loss"], rtol=1e-3)
    np.testing.assert_allclose(teval["pixel_acc"], jeval["pixel_acc"], rtol=1e-3)


@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_train_fn_speaks_blobs_and_follows_the_wire_dtype(wire_dtype):
    """The blob form of ``train_fn``: the JAX package's blob in, an upload
    whose bytes decode against the port's template, bfloat16-cast when
    the server's in-band config asks for it (the JAX client's rule), and
    the same leaves the holder's state carries."""
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.train import federated as tfed

    imgs, msks = synth_crack_batch(4, 32, seed=9)
    cfg = FedConfig(model=port_config(TINY_KW), data=DataConfig(img_size=32))
    fn, holder = tfed.make_train_fn(cfg, ArrayDataset(imgs, msks, batch_size=2, seed=0), batch_size=2,
                                    device="cpu")
    global0 = jax_variables(TINY_KW, seed=10)
    blob, n, metrics = fn(jser.tree_to_bytes(global0), 1, {"local_epochs": 1, "wire_dtype": wire_dtype})
    assert n == 4 and np.isfinite(metrics["loss"])
    trained = holder["state"].variables
    cast = "bfloat16" if wire_dtype == "bfloat16" else None
    assert blob == tser.tree_to_bytes(trained, cast_dtype=cast) == jser.tree_to_bytes(trained, cast_dtype=cast)
    restored = tser.tree_from_bytes(blob, template=trained)
    for (path, got), (_, want) in zip(flat_tree(restored), flat_tree(trained)):
        assert got.dtype == np.float32
        if cast is None:
            np.testing.assert_array_equal(got, want, err_msg="/".join(path))
        else:
            np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-30, err_msg="/".join(path))
