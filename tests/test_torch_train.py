"""The port's training path held against the JAX package on the CPU:
train-mode BatchNorm and ResUNet (values, running statistics, gradients),
``train_step``, ``local_fit``, ``evaluate``, ``recalibrate_batch_stats``,
Adam, the data pipeline and the training configs.

Same numpy weights and inputs on both sides. Tolerances and why:

- Forward values and gradients: rtol/atol 1e-4, as the eval-mode logits
  (XLA and oneDNN sum conv taps in different orders; BatchNorm's batch
  moments add one more reduction).
- After Adam steps, every parameter within 1e-5 (1% of the 1e-3 learning
  rate): Adam maps a gradient g to about lr·g/(|g| + 1e-7), so float32
  noise in g moves a step by far less unless g itself is noise.
- The known hazard, exactly where g IS noise: the bias of a conv that feeds
  a train-mode BatchNorm (``stem_conv``, every ``pointwise``, every
  ``convT1``/``convT2``) has a true gradient of exactly 0, since the batch
  mean subtracts it again. Both frameworks leave rounding noise there, and
  Adam scales noise to a step of up to lr. Those leaves are held by what
  Adam guarantees on each side: within steps·lr of where they started.
  The running means of the BatchNorms they feed carry (1 − 0.99) of the
  difference per step, so ``batch_stats`` means get 0.02·steps·lr on top
  of 1e-5.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    LR,
    TINY_KW,
    TWO_BLOCK_KW,
    assert_trained_trees_close,
    bn_fed_bias,
    flat_tree,
    jax_config,
    jax_variables,
    port_config,
    to_numpy_tree,
)

pytestmark = pytest.mark.torch_port


def _nontrivial_variables(kw, seed):
    """JAX init plus non-trivial BatchNorm affines and statistics."""
    variables = jax_variables(kw, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for name, stats in variables["batch_stats"].items():
        c = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        variables["params"][name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        variables["params"][name]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    return variables


def _port_model(kw, variables, **model_kw):
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    return from_flax_variables(variables, ResUNet(port_config(kw), device="cpu", **model_kw))


def _batch(n, size, seed):
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    return synth_crack_batch(n, size, seed=seed)


# ---- train-mode BatchNorm and ResUNet ----


def test_batchnorm_train_mode_is_flax_fast_variance_and_biased_running_var():
    """A channel with a large mean: flax's E[x²] − E[x]² and the biased
    running variance, not torch's Welford/unbiased ``F.batch_norm``."""
    import flax.linen as fnn
    import jax

    from fedcrack_tpu_torch.models.resunet import BatchNorm

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (4, 5, 6, 3)).astype(np.float32)
    x[..., 1] += 30.0
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = layer.init(jax.random.key(0), x)
    want, mutated = layer.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm(3)
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, stat).numpy(), np.asarray(mutated["batch_stats"][stat]),
                                   rtol=1e-5, atol=1e-6)
    # torch's own running variance is the unbiased one: not flax's.
    ra_mean, ra_var = torch.zeros(3), torch.ones(3)
    torch.nn.functional.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), ra_mean, ra_var,
                                   training=True, momentum=0.01, eps=1e-3)
    assert not np.allclose(ra_var.numpy(), bn.var.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize(
    "kw,shape", [(TINY_KW, (2, 32, 32, 3)), (TWO_BLOCK_KW, (2, 20, 28, 3))],
    ids=["tiny_32", "two_block_odd_grid"],
)
def test_train_mode_logits_and_batch_stats_match_flax(kw, shape):
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet

    variables = _nontrivial_variables(kw, seed=3)
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    want, mutated = FlaxResUNet(config=jax_config(kw)).apply(variables, x, train=True,
                                                             mutable=["batch_stats"])
    model = _port_model(kw, variables)
    model.train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    stats = to_numpy_tree(mutated["batch_stats"])
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    for path, value in flat_tree(stats):
        np.testing.assert_allclose(dict(flat_tree(to_flax_variables(model)["batch_stats"]))[path], value,
                                   rtol=1e-5, atol=1e-5, err_msg="/".join(path))


@pytest.mark.parametrize(
    "kw,shape", [(TINY_KW, (2, 32, 32, 3)), (TWO_BLOCK_KW, (2, 20, 28, 3))],
    ids=["tiny_32", "two_block_odd_grid"],
)
def test_train_mode_parameter_gradients_match_jax_grad(kw, shape):
    """Every parameter's gradient of a BCE loss through the train-mode net
    (both BatchNorm moments, the pool's first-maximum rule, the stride-2
    SAME pads) against ``jax.grad``. The bias of a conv feeding a BatchNorm
    has a true gradient of 0 and is held at that (both sides' noise stays
    far below the other gradients)."""
    import jax
    import jax.numpy as jnp
    import optax

    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet
    from fedcrack_tpu_torch.ops.losses import sigmoid_bce

    variables = _nontrivial_variables(kw, seed=5)
    rng = np.random.default_rng(6)
    imgs = np.ascontiguousarray(_batch(shape[0], 32, seed=6)[0][:, : shape[1], : shape[2]])
    net = FlaxResUNet(config=jax_config(kw))
    out_shape = net.apply(variables, imgs, train=False).shape  # odd grids come back larger
    msks = (rng.uniform(size=out_shape) > 0.8).astype(np.float32)

    def loss_fn(params):
        logits, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, imgs,
                              train=True, mutable=["batch_stats"])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, msks))

    want = dict(flat_tree({"params": to_numpy_tree(jax.grad(loss_fn)(variables["params"]))}))
    model = _port_model(kw, variables)
    model.train()
    sigmoid_bce(model(torch.from_numpy(imgs)), torch.from_numpy(msks)).backward()
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict

    names = {tuple(k.split(".")): k for k in flax_to_state_dict(variables)}
    params = dict(model.named_parameters())
    scale = max(np.abs(v).max() for v in want.values())
    for path, g_want in want.items():
        module = path[1:-1]
        key = ".".join(module + ("weight" if path[-1] == "kernel" else path[-1],))
        assert key in names.values()
        g = params[key].grad
        g = g.permute(2, 3, 1, 0) if path[-1] == "kernel" else g
        if bn_fed_bias(path):
            assert np.abs(g.numpy()).max() <= 1e-5 * scale and np.abs(g_want).max() <= 1e-5 * scale
            continue
        np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-4, atol=1e-4 * scale, err_msg="/".join(path))


def test_eval_mode_unchanged_and_touches_no_statistics():
    """Eval mode is the serving path's forward, bit for bit; only a
    train-mode forward moves the running statistics."""
    variables = _nontrivial_variables(TINY_KW, seed=7)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    model = _port_model(TINY_KW, variables)
    assert not model.training
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        first = model(x)
        model.train()
        model(x)
        moved = {k: v.clone() for k, v in model.state_dict().items()}
        model.eval()
        for k, v in before.items():
            model.state_dict()[k].copy_(v)
        again = model(x)
    assert torch.equal(first, again)
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v)
    assert not torch.equal(moved["stem_bn.mean"], before["stem_bn.mean"])


# ---- train_step, local_fit, evaluate, recalibration ----


def _jax_state(kw, variables):
    import jax

    from fedcrack_tpu.train import local as jl

    return jl.create_train_state(jax.random.key(0), jax_config(kw), LR).replace_variables(variables)


def _port_state(kw, variables):
    from fedcrack_tpu_torch.train import local as tl

    return tl.create_train_state(torch.Generator().manual_seed(0), port_config(kw), LR,
                                 device="cpu").replace_variables(variables)


def _jax_tree(state):
    return to_numpy_tree({"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("mu,pos_weight", [(0.0, 1.0), (0.5, 4.0)], ids=["fedavg", "fedprox_pw4"])
def test_train_step_matches_jax(mu, pos_weight):
    """One step from the same weights and batch. With mu > 0 the anchor is
    a perturbed copy of the weights, so the proximal term has a gradient."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict
    from fedcrack_tpu_torch.train import local as tl

    variables = jax_variables(TINY_KW, seed=0)
    rng = np.random.default_rng(9)
    anchor = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.01, a.shape)).astype(np.float32), variables["params"])
    imgs, msks = _batch(4, 32, seed=1)
    js, jm = jl.train_step(_jax_state(TINY_KW, variables), (imgs, msks), anchor,
                           jnp.float32(mu), jnp.float32(pos_weight))
    ts = _port_state(TINY_KW, variables)
    port_anchor = {k: v.contiguous() for k, v in flax_to_state_dict({"params": anchor}).items()}
    ts, tm = tl.train_step(ts, (imgs, msks), port_anchor, mu, pos_weight)
    assert ts.step == 1
    for k in ("pixel_acc", "iou", "iou_inter", "iou_union"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_trained_trees_close(ts.variables, _jax_tree(js), variables, steps=1)


@pytest.mark.parametrize(
    "kw,mu,pos_weight,transport",
    [(TINY_KW, 0.0, 1.0, "float32"), (TWO_BLOCK_KW, 0.5, 3.0, "float32"), (TINY_KW, 0.0, 1.0, "uint8")],
    ids=["fedavg", "two_block_fedprox_pw3", "uint8_transport"],
)
def test_local_fit_matches_jax(kw, mu, pos_weight, transport):
    """Three steps over an ArrayDataset (the same shuffled batches on both
    sides, seed + epoch), FedProx anchored at the starting weights."""
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset, to_uint8_transport
    from fedcrack_tpu_torch.train import local as tl

    variables = jax_variables(kw, seed=2)
    imgs, msks = _batch(6, 32, seed=3)
    if transport == "uint8":
        imgs, msks = to_uint8_transport(imgs, msks)
    js, jmetrics = jl.local_fit(_jax_state(kw, variables), JaxArrayDataset(imgs, msks, batch_size=2, seed=4),
                                epochs=1, mu=mu, pos_weight=pos_weight)
    ts, tmetrics = tl.local_fit(_port_state(kw, variables), ArrayDataset(imgs, msks, batch_size=2, seed=4),
                                epochs=1, mu=mu, pos_weight=pos_weight)
    assert tmetrics["num_steps"] == jmetrics["num_steps"] == 3
    assert set(tmetrics) == set(jmetrics)
    for k in ("loss", "pixel_acc", "iou", "iou_inter", "iou_union"):
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], rtol=1e-4, err_msg=k)
    assert_trained_trees_close(ts.variables, _jax_tree(js), variables, steps=3)


def test_evaluate_and_recalibrate_match_jax():
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.train import local as tl

    variables = _nontrivial_variables(TINY_KW, seed=11)
    imgs, msks = _batch(6, 32, seed=12)
    jds, tds = JaxArrayDataset(imgs, msks, batch_size=2, seed=1), ArrayDataset(imgs, msks, batch_size=2, seed=1)
    js, ts = _jax_state(TINY_KW, variables), _port_state(TINY_KW, variables)
    for pos_weight in (1.0, 3.0):
        want = jl.evaluate(js, jds, pos_weight=pos_weight)
        got = tl.evaluate(ts, tds, pos_weight=pos_weight)
        assert got["num_batches"] == want["num_batches"] == 3
        for k in ("loss", "pixel_acc", "iou"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    js = jl.recalibrate_batch_stats(js, jds, jax_config(TINY_KW))
    ts = tl.recalibrate_batch_stats(ts, tds)
    assert tds._epoch == jds._epoch == 2  # the two evaluations, not the calibration
    got, want = ts.variables, _jax_tree(js)
    for path, value in flat_tree(want):
        np.testing.assert_allclose(dict(flat_tree(got))[path], value, rtol=1e-5, atol=1e-5, err_msg="/".join(path))
    with pytest.raises(ValueError):
        tl.evaluate(ts, [])
    with pytest.raises(ValueError):
        tl.recalibrate_batch_stats(ts, [])
    assert dict(flat_tree(ts.variables)).keys() == dict(flat_tree(got)).keys()


def test_adam_matches_optax():
    """torch Adam at (0.9, 0.999, eps 1e-7) against optax.adam on the same
    gradients over five steps: eps outside the root, bias-corrected."""
    import optax

    from fedcrack_tpu_torch.train.local import make_optimizer

    rng = np.random.default_rng(13)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(0, 10.0 ** -rng.integers(2, 9), size=(64,)).astype(np.float32) for _ in range(5)]
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-7)
    p, st = p0, tx.init(p0)
    p_t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([p_t], LR)
    for g in grads:
        upd, st = tx.update(g, st, p)
        p = optax.apply_updates(p, upd)
        p_t.grad = torch.from_numpy(g)
        opt.step()
    # The two round the bias corrections and the quotient in different
    # places: each step may differ by about 1e-4 of its size (lr).
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p), rtol=0, atol=1e-4 * LR * len(grads))


# ---- pipeline and configs ----


def test_array_dataset_and_synthetic_source_match_jax():
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    from fedcrack_tpu.data.pipeline import dataset_from_source as jax_source
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset, dataset_from_source

    imgs, msks = _batch(7, 16, seed=5)
    for kw in (dict(batch_size=3, seed=2), dict(batch_size=3, seed=2, drop_last=False),
               dict(batch_size=2, shuffle=False)):
        a, b = ArrayDataset(imgs, msks, **kw), JaxArrayDataset(imgs, msks, **kw)
        assert len(a) == len(b)
        for _ in range(3):  # three epochs, three shuffles
            for (ia, ma), (ib, mb) in zip(a, b, strict=True):
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_array_equal(ma, mb)
    a = dataset_from_source(5, None, None, img_size=16, batch_size=16, seed=3)
    b = jax_source(5, None, None, img_size=16, batch_size=16, seed=3)
    assert a.batch_size == b.batch_size == 5
    for (ia, ma), (ib, mb) in zip(a, b, strict=True):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
    with pytest.raises(ValueError):
        ArrayDataset(imgs, msks, batch_size=8)  # zero batches with drop_last
    with pytest.raises(ValueError):
        dataset_from_source(0, None, None, img_size=16, batch_size=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1$"):
        dataset_from_source(0, "images", "masks", img_size=16, batch_size=4)


def test_device_prefetch_and_model_batch():
    from fedcrack_tpu_torch.data.pipeline import as_model_batch, device_prefetch, to_uint8_transport

    imgs, msks = _batch(4, 16, seed=6)
    batches = [(imgs[i : i + 1], msks[i : i + 1]) for i in range(4)]
    out = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == 4
    for (i, m), (ti, tm) in zip(batches, out):
        assert ti.device.type == "cpu"
        np.testing.assert_array_equal(ti.numpy(), i)
        np.testing.assert_array_equal(tm.numpy(), m)
    assert list(device_prefetch(iter([]), "cpu")) == []
    u8_imgs, u8_msks = to_uint8_transport(imgs, msks)
    fi, fm = as_model_batch(torch.from_numpy(u8_imgs), torch.from_numpy(u8_msks))
    assert fi.dtype == fm.dtype == torch.float32
    np.testing.assert_array_equal(fm.numpy(), msks)
    assert np.abs(fi.numpy() - imgs).max() <= 0.5 / 255 + 1e-7


def test_training_configs_match_jax():
    import dataclasses

    from fedcrack_tpu.configs import DataConfig as JaxDataConfig
    from fedcrack_tpu.configs import FedConfig as JaxFedConfig
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig

    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(JaxDataConfig())
    jax_fed = dataclasses.asdict(JaxFedConfig())
    for field, value in dataclasses.asdict(FedConfig()).items():
        assert jax_fed[field] == value, field
    assert (FedConfig().local_epochs, FedConfig().learning_rate) == (10, 1e-3)
    assert (FedConfig().fedprox_mu, FedConfig().pos_weight) == (0.0, 1.0)
    with pytest.raises(ValueError):
        FedConfig(model=ModelConfig(img_size=64))
