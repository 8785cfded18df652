"""The port's spatial plane (``fedcrack_tpu_torch.parallel.spatial``) and
its halo pool held against the JAX package's ``parallel/spatial.py`` on the
CPU: the counterparts of ``tests/test_spatial.py``, each from JAX's
``init_variables`` carried across by ``models/convert``, at
``ModelConfig(img_size=64)`` with 4 shards and JAX's tolerances.

The batches hold two distinct images, so a halo taken from the wrong image
of the fold (a neighbour is the same image's next band, ``B`` fold rows
away) would show.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

CFG_KW = dict(img_size=64)
SHARDS = 4


def _variables(seed=0, **kw):
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.models.resunet import init_variables

    return jax.tree_util.tree_map(np.asarray, init_variables(jax.random.key(seed), ModelConfig(**{**CFG_KW, **kw})))


def _batch(batch=2, h=64, w=64, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    masks = (rng.uniform(size=(batch, h, w, 1)) > 0.7).astype(np.float32)
    return images, masks


def _cfg(**kw):
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**{**CFG_KW, **kw})


def _jax_cfg(**kw):
    from fedcrack_tpu.configs import ModelConfig

    return ModelConfig(**{**CFG_KW, **kw})


def _mesh(n_space=SHARDS, n_data=1):
    from fedcrack_tpu_torch.parallel import make_spatial_mesh

    return make_spatial_mesh(n_space, n_data, device="cpu")


def _single_device_probs(variables, images, cfg):
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    model = from_flax_variables(variables, ResUNet(cfg, device="cpu"))
    with torch.no_grad():
        return torch.sigmoid(model(torch.from_numpy(images))).float().numpy()


@pytest.mark.parametrize("fill", [0.0, -1.5], ids=["zero", "fill"])
def test_halo_exchange_neighbor_rows_and_edge_fill(fill):
    """Each band of each image receives its own image's neighbour rows, the
    image's edges ``fill``: JAX's ``halo_exchange`` under ``shard_map`` on
    the same two images, band by band."""
    import jax
    from jax.sharding import PartitionSpec as P

    from fedcrack_tpu.jaxcompat import shard_map
    from fedcrack_tpu.parallel.spatial import halo_exchange as jax_halo
    from fedcrack_tpu.parallel.spatial import make_spatial_mesh as jax_mesh
    from fedcrack_tpu_torch.parallel.spatial import fold_shards, halo_exchange

    b, h, w, c = 2, 8, 3, 2
    x = np.arange(b * h * w * c, dtype=np.float32).reshape(b, h, w, c) + 1.0
    want = np.asarray(jax.jit(shard_map(lambda xs: jax_halo(xs, "space", SHARDS, up=1, down=1, fill=fill),
                                        mesh=jax_mesh(SHARDS), in_specs=P(None, "space"),
                                        out_specs=P(None, "space")))(x))
    got = halo_exchange(fold_shards(torch.from_numpy(x), SHARDS), SHARDS, up=1, down=1, fill=fill).numpy()
    hs = h // SHARDS
    for s in range(SHARDS):
        for i in range(b):
            # JAX band s of image i: rows [s*(hs+2), (s+1)*(hs+2)) of its output.
            jband = want[i, s * (hs + 2):(s + 1) * (hs + 2)]
            np.testing.assert_array_equal(got[s * b + i].transpose(1, 2, 0), jband)
    # By hand: band 1 of image 1 starts with image 1's row hs - 1.
    np.testing.assert_array_equal(got[1 * b + 1, :, 0], x[1, hs - 1].T)
    assert (got[0 * b + 0, :, 0] == fill).all() and (got[(SHARDS - 1) * b + 1, :, -1] == fill).all()


@pytest.mark.parametrize("n_space", [1, 2, 4])
def test_spatial_predict_matches_jax_and_single_device(n_space):
    """``build_spatial_predict`` against JAX's on the same variables, and
    against the port's single-device forward, at JAX's rtol/atol 1e-5."""
    from fedcrack_tpu.parallel.spatial import build_spatial_predict as jax_predict
    from fedcrack_tpu.parallel.spatial import make_spatial_mesh as jax_mesh
    from fedcrack_tpu_torch.parallel import build_spatial_predict

    variables = _variables()
    images, _ = _batch()
    got = build_spatial_predict(_mesh(n_space), _cfg())(variables, images).numpy()
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, _single_device_probs(variables, images, _cfg()), rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_predict(jax_mesh(n_space), _jax_cfg())(variables, images))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spatial_predict_with_data_axis():
    from fedcrack_tpu.models.resunet import predict as jax_single
    from fedcrack_tpu_torch.parallel import build_spatial_predict

    variables = _variables()
    images, _ = _batch(batch=2)
    got = build_spatial_predict(_mesh(SHARDS, n_data=2), _cfg())(variables, images).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_single(variables, images, _jax_cfg())), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        build_spatial_predict(_mesh(SHARDS, n_data=2), _cfg())(variables, images[:1])


def test_spatial_predict_bfloat16_config():
    """bf16 tracks JAX's spatial bf16 at ``tests/test_spatial.py``'s loose
    tolerance (the port's BatchNorm normalises in float32 and casts back,
    JAX's spatial ``_bn`` in bfloat16), and the port's own single-device
    bf16 forward at the same tolerance."""
    from fedcrack_tpu.parallel.spatial import build_spatial_predict as jax_predict
    from fedcrack_tpu.parallel.spatial import make_spatial_mesh as jax_mesh
    from fedcrack_tpu_torch.parallel import build_spatial_predict

    variables = _variables()
    images, _ = _batch()
    got = build_spatial_predict(_mesh(), _cfg(compute_dtype="bfloat16"))(variables, images).float().numpy()
    want = np.asarray(jax_predict(jax_mesh(SHARDS), _jax_cfg(compute_dtype="bfloat16"))(variables, images), np.float32)
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.05)
    single = _single_device_probs(variables, images, _cfg(compute_dtype="bfloat16"))
    np.testing.assert_allclose(got, single, rtol=0.1, atol=0.05)


def test_spatial_predict_rejects_misaligned_height():
    from fedcrack_tpu_torch.parallel import build_spatial_predict

    predict_fn = build_spatial_predict(_mesh(), _cfg())
    with pytest.raises(ValueError, match="multiple of 16"):
        predict_fn(_variables(), np.zeros((1, 48, 64, 3), np.float32))  # 48 % (16 * 4) != 0
    with pytest.raises(ValueError, match="reference layout"):
        build_spatial_predict(_mesh(), _cfg(stem_layout="s2d"))


def test_spatial_train_step_matches_jax_gradients_and_stats():
    """One sharded step with SGD(1.0), so the parameter delta is the
    gradient, against ``jax.grad`` of the single-device loss (JAX's
    ``tests/test_spatial.py`` reference): per leaf ||d|| <= 5e-3 ||ref|| +
    1e-5, the running statistics within rtol 1e-4 / atol 1e-6, the loss
    within rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.models import ResUNet as JaxResUNet
    from fedcrack_tpu.ops.pallas_bce import fused_segmentation_metrics
    from fedcrack_tpu_torch.parallel import build_spatial_train_step

    variables = _variables()
    images, masks = _batch()
    model = JaxResUNet(config=_jax_cfg())

    def loss_fn(params):
        logits, mutated = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, images,
                                      train=True, mutable=["batch_stats"])
        m = fused_segmentation_metrics(logits, jnp.asarray(masks))
        return m["loss"], (m["loss"], mutated["batch_stats"])

    (_, (ref_loss, ref_stats)), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    step = build_spatial_train_step(_mesh(), _cfg(), optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
    state = step.init(variables)
    state, metrics = step(state, images, masks)
    new = state.variables
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_loss), rtol=1e-5, atol=1e-6)

    def leaves(tree):
        return jax.tree_util.tree_leaves_with_path(tree)

    grads = jax.tree_util.tree_map(lambda old, n: np.asarray(old, np.float64) - np.asarray(n, np.float64),
                                   variables["params"], new["params"])
    for (path, g), r in zip(leaves(grads), jax.tree_util.tree_leaves(ref_grads)):
        r = np.asarray(r, np.float64)
        err = np.linalg.norm(g - r)
        assert err <= 5e-3 * np.linalg.norm(r) + 1e-5, (jax.tree_util.keystr(path), err, np.linalg.norm(r))
    for (path, a), b in zip(leaves(new["batch_stats"]), jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=jax.tree_util.keystr(path))


def test_spatial_apply_returns_synced_stats_once():
    """``spatial_apply(train=True)`` on a variables tree returns the
    statistics after ONE momentum update with the whole batch's moments:
    equal to the single-device train-mode forward's, and not what S
    per-band updates would leave."""
    from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.parallel import spatial_apply

    variables = _variables()
    images, _ = _batch()
    x = torch.from_numpy(images)
    logits, stats = spatial_apply(variables, x, config=_cfg(), axis_size=SHARDS, train=True)
    model = from_flax_variables(variables, ResUNet(_cfg(), device="cpu")).train()
    want_logits = model(x)
    want = to_flax_variables(model)["batch_stats"]
    np.testing.assert_allclose(logits.detach().numpy(), want_logits.detach().numpy(), rtol=1e-4, atol=1e-4)
    for bn in want:
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[bn][k].numpy(), want[bn][k], rtol=1e-4, atol=1e-6, err_msg=bn)
    moved = want["stem_bn"]["mean"] - variables["batch_stats"]["stem_bn"]["mean"]
    assert np.abs(moved).max() > 0


# ---- the halo pool against the whole image's pool ----


def _halo_pool_case(kind: str, rng):
    x = rng.normal(size=(2, 16, 10, 3)).astype(np.float32)
    if kind == "ties":
        x = np.round(x).astype(np.float32)  # many equal maxima, across band edges too
    elif kind == "nan":
        x[0, 3, 4, 1] = np.nan  # a band's first row: read from the band above
        x[1, 7, 2, 0] = np.nan  # a band's last row
        x[1, 15, 5, 2] = np.nan  # the image's bottom row, beside the fill
    elif kind == "neg_inf":
        x[:, 12:] = -np.inf  # the last band all -inf: only pad and fill beside it
    return x


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("kind", ["random", "ties", "nan", "neg_inf"])
def test_halo_pool_matches_whole_image_pool(kind, n_space):
    """The bands' halo pools, stacked, give ``max_pool_3x3_s2``'s values on
    the whole image bit for bit, and its gradient: the first row-major
    maximum claims, a neighbour's halo row claims for the band above and
    its share flows back through the exchange, the last band's fill never
    claims. Integer cotangents keep every sum exact, so the gradient is
    held bitwise though a band's first row adds its two shares in another
    order."""
    from fedcrack_tpu_torch.ops.pooling import max_pool_3x3_s2, max_pool_3x3_s2_halo
    from fedcrack_tpu_torch.parallel.spatial import fold_shards, halo_exchange, unfold_shards

    rng = np.random.default_rng(7)
    x = _halo_pool_case(kind, rng)
    g = rng.integers(-8, 9, size=(2, 8, 5, 3)).astype(np.float32)

    whole = torch.from_numpy(x.copy()).requires_grad_(True)
    want = max_pool_3x3_s2(whole)
    want.backward(torch.from_numpy(g))

    sharded = torch.from_numpy(x.copy()).requires_grad_(True)
    xf = halo_exchange(fold_shards(sharded, n_space), n_space, up=0, down=1)
    n = xf.shape[0]
    halo_real = torch.arange(n) < n - n // n_space
    got = max_pool_3x3_s2_halo(xf.permute(0, 2, 3, 1), halo_real).permute(0, 3, 1, 2)
    got = unfold_shards(got, n_space)
    got.backward(torch.from_numpy(g))

    assert got.detach().numpy().tobytes() == want.detach().numpy().tobytes()
    assert sharded.grad.numpy().tobytes() == whole.grad.numpy().tobytes()
    # Every output's cotangent landed somewhere: none was lost to the fill.
    assert float(sharded.grad.sum()) == float(g.sum())


def test_halo_pool_fill_row_never_claims():
    """A fill row whose values would win the window (here +inf) is still
    SAME padding: -inf in the forward, no gradient; a neighbour's halo row
    with the same values wins and claims."""
    from fedcrack_tpu_torch.ops.pooling import max_pool_3x3_s2_halo

    x = torch.zeros(2, 5, 4, 1)
    x[:, -1] = float("inf")
    x.requires_grad_(True)
    out = max_pool_3x3_s2_halo(x, torch.tensor([True, False]))
    out.backward(torch.ones_like(out))
    assert torch.isinf(out[0, -1]).all() and (out[1] == 0).all()
    assert x.grad[0, -1].sum() == 2 and x.grad[1, -1].abs().sum() == 0
    with pytest.raises(ValueError, match="halo row"):
        max_pool_3x3_s2_halo(torch.zeros(1, 4, 4, 1), torch.tensor([True]))
