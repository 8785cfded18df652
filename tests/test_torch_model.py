"""The port's eval-mode ResUNet, pooling, upsampling, normalization and
weight carry-over held against the JAX package, with the same numpy
weights and inputs on both sides.

Logits tolerance: rtol 1e-4, atol 1e-4 in float32. Both sides compute the
same convolutions, but XLA and PyTorch's CPU convolutions (oneDNN) sum
the taps in different orders, so the last bits differ and the difference
grows through the net's depth. Pooling, upsampling, normalization and the
weight round trip move no arithmetic and are held bitwise.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, TWO_BLOCK_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port


def _port_model(kw, variables):
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    return from_flax_variables(variables, ResUNet(port_config(kw), device="cpu"))


@pytest.mark.parametrize(
    "kw,shape",
    [(TINY_KW, (2, 32, 32, 3)), (TWO_BLOCK_KW, (2, 20, 28, 3))],
    ids=["tiny_32", "two_block_odd_grid"],
)
def test_eval_logits_match_flax(kw, shape):
    """The 20 x 28 input runs the second pool on a 5 x 7 grid (odd: SAME
    pads 1 before and 1 after there, 0 and 1 on even grids)."""
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet

    variables = jax_variables(kw, seed=3)
    # Non-trivial BatchNorm statistics and affines, so eval BN is exercised.
    rng = np.random.default_rng(4)
    for name, stats in variables["batch_stats"].items():
        c = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        variables["params"][name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        variables["params"][name]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(FlaxResUNet(config=jax_config(kw)).apply(variables, x, train=False))
    with torch.no_grad():
        got = _port_model(kw, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [TINY_KW, TWO_BLOCK_KW], ids=["tiny", "two_block"])
def test_flax_round_trip_bit_exact(kw):
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict, to_flax_variables

    variables = jax_variables(kw, seed=1)
    model = _port_model(kw, variables)
    back = to_flax_variables(model)

    def check(a, b, path=()):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                check(a[k], b[k], path + (k,))
            else:
                assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype, path + (k,)
                np.testing.assert_array_equal(b[k], a[k], err_msg=str(path + (k,)))

    check(variables, back)
    state = flax_to_state_dict(variables)
    assert set(state) == set(model.state_dict())
    # Layouts: conv HWIO -> OIHW, depthwise (3, 3, 1, C) -> (C, 1, 3, 3).
    dw = variables["params"]["enc0_sep1"]["depthwise"]["kernel"]
    assert tuple(state["enc0_sep1.depthwise.weight"].shape) == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(
        state["enc0_sep1.depthwise.weight"][:, 0].numpy(), dw[:, :, 0, :].transpose(2, 0, 1)
    )


def test_port_init_is_seeded_and_flax_shaped():
    from fedcrack_tpu_torch.models.resunet import init_variables

    a = init_variables(torch.Generator().manual_seed(5), port_config(TINY_KW))
    b = init_variables(torch.Generator().manual_seed(5), port_config(TINY_KW))
    want = jax_variables(TINY_KW)

    def check(p, q, w, path=()):
        assert set(p) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                check(p[k], q[k], w[k], path + (k,))
            else:
                assert p[k].shape == w[k].shape, path + (k,)
                np.testing.assert_array_equal(p[k], q[k])
                if k in ("bias", "mean"):
                    assert not p[k].any()
                if k in ("scale", "var"):
                    assert (p[k] == 1).all()
                if k == "kernel":  # glorot-uniform bound, as flax draws it
                    *rf, fin, fout = w[k].shape
                    limit = np.sqrt(6.0 / (np.prod(rf) * (fin + fout)))
                    assert np.abs(p[k]).max() <= limit

    check(a, b, want)


@pytest.mark.parametrize(
    "shape", [(1, 5, 5, 2), (2, 6, 7, 3), (1, 1, 1, 1), (1, 8, 8, 1), (2, 9, 4, 2)]
)
def test_max_pool_matches_jax_incl_neg_inf_pads(shape):
    """All-negative inputs: a zero pad (instead of -inf) would win windows
    on the border; a symmetric pad on even grids would shift them."""
    from fedcrack_tpu.ops.pooling import max_pool_3x3_s2 as jax_pool
    from fedcrack_tpu_torch.ops.pooling import max_pool_3x3_s2, max_pool_auto

    rng = np.random.default_rng(sum(shape))
    x = -rng.uniform(1, 2, shape).astype(np.float32)
    want = np.asarray(jax_pool(x))
    got = max_pool_3x3_s2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(max_pool_auto(torch.from_numpy(x)).numpy(), want)


def test_same_pads_asymmetric_at_stride_2():
    from fedcrack_tpu.ops.pooling import _same_pads as jax_same_pads
    from fedcrack_tpu_torch.ops.pooling import same_pads

    assert same_pads(8, 3, 2) == (4, 0, 1)  # even grid: nothing before, 1 after
    assert same_pads(7, 3, 2) == (4, 1, 1)
    assert same_pads(8, 3, 1) == (8, 1, 1)
    assert same_pads(8, 1, 2) == (4, 0, 0)
    for size in range(1, 20):
        assert same_pads(size, 3, 2) == jax_same_pads(size)


def test_stem_stride2_same_conv_matches_flax():
    """The stem in isolation: flax Conv(3x3, stride 2, SAME) vs the port's
    explicit (0, 1) pad + nn.Conv2d, on an even grid."""
    import flax.linen as fnn
    import jax

    from fedcrack_tpu_torch.models.resunet import _conv, _pad_same

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, 12, 3)).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    params = conv.init(jax.random.key(0), x)
    want = np.asarray(conv.apply(params, x))
    layer = _conv(3, 5, 3, stride=2)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"])).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
        got = layer(_pad_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The symmetric pad the hazard warns about lands elsewhere.
    with torch.no_grad():
        wrong = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), layer.weight, layer.bias, stride=2, padding=1
        ).permute(0, 2, 3, 1)
    assert np.abs(wrong.numpy() - want).max() > 1e-2


def test_conv_transpose_is_the_unflipped_same_conv():
    """Flax ConvTranspose 3x3 stride 1 SAME == SAME conv with the same,
    unflipped kernel; nn.ConvTranspose2d (which flips) does not match."""
    import flax.linen as fnn
    import jax

    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 6, 7, 4)).astype(np.float32)
    convt = fnn.ConvTranspose(3, (3, 3), padding="SAME")
    params = convt.init(jax.random.key(1), x)
    want = np.asarray(convt.apply(params, x))
    k = torch.from_numpy(np.asarray(params["params"]["kernel"]))  # (3, 3, in, out)
    b = torch.from_numpy(np.asarray(params["params"]["bias"]))
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv2d(xc, k.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flipped = torch.nn.functional.conv_transpose2d(xc, k.permute(2, 3, 0, 1), b, padding=1)
    assert np.abs(flipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_strided_residual_reads_every_other_pixel():
    """A 1x1 stride-2 SAME conv reads x[:, ::2, ::2], on odd and even grids."""
    import flax.linen as fnn
    import jax

    rng = np.random.default_rng(9)
    for h, w in ((7, 9), (8, 6)):
        x = rng.normal(size=(1, h, w, 4)).astype(np.float32)
        conv = fnn.Conv(3, (1, 1), strides=(2, 2), padding="SAME")
        params = conv.init(jax.random.key(2), x)
        want = np.asarray(conv.apply(params, x))
        k = np.asarray(params["params"]["kernel"])[0, 0]
        got = x[:, ::2, ::2, :] @ k + np.asarray(params["params"]["bias"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_upsample_and_normalize_bit_exact():
    import jax.numpy as jnp

    from fedcrack_tpu.data.pipeline import normalize_images as jax_normalize
    from fedcrack_tpu.models.resunet import upsample2x as jax_upsample
    from fedcrack_tpu_torch.data.pipeline import normalize_images, to_uint8_transport
    from fedcrack_tpu_torch.models.resunet import upsample2x

    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(upsample2x(torch.from_numpy(x)).numpy(), np.asarray(jax_upsample(x)))
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    got = normalize_images(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_normalize(jnp.asarray(u8))))
    # uint8 transport round trip is exact for every byte value.
    back, _ = to_uint8_transport(got.numpy(), np.zeros((1,), np.float32))
    np.testing.assert_array_equal(back, u8)
    f = torch.from_numpy(x)
    assert normalize_images(f) is f


def test_model_rejects_layouts_the_port_does_not_run():
    """Every layout the config accepts now builds, with the reference
    layout's parameter shapes (tests/test_torch_layouts.py holds their
    values); a layout name the config does not know is refused there."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import ResUNet

    shapes = {k: v.shape for k, v in ResUNet(ModelConfig(), device="meta").state_dict().items()}
    for stem in ("reference", "s2d", "s2d_full"):
        for res in ("reference", "packed"):
            model = ResUNet(ModelConfig(stem_layout=stem, res_layout=res), device="meta")
            assert {k: v.shape for k, v in model.state_dict().items()} == shapes
    for kw in (dict(stem_layout="nope"), dict(res_layout="nope")):
        with pytest.raises(ValueError, match="_layout"):
            ModelConfig(**kw)
    # bfloat16 compute over float32 parameters runs (tests/test_torch_bf16.py);
    # any other dtype pairing is refused.
    assert ResUNet(ModelConfig(compute_dtype="bfloat16"), device="meta").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ResUNet(ModelConfig(compute_dtype="bfloat16", param_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError):
        ResUNet(ModelConfig(compute_dtype="float16"), device="cpu")


def test_configs_match_jax():
    import dataclasses

    from fedcrack_tpu.configs import ModelConfig as JaxModelConfig
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig

    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JaxModelConfig())
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(JaxServeConfig())
    bad = [
        dict(bucket_sizes=()), dict(bucket_sizes=(256, 128)), dict(bucket_sizes=(100,)),
        dict(max_batch=0), dict(tile_overlap=128), dict(quant="int4"),
        dict(kernel_plane="fused_int8"), dict(quant="int8", kernel_plane="bf4"),
        dict(quant_iou_floor=0.0), dict(max_replicas=2), dict(shadow_fraction=2.0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            JaxServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    for kw in (dict(img_size=40), dict(stem_layout="x"), dict(res_layout="x")):
        with pytest.raises(ValueError):
            JaxModelConfig(**kw)
        with pytest.raises(ValueError):
            ModelConfig(**kw)


@pytest.mark.parametrize("name", ["resunet", "UNet", "mobilenet_v2", "MOBILENET_V2"])
def test_get_model_resolves_the_jax_aliases(name):
    from fedcrack_tpu.models import get_model as jax_get_model

    from fedcrack_tpu_torch.models import ResUNet, get_model

    cfg = port_config(TINY_KW)
    model = get_model(name, cfg, device="cpu")
    assert isinstance(model, ResUNet) and model.config == cfg
    assert type(jax_get_model(name, jax_config(TINY_KW))).__name__ == "ResUNet"


def test_get_model_refuses_an_unknown_name_with_the_jax_text():
    from fedcrack_tpu.models import get_model as jax_get_model

    from fedcrack_tpu_torch.models import get_model

    with pytest.raises(KeyError) as jax_err:
        jax_get_model("vgg16")
    with pytest.raises(KeyError) as port_err:
        get_model("vgg16", device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_predict_matches_flax():
    """``models.resunet.predict``: sigmoid probabilities in inference mode,
    against the JAX ``predict`` on the same weights (the logits' tolerance
    above; the sigmoid only shrinks a difference)."""
    from fedcrack_tpu.models.resunet import predict as jax_predict

    from fedcrack_tpu_torch.models.resunet import predict

    variables = jax_variables(TINY_KW, seed=5)
    x = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_predict(variables, x, jax_config(TINY_KW)))
    got = predict(variables, x, port_config(TINY_KW), device="cpu")
    assert got.device.type == "cpu" and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
