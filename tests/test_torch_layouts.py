"""The port's model layouts (``ModelConfig.stem_layout`` / ``res_layout``)
held against the JAX package on the CPU, and against the port's own
reference layout.

- The data movement and kernel folds (``space_to_depth``,
  ``fold_stem_kernel_s2d*``, ``pack_res_kernel`` and their inverses, the
  host ``space_to_depth_images``) are byte-equal to JAX's on the same
  numpy input: they move values and insert exact zeros.
- The forward of every layout pair, eval and train mode (logits and
  running statistics), against JAX's same config on JAX's initial
  variables (BatchNorm affines and statistics made non-trivial): rtol and
  atol 1e-4 on the logits, 1e-5 on the statistics, as
  tests/test_torch_train.py holds the reference layout.
- Against the port's reference layout: the JAX docstrings call ``s2d`` and
  ``packed`` bit-exact, which holds only where the backend sums the real
  conv taps in the reference's order. On oneDNN (this CPU) the
  width-folded stem at strides (2, 1) and the 1x1 conv over the packed
  ``4C`` channels give the reference layout's logits, statistics and
  gradients bit for bit at every shape tried here: the tests assert
  ``torch.equal``. ``s2d_full`` sums taps of different kernel rows in one
  packed block, so it is reassociated; it is held at JAX's
  ``test_s2d_full_is_exact_arithmetic_but_reassociated`` tolerance (atol
  and rtol 1e-4). cuDNN on the card is measured by ``chip_smoke.py``
  phase 22, not assumed.
- Packed and unpacked input to one space-to-depth model reduce to the same
  conv on the same tensor after data movement: ``torch.equal``.
- Gradients and one Adam step against JAX at tests/test_torch_train.py's
  tolerances; bf16 at tests/test_torch_bf16.py's derived bounds.
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

# Every pairing the JAX tests run, and the packed residual alone.
PAIRS = [("s2d", "reference"), ("s2d_full", "packed"), ("s2d", "packed"), ("reference", "packed")]
PAIR_IDS = [f"{s}+{r}" for s, r in PAIRS]
# 32 px on the one-block model, 64 px on the two-block one.
SIZES = [(TINY_KW, 32), (TWO_BLOCK_KW, 64)]
SIZE_IDS = ["32px", "64px"]
BF16_STEP = 2.0 ** -8


def _kw(kw, size, stem="reference", res="reference", **extra):
    return dict(kw, img_size=size, stem_layout=stem, res_layout=res, **extra)


def _variables(kw, seed):
    """JAX's ``init_variables`` with non-trivial BatchNorm affines and
    statistics, as numpy."""
    variables = jax_variables(kw, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for name, stats in variables["batch_stats"].items():
        c = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        variables["params"][name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        variables["params"][name]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    return variables


def _port_model(kw, variables):
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    return from_flax_variables(variables, ResUNet(port_config(kw), device="cpu"))


def _images(n, size, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _port_forward(kw, variables, x, train):
    """Logits and (train mode) the flax-layout running statistics."""
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    model = _port_model(kw, variables)
    model.train(train)
    with torch.no_grad():
        logits = model(torch.as_tensor(x))
    return logits, dict(flat_tree(to_flax_variables(model)["batch_stats"]))


# ---- data movement and kernel folds, byte-equal to JAX ----


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_space_to_depth_byte_equal_to_jax(dtype):
    import jax.numpy as jnp

    from fedcrack_tpu.models.resunet import depth_to_space as jax_d2s
    from fedcrack_tpu.models.resunet import space_to_depth as jax_s2d
    from fedcrack_tpu_torch.models import depth_to_space, space_to_depth

    rng = np.random.default_rng(0)
    x = (rng.integers(0, 255, (2, 8, 12, 3)) if dtype == np.uint8 else rng.normal(size=(2, 8, 12, 3))).astype(dtype)
    got = space_to_depth(torch.from_numpy(x))
    assert got.shape == (2, 4, 6, 12)
    assert got.numpy().tobytes() == np.asarray(jax_s2d(jnp.asarray(x))).tobytes()
    # Packed channel (di*2+dj)*C + c.
    assert got[1, 2, 3, (1 * 2 + 0) * 3 + 2] == torch.from_numpy(x)[1, 5, 6, 2]
    back = depth_to_space(got)
    assert back.numpy().tobytes() == x.tobytes()
    assert back.numpy().tobytes() == np.asarray(jax_d2s(jax_s2d(jnp.asarray(x)))).tobytes()
    with pytest.raises(ValueError, match="even"):
        space_to_depth(torch.zeros(1, 3, 4, 3))
    with pytest.raises(ValueError, match="% 4"):
        depth_to_space(torch.zeros(1, 2, 2, 6))


@pytest.mark.parametrize("shape,dtype", [((2, 32, 32, 3), np.uint8), ((2, 3, 2, 32, 32, 3), np.float32)],
                         ids=["batch_uint8", "round_layout_float32"])
def test_space_to_depth_images_byte_equal_to_jax(shape, dtype):
    """The host staging twin, on a batch and on the ``[C, steps, B, ...]``
    round layout, against JAX's and against the model's device twin."""
    from fedcrack_tpu.data.pipeline import space_to_depth_images as jax_images
    from fedcrack_tpu_torch.data.pipeline import space_to_depth_images
    from fedcrack_tpu_torch.models import space_to_depth

    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, shape).astype(dtype) if dtype == np.uint8 else rng.random(shape, dtype=np.float32)
    got = space_to_depth_images(x)
    assert got.shape == shape[:-3] + (16, 16, 12) and got.flags.c_contiguous
    assert got.tobytes() == jax_images(x).tobytes()
    flat = x.reshape(-1, 32, 32, 3)
    assert got.tobytes() == space_to_depth(torch.from_numpy(flat)).numpy().tobytes()
    with pytest.raises(ValueError, match="even"):
        space_to_depth_images(np.zeros((1, 5, 4, 3), np.uint8))


FOLDS = ["fold_stem_kernel_s2d", "fold_stem_kernel_s2d_full", "pack_res_kernel"]
INVERSE = {"fold_stem_kernel_s2d": "unfold_stem_kernel_s2d",
           "fold_stem_kernel_s2d_full": "unfold_stem_kernel_s2d_full", "pack_res_kernel": "unpack_res_kernel"}


@pytest.mark.parametrize("name", FOLDS)
@pytest.mark.parametrize("way", ["fold", "unfold"])
def test_kernel_folds_byte_equal_to_jax(name, way):
    """Each fold and its inverse on the same HWIO numpy kernel (JAX's
    initial ``stem_conv`` / ``enc0_res`` kernels at full width) give JAX's
    bytes, and each round trip is exact."""
    import jax.numpy as jnp

    from fedcrack_tpu.models import resunet as jr
    from fedcrack_tpu_torch.models import resunet as tr

    variables = jax_variables({}, seed=0)
    kernel = variables["params"]["enc0_res" if name == "pack_res_kernel" else "stem_conv"]["kernel"]
    folded = getattr(tr, name)(torch.from_numpy(kernel.copy()))
    want = np.asarray(getattr(jr, name)(jnp.asarray(kernel)))
    assert folded.shape == want.shape
    if way == "fold":
        assert folded.numpy().tobytes() == want.tobytes()
        return
    back = getattr(tr, INVERSE[name])(folded)
    assert back.numpy().tobytes() == kernel.tobytes()
    assert back.numpy().tobytes() == np.asarray(getattr(jr, INVERSE[name])(jnp.asarray(want))).tobytes()


def test_kernel_folds_refuse_wrong_shapes():
    from fedcrack_tpu_torch.models import resunet as tr

    for fn, shape in (("fold_stem_kernel_s2d", (1, 1, 3, 4)), ("unfold_stem_kernel_s2d", (3, 3, 6, 4)),
                      ("fold_stem_kernel_s2d_full", (2, 2, 3, 4)), ("unfold_stem_kernel_s2d_full", (3, 2, 12, 4)),
                      ("pack_res_kernel", (3, 3, 3, 4)), ("unpack_res_kernel", (1, 1, 6, 4))):
        with pytest.raises(ValueError, match="expected"):
            getattr(tr, fn)(torch.zeros(shape))


# ---- the forward against JAX's same config ----


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw,size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("stem,res", PAIRS, ids=PAIR_IDS)
def test_forward_matches_jax(stem, res, kw, size, train):
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet

    cfg = _kw(kw, size, stem, res)
    variables = _variables(cfg, seed=3)
    x = _images(2, size, seed=4)
    net = FlaxResUNet(config=jax_config(cfg))
    if train:
        want, mutated = net.apply(variables, x, train=True, mutable=["batch_stats"])
    else:
        want = net.apply(variables, x, train=False)
    got, stats = _port_forward(cfg, variables, x, train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if train:
        for path, value in flat_tree(to_numpy_tree(mutated["batch_stats"])):
            np.testing.assert_allclose(stats[path], value, rtol=1e-5, atol=1e-5, err_msg="/".join(path))


# ---- against the port's reference layout ----


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw,size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("stem,res", PAIRS, ids=PAIR_IDS)
def test_layout_against_reference_layout(stem, res, kw, size, train):
    """``s2d`` and ``packed``: ``torch.equal`` to the reference layout on
    oneDNN (logits and running statistics). ``s2d_full``: reassociated,
    within atol and rtol 1e-4 (JAX's tolerance for it)."""
    variables = _variables(_kw(kw, size), seed=5)
    x = _images(3, size, seed=6)
    want, want_stats = _port_forward(_kw(kw, size), variables, x, train)
    got, stats = _port_forward(_kw(kw, size, stem, res), variables, x, train)
    if stem == "s2d_full":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
        for path, value in want_stats.items():
            np.testing.assert_allclose(stats[path], value, rtol=1e-5, atol=1e-5, err_msg="/".join(path))
        return
    assert torch.equal(got, want)
    for path, value in want_stats.items():
        assert stats[path].tobytes() == value.tobytes(), path


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stem", ["s2d", "s2d_full"])
def test_packed_input_equals_unpacked_input(stem, train):
    """``space_to_depth(x)`` and ``x`` into one space-to-depth model:
    ``torch.equal`` logits and statistics (JAX's
    ``test_s2d_layout_accepts_packed_input``)."""
    from fedcrack_tpu_torch.models import space_to_depth

    cfg = _kw(TWO_BLOCK_KW, 64, stem, "packed")
    variables = _variables(cfg, seed=7)
    x = _images(2, 64, seed=8)
    unpacked, s_unpacked = _port_forward(cfg, variables, x, train)
    packed, s_packed = _port_forward(cfg, variables, space_to_depth(torch.from_numpy(x)), train)
    assert packed.shape == (2, 64, 64, 1)
    assert torch.equal(unpacked, packed)
    for path, value in s_unpacked.items():
        assert s_packed[path].tobytes() == value.tobytes(), path


@pytest.mark.parametrize("stem", ["s2d", "s2d_full"])
def test_wrong_channel_count_raises(stem):
    from fedcrack_tpu_torch.models.resunet import ResUNet

    model = ResUNet(port_config(_kw(TINY_KW, 32, stem)), generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="channels"):
        model(torch.zeros(1, 64, 64, 5))


def test_parameters_identical_across_layouts():
    """Names, shapes and initial values from one generator are the
    reference layout's in every layout, and the flax tree's structure is
    JAX's (the weight carry, FedAvg, the wire and checkpoints never see
    the layout)."""
    from fedcrack_tpu_torch.models.resunet import PackedResConv, ResUNet, S2DStemConv, init_variables

    ref = ResUNet(port_config(TWO_BLOCK_KW), generator=torch.Generator().manual_seed(1), device="cpu")
    ref_state = ref.state_dict()
    ref_tree = dict(flat_tree(init_variables(torch.Generator().manual_seed(2), port_config(TWO_BLOCK_KW))))
    for stem, res in PAIRS:
        cfg = _kw(TWO_BLOCK_KW, 32, stem, res)
        model = ResUNet(port_config(cfg), generator=torch.Generator().manual_seed(1), device="cpu")
        assert isinstance(model.stem_conv, S2DStemConv) == (stem != "reference")
        assert isinstance(model.enc1_res, PackedResConv) == (res == "packed")
        state = model.state_dict()
        assert list(state) == list(ref_state)
        for k, v in ref_state.items():
            assert state[k].shape == v.shape and torch.equal(state[k], v), (stem, res, k)
        tree = dict(flat_tree(init_variables(torch.Generator().manual_seed(2), port_config(cfg))))
        jax_tree = dict(flat_tree(jax_variables(cfg, seed=0)))
        assert set(tree) == set(ref_tree) == set(jax_tree)
        for path, v in ref_tree.items():
            assert tree[path].tobytes() == v.tobytes() and jax_tree[path].shape == v.shape, path


# ---- gradients, Adam, bf16 ----


@pytest.mark.parametrize("stem,res", PAIRS, ids=PAIR_IDS)
def test_gradients_match_jax_and_reference_layout(stem, res):
    """Every parameter's gradient of a BCE loss through the train-mode net
    against ``jax.grad`` of JAX's same config (tests/test_torch_train.py's
    rtol 1e-4 and atol 1e-4 of the largest gradient; a BatchNorm-fed bias
    at its true 0), landing on the reference-shaped parameters; ``s2d``
    and ``packed`` gradients ``torch.equal`` to the reference layout's."""
    import jax
    import jax.numpy as jnp
    import optax

    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet
    from fedcrack_tpu_torch.ops.losses import sigmoid_bce

    cfg = _kw(TWO_BLOCK_KW, 32, stem, res)
    variables = _variables(cfg, seed=9)
    x = _images(2, 32, seed=10)
    y = (np.random.default_rng(11).uniform(size=(2, 32, 32, 1)) > 0.8).astype(np.float32)
    net = FlaxResUNet(config=jax_config(cfg))

    def loss_fn(params):
        logits, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                              mutable=["batch_stats"])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y))

    want = dict(flat_tree({"params": to_numpy_tree(jax.grad(loss_fn)(variables["params"]))}))
    grads = {}
    for c in (cfg, _kw(TWO_BLOCK_KW, 32)):
        model = _port_model(c, variables)
        model.train()
        sigmoid_bce(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        grads[c["stem_layout"], c["res_layout"]] = {k: p.grad for k, p in model.named_parameters()}
    got, ref = grads[stem, res], grads["reference", "reference"]
    scale = max(np.abs(v).max() for v in want.values())
    for path, g_want in want.items():
        key = ".".join(path[1:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        g = got[key]
        assert g.shape == ref[key].shape
        if stem != "s2d_full":
            assert torch.equal(g, ref[key]), key
        g = (g.permute(2, 3, 1, 0) if path[-1] == "kernel" else g).numpy()
        if bn_fed_bias(path):
            assert np.abs(g).max() <= 1e-5 * scale and np.abs(g_want).max() <= 1e-5 * scale, key
            continue
        np.testing.assert_allclose(g, g_want, rtol=1e-4, atol=1e-4 * scale, err_msg=key)


@pytest.mark.parametrize("stem,res", PAIRS[:3], ids=PAIR_IDS[:3])
def test_train_step_matches_jax(stem, res):
    """One ``train_step`` (Adam, BCE through ``bce_sums``' plain version)
    from the same weights and batch, with pre-packed images into the port
    for the space-to-depth stems, against JAX's step on unpacked images
    (tests/test_torch_train.py's rules); Adam holds exactly the
    reference-shaped parameters."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.data.pipeline import space_to_depth_images
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train import local as tl

    cfg = _kw(TINY_KW, 32, stem, res)
    variables = jax_variables(cfg, seed=0)
    imgs, msks = synth_crack_batch(4, 32, seed=1)
    js = jl.create_train_state(jax.random.key(0), jax_config(cfg), LR).replace_variables(variables)
    js, jm = jl.train_step(js, (imgs, msks), variables["params"], jnp.float32(0.0), jnp.float32(1.0))
    ts = tl.create_train_state(torch.Generator().manual_seed(0), port_config(cfg), LR,
                               device="cpu").replace_variables(variables)
    shapes = [tuple(p.shape) for p in ts.optimizer.param_groups[0]["params"]]
    ref = tl.create_train_state(torch.Generator().manual_seed(0), port_config(TINY_KW), LR, device="cpu")
    assert shapes == [tuple(p.shape) for p in ref.optimizer.param_groups[0]["params"]]
    ts, tm = tl.train_step(ts, (space_to_depth_images(imgs), msks), tl.snapshot_params(ts), 0.0, 1.0)
    for k in ("pixel_acc", "iou_inter", "iou_union"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_trained_trees_close(ts.variables, to_numpy_tree({"params": js.params, "batch_stats": js.batch_stats}),
                               variables, steps=1)
    assert all(tuple(s["exp_avg"].shape) in shapes for s in ts.optimizer.state.values())


def _roundings(model) -> int:
    from fedcrack_tpu_torch.models.resunet import BatchNorm, Conv

    return sum(isinstance(m, (Conv, BatchNorm)) for m in model.modules())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stem,res", PAIRS[:3], ids=PAIR_IDS[:3])
def test_bf16_forward_matches_jax(stem, res, train):
    """bfloat16 compute with each layout against JAX's bfloat16 model of
    the same layout, held as tests/test_torch_bf16.py holds the reference
    layout: each logit within ``n * 2^-8 * max|logits|`` and the mean
    within ``sqrt(n) * 2^-8 * mean|logits|``, ``n`` the model's
    roundings; the port nearer JAX's bfloat16 logits than JAX's float32
    logits are."""
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet

    cfg = _kw(TWO_BLOCK_KW, 32, stem, res)
    bf16 = dict(cfg, compute_dtype="bfloat16")
    variables = jax_variables(cfg, seed=3)
    x = _images(4, 32, seed=4)
    if train:
        want = FlaxResUNet(config=jax_config(bf16)).apply(variables, x, train=True, mutable=["batch_stats"])[0]
        f32 = FlaxResUNet(config=jax_config(cfg)).apply(variables, x, train=True, mutable=["batch_stats"])[0]
    else:
        want = FlaxResUNet(config=jax_config(bf16)).apply(variables, x, train=False)
        f32 = FlaxResUNet(config=jax_config(cfg)).apply(variables, x, train=False)
    want, f32 = np.asarray(want), np.asarray(f32)
    model = _port_model(bf16, variables)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    n = _roundings(model)
    np.testing.assert_allclose(got, want, rtol=0, atol=n * BF16_STEP * float(np.abs(want).max()))
    assert float(np.abs(got - want).mean()) <= np.sqrt(n) * BF16_STEP * float(np.abs(want).mean())
    assert np.abs(got - want).mean() < np.abs(f32 - want).mean()


def test_bf16_layout_convs_round_like_the_reference_convs():
    """Under bf16 the derived-kernel convs cast the kernel before the fold
    and add the bias to the rounded output: their outputs are bfloat16,
    and in eval mode the c6 pairing (``s2d`` + ``packed``) gives the bf16
    reference layout's logits bit for bit on oneDNN."""
    from fedcrack_tpu_torch.models.resunet import PackedResConv, S2DStemConv

    bf16 = dict(TWO_BLOCK_KW, compute_dtype="bfloat16")
    variables = jax_variables(TWO_BLOCK_KW, seed=3)
    x = torch.from_numpy(_images(2, 32, seed=5))
    model = _port_model(_kw(bf16, 32, "s2d", "packed"), variables)
    seen = {}
    for name, module in model.named_modules():
        if isinstance(module, (S2DStemConv, PackedResConv)):
            module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    with torch.no_grad():
        got = model(x)
        want = _port_model(bf16, variables)(x)
    assert seen == {"stem_conv": torch.bfloat16, "enc0_res": torch.bfloat16, "enc1_res": torch.bfloat16}
    assert torch.equal(got, want)


def test_bf16_train_step_matches_jax_c6_layout():
    """One bfloat16 ``train_step`` with c6's layouts (``s2d`` + ``packed``)
    against JAX's, held as tests/test_torch_bf16.py holds the reference
    layout's step: every parameter moved at most ``lr`` on each side, at
    most 2% of the elements more than 1e-2·lr apart."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train import local as tl

    cfg = _kw(TINY_KW, 32, "s2d", "packed", compute_dtype="bfloat16")
    variables = jax_variables(TINY_KW, seed=0)
    imgs, msks = synth_crack_batch(4, 32, seed=1)
    js = jl.create_train_state(jax.random.key(0), jax_config(cfg), LR).replace_variables(variables)
    js, jm = jl.train_step(js, (imgs, msks), variables["params"], jnp.float32(0.0), jnp.float32(1.0))
    ts = tl.create_train_state(torch.Generator().manual_seed(0), port_config(cfg), LR,
                               device="cpu").replace_variables(variables)
    ts, tm = tl.train_step(ts, (imgs, msks), tl.snapshot_params(ts), 0.0, 1.0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_STEP)
    got, start = dict(flat_tree(ts.variables)), dict(flat_tree(variables))
    want = dict(flat_tree(to_numpy_tree({"params": js.params, "batch_stats": js.batch_stats})))
    far = total = 0
    for path, w in want.items():
        g = got[path]
        if path[0] == "batch_stats":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 + 0.01 * BF16_STEP * float(np.abs(w).max() + 1.0))
            continue
        bound = LR * (1 + 1e-5) + float(np.spacing(np.abs(start[path]).max() + LR))
        assert np.abs(g - start[path]).max() <= bound and np.abs(w - start[path]).max() <= bound, path
        if not bn_fed_bias(path):
            far += int((np.abs(g - w) > 1e-2 * LR).sum())
            total += g.size
    assert far <= 0.02 * total, (far, total)
