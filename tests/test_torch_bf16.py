"""bfloat16 compute in the port, held against the JAX package on the CPU:
``ModelConfig(compute_dtype="bfloat16")`` with float32 parameters, in the
forward (eval and train mode), one train step, and the serving engine's
reference program.

Tolerances and why. Both packages round to bfloat16 at the same points
(after every conv and its bias add, after every BatchNorm), but XLA and
oneDNN sum conv taps in other orders and reduce the batch moments in
other orders, so now and then one side's float32 value lands on the other
side of a bfloat16 rounding boundary: one bfloat16 step, 2^-8 of the
value. Such a flip propagates, at worst adding one step per rounding on
the way to the logits. So with ``n`` roundings on the deepest path (the
model's convs and BatchNorms, counted from the model), each logit is held
within ``n * 2^-8 * max|logits|``; flips at different roundings are
independent and add in quadrature on average, so the mean difference is
held within ``sqrt(n) * 2^-8 * mean|logits|``. The port's logits must
also sit nearer JAX's bfloat16 logits than JAX's float32 logits do.

After one Adam step every parameter has moved at most ``lr`` on each side,
so the two stay within ``2 * lr``. Adam's first step is
``lr * g / (|g| + 1e-7)``, which is ``+-lr`` wherever the gradient is above
noise, so the two steps agree to 1e-2·lr except where a bfloat16 gradient
is at noise level and its sign differs: at most 2% of the elements.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    LR,
    TINY_KW,
    TWO_BLOCK_KW,
    bn_fed_bias,
    flat_tree,
    jax_config,
    jax_variables,
    port_config,
    to_numpy_tree,
)

pytestmark = pytest.mark.torch_port

BF16_STEP = 2.0 ** -8


def _bf16(kw):
    return dict(kw, compute_dtype="bfloat16")


def _port_model(kw, variables):
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    return from_flax_variables(variables, ResUNet(port_config(_bf16(kw)), device="cpu"))


def _roundings(model) -> int:
    from fedcrack_tpu_torch.models.resunet import BatchNorm, Conv

    return sum(isinstance(m, (Conv, BatchNorm)) for m in model.modules())


def _hold(got, want, n):
    scale = np.abs(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=n * BF16_STEP * float(scale.max()))
    assert float(np.abs(got - want).mean()) <= np.sqrt(n) * BF16_STEP * float(scale.mean())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [TINY_KW, TWO_BLOCK_KW], ids=["tiny", "two_block"])
def test_bf16_forward_matches_flax(kw, train):
    """Logits (and in train mode the running statistics) against
    ``fedcrack_tpu.models.resunet.ResUNet(ModelConfig(compute_dtype=
    "bfloat16"))`` on the same weights and input; the port's bf16 logits
    also sit nearer JAX's bf16 logits than JAX's float32 ones do."""
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    variables = jax_variables(kw, seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    flax_bf16 = FlaxResUNet(config=jax_config(_bf16(kw)))
    if train:
        want, mutated = flax_bf16.apply(variables, x, train=True, mutable=["batch_stats"])
        f32 = FlaxResUNet(config=jax_config(kw)).apply(variables, x, train=True, mutable=["batch_stats"])[0]
    else:
        want = flax_bf16.apply(variables, x, train=False)
        f32 = FlaxResUNet(config=jax_config(kw)).apply(variables, x, train=False)
    want, f32 = np.asarray(want), np.asarray(f32)
    model = _port_model(kw, variables)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    _hold(got, want, _roundings(model))
    assert np.abs(got - want).mean() < np.abs(f32 - want).mean()
    if train:
        stats = dict(flat_tree(to_numpy_tree(mutated["batch_stats"])))
        mine = dict(flat_tree(to_flax_variables(model)["batch_stats"]))
        for path, value in stats.items():
            assert mine[path].dtype == np.float32
            # 0.01 of the batch moment, itself a float32 mean of bfloat16
            # activations that may differ by a step.
            np.testing.assert_allclose(mine[path], value, rtol=0,
                                       atol=1e-6 + 0.01 * BF16_STEP * float(np.abs(value).max() + 1.0))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_activations_are_bf16(train):
    """Forward hooks on every conv and BatchNorm: bfloat16 outputs, but the
    head's float32 logits; the same hooks see float32 on a float32 model,
    so a silent float32 run fails here."""
    from fedcrack_tpu_torch.models.resunet import BatchNorm, Conv, ResUNet

    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    for compute, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model = ResUNet(port_config(dict(TWO_BLOCK_KW, compute_dtype=compute)),
                        generator=torch.Generator().manual_seed(0), device="cpu")
        model.train(train)
        seen = {}
        for name, module in model.named_modules():
            if isinstance(module, (Conv, BatchNorm)):
                module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
        with torch.set_grad_enabled(train):
            out = model(x)
        assert out.dtype == torch.float32
        assert seen.pop("head") == torch.float32
        assert len(seen) == _roundings(model) - 1
        assert set(seen.values()) == {want}, seen


def test_bf16_parameters_buffers_and_gradients_stay_float32():
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics

    model = ResUNet(port_config(_bf16(TINY_KW)), generator=torch.Generator().manual_seed(0), device="cpu")
    model.train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(0, 1, (2, 32, 32, 1)) > 0.8).astype(np.float32))
    logits = model(x)
    assert logits.dtype == torch.float32  # what bce_sums is fed
    fused_segmentation_metrics(logits, y)["loss"].backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
    assert {b.dtype for b in model.buffers()} == {torch.float32}


def test_bf16_train_step_matches_jax():
    """One ``train_step`` at ``compute_dtype="bfloat16"`` from the same
    weights and batch in both packages, held as the module docstring says."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train import local as tl

    variables = jax_variables(TINY_KW, seed=0)
    imgs, msks = synth_crack_batch(4, 32, seed=1)
    js = jl.create_train_state(jax.random.key(0), jax_config(_bf16(TINY_KW)), LR).replace_variables(variables)
    js, jm = jl.train_step(js, (imgs, msks), variables["params"], jnp.float32(0.0), jnp.float32(1.0))
    ts = tl.create_train_state(torch.Generator().manual_seed(0), port_config(_bf16(TINY_KW)), LR,
                               device="cpu").replace_variables(variables)
    ts, tm = tl.train_step(ts, (imgs, msks), tl.snapshot_params(ts), 0.0, 1.0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_STEP)
    got = dict(flat_tree(ts.variables))
    want = dict(flat_tree(to_numpy_tree({"params": js.params, "batch_stats": js.batch_stats})))
    start = dict(flat_tree(variables))
    far = total = 0
    for path, w in want.items():
        g = got[path]
        assert g.dtype == np.float32, path
        if path[0] == "batch_stats":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 + 0.01 * BF16_STEP * float(np.abs(w).max() + 1.0))
            continue
        # Plus the float32 rounding of the updated parameter itself.
        bound = LR * (1 + 1e-5) + float(np.spacing(np.abs(start[path]).max() + LR))
        assert np.abs(g - start[path]).max() <= bound and np.abs(w - start[path]).max() <= bound, path
        if not bn_fed_bias(path):
            far += int((np.abs(g - w) > 1e-2 * LR).sum())
            total += g.size
    assert far <= 0.02 * total, (far, total)


def test_bf16_engine_reference_program_matches_jax():
    """The reference program of a bfloat16 serving engine against the JAX
    engine's at the same ``ServeConfig(compute_dtype="bfloat16")``; the
    fused plane ignores the compute dtype (bitwise the float32 engine's),
    and the quant gate holds it against the bfloat16 reference program."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    kw = dict(bucket_sizes=(32,), max_batch=4, max_delay_ms=10.0, tile_overlap=4, compute_dtype="bfloat16")
    variables = jax_variables(TINY_KW, seed=0)
    images = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    jax_engine = JaxEngine(jax_config(TINY_KW), JaxServeConfig(**kw))
    want = jax_engine.predict_bucket(jax_engine.prepare(variables), images)
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**kw, quant="int8", kernel_plane="fused_int8"),
                             device="cpu")
    reference = engine.prepare(variables)
    assert reference.compute_dtype == torch.bfloat16
    got = engine.predict_bucket(reference, images)
    # The sigmoid's slope is at most 1/4: the logit bound carries over.
    _hold(got, want, _roundings(reference))
    f32 = InferenceEngine(port_config(TINY_KW), ServeConfig(**dict(kw, compute_dtype="float32"), quant="int8",
                                                            kernel_plane="fused_int8"), device="cpu")
    quantized = tq.quantize_variables(variables)
    fused = engine.predict_bucket(engine.prepare_quantized(quantized), images)
    np.testing.assert_array_equal(fused, f32.predict_bucket(f32.prepare_quantized(quantized), images))
    gate = tq.quant_gate(engine, reference, engine.prepare_quantized(quantized))
    batch = tq.probe_images(32, 4, engine.serve_config.quant_probe_seed)
    assert gate.iou == tq.mask_iou(engine.predict_bucket(reference, batch),
                                   engine.predict_bucket(engine.prepare_quantized(quantized), batch))


def test_command_lines_take_compute_dtype_from_config(tmp_path):
    """``--config configs/c5_bf16_batch_dp.json`` gives both packages'
    ``build_config`` (the server's and the client's) the same bfloat16
    ``ModelConfig``, and the client's ``make_train_fn`` then fits in
    bfloat16 (a tiny-width copy of that config, two steps, against the JAX
    package's fit: the loss within one bfloat16 step, and each parameter
    moved at most ``1.0014 * lr`` per step on each side; by Cauchy-Schwarz
    on Adam's bias-corrected moments, the second step's
    ``|m_hat| / sqrt(v_hat)`` is at most ``sqrt(1.0027)``).
    ``train.centralized`` takes no ``--config`` in either package and
    always trains float32."""
    import dataclasses
    import json
    import os

    from fedcrack_tpu import server as jax_server
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxDataset
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.train.federated import make_train_fn as jax_make_train_fn
    from fedcrack_tpu_torch import server
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train import centralized
    from fedcrack_tpu_torch.train.federated import make_train_fn

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    c5 = os.path.join(root, "configs", "c5_bf16_batch_dp.json")
    cfg, _ = server.build_config(["--config", c5])
    jcfg, _ = jax_server.build_config(["--config", c5])
    assert cfg.model.compute_dtype == "bfloat16" and cfg.model.param_dtype == "float32"
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    from fedcrack_tpu.train import centralized as jax_centralized

    for main in (centralized.main, jax_centralized.main):
        with pytest.raises(SystemExit):
            main(["--config", c5])

    tiny = dict(json.load(open(c5)), local_epochs=1)
    tiny["model"] = dict(tiny["model"], **{k: list(v) if isinstance(v, tuple) else v for k, v in TINY_KW.items()})
    tiny["data"] = dict(tiny["data"], img_size=32, batch_size=4)
    path = tmp_path / "c5_tiny.json"
    path.write_text(json.dumps(tiny))
    cfg, _ = server.build_config(["--config", str(path)])
    jcfg, _ = jax_server.build_config(["--config", str(path)])
    imgs, msks = synth_crack_batch(8, 32, seed=5)
    train_fn, holder = make_train_fn(cfg, ArrayDataset(imgs, msks, batch_size=4, shuffle=False), 4, device="cpu")
    assert holder["state"].model.compute_dtype == torch.bfloat16
    jtrain_fn, _ = jax_make_train_fn(jcfg, JaxDataset(imgs, msks, batch_size=4, shuffle=False), 4)
    variables = jax_variables(TINY_KW, seed=2)
    blob = jser.tree_to_bytes(variables)
    got, n, metrics = train_fn(blob, 1, {})
    want, jn, jmetrics = jtrain_fn(blob, 1)
    assert n == jn == 8
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=BF16_STEP)
    g = dict(flat_tree(jser.tree_from_bytes(got)))
    w = dict(flat_tree(jser.tree_from_bytes(want)))
    start = dict(flat_tree(variables))
    for path_, value in w.items():
        if path_[0] == "params":
            bound = 2 * cfg.learning_rate * 1.0014 + float(np.spacing(np.abs(start[path_]).max() + 1e-3))
            assert np.abs(g[path_] - start[path_]).max() <= bound, path_
            assert np.abs(value - start[path_]).max() <= bound, path_
