"""SegFormer on the port (``models/segformer.py``), on the CPU at a small
size of the published topology: widths 16 / 32 / 40 / 64, heads 1 / 2 / 5 /
8, depths 1 / 1 / 2 / 1, spatial reductions 8 / 4 / 2 / 1, head 32, 64 px
crops, batch 2.

The model is held to the plain float32 reference the benchmark uses
(``benchmark/reference/segformer.py`` and ``fed_segformer.py``), written
from the published description and sharing no code with the port, on
seeded random weights drawn into one flax-layout tree and handed to both
(``benchmark/inputs/segformer_weights.py``). Each tolerance sits between
the port's gap and the gap of the same reference computed in TF32 (the
operands of every conv and product rounded to 10 mantissa bits), which
must fail it.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.torch_port

SMALL = dict(img_size=64, embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 5, 8), depths=(1, 1, 2, 1),
             sr_ratios=(8, 4, 2, 1), decoder_dim=32)
BATCH = 2
B5_PARAMS, B5_TENSORS = 84_594_113, 1_065
# Forward logits, against the largest reference logit: float32 sums taken
# in other orders (cuDNN / oneDNN convolutions, the separable resize
# against F.interpolate) read ~3e-7; TF32 operands read ~5e-4.
FORWARD_RTOL = 1e-5
# Each leaf's gradient, the norm of the difference against the larger of
# the reference leaf's norm and the median leaf's: ~2e-4 in float32 at
# worst (the head's linear_c biases, whose gradient is rounding alone: the
# batch-statistics BatchNorm removes what they add), ~8e-2 in TF32.
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    from fedcrack_tpu_torch.configs import SegFormerConfig

    return SegFormerConfig(**{**SMALL, **kw})


def _tree(seed: int = 5, cfg=None):
    from benchmark.inputs.segformer_weights import draw_variables

    return draw_variables(seed, dataclasses.asdict(cfg or _cfg()), "cpu")


def _model(tree, cfg=None):
    from fedcrack_tpu_torch.models import build_model
    from fedcrack_tpu_torch.models.convert import from_flax_variables

    return from_flax_variables(tree, build_model(cfg or _cfg(), device="cpu"))


def _batch(seed: int = 3, size: int = 64):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(BATCH, size, size, 3, generator=g)
    masks = (torch.rand(BATCH, size, size, 1, generator=g) < 0.2).to(torch.float32)
    return images, masks


def _ref_forward(tree, images, train: bool, tf32: bool = False):
    from benchmark.reference import segformer as ref

    return ref.forward(tree, images, SMALL["num_heads"], train=train, tf32=tf32)


def _flax_path(name: str) -> tuple:
    *mods, leaf = name.split(".")
    root = "batch_stats" if leaf in ("mean", "var") else "params"
    return (root,) + tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


def test_module_order_is_the_reference_tree_order():
    """The port's parameters and statistics, named in flax's layout, come
    in the reference's leaf order with its shapes: the benchmark reads the
    port's optimizer state in this order."""
    from benchmark.inputs.segformer_weights import leaf_specs

    from fedcrack_tpu_torch.models import build_model
    from fedcrack_tpu_torch.models.convert import weight_to_kernel

    model = build_model(_cfg(), device="meta")
    got = [(_flax_path(n), tuple(weight_to_kernel(t).shape if n.endswith("weight") else t.shape))
           for n, t in list(model.named_parameters()) + list(model.named_buffers())]
    assert got == [(path, shape) for path, shape, _ in leaf_specs(dataclasses.asdict(_cfg()))]


def test_b5_parameter_count():
    """SegFormer-B5 with the one-logit crack head: 84,594,113 values in
    1,065 parameter tensors (the paper's 84.7 M less the 150-class
    classifier), and the head's two running statistics."""
    from fedcrack_tpu_torch.configs import SegFormerConfig
    from fedcrack_tpu_torch.models import build_model

    model = build_model(SegFormerConfig(), device="meta")
    params = list(model.parameters())
    assert (sum(p.numel() for p in params), len(params)) == (B5_PARAMS, B5_TENSORS)
    assert [n for n, _ in model.named_buffers()] == ["head.bn.mean", "head.bn.var"]
    assert sum(1 for n in dict(model.named_modules()) if n.startswith("block") and n.count(".") == 0) == 52


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_reference(train):
    images, _ = _batch()
    tree = _tree()
    model = _model(tree).train(train)
    with torch.no_grad():
        got = model(images)
        want, stats = _ref_forward(tree, images, train)
        control, _ = _ref_forward(tree, images, train, tf32=True)
    assert got.shape == (BATCH, 64, 64, 1) and got.is_contiguous()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= FORWARD_RTOL * scale
    assert float((control - want).abs().max()) > FORWARD_RTOL * scale
    if train:
        # The running statistics: PyTorch's momentum 0.1, the unbiased variance.
        for k in ("mean", "var"):
            torch.testing.assert_close(getattr(model.head.bn, k), stats["head"]["bn"][k], rtol=1e-5, atol=1e-6)


def _grad_gaps(tree, images, masks, tf32: bool) -> dict:
    from benchmark.reference.fed import _leaves, _tree

    from fedcrack_tpu_torch.models.convert import weight_to_kernel

    model = _model(tree).train()
    F.binary_cross_entropy_with_logits(model(images), masks).backward()
    named = dict(model.named_parameters())
    params = [(p, v.detach().clone().requires_grad_(True)) for p, v in _leaves(tree["params"])]
    logits, _ = _ref_forward({"params": _tree(params), "batch_stats": tree["batch_stats"]}, images, True, tf32)
    F.binary_cross_entropy_with_logits(logits, masks).backward()
    median = float(np.median([float(v.grad.norm()) for _, v in params]))
    gaps = {}
    for path, v in params:
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        got = named[name].grad
        got = weight_to_kernel(got) if path[-1] == "kernel" else got
        gaps[path] = float((got - v.grad).norm()) / max(float(v.grad.norm()), median)
    return gaps


def test_every_leaf_gradient_matches_reference():
    images, masks = _batch()
    tree = _tree()
    gaps = _grad_gaps(tree, images, masks, tf32=False)
    assert len(gaps) == 133
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_RTOL, worst
    assert max(_grad_gaps(tree, images, masks, tf32=True).values()) > GRAD_RTOL


def _fed_config(**kw):
    from fedcrack_tpu_torch.configs import FedConfig

    raw = {"model_type": "segformer", "mesh_clients": 2, "local_epochs": 1, "learning_rate": 6e-5,
           "model": {**SMALL}, "data": {"img_size": 64, "batch_size": BATCH}}
    raw.update(kw)
    return FedConfig.from_dict(raw)


def _round_data(clients: int = 2, steps: int = 2):
    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import stack_client_data

    per = [to_uint8_transport(*synth_crack_batch(steps * BATCH, img_size=64, seed=40 + c)) for c in range(clients)]
    images, masks = stack_client_data(per, steps, BATCH)
    return images, masks, np.ones(clients, np.float32), np.full(clients, float(steps * BATCH), np.float32)


def test_fedavg_round_through_round_from_config_matches_reference():
    """One round of 2 clients x 2 steps through ``round_from_config`` with
    ``model_type: "segformer"`` against ``fed_segformer.fedavg_round``: the
    clients' losses, and each leaf's change of the global. Adam's first
    step moves a weight by the learning rate whatever its gradient's size,
    so a change is compared as a norm, against the larger of the leaf's
    and the median leaf's (the benchmark's ``change<n>_gap``): ~3e-4 here
    in float32, ~2e-2 in TF32. As there, leaves whose reference gradient
    is under a thousandth of the median leaf's are left out: the head's
    ``linear_c*`` biases and ``norm4``'s bias shift a channel of the fused
    map by a constant that the batch-statistics BatchNorm removes, so
    their gradient is rounding, which Adam's step amplifies to the
    learning rate."""
    from benchmark.reference import fed_segformer
    from benchmark.reference.fed import _leaves

    from fedcrack_tpu_torch.parallel import round_from_config

    cfg = _fed_config()
    _, round_fn = round_from_config(cfg, device="cpu")
    tree = _tree()
    images, masks, active, n_samples = _round_data()
    new, metrics = round_fn(tree, images, masks, active, n_samples)

    def changes(after):
        out = {}
        for path, v in _leaves(tree):
            a = after
            for k in path:
                a = a[k]
            out[path] = float((a.to(torch.float64) - v.to(torch.float64)).norm())
        return out

    def gap(got, want):
        med = float(np.median(list(want.values())))
        return max(abs(got[p] - want[p]) / max(want[p], med) for p in want)

    sides = {}
    for tf32 in (False, True):
        ref, losses, grads = fed_segformer.fedavg_round(tree, torch.from_numpy(images), torch.from_numpy(masks),
                                                        n_samples, cfg.learning_rate, SMALL["num_heads"], tf32=tf32)
        sides[tf32] = (changes(ref), np.mean(losses, axis=1), grads[0])
    first = {p: float(g.norm()) for p, g in sides[False][2].items()}
    floor = 1e-3 * float(np.median(list(first.values())))
    untrained = {("params",) + p for p, n in first.items() if n < floor}
    assert {("params", "head", f"linear_c{i}", "bias") for i in (1, 2, 3, 4)} | {("params", "norm4", "bias")} \
        <= untrained
    got = changes(new)
    want = {p: v for p, v in sides[False][0].items() if p not in untrained}
    control = {p: v for p, v in sides[True][0].items() if p not in untrained}
    np.testing.assert_allclose(metrics["loss"].numpy(), sides[False][1], rtol=1e-5)
    assert gap(got, want) <= 2e-3
    assert gap(control, want) > 2e-3


def test_convert_round_trip():
    """A flax-layout tree into the port's model and back, bit for bit:
    conv kernels HWIO, Linear kernels ``[in, out]``, LayerNorm and
    BatchNorm scales and biases, the running statistics."""
    from benchmark.reference.fed import _leaves

    from fedcrack_tpu_torch.models.convert import to_flax_variables

    tree = _tree()
    model = _model(tree)
    assert tuple(model.block1_0.attn.kv.weight.shape) == (32, 16)
    assert torch.equal(model.block1_0.attn.kv.weight, tree["params"]["block1_0"]["attn"]["kv"]["kernel"].t())
    back = to_flax_variables(model)
    want = _leaves(tree)
    got = dict(_leaves(back))
    assert set(got) == {p for p, _ in want}
    for path, v in want:
        assert np.array_equal(got[path], v.numpy()), path


def test_config_routes_by_model_type():
    from fedcrack_tpu_torch.configs import FedConfig, ModelConfig, SegFormerConfig

    cfg = _fed_config()
    assert isinstance(cfg.model, SegFormerConfig) and cfg.model.depths == (1, 1, 2, 1)
    assert FedConfig.from_json(cfg.to_json()) == cfg
    assert isinstance(FedConfig.from_dict({"model": {"img_size": 64}, "data": {"img_size": 64}}).model, ModelConfig)
    with pytest.raises(ValueError, match="segformer"):
        FedConfig(model_type="segformer")
    with pytest.raises(ValueError, match="segformer"):
        FedConfig(model=SegFormerConfig(), data=FedConfig().data.__class__(img_size=1024))


def _refused(kind: str):
    from fedcrack_tpu_torch.parallel import build_federated_round, make_mesh
    from fedcrack_tpu_torch.parallel.fedavg_mesh import build_federated_round_segments, build_spatial_federated_round

    mesh = make_mesh(2, device="cpu")
    cfg = _cfg()
    if kind == "dp":
        return build_federated_round(mesh, cfg, dp_clip_norm=1.0)
    if kind == "remat":
        return build_federated_round(mesh, cfg, remat=True)
    if kind == "lowp":
        return build_federated_round(mesh, cfg, lowp="fake_quant_int8")
    if kind == "fedprox":
        return build_federated_round_segments(mesh, cfg, fedprox_mu=0.01)
    if kind == "spatial":
        return build_spatial_federated_round(make_mesh(2, 2, axis_names=("clients", "space"), device="cpu"), cfg)
    if kind == "s2d":
        return _fed_config(model={**SMALL, "stem_layout": "s2d"})
    if kind == "packed":
        return _fed_config(model={**SMALL, "res_layout": "packed"})
    if kind == "serving":
        from fedcrack_tpu_torch.serve.engine import InferenceEngine

        return InferenceEngine(cfg, device="cpu")
    if kind == "client_fit":
        from fedcrack_tpu_torch.train.federated import make_train_fn

        return make_train_fn(_fed_config(), [], BATCH, device="cpu")
    if kind == "centralized":
        from fedcrack_tpu_torch.train.centralized import train_centralized

        return train_centralized([], [], cfg, epochs=1, device="cpu")
    if kind == "resunet":
        from fedcrack_tpu_torch.models import ResUNet

        return ResUNet(cfg, device="cpu")
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["dp", "remat", "lowp", "fedprox", "spatial", "s2d", "packed", "serving",
                                  "client_fit", "centralized", "resunet"])
def test_refusals_name_segformer(kind):
    with pytest.raises((ValueError, TypeError), match="segformer"):
        _refused(kind)


def test_get_model_builds_segformer():
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models import SegFormer, get_model

    model = get_model("SegFormer", _cfg(), device="cpu")
    assert isinstance(model, SegFormer) and model.config == _cfg()
    with pytest.raises(TypeError, match="SegFormerConfig"):
        get_model("segformer", ModelConfig(), device="cpu")
    with pytest.raises(TypeError, match="SegFormerConfig"):
        get_model("resunet", _cfg(), device="cpu")


@pytest.mark.parametrize("which", ["small", "b5"])
def test_flops_equal_flop_counter(which):
    """``obs.flops.segformer_forward_flops`` equals
    ``torch.utils.flop_counter.FlopCounterMode`` on the forward (the small
    model run on the CPU, B5 at 1024 px on the meta device), and the
    benchmark's frozen copy equals it."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.counts.segformer_flops import segformer_forward_flops as frozen
    from benchmark.counts.segformer_flops import segformer_train_step_flops as frozen_step

    from fedcrack_tpu_torch.configs import SegFormerConfig
    from fedcrack_tpu_torch.models import build_model
    from fedcrack_tpu_torch.obs.flops import segformer_forward_flops, segformer_train_step_flops

    cfg = _cfg() if which == "small" else SegFormerConfig()
    device = "cpu" if which == "small" else "meta"
    model = build_model(cfg, device=device).train()
    with FlopCounterMode(display=False) as counter:
        model(torch.zeros(BATCH, cfg.img_size, cfg.img_size, 3, device=device))
    assert counter.get_total_flops() == segformer_forward_flops(cfg, BATCH)
    model_block = dataclasses.asdict(cfg)
    assert frozen(model_block, cfg.img_size, BATCH) == segformer_forward_flops(cfg, BATCH)
    assert frozen_step(model_block, cfg.img_size, BATCH) == segformer_train_step_flops(cfg, BATCH)
    if which == "b5":
        assert round(segformer_forward_flops(cfg, 1) / 1e12, 3) == 1.120


def test_upsample_is_bilinear():
    """The separable resize against ``F.interpolate(mode="bilinear",
    align_corners=False)`` at the factors the model uses."""
    from fedcrack_tpu_torch.models.segformer import upsample

    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    for factor in (2, 4, 8):
        want = F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)
        torch.testing.assert_close(upsample(x, factor, (2, 3)), want, rtol=0, atol=1e-6)


def test_attention_counter_and_build_span():
    """``train_attention_total{stage, path}`` counts each attention call by
    stage; ``model.build`` records the model, its values and leaves; the
    train step's ``train.forward`` names the model."""
    from fedcrack_tpu_torch.models import build_model
    from fedcrack_tpu_torch.obs import spans
    from fedcrack_tpu_torch.obs.registry import REGISTRY
    from fedcrack_tpu_torch.train.local import create_train_state, train_step

    fam = REGISTRY.get("train_attention_total")
    before = {s: fam.labels(stage=s, path="composed").value for s in "1234"} if fam else dict.fromkeys("1234", 0.0)
    rec = spans.install()
    try:
        model = build_model(_cfg(), device="cpu")
        state = create_train_state(torch.Generator().manual_seed(0), _cfg(), device="cpu")
        images, masks = _batch()
        train_step(state, (images, masks), {})
    finally:
        spans.uninstall()
    fam = REGISTRY.get("train_attention_total")
    assert {s: fam.labels(stage=s, path="composed").value - before[s] for s in "1234"} == \
        {"1": 1.0, "2": 1.0, "3": 2.0, "4": 1.0}
    builds = [r for r in rec.records if r["name"] == "model.build"]
    assert [(b["model"], b["params"], b["leaves"]) for b in builds] == \
        [("segformer", sum(p.numel() for p in model.parameters()), 135)] * 2
    forward = [r for r in rec.records if r["name"] == "train.forward"]
    assert [r["model"] for r in forward] == ["segformer"]
