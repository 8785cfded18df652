"""The fused epilogue of ``dequant_matmul`` and ``dequant_conv3x3``
(``kernels.dequant.Epilogue``) and the fused forward that routes every
conv's bias, BatchNorm, ReLU and residual add through it.

On the CPU the wrappers take their plain versions, so what is held here is
the plain epilogue's arithmetic and the forward's routing:

- the plain epilogue equals, bit for bit, the launch without it followed by
  the torch ops it stands for, in their order, once for each mix the
  forward launches, on ragged N, on inputs holding -0.0 and NaN, and with
  ``relu_input`` on -0.0;
- on trees whose biases, BN scales, means and variances are perturbed
  (``perturbed_variables``: the trees of ``init_variables`` have every
  bias and mean 0 and every variance and scale 1, which would hide a
  missing step), the fused forward equals bit for bit the forward before
  the epilogues, kept here over the epilogue-free entry points
  (``_unfused_forward``), and JAX's ``fused_predict_logits(impl=
  "interpret")`` within atol 1e-4 on the logits (float reassociation of the
  sums, as tests/test_torch_forward.py);
- wrong vectors, residuals, mixes and plans are refused.

On the card chip_smoke.py's phase 3 holds each kernel's fused launch bit
for bit against the kernel followed by the same torch ops.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (TINY_KW, TWO_BLOCK_KW, jax_config, perturbed_variables, port_config,
                                skip_without_fp8, to_torch_tree)

pytestmark = pytest.mark.torch_port

CASES = [(TINY_KW, (2, 32, 32, 3)), (TWO_BLOCK_KW, (2, 20, 28, 3))]
IDS = ["tiny_32", "two_block_odd_grid"]
PLANES = {"int8": "fused_int8", "e4m3": "fp8"}
# The mixes of the forward's GEMM launches, each after the conv's bias:
# (BatchNorm, ReLU, residual); the head's is the bias alone.
MATMUL_MIXES = {"bias": (False, False, False), "bias_bn": (True, False, False),
                "bias_bn_relu": (True, True, False), "bias_residual": (False, False, True)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit: NaN payloads and the sign of zero included."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _codes(rng, flavor: str, shape) -> tuple[torch.Tensor, torch.Tensor]:
    from fedcrack_tpu_torch.serve import quant as tq

    w = rng.normal(0.0, 0.2, shape).astype(np.float32)
    leaf = tq.quantize_leaf(w) if flavor == "int8" else tq.quantize_leaf_fp8(w)
    return leaf[tq.QKEY if flavor == "int8" else tq.QKEY_FP8], leaf[tq.SKEY]


def _epilogue(rng, n: int, bn: bool, relu: bool):
    from fedcrack_tpu_torch.kernels import dequant

    def vec(std, mean=0.0):
        return torch.from_numpy(rng.normal(mean, std, n).astype(np.float32))

    vectors = None
    if bn:
        var = torch.from_numpy(rng.uniform(0.3, 2.0, n).astype(np.float32))
        vectors = (vec(0.3), vec(0.4, 1.0) * torch.rsqrt(var + 1e-3), vec(0.3))
    return dequant.Epilogue(bias=vec(0.3), bn=vectors, relu=relu)


def _torch_ops(y: torch.Tensor, epilogue, residual) -> torch.Tensor:
    """The epilogue's steps written out as the forward wrote them before
    they were fused: ``y + bias``; ``(y - mean) * inv + beta``;
    ``torch.relu``; ``residual + y``."""
    y = y + epilogue.bias
    if epilogue.bn is not None:
        mean, inv, beta = epilogue.bn
        y = (y - mean) * inv + beta
    if epilogue.relu:
        y = torch.relu(y)
    return y if residual is None else residual + y


# ---- the plain epilogue against the torch ops ----


@pytest.mark.parametrize("mix", list(MATMUL_MIXES))
def test_matmul_epilogue_is_the_torch_ops_bitwise(mix):
    """Each mix of the forward's GEMMs on a ragged N (odd, past one column
    block), with -0.0 rows and NaN in x and the residual."""
    from fedcrack_tpu_torch.kernels import dequant

    bn, relu, residual = MATMUL_MIXES[mix]
    rng = np.random.default_rng(len(mix))
    m, k, n = 37, 27, 33
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    x[0] = -0.0
    x[3, 5] = float("nan")
    q, s = _codes(rng, "int8", (k, n))
    epi = _epilogue(rng, n, bn, relu)
    r = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) if residual else None
    if r is not None:
        r[1] = -0.0
        r[2, 0] = float("nan")
    got = dequant.dequant_matmul(x, q, s, epilogue=epi, residual=r)
    want = _torch_ops(dequant.dequant_matmul(x, q, s), epi, r)
    assert _same_bits(got, want)
    assert torch.isnan(got[3]).all() and not torch.isnan(got[4:]).any()


def test_epilogue_relu_maps_negative_zero_as_torch_relu():
    """A BatchNorm that leaves -0.0 before the ReLU (bias -0.0, mean 0, inv
    -1, beta -0.0 over a zero row): the epilogue's ReLU gives torch.relu's
    bits."""
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(4)
    x = torch.zeros((4, 8))
    q, s = _codes(rng, "int8", (8, 5))
    bias, bn = -torch.zeros(5), (torch.zeros(5), -torch.ones(5), -torch.zeros(5))
    before = dequant.dequant_matmul(x, q, s, epilogue=dequant.Epilogue(bias=bias, bn=bn))
    assert torch.signbit(before).all()  # -0.0 everywhere
    got = dequant.dequant_matmul(x, q, s, epilogue=dequant.Epilogue(bias=bias, bn=bn, relu=True))
    assert _same_bits(got, torch.relu(before))


@pytest.mark.parametrize("relu", [False, True], ids=["bias_bn", "bias_bn_relu"])
def test_conv_epilogue_is_the_torch_ops_bitwise(relu):
    """Each mix of the forward's decoder convs on F = 17 (odd, past a
    column block), with and without ``relu_input``, on -0.0 and NaN."""
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(10 + relu)
    f = 17
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, 8)).astype(np.float32))
    x[0, 0] = -0.0
    x[1, 2, 3, 4] = float("nan")
    q, s = _codes(rng, "e4m3" if relu else "int8", (3, 3, 8, f))
    epi = _epilogue(rng, f, True, relu)
    for relu_input in (False, True):
        got = dequant.dequant_conv3x3(x, q, s, epilogue=epi, relu_input=relu_input)
        want = _torch_ops(dequant.dequant_conv3x3(torch.relu(x) if relu_input else x, q, s), epi, None)
        assert _same_bits(got, want)


def test_conv_relu_input_on_negative_zero_and_nan():
    """``relu_input`` convolves ``torch.relu(x)``: an input holding -0.0,
    negatives and NaN gives the bits of the conv of ``torch.relu(x)``; and
    with no epilogue at all."""
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 6, 6, 4)).astype(np.float32))
    x[0, :, :, :2] = -0.0
    x[1, 3, 3, 1] = float("nan")
    q, s = _codes(rng, "int8", (3, 3, 4, 9))
    got = dequant.dequant_conv3x3(x, q, s, relu_input=True)
    assert _same_bits(got, dequant.dequant_conv3x3(torch.relu(x), q, s))
    assert torch.isnan(got[1, 2:5, 2:5]).all() and not torch.isnan(got[0]).any()
    clean = x.clone()
    clean[1, 3, 3, 1] = 0.0
    positive = torch.where(clean == 0, torch.zeros_like(clean), clean)  # -0.0 -> +0.0
    assert _same_bits(dequant.dequant_conv3x3(clean, q, s, relu_input=True),
                      dequant.dequant_conv3x3(positive, q, s, relu_input=True))


# ---- refusals ----


def test_epilogue_refuses_bad_vectors_and_mixes():
    """Every epilogue has the conv's bias; a ReLU comes only after a
    BatchNorm (the forward's mixes)."""
    from fedcrack_tpu_torch.kernels import dequant

    with pytest.raises(TypeError):
        dequant.Epilogue()  # no bias
    with pytest.raises(TypeError):
        dequant.Epilogue(bias=None, bn=(torch.zeros(4), torch.ones(4), torch.zeros(4)))
    with pytest.raises(ValueError):
        dequant.Epilogue(bias=torch.zeros(4), relu=True)  # a ReLU without a BatchNorm
    with pytest.raises(TypeError):
        dequant.Epilogue(bias=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError):
        dequant.Epilogue(bias=torch.zeros(2, 2))
    with pytest.raises(TypeError):
        dequant.Epilogue(bias=np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        dequant.Epilogue(bias=torch.zeros(4), bn=(torch.zeros(4), torch.ones(4)))
    with pytest.raises(ValueError):
        dequant.Epilogue(bias=torch.zeros(4), bn=(torch.zeros(4), torch.ones(5), torch.zeros(4)))
    with pytest.raises(ValueError):
        dequant.Epilogue(bias=torch.zeros(8)[::2])  # not contiguous


def test_launches_refuse_epilogues_and_residuals_that_do_not_fit():
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(6)
    x = torch.zeros((6, 8))
    q, s = _codes(rng, "int8", (8, 5))
    bias = dequant.Epilogue(bias=torch.zeros(5))
    with pytest.raises(ValueError):
        dequant.dequant_matmul(x, q, s, epilogue=dequant.Epilogue(bias=torch.zeros(4)))
    with pytest.raises(TypeError):
        dequant.dequant_matmul(x, q, s, epilogue=torch.zeros(5))
    with pytest.raises(ValueError):
        dequant.dequant_matmul(x, q, s, residual=torch.zeros((6, 5)))  # a residual without the bias
    with pytest.raises(ValueError):
        dequant.dequant_matmul(x, q, s, epilogue=_epilogue(rng, 5, True, False), residual=torch.zeros((6, 5)))
    with pytest.raises(ValueError):
        dequant.dequant_matmul(x, q, s, epilogue=bias, residual=torch.zeros((6, 4)))
    with pytest.raises(TypeError):
        dequant.dequant_matmul(x, q, s, epilogue=bias, residual=torch.zeros((6, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        dequant.dequant_matmul(x, q, s, epilogue=bias, residual=torch.zeros((5, 6)).t())
    xc = torch.zeros((1, 4, 4, 8))
    qc, sc = _codes(rng, "int8", (3, 3, 8, 5))
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(xc, qc, sc, epilogue=_epilogue(rng, 6, True, False))
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(xc, qc, sc, epilogue=bias)  # the conv's epilogue has a BatchNorm


# ---- the fused forward on perturbed trees ----


def _perturbed_qtree(kw: dict, flavor: str):
    from fedcrack_tpu.serve import quant as jq

    return jq.quantize_for_plane(perturbed_variables(kw, seed=2), PLANES[flavor]).tree


def _unfused_forward(qtree: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The fused forward as it ran before the epilogues: each launch
    without one, then the bias, BatchNorm, ReLU and residual as torch ops
    (``inv`` recomputed per BatchNorm)."""
    from fedcrack_tpu_torch.kernels.dequant import dequant_conv3x3, dequant_dwconv3x3, dequant_matmul, im2col3x3
    from fedcrack_tpu_torch.kernels.forward import _codes
    from fedcrack_tpu_torch.models.resunet import BN_EPSILON, upsample2x
    from fedcrack_tpu_torch.ops.pooling import max_pool_auto

    def bn(x, p, s):
        inv = p["scale"] * torch.rsqrt(s["var"] + BN_EPSILON)
        return (x - s["mean"]) * inv + p["bias"]

    def conv1x1(x, mod):
        q, s = _codes(mod["kernel"])
        n, h, w, c = x.shape
        y = dequant_matmul(x.reshape(n * h * w, c).contiguous(), q.reshape(c, -1), s)
        return y.reshape(n, h, w, -1) + mod["bias"]

    def conv3x3(x, mod, stride):
        q, s = _codes(mod["kernel"])
        if stride == 1:
            return dequant_conv3x3(x.contiguous(), q, s) + mod["bias"]
        c, f = q.shape[2], q.shape[3]
        rows, ho, wo = im2col3x3(x, stride)
        y = dequant_matmul(rows, q.permute(2, 0, 1, 3).reshape(c * 9, f).contiguous(), s)
        return y.reshape(x.shape[0], ho, wo, f) + mod["bias"]

    def sepconv(x, mod):
        return conv1x1(dequant_dwconv3x3(x.contiguous(), *_codes(mod["depthwise"]["kernel"])), mod["pointwise"])

    p, st = qtree["params"], qtree["batch_stats"]
    x = torch.relu(bn(conv3x3(x, p["stem_conv"], 2), p["stem_bn"], st["stem_bn"]))
    prev = x
    for i in range(len(cfg.encoder_features)):
        x = bn(sepconv(x, p[f"enc{i}_sep1"]), p[f"enc{i}_bn1"], st[f"enc{i}_bn1"])
        x = bn(sepconv(x, p[f"enc{i}_sep2"]), p[f"enc{i}_bn2"], st[f"enc{i}_bn2"])
        x = max_pool_auto(x)
        x = x + conv1x1(prev[:, ::2, ::2, :], p[f"enc{i}_res"])
        prev = x
    for i in range(len(cfg.decoder_features)):
        x = torch.relu(x)
        x = torch.relu(bn(conv3x3(x, p[f"dec{i}_convT1"], 1), p[f"dec{i}_bn1"], st[f"dec{i}_bn1"]))
        x = bn(conv3x3(x, p[f"dec{i}_convT2"], 1), p[f"dec{i}_bn2"], st[f"dec{i}_bn2"])
        x = x + conv1x1(prev, p[f"dec{i}_res"])
        if i + 1 < len(cfg.decoder_features):
            x = upsample2x(x)
            prev = x
    return upsample2x(conv1x1(x, p["head"]))


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_fused_forward_equals_the_unfused_forward_bitwise(kw, shape, flavor):
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits

    skip_without_fp8(flavor)
    tree, cfg = to_torch_tree(_perturbed_qtree(kw, flavor)), port_config(kw)
    x = torch.from_numpy(np.random.default_rng(21).uniform(0, 1, shape).astype(np.float32))
    got = fused_predict_logits(tree, x, cfg, depthwise_group(tree, cfg), epilogue_plan(tree, cfg))
    want = _unfused_forward(tree, x, cfg)
    assert _same_bits(got, want)
    assert float(want.abs().max()) > 0.1  # the perturbed tree gives logits far from 0


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_fused_forward_matches_jax_interpret_on_perturbed_trees(kw, shape, flavor):
    from fedcrack_tpu.kernels.forward import fused_predict_logits as jax_fused
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits

    skip_without_fp8(flavor)
    qtree = _perturbed_qtree(kw, flavor)
    x = np.random.default_rng(22).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax_fused(qtree, x, jax_config(kw), impl="interpret"))
    tree, cfg = to_torch_tree(qtree), port_config(kw)
    got = fused_predict_logits(tree, torch.from_numpy(x), cfg, depthwise_group(tree, cfg),
                               epilogue_plan(tree, cfg)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_epilogue_plan_holds_the_forwards_steps():
    """One epilogue a fused launch: every conv's bias; the BatchNorm after
    the stem, the encoder's pointwise convs and the decoder convs, with
    ``inv`` bitwise the per-forward ``scale * rsqrt(var + eps)``; a ReLU
    after the stem and each decoder block's first conv."""
    from fedcrack_tpu_torch.kernels.forward import bn_inv, epilogue_plan

    tree, cfg = to_torch_tree(_perturbed_qtree(TWO_BLOCK_KW, "int8")), port_config(TWO_BLOCK_KW)
    plan = epilogue_plan(tree, cfg)
    p, st = tree["params"], tree["batch_stats"]
    enc, dec = len(cfg.encoder_features), len(cfg.decoder_features)
    assert len(plan.epilogues) == 1 + 3 * enc + 3 * dec + 1
    with_bn = {"stem_conv": "stem_bn"}
    with_bn.update({f"enc{i}_sep{j}.pointwise": f"enc{i}_bn{j}" for i in range(enc) for j in (1, 2)})
    with_bn.update({f"dec{i}_convT{j}": f"dec{i}_bn{j}" for i in range(dec) for j in (1, 2)})
    for name, epi in plan.epilogues.items():
        mod = p
        for key in name.split("."):
            mod = mod[key]
        assert epi.bias is mod["bias"]
        assert epi.relu == (name == "stem_conv" or name.endswith("_convT1"))
        if name in with_bn:
            bn = with_bn[name]
            mean, inv, beta = epi.bn
            assert mean is st[bn]["mean"] and beta is p[bn]["bias"]
            assert _same_bits(inv, p[bn]["scale"] * torch.rsqrt(st[bn]["var"] + 1e-3))
            assert _same_bits(inv, bn_inv(p[bn], st[bn]))
        else:
            assert epi.bn is None


def test_fused_forward_refuses_an_epilogue_plan_of_another_tree():
    """The plan must hold the tree's own bias and BatchNorm tensors: a plan
    of another tree, of another config, or of a tree whose BatchNorm leaf
    was replaced after the plan was built is refused before any launch; so
    is an object that is no plan."""
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits
    from fedcrack_tpu_torch.serve import quant as tq

    cfg, x = port_config(TINY_KW), torch.zeros(1, 32, 32, 3)
    tree = tq.quantize_variables(perturbed_variables(TINY_KW, seed=2)).tree
    other = tq.quantize_variables(perturbed_variables(TINY_KW, seed=3)).tree
    group = depthwise_group(tree, cfg)
    with pytest.raises(ValueError):
        fused_predict_logits(tree, x, cfg, group, epilogue_plan(other, cfg))
    with pytest.raises(TypeError):
        fused_predict_logits(tree, x, cfg, group, {"stem_conv": None})
    two = tq.quantize_variables(perturbed_variables(TWO_BLOCK_KW, seed=2)).tree
    with pytest.raises(ValueError):
        fused_predict_logits(tree, x, cfg, group, epilogue_plan(two, port_config(TWO_BLOCK_KW)))
    plan = epilogue_plan(tree, cfg)
    tree["batch_stats"]["dec0_bn1"]["var"] = tree["batch_stats"]["dec0_bn1"]["var"].clone()
    with pytest.raises(ValueError):
        fused_predict_logits(tree, x, cfg, group, plan)
    assert fused_predict_logits(tree, x, cfg, group, epilogue_plan(tree, cfg)).shape == (1, 32, 32, 1)


@pytest.mark.parametrize("plane", ["reference", "fused_int8"])
def test_engine_builds_the_epilogue_plan_once_per_placed_tree(plane):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.data.pipeline import normalize_images
    from fedcrack_tpu_torch.kernels.forward import EpiloguePlan
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    cfg = port_config(TINY_KW)
    engine = InferenceEngine(cfg, ServeConfig(quant="int8", kernel_plane=plane, bucket_sizes=(32,), max_batch=1,
                                              tile_overlap=4), device="cpu")
    payload = engine.prepare_quantized(tq.quantize_for_plane(perturbed_variables(TINY_KW), plane))
    if plane == "reference":
        assert payload.epilogues is None
        return
    assert isinstance(payload.epilogues, EpiloguePlan)
    assert payload.epilogues.belongs_to(payload.tree, engine.bucket_model_config)
    images = np.random.default_rng(8).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    probs = engine.predict_bucket(payload, images)
    want = torch.sigmoid(_unfused_forward(payload.tree, normalize_images(torch.from_numpy(images)), cfg))
    assert probs.shape == (1, 32, 32, 1) and np.array_equal(probs, want.numpy())


def test_epilogue_table_holds_the_vectors_padded():
    """The kernels' table: the rows bias, mean, inv and beta of the
    epilogue's ``n`` columns, zero past ``n`` and, without a BatchNorm, in
    the last three rows; rows of a multiple of 128 columns."""
    from fedcrack_tpu_torch.kernels import dequant

    vectors = [torch.arange(5, dtype=torch.float32) + i + 1 for i in range(4)]
    table = dequant.epilogue_table(5, vectors[0], tuple(vectors[1:]))
    assert table.shape == (4, dequant.EPILOGUE_TABLE_COLUMNS) and table.is_contiguous()
    for row, want in enumerate(vectors):
        assert torch.equal(table[row, :5], want)
    assert not table[:, 5:].any()
    bias_only = dequant.epilogue_table(130, torch.ones(130))
    assert bias_only.shape == (4, 256) and bias_only[0, :130].eq(1).all()
    assert not bias_only[0, 130:].any() and not bias_only[1:].any()


def test_every_tile_plan_has_room_for_its_epilogue():
    """The conv stages its epilogue's vectors and scales past the plan's
    shared memory, and a GEMM with a residual puts its barriers there:
    every conv plan that fits a block (each pixel tile, column block and
    ring depth) and every GEMM plan of the forward at buckets 128 to 512
    has that room, so no forward launch is refused for it."""
    import chip_smoke
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.kernels import dequant

    limit = 232_448
    for tw in (8, 16):
        for bn in (16, 32, 64):
            for stages in range(1, 5):
                smem = dequant.conv_smem_bytes(8, tw, bn, stages)
                assert smem > limit or smem + dequant.conv_epilogue_smem(bn) <= limit
    cfg = ModelConfig()
    for size in (128, 256, 512):
        for batch in (1, 8):
            for layer, m, k, n in chip_smoke.matmul_shapes(cfg, size, batch):
                plan = dequant.matmul_tile_plan(m, k, n)
                assert plan.smem + dequant.MATMUL_RESIDUAL_SMEM <= limit, (layer, size, batch)
