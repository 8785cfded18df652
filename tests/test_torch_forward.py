"""The port's fused quantized forward (fedcrack_tpu_torch/kernels/forward.py)
held against the JAX package's ``fused_predict_logits(impl="interpret")``
on the same quantized tree (int8, and e4m3 where this jax build has fp8),
and against the port's own reference program over the dequantized tree.

Tolerance: atol 1e-4 on the logits. Both sides contract the same codes in
float32 but in different orders (im2col matmul order, scale applied after
the sum in the Pallas kernel, before it in the port's plain version).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, TWO_BLOCK_KW, jax_config, jax_variables, port_config, to_torch_tree

pytestmark = pytest.mark.torch_port

CASES = [(TINY_KW, (2, 32, 32, 3)), (TWO_BLOCK_KW, (2, 20, 28, 3))]
IDS = ["tiny_32", "two_block_odd_grid"]


def _quantized(kw, plane):
    from fedcrack_tpu.serve import quant as jq

    return jq.quantize_for_plane(jax_variables(kw, seed=2), plane).tree


@pytest.mark.parametrize("plane", ["fused_int8", "fp8"])
@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_fused_forward_matches_jax_interpret(kw, shape, plane):
    from fedcrack_tpu import jaxcompat
    from fedcrack_tpu.kernels.forward import fused_predict_logits as jax_fused
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits

    if plane == "fp8" and not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")
    qtree = _quantized(kw, plane)
    x = np.random.default_rng(12).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax_fused(qtree, x, jax_config(kw), impl="interpret"))
    tree, cfg = to_torch_tree(qtree), port_config(kw)
    got = fused_predict_logits(tree, torch.from_numpy(x), cfg, depthwise_group(tree, cfg),
                               epilogue_plan(tree, cfg)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_fused_forward_matches_port_reference_program(kw, shape):
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.serve import quant as tq

    qtree = tq.quantize_variables(jax_variables(kw, seed=2)).tree
    x = torch.from_numpy(np.random.default_rng(13).uniform(0, 1, shape).astype(np.float32))
    model = from_flax_variables(tq.dequantize_variables(qtree), ResUNet(port_config(kw), device="cpu"))
    with torch.no_grad():
        want = model(x).numpy()
    cfg = port_config(kw)
    got = fused_predict_logits(qtree, x, cfg, depthwise_group(qtree, cfg), epilogue_plan(qtree, cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("plane", ["fused_int8", "fp8"])
@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_grouped_expansion_matches_leaf_by_leaf_bitwise(kw, shape, plane, monkeypatch):
    """The forward, whose depthwise stages expand their codes inside
    dequant_dwconv3x3, equals bitwise the forward whose depthwise stage is
    relu -> F.pad -> the nine shifted taps of the kernels expanded by one
    dequant_codes_group call on the same group."""
    import torch.nn.functional as F

    from fedcrack_tpu import jaxcompat
    from fedcrack_tpu_torch.kernels import dequant, forward

    if plane == "fp8" and not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")
    qtree, cfg = to_torch_tree(_quantized(kw, plane)), port_config(kw)
    x = torch.from_numpy(np.random.default_rng(16).uniform(0, 1, shape).astype(np.float32))
    group, plan = forward.depthwise_group(qtree, cfg), forward.epilogue_plan(qtree, cfg)
    fused = forward.fused_predict_logits(qtree, x, cfg, group, plan)
    expanded = {id(q): kern for (q, _), kern in zip(group.leaves, dequant.dequant_codes_group(group))}
    stages = []

    def expanded_stage(x, q, scale):
        n, h, w, c = x.shape
        taps = expanded[id(q)].reshape(9, c)
        xp = F.pad(torch.relu(x), (0, 0, 1, 1, 1, 1))
        acc = xp[:, :h, :w] * taps[0]
        for t in range(1, 9):
            dy, dx = divmod(t, 3)
            acc = acc + xp[:, dy:dy + h, dx:dx + w] * taps[t]
        stages.append(id(q))
        return acc.contiguous()

    monkeypatch.setattr(forward, "dequant_dwconv3x3", expanded_stage)
    reference = forward.fused_predict_logits(qtree, x, cfg, group, plan)
    assert stages == [id(q) for q, _ in group.leaves]
    assert torch.equal(fused, reference)


def test_im2col_patch_order_matches_jax_on_a_non_square_kernel():
    """F.unfold orders patch channels (C, kh, kw), as
    lax.conv_general_dilated_patches does; a 2 x 3 window tells kh from kw."""
    from jax import lax

    x = np.random.default_rng(14).normal(size=(1, 5, 6, 3)).astype(np.float32)
    want = np.asarray(
        lax.conv_general_dilated_patches(x, (2, 3), (1, 1), "VALID",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
    )
    got = torch.nn.functional.unfold(torch.from_numpy(x).permute(0, 3, 1, 2), kernel_size=(2, 3))
    got = got.transpose(1, 2).reshape(1, 4, 4, 3 * 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_conv3x3_stride2_matches_jax_on_odd_grid():
    from fedcrack_tpu.kernels.forward import _conv3x3 as jax_conv3x3
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.kernels.dequant import Epilogue
    from fedcrack_tpu_torch.kernels.forward import _conv3x3

    rng = np.random.default_rng(15)
    mod = {"kernel": jq.quantize_leaf(rng.normal(0, 0.2, (3, 3, 3, 5)).astype(np.float32)),
           "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    for shape in ((1, 7, 9, 3), (2, 8, 6, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jax_conv3x3(x, mod, stride=2, impl="reference"))
        tmod = to_torch_tree(mod)
        got = _conv3x3(torch.from_numpy(x), tmod, stride=2, epilogue=Epilogue(bias=tmod["bias"])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fused_forward_counts_no_launch_on_cpu_and_refuses_layouts():
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits
    from fedcrack_tpu_torch.serve import quant as tq

    qtree, cfg = tq.quantize_variables(jax_variables(TINY_KW)).tree, port_config(TINY_KW)
    group, plan = depthwise_group(qtree, cfg), epilogue_plan(qtree, cfg)
    dequant.reset_launch_counts()
    fused_predict_logits(qtree, torch.zeros(1, 32, 32, 3), cfg, group, plan)
    assert dequant.dequant_matmul.launches == 0 and dequant.dequant_codes.launches == 0
    assert dequant.dequant_dwconv3x3.launches == 0
    with pytest.raises(ValueError):
        fused_predict_logits(qtree, torch.zeros(1, 32, 32, 3),
                             ModelConfig(**TINY_KW, res_layout="packed"), group, plan)
    with pytest.raises(TypeError):
        fused_predict_logits(tq.dequantize_variables(qtree), torch.zeros(1, 32, 32, 3), cfg, group, plan)


def test_fused_forward_refuses_a_depthwise_group_of_another_tree():
    """The prepared group must hold the tree's own depthwise code tensors:
    a missing group, another tree's group, or a tree whose depthwise leaf
    was replaced after the group was built is refused before any launch."""
    from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan, fused_predict_logits
    from fedcrack_tpu_torch.serve import quant as tq

    cfg, x = port_config(TINY_KW), torch.zeros(1, 32, 32, 3)
    qtree = tq.quantize_variables(jax_variables(TINY_KW, seed=2)).tree
    other = tq.quantize_variables(jax_variables(TINY_KW, seed=3)).tree
    plan = epilogue_plan(qtree, cfg)
    with pytest.raises(TypeError):
        fused_predict_logits(qtree, x, cfg, None, plan)
    with pytest.raises(ValueError):
        fused_predict_logits(qtree, x, cfg, depthwise_group(other, cfg), plan)
    group = depthwise_group(qtree, cfg)
    leaf = qtree["params"]["enc0_sep2"]["depthwise"]["kernel"]
    leaf[tq.QKEY] = leaf[tq.QKEY].clone()
    with pytest.raises(ValueError):
        fused_predict_logits(qtree, x, cfg, group, plan)
    assert fused_predict_logits(qtree, x, cfg, depthwise_group(qtree, cfg), plan).shape == (1, 32, 32, 1)
