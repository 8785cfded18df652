"""The port's quantizer and quant gate (fedcrack_tpu_torch/serve/quant.py)
held against the JAX package's: codes and scales bit-equal (fp8 codes
compared through their uint8 views), the probe batch byte-equal, mask_iou
equal on its edge cases. All exact.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, code_bytes, jax_variables

pytestmark = pytest.mark.torch_port


def _pairs(jtree, ttree, path=()):
    """(path, jax leaf, port leaf) over two trees of the same structure."""
    assert set(jtree) == set(ttree), path
    for k in jtree:
        if isinstance(jtree[k], dict):
            yield from _pairs(jtree[k], ttree[k], path + (k,))
        else:
            yield path + (k,), jtree[k], ttree[k]


def _assert_same_quantized(jtree, ttree):
    n_codes = 0
    for path, a, b in _pairs(jtree, ttree):
        a = np.asarray(a)
        assert isinstance(b, torch.Tensor), path
        if path[-1] in ("int8_code", "fp8_code"):
            n_codes += 1
            assert tuple(b.shape) == a.shape, path
            np.testing.assert_array_equal(code_bytes(b), code_bytes(a), err_msg=str(path))
        else:
            assert b.numpy().dtype == a.dtype, path
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
    return n_codes


# Edge values: half-way ties of int8 rounding (+-0.5, 1.5, 2.5 at scale 1),
# e4m3 round-to-nearest-even ties, its top binade next to +-448, and
# e4m3 subnormals (below 2**-6 after scaling).
_EDGE = np.array(
    [[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
     [448.0, 440.0, 444.0, 447.9, -436.0, 2.0**-7, 2.0**-9 * 3, -(2.0**-10)],
     [1.0, 1.0625, 1.125, 17.0, 19.0, -33.0, 0.0, 1e-30]],
    np.float32,
).T.copy()  # channels last: 3 output channels of 8 values


@pytest.mark.parametrize("which", ["init_tree", "edges"])
def test_int8_codes_bit_equal_to_jax(which):
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.serve import quant as tq

    if which == "init_tree":
        variables = jax_variables(TINY_KW)
        n = _assert_same_quantized(jq.quantize_variables(variables).tree,
                                   tq.quantize_variables(variables).tree)
        assert n == 13
    else:
        for w in (_EDGE, _EDGE * np.float32(0.01), np.zeros((4, 3), np.float32)):
            _assert_same_quantized(jq.quantize_leaf(w), tq.quantize_leaf(w))


@pytest.mark.parametrize("which", ["init_tree", "edges"])
def test_fp8_codes_bit_equal_to_jax(which):
    from fedcrack_tpu import jaxcompat
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.serve import quant as tq

    if not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")
    if which == "init_tree":
        variables = jax_variables(TINY_KW)
        n = _assert_same_quantized(jq.quantize_variables_fp8(variables).tree,
                                   tq.quantize_variables_fp8(variables).tree)
        assert n == 13
    else:
        rng = np.random.default_rng(5)
        wide = (rng.standard_normal((64, 16)) * np.exp(rng.uniform(-12, 2, (64, 16)))).astype(
            np.float32
        )
        for w in (_EDGE, _EDGE * np.float32(3e-3), wide, np.zeros((4, 3), np.float32)):
            _assert_same_quantized(jq.quantize_leaf_fp8(w), tq.quantize_leaf_fp8(w))


def test_quantize_for_plane_and_dequantize_match_jax():
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.serve import quant as tq

    variables = jax_variables(TINY_KW)
    for plane in ("reference", "fused_int8", "fp8"):
        jt = jq.dequantize_variables(jq.quantize_for_plane(variables, plane).tree)
        tt = tq.dequantize_variables(tq.quantize_for_plane(variables, plane).tree)
        for path, a, b in _pairs(jt, tt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.float32), err_msg=str(path))
    with pytest.raises(ValueError):
        tq.quantize_for_plane(variables, "bf4")


def test_quantized_bytes_matches_jax_on_int8():
    """Both packages count the same totals, on int8 trees and on fp8 trees
    (where the int8-only 4-byte reference rule gives fp8 codes their own
    itemsize)."""
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.serve import quant as tq

    variables = jax_variables(TINY_KW)
    want = jq.quantized_bytes(jq.quantize_variables(variables).tree)
    assert tq.quantized_bytes(tq.quantize_variables(variables).tree) == want
    want_fp8 = jq.quantized_bytes(jq.quantize_variables_fp8(variables).tree)
    assert tq.quantized_bytes(tq.quantize_variables_fp8(variables).tree) == want_fp8
    assert want_fp8[0] == want[0]  # fp8 codes are one byte per weight too


@pytest.mark.parametrize("size,n,seed", [(32, 4, 0), (48, 3, 7)])
def test_probe_images_byte_equal(size, n, seed):
    from fedcrack_tpu.data.synthetic import synth_crack_batch as jax_synth
    from fedcrack_tpu.serve.quant import probe_images as jax_probe
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.serve.quant import probe_images

    got, want = probe_images(size, n, seed), jax_probe(size, n, seed)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    for a, b in zip(synth_crack_batch(n, size, seed, min_thickness=2),
                    jax_synth(n, size, seed, min_thickness=2)):
        assert a.tobytes() == b.tobytes()


def test_mask_iou_edge_cases_match_jax():
    from fedcrack_tpu.serve.quant import mask_iou as jax_iou
    from fedcrack_tpu_torch.serve.quant import mask_iou

    z = np.zeros((2, 4, 4, 1), np.float32)
    o = np.ones_like(z)
    half = z.copy()
    half[:, :2] = 0.9
    at_threshold = np.full_like(z, 0.5)  # > 0.5 is strict: empty mask
    cases = [(z, z), (o, o), (z, o), (half, o), (at_threshold, z), (half, at_threshold)]
    for a, b in cases:
        assert mask_iou(a, b) == jax_iou(a, b)
    assert mask_iou(z, z) == 1.0 and mask_iou(z, o) == 0.0 and mask_iou(half, o) == 0.5
    assert mask_iou(half, o, threshold=0.95) == jax_iou(half, o, threshold=0.95) == 0.0


def test_fake_quant_activations_matches_jax():
    from fedcrack_tpu.serve.quant import fake_quant_activations as jax_fq
    from fedcrack_tpu_torch.serve.quant import fake_quant_activations

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 8, 1)) * 3).astype(np.float32)
    np.testing.assert_array_equal(fake_quant_activations(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_fq(x)))
    zeros = np.zeros((3,), np.float32)
    np.testing.assert_array_equal(fake_quant_activations(torch.from_numpy(zeros)).numpy(), zeros)


def test_gate_result_json_matches_jax():
    from fedcrack_tpu.serve.quant import QuantGateResult as JaxResult
    from fedcrack_tpu_torch.serve.quant import QuantGateResult

    kw = dict(passed=False, iou=0.9712345678, floor=0.98,
              per_bucket={128: 0.99, 256: 0.9712345678}, probe_batch=4, probe_seed=0)
    assert QuantGateResult(**kw).to_json() == JaxResult(**kw).to_json()
