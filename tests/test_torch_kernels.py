"""The port's dequant kernels (fedcrack_tpu_torch/kernels/dequant.py) held
against the JAX package's Pallas kernels, run as the JAX tests run them on
the CPU (``impl="interpret"``: the Pallas interpreter over the same kernel
body). On the CPU the port's wrappers take their plain PyTorch versions;
the CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py.

Tolerances: the fused matmul is the JAX bound, per entry within one
per-channel scale + 1e-6 (the two sides sum the K terms in different
orders and apply the scale before vs after the sum); the code expansion is
one float multiply per entry on both sides, atol 1e-7 as in JAX and in
fact bitwise.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import SWEEP_SHAPES, code_bytes, jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=[str(s) for s in SWEEP_SHAPES])
def test_dequant_matmul_matches_jax_interpret(shape, flavor):
    from fedcrack_tpu.kernels.dequant import dequant_matmul as jax_dequant_matmul
    from fedcrack_tpu_torch.kernels.dequant import dequant_matmul

    skip_without_fp8(flavor)
    m, k, n = shape
    rng = np.random.default_rng(sum(shape) * 7 + len(flavor))
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    q, scale = jax_leaf(flavor, w)
    want = np.asarray(jax_dequant_matmul(x, q, scale, impl="interpret"))
    got = dequant_matmul(torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert np.all(np.abs(got.numpy() - want) <= scale[None, :] + 1e-6)


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
def test_dequant_codes_matches_jax_interpret(flavor):
    from fedcrack_tpu.kernels.dequant import dequant_codes as jax_dequant_codes
    from fedcrack_tpu_torch.kernels.dequant import dequant_codes

    skip_without_fp8(flavor)
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.1, (3, 3, 1, 130)).astype(np.float32)
    q, scale = jax_leaf(flavor, w)
    want = np.asarray(jax_dequant_codes(q, scale, impl="interpret"))
    got = dequant_codes(to_torch_tree(q), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got, want)


def test_fp8_codes_cross_as_the_same_bytes():
    """The uint8 view carries e4m3 codes between ml_dtypes and torch."""
    from fedcrack_tpu import jaxcompat

    if not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")
    w = np.linspace(-0.3, 0.3, 64, dtype=np.float32).reshape(8, 8)
    q, _ = jax_leaf("e4m3", w)
    t = to_torch_tree(q)
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(code_bytes(t), code_bytes(q))
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(q, np.float32))


def test_dequant_wrappers_validate():
    from fedcrack_tpu_torch.kernels.dequant import dequant_codes, dequant_matmul

    x = torch.zeros(4, 8)
    q = torch.zeros(8, 3, dtype=torch.int8)
    s = torch.ones(3)
    with pytest.raises(ValueError):
        dequant_matmul(x, q, torch.ones(4))  # scale != N
    with pytest.raises(ValueError):
        dequant_matmul(x, torch.zeros(7, 3, dtype=torch.int8), s)  # K mismatch
    with pytest.raises(ValueError):
        dequant_matmul(x[0], q, s)  # not 2-D
    with pytest.raises(TypeError):
        dequant_matmul(x, q.to(torch.int32), s)  # not a code dtype
    with pytest.raises(TypeError):
        dequant_matmul(x.double(), q, s)
    with pytest.raises(ValueError):
        dequant_matmul(torch.zeros(8, 4).t(), q, s)  # not contiguous
    with pytest.raises(ValueError):
        dequant_matmul(x, q, torch.ones(3, device="meta"))  # device mismatch
    with pytest.raises(ValueError):
        dequant_codes(q, torch.ones(4))
    with pytest.raises(TypeError):
        dequant_codes(q.to(torch.uint8), s)
    with pytest.raises(TypeError):
        dequant_codes(q, s.double())
    with pytest.raises(ValueError):
        dequant_codes(torch.zeros(3, 8, dtype=torch.int8).t(), s)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    from fedcrack_tpu_torch.kernels import dequant

    dequant.reset_launch_counts()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (6, 4)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 4).astype(np.float32))
    np.testing.assert_array_equal(
        dequant.dequant_matmul(x, q, s).numpy(), dequant._dequant_matmul_plain(x, q, s).numpy()
    )
    np.testing.assert_array_equal(
        dequant.dequant_codes(q, s).numpy(), dequant._dequant_codes_plain(q, s).numpy()
    )
    assert dequant.dequant_matmul.launches == 0
    assert dequant.dequant_codes.launches == 0
