"""The port's max-pool gradient (fedcrack_tpu_torch/ops/pooling.py) held
against ``jax.grad`` of the JAX package's ``max_pool_auto``.

``max_pool_auto`` takes its scatter-free custom VJP on grids up to 64 and
XLA's SelectAndScatter above (a 256 px input's first pool runs on a 128
grid); both send each output's cotangent to the first row-major maximum of
its window, and the port's one backward does the same. The gradients are
held bitwise: per input cell both sides add the same cotangents in the
same (window-offset) order. NaN windows run on the custom path only, where
the JAX package pins its rule (a NaN maximum routes to the first valid
offset; pad cells never claim).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


def _jax_grad(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.ops.pooling import max_pool_auto

    return np.asarray(jax.grad(lambda v: jnp.sum(max_pool_auto(v) * g))(x))


def _port_grad(x: np.ndarray, g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    from fedcrack_tpu_torch.ops.pooling import max_pool_auto

    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = max_pool_auto(xt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.numpy()


def _cotangent(rng, x: np.ndarray) -> np.ndarray:
    from fedcrack_tpu_torch.ops.pooling import same_pads

    n, h, w, c = x.shape
    ho, wo = same_pads(h, 3, 2)[0], same_pads(w, 3, 2)[0]
    return rng.normal(size=(n, ho, wo, c)).astype(np.float32)


@pytest.mark.parametrize(
    "shape", [(2, 8, 8, 3), (1, 16, 16, 2), (2, 5, 7, 3), (1, 10, 14, 2), (1, 1, 1, 1), (1, 64, 64, 2)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_random_input_gradient_bitwise(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = _cotangent(rng, x)
    _, got = _port_grad(x, g)
    np.testing.assert_array_equal(got, _jax_grad(x, g))


@pytest.mark.parametrize("shape", [(1, 8, 8, 2), (2, 5, 7, 1)], ids=["even", "odd"])
def test_constant_input_all_ties_go_to_first_maximum(shape):
    rng = np.random.default_rng(7)
    x = np.full(shape, 0.25, np.float32)
    g = _cotangent(rng, x)
    _, got = _port_grad(x, g)
    np.testing.assert_array_equal(got, _jax_grad(x, g))
    # Each window's first cell is (2i - lo, 2j - lo) clamped into the grid:
    # on an even grid (lo = 0) exactly the even-even cells receive.
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        mask = np.zeros(shape, bool)
        mask[:, ::2, ::2] = True
        assert not got[~mask].any()
        np.testing.assert_array_equal(got[mask].reshape(g.shape), g)


def test_nan_window_routes_gradient_to_first_valid_offset():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 6, 6, 2)).astype(np.float32)
    x[0, 0, 0, 0] = np.nan  # first window's first cell (lo = 0)
    x[0, 3, 4, 1] = np.nan  # interior, shared by overlapping windows
    x[0, 5, 5, 0] = np.nan  # last row/column: its windows hold a pad cell
    g = _cotangent(rng, x)
    out, got = _port_grad(x, g)
    want = _jax_grad(x, g)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(out).any()
    assert np.isfinite(got).all() and got.sum() == pytest.approx(g.sum(), rel=1e-5)


def test_builtin_max_pool_backward_is_not_this_rule():
    """``F.max_pool2d`` lets a NaN take its window: its gradient lands on
    the NaN cell, where JAX's rule sends it to the window's first valid
    cell. The port must not use it."""
    import torch.nn.functional as F

    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 1, 1, 0] = np.nan
    g = np.ones((1, 2, 2, 1), np.float32)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    F.max_pool2d(F.pad(xt.permute(0, 3, 1, 2), (0, 1, 0, 1), value=float("-inf")), 3, 2).sum().backward()
    _, port = _port_grad(x, g)
    want = _jax_grad(x, g)
    np.testing.assert_array_equal(port, want)
    assert not np.array_equal(xt.grad.numpy(), want)


def test_128_grid_with_ties_matches_select_and_scatter():
    """The first pool of a 256 px input: JAX takes XLA's SelectAndScatter
    there; values drawn from {0, 1, 2} put ties in most windows.

    SelectAndScatter adds the cotangents arriving at one input cell in its
    own order, so the sums may differ in the last bit: the routing is held
    exactly (positive cotangents, so a cell receives iff its support
    matches), the values within 2e-6, a few float32 ulps of a sum of up
    to four cotangents below 2."""
    from fedcrack_tpu.ops.pooling import _CUSTOM_MAX_GRID

    assert _CUSTOM_MAX_GRID < 128  # the JAX side really is SelectAndScatter
    rng = np.random.default_rng(13)
    x = rng.integers(0, 3, size=(2, 128, 128, 2)).astype(np.float32)
    g = rng.uniform(0.1, 0.5, size=_cotangent(rng, x).shape).astype(np.float32)
    _, got = _port_grad(x, g)
    want = _jax_grad(x, g)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
