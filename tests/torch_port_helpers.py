"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made once with numpy and handed to both packages; trees cross
from JAX to the port as numpy arrays (fp8 codes through their uint8 view,
since numpy has no e4m3 type of its own).
"""

from __future__ import annotations

import numpy as np
import torch

# The JAX kernel tests' tiny model (tests/test_kernels.py), and a
# two-encoder-block variant whose second pool runs on an odd grid when fed
# a 20 x 28 input (stem 10 x 14, pool 5 x 7, pool 3 x 4).
TINY_KW = dict(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
TWO_BLOCK_KW = dict(
    img_size=32, stem_features=4, encoder_features=(8, 8), decoder_features=(8, 8, 4)
)
SWEEP_SHAPES = [(4, 7, 5), (8, 128, 128), (33, 130, 129), (1, 256, 3), (16, 9, 17)]


def jax_leaf(flavor: str, w: np.ndarray):
    """(codes, scales) of ``w`` from the JAX package's int8 or e4m3 quantizer."""
    from fedcrack_tpu.serve import quant as jq

    if flavor == "int8":
        leaf = jq.quantize_leaf(w)
        return leaf[jq.QKEY], leaf[jq.SKEY]
    leaf = jq.quantize_leaf_fp8(w)
    return leaf[jq.QKEY_FP8], leaf[jq.SKEY]


def skip_without_fp8(flavor: str) -> None:
    import pytest

    from fedcrack_tpu import jaxcompat

    if flavor == "e4m3" and not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")


def jax_variables(kw: dict, seed: int = 0) -> dict:
    """The JAX package's ``init_variables`` as a plain dict of numpy arrays."""
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.models.resunet import init_variables

    return to_numpy_tree(init_variables(jax.random.key(seed), ModelConfig(**kw)))


def to_numpy_tree(node):
    if hasattr(node, "items"):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return np.asarray(node)


def to_torch_tree(node):
    """numpy (incl. ml_dtypes fp8) tree -> tensor tree."""
    if isinstance(node, dict):
        return {k: to_torch_tree(v) for k, v in node.items()}
    arr = np.asarray(node)
    if arr.dtype.itemsize == 1 and arr.dtype.kind in ("V", "f"):
        return torch.from_numpy(arr.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(arr.copy())


def code_bytes(node) -> np.ndarray:
    """The raw bytes of a 1-byte code array or tensor, as uint8."""
    if isinstance(node, torch.Tensor):
        return node.view(torch.uint8).numpy()
    return np.asarray(node).view(np.uint8)


def port_config(kw: dict):
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**kw)


def jax_config(kw: dict):
    from fedcrack_tpu.configs import ModelConfig

    return ModelConfig(**kw)


# ---- trained trees (tests/test_torch_train.py, tests/test_torch_fed.py) ----

LR = 1e-3


def bn_fed_bias(path: tuple) -> bool:
    """A flax path to the bias of a conv that feeds a train-mode BatchNorm
    (``stem_conv``, every ``pointwise``, every ``convT1``/``convT2``): the
    batch mean subtracts it again, so its true gradient is exactly 0."""
    if path[-1] != "bias" or path[0] != "params":
        return False
    module = path[1:-1]
    return (module[0] == "stem_conv" or module[-1] == "pointwise"
            or module[0].endswith("_convT1") or module[0].endswith("_convT2"))


def flat_tree(tree, path=()):
    """(path, numpy leaf) pairs of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_tree(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


def assert_trained_trees_close(got, want, start, steps, atol=1e-5):
    """Two packages' trees after ``steps`` Adam steps from ``start``, held
    by the rules stated in tests/test_torch_train.py."""
    g, w, s = dict(flat_tree(got)), dict(flat_tree(want)), dict(flat_tree(start))
    assert set(g) == set(w) == set(s)
    for path in w:
        name = "/".join(path)
        if bn_fed_bias(path):
            bound = steps * LR * (1 + 1e-5)
            assert np.abs(g[path] - s[path]).max() <= bound, name
            assert np.abs(w[path] - s[path]).max() <= bound, name
        elif path[0] == "batch_stats" and path[-1] == "mean":
            np.testing.assert_allclose(g[path], w[path], rtol=0, atol=1e-5 + 0.02 * steps * LR, err_msg=name)
        else:
            np.testing.assert_allclose(g[path], w[path], rtol=0, atol=atol, err_msg=name)


def perturbed_variables(kw: dict, seed: int = 0, perturb_seed: int = 7) -> dict:
    """``jax_variables(kw, seed)`` with every bias (conv and BatchNorm), BN
    scale, running mean and running variance replaced by seeded numpy
    values, so that no bias is 0, no mean 0, no variance or scale 1:
    biases and means N(0, 0.3), scales N(1, 0.4), variances U(0.3, 2).
    The kernels keep their seeded init."""
    rng = np.random.default_rng(perturb_seed)
    draw = {"bias": lambda n: rng.normal(0.0, 0.3, n), "mean": lambda n: rng.normal(0.0, 0.3, n),
            "scale": lambda n: rng.normal(1.0, 0.4, n), "var": lambda n: rng.uniform(0.3, 2.0, n)}

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (draw[k](v.shape).astype(np.float32) if k in draw else v) for k, v in node.items()}

    return walk(jax_variables(kw, seed))
