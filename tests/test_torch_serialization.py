"""The port's msgpack weight blob (fed/serialization.py) held against the
JAX package's ``fedcrack_tpu.fed.serialization`` (flax's msgpack).

The contract is exact: the port's ``tree_to_bytes`` writes the same bytes
as the JAX package for the same tree (float32 and the bfloat16 wire cast,
whose round-to-nearest-even must agree on ties and subnormals), decodes
JAX-written blobs bitwise, and gives ``validate_update``'s reason strings
word for word. A weight tree carries across in both directions.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port


def _bits(leaf):
    """A decoded leaf's raw bytes (a bfloat16 tensor through its int16 view)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _tie_and_subnormal_values():
    """float32 values on bfloat16 rounding ties (even and odd lower
    halves), just off them, and float32 subnormals."""
    one = np.float32(1.0)
    step = np.float32(2.0**-7)       # bfloat16 spacing at 1.0
    half = np.float32(2.0**-8)       # a tie at 1.0
    return np.array([
        one + half, one + step + half, one + half + np.float32(2.0**-20),
        -(one + 3 * half), np.float32(1e-40), np.float32(-3e-39),
        np.float32(1.1754942e-38), np.float32(65504.0), np.float32(0.0), np.float32(-0.0),
    ], np.float32)


def _mixed_tree():
    """Unsorted insertion order, a 0-d leaf, a numpy scalar, empty and
    one-element arrays, other dtypes, lengths around every msgpack header
    boundary, and plain Python values."""
    rng = np.random.default_rng(0)
    return {
        "zeta": rng.normal(size=(3, 4)).astype(np.float32),
        "alpha": {
            "scalar0d": np.array(3.0, np.float32),
            "npscalar": np.float32(2.5),
            "ints": np.arange(300, dtype=np.int64),
            "int8": np.arange(-4, 4, dtype=np.int8),
            "bool": np.array([True, False]),
        },
        "ties": _tie_and_subnormal_values(),
        "empty": np.zeros((0, 3), np.float32),
        "one": np.ones((1,), np.float32),
        "big": rng.normal(size=(70_000,)).astype(np.float32),
        "lengths": {f"k{i:02d}": np.ones((i,), np.float32) for i in (0, 1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65)},
        "python": [1, -40, 70_000, -70_000, 2.5, "s" * 40, None, True, b"xx"],
    }


def _small_trees():
    rng = np.random.default_rng(1)
    return {
        "flat": {"b": rng.normal(size=(4,)).astype(np.float32), "a": rng.normal(size=(2, 2)).astype(np.float32)},
        "ties": {"w": _tie_and_subnormal_values(), "v": np.array(1.00390625, np.float32)},
        "many_keys": {str(i): rng.normal(size=(i % 5 + 1,)).astype(np.float32) for i in range(40)},
        "nested": {"params": {"dec": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                                      "bias": np.zeros(4, np.float32)}},
                   "batch_stats": {"bn": {"var": np.ones(4, np.float32), "mean": np.zeros(4, np.float32)}}},
    }


@pytest.mark.parametrize("cast", [None, "bfloat16"])
@pytest.mark.parametrize("name", sorted(_small_trees()))
def test_small_trees_byte_identical(name, cast):
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    tree = _small_trees()[name]
    want = jser.tree_to_bytes(tree, cast_dtype=cast)
    assert tser.tree_to_bytes(tree, cast_dtype=cast) == want
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert tser.tree_to_bytes(as_tensors, cast_dtype=cast) == want


@pytest.mark.parametrize("cast", [None, "bfloat16", "float16"])
def test_mixed_tree_byte_identical_and_decodes_bitwise(cast):
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    tree = _mixed_tree()
    if cast is not None:
        tree.pop("python")  # the JAX cast is np.asarray(leaf).astype(dtype) on every leaf
    blob = jser.tree_to_bytes(tree, cast_dtype=cast)
    assert tser.tree_to_bytes(tree, cast_dtype=cast) == blob
    want = jax.tree_util.tree_leaves(jser.tree_from_bytes(blob))
    got = tree_leaves(tser.tree_from_bytes(blob))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert tuple(g.shape) == w.shape
            assert _bits(g) == _bits(w)
            if w.dtype.name == "bfloat16":
                assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            else:
                assert g.dtype == w.dtype
        else:
            assert type(g) is type(w) and g == w


@pytest.mark.parametrize("cast", [None, "bfloat16"])
def test_full_width_model_variables_byte_identical(cast):
    """``ModelConfig()``: 112 leaves, 2,058,145 values, about 8.23 MB as
    float32 and half that on a bfloat16 wire."""
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.models.resunet import init_variables

    variables = init_variables(torch.Generator().manual_seed(0), ModelConfig())
    leaves = tree_leaves(variables)
    assert len(leaves) == 112 and sum(leaf.size for leaf in leaves) == 2_058_145
    blob = tser.tree_to_bytes(variables, cast_dtype=cast)
    assert blob == jser.tree_to_bytes(variables, cast_dtype=cast)
    assert len(blob) == pytest.approx(2_058_145 * (2 if cast else 4), rel=0.01)
    restored = tser.tree_from_bytes(blob, template=variables)
    for got, want in zip(tree_leaves(restored), leaves):
        assert got.dtype == np.float32
        if cast is None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cast", [None, "bfloat16"])
def test_jax_blob_decodes_bitwise_with_template(cast):
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    tree = jax_variables(TINY_KW, seed=3)
    tree["params"]["stem_conv"]["bias"] = _tie_and_subnormal_values()[:4].copy()
    template = jax_variables(TINY_KW, seed=4)
    template["params"]["stem_conv"]["bias"] = np.zeros(4, np.float32)
    blob = jser.tree_to_bytes(tree, cast_dtype=cast)
    want = jser.tree_from_bytes(blob, template=template)
    got = tser.tree_from_bytes(blob, template=template)
    assert set(got) == set(want)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_template_restore_refuses_a_leaf_count_mismatch():
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    t = _small_trees()["flat"]
    blob = jser.tree_to_bytes({"only": t["b"]})
    with pytest.raises(ValueError, match="leaves"):
        jser.tree_from_bytes(blob, template=t)
    with pytest.raises(ValueError, match="leaves"):
        tser.tree_from_bytes(blob, template=t)


def _gate_cases():
    rng = np.random.default_rng(5)
    template = {"layer": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
                "bias": rng.normal(size=(4,)).astype(np.float32)}
    good = {"layer": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
            "bias": rng.normal(size=(4,)).astype(np.float32)}
    nan = {"layer": {"kernel": good["layer"]["kernel"].copy()}, "bias": good["bias"].copy()}
    nan["layer"]["kernel"][1, 2] = np.nan
    inf = {"layer": good["layer"], "bias": np.full(4, np.inf, np.float32)}
    transposed = {"layer": {"kernel": good["layer"]["kernel"].T.copy()}, "bias": good["bias"]}
    return template, {
        "clean": ("tree", good, None),
        "clean_bf16": ("tree", good, "bfloat16"),
        "truncated": ("truncated", good, None),
        "garbage": ("raw", b"\x00\xff garbage", None),
        "trailing_byte": ("trailing", good, None),
        "reserved_byte": ("raw", b"\xc1", None),
        "empty": ("raw", b"", None),
        "int_map_key": ("raw", b"\x81\x01\x02", None),
        "bad_utf8": ("raw", b"\xa2\xff\xfe", None),
        "leaf_count": ("tree", {"bias": good["bias"]}, None),
        "transposed": ("tree", transposed, None),
        "nan": ("tree", nan, None),
        "inf_bf16": ("tree", inf, "bfloat16"),
        "non_numeric": ("tree", {"layer": {"kernel": "x" * 12}, "bias": good["bias"]}, None),
    }


@pytest.mark.parametrize("case", sorted(_gate_cases()[1]))
def test_validate_update_gives_jax_reason_strings(case):
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    template, cases = _gate_cases()
    kind, value, cast = cases[case]
    if kind == "raw":
        blob = value
    else:
        blob = jser.tree_to_bytes(value, cast_dtype=cast)
        if kind == "truncated":
            blob = blob[: len(blob) // 2]
        elif kind == "trailing":
            blob = blob + b"\x00"
    want = jser.validate_update(blob, template)
    assert tser.validate_update(blob, template) == want
    if case.startswith("clean"):
        assert want is None
    else:
        assert want is not None


@pytest.mark.parametrize("cut", [1, 2, 5, 9, 30, 100])
def test_every_truncation_is_undecodable_as_in_jax(cut):
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    template, cases = _gate_cases()
    blob = jser.tree_to_bytes(cases["clean"][1])[:cut]
    want = jser.validate_update(blob, template)
    assert want.startswith("undecodable payload")
    assert tser.validate_update(blob, template) == want


def test_leaf_over_the_chunk_limit_is_refused(monkeypatch):
    """A leaf over the chunk limit is not refused but written in flax's
    chunked form; one at the limit stays a single ext."""
    import flax.serialization

    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    at = {"w": np.arange(16, dtype=np.float32)}   # 64 bytes: at the limit
    over = {"w": np.arange(17, dtype=np.float32)}
    assert b"__msgpack_chunked_array__" not in tser.tree_to_bytes(at)
    assert tser.tree_to_bytes(at) == jser.tree_to_bytes(at)
    blob = tser.tree_to_bytes(over)
    assert b"__msgpack_chunked_array__" in blob and blob == jser.tree_to_bytes(over)
    assert tser.tree_from_bytes(blob)["w"].tobytes() == over["w"].tobytes()


def _chunk_tree():
    rng = np.random.default_rng(5)
    return {
        "params": {"conv": {"kernel": rng.normal(size=(3, 3, 2, 5)).astype(np.float32),
                            "bias": rng.normal(size=(5,)).astype(np.float32)},
                   "big": {"w": rng.normal(size=(37, 11)).astype(np.float32)}},
        "batch_stats": {"mean": rng.normal(size=(40,)).astype(np.float32)},
        "step": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
    }


@pytest.mark.parametrize("limit", [2, 40, 100, 4096])
@pytest.mark.parametrize("cast", [None, "bfloat16"])
def test_chunked_leaves_byte_equal_and_restore_across_packages(monkeypatch, limit, cast):
    """With both packages' MAX_CHUNK_SIZE patched down, the blobs are
    byte-equal, and each package's blob restores through the other on the
    raw and on the template path, bitwise."""
    import flax.serialization

    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", limit)
    tree = _chunk_tree()
    want = jser.tree_to_bytes(tree, cast_dtype=cast)
    got = tser.tree_to_bytes(tree, cast_dtype=cast)
    assert got == want
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves(tser.tree_from_bytes(want)), leaves(jser.tree_from_bytes(got))):
        assert _bits(a) == np.asarray(b).tobytes()
    for a, b in zip(leaves(tser.tree_from_bytes(want, template=tree)),
                    leaves(jser.tree_from_bytes(got, template=tree))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tser.validate_update(want, tree) is None


def test_unserializable_leaves_raise_like_flax():
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser

    for tree in ({"t": (1, 2)}, {"o": object()}):
        with pytest.raises(TypeError):
            jser.tree_to_bytes(tree)
        with pytest.raises(TypeError):
            tser.tree_to_bytes(tree)


def test_weights_carry_from_jax_into_the_port_train_state():
    """A blob written by the JAX package loads into the port's train state
    through ``tree_from_bytes(template=...)``, bit for bit."""
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.train import local as tl

    jax_tree = jax_variables(TINY_KW, seed=7)
    state = tl.create_train_state(torch.Generator().manual_seed(1), port_config(TINY_KW), device="cpu")
    state.replace_variables(tser.tree_from_bytes(jser.tree_to_bytes(jax_tree), template=state.variables))
    carried = state.variables
    for got, want in zip(tree_leaves(carried), jax.tree_util.tree_leaves(jax_tree)):
        assert got.tobytes() == np.asarray(want).tobytes()
    assert tser.tree_to_bytes(carried) == jser.tree_to_bytes(jax_tree)


def test_weights_carry_from_the_port_into_the_jax_train_state():
    from fedcrack_tpu.fed import serialization as jser
    from fedcrack_tpu.train import local as jl
    from fedcrack_tpu_torch.fed import serialization as tser
    from fedcrack_tpu_torch.models.resunet import init_variables

    port_tree = init_variables(torch.Generator().manual_seed(8), port_config(TINY_KW))
    jstate = jl.create_train_state(jax.random.key(0), jax_config(TINY_KW), 1e-3)
    template = jax.device_get(jstate.variables)
    jstate = jstate.replace_variables(jser.tree_from_bytes(tser.tree_to_bytes(port_tree), template=template))
    carried = jax.device_get(jstate.variables)
    assert jser.tree_to_bytes(carried) == tser.tree_to_bytes(port_tree)
