"""The port's grouped code expansion (``dequant_codes_group`` in
fedcrack_tpu_torch/kernels/dequant.py) held against the JAX package's
``dequant_codes(impl="interpret")``, leaf by leaf; its arena layout, its
segment table (emulated here unit by unit as the CUDA kernel walks it) and
its validation. On the CPU the wrapper takes its plain PyTorch version; the
CUDA kernel is held against that plain version on the card by
chip_smoke.py.

Tolerance: none. Both sides are one float32 multiply of an exactly
converted code per entry, so the results are bitwise equal.
"""

import ctypes
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port

CSRC = Path(__file__).resolve().parents[1] / "fedcrack_tpu_torch" / "kernels" / "csrc"


def _depthwise_shapes():
    """The six depthwise kernels of ``ModelConfig()``, in forward order."""
    from fedcrack_tpu_torch.configs import ModelConfig

    cfg, shapes, cin = ModelConfig(), [], ModelConfig().stem_features
    for f in cfg.encoder_features:
        shapes += [(3, 3, 1, cin), (3, 3, 1, f)]
        cin = f
    return shapes


# Ragged: 1 and 17 codes, 1000 x 37, 4099, and a depthwise kernel of 5
# channels (45 codes): numels that are multiples of 4 and numels that are not.
GROUPS = {"model_config_depthwise": _depthwise_shapes(),
          "ragged": [(1,), (17,), (1000, 37), (4099,), (3, 3, 1, 5)]}


def _leaves(flavor, shapes, seed):
    rng = np.random.default_rng(seed)
    return [jax_leaf(flavor, rng.normal(0, 0.1, shape).astype(np.float32)) for shape in shapes]


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
def test_group_matches_jax_interpret_leaf_by_leaf(flavor, group):
    from fedcrack_tpu.kernels.dequant import dequant_codes as jax_dequant_codes
    from fedcrack_tpu_torch.kernels.dequant import dequant_codes_group

    skip_without_fp8(flavor)
    leaves = _leaves(flavor, GROUPS[group], seed=len(group) + len(flavor))
    got = dequant_codes_group([(to_torch_tree(q), torch.from_numpy(s)) for q, s in leaves])
    assert len(got) == len(leaves)
    for (q, s), out in zip(leaves, got):
        want = np.asarray(jax_dequant_codes(q, s, impl="interpret"))
        assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
        np.testing.assert_array_equal(out.numpy(), want)


NUMELS = [[1], [0], [4, 4, 4], [1, 17, 37000, 4099, 45], [0, 5, 0, 3],
          [9 * 32, 9 * 64, 9 * 64, 9 * 128, 9 * 128, 9 * 256], list(range(1, 17))]


@pytest.mark.parametrize("numels", NUMELS, ids=[str(len(n)) + ":" + str(sum(n)) for n in NUMELS])
def test_segment_layout_aligned_disjoint_and_sized(numels):
    from fedcrack_tpu_torch.kernels.dequant import SLICE_ALIGN, segment_layout

    offsets, total = segment_layout(numels)
    assert SLICE_ALIGN * 4 == 16  # floats: 16-byte aligned slices
    assert len(offsets) == len(numels) and offsets[0] == 0
    assert all(o % SLICE_ALIGN == 0 for o in offsets)
    ends = [o + n for o, n in zip(offsets, numels)]
    assert all(end <= nxt for end, nxt in zip(ends, offsets[1:]))  # in order, disjoint
    assert ends[-1] <= total < ends[-1] + SLICE_ALIGN
    assert total == sum(-(-n // SLICE_ALIGN) * SLICE_ALIGN for n in numels)


@pytest.mark.parametrize("numels", [[], [1] * 17], ids=["empty", "17_leaves"])
def test_segment_layout_refuses(numels):
    from fedcrack_tpu_torch.kernels.dequant import segment_layout

    with pytest.raises(ValueError):
        segment_layout(numels)


def _emulate_kernel(table, arena_size):
    """The CUDA kernel's walk over ``table``, in numpy: every 4-code unit
    finds its segment by the prefix offsets and writes ``float(code) *
    scale[i % n]`` into its slice. Arena entries no unit writes stay NaN."""
    from fedcrack_tpu_torch.kernels.dequant import SLICE_ALIGN

    count = table.count
    starts = np.array(table.unit_start[: count + 1], np.int64)
    out = np.full(arena_size, np.nan, np.float32)
    written = np.zeros(arena_size, np.int64)
    units = np.arange(starts[-1])
    seg = np.searchsorted(starts[1:], units, side="right")
    for s in range(count):
        numel, n = table.numel[s], table.n[s]
        q = _bytes_at(table.q[s], numel)
        scale = _floats_at(table.scale[s], n)
        e = SLICE_ALIGN * (units[seg == s] - starts[s])
        for j in range(SLICE_ALIGN):
            i = e + j
            i = i[i < numel]
            out[table.out_offset[s] + i] = q[i].astype(np.float32) * scale[i % n]
            written[table.out_offset[s] + i] += 1
    return out, written


def _bytes_at(address, count):
    return np.frombuffer((ctypes.c_int8 * count).from_address(address), np.int8)


def _floats_at(address, count):
    return np.frombuffer((ctypes.c_float * count).from_address(address), np.float32)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_segment_table_walk_covers_each_slice_once(group):
    """The table the CUDA launch gets, walked as the kernel walks it, writes
    every entry of every slice exactly once, the plain version's value,
    and leaves the alignment padding untouched."""
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(21)
    leaves = [(torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)),
               torch.from_numpy(rng.uniform(0.001, 0.1, shape[-1]).astype(np.float32)))
              for shape in GROUPS[group]]
    grp = dequant.CodeGroup(leaves)
    table = dequant.segment_table(grp.leaves, grp.offsets)
    assert table.count == len(leaves)
    assert [table.q[i] for i in range(len(leaves))] == [q.data_ptr() for q, _ in leaves]
    out, written = _emulate_kernel(table, grp.total)
    covered = np.zeros(grp.total, bool)
    for (q, s), offset in zip(leaves, grp.offsets):
        n = q.numel()
        np.testing.assert_array_equal(out[offset:offset + n], dequant._dequant_codes_plain(q, s).numpy().ravel())
        assert (written[offset:offset + n] == 1).all()
        covered[offset:offset + n] = True
    assert (written[~covered] == 0).all() and np.isnan(out[~covered]).all()


def test_segment_table_mirrors_the_cuda_struct():
    """``_CodeSegments`` is ``CodeSegments`` of csrc/dequant.cu field for
    field: ctypes would pass a drifted layout without complaint."""
    from fedcrack_tpu_torch.kernels import dequant

    source = (CSRC / "dequant.cu").read_text()
    assert int(re.search(r"constexpr int MAX_SEGMENTS = (\d+);", source).group(1)) == dequant.MAX_SEGMENTS
    assert int(re.search(r"constexpr int CODES_PER_UNIT = (\d+);", source).group(1)) == dequant.SLICE_ALIGN
    body = re.search(r"struct CodeSegments \{(.*?)\};", source, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+)(?:\[([\w +]+)\])?;", body, re.M)
    c_types = {"const void*": ctypes.c_void_p, "const float*": ctypes.c_void_p,
               "long long": ctypes.c_longlong, "int": ctypes.c_int}
    lengths = {"MAX_SEGMENTS": dequant.MAX_SEGMENTS, "MAX_SEGMENTS + 1": dequant.MAX_SEGMENTS + 1, "": None}
    want = [(name, c_types[ctype] if lengths[length] is None else c_types[ctype] * lengths[length])
            for ctype, name, length in fields]
    got = dequant._CodeSegments._fields_
    assert [name for name, _ in got] == [name for name, _ in want]
    for (_, got_type), (name, want_type) in zip(got, want):
        assert ctypes.sizeof(got_type) == ctypes.sizeof(want_type), name
        assert getattr(got_type, "_type_", got_type) == getattr(want_type, "_type_", want_type), name


def _c_params(source: str, symbol: str) -> int:
    params = re.search(rf"int {symbol}\(([^)]*)\)", source).group(1)
    return len([p for p in params.split(",") if p.strip()])


@pytest.mark.parametrize("library", ["dequant", "dequant_conv", "bce_sums"])
def test_ctypes_signatures_match_the_sources(library):
    """Every entry point's ctypes argument list has as many arguments as
    its C declaration."""
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.ops import bce

    lib = {"dequant": dequant.LIBRARY, "dequant_conv": dequant.CONV_LIBRARY, "bce_sums": bce.LIBRARY}[library]
    source = Path(lib.source).read_text()
    for symbol, argtypes in lib.symbols.items():
        assert _c_params(source, symbol) == len(argtypes), symbol
    assert set(re.findall(r"^int (fc_\w+)\(", source, re.M)) == set(lib.symbols)


def _int8_leaf(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)),
            torch.from_numpy(rng.uniform(0.01, 0.1, shape[-1]).astype(np.float32)))


def _bad_groups():
    q, s = _int8_leaf((3, 3, 1, 8))
    e4m3 = (q.float().to(torch.float8_e4m3fn), s)
    return {
        "empty": ([], ValueError),
        "mixed_devices": ([(q, s), (q.to("meta"), s.to("meta"))], ValueError),
        "scale_on_other_device": ([(q, s.to("meta"))], ValueError),
        "mixed_code_dtypes": ([(q, s), e4m3], TypeError),
        "non_contiguous_leaf": ([(q, s), (torch.zeros(8, 3, dtype=torch.int8).t(), torch.ones(3))], ValueError),
        "bad_scale_shape": ([(q, torch.ones(7))], ValueError),
        "scale_2d": ([(q, s[None])], ValueError),
        "not_a_code_dtype": ([(q.to(torch.uint8), s)], TypeError),
        "scale_not_f32": ([(q, s.double())], TypeError),
        "scalar_codes": ([(torch.tensor(3, dtype=torch.int8), torch.ones(1))], ValueError),
        "17_leaves": ([(q, s)] * 17, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_groups()))
def test_group_validation(case):
    from fedcrack_tpu_torch.kernels.dequant import CodeGroup, dequant_codes_group

    leaves, error = _bad_groups()[case]
    with pytest.raises(error):
        CodeGroup(leaves)
    with pytest.raises(error):
        dequant_codes_group(leaves)


def test_one_leaf_call_is_the_group_of_one():
    from fedcrack_tpu_torch.kernels import dequant

    q, s = _int8_leaf((4099,), seed=5)
    (grouped,) = dequant.dequant_codes_group([(q, s)])
    assert torch.equal(dequant.dequant_codes(q, s), grouped)
    assert torch.equal(grouped, dequant._dequant_codes_plain(q, s))


def test_cpu_group_takes_the_plain_path_and_counts_no_launch():
    from fedcrack_tpu_torch.kernels import dequant

    dequant.reset_launch_counts()
    leaves = [_int8_leaf(shape, seed=i) for i, shape in enumerate(_depthwise_shapes())]
    group = dequant.CodeGroup(leaves)
    assert group.table is None and group.device.type == "cpu"
    for out, (q, s) in zip(dequant.dequant_codes_group(group), leaves):
        assert torch.equal(out, dequant._dequant_codes_plain(q, s))
    dequant.dequant_codes(*leaves[0])
    assert dequant.dequant_codes.launches == 0


def test_prepared_group_is_shared_by_threads():
    """One prepared group, expanded from many threads at once (the
    batcher's workers share a placed tree): every call returns its own,
    correct tensors."""
    from fedcrack_tpu_torch.kernels import dequant

    leaves = [_int8_leaf(shape, seed=i) for i, shape in enumerate(_depthwise_shapes())]
    group = dequant.CodeGroup(leaves)
    want = [dequant._dequant_codes_plain(q, s) for q, s in leaves]
    results, errors = [], []

    def work():
        try:
            for _ in range(20):
                results.append(dequant.dequant_codes_group(group))
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == 8 * 20
    assert len({id(out[0]) for out in results}) == len(results)
    for outs in results:
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("plane", ["fused_int8", "fp8", "reference"])
def test_engine_builds_the_depthwise_group_once_per_placed_tree(plane):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.kernels.dequant import CodeGroup
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from torch_port_helpers import TINY_KW, jax_variables, port_config

    engine = InferenceEngine(port_config(TINY_KW),
                             ServeConfig(quant="int8", kernel_plane=plane, bucket_sizes=(32,), max_batch=1,
                                         tile_overlap=4),
                             device="cpu")
    payload = engine.prepare_quantized(tq.quantize_for_plane(jax_variables(TINY_KW), plane))
    if plane == "reference":
        assert payload.depthwise is None
    else:
        assert isinstance(payload.depthwise, CodeGroup)
        p = payload.tree["params"]
        want = [p[f"enc{i}_{sep}"]["depthwise"]["kernel"] for i in range(len(TINY_KW["encoder_features"]))
                for sep in ("sep1", "sep2")]
        assert len(payload.depthwise.leaves) == len(want)
        for (q, s), leaf in zip(payload.depthwise.leaves, want):
            assert s is leaf[tq.SKEY] and any(q is leaf[k] for k in (tq.QKEY, tq.QKEY_FP8) if k in leaf)
    probs = engine.predict_bucket(payload, np.zeros((1, 32, 32, 3), np.uint8))
    assert probs.shape == (1, 32, 32, 1) and np.isfinite(probs).all()
