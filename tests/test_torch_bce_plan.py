"""The launch plan of the port's ``bce_sums_kernel`` (ops/bce.py::bce_plan,
csrc/bce_sums.cu) and its reduction order, on the CPU.

The kernel itself runs only on the card (chip_smoke.py's phase 6 holds it
against the plain version there). Here: the plan is a function of n alone;
every block's share, stage by stage and thread by thread as the kernel
indexes it, covers each element exactly once; the plan fits
one wave of the card with the fewest stages a block; ``check_bce_plan``
refuses exactly what the C entry point's ``plan_ok`` refuses (its body,
translated); and a numpy float32 emulation of the kernel's order (each
thread's elements in order, then the same shuffle tree over a warp's
lanes, a block's warps and the grid's rows; integer counts) agrees with
the JAX package's reference path within phase 6's tolerance (rtol 1e-5,
atol 1e-3: float32 sums of up to 2e6 terms in different orders), the
count lanes equal.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest

from fedcrack_tpu_torch.ops import bce

pytestmark = pytest.mark.torch_port

SOURCE = Path(bce.LIBRARY.source).read_text()
# Phase 6's sizes: the ragged sweep, the train step's 16 x 128 x 128, the
# 8 x 256 x 256 batch; one stage and one more element, a full wave of
# one-stage blocks and one more element, the 256 px bf16 step's
# 32 x 256 x 256.
PHASE6 = [1, 100, 128, 32768, 32769, 100_000, 16 * 128 * 128, 8 * 256 * 256]
EDGES = [2048, 2049, 132 * 2048, 132 * 2048 + 1, 32 * 256 * 256]
# And the spatial plane's 2 x 1024 x 256, nothing, and an odd size that
# takes many stages a block.
SIZES = PHASE6 + EDGES + [2 * 1024 * 256, 0, 4_000_037]


def _constant(name):
    return int(re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", SOURCE).group(1)
               .replace("(1LL << 31) - 1", str(2**31 - 1)).replace("4 * THREADS", str(4 * _threads())))


def _threads():
    return int(re.search(r"constexpr int THREADS = (\d+);", SOURCE).group(1))


def test_constants_mirror_the_source():
    assert _threads() == bce.THREADS
    for name in ("STAGE_ELEMS", "MAX_GRID", "MAX_N"):
        assert _constant(name) == getattr(bce, name), name


@pytest.mark.parametrize("n", SIZES)
def test_plan_depends_on_n_alone(n):
    assert list(inspect.signature(bce.bce_plan.__wrapped__).parameters) == ["n"]
    plan = bce.bce_plan(n)
    assert bce.bce_plan.__wrapped__(n) == plan == bce.bce_plan(n)
    assert all(type(v) is int for v in plan)


def _shares(n, plan):
    """(block, stage, thread, j) -> element, as the kernel walks its share:
    the valid elements' indices in the order they are read, per block."""
    stage, t, j = bce.STAGE_ELEMS, np.arange(bce.THREADS)[:, None], np.arange(4)[None, :]
    for b in range(plan.blocks):
        begin = b * plan.stages * stage
        end = min(begin + plan.stages * stage, n)
        filled = -(-(end - begin) // stage) if begin < end else 0
        assert filled <= plan.stages
        for i in range(filled):
            e = begin + i * stage + 4 * t + j
            yield b, e[e < end]


@pytest.mark.parametrize("n", SIZES)
def test_shares_cover_each_element_once(n):
    plan = bce.bce_plan(n)
    seen = np.zeros(max(n, 1), np.int64)
    for b, idx in _shares(n, plan):
        assert ((idx >= b * plan.stages * bce.STAGE_ELEMS) & (idx < (b + 1) * plan.stages * bce.STAGE_ELEMS)).all()
        seen[idx] += 1
    assert (seen[:n] == 1).all()


@pytest.mark.parametrize("n", SIZES + [bce.MAX_N])
def test_plan_fits_the_card(n):
    """One wave of blocks, each the fewest stages one wave allows, and no
    block left without elements."""
    plan = bce.bce_plan(n)
    bce.check_bce_plan(n, plan)
    assert 1 <= plan.blocks <= bce.MAX_GRID == 132
    stages_needed = max(1, -(-n // bce.STAGE_ELEMS))
    assert plan.stages == -(-stages_needed // bce.MAX_GRID)
    assert (plan.blocks - 1) * plan.stages < stages_needed


def test_plan_refuses_sizes_the_kernel_cannot_count():
    assert bce.bce_plan(bce.MAX_N).blocks == bce.MAX_GRID
    with pytest.raises(ValueError):
        bce.bce_plan(bce.MAX_N + 1)
    with pytest.raises(ValueError):
        bce.bce_plan(-1)


def _c_plan_ok():
    """``plan_ok`` of csrc/bce_sums.cu as a Python function: its body,
    translated token for token."""
    body = re.search(r"bool plan_ok\(([^)]*)\) \{(.*?)\n\}", SOURCE, re.S)
    params = [p.split()[-1] for p in body.group(1).split(",")]
    lines = ["def plan_ok(" + ", ".join(params) + "):"]
    for line in body.group(2).strip().splitlines():
        line = line.strip().replace("static_cast<long long>", "").replace("||", " or ").replace("&&", " and ")
        line = line.replace(" / ", " // ").replace("false", "False").replace("true", "True").rstrip(";")
        line = re.sub(r"^if \((.*)\) return (\w+)$", r"if \1: return \2", line)
        lines.append("    " + line)
    scope = {name: _constant(name) for name in ("MAX_N", "MAX_GRID", "STAGE_ELEMS")}
    exec("\n".join(lines), scope)
    return scope["plan_ok"]


def _python_ok(n, plan):
    try:
        bce.check_bce_plan(n, plan)
    except ValueError:
        return False
    return True


def test_plan_check_mirrors_the_c_entry_point():
    plan_ok = _c_plan_ok()
    rng = np.random.default_rng(22)
    cases = []
    for n in SIZES + [bce.MAX_N]:
        good = bce.bce_plan(n)
        cases.append((n, good))
        for field, deltas in (("blocks", (-8, -1, 1, 8, 200, -good.blocks)), ("stages", (-1, 1, -good.stages))):
            for d in deltas:
                cases.append((n, good._replace(**{field: getattr(good, field) + d})))
        cover = good.blocks * good.stages * bce.STAGE_ELEMS
        cases += [(n + 10**6, good), (cover, good), (cover + 1, good)]
    cases.append((-1, bce.bce_plan(0)))
    cases.append((bce.MAX_N + 1, bce.bce_plan(bce.MAX_N)))
    for _ in range(2000):  # near the edges of every condition
        blocks = int(rng.choice([int(rng.integers(-1, 4)), int(rng.integers(0, 140)), 131, 132, 133]))
        stages = int(rng.integers(-1, 40))
        n = int(blocks * stages * bce.STAGE_ELEMS * rng.uniform(-0.01, 1.1))
        cases.append((n, bce.BcePlan(blocks, stages)))
    verdicts = [(plan_ok(n, *plan), _python_ok(n, plan)) for n, plan in cases]
    assert all(c == p for c, p in verdicts)
    assert sum(c for c, _ in verdicts) > 50 and sum(not c for c, _ in verdicts) > 50


def _tree(v):
    """The kernel's warp_fold on the last axis (32 lanes): lane l takes
    lane l + off, off = 16, 8, 4, 2, 1; lane 0's sum."""
    assert v.shape[-1] == 32
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _lanes(v, width=32):
    """Rows on the last axis padded with zeros to a warp's 32 lanes."""
    pad = np.zeros(v.shape[:-1] + (width - v.shape[-1],), v.dtype)
    return np.concatenate([v, pad], axis=-1)


def _emulate(x, y, plan):
    """The kernel's five sums in numpy float32, in its order."""
    n, threads, warps = x.size, bce.THREADS, bce.THREADS // 32
    g, k = plan.blocks, plan.stages
    total = g * k * bce.STAGE_ELEMS
    xs = np.zeros(total, np.float32)
    ys = np.zeros(total, np.float32)
    xs[:n], ys[:n] = x, y
    valid = (np.arange(total) < n).reshape(g, k, threads, 4)
    xs, ys = xs.reshape(g, k, threads, 4), ys.reshape(g, k, threads, 4)
    per = np.maximum(xs, np.float32(0)) - xs * ys + np.log1p(np.exp(-np.abs(xs)))
    assert per.dtype == np.float32
    s = np.zeros((2, g, threads), np.float32)
    for i in range(k):  # each thread's elements in order
        for j in range(4):
            v = valid[:, i, :, j]
            s[0] = np.where(v, s[0] + per[:, i, :, j], s[0])
            s[1] = np.where(v, s[1] + ys[:, i, :, j] * per[:, i, :, j], s[1])
    block = _tree(_lanes(_tree(s.reshape(2, g, warps, 32))))  # the warps, then their rows
    if g == 1:
        grid = block[:, 0]
    else:
        rows = _lanes(block, -(-g // 32) * 32).reshape(2, -1, 32)
        lane = np.zeros((2, 32), np.float32)
        for i in range(rows.shape[1]):  # lane l: rows l, l + 32, ... in order
            lane = lane + rows[:, i]
        grid = _tree(lane)
    pred, tgt = valid & (xs > 0), valid & (ys > 0.5)
    p, t, both = int(pred.sum()), int(tgt.sum()), int((pred & tgt).sum())
    return np.array([grid[0], n - p - t + 2 * both, both, p + t - both, grid[1]], np.float32)


@pytest.mark.parametrize("n", PHASE6 + EDGES)
def test_emulated_order_matches_jax(n):
    from fedcrack_tpu.ops.pallas_bce import bce_sums as jax_bce_sums

    rng = np.random.RandomState(n % 97)
    x = rng.normal(0, 2, n).astype(np.float32)
    y = (rng.uniform(size=n) > 0.7).astype(np.float32)
    want = np.asarray(jax_bce_sums(x, y, "jnp"))
    got = _emulate(x, y, bce.bce_plan(n))
    np.testing.assert_array_equal(got[1:4], want[1:4])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
