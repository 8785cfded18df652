"""The tile plan of the port's GEMM kernel (``matmul_tile_plan``,
fedcrack_tpu_torch/kernels/csrc/dequant.cu) and an emulation of the kernel's
persistent walk, held against the JAX package on the CPU.

The CUDA kernel cannot run here. What surrounds its arithmetic is Python
that these tests reach: the plan's units cover every output entry once, fit
a block's shared memory and mirror the source's constants; and an emulation
of the walk (blocks in turn, each block's units in order, the column
block's codes loaded again only where a unit changes column block, rows
zero-filled past M, K zero-filled to whole chunks, stores masked to M and
N) under the kernels' arithmetic (``_emulated_kernel`` of
tests/test_torch_conv.py: three bf16 terms of x, lo then mid then hi, per
16-deep K step, the scale once) gives bit for bit the same arithmetic over
the whole matrix, and stays within the JAX bound of the JAX
``dequant_matmul`` (``impl="interpret"``). On the card chip_smoke.py holds
the kernel itself against the plain version.

Tolerances: bitwise between the walk and the whole matrix (the same
products summed in the same order per entry, whatever the tile); per entry
within one per-channel scale + 1e-6 of JAX (the two sides sum the K terms in
different orders and apply the scale before vs after the sum).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_conv import _emulated_kernel
from torch_port_helpers import jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port

CSRC = Path(__file__).resolve().parents[1] / "fedcrack_tpu_torch" / "kernels" / "csrc"
SMEM_PER_BLOCK = 232_448  # an H100 block's 227 KB


def _card_matmul_shapes() -> list[tuple[int, int, int]]:
    """(M, K, N) of the fused forward's 15 GEMMs at bucket 256 x batch 8 and
    of chip_smoke.py's ragged sweep: every shape the card runs."""
    import chip_smoke
    from fedcrack_tpu_torch.configs import ModelConfig

    main = [tuple(s[1:]) for s in chip_smoke.matmul_shapes(ModelConfig(), chip_smoke.BUCKET, chip_smoke.BATCH)]
    return main + [tuple(s) for s in chip_smoke.MATMUL_SWEEP]


def _scaled_main_shapes() -> list[tuple[int, int, int]]:
    """The 15 main-path GEMMs with M cut 256-fold (and made ragged), K and N
    as they are."""
    return [(m // 256 + 5, k, n) for m, k, n in _card_matmul_shapes()[:15]]


def _k_order(k: int, chunk: int) -> list[tuple[int, int, int]]:
    """(chunk, k16 step, MMA slot) of each K position of the kernel: the k
    of a chunk in order, two steps a chunk, thread t's k 4t..4t+3 of a step
    in slots 2t, 2t + 1, 2t + 8, 2t + 9."""
    order = []
    for kk in range(-(-k // chunk) * chunk):
        r = kk % chunk
        step, t, h, e = r // 16, (r % 16) // 4, (r // 2) % 2, r % 2
        order.append((kk // chunk, step, 2 * t + 8 * h + e))
    return order


def _walk_plan(m: int, k: int, n: int, tiles_of: tuple[int, int, int] | None = None):
    """The plan for (m, k, n), or the tiles of the plan for ``tiles_of``
    with units and blocks counted for (m, n), as the kernel would run that
    tile on this matrix."""
    from fedcrack_tpu_torch.kernels.dequant import matmul_tile_plan

    plan = matmul_tile_plan(m, k, n)
    if tiles_of is None:
        return plan
    big = matmul_tile_plan(*tiles_of)
    units = -(-m // big.bm) * -(-n // big.bn)
    return plan._replace(bm=big.bm, bn=big.bn, units=units, blocks=min(units, 132))


def _kernel_operands(x, q, scale, plan):
    """A with K zero-filled to whole chunks; the codes (as exact floats) and
    the scales zero-filled to whole column blocks and chunks."""
    m, k = x.shape
    n = q.shape[1]
    kp = -(-k // plan.chunk) * plan.chunk
    np_ = -(-n // plan.bn) * plan.bn
    return F.pad(x, (0, kp - k)), F.pad(q.float(), (0, np_ - n, 0, kp - k)), F.pad(scale, (0, np_ - n))


def _emulated_walk(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, plan) -> tuple[torch.Tensor, int]:
    """The kernel's loop: each block's units in turn (block ``b`` takes
    units ``b``, ``b + blocks``, ...), the column block's codes and scales
    made resident where a unit changes column block, the unit's ``bm`` rows
    (zero past M) against them, the store masked to M and N. Returns the
    output and how many times a block loaded codes."""
    from fedcrack_tpu_torch.kernels.dequant import matmul_unit_origin

    m, n = x.shape[0], q.shape[1]
    xp, qp, sp = _kernel_operands(x, q, scale, plan)
    y = torch.full((m, n), float("nan"))
    loads = 0
    for block in range(plan.blocks):
        resident = None
        for unit in range(block, plan.units, plan.blocks):
            m0, n0 = matmul_unit_origin(plan, m, unit)
            if n0 != resident:
                codes, s_tile, resident = qp[:, n0:n0 + plan.bn], sp[n0:n0 + plan.bn], n0
                loads += 1
            rows = xp[m0:m0 + plan.bm]
            rows = F.pad(rows, (0, 0, 0, plan.bm - rows.shape[0]))
            out = _emulated_kernel(rows, codes, s_tile)
            mr, nc = min(plan.bm, m - m0), min(plan.bn, n - n0)
            y[m0:m0 + mr, n0:n0 + nc] = out[:mr, :nc]
    return y, loads


def _inputs(shape, flavor, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    q, scale = jax_leaf(flavor, rng.normal(0, 0.1, (k, n)).astype(np.float32))
    return x, q, np.asarray(scale)


# ---- the plan ----


@pytest.mark.parametrize("shape", _card_matmul_shapes(), ids=str)
def test_matmul_units_cover_each_output_once_and_fit_shared_memory(shape):
    """Every output entry belongs to exactly one unit of one block, every
    block has work, the tiles are ones the source launches, and a block's
    shared memory fits the H100's 227 KB."""
    from fedcrack_tpu_torch.kernels.dequant import matmul_smem_bytes, matmul_tile_plan, matmul_unit_origin

    m, k, n = shape
    plan = matmul_tile_plan(m, k, n)
    count = np.zeros((m, n), np.int8)
    for block in range(plan.blocks):
        units = range(block, plan.units, plan.blocks)
        assert len(units) >= 1
        for unit in units:
            m0, n0 = matmul_unit_origin(plan, m, unit)
            assert 0 <= m0 < m and 0 <= n0 < n
            count[m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
    assert (count == 1).all()
    assert plan.bm in (64, 128, 256) and plan.bn in (8, 16, 32, 64, 128) and 1 <= plan.stages <= 8
    assert plan.bm < 256 or (plan.bn <= 32 and k <= 32)
    assert plan.units == -(-m // plan.bm) * -(-n // plan.bn) and plan.blocks == min(plan.units, 132)
    assert plan.smem == matmul_smem_bytes(plan.bm, plan.bn, k, plan.stages) <= SMEM_PER_BLOCK
    # The ring holds no more chunks than the busiest block computes.
    assert plan.stages <= -(-plan.units // plan.blocks) * -(-k // plan.chunk)


@pytest.mark.parametrize("k", [1, 27, 32, 64, 128, 256, 2304])
def test_matmul_k_order_depends_on_k_alone(k):
    """What fixes an entry's sums, the chunk (and with it the steps and the
    slots), is the same whatever M and N: so is the K order. The plan for
    ``m // 3 + 1`` rows, phase 3's launch over the leading rows, keeps it."""
    from fedcrack_tpu_torch.kernels.dequant import MATMUL_CHUNK, matmul_tile_plan

    for m in (1, 70, 2048, 8192, 131072):
        for n in (1, 3, 32, 64, 129, 256):
            plans = [matmul_tile_plan(m, k, n), matmul_tile_plan(m // 3 + 1, k, n)]
            assert {p.chunk for p in plans} == {MATMUL_CHUNK}
            assert len({tuple(_k_order(k, p.chunk)) for p in plans}) == 1
    order = _k_order(k, MATMUL_CHUNK)
    # Every step's 16 k fill its 16 slots once.
    for c in range(-(-k // MATMUL_CHUNK)):
        for step in range(2):
            assert sorted(s for cc, st, s in order if (cc, st) == (c, step)) == list(range(16))


def test_matmul_tiles_follow_the_shape():
    """The tiles change with the shape, never the K order: wide column
    blocks where the rows fill the card, narrower where they would leave
    SMs idle."""
    from fedcrack_tpu_torch.kernels.dequant import matmul_tile_plan

    assert matmul_tile_plan(131072, 64, 64)[:2] == (128, 64)
    assert matmul_tile_plan(131072, 32, 1)[:2] == (256, 8)  # four warpgroups for the head's short chains
    assert matmul_tile_plan(131072, 27, 32)[:2] == (256, 32)  # and the stem's
    assert matmul_tile_plan(131072, 64, 32)[:2] == (128, 32)  # not past one chunk of K
    assert matmul_tile_plan(2048, 256, 256)[:2] == (128, 32)  # 128 units, not 32 of 128 x 128
    assert matmul_tile_plan(8192, 256, 256)[:2] == (128, 128)
    assert matmul_tile_plan(64, 256, 256).bm == 64  # one warpgroup holds all the rows
    assert matmul_tile_plan(70, 2304, 257).bn == 8  # the codes of K = 2304 fit only narrow
    with pytest.raises(ValueError, match="do not fit"):
        matmul_tile_plan(100, 20000, 8)
    with pytest.raises(ValueError, match="empty"):
        matmul_tile_plan(0, 8, 8)


def test_matmul_plan_mirrors_the_cuda_source():
    """dequant.cu's constants, tiles and shared-memory layout are the
    plan's: the kernel refuses a plan whose bytes it computes otherwise."""
    from fedcrack_tpu_torch.kernels import dequant

    source = (CSRC / "dequant.cu").read_text()
    common = (CSRC / "dequant_common.cuh").read_text()

    def const(name, text=source):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("CHUNK") == dequant.MATMUL_CHUNK and const("WG_ROWS") == dequant._MATMUL_WG_ROWS
    assert const("MAX_STAGES") == dequant._MATMUL_MAX_STAGES and const("SMEM_LIMIT") == dequant._SMEM_PER_BLOCK
    assert const("ALIGN") == dequant._HALO_ALIGN and const("B_ROW_BYTES", common) == dequant._ROW_BYTES
    assert re.search(r"return stages \* \(stage_bytes\(bm\) \+ 16\) \+ 2 \* out_bytes\(bm, bn\) \+ "
                     r"codes_bytes\(k, bn\) \+ bn \* 4 \+ ALIGN;", source)
    assert re.search(r"stage_bytes\(int bm\) \{ return bm \* A_ROW_BYTES; \}", source)
    assert re.search(r"constexpr int A_ROW_BYTES = CHUNK \* 4;", source)
    assert re.search(r"out_bytes\(int bm, int bn\) \{ return bm \* bn \* 4; \}", source)
    assert re.search(r"codes_bytes\(int k, int bn\) \{ return k_chunks\(k\) \* bn \* B_ROW_BYTES; \}", source)
    tiles = set(re.findall(r"FC_TILE\((\d+), (\d+)\)", source[source.index("launch_matmul"):]))
    narrow = [bn for bn in dequant._MATMUL_BNS if bn <= dequant._MATMUL_NARROW]
    assert tiles == ({(str(bn), str(nc)) for bn in dequant._MATMUL_BNS for nc in (1, 2)}
                     | {(str(bn), "4") for bn in narrow})
    assert re.search(rf"if \(BM == 256 && BN > {dequant._MATMUL_NARROW}\) return bad;", source)
    assert len(re.findall(r"struct Mma<(\d+)>", common)) == 5


# ---- the walk ----


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", _scaled_main_shapes() + [(4, 7, 5), (33, 130, 129), (1000, 27, 1), (129, 36, 33),
                                                           (300, 20, 8), (70, 300, 257)], ids=str)
def test_persistent_walk_equals_whole_matrix_bitwise(shape, flavor):
    """The walk over the plan's units, with its resident codes and masked
    stores, is bit for bit the kernel's arithmetic over the whole matrix
    (its operands zero-filled to whole chunks and column blocks): no unit
    misses, repeats or reorders a product. Also under the tiles the card
    takes for the full-size shape, where the matrix is the scaled one."""
    skip_without_fp8(flavor)
    x, q, scale = _inputs(shape, flavor, sum(shape) * 13 + len(flavor))
    x, q, scale = torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale)
    full = dict(zip(_scaled_main_shapes(), _card_matmul_shapes()))
    for tiles_of in [None] + ([full[shape]] if shape in full else []):
        plan = _walk_plan(*shape, tiles_of)
        got, loads = _emulated_walk(x, q, scale, plan)
        xp, qp, sp = _kernel_operands(x, q, scale, plan)
        want = _emulated_kernel(xp, qp, sp)[:, :shape[2]]
        assert torch.equal(got, want), plan
        # A block loads codes once, and again only where its column block changes.
        cols = -(-shape[2] // plan.bn)
        assert plan.blocks <= loads <= plan.blocks * min(cols, -(-plan.units // plan.blocks))


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", _scaled_main_shapes(), ids=str)
def test_persistent_walk_within_jax_bound(shape, flavor):
    """The walk at the main path's GEMMs (M cut 256-fold), under its own
    plan and the full-size shape's tiles, stays within the JAX bound of the
    JAX ``dequant_matmul`` run as the JAX tests run it."""
    from fedcrack_tpu.kernels.dequant import dequant_matmul as jax_dequant_matmul

    skip_without_fp8(flavor)
    x, q, scale = _inputs(shape, flavor, sum(shape) * 17 + len(flavor))
    want = np.asarray(jax_dequant_matmul(x, q, scale, impl="interpret"))
    full = dict(zip(_scaled_main_shapes(), _card_matmul_shapes()))
    for tiles_of in (None, full[shape]):
        plan = _walk_plan(*shape, tiles_of)
        got, _ = _emulated_walk(torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale), plan)
        assert np.all(np.abs(got.numpy() - want) <= scale[None, :] + 1e-6), plan
