"""The port's fused depthwise 3x3 conv (``dequant_dwconv3x3`` in
fedcrack_tpu_torch/kernels/dequant.py, the kernel in csrc/dequant_dw.cu)
held against the JAX package on the CPU.

On the CPU the wrapper takes its plain version, which is held against the
JAX forward's depthwise stage: ``lax.conv_general_dilated`` of
``jax.nn.relu(x)`` with ``dequant_codes(q, s, impl="reference")`` as the
kernel, ``feature_group_count=C``. The CUDA kernel cannot run here, so its
walk over the work (``dwconv_tile_plan``'s units, each unit's zero-filled
halo box, a column walked down with a 3-row window) is emulated in this
file and held bit for bit against the plain version; on the card
chip_smoke.py holds the kernel bitwise against the plain version.

Tolerance against JAX: atol 1e-5, rtol 0, as for the stride-2 stem
(tests/test_torch_forward.py): both sides multiply the same f32 taps by
the same inputs, but XLA sums the nine products in another order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port

CSRC = Path(__file__).resolve().parents[1] / "fedcrack_tpu_torch" / "kernels" / "csrc"
# (N, H, W, C): odd and non-square grids, C off the 32-channel chunk and
# off TMA's 4-channel rows, a 1x1 image, batch 1 and 3.
SHAPES = [(1, 5, 7, 1), (3, 7, 5, 3), (1, 9, 11, 17), (3, 5, 9, 32), (1, 7, 7, 40), (3, 1, 1, 17)]


def _inputs(shape, flavor, seed):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (n, h, w, c)).astype(np.float32)
    q, scale = jax_leaf(flavor, rng.normal(0, 0.2, (3, 3, 1, c)).astype(np.float32))
    return x, q, np.asarray(scale)


def _card_dw_shapes() -> list[tuple[int, int, int, int]]:
    """(N, H, W, C) of the fused forward's 6 depthwise stages at bucket 256
    x batch 8 and of chip_smoke.py's ragged sweep: every shape the card
    runs."""
    import chip_smoke
    from fedcrack_tpu_torch.configs import ModelConfig

    main = [tuple(s[1:]) for s in chip_smoke.dwconv_shapes(ModelConfig(), chip_smoke.BUCKET, chip_smoke.BATCH)]
    return main + [tuple(s) for s in chip_smoke.DW_SWEEP]


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_dwconv_plain_matches_jax_reference(shape, flavor):
    import jax
    from jax import lax

    from fedcrack_tpu.kernels.dequant import dequant_codes
    from fedcrack_tpu_torch.kernels import dequant

    skip_without_fp8(flavor)
    x, q, scale = _inputs(shape, flavor, sum(shape) * 11 + len(flavor))
    want = np.asarray(lax.conv_general_dilated(
        jax.nn.relu(x), dequant_codes(q, scale, impl="reference"), (1, 1), "SAME",
        feature_group_count=shape[3], dimension_numbers=("NHWC", "HWIO", "NHWC")))
    args = (torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale))
    plain = dequant._dequant_dwconv3x3_plain(*args)
    got = dequant.dequant_dwconv3x3(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape and got.is_contiguous()
    assert torch.equal(got, plain)  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_dwconv_input_clamp_keeps_signed_zero_and_nan_as_torch_relu():
    """The clamp is v < 0 ? 0 : v: -0.0 and NaN pass, as torch.relu lets
    them pass on the CPU, so the stage equals, bit for bit, the same taps
    over torch.relu(x); a NaN reaches exactly the outputs whose window
    holds it."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(0, 1.0, (2, 6, 7, 5)).astype(np.float32))
    x[0, 0, 0, :] = -0.0
    x[0, 3, 4, 1] = float("nan")
    x[1, 5, 6, 4] = float("nan")
    x[1, 2, :, 2] = -0.0
    q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, 5)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 5).astype(np.float32))
    clamped = x.masked_fill(x < 0, 0.0)
    assert torch.equal(clamped.view(torch.int32), torch.relu(x).view(torch.int32))
    got = dequant.dequant_dwconv3x3(x, q, s)

    taps = (q.float() * s).reshape(9, 5)
    xp = F.pad(torch.relu(x), (0, 0, 1, 1, 1, 1))
    want = xp[:, :6, :7] * taps[0]
    for t in range(1, 9):
        want = want + xp[:, t // 3:t // 3 + 6, t % 3:t % 3 + 7] * taps[t]
    assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
    nan = torch.zeros(2, 6, 7, 5, dtype=torch.bool)
    nan[0, 2:5, 3:6, 1] = True
    nan[1, 4:6, 5:7, 4] = True
    assert torch.equal(torch.isnan(got), nan)
    assert torch.signbit(x[x == 0]).all()  # the inputs do hold -0.0


def _covered(plan, n, h, w, c) -> torch.Tensor:
    from fedcrack_tpu_torch.kernels import dequant

    hits = torch.zeros((n, h, w, c), dtype=torch.int32)
    for unit in range(plan.units):
        img, h0, w0, c0 = dequant.dwconv_unit_origin(plan, n, h, w, unit)
        assert c0 % plan.chunk == 0 and c0 < c and h0 < h and w0 < w and img < n
        hits[img, h0:h0 + plan.th, w0:w0 + plan.tw, c0:c0 + plan.chunk] += 1
    return hits


@pytest.mark.parametrize("shape", _card_dw_shapes() + SHAPES, ids=str)
def test_dwconv_units_cover_each_output_once_and_fit_the_card(shape):
    """Every output lies in exactly one unit; at most 132 blocks, none
    idle; a block's shared memory within 227 KB; the TMA box (the unit's
    channels, TW + 2, TH + 2, 1) within 256 a dimension; every consumer
    warp one strip of a unit (TW x channels / 32 = warps x columns)."""
    from fedcrack_tpu_torch.kernels import dequant

    n, h, w, c = shape
    plan = dequant.dwconv_tile_plan(n, h, w, c)
    assert torch.all(_covered(plan, n, h, w, c) == 1)
    assert plan.units == n * -(-h // plan.th) * -(-w // plan.tw) * -(-c // plan.chunk)
    assert plan.blocks == min(plan.units, 132)
    assert 1 <= plan.stages <= min(4, -(-plan.units // plan.blocks))
    assert plan.smem == dequant.dwconv_smem_bytes(plan.th, plan.tw, plan.chunk, plan.stages) <= 232_448
    assert all(d <= 256 for d in (plan.chunk, plan.tw + 2, plan.th + 2, 1))
    assert plan.th in (8, 16) and plan.chunk in (32, 64) and plan.tw * plan.chunk // 32 == dequant.DWCONV_SPAN


def test_dwconv_tiles_follow_the_shape():
    """A unit takes 64 channels where C is a multiple of 64, else 32; 16
    rows where that still gives three quarters of the SMs a unit and 8 rows
    would not give each SM three units, else 8. At the forward's six
    stages that is the plan each stage timed fastest with on an H100."""
    from fedcrack_tpu_torch.kernels import dequant

    plans = [dequant.dwconv_tile_plan(*s) for s in _card_dw_shapes()[:6]]
    assert [(p.th, p.tw, p.chunk) for p in plans] == [(8, 32, 32), (8, 16, 64), (16, 16, 64), (8, 16, 64),
                                                       (8, 16, 64), (16, 16, 64)]
    assert [p.units for p in plans] == [512, 1024, 128, 512, 128, 128]
    assert [p.stages for p in plans] == [4, 4, 1, 4, 1, 1]
    small = dequant.dwconv_tile_plan(1, 1, 1, 17)
    assert (small.th, small.tw, small.chunk, small.units, small.blocks, small.stages) == (8, 32, 32, 1, 1, 1)
    assert dequant.dwconv_tile_plan(6, 50, 70, 80)[:3] == (16, 32, 32)  # C % 64 != 0: 32 channels a unit
    with pytest.raises(ValueError):
        dequant.dwconv_tile_plan(0, 4, 4, 8)


def test_dwconv_plan_mirrors_the_cuda_source():
    """dequant_dw.cu's constants, shared-memory layout and entry points are
    the plan's and the wrapper's: the kernel refuses a plan whose bytes it
    computes otherwise."""
    from fedcrack_tpu_torch.kernels import dequant

    source = (CSRC / "dequant_dw.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))

    assert const("CHUNK") == dequant.DWCONV_CHUNK and const("STAGE_ALIGN") == dequant._DW_ALIGN
    assert const("MAX_STAGES") == dequant._DW_MAX_STAGES and const("SMEM_LIMIT") == dequant._SMEM_PER_BLOCK
    assert const("MAX_BLOCKS") == dequant._SMS
    assert const("CONSUMER_WARPS") * const("COLS") == dequant.DWCONV_SPAN
    assert re.search(r"constexpr int SPAN = CONSUMER_WARPS \* COLS;", source)
    assert re.search(r"return \(th \+ 2\) \* \(tw \+ 2\) \* uc \* 4;", source)
    assert re.search(r"return stages \* \(halo_bytes\(th, tw, uc\) \+ 16\) \+ STAGE_ALIGN;", source)
    assert re.search(r"\(TH != 8 && TH != 16\) \|\| \(UC != 32 && UC != 64\) \|\| TW \* \(UC / CHUNK\) != SPAN",
                     source)
    assert set(re.findall(r"^int (fc_\w+)\(", source, re.M)) == set(dequant.DW_LIBRARY.symbols)
    for symbol, argtypes in dequant.DW_LIBRARY.symbols.items():
        params = re.search(rf"int {symbol}\(([^)]*)\)", source).group(1)
        assert len([p for p in params.split(",") if p.strip()]) == len(argtypes), symbol


def _emulated_kernel(x, q, scale, plan) -> torch.Tensor:
    """The kernel's walk in plain torch: per unit the zero-filled halo box
    of its chunk, the taps float(q) * scale of its channels, and each
    column of the tile walked down with a 3-row window, the nine products
    summed in (dy, dx) row-major order; stores masked at the image's edge
    and past C."""
    from fedcrack_tpu_torch.kernels import dequant

    n, h, w, c = x.shape
    k = plan.chunk
    y = torch.full_like(x, float("inf"))
    taps_all = (q.float() * scale).reshape(9, c)
    for unit in range(plan.units):
        img, h0, w0, c0 = dequant.dwconv_unit_origin(plan, n, h, w, unit)
        box = torch.zeros(plan.th + 2, plan.tw + 2, k)
        lo_h, hi_h = max(h0 - 1, 0), min(h0 + plan.th + 1, h)
        lo_w, hi_w = max(w0 - 1, 0), min(w0 + plan.tw + 1, w)
        cc = min(k, c - c0)
        box[lo_h - h0 + 1:hi_h - h0 + 1, lo_w - w0 + 1:hi_w - w0 + 1, :cc] = x[img, lo_h:hi_h, lo_w:hi_w, c0:c0 + cc]
        box = box.masked_fill(box < 0, 0.0)
        taps = torch.zeros(9, k)
        taps[:, :cc] = taps_all[:, c0:c0 + cc]
        for col in range(plan.tw):
            win = [box[r, col:col + 3] for r in range(2)]  # rows of (3, k)
            for r in range(plan.th):
                win.append(box[r + 2, col:col + 3])
                acc = win[0][0] * taps[0]
                for t in range(1, 9):
                    acc = acc + win[t // 3][t % 3] * taps[t]
                win.pop(0)
                if h0 + r < h and w0 + col < w:
                    y[img, h0 + r, w0 + col, c0:c0 + cc] = acc[:cc]
    return y


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape,tile", [((2, 17, 35, 40), (16, 32, 32)), ((1, 20, 18, 72), (16, 16, 64)),
                                        ((3, 9, 13, 3), (8, 32, 32)), ((1, 1, 1, 17), (8, 16, 64)),
                                        ((2, 11, 19, 64), (8, 16, 64))], ids=str)
def test_halo_tile_emulation_equals_plain_bitwise(shape, tile, flavor):
    """The kernel's tiles (chunks, zero-filled halo boxes, column walks)
    give bit for bit the plain version's outputs: the halo's zeros are the
    SAME padding, and no tile changes an output's sum."""
    from fedcrack_tpu_torch.kernels import dequant

    skip_without_fp8(flavor)
    n, h, w, c = shape
    x, q, scale = _inputs(shape, flavor, sum(shape) * 13 + len(flavor))
    x, q, scale = torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale)
    th, tw, chunk = tile
    units = n * -(-h // th) * -(-w // tw) * -(-c // chunk)
    plan = dequant.DwTilePlan(th, tw, chunk, 1, units, min(units, 132), dequant.dwconv_smem_bytes(th, tw, chunk, 1))
    assert torch.equal(_emulated_kernel(x, q, scale, plan), dequant._dequant_dwconv3x3_plain(x, q, scale))


def test_dwconv_validates_and_counts_no_cpu_launch():
    from fedcrack_tpu_torch.kernels import dequant

    x = torch.zeros(1, 4, 4, 8)
    q = torch.zeros(3, 3, 1, 8, dtype=torch.int8)
    s = torch.ones(8)
    bad = [
        (ValueError, (x, q, torch.ones(7))),  # scale != C
        (ValueError, (x, torch.zeros(3, 3, 1, 7, dtype=torch.int8), s)),  # C mismatch
        (ValueError, (x, torch.zeros(3, 3, 8, 8, dtype=torch.int8), s)),  # a full conv's codes
        (ValueError, (x, torch.zeros(1, 1, 1, 8, dtype=torch.int8), s)),  # not 3x3
        (ValueError, (x[0], q, s)),  # not NHWC
        (TypeError, (x, q.to(torch.int32), s)),
        (TypeError, (x.double(), q, s)),
        (TypeError, (x, q, s.double())),
        (ValueError, (x.permute(0, 2, 1, 3), q, s)),  # not contiguous
        (ValueError, (x, q.to("meta"), s)),  # devices differ
    ]
    for error, args in bad:
        with pytest.raises(error):
            dequant.dequant_dwconv3x3(*args)

    dequant.dequant_dwconv3x3.launches = 3
    dequant.reset_launch_counts()
    assert dequant.dequant_dwconv3x3.launches == 0
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 6)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, 6)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 6).astype(np.float32))
    assert torch.equal(dequant.dequant_dwconv3x3(x, q, s), dequant._dequant_dwconv3x3_plain(x, q, s))
    assert dequant.dequant_dwconv3x3(torch.zeros(0, 3, 5, 6), q, s).shape == (0, 3, 5, 6)
    assert dequant.dequant_dwconv3x3.launches == 0
