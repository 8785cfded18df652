"""The fused 3x3 conv of the port (``dequant_conv3x3``) and the arithmetic of
the tensor-core dequant kernels (fedcrack_tpu_torch/kernels/csrc/dequant.cu),
held against the JAX package on the CPU.

On the CPU the wrapper takes its plain version (F.pad + F.unfold into the
plain matmul); it is held against the JAX ``_conv3x3`` run as the JAX tests
run it (``impl="interpret"``). The CUDA kernels cannot run here, so their
arithmetic is held by a plain-torch emulation kept in this file and used by
nothing in the package: the f32 activation split into three bf16 terms,
each term times the bf16 codes accumulated in f32 per 16-deep K step (lo,
mid, hi), the scale applied once. For the conv (csrc/dequant_conv.cu), K
runs in the kernel's order (32-channel chunk, kh, kw, channel), and the
emulation also walks the kernel's work: ``conv_tile_plan``'s blocks and
units, each unit's zero-filled halo box and the nine shifted windows of it. On the
card chip_smoke.py holds the kernels against the plain versions.

Tolerances: per entry within one per-channel scale + 1e-6, the JAX bound
(both sides sum the same products in different orders and apply the scale
before vs after the sum); the split reconstructs x within 2^-24 |x|; the
tiled emulation equals the whole-image one bit for bit (the same products
summed in the same order per entry, whatever the tile).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import SWEEP_SHAPES, jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port

CSRC = Path(__file__).resolve().parents[1] / "fedcrack_tpu_torch" / "kernels" / "csrc"
# (N, H, W, C, F): odd and non-square grids, ragged C and F, a 1x1 image.
CONV_SHAPES = [(1, 5, 7, 8, 12), (2, 6, 6, 4, 9), (1, 3, 4, 6, 5), (2, 7, 5, 16, 33), (1, 1, 1, 4, 3)]


def _card_conv_shapes() -> list[tuple[int, int, int, int, int]]:
    """(N, H, W, C, F) of the fused forward's 8 convs at bucket 256 x batch
    8 and of chip_smoke.py's ragged sweep: every shape the card runs."""
    import chip_smoke
    from fedcrack_tpu_torch.configs import ModelConfig

    main = [tuple(s[1:]) for s in chip_smoke.conv_shapes(ModelConfig(), chip_smoke.BUCKET, chip_smoke.BATCH)]
    return main + [tuple(s) for s in chip_smoke.CONV_SWEEP]


def _jax_conv3x3(x: np.ndarray, flavor: str, w: np.ndarray):
    """The JAX package's stride-1 ``_conv3x3`` through the Pallas
    interpreter, with a zero bias; returns (output, codes, scales)."""
    from fedcrack_tpu.kernels.forward import _conv3x3
    from fedcrack_tpu.serve import quant as jq

    q, scale = jax_leaf(flavor, w)
    key = jq.QKEY if flavor == "int8" else jq.QKEY_FP8
    mod = {"kernel": {key: q, jq.SKEY: scale}, "bias": np.zeros(w.shape[-1], np.float32)}
    want = np.asarray(_conv3x3(x, mod, stride=1, impl="interpret"))
    return want, q, np.asarray(scale)


# ---- the kernel's arithmetic, emulated in plain torch ----


def _split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _emulated_kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernels' sums: per 16-deep K step, lo, mid and hi of x against
    the bf16 codes, accumulated in f32; the scale once at the end."""
    codes = q.float().to(torch.bfloat16)
    assert torch.equal(codes.float(), q.float())
    terms = _split3(x)
    acc = torch.zeros(x.shape[0], q.shape[1])
    for k0 in range(0, x.shape[1], 16):
        b = codes[k0:k0 + 16].float()
        for term in reversed(terms):  # lo, mid, hi
            acc = acc + term[:, k0:k0 + 16].float() @ b
    return acc * scale


def _chunked(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """The last axis zero-padded to whole chunks of ``chunk`` channels."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % chunk))


def _kernel_order_rows(x: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """The conv kernel's A rows: output pixels, K ordered (chunk of
    ``chunk`` channels, kh, kw, channel), the channels past C zero."""
    n, h, w, _ = x.shape
    xp = _chunked(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)), chunk)
    taps = [xp[:, kh:kh + h, kw:kw + w, :] for kh in range(3) for kw in range(3)]
    rows = torch.stack(taps, dim=3).reshape(n * h * w, 9, -1, chunk)  # [pixel, tap, chunk, channel]
    return rows.permute(0, 2, 1, 3).reshape(n * h * w, -1)


def _kernel_order_codes(q: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """The HWIO codes as the kernel's B: rows in :func:`_kernel_order_rows`'
    K order, the channels past C zero."""
    f = q.shape[3]
    qc = _chunked(q.float().permute(0, 1, 3, 2), chunk)  # [kh, kw, F, C padded]
    return qc.reshape(9, f, -1, chunk).permute(2, 0, 3, 1).reshape(-1, f)


def _k_order(c: int, chunk: int) -> list[tuple[int, int]]:
    """(tap, channel) of each K position of the kernel, -1 for a zero pad."""
    return [(tap, ch if ch < c else -1) for c0 in range(0, c, chunk) for tap in range(9)
            for ch in range(c0, c0 + chunk)]


def _step_sums(rows: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The conv kernel's sums in a fixed order per entry, whatever the
    number of rows or columns: per 16-deep K step, lo, mid and hi of each
    row against the bf16 codes (each product exact in f32), the step's 16
    products summed in k order and added to the f32 accumulator; the scale
    once at the end."""
    b16 = codes.to(torch.bfloat16)
    assert torch.equal(b16.float(), codes)
    terms = _split3(rows)
    acc = torch.zeros(rows.shape[0], codes.shape[1])
    for k0 in range(0, rows.shape[1], 16):
        b = b16[k0:k0 + 16].float()
        for term in reversed(terms):  # lo, mid, hi
            prod = term[:, k0:k0 + 16, None].float() * b[None]
            step = prod[:, 0]
            for k in range(1, prod.shape[1]):
                step = step + prod[:, k]
            acc = acc + step
    return acc * scale


def _emulated_conv_tiled(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The conv kernel's loop: per block of ``conv_tile_plan``, its units in
    turn, each the zero-filled (TH + 2) x (TW + 2) halo box of its image, the
    nine shifted windows of it as the tile's A rows, the unit's columns of
    the codes, and the store masked to the pixels inside the image and F."""
    from fedcrack_tpu_torch.kernels.dequant import conv_tile_plan, conv_unit_origin

    n, h, w, c = x.shape
    f = q.shape[3]
    plan = conv_tile_plan(n, h, w, c, f)
    codes = _kernel_order_codes(q, plan.chunk)
    y = torch.full((n, h, w, f), float("nan"))
    for block in range(plan.blocks):
        for unit in range(block, plan.units, plan.blocks):
            img, h0, w0, n0 = conv_unit_origin(plan, n, h, w, unit)
            halo = torch.zeros(plan.th + 2, plan.tw + 2, c)
            rh = slice(max(h0 - 1, 0), min(h0 + plan.th + 1, h))
            rw = slice(max(w0 - 1, 0), min(w0 + plan.tw + 1, w))
            halo[rh.start - (h0 - 1):rh.stop - (h0 - 1), rw.start - (w0 - 1):rw.stop - (w0 - 1)] = x[img, rh, rw]
            halo = _chunked(halo, plan.chunk)
            taps = [halo[kh:kh + plan.th, kw:kw + plan.tw] for kh in range(3) for kw in range(3)]
            rows = torch.stack(taps, dim=2).reshape(plan.th * plan.tw, 9, -1, plan.chunk)
            rows = rows.permute(0, 2, 1, 3).reshape(plan.th * plan.tw, -1)
            th, tw = min(plan.th, h - h0), min(plan.tw, w - w0)
            cols = slice(n0, min(n0 + plan.bn, f))
            out = _step_sums(rows, codes[:, cols], scale[cols]).reshape(plan.th, plan.tw, -1)
            y[img, h0:h0 + th, w0:w0 + tw, cols] = out[:th, :tw]
    return y


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=[str(s) for s in CONV_SHAPES])
def test_dequant_conv3x3_plain_matches_jax_interpret(shape, flavor):
    from fedcrack_tpu_torch.kernels import dequant

    skip_without_fp8(flavor)
    n, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape) * 5 + len(flavor))
    x = rng.normal(0, 1.0, (n, h, w, c)).astype(np.float32)
    want, q, scale = _jax_conv3x3(x, flavor, rng.normal(0, 0.1, (3, 3, c, f)).astype(np.float32))
    args = (torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale))
    plain = dequant._dequant_conv3x3_plain(*args)
    got = dequant.dequant_conv3x3(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, h, w, f)
    assert torch.equal(got, plain)  # the CPU takes the plain version
    assert np.all(np.abs(got.numpy() - want) <= scale + 1e-6)


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=[str(s) for s in CONV_SHAPES])
def test_emulated_conv_kernel_within_jax_bound(shape, flavor):
    """The conv kernel's order of K, (32-channel chunk, kh, kw, c) with the
    channels past C zero, under the kernel's arithmetic, stays within the
    JAX bound of the JAX conv."""
    skip_without_fp8(flavor)
    n, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape) * 3 + len(flavor))
    x = rng.normal(0, 1.0, (n, h, w, c)).astype(np.float32)
    want, q, scale = _jax_conv3x3(x, flavor, rng.normal(0, 0.1, (3, 3, c, f)).astype(np.float32))
    codes = _kernel_order_codes(to_torch_tree(q))
    got = _step_sums(_kernel_order_rows(torch.from_numpy(x)), codes, torch.from_numpy(scale))
    assert np.all(np.abs(got.reshape(n, h, w, f).numpy() - want) <= scale + 1e-6)


def test_kernel_order_is_a_permutation_of_the_taps():
    """The kernel's rows and codes hold every (tap, channel) product of the
    conv once, the zero pads aside: their product is the plain version's."""
    from fedcrack_tpu_torch.kernels import dequant

    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(2, 5, 6, 36)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 36, 7)).astype(np.int8))
    s = torch.ones(7)
    got = (_kernel_order_rows(x).double() @ _kernel_order_codes(q).double()).reshape(2, 5, 6, 7)
    want = dequant._dequant_conv3x3_plain(x, q, s).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
    order = _k_order(36, 32)
    assert sorted(k for k in order if k[1] >= 0) == [(tap, ch) for tap in range(9) for ch in range(36)]
    assert len(order) == _kernel_order_rows(x).shape[1]


@pytest.mark.parametrize("c", [4, 32, 36, 64, 256])
def test_conv_tile_plan_k_order_depends_on_c_alone(c):
    """What fixes an entry's sums, the chunk, is the same for every N, H, W
    and F: so is the K order. The rest of the plan follows the shape (the
    card's phase 3 holds an image alone to the same image in a batch of 8,
    whose plans differ, bit for bit)."""
    from fedcrack_tpu_torch.kernels.dequant import CONV_CHUNK, conv_tile_plan

    for f in (3, 17, 32, 64, 129, 256):
        plans = [conv_tile_plan(n, h, w, c, f) for n in (1, 2, 8) for h, w in ((1, 1), (16, 16), (33, 31), (128, 128))]
        assert {p.chunk for p in plans} == {CONV_CHUNK}
        assert len({tuple(_k_order(c, p.chunk)) for p in plans}) == 1
    # The tiles do change with the shape: narrower columns where a layer has few pixel tiles.
    assert conv_tile_plan(8, 16, 16, c, 256).bn == 32 and conv_tile_plan(8, 64, 64, c, 256).bn == 64
    assert conv_tile_plan(8, 128, 128, c, 32).tw == 16 and conv_tile_plan(1, 5, 7, c, 12).tw == 8


@pytest.mark.parametrize("shape", _card_conv_shapes(), ids=str)
def test_conv_units_cover_each_output_once_and_fit_shared_memory(shape):
    """Every output (pixel, channel) belongs to exactly one unit of one
    block, every block has work, and a block's shared memory fits the
    H100's 227 KB."""
    from fedcrack_tpu_torch.kernels.dequant import conv_smem_bytes, conv_tile_plan, conv_unit_origin

    n, h, w, c, f = shape
    plan = conv_tile_plan(n, h, w, c, f)
    count = np.zeros((n, h, w, f), np.int32)
    for block in range(plan.blocks):
        units = range(block, plan.units, plan.blocks)
        assert len(units) >= 1
        for unit in units:
            img, h0, w0, n0 = conv_unit_origin(plan, n, h, w, unit)
            assert 0 <= img < n and 0 <= h0 < h and 0 <= w0 < w and 0 <= n0 < f
            count[img, h0:h0 + plan.th, w0:w0 + plan.tw, n0:n0 + plan.bn] += 1
    assert (count == 1).all()
    assert plan.th * plan.tw in (64, 128) and 1 <= plan.stages <= 4
    assert plan.blocks == min(plan.units, 132)
    assert plan.smem == conv_smem_bytes(plan.th, plan.tw, plan.bn, plan.stages) <= 232_448


def test_conv_plan_mirrors_the_cuda_source():
    """dequant_conv.cu's constants and shared-memory layout are the plan's:
    the kernel refuses a plan whose bytes it computes otherwise."""
    from fedcrack_tpu_torch.kernels import dequant

    source = (CSRC / "dequant_conv.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))

    assert const("CHUNK") == dequant.CONV_CHUNK and const("HALO_ALIGN") == dequant._HALO_ALIGN
    assert const("MAX_STAGES") == dequant._CONV_MAX_STAGES and const("SMEM_LIMIT") == dequant._SMEM_PER_BLOCK
    assert re.search(r"constexpr int ROW_BYTES = CHUNK \* 2;", source) and dequant._ROW_BYTES == 64
    assert re.search(r"stages \* \(halo_bytes\(th, tw\) \+ codes_bytes\(bn\) \+ 16\) \+ "
                     r"3 \* plane_bytes\(th, tw\) \+ HALO_ALIGN", source)
    assert re.search(r"constexpr int TH = 8;", source) and re.search(r"constexpr int TW = 8 \* NC;", source)


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", CONV_SHAPES + [(3, 1, 1, 8, 70)], ids=str)
def test_halo_tile_emulation_equals_whole_image_bitwise(shape, flavor):
    """The kernel's tiles (grid, zero-filled halo boxes, tap windows) give
    bit for bit the sums of the whole image's rows: the halo's zeros are
    the SAME padding, and no tile changes an entry's order."""
    skip_without_fp8(flavor)
    n, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape) * 7 + len(flavor))
    x = torch.from_numpy(rng.normal(0, 1.0, (n, h, w, c)).astype(np.float32))
    q, scale = jax_leaf(flavor, rng.normal(0, 0.1, (3, 3, c, f)).astype(np.float32))
    q, scale = to_torch_tree(q), torch.from_numpy(np.asarray(scale))
    whole = _step_sums(_kernel_order_rows(x), _kernel_order_codes(q), scale).reshape(n, h, w, f)
    tiled = _emulated_conv_tiled(x, q, scale)
    assert torch.equal(tiled, whole)


@pytest.mark.parametrize("flavor", ["int8", "e4m3"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=[str(s) for s in SWEEP_SHAPES])
def test_emulated_matmul_kernel_within_jax_bound(shape, flavor):
    from fedcrack_tpu.kernels.dequant import dequant_matmul as jax_dequant_matmul

    skip_without_fp8(flavor)
    m, k, n = shape
    rng = np.random.default_rng(sum(shape) * 11 + len(flavor))
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    q, scale = jax_leaf(flavor, rng.normal(0, 0.1, (k, n)).astype(np.float32))
    want = np.asarray(jax_dequant_matmul(x, q, scale, impl="interpret"))
    got = _emulated_kernel(torch.from_numpy(x), to_torch_tree(q), torch.from_numpy(scale))
    assert np.all(np.abs(got.numpy() - want) <= scale[None, :] + 1e-6)


def test_every_code_is_exact_in_bf16():
    """The premise of the tensor-core design: every int8 code and every
    finite e4m3 code round-trips through bfloat16 unchanged."""
    ints = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(ints.to(torch.bfloat16).float(), ints.float())
    fp8 = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(torch.float8_e4m3fn).float()
    finite = fp8[torch.isfinite(fp8)]
    assert finite.numel() == 254  # e4m3fn: two NaN patterns, no infinity
    assert torch.equal(finite.to(torch.bfloat16).float(), finite)


def test_three_bf16_terms_reconstruct_f32():
    """hi + mid + lo carries x within 2^-24 |x| for normal f32 x over the
    activations' range (|x| in [2^-100, 2^100]), and each term is the
    rounding of what the ones before it left."""
    rng = np.random.default_rng(21)
    mant = rng.uniform(1.0, 2.0, 200_000)
    exp = rng.integers(-100, 100, 200_000)
    sign = rng.choice([-1.0, 1.0], 200_000)
    x = torch.from_numpy((sign * mant * np.exp2(exp)).astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, -1.0, 3.0e38 / 2**28, 1.1754944e-38 * 2**26,
                                    float(np.nextafter(np.float32(1), np.float32(2)))])])
    hi, mid, lo = _split3(x)
    back = hi.double() + mid.double() + lo.double()
    assert torch.all((back - x.double()).abs() <= 2.0**-24 * x.double().abs())
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert torch.equal(mid, (x - hi.float()).to(torch.bfloat16))


def test_dequant_conv3x3_validates_and_counts_no_cpu_launch():
    from fedcrack_tpu_torch.kernels import dequant

    x = torch.zeros(1, 4, 4, 8)
    q = torch.zeros(3, 3, 8, 5, dtype=torch.int8)
    s = torch.ones(5)
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(x, q, torch.ones(4))  # scale != F
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(x, torch.zeros(3, 3, 7, 5, dtype=torch.int8), s)  # C mismatch
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(x, torch.zeros(1, 1, 8, 5, dtype=torch.int8), s)  # not 3x3
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(x[0], q, s)  # not NHWC
    with pytest.raises(TypeError):
        dequant.dequant_conv3x3(x, q.to(torch.int32), s)
    with pytest.raises(TypeError):
        dequant.dequant_conv3x3(x.double(), q, s)
    with pytest.raises(ValueError):
        dequant.dequant_conv3x3(x.permute(0, 2, 1, 3), q, s)  # not contiguous
    # Off the CPU the kernel wants C % 4 == 0, and says so before anything else.
    with pytest.raises(ValueError, match="multiple of 4"):
        dequant.dequant_conv3x3(torch.zeros(1, 4, 4, 6, device="meta"),
                                torch.zeros(3, 3, 6, 5, dtype=torch.int8, device="meta"),
                                torch.ones(5, device="meta"))

    dequant.reset_launch_counts()
    dequant.dequant_conv3x3.launches = 3
    dequant.reset_launch_counts()
    assert dequant.dequant_conv3x3.launches == 0
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 6)).astype(np.float32))  # C = 6 is fine on the CPU
    q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 6, 4)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 4).astype(np.float32))
    assert torch.equal(dequant.dequant_conv3x3(x, q, s), dequant._dequant_conv3x3_plain(x, q, s))
    assert dequant.dequant_conv3x3.launches == 0


def test_fused_forward_sends_stride1_convs_to_dequant_conv3x3(monkeypatch):
    """Per forward: the stem, three GEMMs per encoder block, one residual per
    decoder block and the head through dequant_matmul; two convs per decoder
    block through dequant_conv3x3; the two depthwise stages of every
    encoder block through dequant_dwconv3x3, which expands their codes
    itself (no dequant_codes_group call)."""
    from fedcrack_tpu_torch.kernels import forward
    from fedcrack_tpu_torch.serve import quant as tq
    from torch_port_helpers import TWO_BLOCK_KW, jax_variables, port_config

    calls = {"dequant_matmul": 0, "dequant_conv3x3": 0, "dequant_dwconv3x3": 0}

    def counting(name):
        inner = getattr(forward, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return inner(*args, **kwargs)

        return wrapper

    for name in calls:
        monkeypatch.setattr(forward, name, counting(name))
    qtree = tq.quantize_variables(jax_variables(TWO_BLOCK_KW)).tree
    cfg = port_config(TWO_BLOCK_KW)
    forward.fused_predict_logits(qtree, torch.zeros(1, 32, 32, 3), cfg, forward.depthwise_group(qtree, cfg),
                                 forward.epilogue_plan(qtree, cfg))
    enc, dec = len(cfg.encoder_features), len(cfg.decoder_features)
    assert calls == {"dequant_matmul": 1 + 3 * enc + dec + 1, "dequant_conv3x3": 2 * dec,
                     "dequant_dwconv3x3": 2 * enc}
    assert not hasattr(forward, "dequant_codes_group")


def test_ab_conv_measures_on_the_card_only(monkeypatch, capsys):
    """The A/B tool refuses a host without a card (no time from the CPU),
    and its command line requires at least one checkout."""
    from fedcrack_tpu_torch.tools import ab_conv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card only"):
        ab_conv.run_tree()
    with pytest.raises(SystemExit):
        ab_conv.main([])
    assert "--tree" in capsys.readouterr().err
