"""The fused 3x3 conv of the port (``dequant_conv3x3``) and the arithmetic of
the tensor-core dequant kernels (fedcrack_tpu_torch/kernels/csrc/dequant.cu),
held against the JAX package on the CPU.

On the CPU the wrapper takes its plain version (F.pad + F.unfold into the
plain matmul); it is held against the JAX ``_conv3x3`` run as the JAX tests
run it (``impl="interpret"``). The CUDA kernels cannot run here, so their
arithmetic is held by a plain-torch emulation kept in this file and used by
nothing in the package: the f32 activation split into three bf16 terms,
each term times the bf16 codes accumulated in f32 per 16-deep K step (lo,
mid, hi), the scale applied once; for the conv, K in the kernel's
``(kh, kw, c)`` order. On the card chip_smoke.py holds the kernels against
the plain versions.

Tolerances: per entry within one per-channel scale + 1e-6, the JAX bound
(both sides sum the same products in different orders and apply the scale
before vs after the sum); the split reconstructs x within 2^-24 |x|.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import SWEEP_SHAPES, jax_leaf, skip_without_fp8, to_torch_tree

pytestmark = pytest.mark.torch_port

# (N, H, W, C, F): odd and non-square grids, ragged C and F, a 1x1 image.
CONV_SHAPES = [(1, 5, 7, 8, 12), (2, 6, 6, 4, 9), (1, 3, 4, 6, 5), (2, 7, 5, 16, 33), (1, 1, 1, 4, 3)]


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


def _kernel_order_rows(x: torch.Tensor) -> torch.Tensor:
    """The conv kernel's A rows: output pixels, K ordered (kh, kw, c)."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, kh:kh + h, kw:kw + w, :] for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=-1).reshape(n * h * w, 9 * c)


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
    """The conv kernel's order of K, (kh, kw, c) with the codes as
    q.reshape(9C, F), under the kernel's arithmetic, stays within the JAX
    bound of the JAX conv."""
    skip_without_fp8(flavor)
    n, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape) * 3 + len(flavor))
    x = rng.normal(0, 1.0, (n, h, w, c)).astype(np.float32)
    want, q, scale = _jax_conv3x3(x, flavor, rng.normal(0, 0.1, (3, 3, c, f)).astype(np.float32))
    codes = to_torch_tree(q).reshape(9 * c, f)
    got = _emulated_kernel(_kernel_order_rows(torch.from_numpy(x)), codes, torch.from_numpy(scale))
    assert np.all(np.abs(got.reshape(n, h, w, f).numpy() - want) <= scale + 1e-6)


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
    block through dequant_conv3x3; the two depthwise kernels of every
    encoder block expanded by one dequant_codes_group call."""
    from fedcrack_tpu_torch.kernels import forward
    from fedcrack_tpu_torch.serve import quant as tq
    from torch_port_helpers import TWO_BLOCK_KW, jax_variables, port_config

    calls = {"dequant_matmul": 0, "dequant_conv3x3": 0, "dequant_codes_group": 0}

    def counting(name):
        inner = getattr(forward, name)

        def wrapper(*args):
            calls[name] += 1
            return inner(*args)

        return wrapper

    for name in calls:
        monkeypatch.setattr(forward, name, counting(name))
    qtree = tq.quantize_variables(jax_variables(TWO_BLOCK_KW)).tree
    cfg = port_config(TWO_BLOCK_KW)
    forward.fused_predict_logits(qtree, torch.zeros(1, 32, 32, 3), cfg, forward.depthwise_group(qtree, cfg))
    enc, dec = len(cfg.encoder_features), len(cfg.decoder_features)
    assert calls == {"dequant_matmul": 1 + 3 * enc + dec + 1, "dequant_conv3x3": 2 * dec,
                     "dequant_codes_group": 1}
