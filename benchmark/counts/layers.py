"""Frozen work of each hand-written serving kernel family in one forward.

The fused int8 forward (``fedcrack_tpu_torch/kernels/forward.py``) runs
the 8 decoder 3x3 convs through ``dequant_conv3x3_kernel`` and 15 GEMMs
through ``dequant_matmul_kernel``: the stem (on its im2col patches), the
six encoder pointwise convs, the three encoder residual projections (on
the strided pixels), the four decoder residual projections and the head.
Each launch's work is counted once from its shapes, whatever implements
it: FLOPs are 2 per multiply-accumulate; bytes read each input once (the
float32 activation, the 1-byte codes, the float32 per-channel scales, the
epilogue's float32 vectors: the bias, and the BatchNorm's mean, scale and
shift where one follows, and the float32 residual where the epilogue adds
one) and write the float32 output once. A launch's least time is the
larger of FLOPs over the peak and bytes over the peak bandwidth.
"""

from __future__ import annotations

from benchmark.counts.flops import PEAK_BYTES_PER_S, PEAK_FLOPS


def _gemm(m: int, k: int, n: int, bn: bool, residual: bool) -> tuple[float, float]:
    vectors = 4 if bn else 1
    nbytes = 4 * m * k + k * n + 4 * n + 4 * vectors * n + (4 * m * n if residual else 0) + 4 * m * n
    return 2.0 * m * k * n, float(nbytes)


def _conv3x3(lanes: int, s: int, c: int, f: int) -> tuple[float, float]:
    nbytes = 4 * lanes * s * s * c + 9 * c * f + 4 * f + 4 * 4 * f + 4 * lanes * s * s * f
    return 2.0 * lanes * s * s * 9 * c * f, float(nbytes)


def launches(widths: dict, size: int, lanes: int) -> dict[str, list[tuple[float, float]]]:
    """``{"dequant_matmul": [(flops, bytes), ...], "dequant_conv3x3":
    [...]}`` for one forward of ``lanes`` images of ``size`` x ``size``."""
    gemm, conv = [], []
    s = size // 2
    c = widths["stem_features"]
    gemm.append(_gemm(lanes * s * s, 9 * widths["in_channels"], c, bn=True, residual=False))
    for f in widths["encoder_features"]:
        gemm.append(_gemm(lanes * s * s, c, f, bn=True, residual=False))
        gemm.append(_gemm(lanes * s * s, f, f, bn=True, residual=False))
        s //= 2
        gemm.append(_gemm(lanes * s * s, c, f, bn=False, residual=True))
        c = f
    for f in widths["decoder_features"]:
        conv.append(_conv3x3(lanes, s, c, f))
        conv.append(_conv3x3(lanes, s, f, f))
        gemm.append(_gemm(lanes * s * s, c, f, bn=False, residual=True))
        s *= 2
        c = f
    gemm.append(_gemm(lanes * (s // 2) ** 2, c, widths["num_classes"], bn=False, residual=False))
    return {"dequant_matmul": gemm, "dequant_conv3x3": conv}


def least_seconds(work: list[tuple[float, float]]) -> float:
    """The least time the card could take for these launches, each bound
    by the larger of its FLOPs and its bytes."""
    return sum(max(fl / PEAK_FLOPS, nb / PEAK_BYTES_PER_S) for fl, nb in work)
