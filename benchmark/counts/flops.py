"""Frozen FLOP counts of the crack U-Net and the card's peaks.

``resunet_forward_flops`` and ``train_step_flops`` are a frozen copy of
``fedcrack_tpu_torch/obs/flops.py`` (equal to the JAX package's model and
to ``torch.utils.flop_counter.FlopCounterMode`` on the eval forward):
matmul-equivalent FLOPs of the convolutions, 2 per multiply-accumulate, on
the reference topology, a train step three forwards.

The peaks are NVIDIA's H100 SXM data-sheet figures at its 700 W limit:
989.4 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM3. Every
share of a peak in this benchmark is taken against them, whatever the
precision of the kernel, with the card's power limit reported beside it.
"""

from __future__ import annotations

PEAK_FLOPS = 989.4e12
PEAK_BYTES_PER_S = 3.35e12
TRAIN_STEP_FLOPS_MULTIPLIER = 3.0


def _conv_flops(out_hw: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * out_hw * out_hw * c_out * (k * k * c_in)


def resunet_forward_flops(widths: dict, img_size: int, batch_size: int = 1) -> float:
    s = img_size // 2
    c = widths["stem_features"]
    total = _conv_flops(s, widths["in_channels"], c, 3)
    for feat in widths["encoder_features"]:
        total += 2.0 * s * s * c * 9
        total += _conv_flops(s, c, feat, 1)
        total += 2.0 * s * s * feat * 9
        total += _conv_flops(s, feat, feat, 1)
        s //= 2
        total += _conv_flops(s, c, feat, 1)
        c = feat
    for feat in widths["decoder_features"]:
        total += _conv_flops(s, c, feat, 3)
        total += _conv_flops(s, feat, feat, 3)
        total += _conv_flops(s, c, feat, 1)
        s *= 2
        c = feat
    total += _conv_flops(s // 2, c, widths["num_classes"], 1)
    return total * float(batch_size)


def train_step_flops(widths: dict, img_size: int, batch_size: int) -> float:
    return TRAIN_STEP_FLOPS_MULTIPLIER * resunet_forward_flops(widths, img_size, batch_size)
