"""Frozen FLOP count of SegFormer.

``segformer_forward_flops`` and ``segformer_train_step_flops`` are a
frozen copy of ``fedcrack_tpu_torch/obs/flops.py``'s (equal to
``torch.utils.flop_counter.FlopCounterMode`` on the forward):
matmul-equivalent FLOPs of the convolutions, the Linear layers and the
attention's two batched products, 2 per multiply-accumulate, a train step
three forwards. The peak is ``benchmark/counts/flops.py``'s.
"""

from __future__ import annotations

from benchmark.counts.flops import TRAIN_STEP_FLOPS_MULTIPLIER

PATCH_KERNELS = (7, 3, 3, 3)
PATCH_STRIDES = (4, 2, 2, 2)


def _conv_flops(out_hw: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * out_hw * out_hw * c_out * (k * k * c_in)


def segformer_forward_flops(model: dict, img_size: int, batch_size: int = 1) -> float:
    """``model`` holds ``embed_dims``, ``depths``, ``sr_ratios``,
    ``mlp_ratio``, ``decoder_dim``, ``in_channels`` and ``num_classes``."""
    total = 0.0
    s, cin = img_size, model["in_channels"]
    grids = []
    for i, dim in enumerate(model["embed_dims"]):
        s //= PATCH_STRIDES[i]
        n = s * s
        total += _conv_flops(s, cin, dim, PATCH_KERNELS[i])
        sr = model["sr_ratios"][i]
        m = n // (sr * sr)
        hidden = dim * model["mlp_ratio"]
        block = 2.0 * n * dim * dim
        if sr > 1:
            block += _conv_flops(s // sr, dim, dim, sr)
        block += 2.0 * m * dim * 2 * dim
        block += 2.0 * 2.0 * n * m * dim
        block += 2.0 * n * dim * dim
        block += 2.0 * 2.0 * n * dim * hidden
        block += 2.0 * n * hidden * 9
        total += model["depths"][i] * block
        grids.append((n, dim))
        cin = dim
    d = model["decoder_dim"]
    total += sum(2.0 * n * dim * d for n, dim in grids)
    n1 = grids[0][0]
    total += 2.0 * n1 * 4 * d * d
    total += 2.0 * n1 * d * model["num_classes"]
    return total * float(batch_size)


def segformer_train_step_flops(model: dict, img_size: int, batch_size: int) -> float:
    return TRAIN_STEP_FLOPS_MULTIPLIER * segformer_forward_flops(model, img_size, batch_size)
