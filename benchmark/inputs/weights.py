"""Seeded weights for the crack U-Net, made on the device.

One ``torch.rand`` call on a generator seeded with ``--seed`` draws every
value of the tree; each leaf is then an affine map of its slice: kernels
Glorot-uniform (flax's default initializer, fan-in and fan-out over the
HWIO kernel), conv biases in +-0.1, BatchNorm scales in [0.75, 1.25],
BatchNorm biases and running means in +-0.1 and running variances in
[0.75, 1.25], so that every bias, BatchNorm and residual step of the
forward does work.

:func:`snap_to_int8_grid` puts every kernel (each params leaf of two or
more axes) on the symmetric per-output-channel int8 grid: scale =
max|w| / 127 over all axes but the last (1.0 for an all-zero channel),
codes ``round_half_even(w / scale)`` clipped to +-127, weights ``code *
scale``. A frozen copy of the port's quantizer
(``fedcrack_tpu_torch/serve/quant.py``, ``quantize_leaf`` then
``dequantize_variables``), so that quantizing the snapped weights again is
exact and serving measures the kernels, not the rounding of the weights.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import resunet


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw_variables(seed: int, widths: dict, device) -> dict:
    """The flax-layout ``{"params", "batch_stats"}`` tree of float32
    tensors on ``device``; ``widths`` holds ``stem_features``,
    ``encoder_features``, ``decoder_features``, ``in_channels`` and
    ``num_classes``."""
    specs = resunet.leaf_specs(widths["stem_features"], tuple(widths["encoder_features"]),
                               tuple(widths["decoder_features"]), widths["in_channels"], widths["num_classes"])
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=generator(seed, device), device=device, dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, shape, kind in specs:
        n = math.prod(shape)
        v = u[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            kh, kw, cin, cout = shape
            limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
            v = (2.0 * v - 1.0) * limit
        elif kind in ("bias", "bn_bias", "bn_mean"):
            v = (2.0 * v - 1.0) * 0.1
        else:  # bn_scale, bn_var
            v = 0.75 + 0.5 * v
        resunet.set_leaf(tree, path, v.contiguous())
    return tree


def snap_to_int8_grid(variables: dict) -> dict:
    def walk(node, in_params):
        if isinstance(node, dict):
            return {k: walk(v, in_params or k == "params") for k, v in node.items()}
        if not in_params or node.ndim < 2:
            return node
        absmax = node.abs().amax(dim=tuple(range(node.ndim - 1)))
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        return torch.clamp(torch.round(node / scale), -127, 127) * scale

    return walk(variables, False)
