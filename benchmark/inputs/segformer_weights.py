"""Seeded weights for SegFormer, made on the device.

One ``torch.rand`` call on a generator seeded with ``--seed`` draws every
value of the tree; each leaf is then an affine map of its slice, with the
standard deviation of the published initialization where that is random
and a spread around it where it is constant, so that every bias, norm and
residual of the forward does work: Linear kernels (and the classifier's
1x1 kernel, a per-pixel Linear) uniform with standard deviation 0.02 (the
published truncated normal's), conv kernels uniform
with variance 2 / fan-out (fan-out ``k * k * out / groups``, the published
normal's), biases in +-0.02, LayerNorm and BatchNorm scales in [0.75,
1.25], their biases and the running means in +-0.1 and the running
variances in [0.75, 1.25].
"""

from __future__ import annotations

import math

import torch

from benchmark.inputs.weights import generator
from benchmark.reference import segformer

LINEAR_STD = 0.02
BIAS_SPREAD = 0.02


def leaf_specs(model: dict) -> list:
    """The tree's leaves for a configuration's ``model`` block."""
    return segformer.leaf_specs(tuple(model["embed_dims"]), tuple(model["depths"]), tuple(model["sr_ratios"]),
                                model["mlp_ratio"], model["decoder_dim"], model["in_channels"],
                                model["num_classes"])


def draw_variables(seed: int, model: dict, device) -> dict:
    """The flax-layout ``{"params", "batch_stats"}`` tree of float32
    tensors on ``device`` for a configuration's ``model`` block."""
    specs = leaf_specs(model)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=generator(seed, device), device=device, dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, shape, kind in specs:
        n = math.prod(shape)
        v = 2.0 * u[at:at + n].view(shape) - 1.0     # uniform in [-1, 1): standard deviation 1 / sqrt(3)
        at += n
        if kind == "dense":
            v = v * (math.sqrt(3.0) * LINEAR_STD)
        elif kind == "conv":
            kh, kw, cin_g, cout = shape
            groups = cout if cin_g == 1 and cout > 1 else 1
            v = v * math.sqrt(3.0 * 2.0 / (kh * kw * cout / groups))
        elif kind == "bias":
            v = v * BIAS_SPREAD
        elif kind in ("ln_bias", "bn_bias", "bn_mean"):
            v = v * 0.1
        else:  # ln_scale, bn_scale, bn_var
            v = 1.0 + 0.25 * v
        segformer.set_leaf(tree, path, v.contiguous())
    return tree
