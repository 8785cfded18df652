"""The crack-segmentation residual U-Net in plain float32 PyTorch.

The published model is the Keras residual U-Net of the reference
repository's ``client_fit_model.py`` (stem 32, encoder 64/128/256 of two
separable convs, a 3x3 stride-2 max pool and a strided 1x1 residual each,
decoder 256/128/64/32 of two 3x3 convs and a 1x1 residual each, a 1x1
head). This file writes it as functions over a flax-layout variables tree
(``{"params": ..., "batch_stats": ...}``, HWIO kernels), so that it reads
the same weights the program is handed and nothing the program made.

Departures from the Keras graph, each exact in real arithmetic:

- the decoder's residual 1x1 conv and the head run before the nearest x2
  upsample instead of after it (a 1x1 conv commutes with it);
- "same" padding follows XLA: a stride-2 window on an even grid pads 0
  before and 1 after.

BatchNorm is Keras's: ``(x - mean) * scale / sqrt(var + 1e-3) + bias``; in
training the moments are the batch's (biased variance, two-pass) and the
running statistics move by momentum 0.99.

``tf32=True`` rounds both operands of every convolution to TF32 (10
mantissa bits) and accumulates in float32, forward and backward: the
reference computed one precision below the float32 (TF32 off) that the
configurations state. It is the comparison's control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99


def leaf_specs(stem: int, encoder: tuple, decoder: tuple, in_channels: int = 3,
               num_classes: int = 1) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """Every leaf of the variables tree as ``(path, shape, kind)``; kind is
    ``kernel``, ``bias``, ``bn_scale``, ``bn_bias``, ``bn_mean`` or
    ``bn_var``. The order is the tree's."""
    specs: list = []
    stats: list = []

    def conv(name, k, cin, cout, bias=True, sub=None):
        path = ("params", name) if sub is None else ("params", name, sub)
        specs.append((path + ("kernel",), (k, k, cin, cout), "kernel"))
        if bias:
            specs.append((path + ("bias",), (cout,), "bias"))

    def bn(name, c):
        specs.append((("params", name, "scale"), (c,), "bn_scale"))
        specs.append((("params", name, "bias"), (c,), "bn_bias"))
        stats.append((("batch_stats", name, "mean"), (c,), "bn_mean"))
        stats.append((("batch_stats", name, "var"), (c,), "bn_var"))

    conv("stem_conv", 3, in_channels, stem)
    bn("stem_bn", stem)
    cin = stem
    for i, f in enumerate(encoder):
        for j, c in ((1, cin), (2, f)):
            specs.append((("params", f"enc{i}_sep{j}", "depthwise", "kernel"), (3, 3, 1, c), "kernel"))
            conv(f"enc{i}_sep{j}", 1, c, f, sub="pointwise")
            bn(f"enc{i}_bn{j}", f)
        conv(f"enc{i}_res", 1, cin, f)
        cin = f
    prev = cin
    for i, f in enumerate(decoder):
        conv(f"dec{i}_convT1", 3, cin, f)
        bn(f"dec{i}_bn1", f)
        conv(f"dec{i}_convT2", 3, f, f)
        bn(f"dec{i}_bn2", f)
        conv(f"dec{i}_res", 1, prev, f)
        cin = prev = f
    conv("head", 1, cin, num_classes)
    return specs + stats


def get(tree: dict, path: tuple) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree


def set_leaf(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 value (10 mantissa bits, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, groups):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.stride, ctx.groups = stride, groups
        return F.conv2d(xr, wr, None, stride, 0, 1, groups)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, ctx.stride, 0, 1, ctx.groups)
        gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, ctx.stride, 0, 1, ctx.groups)
        return gx, gw, None, None


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *, stride: int = 1,
         groups: int = 1, tf32: bool = False) -> torch.Tensor:
    """NCHW conv with an HWIO kernel and no padding (the callers pad)."""
    w = kernel.permute(3, 2, 0, 1)
    y = _Tf32Conv.apply(x, w, stride, groups) if tf32 else F.conv2d(x, w, None, stride, 0, 1, groups)
    return y if bias is None else y + bias[:, None, None]


def batch_norm(x: torch.Tensor, p: dict, s: dict, train: bool, new_stats: dict | None, name: str) -> torch.Tensor:
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        new_stats[name] = {
            "mean": BN_MOMENTUM * s["mean"] + (1.0 - BN_MOMENTUM) * mean.detach(),
            "var": BN_MOMENTUM * s["var"] + (1.0 - BN_MOMENTUM) * var.detach(),
        }
    else:
        mean, var = s["mean"], s["var"]
    return (x - mean[:, None, None]) * (p["scale"] / torch.sqrt(var + BN_EPSILON))[:, None, None] \
        + p["bias"][:, None, None]


def _pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 "same" max pool, the pad cells -inf."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


def _up(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def forward(variables: dict, images: torch.Tensor, *, train: bool = False,
            tf32: bool = False) -> tuple[torch.Tensor, dict | None]:
    """Logits ``[N, H, W, 1]`` of float32 NHWC images in [0, 1]. In
    training (``train=True``) also the new ``batch_stats`` tree."""
    # Float32 products: TF32 off for cuDNN's convolutions and cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p, s = variables["params"], variables["batch_stats"]
    encoder = sum(1 for k in p if k.startswith("enc") and k.endswith("_res"))
    decoder = sum(1 for k in p if k.startswith("dec") and k.endswith("_res"))
    stats: dict | None = {} if train else None

    def cv(x, name, stride=1, groups=1):
        return conv(x, p[name]["kernel"], p[name].get("bias"), stride=stride, groups=groups, tf32=tf32)

    def bn(x, name):
        return batch_norm(x, p[name], s[name], train, stats, name)

    x = images.permute(0, 3, 1, 2).contiguous()
    x = torch.relu(bn(cv(F.pad(x, (0, 1, 0, 1)), "stem_conv", stride=2), "stem_bn"))
    previous = x
    for i in range(encoder):
        for j in (1, 2):
            sep = p[f"enc{i}_sep{j}"]
            x = torch.relu(x)
            x = conv(F.pad(x, (1, 1, 1, 1)), sep["depthwise"]["kernel"], groups=x.shape[1], tf32=tf32)
            x = conv(x, sep["pointwise"]["kernel"], sep["pointwise"]["bias"], tf32=tf32)
            x = bn(x, f"enc{i}_bn{j}")
        x = _pool(x) + cv(previous, f"enc{i}_res", stride=2)
        previous = x
    for i in range(decoder):
        x = bn(cv(F.pad(torch.relu(x), (1, 1, 1, 1)), f"dec{i}_convT1"), f"dec{i}_bn1")
        x = bn(cv(F.pad(torch.relu(x), (1, 1, 1, 1)), f"dec{i}_convT2"), f"dec{i}_bn2")
        x = x + cv(previous, f"dec{i}_res")
        if i + 1 < decoder:
            x = _up(x)
            previous = x
    logits = _up(cv(x, "head")).permute(0, 2, 3, 1)
    if train:
        return logits, {**s, **stats}
    return logits, None


def probabilities(variables: dict, images_u8: torch.Tensor, *, tf32: bool = False, block: int = 32) -> torch.Tensor:
    """Sigmoid probabilities ``[N, H, W, 1]`` of uint8 NHWC images, the
    forward run ``block`` images at a time."""
    out = []
    with torch.no_grad():
        for i in range(0, images_u8.shape[0], block):
            x = images_u8[i:i + block].to(torch.float32) / 255.0
            out.append(torch.sigmoid(forward(variables, x, tf32=tf32)[0]))
    return torch.cat(out)
