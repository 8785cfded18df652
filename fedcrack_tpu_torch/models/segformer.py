"""SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203) as a PyTorch
module: the Mix Transformer encoder and the All-MLP head.

The architecture is NVlabs/SegFormer's ``mmseg/models/backbones/
mix_transformer.py`` (``mit_b5`` by default) and ``mmseg/models/
decode_heads/segformer_head.py``, at the widths of
:class:`~fedcrack_tpu_torch.configs.SegFormerConfig`:

- four stages, each an overlapping patch embedding (a conv of kernel 7,
  stride 4, padding 3 on the image; kernel 3, stride 2, padding 1 after;
  then a LayerNorm of eps 1e-5), its blocks and a closing LayerNorm (eps
  1e-6);
- a block is ``x += proj(attn(norm1(x)))`` then ``x += fc2(gelu(
  dwconv(fc1(norm2(x)))))``, its two LayerNorms of eps 1e-6, ``dwconv`` a
  3x3 depthwise conv with bias over the token grid, GELU the exact (erf)
  one;
- the efficient self-attention takes queries from all N tokens and keys
  and values from the tokens reduced by a conv of kernel and stride
  ``sr`` and a LayerNorm (eps 1e-5; neither at ``sr`` 1), scale
  ``head_dim ** -0.5`` (``ops.attention``);
- the head maps each stage to ``decoder_dim`` by a Linear, resizes each
  bilinearly to 1/4 (``align_corners=False``), concatenates them as c4,
  c3, c2, c1, fuses them by a 1x1 conv without bias, BatchNorm (PyTorch's
  eps 1e-5 and momentum 0.1) and ReLU, and predicts ``num_classes``
  logits by a 1x1 conv.

Stochastic depth and the head's dropout are taken at 0: both draw random
masks that no seeded reference could follow. The logits come back at the
input's size (the loss is taken on the logits resized bilinearly to the
label's size, as mmseg's losses do), NHWC ``[N, H, W, num_classes]``,
the contract ``ResUNet`` keeps, so the train step, the loss and the metrics
are the same for both models.

Parameter names map one to one onto a flax-layout tree
(``models/convert.py``): a conv's ``weight`` is an HWIO ``kernel``, a
Linear's ``[out, in]`` ``weight`` an ``[in, out]`` ``kernel``, a
LayerNorm holds ``scale`` and ``bias``, the BatchNorm ``scale``, ``bias``
and the running ``mean`` and ``var``. Module names follow the published
code, flattened the way flax names submodules: ``patch_embed1.proj``,
``block1_0.attn.q``, ``block3_39.mlp.dwconv``, ``norm4``,
``head.linear_c4``, ``head.linear_fuse``, ``head.bn``, ``head.linear_pred``.

The bilinear resizes are written as sums of shifted slices
(:func:`upsample`), not ``F.interpolate``: on the card the latter's
backward adds with atomics, in no fixed order, and the repository's
training is bitwise repeatable. Every resize here enlarges by an integer
factor, where bilinear interpolation is a two-tap filter per output phase.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedcrack_tpu_torch.configs import SegFormerConfig
from fedcrack_tpu_torch.models.resunet import BatchNorm
from fedcrack_tpu_torch.ops.attention import spatial_reduction_attention

PATCH_KERNELS = (7, 3, 3, 3)
PATCH_STRIDES = (4, 2, 2, 2)
PATCH_EPS = 1e-5        # OverlapPatchEmbed's nn.LayerNorm default
BLOCK_EPS = 1e-6        # mit_b5's norm_layer=partial(nn.LayerNorm, eps=1e-6)
SR_EPS = 1e-5           # Attention's nn.LayerNorm default
BN_EPS = 1e-5           # the head's BatchNorm (PyTorch's default)
# PyTorch's momentum 0.1 in the port's convention: running = m * running + (1 - m) * batch.
BN_MOMENTUM = 0.9
LINEAR_STD = 0.02       # trunc_normal_(std=.02) of the published init


def _upsample_axis(x: torch.Tensor, dim: int, s: int) -> torch.Tensor:
    """Bilinear (``align_corners=False``) enlargement of ``x`` by the
    integer ``s`` along ``dim``: output ``s * i + r`` sits at source
    ``i + d_r``, ``d_r = (r + 0.5) / s - 0.5``, between two neighbours of
    the edge-clamped input."""
    n = x.shape[dim]
    padded = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)  # padded[j] = x[clamp(j - 1)]
    phases = []
    for r in range(s):
        d = (r + 0.5) / s - 0.5
        lo = 1 if d >= 0 else 0
        phases.append(torch.lerp(padded.narrow(dim, lo, n), padded.narrow(dim, lo + 1, n), d if d >= 0 else 1.0 + d))
    return torch.stack(phases, dim + 1).flatten(dim, dim + 1)


def upsample(x: torch.Tensor, factor: int, dims: tuple[int, int]) -> torch.Tensor:
    """``x`` enlarged bilinearly by ``factor`` along both spatial ``dims``."""
    if factor == 1:
        return x
    return _upsample_axis(_upsample_axis(x, dims[0], factor), dims[1], factor)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis under flax's names (``scale``,
    ``bias``)."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class BatchNorm2d(BatchNorm):
    """The head's BatchNorm with PyTorch's semantics under flax's names:
    eps 1e-5, batch moments by ``torch.var_mean`` in training, the running
    variance updated with the unbiased batch variance, momentum 0.1 (0.9
    in the port's convention, which a momentum of 0 turns into storing the
    batch's moments)."""

    def forward(self, x: torch.Tensor, moments=None) -> torch.Tensor:  # NCHW
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            count = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var * (count / max(count - 1, 1)))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, H*W, C]`` (a view where ``x`` is
    channels-last)."""
    return x.flatten(2).transpose(1, 2)


def _grid(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, H*W, C]`` -> ``[B, C, H, W]`` (a view, channels-last where
    ``x`` is contiguous)."""
    return x.reshape(x.shape[0], h, w, x.shape[2]).permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    """Overlapping patch embedding: conv, then LayerNorm over tokens."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)
        self.norm = LayerNorm(cout, PATCH_EPS)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.norm(_tokens(x)), h, w


class Attention(nn.Module):
    """Efficient self-attention with spatial reduction ``sr``."""

    def __init__(self, dim: int, heads: int, sr: int, stage: int):
        super().__init__()
        self.heads, self.sr_ratio, self.stage = heads, sr, stage
        self.scale = (dim // heads) ** -0.5
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
            self.norm = LayerNorm(dim, SR_EPS)

    def reduce(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """The ``sr`` conv (kernel and stride ``sr``, so its windows tile
        the grid) as the product it is: each window's tokens, in the
        kernel's (row, column, channel) order, times the HWIO kernel."""
        b, _, c = x.shape
        s = self.sr_ratio
        windows = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, s * s * c)
        return F.linear(windows, self.sr.weight.permute(0, 2, 3, 1).reshape(c, s * s * c), self.sr.bias)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, d).permute(0, 2, 1, 3)
        if self.sr_ratio > 1:
            x = self.norm(self.reduce(x, h, w))
        k, v = self.kv(x).reshape(b, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        out = spatial_reduction_attention(q, k, v, self.scale, self.stage)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    """``fc2(gelu(dwconv(fc1(x))))``, the depthwise conv over the grid."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return self.fc2(F.gelu(_tokens(self.dwconv(_grid(self.fc1(x), h, w)))))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr: int, stage: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, BLOCK_EPS)
        self.attn = Attention(dim, heads, sr, stage)
        self.norm2 = LayerNorm(dim, BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class Head(nn.Module):
    """The All-MLP decoder on the four stages' NCHW maps."""

    def __init__(self, dims: tuple[int, ...], width: int, num_classes: int):
        super().__init__()
        for i in (4, 3, 2, 1):
            self.add_module(f"linear_c{i}", nn.Linear(dims[i - 1], width))
        self.linear_fuse = nn.Conv2d(4 * width, width, 1, bias=False)
        self.bn = BatchNorm2d(width, BN_MOMENTUM)
        self.linear_pred = nn.Conv2d(width, num_classes, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """The four ``[B, C, H, W]`` maps to ``[B, H/4, W/4, classes]``
        logits: NHWC throughout, the 1x1 convs as the per-pixel products
        they are."""
        h, w = feats[0].shape[2:]
        maps = []
        for i in (4, 3, 2, 1):
            f = feats[i - 1]
            t = self.get_submodule(f"linear_c{i}")(_tokens(f))
            t = t.reshape(f.shape[0], f.shape[2], f.shape[3], t.shape[2])
            maps.append(upsample(t, h // f.shape[2], (1, 2)))
        x = F.linear(torch.cat(maps, dim=3), self.linear_fuse.weight.flatten(1))
        x = torch.relu(self.bn(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        return F.linear(x, self.linear_pred.weight.flatten(1), self.linear_pred.bias)


class SegFormer(nn.Module):
    """Per-pixel logits ``[N, H, W, num_classes]`` from NHWC float images.

    The constructor builds the layers without drawing weights; pass a
    ``generator`` to draw the published initial values (Linear weights,
    and the classifier's, a per-pixel Linear, truncated normal of std
    0.02, conv weights normal of variance 2 / fan-out, zero biases,
    LayerNorm and BatchNorm at 1 and 0), or load
    weights with ``models.convert.from_flax_variables``. The module is
    placed on ``device``, CUDA unless the caller names another (``"cpu"``,
    or ``"meta"``); it raises where CUDA is asked for and absent. It
    starts in eval mode; ``model.train()`` runs the head's BatchNorm on
    batch moments."""

    def __init__(
        self,
        config: SegFormerConfig | None = None,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        cfg = config or SegFormerConfig()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SegFormer defaults to device='cuda' and no CUDA device is "
                "available; pass device='cpu' explicitly to run on the CPU"
            )
        self.config = cfg
        with torch.device("meta"):
            cin = cfg.in_channels
            for i, dim in enumerate(cfg.embed_dims):
                s = i + 1
                self.add_module(f"patch_embed{s}", PatchEmbed(cin, dim, PATCH_KERNELS[i], PATCH_STRIDES[i]))
                for j in range(cfg.depths[i]):
                    self.add_module(f"block{s}_{j}", Block(dim, cfg.num_heads[i], cfg.mlp_ratio, cfg.sr_ratios[i], s))
                self.add_module(f"norm{s}", LayerNorm(dim, BLOCK_EPS))
                cin = dim
            self.head = Head(tuple(cfg.embed_dims), cfg.decoder_dim, cfg.num_classes)
        self.to_empty(device=device)
        if generator is not None:
            self.reset_parameters(generator)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The published initial values, drawn on the CPU from
        ``generator`` in module order (one seed, the same weights on any
        device)."""
        for module in self.modules():
            if isinstance(module, nn.Linear) or module is self.head.linear_pred:
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, std=LINEAR_STD, a=-2 * LINEAR_STD, b=2 * LINEAR_STD, generator=generator)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, nn.Conv2d) and module is not self.head.linear_pred:
                o, _, kh, kw = module.weight.shape
                fan_out = kh * kw * o // module.groups
                module.weight.copy_(torch.empty(module.weight.shape).normal_(0.0, math.sqrt(2.0 / fan_out),
                                                                             generator=generator))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (LayerNorm, BatchNorm)):
                module.scale.fill_(1.0)
                module.bias.zero_()
                if isinstance(module, BatchNorm):
                    module.mean.zero_()
                    module.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h, w = x.shape[1:3]
        x = x.to(torch.float32).permute(0, 3, 1, 2)                # channels-last NCHW
        feats = []
        for i in range(len(cfg.embed_dims)):
            s = i + 1
            x, gh, gw = self.get_submodule(f"patch_embed{s}")(x)
            for j in range(cfg.depths[i]):
                x = self.get_submodule(f"block{s}_{j}")(x, gh, gw)
            x = _grid(self.get_submodule(f"norm{s}")(x), gh, gw)
            feats.append(x)
        logits = self.head(feats)                                  # [N, H/4, W/4, classes]
        return upsample(logits, h // logits.shape[1], (1, 2))


def init_variables(generator: torch.Generator, config: SegFormerConfig | None = None) -> dict:
    """Initial ``{'params', 'batch_stats'}`` tree (numpy, flax layout)
    drawn from ``generator`` on the host."""
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    return to_flax_variables(SegFormer(config, generator=generator, device="cpu"))
