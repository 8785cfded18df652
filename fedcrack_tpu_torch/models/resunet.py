"""The crack-segmentation residual U-Net as a PyTorch module.

The counterpart of ``fedcrack_tpu.models.resunet.ResUNet`` for the
``"reference"`` stem and residual layouts, with the flax module names
(``stem_conv``, ``enc{i}_sep1.depthwise``, ``dec{i}_convT1``, ``head``...),
so ``models/convert.py`` maps a flax variables tree onto it name for name.
Its convs are ``F.conv2d``, as the JAX package leaves its convs to XLA.

Parity points with flax, each pinned by tests/test_torch_model.py and
tests/test_torch_train.py:

- ``"SAME"`` padding follows XLA: at stride 2 on an even grid it pads 0
  before and 1 after, so the stem pads explicitly (``nn.Conv2d(padding=1)``
  would shift the sampling grid by one pixel).
- A 3x3 stride-1 SAME flax ``ConvTranspose`` computes the plain SAME conv of
  the same, unflipped kernel, so the decoder uses ``nn.Conv2d`` with that
  kernel; ``nn.ConvTranspose2d`` would flip it.
- The encoder residual 1x1 stride-2 SAME conv reads ``x[:, ::2, ::2]``.
- BatchNorm normalizes as ``(x - mean) * (scale * rsqrt(var + 1e-3)) +
  bias``, flax's order of operations (Keras epsilon 1e-3). In train mode
  (``model.train()``) the moments are the batch's, in float32 over
  (N, H, W) with ``var = mean(x^2) - mean(x)^2`` clipped at 0 (flax's fast
  variance, not torch's Welford), gradients flow through both, and the
  running statistics update as ``m * running + (1 - m) * batch`` with the
  BIASED batch variance (``F.batch_norm`` would store the unbiased one).
- The encoder pool's gradient is the JAX package's (``ops/pooling.py``).
- The decoder residual conv and the head run at the low resolution, before
  the upsample they commute with; the head computes in float32.

Inputs and outputs are NHWC, the JAX layout; inside, the module runs NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.ops.pooling import max_pool_auto, same_pads

# Keras BatchNormalization defaults (the reference relies on them).
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling on NHWC (Keras ``UpSampling2D(2)``)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _upsample2x_nchw(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def _pad_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor the way XLA ``"SAME"`` does."""
    _, lo_h, hi_h = same_pads(x.shape[2], window, stride)
    _, lo_w, hi_w = same_pads(x.shape[3], window, stride)
    return F.pad(x, (lo_w, hi_w, lo_h, hi_h))


def _conv(cin: int, cout: int, k: int, *, stride: int = 1, groups: int = 1, bias: bool = True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=0, groups=groups, bias=bias)


class BatchNorm(nn.Module):
    """BatchNorm holding flax's names: ``scale``/``bias`` parameters,
    ``mean``/``var`` running statistics; flax's semantics in both modes."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class SeparableConv(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1, Keras ``SeparableConv2D``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.depthwise = _conv(in_features, in_features, 3, groups=in_features, bias=False)
        self.pointwise = _conv(in_features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return self.pointwise(self.depthwise(_pad_same(x, 3, 1)))


class ResUNet(nn.Module):
    """Per-pixel logits ``[N, H, W, num_classes]`` from NHWC images.

    The constructor builds the layers without drawing weights; pass a
    ``generator`` to draw flax-style initial values (glorot-uniform kernels,
    zero biases, BatchNorm scale 1, bias 0, mean 0, var 1), or load weights
    with ``models.convert.from_flax_variables``. The module is placed on
    ``device``, CUDA unless the caller names another (``"cpu"``, or
    ``"meta"`` for a parameterless template); it raises where CUDA is
    asked for and absent. It starts in eval mode; ``model.train()`` runs
    BatchNorm on batch moments with running-statistics momentum
    ``bn_momentum`` (Keras's 0.99; 0 makes a train-mode forward store each
    batch's exact moments)."""

    def __init__(
        self,
        config: ModelConfig | None = None,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
        bn_momentum: float = BN_MOMENTUM,
    ):
        super().__init__()
        cfg = config or ModelConfig()
        if cfg.stem_layout != "reference" or cfg.res_layout != "reference":
            raise ValueError(
                "the port runs only the reference parameter layouts; got "
                f"stem_layout={cfg.stem_layout!r} res_layout={cfg.res_layout!r}"
            )
        if cfg.compute_dtype != "float32" or cfg.param_dtype != "float32":
            raise ValueError(
                "the port serves float32 only; got compute_dtype="
                f"{cfg.compute_dtype!r} param_dtype={cfg.param_dtype!r}"
            )
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ResUNet defaults to device='cuda' and no CUDA device is "
                "available; pass device='cpu' explicitly to run on the CPU"
            )
        self.config = cfg
        self.bn_momentum = bn_momentum
        with torch.device("meta"):
            self._build(cfg)
        self.to_empty(device=device)
        if generator is not None:
            self.reset_parameters(generator)
        self.eval()

    def _build(self, cfg: ModelConfig) -> None:
        self.stem_conv = _conv(cfg.in_channels, cfg.stem_features, 3, stride=2)
        self.stem_bn = BatchNorm(cfg.stem_features, self.bn_momentum)
        cin = cfg.stem_features
        for i, f in enumerate(cfg.encoder_features):
            self.add_module(f"enc{i}_sep1", SeparableConv(cin, f))
            self.add_module(f"enc{i}_bn1", BatchNorm(f, self.bn_momentum))
            self.add_module(f"enc{i}_sep2", SeparableConv(f, f))
            self.add_module(f"enc{i}_bn2", BatchNorm(f, self.bn_momentum))
            self.add_module(f"enc{i}_res", _conv(cin, f, 1, stride=2))
            cin = f
        prev = cin
        for i, f in enumerate(cfg.decoder_features):
            self.add_module(f"dec{i}_convT1", _conv(cin, f, 3))
            self.add_module(f"dec{i}_bn1", BatchNorm(f, self.bn_momentum))
            self.add_module(f"dec{i}_convT2", _conv(f, f, 3))
            self.add_module(f"dec{i}_bn2", BatchNorm(f, self.bn_momentum))
            self.add_module(f"dec{i}_res", _conv(prev, f, 1))
            cin = prev = f
        self.head = _conv(cin, cfg.num_classes, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initial values, drawn on the CPU from ``generator`` in
        module order (so one seed gives the same weights on any device)."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                # Flax's glorot on the HWIO kernel: fan_in = kh*kw*in/groups,
                # fan_out = kh*kw*out (for a depthwise kernel: 9 and 9*C).
                o, i, kh, kw = module.weight.shape
                limit = math.sqrt(6.0 / (kh * kw * i + kh * kw * o))
                w = torch.empty(module.weight.shape).uniform_(-limit, limit, generator=generator)
                module.weight.copy_(w)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        if self.training:
            # Train mode runs NCHW-contiguous: torch's CPU backward of the
            # 1x1 stride-2 residual conv on channels-last tensors crashes
            # (oneDNN, batch 2 and 3). Eval mode keeps the layout it serves.
            x = x.contiguous()
        x = self.stem_conv(_pad_same(x, 3, 2))
        x = torch.relu(self.stem_bn(x))
        previous = x
        for i in range(len(cfg.encoder_features)):
            x = torch.relu(x)
            x = self.get_submodule(f"enc{i}_bn1")(self.get_submodule(f"enc{i}_sep1")(x))
            x = torch.relu(x)
            x = self.get_submodule(f"enc{i}_bn2")(self.get_submodule(f"enc{i}_sep2")(x))
            x = max_pool_auto(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = x + self.get_submodule(f"enc{i}_res")(previous)
            previous = x
        for i in range(len(cfg.decoder_features)):
            x = torch.relu(x)
            x = self.get_submodule(f"dec{i}_convT1")(_pad_same(x, 3, 1))
            x = self.get_submodule(f"dec{i}_bn1")(x)
            x = torch.relu(x)
            x = self.get_submodule(f"dec{i}_convT2")(_pad_same(x, 3, 1))
            x = self.get_submodule(f"dec{i}_bn2")(x)
            x = x + self.get_submodule(f"dec{i}_res")(previous)
            if i + 1 < len(cfg.decoder_features):
                x = _upsample2x_nchw(x)
                previous = x
        logits = self.head(x.to(torch.float32))
        return _upsample2x_nchw(logits).permute(0, 2, 3, 1)


def init_variables(generator: torch.Generator, config: ModelConfig | None = None) -> dict:
    """Initial ``{'params', 'batch_stats'}`` tree (numpy, flax layout) drawn
    from ``generator``: the counterpart of the JAX ``init_variables``. The
    tree lives on the host, so the weights are drawn there."""
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    return to_flax_variables(ResUNet(config, generator=generator, device="cpu"))
