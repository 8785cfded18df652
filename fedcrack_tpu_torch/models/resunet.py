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

``ModelConfig(compute_dtype="bfloat16")`` (with float32 parameters) does
what flax does with ``dtype=bfloat16``, with explicit casts and no
``torch.autocast`` (whose per-op rules are not flax's): the input is cast
to bfloat16; each conv casts its input, kernel and bias to bfloat16, and
adds the bias to its rounded bfloat16 output as flax's ``y += bias``
does; BatchNorm takes its moments in float32 (flax's ``_compute_stats``),
normalizes in float32 and casts the result to bfloat16 (``_normalize``),
its running statistics staying float32; pool, ReLU, residual adds and
upsampling run in bfloat16; the head runs in float32 on the activations
cast back. Parameters and their gradients stay float32. The fused serving
planes (``kernels/forward.py``) ignore the compute dtype, as the JAX
package's do.

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

# ModelConfig.compute_dtype -> the activations' dtype.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with flax's reduced-precision semantics when
    ``compute_dtype`` is set: input, kernel and bias cast to it, the bias
    added to the rounded conv output. Unset, it is ``nn.Conv2d``."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


def _conv(cin: int, cout: int, k: int, *, stride: int = 1, groups: int = 1, bias: bool = True):
    return Conv(cin, cout, k, stride=stride, padding=0, groups=groups, bias=bias)


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

    def forward(self, x: torch.Tensor, moments=None) -> torch.Tensor:  # NCHW
        """``moments(xs) -> (mean, var)`` over float32 ``xs`` replaces the
        batch moments in train mode (the spatial plane across processes
        takes them over every rank's bands); None takes them over ``x``."""
        if self.training:
            # Moments in float32 whatever the activations' dtype.
            xs = x.to(torch.float32)
            if moments is None:
                mean = xs.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            else:
                mean, var = moments(xs)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        # A bfloat16 x promotes to float32 here; the result goes back to x's dtype.
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1, Keras ``SeparableConv2D``:
    :meth:`ResUNet.trunk` calls the two convs, padding between them."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.depthwise = _conv(in_features, in_features, 3, groups=in_features, bias=False)
        self.pointwise = _conv(in_features, features, 1)


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
        if cfg.compute_dtype not in COMPUTE_DTYPES or cfg.param_dtype != "float32":
            raise ValueError(
                "the port computes in float32 or bfloat16 with float32 parameters; got "
                f"compute_dtype={cfg.compute_dtype!r} param_dtype={cfg.param_dtype!r}"
            )
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ResUNet defaults to device='cuda' and no CUDA device is "
                "available; pass device='cpu' explicitly to run on the CPU"
            )
        self.config = cfg
        self.bn_momentum = bn_momentum
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        with torch.device("meta"):
            self._build(cfg)
        if self.compute_dtype != torch.float32:
            for name, module in self.named_modules():
                if isinstance(module, Conv) and name != "head":
                    module.compute_dtype = self.compute_dtype
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
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if self.training:
            # Train mode runs NCHW-contiguous: torch's CPU backward of the
            # 1x1 stride-2 residual conv on channels-last tensors crashes
            # (oneDNN, batch 2 and 3). Eval mode keeps the layout it serves.
            x = x.contiguous()
        return _upsample2x_nchw(self.trunk(x, SAME)).permute(0, 2, 3, 1)

    def trunk(self, x: torch.Tensor, geometry: "SameGeometry") -> torch.Tensor:
        """The layers from the stem to the head on NCHW input in the
        compute dtype: float32 logits at half resolution, before the final
        upsample. ``geometry`` pads the 3x3 windows and pools; the spatial
        plane (``parallel.spatial``) passes its halo geometry here, so a
        sharded forward runs these very layers; the geometry's ``moments``
        (None on one process) feeds every BatchNorm."""
        cfg = self.config
        moments = geometry.moments
        x = self.stem_conv(geometry.pad_s2(x))
        x = torch.relu(self.stem_bn(x, moments))
        previous = x
        for i in range(len(cfg.encoder_features)):
            for j in (1, 2):
                x = torch.relu(x)
                sep = self.get_submodule(f"enc{i}_sep{j}")
                x = self.get_submodule(f"enc{i}_bn{j}")(sep.pointwise(sep.depthwise(geometry.pad_s1(x))), moments)
            x = geometry.pool(x)
            x = x + self.get_submodule(f"enc{i}_res")(previous)
            previous = x
        for i in range(len(cfg.decoder_features)):
            x = torch.relu(x)
            x = self.get_submodule(f"dec{i}_convT1")(geometry.pad_s1(x))
            x = self.get_submodule(f"dec{i}_bn1")(x, moments)
            x = torch.relu(x)
            x = self.get_submodule(f"dec{i}_convT2")(geometry.pad_s1(x))
            x = self.get_submodule(f"dec{i}_bn2")(x, moments)
            x = x + self.get_submodule(f"dec{i}_res")(previous)
            if i + 1 < len(cfg.decoder_features):
                x = _upsample2x_nchw(x)
                previous = x
        return self.head(x.to(torch.float32))


class SameGeometry:
    """The single-device geometry of :meth:`ResUNet.trunk`: XLA ``"SAME"``
    zero padding for the 3x3 convs, the SAME max pool."""

    moments = None

    def pad_s1(self, x: torch.Tensor) -> torch.Tensor:
        return _pad_same(x, 3, 1)

    def pad_s2(self, x: torch.Tensor) -> torch.Tensor:
        return _pad_same(x, 3, 2)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_auto(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


SAME = SameGeometry()


def init_variables(generator: torch.Generator, config: ModelConfig | None = None) -> dict:
    """Initial ``{'params', 'batch_stats'}`` tree (numpy, flax layout) drawn
    from ``generator``: the counterpart of the JAX ``init_variables``. The
    tree lives on the host, so the weights are drawn there."""
    from fedcrack_tpu_torch.models.convert import to_flax_variables

    return to_flax_variables(ResUNet(config, generator=generator, device="cpu"))
