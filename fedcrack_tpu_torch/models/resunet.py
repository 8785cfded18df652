"""The crack-segmentation residual U-Net as a PyTorch module.

The counterpart of ``fedcrack_tpu.models.resunet.ResUNet``, with the flax
module names (``stem_conv``, ``enc{i}_sep1.depthwise``, ``dec{i}_convT1``,
``head``...), so ``models/convert.py`` maps a flax variables tree onto it
name for name. Its convs are ``F.conv2d``, as the JAX package leaves its
convs to XLA.

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

The layouts (``ModelConfig.stem_layout`` / ``res_layout``) re-express the
stem and the encoder's residual projections over the same parameters,
whose names, shapes and initial values do not change, so the weight
carry, FedAvg, the wire and the statefile never see the layout. The
transformed kernels are derived inside ``forward`` from the reference
kernels (``fold_stem_kernel_s2d`` and the rest, plain functions on HWIO
tensors as in the JAX package), so gradients land on the reference
parameters. ``"s2d"`` runs the stem as a width-folded ``[3,2,2C,F]`` conv
at strides (2, 1); ``"s2d_full"`` as a fully folded ``[2,2,4C,F]`` conv at
stride 1 on the space-to-depth input; either takes the ``[N,H,W,C]`` input
or the pre-packed ``[N,H/2,W/2,4C]`` of :func:`space_to_depth`.
``"packed"`` runs each encoder residual ``Conv(F, 1x1, stride 2)`` as a
stride-1 1x1 conv over the space-to-depth of its input with the kernel
zero-extended to ``[1,1,4C,F]``. The same multiplies are summed with exact
zeros between them; whether the backend sums the real terms in the
reference's order (the JAX docstring's bit-exactness) depends on the
backend's algorithm, and tests/test_torch_layouts.py measures it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedcrack_tpu_torch.configs import SLOT_PLANE_ONLY, ModelConfig, SegFormerConfig
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


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[N,H,W,C] -> [N,H/2,W/2,4C]``: 2x2 pixel blocks to channels,
    block-position-major (packed channel ``(di*2+dj)*C + c`` for the pixel
    at block offset ``(di, dj)``). Pure data movement; the host twin for
    staging is ``data.pipeline.space_to_depth_images``."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H,W; got {(h, w)}")
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, h2, w2, c4 = x.shape
    if c4 % 4:
        raise ValueError(f"depth_to_space needs channels % 4 == 0; got {c4}")
    c = c4 // 4
    return x.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h2, 2 * w2, c)


def fold_stem_kernel_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """Reference stem kernel ``[3,3,C,F]`` (HWIO) -> width-folded
    ``[3,2,2C,F]``: tap ``(kh, kw, c)`` lands at ``[kh, kw//2, (kw%2)*C +
    c]``, the unused slot ``(kh, 1, C + c)`` exact zero. Linear in
    ``kernel``, so differentiable."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"expected a 3x3 stem kernel, got {tuple(kernel.shape)}")
    k0 = torch.cat([kernel[:, 0], kernel[:, 1]], dim=1)  # [3, 2C, F]
    k1 = torch.cat([kernel[:, 2], torch.zeros_like(kernel[:, 2])], dim=1)
    return torch.stack([k0, k1], dim=1)


def unfold_stem_kernel_s2d(folded: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`fold_stem_kernel_s2d`."""
    if tuple(folded.shape[:2]) != (3, 2):
        raise ValueError(f"expected a [3,2,2C,F] folded kernel, got {tuple(folded.shape)}")
    c = folded.shape[2] // 2
    k0, k1 = folded[:, 0], folded[:, 1]
    return torch.stack([k0[:, :c], k0[:, c:], k1[:, :c]], dim=1)


def fold_stem_kernel_s2d_full(kernel: torch.Tensor) -> torch.Tensor:
    """Reference stem kernel ``[3,3,C,F]`` -> fully folded ``[2,2,4C,F]``
    for the stride-1 conv on the space-to-depth input: tap ``(kh, kw, c)``
    lands at ``[kh//2, kw//2, ((kh%2)*2 + kw%2)*C + c]``. Taps of different
    rows share a packed block, so the sum is reassociated."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"expected a 3x3 stem kernel, got {tuple(kernel.shape)}")
    zeros = torch.zeros_like(kernel[0, 0])  # [C, F]

    def tap(kh: int, kw: int) -> torch.Tensor:
        return kernel[kh, kw] if kh < 3 and kw < 3 else zeros

    rows = [
        torch.stack([torch.cat([tap(2 * bh + di, 2 * bw + dj) for di in (0, 1) for dj in (0, 1)], dim=0)
                     for bw in range(2)], dim=0)
        for bh in range(2)
    ]
    return torch.stack(rows, dim=0)


def unfold_stem_kernel_s2d_full(folded: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`fold_stem_kernel_s2d_full`."""
    if tuple(folded.shape[:2]) != (2, 2):
        raise ValueError(f"expected a [2,2,4C,F] folded kernel, got {tuple(folded.shape)}")
    c = folded.shape[2] // 4
    taps = []
    for kh in range(3):
        row = []
        for kw in range(3):
            lo = ((kh % 2) * 2 + kw % 2) * c
            row.append(folded[kh // 2, kw // 2, lo:lo + c])
        taps.append(torch.stack(row, dim=0))
    return torch.stack(taps, dim=0)


def pack_res_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Reference 1x1 residual kernel ``[1,1,C,F]`` -> ``[1,1,4C,F]`` for
    the stride-1 conv on the space-to-depth input: the real taps (block
    offset (0, 0), the pixels a stride-2 1x1 conv reads) first, zeros
    after."""
    if tuple(kernel.shape[:2]) != (1, 1):
        raise ValueError(f"expected a 1x1 residual kernel, got {tuple(kernel.shape)}")
    zeros = kernel.new_zeros((1, 1, 3 * kernel.shape[2], kernel.shape[3]))
    return torch.cat([kernel, zeros], dim=2)


def unpack_res_kernel(packed: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`pack_res_kernel`."""
    if packed.shape[2] % 4:
        raise ValueError(f"expected a [1,1,4C,F] packed kernel, got {tuple(packed.shape)}")
    return packed[:, :, : packed.shape[2] // 4]


def _space_to_depth_nchw(x: torch.Tensor) -> torch.Tensor:
    """:func:`space_to_depth` on NCHW: ``[N,C,H,W] -> [N,4C,H/2,W/2]``."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H,W; got {(h, w)}")
    return x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format a conv on ``x`` would run in."""
    if not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


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


class _DerivedKernelConv(Conv):
    """A conv holding the reference kernel ``weight`` (OIHW) and bias, run
    with a kernel derived from it per call: flax's reduced-precision
    semantics as :class:`Conv` (the kernel cast before the derivation, the
    bias added to the rounded output)."""

    def _run(self, x: torch.Tensor, derive, stride) -> torch.Tensor:
        dt = self.compute_dtype
        kernel = self.weight if dt is None else self.weight.to(dt)
        w = derive(kernel.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
        if dt is None:
            return F.conv2d(x, w, self.bias, stride)
        return F.conv2d(x.to(dt), w, None, stride) + self.bias.to(dt)[:, None, None]


class S2DStemConv(_DerivedKernelConv):
    """The stem conv run space-to-depth, with the reference stem's
    parameters (``weight [F,C,3,3]``, ``bias [F]``). Takes NCHW ``[N,C,H,W]``
    or the pre-packed ``[N,4C,H/2,W/2]`` (the NHWC input of
    :func:`space_to_depth`, permuted) and returns ``[N,F,H/2,W/2]``;
    pads the stem's SAME itself. ``layout="s2d"``: the width fold, strides
    (2, 1), padding ((0, 1), (0, 1)); ``"s2d_full"``: stride 1 on the
    fully packed input, the same padding. The data movement copies into
    the memory format the input arrived in, so the layers after the stem
    run as they do after the reference stem."""

    def __init__(self, cin: int, cout: int, layout: str):
        super().__init__(cin, cout, 3, stride=2, padding=0, bias=True)
        self.layout = layout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.in_channels
        n, ch, h, w = x.shape
        packed = ch == 4 * c
        if not packed and ch != c:
            raise ValueError(
                f"stem input has {ch} channels; expected {c} (reference layout) or {4 * c} "
                "(space_to_depth-packed)"
            )
        fmt = _memory_format(x)
        if self.layout == "s2d":
            if packed:
                # Unpack H only: [N,4C,H/2,W/2] -> [N,2C,H,W/2], channel dj*C + c.
                x = x.reshape(n, 2, 2, c, h, w).permute(0, 2, 3, 4, 1, 5).reshape(n, 2 * c, 2 * h, w)
            else:
                # The width fold: [N,C,H,W] -> [N,2C,H,W/2], channel dj*C + c.
                x = x.reshape(n, c, h, w // 2, 2).permute(0, 4, 1, 2, 3).reshape(n, 2 * c, h, w // 2)
            derive, stride = fold_stem_kernel_s2d, (2, 1)
        else:  # "s2d_full"
            if not packed:
                x = _space_to_depth_nchw(x)
            derive, stride = fold_stem_kernel_s2d_full, (1, 1)
        x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=fmt)
        return self._run(x, derive, stride)


class PackedResConv(_DerivedKernelConv):
    """An encoder residual projection, reference ``Conv(F, 1x1, stride 2)``
    with its parameters (``weight [F,C,1,1]``, ``bias``), run as a stride-1
    1x1 conv over the space-to-depth of its NCHW input with the kernel
    zero-extended to ``[1,1,4C,F]`` (:func:`pack_res_kernel`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1, stride=2, padding=0, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fmt = _memory_format(x)
        return self._run(_space_to_depth_nchw(x).contiguous(memory_format=fmt), pack_res_kernel, (1, 1))


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
        if isinstance(cfg, SegFormerConfig):
            raise TypeError(SLOT_PLANE_ONLY.format(what="ResUNet"))
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
        if cfg.stem_layout == "reference":
            self.stem_conv = _conv(cfg.in_channels, cfg.stem_features, 3, stride=2)
        else:
            self.stem_conv = S2DStemConv(cfg.in_channels, cfg.stem_features, cfg.stem_layout)
        self.stem_bn = BatchNorm(cfg.stem_features, self.bn_momentum)
        cin = cfg.stem_features
        for i, f in enumerate(cfg.encoder_features):
            self.add_module(f"enc{i}_sep1", SeparableConv(cin, f))
            self.add_module(f"enc{i}_bn1", BatchNorm(f, self.bn_momentum))
            self.add_module(f"enc{i}_sep2", SeparableConv(f, f))
            self.add_module(f"enc{i}_bn2", BatchNorm(f, self.bn_momentum))
            packed = cfg.res_layout == "packed"
            self.add_module(f"enc{i}_res", PackedResConv(cin, f) if packed else _conv(cin, f, 1, stride=2))
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
        # A space-to-depth stem pads itself and takes [N,C,H,W] or the
        # pre-packed [N,4C,H/2,W/2]; from stem_bn on the layers are the
        # reference layout's.
        x = self.stem_conv(x if cfg.stem_layout != "reference" else geometry.pad_s2(x))
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


def predict(variables: dict, images, config: ModelConfig | None = None,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Sigmoid probabilities ``[N, H, W, num_classes]`` for a batch of NHWC
    float images (numpy or a tensor) under the flax-layout ``variables``,
    in inference mode (running BatchNorm statistics), on ``device`` (CUDA
    unless the caller names another)."""
    from fedcrack_tpu_torch.models.convert import from_flax_variables

    model = from_flax_variables(variables, ResUNet(config, device=device))
    x = torch.as_tensor(images, device=next(model.parameters()).device)
    with torch.no_grad():
        return torch.sigmoid(model(x))
