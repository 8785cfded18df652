"""Fused ResUNet inference forward over the quantized variables tree.

The counterpart of ``fedcrack_tpu.kernels.forward.fused_predict_logits``:
every conv is re-expressed in matmul form and runs through
:func:`~fedcrack_tpu_torch.kernels.dequant.dequant_matmul`, so the int8 /
e4m3 codes reach the contraction directly. Activations stay NHWC (the JAX
layout) and the tree stays in the JAX layout (HWIO codes, per-last-axis
scales):

- decoder 3x3 stride-1 convs (``convT1``/``convT2``): a 3x3 stride-1 SAME
  flax ``ConvTranspose`` equals the plain SAME conv of the same, unflipped
  kernel, so they run through
  :func:`~fedcrack_tpu_torch.kernels.dequant.dequant_conv3x3`, which
  gathers its patches from the NHWC activation inside the kernel.
- the stride-2 stem (C = 3): im2col through ``F.unfold``
  (:func:`~fedcrack_tpu_torch.kernels.dequant.im2col3x3`, ``(C, kh, kw)``
  patch order like ``lax.conv_general_dilated_patches``, flax's asymmetric
  SAME padding made explicit), the HWIO codes permuted to match, then
  ``dequant_matmul``.
- 1x1 convs (pointwise, decoder residuals, head): reshape and matmul.
- encoder residual 1x1 stride 2 SAME: it reads exactly ``x[:, ::2, ::2]``.
- depthwise 3x3 with the ReLU before it:
  :func:`~fedcrack_tpu_torch.kernels.dequant.dequant_dwconv3x3` takes the
  pre-ReLU activation and the layer's codes and scales, and expands the
  nine taps, clamps the input and pads it (TMA's zero fill) inside the
  kernel; its codes come from the
  :class:`~fedcrack_tpu_torch.kernels.dequant.CodeGroup` that
  :func:`depthwise_group` builds once when the tree is placed.

- every conv's bias, the BatchNorm after it, the ReLU after that and the
  residual add after a residual conv run in the epilogue of the conv's own
  ``dequant_matmul`` or ``dequant_conv3x3`` launch
  (:class:`~fedcrack_tpu_torch.kernels.dequant.Epilogue`), and the ReLU
  before each decoder block's first conv as that conv reads its input
  (``relu_input``). Each step is one correctly rounded f32 op in the
  order the unfused forward takes them, so the forward is bit for bit the
  one that runs them as torch ops after each launch. The per-layer vectors
  (the BatchNorm's ``inv = scale * rsqrt(var + eps)`` computed once) come
  from the :class:`EpiloguePlan` that :func:`epilogue_plan` builds when
  the tree is placed.

Per forward at ``ModelConfig()`` that is 15 ``dequant_matmul`` launches
(stem, 9 encoder, 4 decoder residuals, head), 8 ``dequant_conv3x3``
launches, 6 ``dequant_dwconv3x3`` launches and no ``dequant_codes``
launch, and between them only the pools, the upsamples and the copies
that gather the stem's patches and the encoder residuals' strided pixels.
Everything accumulates in float32.
"""

from __future__ import annotations

import torch

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.kernels.dequant import (
    CodeGroup,
    Epilogue,
    dequant_conv3x3,
    dequant_dwconv3x3,
    dequant_matmul,
    im2col3x3,
)
from fedcrack_tpu_torch.models.resunet import BN_EPSILON, upsample2x
from fedcrack_tpu_torch.ops.pooling import max_pool_auto


def _codes(leaf) -> tuple[torch.Tensor, torch.Tensor]:
    from fedcrack_tpu_torch.serve.quant import QKEY, QKEY_FP8, SKEY

    if not isinstance(leaf, dict):
        raise TypeError(
            f"fused forward wants quantized kernel leaves, got {type(leaf).__name__}"
        )
    return leaf[QKEY] if QKEY in leaf else leaf[QKEY_FP8], leaf[SKEY]


def bn_inv(p: dict, s: dict) -> torch.Tensor:
    """A BatchNorm's ``scale * rsqrt(var + eps)``, as the unfused forward
    computes it before ``(x - mean) * inv + bias``."""
    return p["scale"] * torch.rsqrt(s["var"] + BN_EPSILON)


def _conv1x1(x: torch.Tensor, mod: dict, epilogue: Epilogue,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """The 1x1 conv of ``mod`` with ``epilogue`` (its bias first) and
    ``residual + y`` fused into its launch."""
    q, s = _codes(mod["kernel"])  # (1, 1, C, F)
    n, h, w, c = x.shape
    r = None if residual is None else residual.reshape(n * h * w, -1).contiguous()
    y = dequant_matmul(x.reshape(n * h * w, c).contiguous(), q.reshape(c, -1), s,
                       epilogue=epilogue, residual=r)
    return y.reshape(n, h, w, -1)


def _conv3x3(x: torch.Tensor, mod: dict, *, stride: int, epilogue: Epilogue,
             relu_input: bool = False) -> torch.Tensor:
    """The 3x3 SAME conv of ``mod`` with ``epilogue`` (its bias first)
    fused into its launch; ``relu_input`` (stride 1) convolves
    ``relu(x)``."""
    q, s = _codes(mod["kernel"])  # (3, 3, C, F)
    if stride == 1:
        return dequant_conv3x3(x.contiguous(), q, s, epilogue=epilogue, relu_input=relu_input)
    c, f = q.shape[2], q.shape[3]
    rows, ho, wo = im2col3x3(x, stride)
    q2 = q.permute(2, 0, 1, 3).reshape(c * 9, f).contiguous()
    y = dequant_matmul(rows, q2, s, epilogue=epilogue)
    return y.reshape(x.shape[0], ho, wo, f)


def _sepconv(x: torch.Tensor, codes: tuple[torch.Tensor, torch.Tensor], mod: dict,
             epilogue: Epilogue) -> torch.Tensor:
    """``relu(x)`` through the depthwise then the pointwise conv of ``mod``;
    ``codes``: the (3, 3, 1, C) depthwise codes of ``mod`` and their scales;
    ``epilogue``: the pointwise launch's."""
    return _conv1x1(dequant_dwconv3x3(x.contiguous(), *codes), mod["pointwise"], epilogue)


def _depthwise_codes(qtree: dict, config: ModelConfig) -> list[tuple[torch.Tensor, torch.Tensor]]:
    p = qtree["params"]
    return [_codes(p[f"enc{i}_{sep}"]["depthwise"]["kernel"])
            for i in range(len(config.encoder_features)) for sep in ("sep1", "sep2")]


def depthwise_group(qtree: dict, config: ModelConfig) -> CodeGroup:
    """The depthwise kernels' codes of ``qtree`` (two per encoder block, in
    forward order) as one validated group, for ``fused_predict_logits``."""
    return CodeGroup(_depthwise_codes(qtree, config))


def _epilogue_layers(config: ModelConfig) -> list[tuple[tuple[str, ...], str | None, bool]]:
    """Each fused launch of the forward: the path of its conv in ``params``,
    the BatchNorm its epilogue applies (or None) and whether a ReLU
    follows, in launch order."""
    layers = [(("stem_conv",), "stem_bn", True)]
    for i in range(len(config.encoder_features)):
        layers += [((f"enc{i}_sep1", "pointwise"), f"enc{i}_bn1", False),
                   ((f"enc{i}_sep2", "pointwise"), f"enc{i}_bn2", False), ((f"enc{i}_res",), None, False)]
    for i in range(len(config.decoder_features)):
        layers += [((f"dec{i}_convT1",), f"dec{i}_bn1", True), ((f"dec{i}_convT2",), f"dec{i}_bn2", False),
                   ((f"dec{i}_res",), None, False)]
    return layers + [(("head",), None, False)]


def _epilogue_sources(qtree: dict, path: tuple[str, ...], bn: str | None) -> tuple[torch.Tensor, ...]:
    """The tree's tensors a layer's epilogue is built from: the conv's bias,
    then the BatchNorm's scale, bias, mean and var."""
    p, st = qtree["params"], qtree["batch_stats"]
    mod = p
    for key in path:
        mod = mod[key]
    if bn is None:
        return (mod["bias"],)
    return mod["bias"], p[bn]["scale"], p[bn]["bias"], st[bn]["mean"], st[bn]["var"]


class EpiloguePlan:
    """Every fused launch's :class:`~fedcrack_tpu_torch.kernels.dequant.Epilogue`
    for one placed tree, keyed by the conv's path (``"enc0_sep1.pointwise"``),
    with the tree tensors each was built from, so the forward can check by
    identity that the plan is this tree's."""

    def __init__(self, qtree: dict, config: ModelConfig):
        self.epilogues: dict[str, Epilogue] = {}
        self.sources: dict[str, tuple[torch.Tensor, ...]] = {}
        st = qtree["batch_stats"]
        for path, bn, relu in _epilogue_layers(config):
            sources = _epilogue_sources(qtree, path, bn)
            vectors = None
            if bn is not None:
                vectors = (st[bn]["mean"], bn_inv(qtree["params"][bn], st[bn]), qtree["params"][bn]["bias"])
            name = ".".join(path)
            self.epilogues[name] = Epilogue(bias=sources[0], bn=vectors, relu=relu)
            self.sources[name] = sources

    def belongs_to(self, qtree: dict, config: ModelConfig) -> bool:
        """Whether this plan was built from ``qtree``'s own tensors for
        ``config``'s layers."""
        layers = _epilogue_layers(config)
        if len(layers) != len(self.sources):
            return False
        for path, bn, _ in layers:
            have = self.sources.get(".".join(path))
            want = _epilogue_sources(qtree, path, bn)
            if have is None or len(have) != len(want) or any(a is not b for a, b in zip(have, want)):
                return False
        return True


def epilogue_plan(qtree: dict, config: ModelConfig) -> EpiloguePlan:
    """The fused launches' epilogues of ``qtree`` (bias, BatchNorm, ReLU a
    layer), built once beside the placed tree, for ``fused_predict_logits``."""
    return EpiloguePlan(qtree, config)


def fused_predict_logits(
    qtree: dict, x: torch.Tensor, config: ModelConfig, depthwise: CodeGroup, epilogues: EpiloguePlan,
) -> torch.Tensor:
    """Per-pixel NHWC logits from the quantized tree: the fused counterpart
    of the reference ``ResUNet`` over ``dequantize_variables(qtree)``.

    ``qtree``: the ``{'params', 'batch_stats'}`` tree of tensors from
    ``quantize_variables`` / ``quantize_variables_fp8`` (the bare tree),
    on the device of ``x``. ``depthwise``: ``depthwise_group(qtree,
    config)``, built once beside the placed tree
    (``InferenceEngine.prepare_quantized``); it must hold ``qtree``'s own
    code and scale tensors, which is checked by identity per call.
    ``epilogues``: ``epilogue_plan(qtree, config)``, built there too and
    checked the same way."""
    if config.stem_layout != "reference" or config.res_layout != "reference":
        raise ValueError(
            "fused kernel planes support only the reference parameter layouts; "
            f"got stem_layout={config.stem_layout!r} res_layout={config.res_layout!r}"
        )
    if not isinstance(depthwise, CodeGroup):
        raise TypeError(
            "depthwise must be depthwise_group(qtree, config) (InferenceEngine.prepare_quantized "
            f"builds it), got {type(depthwise).__name__}"
        )
    leaves = _depthwise_codes(qtree, config)
    if len(leaves) != len(depthwise.leaves) or any(
        q is not gq or s is not gs for (q, s), (gq, gs) in zip(leaves, depthwise.leaves)
    ):
        raise ValueError("depthwise group was not built from this tree's depthwise codes")
    if not isinstance(epilogues, EpiloguePlan):
        raise TypeError(
            "epilogues must be epilogue_plan(qtree, config) (InferenceEngine.prepare_quantized "
            f"builds it), got {type(epilogues).__name__}"
        )
    if not epilogues.belongs_to(qtree, config):
        raise ValueError("epilogue plan was not built from this tree's biases and BatchNorms")
    p = qtree["params"]
    codes = depthwise.leaves
    epi = epilogues.epilogues
    x = x.to(torch.float32)

    # Each launch's epilogue: the conv's bias, then its BatchNorm and ReLU
    # (stem, encoder pointwise convs, decoder convs), then the residual.
    x = _conv3x3(x, p["stem_conv"], stride=2, epilogue=epi["stem_conv"])
    prev = x

    for i in range(len(config.encoder_features)):
        x = _sepconv(x, codes[2 * i], p[f"enc{i}_sep1"], epi[f"enc{i}_sep1.pointwise"])  # ReLU in the kernel
        x = _sepconv(x, codes[2 * i + 1], p[f"enc{i}_sep2"], epi[f"enc{i}_sep2.pointwise"])
        x = max_pool_auto(x)
        x = _conv1x1(prev[:, ::2, ::2, :], p[f"enc{i}_res"], epi[f"enc{i}_res"], residual=x)
        prev = x

    for i in range(len(config.decoder_features)):
        x = _conv3x3(x, p[f"dec{i}_convT1"], stride=1, epilogue=epi[f"dec{i}_convT1"], relu_input=True)
        x = _conv3x3(x, p[f"dec{i}_convT2"], stride=1, epilogue=epi[f"dec{i}_convT2"])
        # Residual conv + add at the low resolution, before the upsample.
        x = _conv1x1(prev, p[f"dec{i}_res"], epi[f"dec{i}_res"], residual=x)
        if i + 1 < len(config.decoder_features):
            x = upsample2x(x)
            prev = x

    logits = _conv1x1(x, p["head"], epi["head"])
    return upsample2x(logits)
