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

Per forward at ``ModelConfig()`` that is 15 ``dequant_matmul`` launches
(stem, 9 encoder, 4 decoder residuals, head), 8 ``dequant_conv3x3``
launches, 6 ``dequant_dwconv3x3`` launches and no ``dequant_codes``
launch. Everything accumulates in float32.
"""

from __future__ import annotations

import torch

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.kernels.dequant import (
    CodeGroup,
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


def _bn(x: torch.Tensor, p: dict, s: dict) -> torch.Tensor:
    inv = p["scale"] * torch.rsqrt(s["var"] + BN_EPSILON)
    return (x - s["mean"]) * inv + p["bias"]


def _conv1x1(x: torch.Tensor, mod: dict) -> torch.Tensor:
    q, s = _codes(mod["kernel"])  # (1, 1, C, F)
    n, h, w, c = x.shape
    y = dequant_matmul(x.reshape(n * h * w, c).contiguous(), q.reshape(c, -1), s)
    return y.reshape(n, h, w, -1) + mod["bias"]


def _conv3x3(x: torch.Tensor, mod: dict, *, stride: int) -> torch.Tensor:
    q, s = _codes(mod["kernel"])  # (3, 3, C, F)
    if stride == 1:
        return dequant_conv3x3(x.contiguous(), q, s) + mod["bias"]
    c, f = q.shape[2], q.shape[3]
    rows, ho, wo = im2col3x3(x, stride)
    q2 = q.permute(2, 0, 1, 3).reshape(c * 9, f).contiguous()
    y = dequant_matmul(rows, q2, s)
    return y.reshape(x.shape[0], ho, wo, f) + mod["bias"]


def _sepconv(x: torch.Tensor, codes: tuple[torch.Tensor, torch.Tensor], mod: dict) -> torch.Tensor:
    """``relu(x)`` through the depthwise then the pointwise conv of ``mod``;
    ``codes``: the (3, 3, 1, C) depthwise codes of ``mod`` and their scales."""
    return _conv1x1(dequant_dwconv3x3(x.contiguous(), *codes), mod["pointwise"])


def _depthwise_codes(qtree: dict, config: ModelConfig) -> list[tuple[torch.Tensor, torch.Tensor]]:
    p = qtree["params"]
    return [_codes(p[f"enc{i}_{sep}"]["depthwise"]["kernel"])
            for i in range(len(config.encoder_features)) for sep in ("sep1", "sep2")]


def depthwise_group(qtree: dict, config: ModelConfig) -> CodeGroup:
    """The depthwise kernels' codes of ``qtree`` (two per encoder block, in
    forward order) as one validated group, for ``fused_predict_logits``."""
    return CodeGroup(_depthwise_codes(qtree, config))


def fused_predict_logits(
    qtree: dict, x: torch.Tensor, config: ModelConfig, depthwise: CodeGroup
) -> torch.Tensor:
    """Per-pixel NHWC logits from the quantized tree: the fused counterpart
    of the reference ``ResUNet`` over ``dequantize_variables(qtree)``.

    ``qtree``: the ``{'params', 'batch_stats'}`` tree of tensors from
    ``quantize_variables`` / ``quantize_variables_fp8`` (the bare tree),
    on the device of ``x``. ``depthwise``: ``depthwise_group(qtree,
    config)``, built once beside the placed tree
    (``InferenceEngine.prepare_quantized``); it must hold ``qtree``'s own
    code and scale tensors, which is checked by identity per call."""
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
    p, st = qtree["params"], qtree["batch_stats"]
    codes = depthwise.leaves
    x = x.to(torch.float32)

    x = _conv3x3(x, p["stem_conv"], stride=2)
    x = torch.relu(_bn(x, p["stem_bn"], st["stem_bn"]))
    prev = x

    for i in range(len(config.encoder_features)):
        x = _sepconv(x, codes[2 * i], p[f"enc{i}_sep1"])  # the ReLU is the kernel's
        x = _bn(x, p[f"enc{i}_bn1"], st[f"enc{i}_bn1"])
        x = _sepconv(x, codes[2 * i + 1], p[f"enc{i}_sep2"])
        x = _bn(x, p[f"enc{i}_bn2"], st[f"enc{i}_bn2"])
        x = max_pool_auto(x)
        x = x + _conv1x1(prev[:, ::2, ::2, :], p[f"enc{i}_res"])
        prev = x

    for i in range(len(config.decoder_features)):
        x = torch.relu(x)
        x = _conv3x3(x, p[f"dec{i}_convT1"], stride=1)
        x = _bn(x, p[f"dec{i}_bn1"], st[f"dec{i}_bn1"])
        x = torch.relu(x)
        x = _conv3x3(x, p[f"dec{i}_convT2"], stride=1)
        x = _bn(x, p[f"dec{i}_bn2"], st[f"dec{i}_bn2"])
        # Residual conv + add at the low resolution, before the upsample.
        x = x + _conv1x1(prev, p[f"dec{i}_res"])
        if i + 1 < len(config.decoder_features):
            x = upsample2x(x)
            prev = x

    logits = _conv1x1(x, p["head"])
    return upsample2x(logits)
