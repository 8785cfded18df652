"""Fused ResUNet inference forward over the quantized variables tree.

The counterpart of ``fedcrack_tpu.kernels.forward.fused_predict_logits``:
every conv is re-expressed in matmul form and runs through
:func:`~fedcrack_tpu_torch.kernels.dequant.dequant_matmul`, so the int8 /
e4m3 codes reach the contraction directly. Activations stay NHWC (the JAX
layout) and the tree stays in the JAX layout (HWIO codes, per-last-axis
scales):

- 3x3 convs (stem, decoder ConvTranspose): im2col through ``F.unfold``,
  whose patch channels are ``(C, kh, kw)``-major like
  ``lax.conv_general_dilated_patches``, so the HWIO codes reshape as
  ``permute(2, 0, 1, 3).reshape(C * 9, F)``. Flax ``"SAME"`` padding is
  asymmetric at stride 2 (0 before, 1 after on an even grid), so the input
  is padded explicitly before the unfold. A 3x3 stride-1 SAME flax
  ``ConvTranspose`` equals the plain SAME conv of the same, unflipped
  kernel, so the decoder needs no transposed conv.
- 1x1 convs (pointwise, decoder residuals, head): reshape and matmul.
- encoder residual 1x1 stride 2 SAME: it reads exactly ``x[:, ::2, ::2]``.
- depthwise 3x3: O(9 C) weights, expanded by
  :func:`~fedcrack_tpu_torch.kernels.dequant.dequant_codes` and run as a
  grouped conv.

Per forward at ``ModelConfig()`` that is 23 ``dequant_matmul`` launches and
6 ``dequant_codes`` launches. Everything accumulates in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.kernels.dequant import dequant_codes, dequant_matmul
from fedcrack_tpu_torch.models.resunet import BN_EPSILON, upsample2x
from fedcrack_tpu_torch.ops.pooling import max_pool_auto, same_pads


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
    c, f = q.shape[2], q.shape[3]
    n, h, w, _ = x.shape
    ho, lo_h, hi_h = same_pads(h, 3, stride)
    wo, lo_w, hi_w = same_pads(w, 3, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h))
    patches = F.unfold(xc, kernel_size=3, stride=stride)  # [N, C*9, Ho*Wo]
    rows = patches.transpose(1, 2).reshape(n * ho * wo, c * 9).contiguous()
    q2 = q.permute(2, 0, 1, 3).reshape(c * 9, f).contiguous()
    y = dequant_matmul(rows, q2, s)
    return y.reshape(n, ho, wo, f) + mod["bias"]


def _sepconv(x: torch.Tensor, mod: dict) -> torch.Tensor:
    dq, ds = _codes(mod["depthwise"]["kernel"])  # (3, 3, 1, C)
    kern = dequant_codes(dq, ds).permute(3, 2, 0, 1)  # (C, 1, 3, 3)
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    xc = F.conv2d(xc, kern, groups=xc.shape[1])
    return _conv1x1(xc.permute(0, 2, 3, 1), mod["pointwise"])


def fused_predict_logits(qtree: dict, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Per-pixel NHWC logits from the quantized tree: the fused counterpart
    of the reference ``ResUNet`` over ``dequantize_variables(qtree)``.

    ``qtree``: the ``{'params', 'batch_stats'}`` tree of tensors from
    ``quantize_variables`` / ``quantize_variables_fp8`` (the bare tree),
    on the device of ``x``."""
    if config.stem_layout != "reference" or config.res_layout != "reference":
        raise ValueError(
            "fused kernel planes support only the reference parameter layouts; "
            f"got stem_layout={config.stem_layout!r} res_layout={config.res_layout!r}"
        )
    p, st = qtree["params"], qtree["batch_stats"]
    x = x.to(torch.float32)

    x = _conv3x3(x, p["stem_conv"], stride=2)
    x = torch.relu(_bn(x, p["stem_bn"], st["stem_bn"]))
    prev = x

    for i in range(len(config.encoder_features)):
        x = torch.relu(x)
        x = _sepconv(x, p[f"enc{i}_sep1"])
        x = _bn(x, p[f"enc{i}_bn1"], st[f"enc{i}_bn1"])
        x = torch.relu(x)
        x = _sepconv(x, p[f"enc{i}_sep2"])
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
