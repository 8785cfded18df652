"""Analytic FLOPs models of the crack U-Net and SegFormer, MFU against the H100's peak,
and which kernel plane answers quantized traffic, as a scrapeable gauge.

The counterpart of ``fedcrack_tpu.obs.flops``. The model walks the
topology of ``models/resunet.py`` and counts matmul-equivalent FLOPs: the
convolutions, which carry more than 99% of the arithmetic. Elementwise
work (BatchNorm, ReLU, residual adds, the loss) is O(HW·C) against the
convs' O(HW·C²·K²) and is left out. On the port's eval forward the count
equals ``torch.utils.flop_counter.FlopCounterMode``'s exactly
(``tests/test_torch_flops.py``), and it equals the JAX package's model on
every config.

MFU is reported against the card's **bf16 dense tensor-core peak** for
both dtypes, the JAX package's convention (float32 runs the same machine
more slowly, so "fraction of the machine's ceiling" stays comparable
across dtypes).

CANONICAL FLOPs, by design, as in the JAX package: ``stem_layout`` and
``res_layout`` are not consulted. The layouts re-express the same math
with zero-extended kernels, and counting those zero MACs would inflate
the MFU of the transformed variants. Every layout is charged the
reference topology's FLOPs, and so is every kernel plane: a fused-int8 or
fp8 forward changes bytes moved and bit-width per MAC, not canonical MACs.
Which plane answered is exported separately as the
``serve_kernel_plane_info`` labeled gauge (:func:`export_kernel_plane`).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

from fedcrack_tpu_torch.configs import ModelConfig, SegFormerConfig

if TYPE_CHECKING:
    import torch

# One step ≈ forward + backward; for conv stacks the backward pass is two
# conv-shaped passes (grad wrt activations + grad wrt kernels), so train-step
# FLOPs ≈ 3x forward. Optimizer/BN/loss work is elementwise and excluded.
TRAIN_STEP_FLOPS_MULTIPLIER = 3.0

# Dense bf16 tensor-core peak (TFLOP/s, no sparsity) per CUDA device, keyed
# by substrings of torch.cuda.get_device_name in lower case; the specific
# rows come before the generic one. NVIDIA H100 data sheet: SXM5 1,979
# TFLOP/s with sparsity, so 989.4 dense; PCIe 1,513 with sparsity (756.5
# dense); H100 NVL 1,671 with sparsity (835.5 dense). The SXM5 card reports
# "NVIDIA H100 80GB HBM3" and takes the generic row. Override with
# FEDCRACK_PEAK_TFLOPS for a card not listed.
_PEAK_TFLOPS_BF16 = (
    ("h100 pcie", 756.5),
    ("h100 nvl", 835.5),
    ("h100", 989.4),
)


def _conv_flops(out_hw: int, c_in: int, c_out: int, k: int) -> float:
    """Dense KxK conv at SAME padding: 2 FLOPs (mul+add) per MAC."""
    return 2.0 * out_hw * out_hw * c_out * (k * k * c_in)


def resunet_forward_flops(config: ModelConfig | None = None, batch_size: int = 1) -> float:
    """Forward-pass FLOPs for one batch through the residual U-Net.

    Mirrors models/resunet.py layer by layer: stem conv /2; encoder blocks
    (depthwise 3x3 + pointwise 1x1) x2 + pool /2 + strided 1x1 residual;
    decoder blocks (3x3 conv) x2 + low-resolution 1x1 residual + single
    upsample x2; 1x1 head at img_size/2. The layout flags are not
    consulted (module docstring)."""
    cfg = config or ModelConfig()
    s = cfg.img_size // 2  # after the stride-2 stem
    c = cfg.stem_features
    total = _conv_flops(s, cfg.in_channels, c, 3)

    for feat in cfg.encoder_features:
        # SeparableConv = depthwise 3x3 (per-channel) + pointwise 1x1.
        total += 2.0 * s * s * c * 9  # depthwise on c channels
        total += _conv_flops(s, c, feat, 1)  # pointwise c -> feat
        total += 2.0 * s * s * feat * 9
        total += _conv_flops(s, feat, feat, 1)
        s //= 2  # MaxPool(3x3, stride 2)
        # Residual: 1x1 stride-2 conv from the block input (c channels).
        total += _conv_flops(s, c, feat, 1)
        c = feat

    for feat in cfg.decoder_features:
        total += _conv_flops(s, c, feat, 3)
        total += _conv_flops(s, feat, feat, 3)
        # The residual 1x1 conv runs at the LOW resolution, before the
        # upsample it commutes with; counting it after the upsample would
        # overcount this branch 4x.
        total += _conv_flops(s, c, feat, 1)
        s *= 2  # UpSampling2D(2)
        c = feat

    # The head's 1x1 conv is also deferred past the final upsample: it
    # runs at img_size/2, so it is counted there.
    total += _conv_flops(s // 2, c, cfg.num_classes, 1)
    return total * float(batch_size)


def train_step_flops(config: ModelConfig | None = None, batch_size: int = 1) -> float:
    """FLOPs for one training step (forward + backward) at the given batch size."""
    return TRAIN_STEP_FLOPS_MULTIPLIER * resunet_forward_flops(config, batch_size)


def segformer_forward_flops(config: SegFormerConfig | None = None, batch_size: int = 1) -> float:
    """Forward-pass FLOPs for one batch through SegFormer
    (``models/segformer.py``): matmul-equivalent FLOPs of the convolutions
    (the patch embeddings, the spatial reductions, the depthwise 3x3s of
    the Mix-FFNs, the head's fuse and prediction), the Linear layers (q,
    kv, proj, fc1, fc2, the head's four) and the attention's two batched
    products, 2 per multiply-accumulate. LayerNorm, GELU, softmax, the
    resizes and the loss are left out."""
    cfg = config or SegFormerConfig()
    total = 0.0
    s, cin = cfg.img_size, cfg.in_channels
    grids = []
    for i, dim in enumerate(cfg.embed_dims):
        s //= (4, 2, 2, 2)[i]
        n = s * s
        total += _conv_flops(s, cin, dim, (7, 3, 3, 3)[i])
        sr = cfg.sr_ratios[i]
        m = n // (sr * sr)
        hidden = dim * cfg.mlp_ratio
        block = 2.0 * n * dim * dim                      # q
        if sr > 1:
            block += _conv_flops(s // sr, dim, dim, sr)  # the spatial reduction
        block += 2.0 * m * dim * 2 * dim                 # kv
        block += 2.0 * 2.0 * n * m * dim                 # q k^T and the weights times v, over the heads
        block += 2.0 * n * dim * dim                     # proj
        block += 2.0 * 2.0 * n * dim * hidden            # fc1 and fc2
        block += 2.0 * n * hidden * 9                    # the depthwise 3x3
        total += cfg.depths[i] * block
        grids.append((n, dim))
        cin = dim
    d = cfg.decoder_dim
    total += sum(2.0 * n * dim * d for n, dim in grids)  # linear_c1..c4
    n1 = grids[0][0]
    total += 2.0 * n1 * 4 * d * d                        # linear_fuse
    total += 2.0 * n1 * d * cfg.num_classes              # linear_pred
    return total * float(batch_size)


def segformer_train_step_flops(config: SegFormerConfig | None = None, batch_size: int = 1) -> float:
    """FLOPs for one SegFormer training step (forward + backward), counted
    as three forwards."""
    return TRAIN_STEP_FLOPS_MULTIPLIER * segformer_forward_flops(config, batch_size)


def device_peak_flops(device: torch.device | str | None = None) -> float | None:
    """The device's bf16 dense peak in FLOP/s, or None where it is unknown:
    a CPU, or a CUDA card whose name the table does not list (never a
    guess). ``device`` None is the current CUDA device, and raises where
    there is none. ``FEDCRACK_PEAK_TFLOPS`` overrides."""
    import torch

    env = os.environ.get("FEDCRACK_PEAK_TFLOPS", "")
    if env:
        return float(env) * 1e12
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}; pass a CPU device to read no peak")
    name = torch.cuda.get_device_name(device).lower()
    for needle, tflops in _PEAK_TFLOPS_BF16:
        if needle in name:
            return tflops * 1e12
    return None


def mfu(step_time_s: float, flops_per_step: float, device: torch.device | str | None = None) -> float | None:
    """Model FLOPs utilization: achieved FLOP/s over the device's bf16 peak.

    None when the peak is unknown (a CPU, an unlisted card)."""
    peak = device_peak_flops(device)
    if peak is None or step_time_s <= 0.0:
        return None
    return (flops_per_step / step_time_s) / peak


def export_kernel_plane(effective: str, *, requested: str | None = None, registry=None) -> None:
    """Export the ``serve_kernel_plane_info`` labeled gauge (the Prometheus
    info-metric idiom: constant 1, state in the labels). ``requested`` is
    the ``ServeConfig.kernel_plane`` asked for; earlier states' series drop
    to 0 so exactly one ``plane`` reads 1. The port never degrades a plane
    (torch has e4m3 on every device), so the two labels agree."""
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    fam = reg.gauge(
        "serve_kernel_plane_info",
        "which quantized-predict kernel plane answers quantized traffic "
        "(constant-1 info gauge; plane=effective program body, "
        "requested=the ServeConfig ask)",
        labels=("plane", "requested"),
    )
    req = requested if requested is not None else effective
    for key, child in fam._series():
        if key != (effective, req):
            child.set(0)
    fam.labels(plane=effective, requested=req).set(1)
