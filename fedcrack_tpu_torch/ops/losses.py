"""Losses and quality metrics for binary crack segmentation, in torch.

A copy of ``fedcrack_tpu.ops.losses``: the loss is computed from logits
(``-y·log σ(x) − (1 − y)·log σ(−x)``, the stable form the JAX package takes
from optax) and crack IoU comes from global pixel counts. Everything
reduces in float32 whatever the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sigmoid_bce_per_pixel(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy from logits, in float32
    (``optax.sigmoid_binary_cross_entropy``)."""
    x = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return -y * F.logsigmoid(x) - (1.0 - y) * F.logsigmoid(-x)


def pos_weight_minus_one(pos_weight: float | torch.Tensor) -> float:
    """``pos_weight - 1`` rounded as float32 arithmetic rounds it (the JAX
    package subtracts from a float32 array)."""
    return float(np.float32(float(pos_weight)) - np.float32(1.0))


def sigmoid_bce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    pos_weight: float | None = None,
) -> torch.Tensor:
    """Mean binary cross-entropy over all pixels, from logits.
    ``pos_weight`` scales crack-pixel terms by ``1 + (pos_weight - 1)·y``;
    ``None``/1.0 is the reference's plain BCE."""
    per_pixel = sigmoid_bce_per_pixel(logits, labels)
    if pos_weight is not None:
        w = 1.0 + pos_weight_minus_one(pos_weight) * labels.to(torch.float32)
        per_pixel = w * per_pixel
    return per_pixel.mean()


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Fraction of pixels whose thresholded prediction matches the mask."""
    preds = torch.sigmoid(logits.to(torch.float32)) > threshold
    return (preds == (labels > 0.5)).to(torch.float32).mean()


def iou_from_counts(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """IoU with the 0/0 -> 1.0 (perfect empty prediction) convention."""
    return torch.where(union > 0, inter / torch.clamp_min(union, 1.0), torch.ones_like(inter))


def iou_counts(
    logits: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(intersection, union) pixel counts: the summable form of IoU."""
    preds = torch.sigmoid(logits.to(torch.float32)) > threshold
    tgt = labels > 0.5
    inter = (preds & tgt).to(torch.float32).sum()
    union = (preds | tgt).to(torch.float32).sum()
    return inter, union


def binary_iou(logits: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Crack (foreground) IoU over the whole batch, from global counts; an
    empty union scores 1.0."""
    inter, union = iou_counts(logits, labels, threshold)
    return iou_from_counts(inter, union)


def segmentation_metrics(
    logits: torch.Tensor,
    labels: torch.Tensor,
    pos_weight: float | None = None,
) -> dict[str, torch.Tensor]:
    """The per-batch metric dict logged every round."""
    inter, union = iou_counts(logits, labels)
    return {
        "loss": sigmoid_bce(logits, labels, pos_weight),
        "pixel_acc": pixel_accuracy(logits, labels),
        "iou": iou_from_counts(inter, union),
        "iou_inter": inter,
        "iou_union": union,
    }
