"""Fused BCE loss and segmentation statistics: one pass, five sums.

The counterpart of ``fedcrack_tpu.ops.pallas_bce``. Every train step and
every eval batch reduces the same logits and mask to the BCE sum, the
correct-pixel count, the IoU intersection and union, and the crack-pixel
BCE sum; one hand-written CUDA kernel (``kernels/csrc/bce_sums.cu``) reads
the two tensors once and produces all five in one launch, its blocks'
rows folded by the last block through a per-stream workspace. The
launch's shape is :func:`bce_plan`, a function of the element count
alone.

Routing is by device, never by fallback: a CPU tensor takes the plain
PyTorch version :func:`_bce_sums_plain` (the counterpart of the JAX
package's ``_sums_jnp``, what the CPU tests hold against JAX), a CUDA
tensor launches the kernel or raises. Unlike the JAX package, where the
kernel is opt-in, on the card every call goes through the kernel.
:func:`bce_sums` counts its kernel launches in ``bce_sums.launches`` as
they run. A launch recorded into a CUDA graph's capture runs only when the
graph does: the capturing thread takes its count
(:func:`take_captured_launches`) and adds it at each run of the graph
(:func:`count_launches`).

The gradient is elementwise torch, exactly the JAX package's: only the two
BCE lanes (0 and 4) carry one; the counts are piecewise constant.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from fedcrack_tpu_torch.kernels.build import I32, I64, PTR, KernelLibrary
from fedcrack_tpu_torch.ops.losses import iou_from_counts, pos_weight_minus_one, sigmoid_bce_per_pixel

LANES = 5
# The kernel's constants (csrc/bce_sums.cu): a stage is one float4 of x
# and of y for each of a block's threads; a grid is at most one wave of an
# H100 SXM's 132 SMs; the count lanes are int32, so n < 2^31.
THREADS = 512
STAGE_ELEMS = 4 * THREADS
MAX_GRID = 132
MAX_N = 2**31 - 1

LIBRARY = KernelLibrary("bce_sums", {
    "fc_bce_sums": [PTR, PTR, PTR, PTR, PTR, I64, I32, I32, PTR],
})


class BcePlan(NamedTuple):
    """How ``bce_sums_kernel`` cuts n elements: block ``b`` of ``blocks``
    reduces the ``stages`` stages of ``STAGE_ELEMS`` elements from ``b *
    stages * STAGE_ELEMS`` on (the last block's share may be short)."""

    blocks: int
    stages: int


@functools.lru_cache(maxsize=256)
def bce_plan(n: int) -> BcePlan:
    """The kernel's launch for ``n`` elements, a function of ``n`` alone,
    so one ``n`` always reduces in the same order (bitwise repeatable): at
    most one block an SM, each as few stages as that allows."""
    if not 0 <= n <= MAX_N:
        raise ValueError(f"bce_sums takes 0 to 2^31 - 1 elements on cuda, got {n}")
    total = max(1, -(-n // STAGE_ELEMS))
    stages = -(-total // MAX_GRID)
    return BcePlan(-(-total // stages), stages)


def check_bce_plan(n: int, plan: BcePlan) -> None:
    """Raises ``ValueError`` for a plan the kernel's entry point refuses
    (``plan_ok`` in csrc/bce_sums.cu, condition for condition)."""
    blocks, stages = plan
    if not 0 <= n <= MAX_N:
        raise ValueError(f"n {n} outside 0 .. 2^31 - 1")
    if not 1 <= blocks <= MAX_GRID or stages < 1:
        raise ValueError(f"{blocks} blocks of {stages} stages: not 1 to {MAX_GRID} blocks of at least one stage")
    if blocks * stages * STAGE_ELEMS < n:
        raise ValueError(f"{blocks} blocks of {stages} stages do not cover {n} elements")


_count_lock = threading.Lock()
# Launches recorded into a CUDA graph by this thread's capture, not yet
# taken by it.
_captured = threading.local()
# (device index, stream) -> (partials [MAX_GRID, LANES] int32, ticket [1]
# int32): the scratch of a grid of several blocks, allocated once
# per stream with the ticket zeroed on that stream. Calls on one stream run
# in order, so they take turns with it; the kernel leaves the ticket at 0
# for the next call.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_workspace_lock = threading.Lock()


def _check_operands(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.shape != y.shape:
        raise ValueError(f"logits {tuple(x.shape)} and labels {tuple(y.shape)} differ in shape")
    if x.device != y.device:
        raise ValueError(f"logits and labels on different devices: {x.device} vs {y.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bce_sums runs on cuda (or plain on cpu), got {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("bce_sums wants contiguous logits and labels")
    if x.is_complex() or y.is_complex():
        raise TypeError("bce_sums takes real logits and labels")


def _bce_sums_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[bce_sum, n_correct, iou_inter, iou_union, pos_bce_sum]`` in
    float32, in plain torch."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    per_pixel = sigmoid_bce_per_pixel(x, y)
    pred = x > 0
    tgt = y > 0.5
    return torch.stack([
        per_pixel.sum(),
        (pred == tgt).to(torch.float32).sum(),
        (pred & tgt).to(torch.float32).sum(),
        (pred | tgt).to(torch.float32).sum(),
        (y * per_pixel).sum(),
    ])


def _workspace(device: torch.device, stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        with _workspace_lock:
            ws = _workspaces.get(key)
            if ws is None:
                ws = (torch.empty((MAX_GRID, LANES), dtype=torch.int32, device=device),
                      torch.zeros((1,), dtype=torch.int32, device=device))
                _workspaces[key] = ws
    return ws


def _bce_sums_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on contiguous float32 tensors of one CUDA device."""
    n = x.numel()
    partials, ticket = _workspace(x.device, torch.cuda.current_stream(x.device).cuda_stream)
    out = torch.empty((LANES,), dtype=torch.float32, device=x.device)
    LIBRARY.launch("fc_bce_sums", x.device, x.data_ptr(), y.data_ptr(), partials.data_ptr(),
                   ticket.data_ptr(), out.data_ptr(), n, *bce_plan(n))
    _count_launch()
    return out


def _count_launch() -> None:
    """One launch: counted as it runs, or, recorded into a graph's
    capture, kept for the capturing thread."""
    if torch.cuda.is_current_stream_capturing():
        _captured.launches = getattr(_captured, "launches", 0) + 1
        return
    with _count_lock:
        bce_sums.launches += 1


class BceSums(torch.autograd.Function):
    """The five sums, differentiable in logits and labels through the two
    BCE lanes (``_bce_sums_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        _check_operands(logits, labels)
        x = logits.to(torch.float32)
        y = labels.to(torch.float32)
        ctx.save_for_backward(logits, labels)
        if x.device.type == "cpu":
            return _bce_sums_plain(x, y)
        return _bce_sums_kernel(x, y)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, y = ctx.saved_tensors
        x32 = x.to(torch.float32)
        y32 = y.to(torch.float32)
        dx = dy = None
        # d(bce_sum)/dx = sigmoid(x) - y ; d(bce_sum)/dy = -x.
        # d(pos_bce_sum)/dx = y * (sigmoid(x) - y) ;
        # d(pos_bce_sum)/dy = bce + y * d(bce)/dy = bce - y*x.
        if ctx.needs_input_grad[0]:
            dx = ((g[0] + g[4] * y32) * (torch.sigmoid(x32) - y32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            bce = torch.clamp_min(x32, 0.0) - x32 * y32 + torch.log1p(torch.exp(-x32.abs()))
            dy = (g[0] * (-x32) + g[4] * (bce - y32 * x32)).to(y.dtype)
        return dx, dy


def bce_sums(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``[bce_sum, n_correct, iou_inter, iou_union, pos_bce_sum]`` as one
    float32 vector on the inputs' device. Inputs of another dtype (bf16
    logits, uint8 masks) are cast to float32 first."""
    return BceSums.apply(logits, labels)


bce_sums.launches = 0


def take_captured_launches() -> int:
    """The launches this thread recorded into CUDA graph captures since it
    last took them."""
    n = getattr(_captured, "launches", 0)
    _captured.launches = 0
    return n


def count_launches(n: int) -> None:
    """Add ``n`` launches that ran with no call to :func:`bce_sums`: a CUDA
    graph's, each time it runs."""
    with _count_lock:
        bce_sums.launches += n


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    with _count_lock:
        bce_sums.launches = 0


def fused_segmentation_metrics(
    logits: torch.Tensor,
    labels: torch.Tensor,
    pos_weight: float | None = None,
) -> dict[str, torch.Tensor]:
    """Drop-in fused equivalent of ``ops.losses.segmentation_metrics``.
    ``pos_weight`` > 1 up-weights crack pixels in the loss (mean of
    ``(1 + (pos_weight - 1)·y)·bce``); ``None``/1.0 is plain BCE."""
    return metrics_from_sums(bce_sums(logits, labels), float(logits.numel()), pos_weight)


def metrics_from_sums(sums: torch.Tensor, n: float, pos_weight: float | None = None) -> dict[str, torch.Tensor]:
    """:func:`fused_segmentation_metrics` from the five sums over ``n``
    pixels (the sums of several processes' pixels, added in rank order,
    for the spatial plane across processes)."""
    loss = sums[0] / n
    if pos_weight is not None:
        loss = loss + pos_weight_minus_one(pos_weight) * sums[4] / n
    return {
        "loss": loss,
        "pixel_acc": sums[1] / n,
        "iou": iou_from_counts(sums[2], sums[3]),
        "iou_inter": sums[2],
        "iou_union": sums[3],
    }
