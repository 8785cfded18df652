"""Local training engine: train/eval steps and the per-round fit loop.

The counterpart of ``fedcrack_tpu.train.local``. One train step runs the
train-mode ResUNet (batch-moment BatchNorm, running statistics updated in
place), reduces logits and mask through ``ops.bce.fused_segmentation_metrics``
(the hand-written CUDA kernel on the card), adds the FedProx term
``mu/2·||params − anchor||²`` when ``mu`` is not 0, and takes one Adam step
with optax's Keras-default hyperparameters.

Where JAX threads an immutable ``TrainState`` through jitted functions, the
port's :class:`TrainState` holds the module and its optimizer and the steps
update them in place (each still returns the state, so call sites read the
same). Convolutions and their gradients are cuDNN's; :func:`create_train_state`
turns TF32 off and asks cuDNN for deterministic algorithms, so two fits
from the same start give bitwise-equal weights on one card.

Metrics stay on the device during an epoch and cross to the host once at
its end; they are then summed in float64 in step order, as the JAX
package's per-step ``float()`` accumulation sums them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.data.pipeline import as_model_batch, device_prefetch, normalize_images
from fedcrack_tpu_torch.fed.algorithms import fedprox_penalty
from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from fedcrack_tpu_torch.models.resunet import BatchNorm, ResUNet
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics


@dataclasses.dataclass
class TrainState:
    """The model, its Adam optimizer, and the count of steps taken."""

    model: ResUNet
    optimizer: torch.optim.Optimizer
    learning_rate: float
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def variables(self) -> dict:
        """The flax-layout ``{'params', 'batch_stats'}`` tree, numpy, on
        the host."""
        return to_flax_variables(self.model)

    def replace_variables(self, variables: Mapping) -> "TrainState":
        """Load a flax-layout tree (the round's global weights) into the
        model in place; the optimizer keeps tracking the same parameters."""
        from_flax_variables(variables, self.model)
        return self


def make_optimizer(params, learning_rate: float = 1e-3) -> torch.optim.Adam:
    """Adam with Keras-default hyperparameters, as optax's
    ``adam(lr, b1=0.9, b2=0.999, eps=1e-7)``: eps outside the square root,
    both moments bias-corrected."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)


def configure_backends() -> None:
    """Float32 convolutions and products (no TF32) and deterministic cuDNN
    algorithms: the repo treats run-to-run determinism as a contract."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def create_train_state(
    generator: torch.Generator,
    model_config: ModelConfig | None = None,
    learning_rate: float = 1e-3,
    device: torch.device | str | None = None,
) -> TrainState:
    """A model with flax-style initial weights drawn from ``generator``,
    and its optimizer, on ``device`` (CUDA unless the caller names another;
    raises where CUDA is asked for and absent)."""
    configure_backends()
    model = ResUNet(model_config or ModelConfig(), generator=generator, device=device)
    return TrainState(model, make_optimizer(model.parameters(), learning_rate), learning_rate)


def snapshot_params(state: TrainState) -> dict[str, torch.Tensor]:
    """A detached copy of the parameters: the FedProx anchor."""
    return {k: p.detach().clone() for k, p in state.model.named_parameters()}


def _device_batch(batch, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(a, device=device) for a in batch)


def train_step(
    state: TrainState,
    batch,
    anchor_params: Mapping[str, torch.Tensor],
    mu: float = 0.0,
    pos_weight: float = 1.0,
    forward=None,
    after_backward=None,
    metrics_fn=None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One step: BCE (+ ``(mu/2)·||params − anchor||²``), Adam, BatchNorm
    running statistics. ``batch`` is (images, masks), uint8 or float32,
    numpy or tensors; ``anchor_params`` maps the model's parameter names to
    tensors on its device (:func:`snapshot_params`); the metrics come back
    as 0-d tensors on the device. Under a space-to-depth ``stem_layout``
    the images may arrive packed (``data.pipeline.space_to_depth_images``);
    the masks are full resolution either way.

    The slot plane's twins hook in here, so its step is this step:
    ``forward(model, images) -> logits`` replaces the model call (the
    fake-quant forward, recomputation), and ``after_backward(model)`` runs
    between the backward pass and the Adam step (the DP-SGD clip and
    noise). Both None (the default) run none of their code.
    ``metrics_fn(logits, masks, pos_weight=)`` replaces
    ``fused_segmentation_metrics`` (the spatial plane across processes
    sums the five sums over the ranks there).

    Spans (while a recorder is installed): ``train.forward`` (the batch to
    the device, the model call, the metrics and the FedProx term),
    ``train.backward`` (``zero_grad``, the backward pass and
    ``after_backward``) and ``train.optimizer`` (the Adam step)."""
    with tracing.span("train.forward", step=state.step):
        images, masks = as_model_batch(*_device_batch(batch, state.device))
        model = state.model
        model.train()
        logits = model(images) if forward is None else forward(model, images)
        metrics = (metrics_fn or fused_segmentation_metrics)(logits, masks, pos_weight=pos_weight)
        loss = metrics["loss"]
        if mu != 0.0:
            loss = loss + fedprox_penalty(dict(model.named_parameters()), anchor_params, mu)
    with tracing.span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if after_backward is not None:
            after_backward(model)
    with tracing.span("train.optimizer"):
        state.optimizer.step()
    state.step += 1
    out = {k: v.detach() for k, v in metrics.items()}
    out["loss"] = loss.detach()
    return state, out


def eval_step(state: TrainState, batch, pos_weight: float = 1.0) -> dict[str, torch.Tensor]:
    """Inference-mode metrics (running BatchNorm statistics). ``pos_weight``
    matches the training objective."""
    images, masks = as_model_batch(*_device_batch(batch, state.device))
    state.model.eval()
    with torch.no_grad():
        logits = state.model(images)
        return fused_segmentation_metrics(logits, masks, pos_weight=pos_weight)


def _host_rows(per_step: list[dict[str, torch.Tensor]]) -> tuple[list[str], np.ndarray]:
    """Per-step metric dicts of 0-d device tensors -> (keys, [steps, keys])
    float32 on the host, in one copy."""
    keys = list(per_step[0])
    rows = torch.stack([torch.stack([m[k] for k in keys]) for m in per_step])
    return keys, rows.cpu().numpy()


def _iou_from_counts(inter: float, union: float) -> float:
    inter32, union32 = np.float32(inter), np.float32(union)
    return float(inter32 / max(union32, np.float32(1.0))) if union32 > 0 else 1.0


def evaluate(state: TrainState, batches: Iterable, pos_weight: float = 1.0) -> dict[str, float]:
    """Metrics over a validation set: loss and accuracy averaged per batch,
    IoU from the summed global counts."""
    per_batch = [eval_step(state, b, pos_weight) for b in device_prefetch(batches, state.device)]
    if not per_batch:
        raise ValueError("empty evaluation set")
    keys, rows = _host_rows(per_batch)
    col = {k: [float(v) for v in rows[:, i]] for i, k in enumerate(keys)}
    n = len(per_batch)
    return {
        "loss": sum(col["loss"]) / n,
        "pixel_acc": sum(col["pixel_acc"]) / n,
        "iou": _iou_from_counts(sum(col["iou_inter"]), sum(col["iou_union"])),
        "num_batches": n,
    }


def recalibrate_batch_stats(state: TrainState, batches: Iterable) -> TrainState:
    """Re-estimate the BatchNorm running statistics from data: each batch's
    exact moments (a train-mode forward at momentum 0, from the carried
    statistics), averaged. Images only; the parameters are not touched, and
    the dataset's shuffle epoch is left where it was."""
    model = state.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    carried = {k: v.clone() for k, v in model.named_buffers()}
    momenta = [bn.momentum for bn in bns]
    epoch_snapshot = getattr(batches, "_epoch", None)
    acc: dict[str, torch.Tensor] = {}
    n = 0
    done = False
    try:
        for bn in bns:
            bn.momentum = 0.0
        model.train()
        with torch.no_grad():
            for images, _ in batches:
                for k, buf in model.named_buffers():
                    buf.copy_(carried[k])
                model(normalize_images(torch.as_tensor(images, device=state.device)))
                for k, buf in model.named_buffers():
                    acc[k] = buf.clone() if n == 0 else acc[k] + buf
                n += 1
        done = True
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        if epoch_snapshot is not None:
            batches._epoch = epoch_snapshot
        if not done or n == 0:
            with torch.no_grad():
                for k, buf in model.named_buffers():
                    buf.copy_(carried[k])
    if n == 0:
        raise ValueError("empty calibration set")
    with torch.no_grad():
        for k, buf in model.named_buffers():
            buf.copy_(acc[k] / n)
    return state


def local_fit(
    state: TrainState,
    train_batches: Iterable,
    epochs: int,
    mu: float = 0.0,
    anchor_params: Mapping[str, torch.Tensor] | None = None,
    prefetch: int = 2,
    pos_weight: float = 1.0,
) -> tuple[TrainState, dict[str, float]]:
    """One federated client's local fit for a round: ``epochs`` passes over
    ``train_batches`` (re-iterated per epoch, so each reshuffles), batches
    copied to the device ahead of compute. Returns the state and the mean
    train metrics of the final epoch."""
    anchor = anchor_params if anchor_params is not None else snapshot_params(state)
    last: dict[str, float] = {}
    for _ in range(max(1, epochs)):
        per_step = []
        for batch in device_prefetch(train_batches, state.device, prefetch):
            state, metrics = train_step(state, batch, anchor, mu, pos_weight)
            per_step.append(metrics)
        if not per_step:
            raise ValueError("empty training set")
        keys, rows = _host_rows(per_step)
        n = len(per_step)
        last = {k: sum(float(v) for v in rows[:, i]) / n for i, k in enumerate(keys)}
        last["num_steps"] = n
    return state, last


def count_samples(num_batches: int, batch_size: int) -> int:
    """Sample count used to weight this client in FedAvg."""
    return num_batches * batch_size
