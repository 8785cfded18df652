"""Local training engine: train/eval steps and the per-round fit loop.

The counterpart of ``fedcrack_tpu.train.local``. One train step runs the
train-mode model (the ResUNet, or SegFormer under a ``SegFormerConfig``;
batch-moment BatchNorm, running statistics updated in place), reduces
logits and mask through ``ops.bce.fused_segmentation_metrics`` (the
hand-written CUDA kernel on the card), adds the FedProx term
``mu/2·||params − anchor||²`` when ``mu`` is not 0, and takes one Adam step
with optax's Keras-default hyperparameters.

Where JAX threads an immutable ``TrainState`` through jitted functions, the
port's :class:`TrainState` holds the module and its optimizer and the steps
update them in place (each still returns the state, so call sites read the
same). Convolutions and their gradients are cuDNN's; :func:`create_train_state`
turns TF32 off and asks cuDNN for deterministic algorithms, so two fits
from the same start give bitwise-equal weights on one card.

On the card a step with none of the hooks replays its forward and
backward as one CUDA graph (:class:`StepGraphs`): the same kernels as the
eager step, launched by one call, so the host runs ahead of the card.

Metrics stay on the device during an epoch and cross to the host once at
its end; they are then summed in float64 in step order, as the JAX
package's per-step ``float()`` accumulation sums them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from fedcrack_tpu_torch.configs import ModelConfig, SegFormerConfig
from fedcrack_tpu_torch.data.pipeline import as_model_batch, device_prefetch, normalize_images
from fedcrack_tpu_torch.fed.algorithms import fedprox_penalty
from fedcrack_tpu_torch.models import build_model
from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from fedcrack_tpu_torch.models.resunet import BatchNorm, ResUNet
from fedcrack_tpu_torch.models.segformer import SegFormer
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.ops import attention, bce
from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics


@dataclasses.dataclass
class TrainState:
    """The model, its Adam optimizer, the count of steps taken, and the
    step's CUDA graphs (built at the first step on the card; None
    elsewhere)."""

    model: ResUNet | SegFormer
    optimizer: torch.optim.Optimizer
    learning_rate: float
    step: int = 0
    graphs: "StepGraphs | None" = dataclasses.field(default=None, repr=False, compare=False)

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
    model_config: ModelConfig | SegFormerConfig | None = None,
    learning_rate: float = 1e-3,
    device: torch.device | str | None = None,
) -> TrainState:
    """A model with its initial weights drawn from ``generator`` (the U-Net
    flax-style, SegFormer as published), and its optimizer, on ``device``
    (CUDA unless the caller names another; raises where CUDA is asked for
    and absent)."""
    configure_backends()
    model = build_model(model_config or ModelConfig(), generator=generator, device=device)
    return TrainState(model, make_optimizer(model.parameters(), learning_rate), learning_rate)


def snapshot_params(state: TrainState) -> dict[str, torch.Tensor]:
    """A detached copy of the parameters: the FedProx anchor."""
    return {k: p.detach().clone() for k, p in state.model.named_parameters()}


def _device_batch(batch, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(a, device=device) for a in batch)


# Steps by path: "eager" (a hook, FedProx, no graph backend, or a key's
# first step), "capture" (a key's second step), "replay" (every later one).
STEP_GRAPH_TOTAL = REGISTRY.counter(
    "train_step_graph_total", "train steps by path: eager, capture (a key's second step) or replay",
    labels=("path",))


# Held through every warm-up and capture in the process. A capture starts
# by synchronizing the device, which another thread's capture in progress
# would not survive, and two states may draw the same side stream from
# PyTorch's pool, whose capture would take in the other's warm-up.
_SIDE_STREAM_LOCK = threading.Lock()


class CudaGraphs:
    """The capture/replay interface on the card: warm-up and capture on
    one side stream, one thread at a time in the process, every graph
    captured through it in one memory pool, freed with the last state that
    holds it. A state's graphs take one; the slot plane's states, which
    replay in turn on one stream, share one (``parallel.fedavg_mesh``), so
    a round holds one step's activations, not one a slot."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn: Callable[[], list]) -> list:
        """``fn()`` run eagerly on the side stream, ordered after the
        work already queued and before the work queued next."""
        current = torch.cuda.current_stream(self.stream.device)
        with _SIDE_STREAM_LOCK:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = fn()
            current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], list]) -> tuple[Any, list]:
        """``fn`` captured into a graph and the graph run once: ``(graph,
        outputs)``, the outputs tensors that each ``graph.replay()``
        writes again."""
        graph = torch.cuda.CUDAGraph()
        with _SIDE_STREAM_LOCK, torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                                 capture_error_mode="thread_local"):
            out = fn()
        graph.replay()
        return graph, out


def graph_backend(device: torch.device) -> CudaGraphs | None:
    """A capture/replay backend for states on ``device``: a new
    :class:`CudaGraphs` (its own pool) on the card, None elsewhere."""
    return CudaGraphs(device) if device.type == "cuda" else None


@dataclasses.dataclass
class _Captured:
    """One key's graph: the static inputs it reads, the metrics and
    gradients it writes, the ``bce_sums`` launches and the attention
    calls it holds."""

    images: torch.Tensor
    masks: torch.Tensor
    graph: Any = None
    metrics: dict | None = None
    grads: list | None = None
    launches: int = 0
    attention_calls: dict = dataclasses.field(default_factory=dict)


class StepGraphs:
    """A state's train steps as graphs, one a key: the batch's shapes and
    dtypes, ``pos_weight`` and the addresses of the model's parameters and
    statistics. A key's first step runs eagerly on the backend's side
    stream (the warm-up), its second is captured and run, and every later
    one replays. The graph holds the forward (BatchNorm's moments and
    running statistics included), the metrics through ``bce_sums`` and
    the backward from gradients of None, so it writes the gradients and
    never adds to them; Adam stays outside it."""

    def __init__(self, backend):
        self.backend = backend
        self._steps: dict[tuple, _Captured] = {}

    def path(self, key: tuple) -> str:
        entry = self._steps.get(key)
        return "eager" if entry is None else "capture" if entry.graph is None else "replay"

    def run(self, key: tuple, model: ResUNet | SegFormer, params: list, images: torch.Tensor, masks: torch.Tensor,
            pos_weight: float) -> dict:
        """The step's forward and backward for ``key`` by :meth:`path`,
        into the static inputs copied from ``images`` and ``masks``: the
        metrics (the graph's copied out)."""
        model.train()
        entry = self._steps.get(key)
        first = entry is None
        if first:
            # The static inputs, on the current stream, outlive every replay.
            device = params[0].device
            entry = self._steps[key] = _Captured(torch.empty_like(images, device=device),
                                                 torch.empty_like(masks, device=device))
        entry.images.copy_(images)
        entry.masks.copy_(masks)

        def body():
            return _forward_backward(model, params, entry.images, entry.masks, pos_weight)

        if first:
            return self.backend.warm_up(body)[0]
        if entry.graph is None:
            bce.take_captured_launches()
            attention.take_captured_calls()
            entry.graph, (entry.metrics, entry.grads) = self.backend.capture(body)
            entry.launches = bce.take_captured_launches()
            entry.attention_calls = attention.take_captured_calls()
        else:
            entry.graph.replay()
        bce.count_launches(entry.launches)
        attention.count_calls(entry.attention_calls)
        return {k: v.clone() for k, v in entry.metrics.items()}

    def point_grads(self, key: tuple, params: list) -> None:
        """Each parameter's ``.grad`` at the gradient ``key``'s graph
        writes (a caller may have set it to None since), once the key has
        one."""
        grads = self._steps[key].grads
        if grads is not None:
            for p, g in zip(params, grads):
                p.grad = g


def _forward_backward(model: ResUNet | SegFormer, params: list, images: torch.Tensor, masks: torch.Tensor,
                      pos_weight: float) -> tuple[dict, list]:
    """The graph's body: ``(metrics, gradients)`` of one step, the
    gradients computed from None."""
    images, masks = as_model_batch(images, masks)
    metrics = fused_segmentation_metrics(model(images), masks, pos_weight=pos_weight)
    for p in params:
        p.grad = None
    metrics["loss"].backward()
    return {k: v.detach() for k, v in metrics.items()}, [p.grad for p in params]


def _graph_key(model: ResUNet | SegFormer, params: list, images: torch.Tensor, masks: torch.Tensor,
               pos_weight: float) -> tuple:
    return (tuple(images.shape), images.dtype, tuple(masks.shape), masks.dtype, float(pos_weight),
            tuple(t.data_ptr() for t in params), tuple(t.data_ptr() for t in model.buffers()))


def _step_graphs(state: TrainState) -> StepGraphs | None:
    """The state's graphs, made at its first step on the card with a
    backend of their own unless the state was given graphs."""
    if state.graphs is None and state.device.type == "cuda":
        state.graphs = StepGraphs(graph_backend(state.device))
    return state.graphs


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

    With no hook and ``mu`` 0, on the card, the forward and backward run
    through the state's :class:`StepGraphs` (the same arithmetic, bit for
    bit): the batch is copied into the graph's inputs, the graph replayed,
    each parameter's ``.grad`` pointed at the graph's gradient and the
    metrics copied out; Adam then steps eagerly. Everything else, and the
    CPU, runs eagerly.

    Spans (while a recorder is installed): ``train.forward`` (the batch to
    the device, the model call, the metrics and the FedProx term; on the
    graph path the copies and the replay, which runs the backward too;
    ``graph`` is ``eager``, ``capture`` or ``replay``), ``train.backward``
    (``zero_grad``, the backward pass and ``after_backward``; on the graph
    path the gradients pointed at) and ``train.optimizer`` (the Adam
    step). ``train_step_graph_total{path}`` counts the steps by path.
    ``model`` on ``train.forward`` names the model (``resunet`` or
    ``segformer``)."""
    model = state.model
    name = "segformer" if isinstance(model, SegFormer) else "resunet"
    graphs = None
    if forward is None and after_backward is None and metrics_fn is None and mu == 0.0:
        graphs = _step_graphs(state)
    if graphs is not None:
        images, masks = (torch.as_tensor(a) for a in batch)
        params = list(model.parameters())
        key = _graph_key(model, params, images, masks, pos_weight)
        path = graphs.path(key)
        with tracing.span("train.forward", step=state.step, graph=path, model=name):
            metrics = graphs.run(key, model, params, images, masks, pos_weight)
        with tracing.span("train.backward"):
            graphs.point_grads(key, params)
        loss = metrics["loss"]
    else:
        path = "eager"
        with tracing.span("train.forward", step=state.step, graph=path, model=name):
            images, masks = as_model_batch(*_device_batch(batch, state.device))
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
    STEP_GRAPH_TOTAL.labels(path=path).inc()
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
