"""A federated round of several clients on one device: the slot plane.

The counterpart of ``fedcrack_tpu.parallel.fedavg_mesh``. There a round is
one ``shard_map`` over ``Mesh(('clients', 'batch'))``: each client's local
fit a ``lax.scan`` on its own chip, FedAvg an ordered fold over the clients
axis. Here the round's ``C`` client slots (``parallel.slots.make_mesh``)
run on one device in client order:

- every slot trains, active or not, from the round's global weights, with
  a fresh Adam (the reference rebuilds its model per round) and the
  round's global as its FedProx anchor; its every step is
  ``train.local.train_step``, the host path's step, so a slot's trained
  weights equal a host fit of the same data on the same device bit for
  bit, and every step reduces its logits through ``bce_sums``;
- the active slots' ``{params, batch_stats}`` fold into an accumulator on
  the device in client order with weight ``active · n_samples``
  (``fed.aggregation.mesh_ordered_fold``), and the empty-cohort guard
  returns the incoming global (``mesh_finish_cohort_mean``);
- metrics come back for all ``C`` slots, from each one's last epoch.

The twins of the JAX round come across with their null-build discipline:
with ``update_codec``, ``lowp`` and DP off the round runs none of their
code. ``update_codec`` applies the codec's value map to each slot's round
delta before the fold (``compress.mesh``), the top-k twin keeping each
slot's error-feedback residual on the device; ``lowp="fake_quant_int8"``
runs each forward on straight-through int8 fake-quant weights
(``kernels.dequant.fake_quant_leaf``); ``dp_clip_norm`` clips each step's
gradients and adds seeded noise between the backward pass and the Adam
step (``privacy.dpsgd``), the noise's round seed the per-dispatch counter
that ``codec_state`` restores on a replay.

Running the slots one after another is the first form, not the fast one:
batching them into one launch per operation waits in ROADMAP Queue 2.

Spans (``obs.spans``, while a recorder is installed): each client slot is
a ``mesh.slot`` holding its ``mesh.slot_init`` (weights loaded, Adam made),
its steps' ``train.*`` spans and its ``mesh.fold`` (the codec, if any, and
the fold into the carry); the round's mean and metrics are ``mesh.finish``.

A mesh that spans processes (``make_mesh(..., group=)``) splits the
``clients`` axis into one contiguous block per rank. ``round_fn`` then
takes this rank's clients' data only (leading dimension the block's
size), with ``active`` and ``n_samples`` still global ``[C]``. Each rank
fits its slots as above, keyed by the global client index (the int8
twin's rounding seed, the DP noise chain, the top-k residual, which stays
with the rank that owns the client); the ranks then all-gather the slots'
updates and metrics, and every rank folds all ``C`` updates in client
order. No ``all_reduce`` decides the global: every rank holds the bits of
the same round run in one process. The segmented round gathers the same
way, and so does the cohort round, group by group.

The inner axis splits each client's step into shards with sync-BN and
averaged gradients. A ``batch`` axis of ``n`` needs a per-step batch that
divides by ``n`` (a batch that does not is refused, as the JAX sharding
refuses it); on one card its sub-batches folded in order are the batch
itself, so the step is the model's over the whole batch, whose
BatchNorm takes the moments of every sub-batch: sync-BN. The loss and
pixel accuracy are then the whole batch's means, which are the means
over the equal-sized shards of theirs (the JAX ``_epoch_runner``'s
pmean), and the IoU counts its sums (the psum). A ``space`` axis
(:func:`build_spatial_federated_round`) runs each step through the
spatial plane's fold forward (``parallel.spatial``).

The segmented round (:class:`SegmentedRound`) keeps each slot's model and
optimizer between segment calls, so the driver can stage between them; the
cohort round (:class:`CohortRound`) runs a larger cohort in groups of
``C`` slots that continue one fold carry. Both equal the monolithic round
on the same inputs bit for bit, because every slot runs the same steps and
the fold is one expression tree however it is split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.compress.codecs import encoded_bytes_model
from fedcrack_tpu_torch.compress.mesh import int8_roundtrip, topk_roundtrip, validate_mesh_codec, zero_residual_like
from fedcrack_tpu_torch.configs import ModelConfig, SegFormerConfig
from fedcrack_tpu_torch.fed.aggregation import (
    mesh_finish_cohort_mean,
    mesh_ordered_fold,
    mesh_zero_sums,
)
from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from fedcrack_tpu_torch.models import build_model
from fedcrack_tpu_torch.models.convert import flax_to_state_dict, from_flax_variables, weight_to_kernel
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.ops.losses import iou_from_counts
from fedcrack_tpu_torch.parallel.multihost import ProcessSpan
from fedcrack_tpu_torch.parallel.slots import BATCH, CLIENTS, SlotMesh
from fedcrack_tpu_torch.parallel.spatial import SPACE, check_layout, spatial_forward, validate_shape
from fedcrack_tpu_torch.train.local import (
    StepGraphs,
    TrainState,
    configure_backends,
    graph_backend,
    make_optimizer,
    train_step,
)


def _host_view(x) -> np.ndarray | None:
    """Host float32 view of a cohort mask or weight vector. (The JAX
    package returns None for a mask no process can fetch whole; on one
    device every mask is fetchable. Kept as a seam: the in-round guard
    test replaces it.)"""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


def _host_cohort_check(active, n_samples):
    """Raise on an all-dropped cohort; return host float32 views (or the
    inputs untouched when :func:`_host_view` declines)."""
    active_h, n_samples_h = _host_view(active), _host_view(n_samples)
    if active_h is not None and n_samples_h is not None:
        if float(np.sum(active_h * n_samples_h)) <= 0.0:
            raise ValueError(
                "non-positive total FedAvg weight: every client dropped "
                f"out (active={active_h.tolist()}, n_samples={n_samples_h.tolist()})"
            )
        return active_h, n_samples_h
    return active, n_samples


def _as_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (no copy when it
    is one there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


def _device_tree(variables, device: torch.device) -> dict:
    """The ``{'params', 'batch_stats'}`` tree with every leaf a tensor on
    ``device``."""
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    return tree_map(lambda leaf: _as_device(leaf, device), tree)


def _model_variables(model: torch.nn.Module) -> dict:
    """The model's weights as a flax-layout tree of tensors on its device:
    views of its storage (kernels are permuted views), valid until the
    model changes."""
    params: dict = {}
    stats: dict = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "weight":
            leaf, value = "kernel", weight_to_kernel(value)
        root = stats if leaf in ("mean", "var") else params
        for name in path:
            root = root.setdefault(name, {})
        root[leaf] = value
    return {"params": params, "batch_stats": stats}


def _flax_param_order(model: torch.nn.Module) -> list[str]:
    """The model's parameter names in the JAX package's flatten order of
    the params tree (sorted paths, ``weight`` named ``kernel``)."""
    def path(name: str) -> tuple:
        *mods, leaf = name.split(".")
        return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)

    return sorted((n for n, _ in model.named_parameters()), key=path)


def _tree_sub(a, b):
    return tree_map(lambda x, y: x.to(torch.float32) - y.to(torch.float32), a, b)


def _tree_add_cast(base, delta):
    return tree_map(lambda b, d: (b.to(torch.float32) + d.to(torch.float32)).to(b.dtype), base, delta)


def _epoch_reductions(per_step: list[dict]) -> dict:
    return {
        "loss": torch.mean(torch.stack([m["loss"] for m in per_step])),
        "pixel_acc": torch.mean(torch.stack([m["pixel_acc"] for m in per_step])),
        "iou_inter": torch.sum(torch.stack([m["iou_inter"] for m in per_step])),
        "iou_union": torch.sum(torch.stack([m["iou_union"] for m in per_step])),
    }


def _stack_slots(per_slot: list[dict]) -> dict:
    """Per-slot last-epoch dicts of 0-d tensors -> one dict of ``[C]``."""
    return {k: torch.stack([m[k] for m in per_slot]) for k in per_slot[0]}


def _fold_slot(variables: dict, active_c, n_c, sums: tuple) -> tuple:
    """One slot into the fold carry with weight ``active · n_samples``, a
    float32 product on the host."""
    return mesh_ordered_fold(variables, np.float32(active_c) * np.float32(n_c), sums)


def _flat_update(tree) -> torch.Tensor:
    """One slot's update tree as one float32 vector in leaf order (a
    copy: the slot's model is reused by the next slot)."""
    return torch.cat([leaf.detach().reshape(-1).to(torch.float32) for leaf in tree_leaves(tree)])


def _gather_slots(span: ProcessSpan, flats: list, like) -> list:
    """Every rank's slot updates in global client order, each a tree shaped
    as ``like`` whose leaves are views of the gathered vectors."""
    leaves, treedef = tree_flatten(like)
    sizes = [int(leaf.numel()) for leaf in leaves]
    out = []
    for part in span.all_gather(torch.stack(flats)):
        for row in part:
            views = [v.view(tuple(leaf.shape)) for v, leaf in zip(torch.split(row, sizes), leaves)]
            out.append(tree_unflatten(treedef, views))
    return out


def _gather_metrics(span: ProcessSpan, last: dict) -> dict:
    """Every rank's ``[C_local]`` last-epoch counts as global ``[C]``."""
    keys = sorted(last)
    parts = span.all_gather(torch.stack([last[k] for k in keys]))
    stacked = torch.cat(parts, dim=1)
    return {k: stacked[i] for i, k in enumerate(keys)}


def _round_metrics(last: dict, active, device: torch.device) -> dict:
    """The round's ``[C]`` metrics from the slots' last-epoch counts."""
    return {
        "loss": last["loss"],
        "pixel_acc": last["pixel_acc"],
        "iou": iou_from_counts(last["iou_inter"], last["iou_union"]),
        # A pageable copy with no wait: CUDA stages the bytes before it returns.
        "active": torch.as_tensor(np.asarray(active, np.float32)).to(device, non_blocking=True),
    }


@dataclasses.dataclass
class _Slot:
    """One client slot's carry: its model, its optimizer and its DP step
    counter."""

    state: TrainState
    dp_step: int = 0


def _refuse_segformer(model_config, *features: tuple[str, bool]) -> None:
    """SegFormer trains on the slot plane's plain step only: a twin or
    plane it does not have is refused by name."""
    on = [name for name, used in features if used]
    if isinstance(model_config, SegFormerConfig) and on:
        raise ValueError(f"model_type 'segformer' trains on the slot plane's plain step only; "
                         f"{', '.join(on)} is the residual U-Net's")


class _SlotFit:
    """The per-client local-fit core, shared by the monolithic, segmented
    and cohort rounds (the JAX package's ``_epoch_runner``): sharing it is
    what makes them equal by construction. Its slot states' step graphs
    share one capture backend, so one memory pool: the slots replay in
    turn on one stream."""

    def __init__(self, model_config: ModelConfig | SegFormerConfig, learning_rate: float, fedprox_mu: float,
                 pos_weight: float, remat: bool, device: torch.device, lowp: str | None = None,
                 dp: dict | None = None, forward: Callable | None = None):
        _refuse_segformer(model_config, ("FedProx", fedprox_mu != 0.0), ("remat", remat),
                          ("lowp", lowp not in (None, "null")), ("DP-SGD", dp is not None))
        configure_backends()
        self.model_config = model_config
        self.learning_rate = float(learning_rate)
        self.mu = float(fedprox_mu)
        self.pos_weight = float(pos_weight)
        self.device = device
        self.dp = dp
        self._workers: list[TrainState] = []
        self._graphs = graph_backend(device)
        # ``forward(model, images)``: the spatial plane's fold forward, or
        # None for the model's own.
        fwd = forward
        if lowp == "fake_quant_int8":
            from fedcrack_tpu_torch.kernels.dequant import fake_quant_leaf

            def fwd(model, images):
                params = {n: fake_quant_leaf(p, channel_axis=0) if p.ndim >= 2 else p
                          for n, p in model.named_parameters()}
                return torch.func.functional_call(model, params, (images,))

        self.after_backward = None
        if remat:
            inner = fwd
            saved: list = []

            def fwd(model, images):
                # Recompute the forward in the backward pass; the recompute
                # moves the BatchNorm running statistics a second time, so
                # the first forward's are put back after the backward.
                call = model if inner is None else (lambda x: inner(model, x))
                logits = torch.utils.checkpoint.checkpoint(call, images, use_reentrant=False)
                saved[:] = [b.detach().clone() for b in model.buffers()]
                return logits

            def restore(model):
                with torch.no_grad():
                    for b, s in zip(model.buffers(), saved):
                        b.copy_(s)

            self.after_backward = restore
        self.forward = fwd

    def worker(self, i: int) -> TrainState:
        """Slot state ``i`` (built at first use, reused across rounds)."""
        while len(self._workers) <= i:
            model = build_model(self.model_config, device=self.device)
            graphs = None if self._graphs is None else StepGraphs(self._graphs)
            self._workers.append(TrainState(model, make_optimizer(model.parameters(), self.learning_rate),
                                            self.learning_rate, graphs=graphs))
        return self._workers[i]

    def init(self, i: int, gvars: dict) -> _Slot:
        """Slot ``i`` from the round's global: weights loaded, Adam fresh."""
        with tracing.span("mesh.slot_init") as init_span:
            if init_span is not None:
                init_span.set(leaves=len(tree_leaves(gvars)))
            state = self.worker(i)
            from_flax_variables(gvars, state.model)
            state.optimizer = make_optimizer(state.model.parameters(), self.learning_rate)
            state.step = 0
            return _Slot(state)

    def _after_backward(self, slot: _Slot, client: int, round_seed: int | None):
        if self.dp is None:
            return self.after_backward
        from fedcrack_tpu_torch.privacy.dpsgd import dp_grad_transform, dp_step_key

        remat_restore = self.after_backward
        dp = self.dp

        def after(model):
            if remat_restore is not None:
                remat_restore(model)
            named = dict(model.named_parameters())
            order = _flax_param_order(model)
            seed = dp_step_key(dp["seed"], round_seed, client, slot.dp_step)
            grads = dp_grad_transform([named[n].grad for n in order], seed, dp["clip"], dp["sigma"])
            for n, g in zip(order, grads):
                named[n].grad = g
            slot.dp_step += 1

        return after

    def run_epochs(self, slot: _Slot, chunks: Sequence[tuple], n_epochs: int, anchor: dict, *,
                   client: int, idx=None, round_seed: int | None = None) -> list[dict]:
        """``n_epochs`` passes over the slot's data: each step-axis chunk
        ``(images [steps, B, ...], masks)`` in order, or, resident,
        ``chunks`` the one ``(pool_images [N, ...], pool_masks)`` pair and
        ``idx`` the ``[epochs, steps, B]`` gather plan. Returns each
        epoch's reductions (0-d tensors on the device)."""
        after = self._after_backward(slot, client, round_seed)
        out = []
        if idx is not None:
            if len(chunks) != 1:
                raise ValueError("resident mode takes exactly one pool chunk")
            if idx.shape[0] != n_epochs:
                raise ValueError(f"idx carries {idx.shape[0]} epochs, round runs {n_epochs}")
            pool_i, pool_m = chunks[0]
            for e in range(n_epochs):
                per_step = []
                for s in range(idx.shape[1]):
                    rows = idx[e, s]
                    batch = (pool_i.index_select(0, rows), pool_m.index_select(0, rows))
                    per_step.append(self._step(slot, batch, anchor, after))
                out.append(_epoch_reductions(per_step))
            return out
        for _ in range(n_epochs):
            per_step = []
            for imgs, msks in chunks:
                for s in range(imgs.shape[0]):
                    per_step.append(self._step(slot, (imgs[s], msks[s]), anchor, after))
            out.append(_epoch_reductions(per_step))
        return out

    def _step(self, slot: _Slot, batch, anchor: dict, after) -> dict:
        _, metrics = train_step(slot.state, batch, anchor, self.mu, self.pos_weight,
                                forward=self.forward, after_backward=after)
        return metrics


def _anchor(gvars: dict, model: torch.nn.Module) -> dict:
    """The FedProx anchor (the round's global params) by parameter name."""
    sd = flax_to_state_dict({"params": gvars["params"]})
    return {n: sd[n] for n, _ in model.named_parameters()}


def _validate_channels(model_config: ModelConfig | SegFormerConfig):
    """The staging-layout check: ``C`` channels, or ``4C`` (images packed
    by ``data.pipeline.space_to_depth_images``) under a space-to-depth
    ``stem_layout`` (the U-Net's; SegFormer has none)."""
    in_ch = model_config.in_channels
    layout = getattr(model_config, "stem_layout", "reference")
    allowed = (in_ch, 4 * in_ch) if layout != "reference" else (in_ch,)

    def validate(images) -> None:
        ch = images.shape[-1]
        if ch not in allowed:
            raise ValueError(
                f"images carry {ch} channels; stem_layout={layout!r} accepts {allowed} "
                "(4x = space_to_depth-packed staging)"
            )

    return validate


def _check_step_batch(images, n_inner: int) -> None:
    """A streamed ``[C, steps, B, ...]`` slab's batch must divide over the
    ``batch`` axis."""
    if images.shape[2] % n_inner:
        raise ValueError(f"per-step batch {images.shape[2]} does not divide over the {n_inner}-way inner axis")


def _require_axes(mesh: SlotMesh, *axes: str) -> None:
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, but this round builder needs "
            f"{axes} (missing {missing})"
        )


def _check_resident_inputs(pool, idx, n_client_shards, epochs, n_inner, validate_data) -> None:
    """Host-side validation of the resident round's data contract."""
    pool_imgs, pool_msks = pool
    if pool_imgs.shape[0] != n_client_shards:
        raise ValueError(
            f"pool carries {pool_imgs.shape[0]} clients, mesh has {n_client_shards} on the '{CLIENTS}' axis"
        )
    if tuple(pool_imgs.shape[:2]) != tuple(pool_msks.shape[:2]):
        raise ValueError(
            f"pool images/masks disagree on [C, N]: {tuple(pool_imgs.shape[:2])} vs {tuple(pool_msks.shape[:2])}"
        )
    validate_data(pool_imgs)
    if idx.ndim != 4 or idx.shape[0] != n_client_shards:
        raise ValueError(f"idx must be [C={n_client_shards}, epochs, steps, B]; got {tuple(idx.shape)}")
    if idx.shape[1] != epochs:
        raise ValueError(f"idx carries {idx.shape[1]} epochs, the round runs {epochs}")
    if idx.shape[-1] % n_inner:
        raise ValueError(f"per-step batch {idx.shape[-1]} does not divide over the {n_inner}-way inner axis")
    # Bounds-check the plan against the pool now: an index outside it would
    # gather wrong data on the device (or fault) where numpy raises.
    n_pool = pool_imgs.shape[1]
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= n_pool:
        raise ValueError(f"gather plan indexes [{lo}, {hi}] outside the {n_pool}-sample pool")


def _plan_tensor(idx, device: torch.device) -> torch.Tensor:
    return _as_device(np.asarray(idx, np.int64) if not isinstance(idx, torch.Tensor) else idx, device).long()


def _build_round(
    mesh: SlotMesh,
    model_config: ModelConfig,
    learning_rate: float,
    local_epochs: int,
    fedprox_mu: float,
    *,
    inner_axis: str = BATCH,
    forward: Callable | None = None,
    validate_data: Callable | None = None,
    pos_weight: float = 1.0,
    remat: bool = False,
    data_placement: str = "streamed",
    update_codec: str | None = None,
    topk_fraction: float = 0.01,
    lowp: str | None = None,
    dp_clip_norm: float = 0.0,
    dp_noise_multiplier: float = 0.0,
    dp_seed: int = 0,
):
    """The monolithic round (see :func:`build_federated_round`): the
    client's step split over ``inner_axis``, run by ``forward`` (None: the
    model's own), the data checked by ``validate_data``."""
    n_clients = mesh.shape[CLIENTS]
    span = mesh.span
    local = mesh.local_range(CLIENTS)
    n_inner = mesh.shape[inner_axis]
    # Only a batch axis splits the batch; the space axis splits H.
    n_split = n_inner if inner_axis == BATCH else 1
    device = mesh.device
    epochs = max(1, local_epochs)
    if data_placement not in ("streamed", "resident"):
        raise ValueError(f"data_placement must be 'streamed' or 'resident', got {data_placement!r}")
    resident = data_placement == "resident"
    codec = validate_mesh_codec(update_codec)
    if not 0.0 < topk_fraction <= 1.0:
        raise ValueError(f"topk_fraction must be in (0, 1], got {topk_fraction}")
    topk = codec == "topk_delta"
    if lowp in (None, "null"):
        lowp = "null"
    elif lowp != "fake_quant_int8":
        raise ValueError(f"lowp must be None, 'null' or 'fake_quant_int8', got {lowp!r}")
    if dp_clip_norm < 0.0:
        raise ValueError(f"dp_clip_norm must be >= 0, got {dp_clip_norm}")
    if dp_noise_multiplier < 0.0:
        raise ValueError(f"dp_noise_multiplier must be >= 0, got {dp_noise_multiplier}")
    dp_on = dp_clip_norm > 0.0
    if dp_noise_multiplier > 0.0 and not dp_on:
        raise ValueError(
            "dp_noise_multiplier > 0 requires dp_clip_norm > 0 (noise is calibrated to the clip norm)"
        )
    # The per-dispatch seed feeds int8's stochastic rounding and the DP
    # noise chain; either consumer pulls it in.
    needs_seed = codec == "int8" or dp_on
    dp = {"clip": float(dp_clip_norm), "sigma": float(dp_noise_multiplier), "seed": int(dp_seed)} if dp_on else None
    fit = _SlotFit(model_config, learning_rate, fedprox_mu, pos_weight, remat, device,
                   lowp=None if lowp == "null" else lowp, dp=dp, forward=forward)
    validate_data = validate_data or _validate_channels(model_config)
    ef_state: dict = {"ef": None, "calls": 0}

    def _wire_bytes_per_client(gvars) -> int:
        """Analytic wire bytes of one client's upload under this codec
        (``compress.codecs.encoded_bytes_model``): a model, not a
        measure, since the slot plane moves no wire bytes."""
        return encoded_bytes_model([int(leaf.numel()) for leaf in tree_leaves(gvars)], codec,
                                   topk_fraction=topk_fraction)

    def _dispatch(variables, slot_data, active, n_samples):
        gvars = _device_tree(variables, device)
        if round_fn.wire_bytes_per_client is None:
            round_fn.wire_bytes_per_client = _wire_bytes_per_client(gvars)
        seed_in = ef_state["calls"] if needs_seed else None
        if topk and ef_state["ef"] is None:
            ef_state["ef"] = [zero_residual_like(gvars) for _ in local]
        ef_new = list(ef_state["ef"]) if topk else None
        anchor = _anchor(gvars, fit.worker(0).model)
        sums = mesh_zero_sums(gvars)
        lasts, flats = [], []
        for i, c in enumerate(local):
            with tracing.span("mesh.slot", client=c) as slot_span:
                slot = fit.init(0, gvars)
                chunks, idx = slot_data(i)
                per_epoch = fit.run_epochs(slot, chunks, epochs, anchor, client=c, idx=idx, round_seed=seed_in)
                lasts.append(per_epoch[-1])
                with tracing.span("mesh.fold") as fold_span:
                    update = _model_variables(slot.state.model)
                    if fold_span is not None:
                        fold_span.set(leaves=len(tree_leaves(update)))
                    if round_fn.slot_hook is not None:
                        round_fn.slot_hook(c, tree_map(lambda t: t.detach().clone(), update))
                    if codec == "int8":
                        update = _tree_add_cast(gvars, int8_roundtrip(_tree_sub(update, gvars), (seed_in, c)))
                    elif topk:
                        kept, residual = topk_roundtrip(_tree_sub(update, gvars), ef_state["ef"][i], topk_fraction)
                        update = _tree_add_cast(gvars, kept)
                        # The residual advances only for an active client: on
                        # the wire an inactive client never encodes.
                        if float(active[c]) > 0.0:
                            ef_new[i] = residual
                    if span is None:
                        sums = _fold_slot(update, active[c], n_samples[c], sums)
                    else:
                        flats.append(_flat_update(update))
                if slot_span is not None:
                    slot_span.set(steps=slot.state.step)
        if span is not None:
            before = dict(span.stats)
            with tracing.span("mesh.fold") as fold_span:
                if fold_span is not None:
                    fold_span.set(leaves=len(tree_leaves(gvars)))
                for c, update in enumerate(_gather_slots(span, flats, gvars)):
                    sums = _fold_slot(update, active[c], n_samples[c], sums)
        with tracing.span("mesh.finish"):
            last = _stack_slots(lasts)
            if span is not None:
                last = _gather_metrics(span, last)
                round_fn.last_gather = {k: span.stats[k] - before[k] for k in ("seconds", "bytes")}
            new_vars = mesh_finish_cohort_mean(sums[0], sums[1], gvars)
            metrics = _round_metrics(last, active, device)
        if needs_seed:
            ef_state["calls"] += 1
        if topk:
            ef_state["ef"] = ef_new
        return new_vars, metrics

    if resident:

        def round_fn(variables, pool, idx, active, n_samples):
            _check_resident_inputs(pool, idx, len(local), epochs, n_split, validate_data)
            active, n_samples = _host_cohort_check(active, n_samples)
            pool_i, pool_m = (_as_device(p, device) for p in pool)
            plan = _plan_tensor(idx, device)
            return _dispatch(variables, lambda c: ([(pool_i[c], pool_m[c])], plan[c]), active, n_samples)

    else:

        def round_fn(variables, images, masks, active, n_samples):
            if images.shape[0] != len(local):
                raise ValueError(
                    f"data carries {images.shape[0]} clients, mesh has {n_clients} on the '{CLIENTS}' axis"
                    + ("" if span is None else f", {len(local)} of them in this process")
                )
            validate_data(images)
            _check_step_batch(images, n_split)
            active, n_samples = _host_cohort_check(active, n_samples)
            imgs, msks = _as_device(images, device), _as_device(masks, device)
            return _dispatch(variables, lambda c: ([(imgs[c], msks[c])], None), active, n_samples)

    round_fn.data_placement = data_placement
    round_fn.update_codec = codec
    round_fn.lowp = lowp
    round_fn.dp = "dpsgd" if dp_on else "null"
    round_fn.wire_bytes_per_client = None
    # Across processes: the last dispatch's gather, its host-clock seconds
    # and the bytes this rank moved.
    round_fn.last_gather = None
    # Called as slot_hook(client, variables) with each slot's trained
    # weights (a copy, before any codec) when set: the per-slot check
    # against a host fit.
    round_fn.slot_hook = None
    round_fn.reset_ef = lambda: ef_state.update(ef=None, calls=0)

    def _ef_view():
        if ef_state["ef"] is None:
            return None
        return tree_map(lambda *xs: torch.stack(xs), *ef_state["ef"])

    # The top-k residuals stacked to [C, ...] per leaf, this process's
    # clients' (None before the first top-k dispatch): read-only, for tests.
    round_fn.ef_state = _ef_view
    # A replay restores this with the weights: the round commits its
    # residuals and seed counter as it returns, before a driver can find a
    # non-finite output. The residual tensors are never written in place,
    # so a shallow copy is a snapshot.
    round_fn.codec_state = lambda: dict(ef_state)
    round_fn.set_codec_state = lambda s: (ef_state.clear(), ef_state.update(s))
    return round_fn


def build_federated_round(
    mesh: SlotMesh,
    model_config: ModelConfig | None = None,
    learning_rate: float = 1e-3,
    local_epochs: int = 1,
    fedprox_mu: float = 0.0,
    pos_weight: float = 1.0,
    remat: bool = False,
    data_placement: str = "streamed",
    update_codec: str | None = None,
    topk_fraction: float = 0.01,
    lowp: str | None = None,
    dp_clip_norm: float = 0.0,
    dp_noise_multiplier: float = 0.0,
    dp_seed: int = 0,
):
    """A round of ``mesh.clients`` slots on ``mesh.device``.

    Returns ``round_fn(variables, images, masks, active, n_samples)``:

    - ``variables``: the global ``{'params', 'batch_stats'}`` tree (numpy
      or tensors, flax layout);
    - ``images`` ``[C, steps, B, H, W, 3]`` and ``masks`` ``[C, steps, B,
      H, W, 1]``, uint8 or float32, numpy or tensors;
    - ``active`` ``[C]`` participation mask, ``n_samples`` ``[C]`` FedAvg
      weights.

    It returns ``(new_variables, metrics)``: the new global as a tree of
    float32 tensors on the device, and ``[C]`` tensors ``loss``,
    ``pixel_acc``, ``iou``, ``active`` from each slot's last epoch.

    ``data_placement="resident"`` takes ``round_fn(variables, (pool_images,
    pool_masks), idx, active, n_samples)``: a ``[C, N, ...]`` sample pool
    (``data.pipeline.SamplePool.stage``) and a ``[C, epochs, steps, B]``
    gather plan, each step gathering its batch on the device; equal to the
    streamed round over ``pool[idx]`` bit for bit.

    ``remat=True`` recomputes each forward in the backward pass
    (``torch.utils.checkpoint``): the same gradients for about half the
    activation memory. ``update_codec``, ``topk_fraction``, ``lowp`` and
    ``dp_*`` are the twins described in the module docstring.

    A ``batch`` axis wider than 1 needs a per-step batch ``B`` that
    divides by it and trains as the ``(C, 1)`` round does (module
    docstring).
    """
    _require_axes(mesh, CLIENTS, BATCH)
    return _build_round(
        mesh, model_config or ModelConfig(), learning_rate, local_epochs, fedprox_mu,
        pos_weight=pos_weight, remat=remat, data_placement=data_placement,
        update_codec=update_codec, topk_fraction=topk_fraction, lowp=lowp,
        dp_clip_norm=dp_clip_norm, dp_noise_multiplier=dp_noise_multiplier, dp_seed=dp_seed,
    )


def _as_chunks(x) -> tuple:
    """A round data argument as a tuple of step-axis chunks."""
    if isinstance(x, (tuple, list)):
        if not x:
            raise ValueError("empty chunk list for round data")
        return tuple(x)
    return (x,)


@dataclasses.dataclass(frozen=True)
class SegmentedRound:
    """An epoch-segmented round: ``n_segments`` calls of ``segment_epochs``
    epochs each, every slot's model and Adam state kept on the device
    between them, then the fold.

    Equal to the monolithic round on the same inputs, weights and metrics,
    bit for bit, for any ``n_segments`` dividing ``local_epochs`` and any
    step-axis chunking of the data: the same slot steps in the same order.
    Calling it is ``round_fn``-compatible; the driver calls ``init``,
    ``segment`` and ``finalize`` itself, to stage between segments. A
    carry is valid until the next ``init`` (the slot states are reused),
    as a donated carry is in the JAX package.

    Across processes (``span``) the carry holds this rank's
    ``n_client_shards`` slots, from global client ``client_offset`` on;
    ``fold`` and ``finalize`` gather every rank's slots and fold them all
    in client order.
    """

    n_segments: int
    segment_epochs: int
    local_epochs: int
    n_client_shards: int
    fit: _SlotFit = dataclasses.field(repr=False)
    validate_data: Callable = dataclasses.field(repr=False)
    data_placement: str = "streamed"
    n_inner: int = 1
    span: ProcessSpan | None = dataclasses.field(default=None, repr=False)
    client_offset: int = 0

    @property
    def device(self) -> torch.device:
        return self.fit.device

    def check_inputs(self, img_chunks, active, n_samples, idx=None):
        """Host-side validation; returns the host cohort arrays."""
        if self.data_placement == "resident":
            _check_resident_inputs(img_chunks, idx, self.n_client_shards, self.local_epochs,
                                   self.n_inner, self.validate_data)
            return _host_cohort_check(active, n_samples)
        for c in img_chunks:
            if c.shape[0] != self.n_client_shards:
                raise ValueError(
                    f"data carries {c.shape[0]} clients, mesh has {self.n_client_shards} on the '{CLIENTS}' axis"
                )
            _check_step_batch(c, self.n_inner)
        self.validate_data(img_chunks[0])
        return _host_cohort_check(active, n_samples)

    def init(self, variables) -> list:
        """Every slot from the round's global variables, Adam fresh."""
        gvars = _device_tree(variables, self.device)
        return [self.fit.init(c, gvars) for c in range(self.n_client_shards)]

    def segment(self, carry: list, variables, img_chunks, msk_chunks):
        """One segment (``segment_epochs`` epochs over all chunks) for every
        slot; returns ``(carry, raw_last)``, ``raw_last`` the segment's
        last-epoch counts as ``[C]`` tensors. Resident: ``img_chunks`` is
        the pool pair, ``msk_chunks`` the segment's ``[C, segment_epochs,
        steps, B]`` plan."""
        gvars = _device_tree(variables, self.device)
        anchor = _anchor(gvars, carry[0].state.model)
        lasts = []
        if self.data_placement == "resident":
            pool_i, pool_m = (_as_device(p, self.device) for p in img_chunks)
            plan = _plan_tensor(msk_chunks, self.device)
            for c, slot in enumerate(carry):
                with tracing.span("mesh.slot", client=self.client_offset + c, steps=int(plan.shape[1] * plan.shape[2])):
                    per_epoch = self.fit.run_epochs(slot, [(pool_i[c], pool_m[c])], self.segment_epochs, anchor,
                                                    client=self.client_offset + c, idx=plan[c])
                lasts.append(per_epoch[-1])
        else:
            chunks = [(_as_device(i, self.device), _as_device(m, self.device))
                      for i, m in zip(_as_chunks(img_chunks), _as_chunks(msk_chunks))]
            steps = self.segment_epochs * sum(int(i.shape[1]) for i, _ in chunks)
            for c, slot in enumerate(carry):
                with tracing.span("mesh.slot", client=self.client_offset + c, steps=steps):
                    per_epoch = self.fit.run_epochs(slot, [(i[c], m[c]) for i, m in chunks], self.segment_epochs,
                                                    anchor, client=self.client_offset + c)
                lasts.append(per_epoch[-1])
        return carry, _stack_slots(lasts)

    def fold(self, carry: list, active, n_samples, sums: tuple) -> tuple:
        """Fold every slot's weights into ``sums`` in client order (every
        rank's slots, across processes)."""
        with tracing.span("mesh.fold") as fold_span:
            updates = [_model_variables(slot.state.model) for slot in carry]
            if fold_span is not None:
                fold_span.set(leaves=len(updates) * len(tree_leaves(updates[0])))
            if self.span is not None:
                updates = _gather_slots(self.span, [_flat_update(u) for u in updates], updates[0])
            for c, update in enumerate(updates):
                sums = _fold_slot(update, active[c], n_samples[c], sums)
            return sums

    def finalize(self, carry: list, variables, active, n_samples, raw_last):
        """The fold, the guard and the metrics dict."""
        gvars = _device_tree(variables, self.device)
        active32, n32 = np.asarray(active, np.float32), np.asarray(n_samples, np.float32)
        num, den = self.fold(carry, active32, n32, mesh_zero_sums(gvars))
        with tracing.span("mesh.finish"):
            new_variables = mesh_finish_cohort_mean(num, den, gvars)
            if self.span is not None:
                raw_last = _gather_metrics(self.span, raw_last)
            return new_variables, _round_metrics(raw_last, active32, self.device)

    def __call__(self, variables, images, masks, active, n_samples):
        if self.data_placement == "resident":
            pool, idx = tuple(images), masks
            active, n_samples = self.check_inputs(pool, active, n_samples, idx=idx)
            carry = self.init(variables)
            raw_last = None
            se = self.segment_epochs
            for k in range(self.n_segments):
                carry, raw_last = self.segment(carry, variables, pool, idx[:, k * se:(k + 1) * se])
            return self.finalize(carry, variables, active, n_samples, raw_last)
        img_chunks, msk_chunks = _as_chunks(images), _as_chunks(masks)
        active, n_samples = self.check_inputs(img_chunks, active, n_samples)
        carry = self.init(variables)
        raw_last = None
        for _ in range(self.n_segments):
            carry, raw_last = self.segment(carry, variables, img_chunks, msk_chunks)
        return self.finalize(carry, variables, active, n_samples, raw_last)


def _build_round_segments(mesh: SlotMesh, model_config: ModelConfig, learning_rate: float, local_epochs: int,
                          fedprox_mu: float, *, pos_weight: float = 1.0, remat: bool = False,
                          segments: int = 0, data_placement: str = "streamed") -> SegmentedRound:
    _require_axes(mesh, CLIENTS, BATCH)
    if data_placement not in ("streamed", "resident"):
        raise ValueError(f"data_placement must be 'streamed' or 'resident', got {data_placement!r}")
    epochs = max(1, local_epochs)
    n_segments = epochs if not segments else int(segments)
    if n_segments <= 0 or epochs % n_segments:
        raise ValueError(
            f"segments={segments!r} must be a positive divisor of "
            f"local_epochs={epochs} (epoch-grain segmentation)"
        )
    local = mesh.local_range(CLIENTS)
    return SegmentedRound(
        n_segments=n_segments,
        segment_epochs=epochs // n_segments,
        local_epochs=epochs,
        n_client_shards=len(local),
        fit=_SlotFit(model_config, learning_rate, fedprox_mu, pos_weight, remat, mesh.device),
        validate_data=_validate_channels(model_config),
        data_placement=data_placement,
        n_inner=mesh.shape[BATCH],
        span=mesh.span,
        client_offset=local.start,
    )


def build_federated_round_segments(
    mesh: SlotMesh,
    model_config: ModelConfig | None = None,
    learning_rate: float = 1e-3,
    local_epochs: int = 1,
    fedprox_mu: float = 0.0,
    pos_weight: float = 1.0,
    remat: bool = False,
    segments: int = 0,
    data_placement: str = "streamed",
) -> SegmentedRound:
    """The epoch-segmented variant of :func:`build_federated_round`, with
    its data contract; ``segments`` (0: one per local epoch) must divide
    ``local_epochs``. The codec, lowp and DP twins are monolithic-only, as
    in the JAX package."""
    return _build_round_segments(mesh, model_config or ModelConfig(), learning_rate, local_epochs, fedprox_mu,
                                 pos_weight=pos_weight, remat=remat, segments=segments,
                                 data_placement=data_placement)


def pad_cohort_axis(arr, c_pad: int):
    """Zero-pad the leading (cohort) axis of a per-client array (numpy or
    tensor) to ``c_pad`` entries. Padding clients ride with ``active = 0``
    and ``n_samples = 0``, so they add ±0.0 to the fold: a bitwise no-op."""
    if isinstance(arr, torch.Tensor):
        c = arr.shape[0]
        if c >= c_pad:
            return arr
        pad = torch.zeros((c_pad - c,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, pad], dim=0)
    arr = np.asarray(arr)
    c = arr.shape[0]
    if c >= c_pad:
        return arr
    pad = np.zeros((c_pad - c,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclasses.dataclass(frozen=True)
class CohortRound:
    """A cohort of any size run as ``ceil(C / G)`` groups of ``G =
    mesh.clients`` slots, one after another, continuing one fold carry.

    Each group runs the segmented round's slot fits and folds its slots
    into the carry (``partial``); ``finish`` divides and guards. Equal to
    the monolithic round over the whole cohort bit for bit: the fold is one
    expression tree however the groups split it, a slot's fit does not
    depend on its group, and metrics carry no cross-client reduction. A
    ragged cohort pads its last group with inactive zero-weight slots,
    sliced out of the metrics. The driver calls ``zeros``, ``run_group``
    and ``finish`` itself, to stage group by group.

    Across processes (a mesh that spans them) each group's ``G`` slots
    split over the ranks as the segmented round's do: every rank runs its
    block of every group, the padding slots of a ragged last group
    included, and ``run_group`` gathers the group's slots and metrics so
    that every rank folds all ``G`` in client order, carrying the bits of
    the one-process round.
    """

    group_size: int
    n_segments: int
    segment_epochs: int
    local_epochs: int
    n_inner: int
    seg: SegmentedRound = dataclasses.field(repr=False)
    data_placement: str = "streamed"

    def n_groups(self, cohort_size: int) -> int:
        if cohort_size <= 0:
            raise ValueError(f"cohort_size must be positive, got {cohort_size}")
        return -(-cohort_size // self.group_size)

    def zeros(self, variables) -> tuple:
        """The round's initial fold carry (float32 zeros on the device)."""
        return mesh_zero_sums(_device_tree(variables, self.seg.device))

    @property
    def block(self) -> slice:
        """This process's slots within a group (all ``G`` in one process)."""
        seg = self.seg
        return slice(seg.client_offset, seg.client_offset + seg.n_client_shards)

    def run_group(self, sums, variables, data_a, data_b, active_g, n_g):
        """Train one group of G slots and fold them into ``sums``.
        Streamed: ``data_a``/``data_b`` the group's ``[G, steps, B, ...]``
        slabs; resident: the group's pool pair and its ``[G,
        local_epochs, steps, B]`` plan; across processes, this rank's
        :attr:`block` of them. ``active_g`` and ``n_g`` are the whole
        group's. Returns ``(sums, raw_last)``, ``raw_last`` the group's
        ``[G]`` counts. An all-inactive group (pure padding) leaves
        ``sums`` bitwise as it was."""
        carry = self.seg.init(variables)
        raw_last = None
        if self.data_placement == "resident":
            se = self.segment_epochs
            for k in range(self.n_segments):
                carry, raw_last = self.seg.segment(carry, variables, data_a, data_b[:, k * se:(k + 1) * se])
        else:
            for _ in range(self.n_segments):
                carry, raw_last = self.seg.segment(carry, variables, data_a, data_b)
        sums = self.seg.fold(carry, np.asarray(active_g, np.float32), np.asarray(n_g, np.float32), sums)
        if self.seg.span is not None:
            raw_last = _gather_metrics(self.seg.span, raw_last)
        return sums, raw_last

    def finish(self, sums, variables, raw_lasts, active, cohort_size):
        """The new global from the cross-group sums, and the per-client
        metrics from the concatenated group counts (padding sliced off)."""
        gvars = _device_tree(variables, self.seg.device)
        with tracing.span("mesh.finish"):
            new_variables = mesh_finish_cohort_mean(sums[0], sums[1], gvars)
            last = {k: torch.cat([r[k] for r in raw_lasts])[:cohort_size] for k in raw_lasts[0]}
            return new_variables, _round_metrics(last, np.asarray(active, np.float32)[:cohort_size],
                                                 self.seg.device)

    def _padded_cohort(self, active, n_samples):
        active = np.asarray(active, np.float32)
        n_samples = np.asarray(n_samples, np.float32)
        c = active.shape[0]
        c_pad = self.n_groups(c) * self.group_size
        return pad_cohort_axis(active, c_pad), pad_cohort_axis(n_samples, c_pad), c, c_pad

    def __call__(self, variables, images, masks, active, n_samples):
        """The whole cohort's data in (across processes too: each rank
        stages only its block of every group)."""
        g, block = self.group_size, self.block

        def mine(arr, lo):
            return arr[lo + block.start:lo + block.stop]

        if self.data_placement == "resident":
            pool, idx = tuple(images), np.asarray(masks, np.int32)
            c = idx.shape[0]
            _check_resident_inputs(pool, idx, c, self.local_epochs, self.n_inner, self.seg.validate_data)
            _host_cohort_check(active, n_samples)
            active, n_samples, c, c_pad = self._padded_cohort(active, n_samples)
            pool_i, pool_m = pad_cohort_axis(pool[0], c_pad), pad_cohort_axis(pool[1], c_pad)
            idx = pad_cohort_axis(idx, c_pad)
            sums = self.zeros(variables)
            raw_lasts = []
            for lo in range(0, c_pad, g):
                sums, raw = self.run_group(sums, variables, (mine(pool_i, lo), mine(pool_m, lo)),
                                           mine(idx, lo), active[lo:lo + g], n_samples[lo:lo + g])
                raw_lasts.append(raw)
            return self.finish(sums, variables, raw_lasts, active, c)
        if images.shape[0] != np.asarray(active).shape[0]:
            raise ValueError(f"data carries {images.shape[0]} clients, cohort mask {np.asarray(active).shape[0]}")
        self.seg.validate_data(images)
        _check_step_batch(images, self.n_inner)
        _host_cohort_check(active, n_samples)
        active, n_samples, c, c_pad = self._padded_cohort(active, n_samples)
        images, masks = pad_cohort_axis(images, c_pad), pad_cohort_axis(masks, c_pad)
        sums = self.zeros(variables)
        raw_lasts = []
        for lo in range(0, c_pad, g):
            sums, raw = self.run_group(sums, variables, mine(images, lo), mine(masks, lo),
                                       active[lo:lo + g], n_samples[lo:lo + g])
            raw_lasts.append(raw)
        return self.finish(sums, variables, raw_lasts, active, c)


def build_federated_cohort_round(
    mesh: SlotMesh,
    model_config: ModelConfig | None = None,
    learning_rate: float = 1e-3,
    local_epochs: int = 1,
    fedprox_mu: float = 0.0,
    pos_weight: float = 1.0,
    remat: bool = False,
    segments: int = 1,
    data_placement: str = "streamed",
) -> CohortRound:
    """The cohort variant of :func:`build_federated_round`: any cohort size
    in groups of ``mesh.clients`` slots (see :class:`CohortRound`).
    ``segments`` is per group and must divide ``local_epochs``;
    ``data_placement="resident"`` takes a cohort-wide pool, sliced per
    group. On a mesh that spans processes each group's slots split over
    the ranks (see :class:`CohortRound`)."""
    seg = _build_round_segments(mesh, model_config or ModelConfig(), learning_rate, local_epochs, fedprox_mu,
                                pos_weight=pos_weight, remat=remat, segments=segments,
                                data_placement=data_placement)
    return CohortRound(
        group_size=mesh.shape[CLIENTS],
        n_segments=seg.n_segments,
        segment_epochs=seg.segment_epochs,
        local_epochs=seg.local_epochs,
        n_inner=seg.n_inner,
        seg=seg,
        data_placement=data_placement,
    )


def build_spatial_federated_round(
    mesh: SlotMesh,
    model_config: ModelConfig | None = None,
    learning_rate: float = 1e-3,
    local_epochs: int = 1,
    fedprox_mu: float = 0.0,
    pos_weight: float = 1.0,
    remat: bool = False,
):
    """A round over a ``(clients, space)`` mesh (``make_mesh(C, S,
    axis_names=('clients', 'space'))``): FedAvg over ``C`` client slots
    whose every step is split over image height into ``S`` bands with
    halo exchange and sync-BN (``parallel.spatial``), the composition for
    crops too large for one client's step. Each step is
    ``train.local.train_step`` with the spatial fold forward; ``remat``
    recomputes that forward in the backward pass. Trains as the ``(C, 1)``
    round on the same data, within float reassociation.

    :func:`build_federated_round`'s call contract (streamed data), with H
    a multiple of 16 x ``S``. A transformed layout is refused."""
    model_config = model_config or ModelConfig()
    _refuse_segformer(model_config, ("the spatial plane", True))
    check_layout(model_config, "spatial sharding")
    _require_axes(mesh, CLIENTS, SPACE)
    n_space = mesh.shape[SPACE]
    channels = _validate_channels(model_config)

    def validate_data(images) -> None:
        channels(images)
        validate_shape(images.shape[3], images.shape[4], n_space)

    return _build_round(
        mesh, model_config, learning_rate, local_epochs, fedprox_mu, inner_axis=SPACE,
        forward=spatial_forward(n_space), validate_data=validate_data, pos_weight=pos_weight, remat=remat,
    )


def mesh_fedavg(stacked: Any, weights=None, active=None) -> Any:
    """Masked weighted mean over the leading (client) axis of a stacked
    tree of numpy arrays or tensors: the host-callable form of the
    round's aggregation, held against ``fed.algorithms.fedavg``. Returns
    tensors in the leaves' dtypes."""
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("empty pytree")
    k = leaves[0].shape[0]
    w = torch.ones(k, dtype=torch.float32) if weights is None else torch.as_tensor(
        np.asarray(weights, np.float32))
    if active is not None:
        w = w * torch.as_tensor(np.asarray(active, np.float32))
    total = float(torch.sum(w))
    if total <= 0.0:
        raise ValueError("non-positive total FedAvg weight (empty effective cohort)")
    wn = w / total

    def leaf(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        acc = torch.tensordot(wn.to(x.device), x.to(torch.float32), dims=1)
        return acc.to(x.dtype)

    return tree_map(leaf, stacked)


def stack_client_data(
    client_batches: Sequence[tuple[np.ndarray, np.ndarray]],
    steps: int,
    batch_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-client (images, masks) sample arrays into the round layout
    ``[C, steps, B, H, W, ch]``, cycling or truncating each client's
    samples to exactly ``steps * batch_size``."""
    need = steps * batch_size
    imgs_out, masks_out = [], []
    for images, masks in client_batches:
        n = images.shape[0]
        if n == 0:
            raise ValueError("client with zero samples")
        idx = np.resize(np.arange(n), need)  # cycle if short, truncate if long
        imgs_out.append(images[idx].reshape(steps, batch_size, *images.shape[1:]))
        masks_out.append(masks[idx].reshape(steps, batch_size, *masks.shape[1:]))
    return np.stack(imgs_out), np.stack(masks_out)


def round_from_config(cfg, device=None):
    """``(mesh, round)`` as a ``FedConfig``'s mesh fields describe them:
    ``make_mesh(cfg.mesh_clients, cfg.mesh_batch)`` on ``device`` (a
    ``mesh_batch`` above 1, as ``configs/c5_bf16_batch_dp.json`` sets,
    splits each step's batch with sync-BN), and the
    monolithic round (``cfg.segments == 0``) or the segmented one, with
    the config's model (the U-Net, or SegFormer under ``model_type``
    ``"segformer"``), learning rate, local epochs, FedProx mu, pos_weight
    and ``data_placement``. Drive it with
    ``run_mesh_federation(..., segment_overlap=cfg.segment_overlap,
    data_placement=cfg.data_placement)``.

    The config's ``dp_*``, ``update_codec`` and ``secagg`` fields are the
    client plane's update-level DP, wire codec and masking, not the slot
    plane's per-step DP-SGD and codec twins: a config that sets any of them
    is refused rather than run without them. Build those twins with
    :func:`build_federated_round`'s own arguments."""
    from fedcrack_tpu_torch.parallel.slots import make_mesh

    unmapped = [name for name, on in (("dp_clip_norm", cfg.dp_clip_norm > 0.0),
                                      ("update_codec", cfg.update_codec != "null"),
                                      ("secagg", cfg.secagg)) if on]
    if unmapped:
        raise ValueError(
            f"round_from_config maps the mesh fields only; {', '.join(unmapped)} configure the client plane "
            "(update-level DP, the wire codec, secure aggregation), which the slot plane does not run: pass "
            "build_federated_round's dp_*/update_codec arguments instead"
        )
    mesh = make_mesh(cfg.mesh_clients, cfg.mesh_batch, device=device)
    common = dict(model_config=cfg.model, learning_rate=cfg.learning_rate, local_epochs=cfg.local_epochs,
                  fedprox_mu=cfg.fedprox_mu, pos_weight=cfg.pos_weight, data_placement=cfg.data_placement)
    if cfg.segments:
        return mesh, build_federated_round_segments(mesh, segments=cfg.segments, **common)
    return mesh, build_federated_round(mesh, **common)
