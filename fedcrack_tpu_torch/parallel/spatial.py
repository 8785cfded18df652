"""Spatial context parallelism: the U-Net's step split over image height.

The counterpart of ``fedcrack_tpu.parallel.spatial``. There each chip of a
``space`` mesh axis holds one band of rows of every image, a one-row halo
exchange (``lax.ppermute``) feeds each 3x3 window that straddles a band
edge, and BatchNorm pmeans its moments over the bands (sync-BN), so the
sharded step equals the single-device one on the same variables.

On one card the ``S`` bands of a ``B``-image batch are one NCHW tensor of
shape ``[S·B, C, H/S, W]``, the fold, in shard-major order (fold row
``s·B + b`` is band ``s`` of image ``b``), so band ``s`` of an image has its
neighbours ``B`` fold rows away. The forward is the model's own
(``ResUNet.trunk``, its own ``Conv`` and ``BatchNorm`` modules) with a halo
geometry in place of SAME padding; the halo is a slice and ``torch.cat``
along the fold, with zeros at the image's top and bottom edges, which is
SAME zero padding there. Per-op halo geometry (H; W is padded SAME as on
one device), JAX's:

- 3x3 stride-1 convs (plain, depthwise, and the decoder's stride-1
  ``ConvTranspose``, which is the same cross-correlation): 1 row up and
  1 down, the conv padding only W;
- the stride-2 stem and the 3x3/2 max pool, SAME on even H, pad (0, 1):
  1 row down only; the pool's bottom edge is ``-inf`` and never claims a
  gradient (``ops.pooling.max_pool_3x3_s2_halo``);
- 1x1 convs and the x2 upsample: local, since every band's first row
  stays even while the per-band H is a multiple of 16.

One BatchNorm call over the fold takes its moments over every band of
every image, which is what the JAX ``_bn``'s pmean computes, and moves the
running statistics once per layer per step. The gradient of the exchange
is autograd's through the cat and the slice: the transposed permutation.
The logits come back as ``[B, H, W, 1]``, so a train step reduces them
through one ``bce_sums`` launch for all bands, as on one device.

Across processes (``make_spatial_mesh(..., group=)``) each rank holds a
contiguous block of the ``S`` bands of every image, takes those rows of
the images as its input and keeps the shard-major fold within its block:

- the halo stays a ``torch.cat`` between bands of one rank; at a rank
  boundary the edge rows go to the neighbouring rank by send and receive,
  and the backward sends each cotangent row back the way its row came
  (``_RankHalo``); the image's top and bottom edges still get the fill;
- BatchNorm takes its moments over every rank's bands: each rank's
  per-channel sums of ``x`` and ``x·x`` are gathered and added in rank
  order, divided by the global count (flax's fast variance, clamped), and
  the backward adds the moments' cotangents over the ranks in rank order;
- a train step reduces each rank's logits through one ``bce_sums`` launch,
  adds the five sums over the ranks in rank order and takes the loss from
  the totals; the parameter gradients are added over the ranks in rank
  order before the optimizer step, so every rank holds the same weights.

No ``all_reduce`` decides a moment, a loss or a gradient. The predict
returns each rank's own rows of the probabilities.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from fedcrack_tpu_torch.ops.bce import bce_sums, metrics_from_sums
from fedcrack_tpu_torch.parallel.multihost import ProcessSpan, rank_sum, rank_total
from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.models.convert import from_flax_variables
from fedcrack_tpu_torch.models.resunet import ResUNet, _upsample2x_nchw
from fedcrack_tpu_torch.ops.pooling import max_pool_3x3_s2_halo
from fedcrack_tpu_torch.parallel.slots import SlotMesh, make_mesh
from fedcrack_tpu_torch.train.local import TrainState, configure_backends, make_optimizer, train_step

SPACE, DATA = "space", "data"


def fold_shards(x: torch.Tensor, axis_size: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> the NCHW fold ``[S·B, C, H/S, W]``,
    shard-major, contiguous."""
    b, h, w, c = x.shape
    s = axis_size
    return x.permute(0, 3, 1, 2).reshape(b, c, s, h // s, w).permute(2, 0, 1, 3, 4).reshape(s * b, c, h // s, w)


def unfold_shards(x: torch.Tensor, axis_size: int) -> torch.Tensor:
    """The NCHW fold ``[S·B, C, h, W]`` -> NHWC ``[B, S·h, W, C]``,
    contiguous."""
    n, c, h, w = x.shape
    s = axis_size
    b = n // s
    return x.reshape(s, b, c, h, w).permute(1, 0, 3, 4, 2).reshape(b, s * h, w, c)


class _RankHalo(torch.autograd.Function):
    """The halo rows that cross a rank boundary: this rank's first band's
    top ``down`` rows go to the rank above, its last band's bottom ``up``
    rows to the rank below; returns ``(above, below)``, the rows received
    for this rank's first and last bands (``fill`` at the image's edges).
    The backward sends each cotangent back to the rank its rows came from
    and returns the cotangents received for this rank's own rows."""

    @staticmethod
    def forward(ctx, top, bottom, span: ProcessSpan, up: int, down: int, fill: float):
        prev, nxt = span.rank - 1, span.rank + 1
        has_prev, has_next = span.rank > 0, nxt < span.world
        ctx.span, ctx.links = span, (has_prev, has_next, up, down)
        ctx.shapes = (top.shape, bottom.shape, top.dtype, top.device)
        sends, recvs = {}, {}
        if has_prev and down:
            sends[prev] = top
        if has_next and up:
            sends[nxt] = bottom
        if has_prev and up:
            recvs[prev] = bottom
        if has_next and down:
            recvs[nxt] = top
        got = span.exchange(sends, recvs)
        above = got[prev] if prev in recvs else bottom.new_full(bottom.shape, fill)
        below = got[nxt] if nxt in recvs else top.new_full(top.shape, fill)
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        span, (has_prev, has_next, up, down) = ctx.span, ctx.links
        top_shape, bottom_shape, dtype, device = ctx.shapes
        top = torch.zeros(top_shape, dtype=dtype, device=device)
        bottom = torch.zeros(bottom_shape, dtype=dtype, device=device)
        prev, nxt = span.rank - 1, span.rank + 1
        sends, recvs = {}, {}
        if has_prev and up:
            sends[prev] = g_above
        if has_next and down:
            sends[nxt] = g_below
        if has_next and up:
            recvs[nxt] = bottom
        if has_prev and down:
            recvs[prev] = top
        got = span.exchange(sends, recvs)
        g_top = got[prev] if prev in recvs else top
        g_bottom = got[nxt] if nxt in recvs else bottom
        return g_top, g_bottom, None, None, None, None


def halo_exchange(x: torch.Tensor, axis_size: int, up: int = 1, down: int = 1, fill: float = 0.0,
                  span: ProcessSpan | None = None) -> torch.Tensor:
    """Concatenate ``up`` rows of the band above and ``down`` rows of the
    band below onto each band of the fold ``x`` (NCHW ``[S·B, C, h, W]``,
    H is dim 2). The image's top and bottom edges receive ``fill`` (0 for
    SAME conv padding). With ``span`` the fold is this rank's block of
    bands, and the rows across its edges come from the neighbouring
    ranks."""
    n, c, h, w = x.shape
    s = axis_size
    bands = x.reshape(s, n // s, c, h, w)
    above = below = None
    if span is not None:
        above, below = _RankHalo.apply(bands[0, :, :, :down], bands[-1, :, :, h - up:], span, up, down, fill)
    parts = []
    if up:
        edge = bands.new_full((1, n // s, c, up, w), fill) if above is None else above[None]
        parts.append(torch.cat([edge, bands[:-1, :, :, h - up:]], dim=0))
    parts.append(bands)
    if down:
        edge = bands.new_full((1, n // s, c, down, w), fill) if below is None else below[None]
        parts.append(torch.cat([bands[1:, :, :, :down], edge], dim=0))
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=3).reshape(n, c, h + up + down, w)


def rank_moments(span: ProcessSpan, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm's batch moments over every rank's bands: the per-channel
    sums of ``xs`` and ``xs·xs`` added over the ranks in rank order, over
    the global count; the variance flax's fast one, clamped at 0."""
    local = torch.stack([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3))])
    total = rank_sum(span, local)
    count = xs.numel() // xs.shape[1] * span.world
    mean = total[0] / count
    return mean, torch.clamp_min(total[1] / count - mean * mean, 0.0)


class HaloGeometry:
    """:meth:`ResUNet.trunk`'s geometry over the fold of ``axis_size``
    bands: halo rows in H, SAME padding in W. With ``span`` the bands are
    this rank's block, the halo crosses to the neighbouring ranks and the
    BatchNorm moments are every rank's."""

    def __init__(self, axis_size: int, n_fold: int, device: torch.device, span: ProcessSpan | None = None):
        self.axis_size = axis_size
        self.span = span
        # Fold rows whose band has a band below it, on this rank or the
        # next: their pool halo is real.
        last = span is None or span.rank == span.world - 1
        self.halo_real = torch.arange(n_fold, device=device) < n_fold - (n_fold // axis_size if last else 0)
        self.moments = None if span is None else (lambda xs: rank_moments(span, xs))

    def pad_s1(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(halo_exchange(x, self.axis_size, up=1, down=1, span=self.span), (1, 1, 0, 0))

    def pad_s2(self, x: torch.Tensor) -> torch.Tensor:
        # SAME at stride 2 on an even grid pads (0, 1): W here, H by the halo.
        return F.pad(halo_exchange(x, self.axis_size, up=0, down=1, span=self.span), (0, 1, 0, 0))

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        xp = halo_exchange(x, self.axis_size, up=0, down=1, span=self.span)
        return max_pool_3x3_s2_halo(xp.permute(0, 2, 3, 1), self.halo_real).permute(0, 3, 1, 2)


def check_layout(cfg: ModelConfig, what: str = "spatial_apply") -> None:
    """Refuse a transformed layout: the halo geometry is derived for the
    reference ops, and a layout that repacks H and W into channels would
    change every halo."""
    if cfg.stem_layout != "reference" or cfg.res_layout != "reference":
        raise ValueError(
            f"{what} supports the reference layout only; got "
            f"stem_layout={cfg.stem_layout!r}, res_layout={cfg.res_layout!r}"
        )


def validate_shape(h: int, w: int, axis_size: int) -> None:
    # Per-shard H must survive the stem's /2 and three pools' /2 with even
    # alignment at every stage: a multiple of 16 (the single-device
    # constraint, per shard). W stays local but needs the same /16.
    if h % (16 * axis_size) != 0:
        raise ValueError(
            f"image height {h} must be a multiple of 16 x {axis_size} shards "
            f"= {16 * axis_size} for the spatially-sharded U-Net"
        )
    if w % 16 != 0:
        raise ValueError(f"image width {w} must be a multiple of 16 for the U-Net")


def _model_for(variables, config: ModelConfig, device: torch.device) -> ResUNet:
    model = ResUNet(config, device=device)
    from_flax_variables(variables, model)
    return model


def spatial_apply(model_or_variables, x: torch.Tensor, *, config: ModelConfig | None = None, axis_size: int,
                  train: bool | None = None, span: ProcessSpan | None = None):
    """H-sharded forward of the crack U-Net over ``axis_size`` bands.

    ``model_or_variables`` is a :class:`ResUNet` or a flax-layout
    ``{'params', 'batch_stats'}`` tree (loaded into a model on ``x``'s
    device, ``config`` its config); ``x`` NHWC ``[B, H, W, 3]``. Returns
    logits ``[B, H, W, 1]`` (``train`` False) or ``(logits,
    new_batch_stats)``, the statistics after one sync-BN update, as a
    flax-layout tree of tensors (``train`` True). With a model and
    ``train`` None the model's own mode decides, and a train-mode call
    updates its statistics in place. With ``span``, ``x`` is this rank's
    rows of the images, ``axis_size`` the bands they hold, and the logits
    are those rows'."""
    model = model_or_variables if isinstance(model_or_variables, ResUNet) else None
    check_layout(model.config if model is not None else config or ModelConfig())
    if model is None:
        model = _model_for(model_or_variables, config or ModelConfig(), x.device)
    if train is not None:
        model.train(train)
    world = 1 if span is None else span.world
    validate_shape(x.shape[1] * world, x.shape[2], axis_size * world)
    xf = fold_shards(x.to(model.compute_dtype), axis_size)
    geometry = HaloGeometry(axis_size, xf.shape[0], xf.device, span)
    logits = unfold_shards(_upsample2x_nchw(model.trunk(xf, geometry)), axis_size)
    if not train:
        return logits
    stats: dict = {}
    for key, value in model.named_buffers():
        bn, leaf = key.split(".")
        stats.setdefault(bn, {})[leaf] = value.detach().clone()
    return logits, stats


def _space_size(mesh: SlotMesh, space_axis: str) -> int:
    if space_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no '{space_axis}' axis")
    return mesh.shape[space_axis]


def _check_batch(b: int, mesh: SlotMesh, batch_axis: str) -> None:
    n = mesh.shape.get(batch_axis, 1)
    if b % n:
        raise ValueError(f"batch {b} does not divide over the {n}-way '{batch_axis}' axis")


def _space_plan(mesh: SlotMesh, space_axis: str) -> tuple[int, int, ProcessSpan | None]:
    """``(S, bands held here, span)``: a mesh that spans processes must
    split its space axis."""
    s = _space_size(mesh, space_axis)
    if mesh.span is not None and mesh.split_axis != space_axis:
        raise ValueError(
            f"the spatial plane splits its '{space_axis}' axis over processes; this mesh splits "
            f"'{mesh.split_axis}' (make it with make_spatial_mesh(..., group=))"
        )
    return s, len(mesh.local_range(space_axis)), mesh.span


def spatial_forward(axis_size: int, span: ProcessSpan | None = None) -> Callable:
    """``forward(model, images) -> logits``: the hook
    ``train.local.train_step`` takes, running the model's train-mode step
    over ``axis_size`` bands (this rank's, with ``span``)."""

    def forward(model: ResUNet, images: torch.Tensor) -> torch.Tensor:
        return spatial_apply(model, images, axis_size=axis_size, span=span)

    return forward


def _rank_metrics(span: ProcessSpan) -> Callable:
    """``train_step``'s ``metrics_fn`` across processes: one ``bce_sums``
    launch over this rank's logits, the five sums added over the ranks in
    rank order, the metrics over the global pixel count."""

    def metrics(logits: torch.Tensor, masks: torch.Tensor, pos_weight=None) -> dict:
        sums = rank_total(span, bce_sums(logits, masks))
        return metrics_from_sums(sums, float(logits.numel() * span.world), pos_weight)

    return metrics


def _rank_grads(span: ProcessSpan) -> Callable:
    """``train_step``'s ``after_backward`` across processes: every
    parameter's gradient added over the ranks in rank order (one gather),
    so every rank takes the same optimizer step."""

    def after(model: ResUNet) -> None:
        params = list(model.parameters())
        total = span.sum_in_rank_order(torch.cat([p.grad.reshape(-1) for p in params]))
        for p, g in zip(params, torch.split(total, [p.numel() for p in params])):
            p.grad = g.view_as(p)

    return after


def build_spatial_predict(mesh: SlotMesh, config: ModelConfig | None = None, batch_axis: str = DATA,
                          space_axis: str = SPACE):
    """``fn(variables or model, images [B, H, W, 3]) -> sigmoid
    probabilities [B, H, W, 1]``, H split over ``space_axis``'s bands (and
    B over ``batch_axis``, which on one card is the batch itself). Equal to
    the single-device forward of the same model.

    On a mesh that spans processes ``images`` is this rank's block of rows
    ``[B, H / world, W, 3]`` and the probabilities are this rank's rows:
    each rank returns its own bands, nothing is gathered."""
    cfg = config or ModelConfig()
    check_layout(cfg)
    s, k, span = _space_plan(mesh, space_axis)
    world = 1 if span is None else span.world
    held: list = []

    def predict_fn(variables, images) -> torch.Tensor:
        validate_shape(images.shape[1] * world, images.shape[2], s)
        _check_batch(images.shape[0], mesh, batch_axis)
        if isinstance(variables, ResUNet):
            model = variables
        else:
            if not held:
                held.append(ResUNet(cfg, device=mesh.device))
            model = held[0]
            from_flax_variables(variables, model)
        images = torch.as_tensor(images).to(next(model.parameters()).device)
        model.eval()
        with torch.no_grad():
            return torch.sigmoid(spatial_apply(model, images, axis_size=k, span=span))

    return predict_fn


def build_spatial_train_step(mesh: SlotMesh, config: ModelConfig | None = None, learning_rate: float = 1e-3,
                             batch_axis: str = DATA, space_axis: str = SPACE,
                             optimizer: Callable | None = None, pos_weight: float = 1.0):
    """The sharded counterpart of ``train.local.train_step`` (Adam, fused
    BCE, sync-BN): ``step(state, images, masks) -> (state, metrics)``, the
    model and optimizer of ``state`` updated in place, images and masks
    NHWC, H split over ``space_axis``'s bands.

    ``optimizer(params, learning_rate)`` builds the optimizer, Adam
    (``train.local.make_optimizer``) unless given, as JAX's ``tx=`` (SGD
    for gradient-parity tests). ``step.init(variables)`` makes the
    ``TrainState`` on the mesh's device from a flax-layout tree.

    The metrics are the whole batch's: the loss and pixel accuracy the
    mean over every band of every image (JAX's pmean of equal-sized band
    means), the IoU counts the sums.

    On a mesh that spans processes ``images`` and ``masks`` are this
    rank's rows; the loss, the metrics, the gradients and so the new
    weights are the whole images' and the same on every rank."""
    cfg = config or ModelConfig()
    check_layout(cfg)
    s, k, span = _space_plan(mesh, space_axis)
    world = 1 if span is None else span.world
    make_opt = optimizer or make_optimizer
    forward = spatial_forward(k, span)
    metrics_fn = None if span is None else _rank_metrics(span)
    after = None if span is None else _rank_grads(span)
    pw = float(pos_weight)

    def init(variables) -> TrainState:
        configure_backends()
        model = _model_for(variables, cfg, mesh.device)
        return TrainState(model, make_opt(model.parameters(), learning_rate), learning_rate)

    def step_fn(state: TrainState, images, masks):
        validate_shape(images.shape[1] * world, images.shape[2], s)
        _check_batch(images.shape[0], mesh, batch_axis)
        return train_step(state, (images, masks), {}, 0.0, pw, forward=forward, after_backward=after,
                          metrics_fn=metrics_fn)

    step_fn.init = init
    return step_fn


def make_spatial_mesh(n_space: int, n_data: int = 1, device: torch.device | str | None = None,
                      group=None) -> SlotMesh:
    """A mesh with axes ``('data', 'space')`` for spatially-sharded jobs;
    ``group`` (``make_mesh``'s) spreads the ``space`` bands over the
    group's ranks in equal contiguous blocks."""
    return make_mesh(n_data, n_space, device, axis_names=(DATA, SPACE), group=group, split_axis=SPACE)
