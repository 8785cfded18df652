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
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

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


def halo_exchange(x: torch.Tensor, axis_size: int, up: int = 1, down: int = 1, fill: float = 0.0) -> torch.Tensor:
    """Concatenate ``up`` rows of the band above and ``down`` rows of the
    band below onto each band of the fold ``x`` (NCHW ``[S·B, C, h, W]``,
    H is dim 2). The image's top and bottom edges receive ``fill`` (0 for
    SAME conv padding)."""
    n, c, h, w = x.shape
    s = axis_size
    bands = x.reshape(s, n // s, c, h, w)
    parts = []
    if up:
        edge = bands.new_full((1, n // s, c, up, w), fill)
        parts.append(torch.cat([edge, bands[:-1, :, :, h - up:]], dim=0))
    parts.append(bands)
    if down:
        edge = bands.new_full((1, n // s, c, down, w), fill)
        parts.append(torch.cat([bands[1:, :, :, :down], edge], dim=0))
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=3).reshape(n, c, h + up + down, w)


class HaloGeometry:
    """:meth:`ResUNet.trunk`'s geometry over the fold of ``axis_size``
    bands: halo rows in H, SAME padding in W."""

    def __init__(self, axis_size: int, n_fold: int, device: torch.device):
        self.axis_size = axis_size
        # Fold rows whose band has a band below it: their pool halo is real.
        self.halo_real = torch.arange(n_fold, device=device) < n_fold - n_fold // axis_size

    def pad_s1(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(halo_exchange(x, self.axis_size, up=1, down=1), (1, 1, 0, 0))

    def pad_s2(self, x: torch.Tensor) -> torch.Tensor:
        # SAME at stride 2 on an even grid pads (0, 1): W here, H by the halo.
        return F.pad(halo_exchange(x, self.axis_size, up=0, down=1), (0, 1, 0, 0))

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        xp = halo_exchange(x, self.axis_size, up=0, down=1)
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
                  train: bool | None = None):
    """H-sharded forward of the crack U-Net over ``axis_size`` bands.

    ``model_or_variables`` is a :class:`ResUNet` or a flax-layout
    ``{'params', 'batch_stats'}`` tree (loaded into a model on ``x``'s
    device, ``config`` its config); ``x`` NHWC ``[B, H, W, 3]``. Returns
    logits ``[B, H, W, 1]`` (``train`` False) or ``(logits,
    new_batch_stats)``, the statistics after one sync-BN update, as a
    flax-layout tree of tensors (``train`` True). With a model and
    ``train`` None the model's own mode decides, and a train-mode call
    updates its statistics in place."""
    model = model_or_variables if isinstance(model_or_variables, ResUNet) else None
    check_layout(model.config if model is not None else config or ModelConfig())
    if model is None:
        model = _model_for(model_or_variables, config or ModelConfig(), x.device)
    if train is not None:
        model.train(train)
    validate_shape(x.shape[1], x.shape[2], axis_size)
    xf = fold_shards(x.to(model.compute_dtype), axis_size)
    logits = unfold_shards(_upsample2x_nchw(model.trunk(xf, HaloGeometry(axis_size, xf.shape[0], xf.device))),
                           axis_size)
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


def spatial_forward(axis_size: int) -> Callable:
    """``forward(model, images) -> logits``: the hook
    ``train.local.train_step`` takes, running the model's train-mode step
    over ``axis_size`` bands."""

    def forward(model: ResUNet, images: torch.Tensor) -> torch.Tensor:
        return spatial_apply(model, images, axis_size=axis_size)

    return forward


def build_spatial_predict(mesh: SlotMesh, config: ModelConfig | None = None, batch_axis: str = DATA,
                          space_axis: str = SPACE):
    """``fn(variables or model, images [B, H, W, 3]) -> sigmoid
    probabilities [B, H, W, 1]``, H split over ``space_axis``'s bands (and
    B over ``batch_axis``, which on one card is the batch itself). Equal to
    the single-device forward of the same model."""
    cfg = config or ModelConfig()
    check_layout(cfg)
    s = _space_size(mesh, space_axis)
    held: list = []

    def predict_fn(variables, images) -> torch.Tensor:
        validate_shape(images.shape[1], images.shape[2], s)
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
            return torch.sigmoid(spatial_apply(model, images, axis_size=s))

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
    means), the IoU counts the sums."""
    cfg = config or ModelConfig()
    check_layout(cfg)
    s = _space_size(mesh, space_axis)
    make_opt = optimizer or make_optimizer
    forward = spatial_forward(s)
    pw = float(pos_weight)

    def init(variables) -> TrainState:
        configure_backends()
        model = _model_for(variables, cfg, mesh.device)
        return TrainState(model, make_opt(model.parameters(), learning_rate), learning_rate)

    def step_fn(state: TrainState, images, masks):
        validate_shape(images.shape[1], images.shape[2], s)
        _check_batch(images.shape[0], mesh, batch_axis)
        return train_step(state, (images, masks), {}, 0.0, pw, forward=forward)

    step_fn.init = init
    return step_fn


def make_spatial_mesh(n_space: int, n_data: int = 1, device: torch.device | str | None = None) -> SlotMesh:
    """A mesh with axes ``('data', 'space')`` for spatially-sharded jobs."""
    return make_mesh(n_data, n_space, device, axis_names=(DATA, SPACE))
