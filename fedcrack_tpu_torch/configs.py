"""Model, data, federation and serving configuration for the PyTorch port.

The port keeps its own copy of the dataclasses its slices need, with the
same fields, defaults and validation as ``fedcrack_tpu.configs``, so that a
JSON config written for one package describes the same model, data and
serving plane in the other. ``FedConfig`` carries the fields one client's
training round reads; the wire, the server's round machine and the other
planes add theirs with the slices that port them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Residual U-Net hyperparameters (reference: client_fit_model.py:92-150).

    128x128x3 inputs, stem 32 filters, encoder (64, 128, 256), decoder
    (256, 128, 64, 32) and a single-logit head. ``stem_layout`` and
    ``res_layout`` name exact re-expressions of the same weights; the port
    runs the ``"reference"`` layouts only and refuses the others where it
    builds a program.
    """

    img_size: int = 128
    in_channels: int = 3
    num_classes: int = 1
    stem_features: int = 32
    encoder_features: tuple[int, ...] = (64, 128, 256)
    decoder_features: tuple[int, ...] = (256, 128, 64, 32)
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    stem_layout: str = "reference"
    res_layout: str = "reference"

    def __post_init__(self) -> None:
        # stem /2 + one pool /2 per encoder block, then x2 per decoder block:
        # the output comes back to img_size only for multiples of 16.
        if self.img_size % 16 != 0 or self.img_size <= 0:
            raise ValueError(
                f"img_size must be a positive multiple of 16, got {self.img_size}"
            )
        if self.stem_layout not in ("reference", "s2d", "s2d_full"):
            raise ValueError(
                "stem_layout must be one of 'reference', 's2d', 's2d_full'; "
                f"got {self.stem_layout!r}"
            )
        if self.res_layout not in ("reference", "packed"):
            raise ValueError(
                "res_layout must be 'reference' or 'packed'; "
                f"got {self.res_layout!r}"
            )

    @property
    def input_shape(self) -> tuple[int, int, int]:
        return (self.img_size, self.img_size, self.in_channels)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset layout + split semantics (reference: client_fit_model.py:54-90)."""

    image_dir: str = ""
    mask_dir: str = ""
    img_size: int = 128
    batch_size: int = 16          # reference: client_fit_model.py:55
    split_seed: int = 1337        # reference: client_fit_model.py:77-78
    train_samples: int = 6213     # reference: client_fit_model.py:76
    # "iid" or "skew" (per-client crack-density skew)
    partition: str = "iid"
    skew_alpha: float = 0.3       # Dirichlet concentration for non-IID shards
    prefetch: int = 2
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federation configuration: the fields one client's training round
    reads, with the JAX package's defaults.

    Reference values: MAX_NUM_ROUND=5 (fl_server.py:18), local epochs
    hardcoded to 10 (client_fit_model.py:166), Keras Adam at 1e-3.
    """

    max_rounds: int = 5
    cohort_size: int = 2
    local_epochs: int = 10
    learning_rate: float = 1e-3
    # FedProx proximal term (mu/2)||params - anchor||^2; 0 disables (plain
    # FedAvg local SGD).
    fedprox_mu: float = 0.0
    # Crack-pixel loss weight (1 + (pos_weight-1)*mask scales each pixel's
    # BCE); 1.0 is the reference's unweighted BCE (client_fit_model.py:157).
    pos_weight: float = 1.0
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def __post_init__(self) -> None:
        if self.data.img_size != self.model.img_size:
            raise ValueError(
                "data.img_size and model.img_size must match; got "
                f"{self.data.img_size} vs {self.model.img_size}"
            )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-plane configuration.

    Fields the port does not act on yet (gRPC host/port, replicas, the
    router's admission control, stream serving, the autoscaler and shadow
    delivery) are kept so that one config validates the same way in both
    packages.
    """

    # Square input buckets; a request lands in the smallest bucket that
    # holds it (zero-padded, output cropped); larger images run tiled
    # sliding-window inference with the largest bucket as the tile.
    bucket_sizes: tuple[int, ...] = (128, 256)
    # Batch per bucket program: requests accumulate until max_batch or
    # max_delay_ms, then run padded to exactly max_batch lanes.
    max_batch: int = 8
    max_delay_ms: float = 5.0
    swap_poll_s: float = 2.0
    # Overlap (pixels) between neighbouring tiles, blended with a ramp.
    tile_overlap: int = 32
    compute_dtype: str = "float32"
    mesh_batch: int = 1
    # Per-request deadline for accounting (0 = none): late requests are
    # served and counted, never dropped.
    deadline_ms: float = 0.0
    host: str = "127.0.0.1"
    port: int = 8890
    max_message_mb: int = 64
    replicas: int = 1
    # "int8" builds the weight-only per-channel quantized program beside the
    # reference program; an install whose probe-batch mask IoU against the
    # reference falls below quant_iou_floor is refused and the reference
    # program keeps serving.
    quant: str = "none"
    quant_iou_floor: float = 0.98
    # Body of the quantized program: "reference" (dequantize, then the
    # reference model), "fused_int8" (int8 codes straight into the
    # hand-written dequant-matmul kernel) or "fp8" (the same forward over
    # e4m3 codes). Every non-reference plane requires quant="int8".
    kernel_plane: str = "reference"
    # Dynamic per-tensor int8 quantize-dequantize of the logits.
    quant_act_fakequant: bool = False
    quant_probe_batch: int = 4
    quant_probe_seed: int = 0
    slo_p95_ms: float = 0.0
    queue_bound: int = 0
    stream_cache_tiles: int = 4096
    stream_max_sessions: int = 64
    stream_track_match_frac: float = 0.05
    min_replicas: int = 0
    max_replicas: int = 0
    scale_interval_s: float = 1.0
    scale_cooldown_s: float = 5.0
    scale_up_queue_depth: int = 4
    scale_up_p95_frac: float = 0.8
    scale_down_idle_evals: int = 3
    shadow_fraction: float = 0.0
    shadow_min_samples: int = 16
    shadow_iou_floor: float = 0.98
    shadow_psi_ceiling: float = 0.25
    shadow_latency_factor: float = 3.0

    def __post_init__(self) -> None:
        if not self.bucket_sizes:
            raise ValueError("bucket_sizes must not be empty")
        sizes = tuple(self.bucket_sizes)
        if list(sizes) != sorted(set(sizes)):
            raise ValueError(
                f"bucket_sizes must be strictly increasing, got {sizes}"
            )
        for s in sizes:
            if s <= 0 or s % 16 != 0:
                raise ValueError(
                    f"every bucket size must be a positive multiple of 16 "
                    f"(the U-Net's spatial contract), got {s}"
                )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {self.max_delay_ms}"
            )
        if self.swap_poll_s <= 0:
            raise ValueError(f"swap_poll_s must be > 0, got {self.swap_poll_s}")
        if self.tile_overlap < 0 or self.tile_overlap >= min(sizes):
            raise ValueError(
                f"tile_overlap must be in [0, smallest bucket), got "
                f"{self.tile_overlap} with buckets {sizes}"
            )
        if self.mesh_batch < 1 or self.max_batch % self.mesh_batch != 0:
            raise ValueError(
                f"mesh_batch={self.mesh_batch} must be >= 1 and divide "
                f"max_batch={self.max_batch}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "serve compute_dtype must be float32 or bfloat16, got "
                f"{self.compute_dtype!r}"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.quant not in ("none", "int8"):
            raise ValueError(
                f"serve quant must be 'none' or 'int8', got {self.quant!r}"
            )
        if not 0.0 < self.quant_iou_floor <= 1.0:
            raise ValueError(
                f"quant_iou_floor must be in (0, 1], got {self.quant_iou_floor}"
            )
        if self.kernel_plane not in ("reference", "fused_int8", "fp8"):
            raise ValueError(
                "kernel_plane must be 'reference', 'fused_int8' or 'fp8', "
                f"got {self.kernel_plane!r}"
            )
        if self.kernel_plane != "reference" and self.quant != "int8":
            raise ValueError(
                f"kernel_plane={self.kernel_plane!r} requires quant='int8' — "
                "the fused planes consume the quantized tree and ride its "
                "install gate"
            )
        if self.quant_probe_batch < 1:
            raise ValueError(
                f"quant_probe_batch must be >= 1, got {self.quant_probe_batch}"
            )
        if self.slo_p95_ms < 0:
            raise ValueError(f"slo_p95_ms must be >= 0, got {self.slo_p95_ms}")
        if self.queue_bound < 0:
            raise ValueError(f"queue_bound must be >= 0, got {self.queue_bound}")
        if self.stream_cache_tiles < 0:
            raise ValueError(
                f"stream_cache_tiles must be >= 0, got {self.stream_cache_tiles}"
            )
        if self.stream_max_sessions < 1:
            raise ValueError(
                f"stream_max_sessions must be >= 1, got {self.stream_max_sessions}"
            )
        if not 0.0 < self.stream_track_match_frac <= 1.0:
            raise ValueError(
                f"stream_track_match_frac must be in (0, 1], got "
                f"{self.stream_track_match_frac}"
            )
        if self.min_replicas < 0 or self.max_replicas < 0:
            raise ValueError(
                f"min_replicas/max_replicas must be >= 0, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        if self.min_replicas > 0:
            if self.max_replicas < self.min_replicas:
                raise ValueError(
                    f"max_replicas={self.max_replicas} must be >= "
                    f"min_replicas={self.min_replicas}"
                )
            if not self.min_replicas <= self.replicas <= self.max_replicas:
                raise ValueError(
                    f"replicas={self.replicas} (the boot size) must sit in "
                    f"[min_replicas={self.min_replicas}, "
                    f"max_replicas={self.max_replicas}]"
                )
        elif self.max_replicas > 0:
            raise ValueError(
                "max_replicas without min_replicas is a disarmed ceiling — "
                "set min_replicas >= 1 to arm the autoscaler"
            )
        if self.scale_interval_s <= 0:
            raise ValueError(
                f"scale_interval_s must be > 0, got {self.scale_interval_s}"
            )
        if self.scale_cooldown_s < 0:
            raise ValueError(
                f"scale_cooldown_s must be >= 0, got {self.scale_cooldown_s}"
            )
        if self.scale_up_queue_depth < 1:
            raise ValueError(
                f"scale_up_queue_depth must be >= 1, got "
                f"{self.scale_up_queue_depth}"
            )
        if not 0.0 < self.scale_up_p95_frac <= 1.0:
            raise ValueError(
                f"scale_up_p95_frac must be in (0, 1], got "
                f"{self.scale_up_p95_frac}"
            )
        if self.scale_down_idle_evals < 1:
            raise ValueError(
                f"scale_down_idle_evals must be >= 1, got "
                f"{self.scale_down_idle_evals}"
            )
        if not 0.0 <= self.shadow_fraction <= 1.0:
            raise ValueError(
                f"shadow_fraction must be in [0, 1], got {self.shadow_fraction}"
            )
        if self.shadow_min_samples < 1:
            raise ValueError(
                f"shadow_min_samples must be >= 1, got {self.shadow_min_samples}"
            )
        if not 0.0 < self.shadow_iou_floor <= 1.0:
            raise ValueError(
                f"shadow_iou_floor must be in (0, 1], got {self.shadow_iou_floor}"
            )
        if self.shadow_psi_ceiling <= 0:
            raise ValueError(
                f"shadow_psi_ceiling must be > 0, got {self.shadow_psi_ceiling}"
            )
        if self.shadow_latency_factor < 1.0:
            raise ValueError(
                f"shadow_latency_factor must be >= 1, got "
                f"{self.shadow_latency_factor}"
            )
