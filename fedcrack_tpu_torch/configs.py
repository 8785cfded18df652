"""Model, data, federation and serving configuration for the PyTorch port.

The port keeps its own copy of the dataclasses its slices need, with the
same fields, defaults and validation as ``fedcrack_tpu.configs``, so that a
JSON config written for one package describes the same model, data and
serving plane in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Residual U-Net hyperparameters (reference: client_fit_model.py:92-150).

    128x128x3 inputs, stem 32 filters, encoder (64, 128, 256), decoder
    (256, 128, 64, 32) and a single-logit head. ``stem_layout`` and
    ``res_layout`` name re-expressions of the same weights: the stem run
    space-to-depth (``"s2d"``, ``"s2d_full"``) and the encoder's residual
    projections run channel-packed (``"packed"``), with the parameters,
    their names and shapes unchanged (``models.resunet``).
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
class SegFormerConfig:
    """SegFormer hyperparameters (Xie et al., NeurIPS 2021,
    arXiv:2105.15203; NVlabs/SegFormer ``mit_b5`` and ``SegFormerHead``),
    B5 by default: a Mix Transformer of four stages (``embed_dims``,
    ``num_heads``, ``depths``, spatial-reduction ratios ``sr_ratios``, MLP
    ratio ``mlp_ratio``) and the All-MLP head of width ``decoder_dim``.
    ``img_size`` and ``num_classes`` play their ``ModelConfig`` roles: the
    square crop the data path stages, and the head's logits (one for the
    crack mask). Trains in float32 only, on the slot plane
    (``parallel.fedavg_mesh``)."""

    img_size: int = 1024
    in_channels: int = 3
    num_classes: int = 1
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    depths: tuple[int, ...] = (3, 6, 40, 3)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    decoder_dim: int = 768
    compute_dtype: str = "float32"
    param_dtype: str = "float32"

    def __post_init__(self) -> None:
        stages = (self.embed_dims, self.num_heads, self.depths, self.sr_ratios)
        if any(len(s) != 4 for s in stages):
            raise ValueError(f"segformer has four stages; got embed_dims, num_heads, depths, sr_ratios {stages}")
        # Patch embeddings of stride 4, 2, 2, 2: the last stage is at 1/32.
        if self.img_size % 32 != 0 or self.img_size <= 0:
            raise ValueError(f"segformer img_size must be a positive multiple of 32, got {self.img_size}")
        for i, (dim, heads, sr) in enumerate(zip(self.embed_dims, self.num_heads, self.sr_ratios)):
            if heads < 1 or dim % heads:
                raise ValueError(f"stage {i + 1}: {heads} heads do not divide width {dim}")
            if sr < 1 or (self.img_size >> (2 + i)) % sr:
                raise ValueError(f"stage {i + 1}: sr_ratio {sr} does not divide its grid of "
                                 f"{self.img_size >> (2 + i)}")
        if min(self.depths) < 1 or self.mlp_ratio < 1 or self.decoder_dim < 1:
            raise ValueError(f"segformer depths, mlp_ratio and decoder_dim must be positive; got {self.depths}, "
                             f"{self.mlp_ratio}, {self.decoder_dim}")
        if self.compute_dtype != "float32" or self.param_dtype != "float32":
            raise ValueError("segformer trains in float32 only; got "
                             f"compute_dtype={self.compute_dtype!r} param_dtype={self.param_dtype!r}")

    @property
    def input_shape(self) -> tuple[int, int, int]:
        return (self.img_size, self.img_size, self.in_channels)


SLOT_PLANE_ONLY = ("model_type 'segformer' trains on the slot plane only (parallel.round_from_config); "
                   "{what} runs the residual U-Net")


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
class ServeConfig:
    """Serving-plane configuration.

    The shadow-delivery fields (``shadow_*``) are kept, though the port
    does not act on them yet (the serve command refuses
    ``shadow_fraction > 0``), so that one config validates the same way in
    both packages.
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


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federation round/protocol configuration: every field of the JAX
    package's ``FedConfig``, with its defaults and its validation, so the
    port accepts exactly the configurations the JAX package accepts and
    its round machine sends the same handshake map.

    The mesh plane's fields (``mesh_clients``, ``mesh_batch``,
    ``segments``, ``segment_overlap``, ``data_placement``) drive the slot
    plane: ``parallel.round_from_config`` builds the round they describe on
    one card (a ``mesh_batch`` above 1 splits each step's batch with
    sync-BN), and ``segment_overlap`` is the
    driver's knob of that name.

    Reference values: MAX_NUM_ROUND=5 (fl_server.py:18), 10 s registration
    window (fl_server.py:42), 20 s version poll (fl_client.py:141), local
    epochs hardcoded to 10 (client_fit_model.py:166).
    """

    max_rounds: int = 5
    cohort_size: int = 2
    # "sync" (the round barrier) or "buffered" (FedBuff, fed/buffered.py).
    mode: str = "sync"
    buffer_k: int = 2
    staleness_alpha: float = 0.5
    max_staleness: int = 4
    # Seed of fed.algorithms.sample_cohort.
    cohort_seed: int = 0
    local_epochs: int = 10
    learning_rate: float = 1e-3
    registration_window_s: float = 10.0
    poll_period_s: float = 20.0
    # Per-round deadline; on expiry the cohort shrinks to the clients that
    # reported. 0 = no deadline.
    round_deadline_s: float = 0.0
    # The round closes at ceil(quorum_fraction * |cohort|) updates.
    quorum_fraction: float = 1.0
    # Every upload is checked against the global template before the fold.
    sanitize_updates: bool = True
    # The server's combine: fedavg, trimmed_mean, (coordinate_)median,
    # krum, multi_krum (fed/aggregation.py).
    aggregation: str = "fedavg"
    trim_fraction: float = 0.1
    byzantine_f: int = 1
    # A client whose flush-time robust z reaches this is left out of the
    # fold. 0 disables.
    quarantine_z: float = 0.0
    # Update-level DP (privacy/dpsgd.py, applied by the client command
    # line) and the RDP accountant (privacy/accountant.py) that charges
    # each round's contributors.
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_sample_rate: float = 0.01
    dp_delta: float = 1e-5
    dp_steps_per_round: int = 0
    dp_seed: int = 0
    dp_epsilon_budget: float = 0.0
    # Pairwise-mask secure aggregation (privacy/secagg.py).
    secagg: bool = False
    secagg_bits: int = 24
    # Mid-round durable server state (ckpt/statefile.py).
    state_path: str = ""
    # FedProx proximal term; 0 disables.
    fedprox_mu: float = 0.0
    # Crack-pixel loss weight; 1.0 is the reference's unweighted BCE.
    pos_weight: float = 1.0
    # FedOpt on the round pseudo-gradient: avg, momentum/fedavgm,
    # adam/fedadam, yogi/fedyogi (params only; BN stats plain-averaged).
    server_optimizer: str = "avg"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    model_type: str = "resunet"
    # "bfloat16" halves broadcast and upload bytes; server math stays f32.
    wire_dtype: str = "float32"
    # Compressed update transport (compress/): "null" is the raw blob.
    update_codec: str = "null"
    topk_fraction: float = 0.01
    host: str = "127.0.0.1"
    port: int = 8889              # reference: fl_server.py:218
    ckpt_dir: str = ""
    seed: int = 0
    metrics_path: str = ""
    tb_dir: str = ""
    logs_dir: str = ""
    # In-memory log sink caps, in MiB; 0 = uncapped.
    log_max_mb_per_upload: int = 64
    log_max_mb_total: int = 256
    profile_dir: str = ""
    init_weights: str = ""
    best_path: str = ""
    auth_token: str = ""
    allow_insecure_token: bool = False
    tls_cert: str = ""
    tls_key: str = ""
    tls_ca: str = ""
    max_message_mb: int = 512     # reference: fl_server.py:215
    # ModelConfig, or SegFormerConfig under model_type "segformer".
    model: ModelConfig | SegFormerConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    mesh_clients: int = 8
    mesh_batch: int = 1
    segments: int = 0
    segment_overlap: bool = True
    data_placement: str = "streamed"

    def __post_init__(self) -> None:
        if (self.model_type == "segformer") != isinstance(self.model, SegFormerConfig):
            raise ValueError(
                f"model_type={self.model_type!r} does not match its {type(self.model).__name__} model block: "
                "model_type 'segformer' takes a SegFormerConfig, every other model type a ModelConfig"
            )
        if self.data.img_size != self.model.img_size:
            raise ValueError(
                "data.img_size and model.img_size must match; got "
                f"{self.data.img_size} vs {self.model.img_size}"
            )
        if self.segments < 0:
            raise ValueError(f"segments must be >= 0, got {self.segments}")
        if self.segments > 0 and self.local_epochs % self.segments != 0:
            raise ValueError(
                f"segments={self.segments} must divide "
                f"local_epochs={self.local_epochs} (epoch-grain segmentation)"
            )
        if self.data_placement not in ("streamed", "resident"):
            raise ValueError(
                "data_placement must be 'streamed' or 'resident', got "
                f"{self.data_placement!r}"
            )
        if self.mode not in ("sync", "buffered"):
            raise ValueError(
                f"mode must be 'sync' or 'buffered', got {self.mode!r}"
            )
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        if self.staleness_alpha < 0.0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got {self.staleness_alpha}"
            )
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}"
            )
        if self.cohort_seed < 0:
            raise ValueError(
                f"cohort_seed must be >= 0, got {self.cohort_seed}"
            )
        if not 0.0 < self.quorum_fraction <= 1.0:
            raise ValueError(
                f"quorum_fraction must be in (0, 1], got {self.quorum_fraction}"
            )
        if self.aggregation not in (
            "fedavg", "trimmed_mean", "median", "coordinate_median",
            "krum", "multi_krum",
        ):
            raise ValueError(
                "aggregation must be one of 'fedavg', 'trimmed_mean', "
                "'median', 'coordinate_median', 'krum', 'multi_krum', got "
                f"{self.aggregation!r}"
            )
        if not 0.0 <= self.trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5), got {self.trim_fraction}"
            )
        if self.byzantine_f < 0:
            raise ValueError(
                f"byzantine_f must be >= 0, got {self.byzantine_f}"
            )
        if self.quarantine_z < 0.0:
            raise ValueError(
                f"quarantine_z must be >= 0 (0 disables), got "
                f"{self.quarantine_z}"
            )
        if self.dp_clip_norm < 0.0:
            raise ValueError(
                f"dp_clip_norm must be >= 0 (0 disables DP), got "
                f"{self.dp_clip_norm}"
            )
        if self.dp_noise_multiplier < 0.0:
            raise ValueError(
                f"dp_noise_multiplier must be >= 0, got "
                f"{self.dp_noise_multiplier}"
            )
        if self.dp_noise_multiplier > 0.0 and self.dp_clip_norm <= 0.0:
            raise ValueError(
                "dp_noise_multiplier > 0 requires dp_clip_norm > 0: noise "
                "is calibrated to the clip norm (stddev = multiplier * "
                "clip), and unclipped gradients have no sensitivity bound "
                "for the accountant to certify."
            )
        if not 0.0 < self.dp_sample_rate <= 1.0:
            raise ValueError(
                f"dp_sample_rate must be in (0, 1], got {self.dp_sample_rate}"
            )
        if not 0.0 < self.dp_delta < 1.0:
            raise ValueError(
                f"dp_delta must be in (0, 1), got {self.dp_delta}"
            )
        if self.dp_steps_per_round < 0:
            raise ValueError(
                f"dp_steps_per_round must be >= 0 (0 derives local_epochs), "
                f"got {self.dp_steps_per_round}"
            )
        if self.dp_epsilon_budget < 0.0:
            raise ValueError(
                f"dp_epsilon_budget must be >= 0 (0 = unlimited), got "
                f"{self.dp_epsilon_budget}"
            )
        if not 8 <= self.secagg_bits <= 52:
            raise ValueError(
                f"secagg_bits must be in [8, 52] (float64-exact fixed "
                f"point), got {self.secagg_bits}"
            )
        if self.secagg:
            if self.aggregation != "fedavg":
                raise ValueError(
                    "secagg composes only with the null combine: masked "
                    "updates are opaque to robust aggregation, so "
                    "aggregation must be 'fedavg', got "
                    f"{self.aggregation!r}. This is the privacy/robustness "
                    "trade-off — pick one per federation."
                )
            if self.quarantine_z != 0.0:
                raise ValueError(
                    "secagg requires quarantine_z=0: the health ledger cannot "
                    "window norms/cosines of masked uploads, so quarantine "
                    "would act on noise. Got quarantine_z="
                    f"{self.quarantine_z}."
                )
            if self.update_codec != "null":
                raise ValueError(
                    "secagg requires update_codec='null': the masked "
                    "fixed-point wire format replaces the codec stack, got "
                    f"{self.update_codec!r}"
                )
            if self.mode != "sync":
                raise ValueError(
                    "secagg requires mode='sync': the masking roster is a "
                    "closed cohort, and the buffered plane folds across "
                    f"cohort boundaries. Got mode={self.mode!r}."
                )
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"wire_dtype must be float32 or bfloat16, got {self.wire_dtype!r}"
            )
        if self.update_codec not in ("null", "int8", "topk_delta"):
            raise ValueError(
                "update_codec must be 'null', 'int8' or 'topk_delta', got "
                f"{self.update_codec!r}"
            )
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}"
            )
        if self.max_message_mb < 1:
            raise ValueError(
                f"max_message_mb must be >= 1, got {self.max_message_mb}"
            )
        if bool(self.tls_cert) != bool(self.tls_key):
            raise ValueError(
                "tls_cert and tls_key must be set together; got "
                f"tls_cert={self.tls_cert!r}, tls_key={self.tls_key!r}"
            )
        if (
            self.auth_token
            and not (self.tls_cert or self.tls_ca)
            and not self.allow_insecure_token
        ):
            raise ValueError(
                "auth_token is set but the channel is plaintext (no TLS "
                "config): the secret would travel in cleartext on every "
                "message. Configure tls_cert/tls_key (server) or tls_ca "
                "(client), or set allow_insecure_token=true to accept this "
                "for loopback/testing."
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str | bytes) -> "FedConfig":
        raw = json.loads(blob)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "FedConfig":
        raw = dict(raw)
        model = raw.pop("model", {})
        data = raw.pop("data", {})
        serve = raw.pop("serve", {})
        known = {f.name for f in dataclasses.fields(cls)}
        raw = {k: v for k, v in raw.items() if k in known}
        # model_type "segformer" takes a SegFormerConfig block, every other a ModelConfig.
        mcls = ModelConfig
        if raw.get("model_type") == "segformer":
            mcls = SegFormerConfig
            layouts = {k: model[k] for k in ("stem_layout", "res_layout") if model.get(k, "reference") != "reference"}
            if layouts:
                raise ValueError(
                    f"{layouts} re-express the residual U-Net's stem and residual convs; model_type 'segformer' "
                    "has neither and runs the reference layout only"
                )
        mknown = {f.name for f in dataclasses.fields(mcls)}
        dknown = {f.name for f in dataclasses.fields(DataConfig)}
        sknown = {f.name for f in dataclasses.fields(ServeConfig)}
        mc = mcls(**{k: _detuple(k, v) for k, v in model.items() if k in mknown})
        dc = DataConfig(**{k: v for k, v in data.items() if k in dknown})
        sc = ServeConfig(
            **{k: _detuple(k, v) for k, v in serve.items() if k in sknown}
        )
        return cls(model=mc, data=dc, serve=sc, **raw)


def _detuple(key: str, value: Any) -> Any:
    if key in ("encoder_features", "decoder_features", "bucket_sizes", "embed_dims", "num_heads", "depths",
               "sr_ratios") and isinstance(
        value, list
    ):
        return tuple(value)
    return value
