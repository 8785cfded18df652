"""Inference engine: bucket programs plus tiled sliding-window inference.

The counterpart of ``fedcrack_tpu.serve.engine``, one device, no mesh:

- ``predict_bucket`` runs one batch of uint8 ``[B, S, S, 3]`` images (S a
  bucket size, B padded to ``max_batch`` lanes) through the program the
  weights select: a ``ResUNet`` (the reference program, from
  :meth:`InferenceEngine.prepare`) or a ``QuantizedVariables`` tree (the
  quantized program, from :meth:`InferenceEngine.prepare_quantized`).
  Normalization happens on the device; float32 sigmoid probabilities come
  back to the host.
- The quantized program's body is ``ServeConfig.kernel_plane``:
  ``"reference"`` dequantizes and runs the reference model,
  ``"fused_int8"`` / ``"fp8"`` run ``kernels.forward.fused_predict_logits``,
  whose convs are the hand-written dequant-matmul kernel on the card.
- ``ServeConfig.compute_dtype`` is the reference programs' dtype (the
  model of :meth:`prepare`, and the dequantized model of the quantized
  ``"reference"`` plane): ``"bfloat16"`` runs them in bfloat16 as
  ``models/resunet.py`` says. The fused planes ignore it and accumulate in
  float32, as the JAX package's do, so the quant gate holds a fused
  program against the bfloat16 reference program.
- ``predict_image`` pads a request into the smallest bucket that holds it
  and crops the answer, or tiles an image larger than every bucket.
  The tile schedule, ramp weights and float32 host accumulation order are
  fixed functions of (H, W, tile, overlap), so tiled output is
  byte-identical run to run.

PyTorch runs eagerly, so there is nothing to compile per bucket; warmup
runs each bucket once to load the kernels and settle the allocator.

Numerics on the card: cuDNN convolutions and cuBLAS matmuls may use TF32
by default, which would make the reference program, and with it the quant
gate, TF32. An engine on CUDA turns both off for the process
(``torch.backends.cudnn.allow_tf32 = False``,
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from fedcrack_tpu_torch.configs import SLOT_PLANE_ONLY, ModelConfig, SegFormerConfig, ServeConfig
from fedcrack_tpu_torch.data.pipeline import normalize_images
from fedcrack_tpu_torch.models.convert import flax_to_state_dict, from_flax_variables
from fedcrack_tpu_torch.models.resunet import ResUNet
from fedcrack_tpu_torch.serve.quant import QuantizedVariables


def tile_plan(extent: int, tile: int, overlap: int) -> list[int]:
    """Deterministic 1-D tile offsets covering ``[0, extent)`` with
    ``tile``-sized windows sharing at least ``overlap`` pixels; the last
    window is clamped to the extent. Requires ``extent >= tile``."""
    if extent < tile:
        raise ValueError(f"extent {extent} < tile {tile}")
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be < tile {tile}")
    offsets = list(range(0, max(extent - tile, 0) + 1, stride))
    if offsets[-1] != extent - tile:
        offsets.append(extent - tile)
    return offsets


def _ramp_weights(tile: int, overlap: int, has_before: bool, has_after: bool) -> np.ndarray:
    """1-D blend weights for one tile: 1.0 inside, ramping down to
    1/(overlap+1) over the ``overlap`` pixels facing a neighbour."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = np.linspace(1.0, 1.0 / (overlap + 1), overlap, dtype=np.float32)
        if has_before:
            w[:overlap] = ramp[::-1]
        if has_after:
            w[-overlap:] = ramp
    return w


def _tree_to(node: Any, device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    return node.to(device)


class InferenceEngine:
    """Owns the bucket programs and the padding/tiling routing.

    Stateless with respect to weights: every predict call takes the weights
    to use (placed once by :meth:`prepare` / :meth:`prepare_quantized`);
    the version manager decides which weights are current."""

    def __init__(
        self,
        model_config: ModelConfig | None = None,
        serve_config: ServeConfig | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        if isinstance(model_config, SegFormerConfig):
            raise ValueError(SLOT_PLANE_ONLY.format(what="serving"))
        self.model_config = model_config or ModelConfig()
        self.serve_config = serve_config or ServeConfig()
        if self.model_config.in_channels != 3:
            raise ValueError("serving assumes 3-channel RGB inputs")
        if self.serve_config.mesh_batch != 1:
            raise ValueError("the port serves on one device (mesh_batch=1)")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InferenceEngine defaults to device='cuda' and no CUDA device "
                    "is available; pass device='cpu' explicitly to run on the CPU"
                )
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # Training-time layout kept, serving dtype applied; img_size only
        # keeps the config coherent (the model is fully convolutional).
        self.bucket_model_config = dataclasses.replace(
            self.model_config,
            img_size=max(self.serve_config.bucket_sizes),
            compute_dtype=self.serve_config.compute_dtype,
        )
        # torch has e4m3 on every device, so an fp8 request never degrades
        # (the JAX engine's effective_kernel_plane has no counterpart).
        self.kernel_plane = self.serve_config.kernel_plane
        # The fused planes run the reference layouts only (kernels/forward.py);
        # the reference plane serves every layout, quantized or not.
        cfg = self.bucket_model_config
        if (self.serve_config.quant == "int8" and self.kernel_plane != "reference"
                and (cfg.stem_layout != "reference" or cfg.res_layout != "reference")):
            raise ValueError(
                f"kernel_plane={self.kernel_plane!r} supports only the "
                "reference parameter layouts (kernels/forward.py); got "
                f"stem_layout={cfg.stem_layout!r} "
                f"res_layout={cfg.res_layout!r}"
            )
        # Parameterless twin of the model: the quantized reference plane
        # runs it over dequantized tensors with torch.func.functional_call.
        self._template = ResUNet(self.bucket_model_config, device="meta")
        self._max_batch = self.serve_config.max_batch
        self._count_lock = threading.Lock()
        self.quantized_forwards = 0

    # ---- weights placement ----

    def prepare(self, variables: Any) -> Any:
        """Place a flax-layout host tree on the device as the reference
        program (a loaded ``ResUNet``); a ``QuantizedVariables`` goes to
        :meth:`prepare_quantized`."""
        if isinstance(variables, QuantizedVariables):
            return self.prepare_quantized(variables)
        model = ResUNet(self.bucket_model_config, device=self.device)
        return from_flax_variables(variables, model)

    def prepare_quantized(self, quantized: Any) -> QuantizedVariables:
        """Place a quantized tree's codes and scales on the device as is.
        For a fused plane, the depthwise codes' group and the launches'
        epilogue plan are built and validated here, once per placed tree,
        and travel with it."""
        if not isinstance(quantized, QuantizedVariables):
            raise TypeError(
                f"prepare_quantized wants QuantizedVariables, got "
                f"{type(quantized).__name__}"
            )
        if self.serve_config.quant != "int8":
            raise ValueError(
                "engine was built with quant='none'; rebuild with "
                "ServeConfig.quant='int8' to serve quantized weights"
            )
        tree = _tree_to(quantized.tree, self.device)
        if self.kernel_plane == "reference":
            return QuantizedVariables(tree)
        from fedcrack_tpu_torch.kernels.forward import depthwise_group, epilogue_plan

        cfg = self.bucket_model_config
        return QuantizedVariables(tree, depthwise_group(tree, cfg), epilogue_plan(tree, cfg))

    # ---- bucket routing ----

    @property
    def bucket_sizes(self) -> tuple[int, ...]:
        return tuple(self.serve_config.bucket_sizes)

    @property
    def max_batch(self) -> int:
        return self._max_batch

    def bucket_for(self, h: int, w: int) -> int | None:
        """Smallest bucket that holds (h, w); None -> tiled path."""
        for size in self.serve_config.bucket_sizes:
            if h <= size and w <= size:
                return size
        return None

    def warmup(self, variables: Any) -> None:
        """Run every bucket once with the given weights before traffic."""
        for size in self.serve_config.bucket_sizes:
            self.predict_bucket(variables, np.zeros((self._max_batch, size, size, 3), np.uint8))

    def _quantized_logits(self, variables: QuantizedVariables, x: torch.Tensor) -> torch.Tensor:
        from fedcrack_tpu_torch.serve.quant import dequantize_variables

        if self.kernel_plane == "reference":
            state = flax_to_state_dict(dequantize_variables(variables.tree))
            return torch.func.functional_call(self._template, state, (x,))
        from fedcrack_tpu_torch.kernels.forward import fused_predict_logits

        return fused_predict_logits(variables.tree, x, self.bucket_model_config, variables.depthwise,
                                    variables.epilogues)

    @torch.inference_mode()
    def _forward_batch(self, variables: Any, images_u8: np.ndarray) -> np.ndarray:
        x = normalize_images(torch.from_numpy(images_u8).to(self.device))
        if isinstance(variables, QuantizedVariables):
            if self.serve_config.quant != "int8":
                raise ValueError(
                    "quantized weights handed to an engine built with quant='none'"
                )
            logits = self._quantized_logits(variables, x)
            if self.serve_config.quant_act_fakequant:
                from fedcrack_tpu_torch.serve.quant import fake_quant_activations

                logits = fake_quant_activations(logits)
            with self._count_lock:
                self.quantized_forwards += 1
        elif isinstance(variables, ResUNet):
            logits = variables(x)
        else:
            raise TypeError(
                "predict wants weights from prepare()/prepare_quantized(), got "
                f"{type(variables).__name__}"
            )
        return torch.sigmoid(logits).to(torch.float32).cpu().numpy()

    def predict_bucket(self, variables: Any, images_u8: np.ndarray) -> np.ndarray:
        """One batch through its bucket program: ``[B, S, S, 3]`` uint8 with
        B <= max_batch and S a bucket size; the batch is zero-padded to
        max_batch lanes (eval BatchNorm keeps lanes independent). Returns
        ``[B, S, S, 1]`` float32 probabilities on the host."""
        b, h, w, c = images_u8.shape
        if h != w or h not in self.serve_config.bucket_sizes:
            raise ValueError(f"not a bucket shape: {images_u8.shape}")
        if b > self._max_batch:
            raise ValueError(f"batch {b} exceeds max_batch {self._max_batch}")
        if images_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 transport bytes, got {images_u8.dtype}")
        if b < self._max_batch:
            pad = np.zeros((self._max_batch - b, h, w, c), np.uint8)
            images_u8 = np.concatenate([images_u8, pad], axis=0)
        return self._forward_batch(variables, np.ascontiguousarray(images_u8))[:b]

    def predict_image(self, variables: Any, image_u8: np.ndarray) -> np.ndarray:
        """One ``[H, W, 3]`` uint8 image at any size: direct bucket, padded
        bucket, or tiled sliding window. Returns ``[H, W, 1]`` float32."""
        h, w, _ = image_u8.shape
        bucket = self.bucket_for(h, w)
        if bucket is not None:
            canvas = np.zeros((1, bucket, bucket, 3), np.uint8)
            canvas[0, :h, :w] = image_u8
            return self.predict_bucket(variables, canvas)[0, :h, :w]
        return self.predict_tiled(variables, image_u8)

    # ---- tiled sliding-window inference ----

    def predict_tiled(self, variables: Any, image_u8: np.ndarray) -> np.ndarray:
        """Overlap-blended sliding-window inference with the largest bucket
        as the tile; byte-identical run to run."""
        tile = max(self.serve_config.bucket_sizes)
        overlap = self.serve_config.tile_overlap
        h, w, _ = image_u8.shape
        ph, pw = max(h, tile), max(w, tile)
        if (ph, pw) != (h, w):
            padded = np.zeros((ph, pw, 3), np.uint8)
            padded[:h, :w] = image_u8
            image_u8 = padded
        ys = tile_plan(ph, tile, overlap)
        xs = tile_plan(pw, tile, overlap)
        acc = np.zeros((ph, pw, 1), np.float32)
        wacc = np.zeros((ph, pw, 1), np.float32)
        tiles, spans = [], []
        for yi, y in enumerate(ys):
            for xi, x in enumerate(xs):
                tiles.append(image_u8[y : y + tile, x : x + tile])
                wy = _ramp_weights(tile, overlap, yi > 0, yi + 1 < len(ys))
                wx = _ramp_weights(tile, overlap, xi > 0, xi + 1 < len(xs))
                spans.append((y, x, np.outer(wy, wx)[..., None]))
        for start in range(0, len(tiles), self._max_batch):
            chunk = np.stack(tiles[start : start + self._max_batch])
            probs = self.predict_bucket(variables, chunk)
            for i, (y, x, wgt) in enumerate(spans[start : start + self._max_batch]):
                acc[y : y + tile, x : x + tile] += probs[i] * wgt
                wacc[y : y + tile, x : x + tile] += wgt
        out = acc / wacc
        return out[:h, :w]

    def n_tiles(self, h: int, w: int) -> int:
        """How many tiles a (h, w) image costs on the tiled path."""
        tile = max(self.serve_config.bucket_sizes)
        overlap = self.serve_config.tile_overlap
        ph, pw = max(h, tile), max(w, tile)
        return len(tile_plan(ph, tile, overlap)) * len(tile_plan(pw, tile, overlap))


def watch_kernel_compiles(registry: Any = None) -> None:
    """Export the port's run-time compiles since this call as the serve
    plane's ``serve_recompiles_total`` gauge, read at every scrape: the
    kernel libraries loaded, each built first where its cache held none
    (``kernels.build.compile_count``), the only compiling the eager port
    does. Call it after the engines'
    warm-up, as the JAX command calls ``watch_recompiles``: the
    steady-state contract says the gauge then stays 0 across any number of
    hot swaps."""
    from fedcrack_tpu_torch.kernels.build import compile_count
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    mark = compile_count()
    reg = registry if registry is not None else REGISTRY
    reg.gauge(
        "serve_recompiles_total",
        "kernel libraries loaded (and built) since the serve plane's warm-up "
        "(steady-state contract: 0 across any number of hot swaps)",
    ).set_function(lambda: compile_count() - mark)
