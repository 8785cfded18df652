"""The models, their weight carry-over from flax, and the model registry
(the counterpart of ``fedcrack_tpu.models``): the residual U-Net, and
SegFormer, which the port alone has and trains on the slot plane only.
``get_model`` accepts the reference's advertised model type string
``"mobilenet_v2"`` as an alias, so a reference client's handshake resolves
to the real model."""

from __future__ import annotations

import torch

from fedcrack_tpu_torch.configs import ModelConfig, SegFormerConfig
from fedcrack_tpu_torch.models.resunet import ResUNet, depth_to_space, space_to_depth
from fedcrack_tpu_torch.models.segformer import SegFormer
from fedcrack_tpu_torch.obs import spans as tracing

_ALIASES = {
    "resunet": "resunet",
    "unet": "resunet",
    # Legacy alias: the reference's advertised-but-vestigial model type string.
    "mobilenet_v2": "resunet",
}


def build_model(config: ModelConfig | SegFormerConfig | None = None, *, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> ResUNet | SegFormer:
    """The model a config block describes (a ``SegFormerConfig`` builds
    SegFormer, anything else the U-Net), on ``device`` (CUDA unless
    named), its weights drawn from ``generator`` where one is given. Span
    ``model.build`` (``model``, ``params``, ``leaves``)."""
    with tracing.span("model.build") as build_span:
        if isinstance(config, SegFormerConfig):
            name, model = "segformer", SegFormer(config, generator=generator, device=device)
        else:
            name, model = "resunet", ResUNet(config or ModelConfig(), generator=generator, device=device)
        if build_span is not None:
            leaves = list(model.parameters()) + list(model.buffers())
            build_span.set(model=name, params=sum(p.numel() for p in model.parameters()), leaves=len(leaves))
        return model


def get_model(name: str = "resunet", config: ModelConfig | SegFormerConfig | None = None,
              device: torch.device | str | None = None) -> ResUNet | SegFormer:
    """Build a model by registry name (case-insensitive, legacy aliases
    ok), its weights not drawn, on ``device`` (CUDA unless named)."""
    if name.lower() == "segformer":
        if config is not None and not isinstance(config, SegFormerConfig):
            raise TypeError(f"model type 'segformer' takes a SegFormerConfig, got {type(config).__name__}")
        return build_model(config or SegFormerConfig(), device=device)
    # The U-Net's names, and the JAX package's text for any other.
    if _ALIASES.get(name.lower()) is None:
        raise KeyError(f"unknown model type {name!r}; known: {sorted(_ALIASES)}")
    if isinstance(config, SegFormerConfig):
        raise TypeError(f"model type {name!r} takes a ModelConfig, got a SegFormerConfig")
    return build_model(config or ModelConfig(), device=device)


__all__ = ["ResUNet", "SegFormer", "build_model", "depth_to_space", "get_model", "space_to_depth"]
