"""The residual U-Net, its weight carry-over from flax, and the model
registry (the counterpart of ``fedcrack_tpu.models``): ``get_model``
accepts the reference's advertised model type string ``"mobilenet_v2"``
as an alias, so a reference client's handshake resolves to the real
model."""

from __future__ import annotations

import torch

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.models.resunet import ResUNet, depth_to_space, space_to_depth

_ALIASES = {
    "resunet": "resunet",
    "unet": "resunet",
    # Legacy alias: the reference's advertised-but-vestigial model type string.
    "mobilenet_v2": "resunet",
}


def get_model(name: str = "resunet", config: ModelConfig | None = None,
              device: torch.device | str | None = None) -> ResUNet:
    """Build a model by registry name (case-insensitive, legacy aliases
    ok), its weights not drawn, on ``device`` (CUDA unless named)."""
    key = _ALIASES.get(name.lower())
    if key is None:
        raise KeyError(f"unknown model type {name!r}; known: {sorted(_ALIASES)}")
    return ResUNet(config or ModelConfig(), device=device)


__all__ = ["ResUNet", "depth_to_space", "get_model", "space_to_depth"]
