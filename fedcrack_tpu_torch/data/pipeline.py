"""Image transport encoding shared by the serving path.

Images travel as uint8 bytes and become the model's float32-in-[0, 1]
contract on the device. The JAX package multiplies by the float32
reciprocal of 255 rather than dividing (XLA rewrites the divide into that
multiply), so the port multiplies by the same constant to stay bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

_INV255 = np.float32(1.0 / 255.0)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 transport bytes -> float32 in [0, 1]; float32 passes through."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) * float(_INV255)
    return images


def to_uint8_transport(
    images: np.ndarray, masks: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """float32 images in [0, 1] -> round-to-nearest uint8; masks {0, 1} ->
    uint8 {0, 1}. The inverse of :func:`normalize_images`."""
    images_u8 = np.clip(np.rint(images * np.float32(255.0)), 0, 255).astype(np.uint8)
    return images_u8, masks.astype(np.uint8)
