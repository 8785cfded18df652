"""Synthetic crack-image fixtures (numpy, deterministic per seed), in
memory or written to disk in the reference dataset's layout.

A copy of ``fedcrack_tpu.data.synthetic.synth_crack_batch``: a noisy
concrete-like texture with a dark random-walk crack polyline, the mask
being the crack's footprint. The quant gate's probe batch comes from here,
so the draw order must stay byte-identical to the JAX package's (pinned by
tests/test_torch_quant.py).
"""

from __future__ import annotations

import os

import numpy as np


def _crack_polyline(
    rng: np.random.Generator, size: int, min_thickness: int | None = None
) -> np.ndarray:
    """Boolean crack footprint: a jittered random walk across the tile."""
    mask = np.zeros((size, size), dtype=bool)
    y = rng.integers(0, size)
    lo_t = 1 if min_thickness is None else min_thickness
    thickness = int(rng.integers(lo_t, max(lo_t + 1, size // 24)))
    for x in range(size):
        y = int(np.clip(y + rng.integers(-2, 3), 0, size - 1))
        lo = max(0, y - thickness)
        hi = min(size, y + thickness + 1)
        mask[lo:hi, x] = True
    if rng.random() < 0.5:
        mask = mask.T
    return mask


def synth_crack_batch(
    n: int,
    img_size: int = 128,
    seed: int = 0,
    crack_prob: float = 0.8,
    min_thickness: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``n`` (image, mask) pairs: images float32 [n, s, s, 3] in [0, 1],
    masks float32 [n, s, s, 1] in {0, 1}."""
    rng = np.random.default_rng(seed)
    images = np.empty((n, img_size, img_size, 3), np.float32)
    masks = np.zeros((n, img_size, img_size, 1), np.float32)
    for i in range(n):
        base = rng.uniform(0.45, 0.75)
        texture = rng.normal(base, 0.06, size=(img_size, img_size, 1)).astype(np.float32)
        img = np.clip(np.repeat(texture, 3, axis=-1), 0.0, 1.0)
        if rng.random() < crack_prob:
            crack = _crack_polyline(rng, img_size, min_thickness)
            darkness = rng.uniform(0.15, 0.35)
            img[crack] = darkness + rng.normal(0, 0.02, size=(int(crack.sum()), 3)).astype(
                np.float32
            )
            masks[i, crack, 0] = 1.0
        images[i] = np.clip(img, 0.0, 1.0)
    return images, masks


def write_synthetic_dataset(
    root: str,
    n: int = 32,
    img_size: int = 128,
    seed: int = 0,
    crack_prob: float = 0.8,
    min_thickness: int | None = None,
) -> tuple[str, str]:
    """Write :func:`synth_crack_batch`'s pairs under ``root/images`` (JPEG)
    and ``root/masks`` (PNG, lossless, so no ringing crosses the ``> 0``
    binarisation) with equal stems, the reference dataset's layout; returns
    ``(image_dir, mask_dir)``. Needs OpenCV."""
    import cv2

    image_dir = os.path.join(root, "images")
    mask_dir = os.path.join(root, "masks")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    images, masks = synth_crack_batch(n, img_size, seed, crack_prob, min_thickness)
    for i in range(n):
        bgr = cv2.cvtColor((images[i] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imwrite(os.path.join(image_dir, f"img_{i:05d}.jpg"), bgr)
        cv2.imwrite(os.path.join(mask_dir, f"img_{i:05d}.png"), (masks[i, :, :, 0] * 255).astype(np.uint8))
    return image_dir, mask_dir
