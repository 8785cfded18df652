"""Synthetic crack-image fixtures (numpy, deterministic per seed).

A copy of ``fedcrack_tpu.data.synthetic.synth_crack_batch``: a noisy
concrete-like texture with a dark random-walk crack polyline, the mask
being the crack's footprint. The quant gate's probe batch comes from here,
so the draw order must stay byte-identical to the JAX package's (pinned by
tests/test_torch_quant.py).
"""

from __future__ import annotations

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
