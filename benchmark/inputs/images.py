"""Seeded synthetic crack images, made on the device in bulk.

Adapted from ``fedcrack_tpu_torch/data/synthetic.py::synth_crack_batch``
(the JAX package's generator) to rectangular photos and to bulk draws on a
``torch.Generator``: a grey concrete texture (per image a base level in
[0.45, 0.75] and per-pixel noise of standard deviation 0.06, the same in
the three channels), and with probability 0.8 a dark crack (level in
[0.15, 0.35] with per-channel noise of 0.02): a random walk of steps in
{-2..2} across the image along its rows or its columns at even odds,
clamped to the image, of half-thickness drawn from [1, min(H, W) / 24).
The mask is the crack's footprint. Images come back as uint8 transport
bytes (``rint(255 v)``), masks as uint8 {0, 1}.
"""

from __future__ import annotations

import torch

from benchmark.inputs.weights import generator


def crack_images(n: int, h: int, w: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` images ``[n, h, w, 3]`` uint8 and masks ``[n, h, w, 1]``
    uint8, on ``device``."""
    g = generator(seed, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    base = 0.45 + 0.3 * rand(n, 1, 1)
    texture = base + 0.06 * torch.randn((n, h, w), generator=g, device=device)
    has_crack = rand(n) < 0.8
    along_rows = rand(n) < 0.5  # the walk advances along the width
    length = max(h, w)
    steps = torch.randint(-2, 3, (n, length), generator=g, device=device)
    start = rand(n)
    thick_hi = max(2, min(h, w) // 24)
    thickness = torch.randint(1, thick_hi, (n,), generator=g, device=device)
    darkness = 0.15 + 0.2 * rand(n, 1, 1, 1)
    crack_noise = 0.02 * torch.randn((n, h, w, 3), generator=g, device=device)

    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    # Along the rows: a centre row for every column; else a centre column
    # for every row.
    y0 = (start * h).long()
    x0 = (start * w).long()
    cy = torch.clamp(y0[:, None] + torch.cumsum(steps[:, :w], 1), 0, h - 1)          # [n, w]
    cx = torch.clamp(x0[:, None] + torch.cumsum(steps[:, :h], 1), 0, w - 1)          # [n, h]
    t = thickness[:, None, None]
    horiz = (rows[None, :, None] - cy[:, None, :]).abs() <= t                        # [n, h, w]
    vert = (cols[None, None, :] - cx[:, :, None]).abs() <= t
    mask = torch.where(along_rows[:, None, None], horiz, vert) & has_crack[:, None, None]
    img = torch.clamp(texture, 0.0, 1.0)[..., None].expand(n, h, w, 3)
    img = torch.where(mask[..., None], darkness + crack_noise, img)
    images = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return images, mask[..., None].to(torch.uint8)
