"""Overlap-blended sliding-window segmentation of a large photo, plainly.

A photo larger than the model's tile is covered by square tiles whose
offsets step by ``tile - overlap`` along each axis, the last one clamped to
the edge. Each tile's probabilities are weighted by the outer product of
two 1-D ramps that fall linearly from 1 to ``1/(overlap+1)`` over the
``overlap`` pixels facing a neighbouring tile, and the photo's map is the
weighted sum over the tiles divided by the summed weights.
"""

from __future__ import annotations

import torch

from benchmark.reference import resunet


def offsets(extent: int, tile: int, overlap: int) -> list[int]:
    last = extent - tile
    out = list(range(0, last + 1, tile - overlap))
    if out[-1] != last:
        out.append(last)
    return out


def _ramp(tile: int, overlap: int, before: bool, after: bool, device) -> torch.Tensor:
    w = torch.ones(tile, dtype=torch.float32, device=device)
    ramp = torch.linspace(1.0, 1.0 / (overlap + 1), overlap, dtype=torch.float32, device=device)
    if before:
        w[:overlap] = ramp.flip(0)
    if after:
        w[-overlap:] = ramp
    return w


def tile_count(h: int, w: int, tile: int, overlap: int) -> int:
    return len(offsets(max(h, tile), tile, overlap)) * len(offsets(max(w, tile), tile, overlap))


def photo_probabilities(variables: dict, photo_u8: torch.Tensor, tile: int, overlap: int, *,
                        tf32: bool = False, block: int = 32) -> torch.Tensor:
    """``[H, W, 1]`` float32 map of one uint8 ``[H, W, 3]`` photo on the
    photo's device."""
    h, w, _ = photo_u8.shape
    ph, pw = max(h, tile), max(w, tile)
    canvas = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=photo_u8.device)
    canvas[:h, :w] = photo_u8
    ys, xs = offsets(ph, tile, overlap), offsets(pw, tile, overlap)
    spans = [(y, x) for y in ys for x in xs]
    tiles = torch.stack([canvas[y:y + tile, x:x + tile] for y, x in spans])
    probs = resunet.probabilities(variables, tiles, tf32=tf32, block=block)
    acc = torch.zeros((ph, pw, 1), dtype=torch.float32, device=photo_u8.device)
    wacc = torch.zeros_like(acc)
    for k, (y, x) in enumerate(spans):
        yi, xi = ys.index(y), xs.index(x)
        wy = _ramp(tile, overlap, yi > 0, yi + 1 < len(ys), acc.device)
        wx = _ramp(tile, overlap, xi > 0, xi + 1 < len(xs), acc.device)
        wgt = torch.outer(wy, wx)[..., None]
        acc[y:y + tile, x:x + tile] += probs[k] * wgt
        wacc[y:y + tile, x:x + tile] += wgt
    return (acc / wacc)[:h, :w]
