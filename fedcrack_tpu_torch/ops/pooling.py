"""3x3 / stride-2 SAME max pooling, with the JAX package's gradient rule.

The encoder pool (Keras ``MaxPooling2D(3, strides=2, "same")``) pads the
way XLA's ``"SAME"`` does: ``total = max((out - 1) * 2 + 3 - size, 0)``
split ``lo = total // 2`` and ``hi = total - lo``, so an even grid pads
0 before and 1 after, never 1 and 1 as ``nn.MaxPool2d(padding=1)`` would.
The pad value is ``-inf``, so a pad cell never wins a window.

The backward is the counterpart of ``fedcrack_tpu.ops.pooling._bwd``: for
each output, the FIRST window offset in row-major order whose candidate is
not below the output (``~(cand < out)``) and is not a pad cell takes the
whole cotangent. Ties therefore go to the first maximum, as in XLA's
SelectAndScatter, and a NaN maximum still routes its gradient, to the first
valid offset. ``F.max_pool2d``'s own backward follows the indices its
forward recorded, where a NaN takes the window; it is not this rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WINDOW = 3
_STRIDE = 2


def same_pads(size: int, window: int, stride: int) -> tuple[int, int, int]:
    """(out_size, pad_lo, pad_hi) of XLA ``"SAME"`` padding on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    lo = total // 2
    return out, lo, total - lo


def _pool_forward(x: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = x.shape
    _, lo_h, hi_h = same_pads(h, _WINDOW, _STRIDE)
    _, lo_w, hi_w = same_pads(w, _WINDOW, _STRIDE)
    xc = x.permute(0, 3, 1, 2)
    xc = F.pad(xc, (lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
    y = F.max_pool2d(xc, kernel_size=_WINDOW, stride=_STRIDE)
    return y.permute(0, 2, 3, 1)


def _pool_backward(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, pads_h: tuple[int, int],
                   pads_w: tuple[int, int], row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The cotangent of the pool's input ``x`` (NHWC). ``pads_h`` and
    ``pads_w`` are the ``-inf`` pads the forward added; ``row_valid``
    ([N, H] bool), where given, marks further rows of ``x`` that are pad
    cells too (a halo pool's global-edge fill)."""
    n, h, w, c = x.shape
    lo_h, hi_h = pads_h
    lo_w, hi_w = pads_w
    ho, wo = out.shape[1], out.shape[2]
    xp = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h),
               value=float("-inf")).permute(0, 2, 3, 1)
    # Contributions land on the padded input grid, each offset's in its
    # strided slice; per input cell they add in offset order, as the
    # JAX backward adds them.
    dxp = torch.zeros(xp.shape, dtype=g.dtype, device=g.device)
    claimed = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
    rows = torch.arange(ho, device=x.device) * _STRIDE
    cols = torch.arange(wo, device=x.device) * _STRIDE
    if row_valid is not None:
        row_valid = F.pad(row_valid, (lo_h, hi_h), value=False)
    for dy in range(_WINDOW):
        ys = rows + dy
        lim_y = dy + _STRIDE * (ho - 1) + 1
        for dx in range(_WINDOW):
            xs = cols + dx
            lim_x = dx + _STRIDE * (wo - 1) + 1
            cand = xp[:, dy:lim_y:_STRIDE, dx:lim_x:_STRIDE, :]
            # Pad cells never claim: under a NaN maximum every compare
            # is False and a pad at the first offset would take it.
            valid = (((ys >= lo_h) & (ys < lo_h + h))[:, None]
                     & ((xs >= lo_w) & (xs < lo_w + w))[None, :])[None, :, :, None]
            if row_valid is not None:
                valid = valid & row_valid[:, dy:lim_y:_STRIDE, None, None]
            m = ~(cand < out) & ~claimed & valid
            claimed |= m
            dxp[:, dy:lim_y:_STRIDE, dx:lim_x:_STRIDE, :] += torch.where(m, g, 0.0)
    return dxp[:, lo_h:lo_h + h, lo_w:lo_w + w, :].to(x.dtype)


class _MaxPool3x3S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = _pool_forward(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, out = ctx.saved_tensors
        _, h, w, _ = x.shape
        _, lo_h, hi_h = same_pads(h, _WINDOW, _STRIDE)
        _, lo_w, hi_w = same_pads(w, _WINDOW, _STRIDE)
        return _pool_backward(x, out, g, (lo_h, hi_h), (lo_w, hi_w))


class _MaxPool3x3S2Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, halo_real: torch.Tensor) -> torch.Tensor:
        n, h1, w, _ = x.shape
        # The halo row of a shard with no neighbour below is SAME padding:
        # -inf in the forward, a pad cell in the backward.
        row_valid = torch.ones((n, h1), dtype=torch.bool, device=x.device)
        row_valid[:, -1] = halo_real
        x = torch.where(row_valid[:, :, None, None], x, float("-inf"))
        _, lo_w, hi_w = same_pads(w, _WINDOW, _STRIDE)
        xc = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, 0, 0), value=float("-inf"))
        out = F.max_pool2d(xc, kernel_size=_WINDOW, stride=_STRIDE).permute(0, 2, 3, 1)
        ctx.save_for_backward(x, out, row_valid)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, out, row_valid = ctx.saved_tensors
        _, lo_w, hi_w = same_pads(x.shape[2], _WINDOW, _STRIDE)
        return _pool_backward(x, out, g, (0, 0), (lo_w, hi_w), row_valid), None


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """NHWC max pool, window 3x3, stride 2, SAME; the same values as
    ``flax.linen.max_pool(x, (3, 3), (2, 2), "SAME")`` and the JAX
    package's gradient (first row-major maximum takes the cotangent)."""
    return _MaxPool3x3S2.apply(x)


# The JAX package's max_pool_auto picks between two backward lowerings by
# grid size (its scatter-free VJP up to 64, XLA's SelectAndScatter above);
# values and gradients agree on both, so here it is one function.
max_pool_auto = max_pool_3x3_s2


def max_pool_3x3_s2_halo(x: torch.Tensor, halo_real: torch.Tensor) -> torch.Tensor:
    """The pool of one H shard of an image: ``x`` NHWC ``[N, h + 1, W,
    C]`` holds the shard's ``h`` rows (``h`` even) and below them one halo
    row, the first row of the shard beneath (``parallel.spatial``). W is
    padded SAME here; H is not, since the halo row is the window's third
    row at the shard's bottom edge, where the whole image's pool pads 0
    before and 1 after. ``halo_real`` ([N] bool) says whose halo row is a
    neighbour's: a False row is the image's bottom edge, -inf in the
    forward and never claiming a gradient, as the pad row of
    :func:`max_pool_3x3_s2`. A neighbour's row is a real candidate, and its
    share of the cotangent flows back to it through the exchange.

    Stacked over the shards, the values are :func:`max_pool_3x3_s2`'s of the
    whole image bit for bit, and so is the cotangent of each cell that
    only one shard's windows read; a shard's first row, read by the window
    above it too, takes its two shares in another order of addition."""
    if x.shape[1] % 2 != 1:
        raise ValueError(f"a halo pool takes an even shard plus one halo row, got {x.shape[1]} rows")
    return _MaxPool3x3S2Halo.apply(x, halo_real)
