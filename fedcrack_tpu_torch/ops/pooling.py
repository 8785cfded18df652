"""3x3 / stride-2 SAME max pooling, forward only.

The encoder pool (Keras ``MaxPooling2D(3, strides=2, "same")``) pads the
way XLA's ``"SAME"`` does: ``total = max((out - 1) * 2 + 3 - size, 0)``
split ``lo = total // 2`` and ``hi = total - lo``, so an even grid pads
0 before and 1 after, never 1 and 1 as ``nn.MaxPool2d(padding=1)`` would.
The pad value is ``-inf``, so a pad cell never wins a window. The
scatter-free backward of ``fedcrack_tpu.ops.pooling`` belongs to the
training slice.
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


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """NHWC max pool, window 3x3, stride 2, SAME; the same values as
    ``flax.linen.max_pool(x, (3, 3), (2, 2), "SAME")``."""
    _, h, w, _ = x.shape
    _, lo_h, hi_h = same_pads(h, _WINDOW, _STRIDE)
    _, lo_w, hi_w = same_pads(w, _WINDOW, _STRIDE)
    xc = x.permute(0, 3, 1, 2)
    xc = F.pad(xc, (lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
    y = F.max_pool2d(xc, kernel_size=_WINDOW, stride=_STRIDE)
    return y.permute(0, 2, 3, 1)


# The JAX package's max_pool_auto picks between two backward lowerings by
# grid size; the forward values are identical, so here it is one function.
max_pool_auto = max_pool_3x3_s2
