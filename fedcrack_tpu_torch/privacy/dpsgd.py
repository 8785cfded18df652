"""Update-level DP on the host (McMahan et al. 2018): the host half of
``fedcrack_tpu.privacy.dpsgd``.

The client command line clips the whole round's delta ``trained - base``
to ``C`` and adds one Gaussian draw of standard deviation ``sigma * C``,
on the host in numpy, seeded from ``(dp_seed, cname, round)`` so a retried
upload of the same round is bit-identical and never noised twice. The
arithmetic is the JAX package's, operation for operation (float32 deltas,
the norm from ``np.sum`` in float64, numpy's Philox keyed on a sha256), so
the privatized trees are byte-equal; a torch sum or torch noise would not
be. The per-step DP-SGD transform of the mesh plane (``dp_grad_transform``)
is not here: it comes with the mesh plane.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_unflatten

# Guards the clip factor's division when a delta is exactly zero; far
# below any float32 norm the clip could meaningfully scale.
NORM_EPS = 1e-12


def _host_seed(dp_seed: int, cname: str, round_idx: int) -> int:
    """A 64-bit seed from sha256 of (dp_seed, cname, round): stable across
    processes and platforms, unlike Python's hash()."""
    digest = hashlib.sha256(f"fedcrack-dp:{int(dp_seed)}:{cname}:{int(round_idx)}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _float32(leaf: Any) -> np.ndarray:
    """A numpy array or a CPU tensor (a bfloat16 one included) as float32."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def _like(new: np.ndarray, ref: Any) -> Any:
    """``new`` in the leaf type and dtype of ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(new).to(ref.dtype)
    return new.astype(np.asarray(ref).dtype)


def dp_update_host(
    trained: Any,
    base: Any,
    *,
    clip_norm: float,
    noise_multiplier: float,
    dp_seed: int,
    cname: str,
    round_idx: int,
) -> Any:
    """Clip ``trained - base`` to ``clip_norm`` and add one seeded Gaussian
    draw: returns ``base + clipped_delta + noise`` in ``trained``'s
    structure and leaf dtypes. Leaves are numpy arrays or CPU tensors."""
    t_leaves, treedef = tree_flatten(trained)
    b_leaves = tree_leaves(base)
    if len(t_leaves) != len(b_leaves):
        raise ValueError(f"trained/base leaf mismatch: {len(t_leaves)} vs {len(b_leaves)}")
    deltas = [_float32(t) - _float32(b) for t, b in zip(t_leaves, b_leaves)]
    norm = float(np.sqrt(sum(float(np.sum(d * d)) for d in deltas)))
    factor = min(1.0, float(clip_norm) / (norm + NORM_EPS))
    rng = np.random.Generator(np.random.Philox(key=_host_seed(dp_seed, cname, round_idx)))
    stddev = float(noise_multiplier) * float(clip_norm)
    out = []
    for b, t, d in zip(b_leaves, t_leaves, deltas):
        new = _float32(b) + d * np.float32(factor)
        if stddev > 0.0:
            new = new + rng.normal(0.0, stddev, size=new.shape).astype(np.float32)
        out.append(_like(new, t))
    return tree_unflatten(treedef, out)
