"""DP-SGD primitives: update-level DP on the host, and the per-step
transform of the slot plane. The counterpart of
``fedcrack_tpu.privacy.dpsgd``.

The client command line clips the whole round's delta ``trained - base``
to ``C`` and adds one Gaussian draw of standard deviation ``sigma * C``,
on the host in numpy, seeded from ``(dp_seed, cname, round)`` so a retried
upload of the same round is bit-identical and never noised twice. The
arithmetic is the JAX package's, operation for operation (float32 deltas,
the norm from ``np.sum`` in float64, numpy's Philox keyed on a sha256), so
the privatized trees are byte-equal; a torch sum or torch noise would not
be.

The slot plane (``parallel.fedavg_mesh``) applies the per-step DP-SGD
transform (Abadi et al. 2016, at client granularity) to the gradients
between the backward pass and the Adam step: clip the client's mean
gradient to L2 norm ``C`` (:func:`clip_by_global_norm`), then add
``N(0, (sigma·C)^2)`` (:func:`add_gaussian_noise`). The JAX package keys
the noise with ``jax.random`` fold-ins of (dp_seed, round seed, client,
step); the port derives a ``torch.Generator`` seed from the same chain
(:func:`dp_step_key`). Its noise is held to the JAX noise by its
statistics, not its bytes: matching ``jax.random.normal`` byte for byte
would need threefry and XLA's own inverse-erf polynomial. Replay is exact:
the same chain draws the same bits on one device. CPU (mt19937) and CUDA
(Philox) generators draw different streams, so a DP trajectory on the
card differs from one on the CPU; two runs on the card agree bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# Guards the clip factor's division when a delta is exactly zero; far
# below any float32 norm the clip could meaningfully scale.
NORM_EPS = 1e-12


def global_l2_norm(tree: Any) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree`` (tensors), each leaf's sum
    of squares in float32 and the leaves summed in flatten order."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("global_l2_norm over no leaves")
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, clip_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale ``tree`` by ``min(1, C / (||tree||_2 + eps))``, the DP-SGD
    clip. Returns ``(clipped_tree, factor)``, the factor a 0-d float32
    tensor on the leaves' device."""
    norm = global_l2_norm(tree)
    factor = torch.clamp_max(float(clip_norm) / (norm + NORM_EPS), 1.0).to(torch.float32)
    clipped = tree_map(lambda leaf: (leaf.to(torch.float32) * factor).to(leaf.dtype), tree)
    return clipped, factor


def add_gaussian_noise(tree: Any, seed: int, stddev: float) -> Any:
    """Add ``N(0, stddev^2)`` per leaf, drawn in flatten order from one
    ``torch.Generator`` seeded with ``seed`` on the leaves' device."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return tree
    device = leaves[0].device
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    noised = [
        (leaf.to(torch.float32)
         + stddev * torch.randn(tuple(leaf.shape), generator=g, dtype=torch.float32, device=device)).to(leaf.dtype)
        for leaf in leaves
    ]
    return tree_unflatten(treedef, noised)


def dp_grad_transform(grads: Any, seed: int, clip_norm: float, noise_multiplier: float) -> Any:
    """The per-step DP-SGD transform: clip to ``clip_norm``, then (when
    ``noise_multiplier > 0``) add ``N(0, (noise_multiplier·clip_norm)^2)``
    from ``seed`` (:func:`dp_step_key`)."""
    clipped, _ = clip_by_global_norm(grads, clip_norm)
    if noise_multiplier <= 0.0:
        return clipped
    return add_gaussian_noise(clipped, seed, float(noise_multiplier) * float(clip_norm))


def dp_step_key(dp_seed: int, round_seed: int, client_index: int, step: int) -> int:
    """The (dp_seed, round, client, step) chain as a 63-bit generator
    seed (sha256). ``round_seed`` is the round program's per-dispatch
    counter, restored on a replay with ``codec_state``; ``step`` counts
    the client's steps across its epochs."""
    text = f"fedcrack-dpsgd:{int(dp_seed)}:{int(round_seed)}:{int(client_index)}:{int(step)}"
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "big") >> 1


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
