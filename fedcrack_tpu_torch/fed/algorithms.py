"""Federated aggregation math: FedAvg and the FedProx penalty.

The counterpart of ``fedcrack_tpu.fed.algorithms.fedavg`` and
``fedprox_penalty``. FedAvg is the sample-weighted element-wise mean of the
clients' trees (BatchNorm statistics averaged with the kernels, as the
reference's ``get_weights()`` lists include them). A tree is a nested dict
whose leaves are numpy arrays (decoded client payloads) or torch tensors
on any device.

The mean is the expression of the JAX package's host path (the native
``weighted_accumulate`` / ``scale_inplace`` kernels): from a float32 zero,
``acc += float32(w) * x`` per client in order, then
``acc *= float32(1 / total)`` with the total summed in float64. The native
kernels are compiled with FMA contraction, so ``acc + w * x`` rounds once
to float32; the port rounds it once too (the product of two float32 values
is exact in float64), which keeps the two packages within an ulp of each
other even where client values cancel.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


def _leaves(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k in tree:
            out += _leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def _rebuild(template: Any, values: dict[tuple, Any], path: tuple = ()) -> Any:
    if isinstance(template, Mapping):
        return {k: _rebuild(template[k], values, path + (k,)) for k in template}
    return values[path]


def _weighted_mean_leaf(leaves: Sequence[Any], weights: Sequence[float], total: float) -> Any:
    first = leaves[0]
    scale = np.float32(1.0 / total)
    if isinstance(first, torch.Tensor):
        acc = torch.zeros(first.shape, dtype=torch.float32, device=first.device)
        for w, x in zip(weights, leaves):
            w32 = float(np.float32(w))
            acc = (acc.double() + w32 * x.to(acc.device, torch.float64)).to(torch.float32)
        return (acc * float(scale)).to(first.dtype)
    acc = np.zeros(np.shape(first), np.float32)
    for w, x in zip(weights, leaves):
        w64 = np.float64(np.float32(w))
        acc = (acc.astype(np.float64) + w64 * np.asarray(x, np.float64)).astype(np.float32)
    acc *= scale
    return acc.astype(np.asarray(first).dtype, copy=False)


def fedavg(updates: Sequence[Any], weights: Sequence[float] | None = None) -> Any:
    """Weighted element-wise mean of K client trees.

    ``weights`` are per-client sample counts (proper FedAvg); ``None``
    gives the reference's unweighted mean (fl_server.py:101-102 divides the
    sum by the client count)."""
    if not updates:
        raise ValueError("fedavg over zero clients")
    k = len(updates)
    if weights is None:
        raw_w = [1.0] * k
    else:
        if len(weights) != k:
            raise ValueError(f"{len(weights)} weights for {k} updates")
        raw_w = [float(x) for x in weights]
        if sum(raw_w) <= 0:
            raise ValueError("non-positive total weight")
    total = float(np.sum(np.asarray(raw_w, np.float64)))
    columns = [dict(_leaves(u)) for u in updates]
    paths = list(columns[0])
    for col in columns[1:]:
        if list(col) != paths:
            raise ValueError("client trees differ in structure")
    mean = {p: _weighted_mean_leaf([col[p] for col in columns], raw_w, total) for p in paths}
    return _rebuild(updates[0], mean)


def fedprox_penalty(
    params: Mapping[str, torch.Tensor], anchor: Mapping[str, torch.Tensor], mu: float
) -> torch.Tensor:
    """``(mu/2)·||params − anchor||²`` over matching names, the FedProx
    proximal term added to the client loss; summed leaf by leaf from a
    float32 zero."""
    total = None
    for name, p in params.items():
        sq = torch.sum((p.to(torch.float32) - anchor[name].to(torch.float32)) ** 2)
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("fedprox_penalty over no parameters")
    return 0.5 * mu * total
