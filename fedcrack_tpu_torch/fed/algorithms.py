"""Federated aggregation math: FedAvg, the FedProx penalty, seeded cohort
sampling and the FedOpt server optimizers.

The counterpart of ``fedcrack_tpu.fed.algorithms``. FedAvg is the sample-weighted element-wise mean of the
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

from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_map, tree_unflatten


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
    flat = [tree_flatten(u) for u in updates]
    treedef = flat[0][1]
    if any(td != treedef for _, td in flat[1:]):
        raise ValueError("client trees differ in structure")
    columns = zip(*(leaves for leaves, _ in flat))
    return tree_unflatten(treedef, [_weighted_mean_leaf(col, raw_w, total) for col in columns])


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


def sample_cohort(
    n_clients: int,
    cohort_size: int,
    round_idx: int,
    seed: int = 0,
) -> np.ndarray:
    """The round's cohort: a seeded, sorted, without-replacement sample of
    ``cohort_size`` client indices from ``n_clients``, a pure function of
    ``(seed, round_idx)`` (each round seeds a fresh ``SeedSequence([seed,
    round_idx])``)."""
    if n_clients <= 0:
        raise ValueError(f"n_clients must be positive, got {n_clients}")
    if not 0 < cohort_size <= n_clients:
        raise ValueError(
            f"cohort_size must be in [1, n_clients={n_clients}], got {cohort_size}"
        )
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(round_idx)]))
    picks = rng.choice(n_clients, size=cohort_size, replace=False)
    return np.sort(picks.astype(np.int64))


# ---- FedOpt: server optimizers on the round pseudo-gradient ----
#
# (Reddi et al., "Adaptive Federated Optimization".) ``global - average``
# is a pseudo-gradient fed to a server optimizer: FedAvgM (momentum),
# FedAdam, FedYogi. Only ``params`` go through it; BatchNorm statistics
# are plain-averaged. The JAX package builds these on optax; the port has
# no optax, so each is an ``init``/``update`` pair over float32 numpy
# trees with the same expressions, and its state a tuple of trees.


class ServerOptimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state) -> (updates,
    state)``, as an optax ``GradientTransformation``."""

    init: Callable
    update: Callable


def _zeros(tree: Any) -> Any:
    return tree_map(lambda p: np.zeros(np.shape(p), np.float32), tree)


def _sgd_momentum(lr: float, momentum: float) -> ServerOptimizer:
    """optax ``sgd(lr, momentum)``: ``m = g + momentum * m``, update
    ``-lr * m``."""

    def update(grads, state):
        (m,) = state
        m = tree_map(lambda g, t: g + momentum * t, grads, m)
        return tree_map(lambda t: (-lr) * t, m), (m,)

    return ServerOptimizer(lambda params: (_zeros(params),), update)


def _fedopt_adaptive(lr: float, b1: float, b2: float, eps: float, variant: str) -> ServerOptimizer:
    """Reddi et al.'s adaptive server updates with no bias correction:
    ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g^2`` (FedAdam) or
    ``v = v - (1-b2)*sign(v - g^2)*g^2`` (FedYogi), step
    ``-lr * m / (sqrt(v) + eps)``."""

    def v_update(vi, g):
        g2 = np.square(g.astype(np.float32))
        if variant == "yogi":
            return vi - (1.0 - b2) * np.sign(vi - g2) * g2
        return b2 * vi + (1.0 - b2) * g2

    def update(grads, state):
        m, v = state
        m = tree_map(lambda mi, g: b1 * mi + (1.0 - b1) * g.astype(np.float32), m, grads)
        v = tree_map(v_update, v, grads)
        updates = tree_map(lambda mi, vi: -lr * mi / (np.sqrt(vi) + eps), m, v)
        return updates, (m, v)

    return ServerOptimizer(lambda params: (_zeros(params), _zeros(params)), update)


def make_server_optimizer(kind: str, lr: float = 1.0, momentum: float = 0.9) -> ServerOptimizer | None:
    """The server update for ``FedConfig.server_optimizer``, or None for
    plain FedAvg."""
    if kind in ("", "avg", "fedavg", "none"):
        return None
    if kind in ("momentum", "fedavgm"):
        return _sgd_momentum(lr, momentum)
    if kind in ("adam", "fedadam"):
        return _fedopt_adaptive(lr, b1=0.9, b2=0.99, eps=1e-3, variant="adam")
    if kind in ("yogi", "fedyogi"):
        return _fedopt_adaptive(lr, b1=0.9, b2=0.99, eps=1e-3, variant="yogi")
    raise ValueError(f"unknown server optimizer {kind!r}")


def apply_server_opt(global_params, avg_params, tx: ServerOptimizer, opt_state):
    """One FedOpt step: pseudo-gradient = global - average (so SGD with
    lr=1 and no momentum recovers plain FedAvg). Returns ``(new_params,
    new_opt_state)``; each leaf keeps the global's dtype."""
    grad = tree_map(
        lambda g, a: np.asarray(g).astype(np.float32) - np.asarray(a).astype(np.float32),
        global_params,
        avg_params,
    )
    updates, new_opt_state = tx.update(grad, opt_state)
    new_params = tree_map(
        lambda p, u: np.asarray(np.asarray(p) + u).astype(np.asarray(p).dtype),
        global_params,
        updates,
    )
    return new_params, new_opt_state
