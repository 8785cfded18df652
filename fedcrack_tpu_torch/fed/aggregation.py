"""The aggregation algebra: one ordered fold over client updates.

The counterpart of ``fedcrack_tpu.fed.aggregation``. An algebra folds
``(name, weight, tree)`` triples that the caller hands over in canonical
order (sorted client names on the sync round):

    acc = algebra.init()
    for triple in triples:
        acc = algebra.combine(acc, triple)
    result = algebra.finalize(acc)

The fold never re-orders. :class:`FedAvg` is the null instance: the
sample-weighted mean through :func:`fed.algorithms.fedavg` with the JAX
package's weight gate (weights are used iff any is positive, else the mean
is unweighted). The robust instances are the JAX package's, with its numpy
expressions, so they agree bitwise (Multi-Krum's mean within FedAvg's ulp):

- :class:`TrimmedMean`, the coordinate-wise beta-trimmed mean, and
  :class:`CoordinateMedian` (Yin et al., ICML 2018);
- :class:`Krum` / Multi-Krum (Blanchard et al., NeurIPS 2017): each update
  scores the sum of its ``n - f - 2`` smallest squared distances to the
  others; Krum selects the lowest-scoring update verbatim, Multi-Krum
  means the ``n - f`` lowest.

Robust combines ignore the client-reported sample weights: a Byzantine
client self-reports them. The fold runs on the server's host, over the
decoded float32 numpy trees.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.fed.algorithms import fedavg
from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map

# One triple per contributing update, in the plane's canonical order.
Triple = tuple  # (name: str, weight: float, tree: Any)

# The FedConfig.aggregation vocabulary ("median" is shorthand for
# "coordinate_median"; from_config canonicalizes).
AGGREGATIONS = (
    "fedavg", "trimmed_mean", "median", "coordinate_median", "krum",
    "multi_krum",
)


class AggregationAlgebra:
    """One aggregation algebra: ``init`` / ``combine`` / ``finalize``. The
    default ``init``/``combine`` collect the ordered triples into a list."""

    name = "abstract"

    def init(self) -> list:
        return []

    def combine(self, acc: list, triple: Triple) -> list:
        acc.append(triple)
        return acc

    def finalize(self, acc: list) -> Any:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


def fold(algebra: AggregationAlgebra, triples: Iterable[Triple]) -> Any:
    """The ordered fold: run ``triples`` (already in canonical order)
    through ``algebra``."""
    acc = algebra.init()
    for t in triples:
        acc = algebra.combine(acc, t)
    return algebra.finalize(acc)


class FedAvg(AggregationAlgebra):
    """The null instance: the sample-weighted mean, weights passed through
    untouched and used iff any is positive."""

    name = "fedavg"

    def finalize(self, acc: list) -> Any:
        if not acc:
            raise ValueError("aggregation fold over zero updates")
        trees = [t for (_, _, t) in acc]
        weights = [w for (_, w, _) in acc]
        use = weights if any(w > 0 for w in weights) else None
        return fedavg(trees, use)


def _stacked_leaf_combine(trees: Sequence[Any], leaf_fn: Callable) -> Any:
    """Per-leaf combine over the cohort: stack each leaf position across
    the n trees as float32, reduce with ``leaf_fn(stacked)`` and cast back
    to the first tree's leaf dtype."""

    def per_leaf(*leaves):
        stacked = np.stack([np.asarray(leaf, np.float32) for leaf in leaves])
        out = np.asarray(leaf_fn(stacked), np.float32)
        return out.astype(np.asarray(leaves[0]).dtype)

    return tree_map(per_leaf, *trees)


class TrimmedMean(AggregationAlgebra):
    """Coordinate-wise beta-trimmed mean: per coordinate, sort the n client
    values, drop the ``floor(beta * n)`` smallest and largest, mean the
    rest. ``trim_fraction`` in ``[0, 0.5)`` keeps one survivor at least."""

    name = "trimmed_mean"

    def __init__(self, trim_fraction: float = 0.1):
        if not 0.0 <= trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5), got {trim_fraction}"
            )
        self.trim_fraction = float(trim_fraction)

    def finalize(self, acc: list) -> Any:
        if not acc:
            raise ValueError("aggregation fold over zero updates")
        n = len(acc)
        k = int(math.floor(self.trim_fraction * n))

        def leaf_fn(stacked):
            s = np.sort(stacked, axis=0)
            return s[k : n - k].mean(axis=0, dtype=np.float32)

        return _stacked_leaf_combine([t for (_, _, t) in acc], leaf_fn)


class CoordinateMedian(AggregationAlgebra):
    """Coordinate-wise median. Ignores weights."""

    name = "coordinate_median"

    def finalize(self, acc: list) -> Any:
        if not acc:
            raise ValueError("aggregation fold over zero updates")
        return _stacked_leaf_combine(
            [t for (_, _, t) in acc],
            lambda stacked: np.median(stacked, axis=0),
        )


class Krum(AggregationAlgebra):
    """Krum / Multi-Krum. Ties break on ``(score, name, canonical index)``
    so the selection does not depend on arrival order; distances sum in
    float64 over the leaves concatenated in the JAX package's order.
    ``n <= f + 2`` clamps the neighbour count to 1."""

    name = "krum"

    def __init__(self, byzantine_f: int = 1, *, multi: bool = False):
        if byzantine_f < 0:
            raise ValueError(f"byzantine_f must be >= 0, got {byzantine_f}")
        self.byzantine_f = int(byzantine_f)
        self.multi = bool(multi)
        if multi:
            self.name = "multi_krum"

    def _scores(self, vecs: list) -> list:
        n = len(vecs)
        closest = max(1, n - self.byzantine_f - 2)
        d2 = np.zeros((n, n), np.float64)
        for i in range(n):
            for j in range(i + 1, n):
                d = float(np.dot(vecs[i] - vecs[j], vecs[i] - vecs[j]))
                d2[i, j] = d2[j, i] = d
        scores = []
        for i in range(n):
            others = np.sort(np.delete(d2[i], i))
            scores.append(float(np.sum(others[:closest])))
        return scores

    def finalize(self, acc: list) -> Any:
        if not acc:
            raise ValueError("aggregation fold over zero updates")
        n = len(acc)
        if n == 1:
            return acc[0][2]
        vecs = [
            np.concatenate([np.asarray(leaf, np.float64).ravel() for leaf in tree_leaves(t)])
            for (_, _, t) in acc
        ]
        scores = self._scores(vecs)
        order = sorted(range(n), key=lambda i: (scores[i], acc[i][0], i))
        if not self.multi:
            return acc[order[0]][2]
        m = max(1, n - self.byzantine_f)
        # Mean the selected set in canonical index order (not score order)
        # so the summation does not depend on arrival order.
        selected = sorted(order[:m])
        return fedavg([acc[i][2] for i in selected], None)


def from_config(cfg: Any) -> AggregationAlgebra:
    """The FedConfig -> algebra factory: ``cfg.aggregation`` names the
    combine, ``cfg.trim_fraction`` / ``cfg.byzantine_f`` parameterize it;
    missing attributes mean the null instance."""
    kind = getattr(cfg, "aggregation", "fedavg") or "fedavg"
    if kind == "fedavg":
        return FedAvg()
    if kind == "trimmed_mean":
        return TrimmedMean(float(getattr(cfg, "trim_fraction", 0.1)))
    if kind in ("median", "coordinate_median"):
        return CoordinateMedian()
    if kind == "krum":
        return Krum(int(getattr(cfg, "byzantine_f", 1)))
    if kind == "multi_krum":
        return Krum(int(getattr(cfg, "byzantine_f", 1)), multi=True)
    raise ValueError(
        f"unknown aggregation {kind!r} (choose from {AGGREGATIONS})"
    )


def quarantine_set(
    scores: dict, names: Sequence[str], quarantine_z: float
) -> dict:
    """Which of this flush's contributors the fold excludes: a client whose
    robust-z score (:func:`health.ledger.observe_flush`) is at or above
    ``quarantine_z``. ``quarantine_z <= 0`` disables it. A verdict that
    would quarantine the whole cohort is dropped (robust z needs a
    majority reference, and a fold over zero updates cannot advance the
    round). Returns ``{name: score rounded to 6}``."""
    if quarantine_z <= 0.0:
        return {}
    out = {}
    for n in names:
        s = float(scores.get(n, 0.0))
        if s >= quarantine_z:
            out[n] = round(s, 6)
    if out and len(out) >= len(set(names)):
        return {}
    return out


# ---- the slot plane's instance: the same fold, on the device ----
#
# The counterpart of the JAX package's ``mesh_ordered_fold``,
# ``mesh_zero_sums`` and ``mesh_finish_cohort_mean``. There the fold runs
# inside ``shard_map`` over the clients axis; here the round's client slots
# run one after another on one device and fold as they finish. Either way
# the expression tree is ``(((0 + w0·x0) + w1·x1) + ...)`` in client order,
# each product and each sum rounded to float32 as its own operation (no
# fused multiply-add, no reduction whose order a library picks), so a
# cohort run in groups that continue the carry equals the whole cohort run
# at once, bit for bit. A zero-weight padding slot adds ±0.0, a bitwise
# no-op on any partial sum reachable from the +0.0 start.


def mesh_ordered_fold(tree: Any, weight: Any, init: tuple) -> tuple:
    """Continue the carry ``init = (num_tree, den)`` with weighted updates
    in client order. ``tree`` is one slot's tree with a 0-d ``weight``, or
    a stacked tree (leaves ``[C, ...]``) with a ``[C]`` weight vector.
    Float32 tensors on the carry's device throughout. The weights live on
    the host (numbers, numpy, a CPU tensor) and enter the products as
    Python floats holding their float32 values exactly: nothing is copied
    to the device, so the fold waits for nothing there, and each product
    and sum is the same float32 operation as with a 0-d float32 tensor."""
    num, den = init
    w = torch.as_tensor(weight, dtype=torch.float32)
    if w.ndim == 0:
        w0 = w.item()
        return tree_map(lambda a, x: a + w0 * x.to(torch.float32), num, tree), den + w0
    for i, wi in enumerate(w.tolist()):
        num = tree_map(lambda a, x: a + wi * x[i].to(torch.float32), num, tree)
        den = den + wi
    return num, den


def mesh_zero_sums(tree: Any) -> tuple:
    """The fold's identity carry: float32 zeros per update leaf, on each
    leaf's device, and a 0-d zero weight."""
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else torch.device("cpu")
    zeros = tree_map(
        lambda x: torch.zeros(tuple(x.shape), dtype=torch.float32,
                              device=x.device if isinstance(x, torch.Tensor) else device),
        tree,
    )
    return zeros, torch.zeros((), dtype=torch.float32, device=device)


def mesh_finish_cohort_mean(num: Any, total_w: torch.Tensor, fallback: Any) -> Any:
    """Divide the ordered sums into the FedAvg mean, with the empty-cohort
    guard: a zero total weight returns ``fallback`` (the round's incoming
    global) unchanged. Elementwise operations only, on the device."""
    denom = torch.clamp_min(total_w, 1e-9)
    keep = total_w > 0.0

    def leaf(s, orig):
        orig = torch.as_tensor(orig).to(s.device)
        avg = (s / denom).to(orig.dtype)
        return torch.where(keep, avg, orig.to(avg.dtype)).contiguous()

    return tree_map(leaf, num, fallback)
