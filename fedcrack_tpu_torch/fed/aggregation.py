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
is unweighted). The robust instances (trimmed mean, median, Krum) belong to
a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Iterable

from fedcrack_tpu_torch.fed.algorithms import fedavg

# One triple per contributing update, in the plane's canonical order.
Triple = tuple  # (name: str, weight: float, tree: Any)


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
