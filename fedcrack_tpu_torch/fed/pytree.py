"""Nested-dict trees in the JAX package's canonical leaf order.

The JAX package walks weight trees with ``jax.tree_util``: a dict's
children in sorted key order, a list's or tuple's in position order, and
``None`` as an empty node with no leaf. Every order-sensitive step of the
port's federation (the leaf index in ``validate_update``'s reasons,
template restore, the flattened update vector of the health ledger and of
Krum) walks trees the same way through these helpers, so both packages
number and concatenate leaves identically.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the tree with
    :func:`tree_unflatten` (dicts come back with sorted keys, as
    ``jax.tree_util.tree_unflatten`` gives them)."""
    leaves: list = []

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(c) for c in node])
        if node is None:
            return ("none", None, [])
        leaves.append(node)
        return ("leaf", None, [])

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(spec: Any) -> Any:
        kind, keys, children = spec
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        values = [build(c) for c in children]
        if kind is list:
            return values
        return kind(*values) if hasattr(kind, "_fields") else kind(values)

    return build(treedef)


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must have the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*args) for args in zip(leaves, *others)])
