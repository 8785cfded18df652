"""Weights carried between the flax variables tree and the port's models.

The JAX package's ``{'params', 'batch_stats'}`` tree is nested dicts keyed
by flax module names; the port's ``ResUNet`` and ``SegFormer`` use the
same names as module attributes, so a leaf path maps to a state-dict key
directly:

- ``params/<module...>/kernel`` -> ``<module...>.weight``: a conv's HWIO
  -> OIHW (a depthwise ``(3, 3, 1, C)`` kernel becomes ``(C, 1, 3, 3)`` by
  the same permutation), a Dense ``[in, out]`` -> a Linear's ``[out,
  in]``;
- ``params/<module...>/{bias,scale}`` -> ``<module...>.{bias,scale}``
  (BatchNorm's and LayerNorm's scale);
- ``batch_stats/<bn>/{mean,var}`` -> ``<bn>.{mean,var}``.

Values are carried bit for bit in both directions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from torch import nn

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def kernel_to_weight(kernel: torch.Tensor) -> torch.Tensor:
    """A flax kernel as the torch weight it maps to (a permuted view)."""
    return kernel.permute(*_HWIO_TO_OIHW) if kernel.ndim == 4 else kernel.t()


def weight_to_kernel(weight: torch.Tensor) -> torch.Tensor:
    """A torch conv or Linear weight as its flax kernel (a permuted view)."""
    return weight.permute(*_OIHW_TO_HWIO) if weight.ndim == 4 else weight.t()


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))  # a copy: host trees may be read-only


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State-dict view of a flax-layout tree of numpy arrays or tensors.
    Kernels come out as permuted views (no copy for tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: dict, path: tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, dict):
                walk(child, path + (name,))
                continue
            t = _as_tensor(child)
            if name == "kernel":
                out[".".join(path + ("weight",))] = kernel_to_weight(t)
            else:
                out[".".join(path + (name,))] = t

    walk(tree["params"], ())
    walk(tree.get("batch_stats", {}), ())
    return out


def from_flax_variables(tree: dict, model: nn.Module) -> nn.Module:
    """Load a flax ``{'params', 'batch_stats'}`` tree into ``model`` (every
    parameter and statistic must be present, with matching shapes)."""
    state = flax_to_state_dict(tree)
    model.load_state_dict(state, strict=True)
    return model


def to_flax_variables(model: nn.Module) -> dict:
    """The flax ``{'params', 'batch_stats'}`` tree (numpy, HWIO kernels) of
    ``model``'s weights."""
    params: dict = {}
    stats: dict = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu()
        if leaf == "weight":
            leaf, arr = "kernel", weight_to_kernel(arr)
        root = stats if leaf in ("mean", "var") else params
        for name in path:
            root = root.setdefault(name, {})
        root[leaf] = np.ascontiguousarray(arr.numpy())
    return {"params": params, "batch_stats": stats}
