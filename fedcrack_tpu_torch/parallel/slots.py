"""The slot mesh: how many client slots a round runs, and where.

The JAX package runs a round as one ``shard_map`` over ``Mesh(('clients',
'batch'))``, one client per chip. The port has one card, so a round runs
its ``clients`` slots on that card one after another, in client order
(``parallel.fedavg_mesh``). :func:`make_mesh` takes the place of the JAX
package's ``parallel.mesh.make_mesh`` for the round builders, the spatial
plane and the driver: a value that carries the two axes' names and sizes
and the device.

The inner axis splits one client's step into shards whose BatchNorm
moments are synchronised and whose gradients are averaged: ``batch``
splits the batch (sync-BN data parallelism), ``space`` the image height
(``parallel.spatial``). On one card the ``batch`` shards, folded in
order, are the batch itself, so a ``(C, B)`` round runs the ``(C, 1)``
round's steps; the ``space`` shards run as one fold of halo-exchanged
rows. Several cards (``parallel/multihost.py`` over ``torch.distributed``)
are ROADMAP Queue 1 item 4's last part.
"""

from __future__ import annotations

import dataclasses

import torch

CLIENTS, BATCH = "clients", "batch"


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device``, CUDA when None; raises where CUDA is asked for and
    absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the slot plane defaults to device='cuda' and no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """Two named axes of ``sizes`` on ``device``: ``(clients, batch)`` for
    a round, ``(clients, space)`` for a spatial round, ``(data, space)``
    for the spatial plane."""

    sizes: tuple
    device: torch.device
    axis_names: tuple = (CLIENTS, BATCH)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(n_clients: int, n_batch: int = 1, device: torch.device | str | None = None,
              axis_names: tuple = (CLIENTS, BATCH)) -> SlotMesh:
    """A mesh of ``n_clients x n_batch`` on ``device`` (CUDA unless
    named), its axes called ``axis_names``."""
    if n_clients <= 0 or n_batch <= 0:
        raise ValueError(f"mesh axes must be positive, got ({n_clients}, {n_batch})")
    if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
        raise ValueError(f"a mesh takes two distinct axis names, got {axis_names!r}")
    return SlotMesh((int(n_clients), int(n_batch)), resolve_device(device), tuple(axis_names))
