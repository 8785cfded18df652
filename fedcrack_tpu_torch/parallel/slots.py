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
rows.

A mesh made with ``group=`` spans the processes of a ``torch.distributed``
process group (``parallel.multihost``): each rank holds a contiguous
block of the outer axis (``clients``; ``space`` for the spatial plane's
``(data, space)`` mesh), stages only that block's data, and the round
gathers the blocks' updates and folds them in client order on every
rank. The inner axis stays inside each process.
"""

from __future__ import annotations

import dataclasses

import torch

from fedcrack_tpu_torch.parallel.multihost import ProcessSpan, process_span

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
    for the spatial plane. ``span`` is the processes the mesh spans (None:
    this one), ``split_axis`` the axis whose blocks they share out."""

    sizes: tuple
    device: torch.device
    axis_names: tuple = (CLIENTS, BATCH)
    span: ProcessSpan | None = None
    split_axis: str | None = None

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as a JAX mesh's ``shape``: the global
        sizes."""
        return dict(zip(self.axis_names, self.sizes))

    def local_range(self, axis: str) -> range:
        """The indices along ``axis`` this process holds: all of them, or
        its rank's contiguous block of the split axis."""
        n = self.shape[axis]
        if self.span is None or axis != self.split_axis:
            return range(n)
        per = n // self.span.world
        return range(self.span.rank * per, (self.span.rank + 1) * per)


def make_mesh(n_clients: int, n_batch: int = 1, device: torch.device | str | None = None,
              axis_names: tuple = (CLIENTS, BATCH), group=None, split_axis: str | None = None) -> SlotMesh:
    """A mesh of ``n_clients x n_batch`` on ``device`` (CUDA unless
    named), its axes called ``axis_names``.

    ``group`` (a ``torch.distributed`` process group, or
    ``parallel.multihost.WORLD`` for the default one) spreads
    ``split_axis`` (the first axis unless named) over the group's ranks in
    contiguous blocks, which must be equal; it raises where no process
    group is up."""
    if n_clients <= 0 or n_batch <= 0:
        raise ValueError(f"mesh axes must be positive, got ({n_clients}, {n_batch})")
    if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
        raise ValueError(f"a mesh takes two distinct axis names, got {axis_names!r}")
    device = resolve_device(device)
    sizes, axis_names = (int(n_clients), int(n_batch)), tuple(axis_names)
    if group is None:
        return SlotMesh(sizes, device, axis_names)
    split_axis = split_axis or axis_names[0]
    if split_axis not in axis_names:
        raise ValueError(f"split_axis {split_axis!r} is not one of the mesh's axes {axis_names}")
    span = process_span(group, device)
    n = dict(zip(axis_names, sizes))[split_axis]
    if n % span.world:
        raise ValueError(f"the '{split_axis}' axis of {n} does not divide over {span.world} processes")
    return SlotMesh(sizes, device, axis_names, span, split_axis)
