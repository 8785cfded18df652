"""The slot mesh: how many client slots a round runs, and where.

The JAX package runs a round as one ``shard_map`` over ``Mesh(('clients',
'batch'))``, one client per chip. The port has one card, so a round runs
its ``clients`` slots on that card one after another, in client order
(``parallel.fedavg_mesh``). :func:`make_mesh` takes the place of the JAX
package's ``parallel.mesh.make_mesh`` for the round builders and the
driver: a value that carries the two axis sizes and the device.

The ``batch`` axis splits one client's batch over chips with sync-BN, which
makes ``(C, B)`` train exactly like ``(C, 1)``; on one card only ``batch=1``
exists, and a wider one raises. Several cards (``parallel/multihost.py``
over ``torch.distributed``) come last in ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import dataclasses

import torch

CLIENTS, BATCH = "clients", "batch"

BATCH_REFUSAL = (
    "a batch axis wider than 1 splits a client over several cards "
    "(parallel/multihost.py over torch.distributed): ROADMAP Queue 1 item 4"
)


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
    """``clients`` slots of one round on ``device`` (``batch`` is 1)."""

    clients: int
    batch: int
    device: torch.device
    axis_names: tuple = (CLIENTS, BATCH)

    @property
    def shape(self) -> dict:
        """``{'clients': C, 'batch': B}``, as a JAX mesh's ``shape``."""
        return {CLIENTS: self.clients, BATCH: self.batch}


def make_mesh(n_clients: int, n_batch: int = 1, device: torch.device | str | None = None) -> SlotMesh:
    """A round of ``n_clients`` slots on ``device`` (CUDA unless named)."""
    if n_clients <= 0 or n_batch <= 0:
        raise ValueError(f"mesh axes must be positive, got ({n_clients}, {n_batch})")
    if n_batch != 1:
        raise NotImplementedError(BATCH_REFUSAL)
    return SlotMesh(int(n_clients), int(n_batch), resolve_device(device))
