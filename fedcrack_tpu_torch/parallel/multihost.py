"""Several processes: bring-up over ``torch.distributed``, and the
collectives the slot and spatial planes run across processes.

The counterpart of ``fedcrack_tpu.parallel.multihost``. There
``jax.distributed.initialize`` joins the hosts of a pod slice into one
device set and the unchanged ``shard_map`` programs span them. Here each
process joins a ``torch.distributed`` process group and a mesh made with
``group=`` (``parallel.slots.make_mesh``, ``parallel.spatial.
make_spatial_mesh``) spans the group's ranks: each rank holds a
contiguous block of the mesh's outer axis (a round's ``clients``, the
spatial plane's ``space`` bands) and stages only its own block's data, as
``jax.make_array_from_process_local_data`` feeds the JAX programs.

No cross-process sum in this package is an ``all_reduce``, whose
summation order is not defined: every one gathers the ranks' parts and
adds them in rank order (or folds them in client order), so every rank
holds the same bits, and a round across processes gives the bits of the
same round in one process. The JAX package's psum became an all-gather
plus a left fold for the same reason.

``backend`` is a parameter. ``gloo`` moves host memory: with it every
collective on CUDA tensors is staged through the host (:class:`ProcessSpan`
does the staging in one place). ``nccl`` keeps the tensors on the
devices, and needs one device per rank. Single-process use needs no
initialization: every helper here answers for one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Any

import torch
import torch.distributed as dist

log = logging.getLogger("fedcrack.multihost")

# The default group's name for ``make_mesh(..., group=WORLD)``.
WORLD = "world"
# A peer that has not joined by then fails the bring-up rather than hangs.
DEFAULT_TIMEOUT_S = 300.0
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _init_method(address: str) -> str:
    """``host:port`` as a ``tcp://`` URL; a URL (``tcp://``, ``file://``)
    as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_if_needed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "gloo",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to a ``torch.distributed`` process group when it
    runs as one process of a multi-process job; a no-op otherwise.

    Resolution order (the JAX package's):

    1. a process group already up: return True, touching nothing;
    2. explicit arguments, which must be complete: ``coordinator_address``
       (``host:port`` or an init URL such as ``file:///path``),
       ``num_processes`` and ``process_id``;
    3. torch's own environment (what ``torchrun`` sets): ``MASTER_ADDR``,
       ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, all four;
    4. none of these: single process, return False (JAX's failed
       auto-detect).

    Incomplete arguments or environment raise ``ValueError``. The group's
    ``timeout`` is ``timeout_s``: a peer that never joins makes the
    bring-up raise. Returns True when a process group is up."""
    if _group_up():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        source = "arguments"
    elif os.environ.get("MASTER_ADDR"):
        source = "environment"
        env = {k: os.environ.get(k) for k in _ENV}
        if not all(env.values()):
            raise ValueError(
                "multi-process bring-up from the environment needs MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
                f"and RANK together (got {env})"
            )
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if not coordinator_address or not num_processes or process_id is None \
            or not 0 <= process_id < num_processes:
        raise ValueError(
            "multi-process bring-up needs coordinator_address, num_processes and process_id together "
            f"(got {coordinator_address=}, {num_processes=}, {process_id=})"
        )
    dist.init_process_group(backend, init_method=_init_method(coordinator_address), world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=float(timeout_s)))
    log.info("torch.distributed up from the %s: rank %d of %d over %s", source, dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def _this_device(device: torch.device | str | None) -> torch.device:
    from fedcrack_tpu_torch.parallel.slots import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def global_mesh_devices(device: torch.device | str | None = None) -> list[tuple[int, torch.device]]:
    """Every rank's device in rank order, as ``(rank, device)`` pairs:
    ``device`` is this process's (CUDA unless named; raises where CUDA is
    asked for and absent), gathered from every rank of the process group.
    One pair without a process group."""
    device = _this_device(device)
    if not _group_up():
        return [(0, device)]
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return [(rank, torch.device(name)) for rank, name in enumerate(names)]


def is_coordinator() -> bool:
    """True on the process that runs the control plane and writes
    checkpoints: rank 0, or the only process."""
    return not _group_up() or dist.get_rank() == 0


@dataclasses.dataclass(eq=False)
class ProcessSpan:
    """The processes a mesh spans: this process's ``rank`` of ``world`` in
    ``group``, over ``backend``, its tensors on ``device``.

    Every cross-process move of the planes goes through :meth:`all_gather`
    and :meth:`exchange`, which stage CUDA tensors through host memory
    when the backend is not ``nccl``. ``stats`` counts their calls, the
    bytes this rank sends and receives, and their seconds on the host
    clock (staging included)."""

    group: Any
    rank: int
    world: int
    backend: str
    device: torch.device
    stats: dict = dataclasses.field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    @property
    def host_staged(self) -> bool:
        return self.backend != "nccl" and self.device.type != "cpu"

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, seconds=0.0)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().contiguous().cpu() if self.host_staged else t.detach().contiguous()

    def _count(self, t0: float, n_bytes: int) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += int(n_bytes)
        self.stats["seconds"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape and dtype on all ranks), in rank
        order, on ``t``'s device."""
        t0 = time.perf_counter()
        wire = self._wire(t)
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire, group=self.group)
        out = [p.to(t.device) for p in parts]
        self._count(t0, wire.numel() * wire.element_size() * self.world)
        return out

    def sum_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """``t_0 + t_1 + ...`` over the ranks, left to right: the same
        bits on every rank."""
        parts = self.all_gather(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def exchange(self, sends: dict[int, torch.Tensor], recv_like: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        """Point to point: ``sends[peer]`` to each peer rank, and from each
        peer of ``recv_like`` a tensor shaped like its entry; returns the
        received tensors on ``device``. Every send must meet the peer's
        receive in the same call there."""
        t0 = time.perf_counter()
        ops, received, n_bytes = [], {}, 0
        for peer, t in sends.items():
            wire = self._wire(t)
            n_bytes += wire.numel() * wire.element_size()
            ops.append(dist.P2POp(dist.isend, wire, dist.get_global_rank(self.group, peer), self.group))
        for peer, like in recv_like.items():
            buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if self.host_staged else like.device)
            n_bytes += buf.numel() * buf.element_size()
            received[peer] = buf
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, peer), self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = {peer: buf.to(self.device) for peer, buf in received.items()}
        self._count(t0, n_bytes)
        return out


def process_span(group: Any, device: torch.device) -> ProcessSpan:
    """The :class:`ProcessSpan` of ``group`` (a process group, or
    :data:`WORLD` for the default one) for this process on ``device``.
    Raises where no process group is up: a mesh that spans processes
    never falls back to one."""
    if not _group_up():
        raise RuntimeError(
            "a mesh that spans processes needs an initialized process group: call "
            "parallel.multihost.initialize_if_needed first"
        )
    pg = dist.group.WORLD if group == WORLD else group
    return ProcessSpan(pg, dist.get_rank(pg), dist.get_world_size(pg), str(dist.get_backend(pg)), device)


class _RankSum(torch.autograd.Function):
    """The sum over ranks of a tensor every rank contributes to and every
    rank then uses (BatchNorm's moments): forward and backward both add
    the ranks' parts in rank order, the backward's being each rank's
    cotangent of the sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, span: ProcessSpan) -> torch.Tensor:
        ctx.span = span
        return span.sum_in_rank_order(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.span.sum_in_rank_order(g), None


def rank_sum(span: ProcessSpan, t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks in rank order, whose
    gradient gathers the cotangent each rank's own use of the sum gives."""
    return _RankSum.apply(t, span)


def rank_total(span: ProcessSpan, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks in rank order where every rank then
    computes the same value from it (the loss): this rank's ``t`` carries
    the gradient, the others' parts are constants."""
    parts = span.all_gather(t.detach())
    parts[span.rank] = t
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total
