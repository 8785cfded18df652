"""The multi-round driver of the slot plane, with double-buffered staging.

The counterpart of ``fedcrack_tpu.parallel.driver``. A round program
(``parallel.fedavg_mesh``) takes its clients' data already on the device;
this loop makes a federation of it: stage round r's data, run the round,
and while the device works, produce and stage round r+1's data, so the
copy rides under the round instead of adding to it.

- **Staging** (:func:`stage_round_data`): on CUDA each array is copied
  from pinned host memory on a side stream and waited for before it is
  handed over; the tensor is marked as used by the current stream, so the
  caching allocator cannot hand its memory out while a round still reads
  it. The round's kernels are queued on the current stream as the host
  issues them, so a copy issued while they run overlaps them. Overlapped
  staging gives the same weights as sequential staging, bit for bit:
  staging moves bytes and changes no value.
- **Monolithic** rounds stage at round grain; **segmented** rounds
  (``SegmentedRound``) stream the next round's slab one step-range chunk
  per segment (``segment_overlap``), and ``round_overlap`` issues round
  r+1's first segment before the host reads round r's metrics.
- **Resident** data (``data_placement="resident"``) stages a
  ``data.pipeline.SamplePool`` once and only the gather plan per round;
  an HBM guard (:func:`resident_pool_fits`) falls back to the streamed
  round over slabs assembled from the same pool and plan.
- **Retries** (``max_round_retries``): an attempt that raises or returns
  non-finite weights or metrics is rolled back (the checkpoint, else a
  host snapshot of the weights, and the round's ``codec_state``) and
  replayed on the same data, re-staged bit for bit: the recovered
  trajectory equals an unfaulted one. ``fault_injector`` is the chaos
  hook (``chaos.inject.MeshChaos``).
- **Checkpoints**: a ``ckpt.manager.FedCheckpointer`` saves the global
  and the history at every round boundary; a resumed session passes the
  restored variables, ``start_round`` and ``history``.

``run_cohort_federation`` drives a ``CohortRound`` group by group, staging
group g+1 while group g runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.data.pipeline import SamplePool, _to_device_now, split_epoch_slab
from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.parallel.fedavg_mesh import CohortRound, SegmentedRound, pad_cohort_axis
from fedcrack_tpu_torch.parallel.slots import SlotMesh

SENTRY_REFUSAL = (
    "recompile_sentry watches XLA recompiles; the eager port compiles no round program, "
    "so it has none to watch (ROADMAP, not to port): pass None"
)


def _single_process(mesh: SlotMesh) -> None:
    if mesh.span is not None:
        raise ValueError(
            f"the round loop runs in one process, and this mesh spans {mesh.span.world} processes: a "
            "multi-process job drives its own loop around round_fn (parallel.multihost)"
        )


def _observe_round_record(record: "RoundRecord") -> None:
    """One RoundRecord into the metric registry and a correlation span."""
    REGISTRY.counter("driver_rounds_total", "mesh federated rounds driven to their barrier").inc()
    REGISTRY.histogram(
        "driver_round_seconds",
        "host wall clock of one driven round (dispatch to barrier)",
        buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
    ).observe(record.wall_clock_s)
    REGISTRY.counter("driver_staged_bytes_total", "host->device bytes newly staged for driven rounds").inc(
        max(0, record.staged_bytes))
    REGISTRY.gauge("driver_live_staged_bytes", "peak concurrently-staged driver bytes in the latest round").set(
        record.max_live_staged_bytes)
    if record.bytes_per_round:
        REGISTRY.counter("driver_wire_bytes_total", "modeled update wire bytes for driven rounds (codec-priced)").inc(
            record.bytes_per_round)
    with tracing.span(
        "driver.round",
        trace=f"round-{record.round_idx}",
        wall_s=round(record.wall_clock_s, 6),
        staging_s=round(record.staging_s, 6),
        staged_bytes=int(record.staged_bytes),
        retries=int(record.retries),
        data_placement=record.data_placement,
    ):
        pass


@dataclasses.dataclass
class RoundRecord:
    """One round's timing and metrics, on the host (the JAX package's
    fields). ``staging_s`` is the host-blocking staging paid for this
    round's data: the first round carries the initial staging, a
    sequential round the staging done after the previous barrier, an
    overlapped one 0.0. In overlap mode the next round's ``data_fn`` and
    staging ride inside ``wall_clock_s``."""

    round_idx: int
    metrics: dict[str, np.ndarray]
    wall_clock_s: float
    data_fn_s: float
    staging_s: float
    staged_bytes: int
    overlapped: bool
    segments: tuple = ()
    max_live_staged_bytes: int = 0
    retries: int = 0
    faults: tuple = ()
    data_placement: str = "streamed"
    bytes_per_round: int | None = None


class NonFiniteRound(RuntimeError):
    """A round produced NaN/Inf weights or metrics (checked only when
    ``max_round_retries > 0``)."""


def _tree_finite(tree: Any) -> bool:
    """One device reduction over every float leaf, one scalar read."""
    flags = [torch.isfinite(torch.as_tensor(leaf)).all() for leaf in tree_leaves(tree)
             if torch.as_tensor(leaf).is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).all())


def _device_of(mesh) -> torch.device:
    return torch.device(getattr(mesh, "device", mesh))


def stage_round_data(images: np.ndarray, masks: np.ndarray, mesh: SlotMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Put one round's ``[C, steps, B, ...]`` arrays on the device and wait
    until the bytes have landed (on CUDA: pinned memory, a side stream,
    the tensor marked for the current stream). Segment-grain staging calls
    this once per step-range chunk."""
    device = _device_of(mesh)
    return _to_device_now(images, device), _to_device_now(masks, device)


def stage_round_indices(idx: np.ndarray, mesh: SlotMesh, seg: SegmentedRound | None = None):
    """Put one round's ``[C, epochs, steps, B]`` gather plan on the device;
    for a segmented round one ``[C, segment_epochs, steps, B]`` slice per
    segment."""
    idx = np.ascontiguousarray(np.asarray(idx, np.int32))
    device = _device_of(mesh)
    if seg is None:
        return _to_device_now(idx.astype(np.int64), device)
    se = seg.segment_epochs
    return tuple(_to_device_now(np.ascontiguousarray(idx[:, k * se:(k + 1) * se]).astype(np.int64), device)
                 for k in range(seg.n_segments))


def resident_pool_fits(pool_nbytes: int, mesh: SlotMesh, *, limit_bytes: int | None = None,
                       safety: float = 0.8) -> tuple[bool, dict]:
    """The resident plane's HBM guard: does the pool fit beside the
    model, the slot carries and the activations?

    The limit comes from ``limit_bytes``, else
    ``FEDCRACK_RESIDENT_HBM_LIMIT_BYTES``, else the card's total memory
    (``torch.cuda.mem_get_info``). On the CPU nothing is discoverable and
    the guard passes. Every slot's pool lives on the one card, so the
    whole pool is charged to it. Returns ``(fits, info)``."""
    limit = limit_bytes
    if limit is None:
        env = os.environ.get("FEDCRACK_RESIDENT_HBM_LIMIT_BYTES", "")
        if env:
            limit = int(env)
    device = _device_of(mesh)
    if limit is None and device.type == "cuda":
        limit = int(torch.cuda.mem_get_info(device)[1])
    per_device = int(pool_nbytes)
    info = {"pool_bytes": int(pool_nbytes), "per_device_bytes": per_device,
            "limit_bytes": None if limit is None else int(limit), "safety": safety}
    if limit is None:
        info["reason"] = "no per-device memory limit discoverable; assuming fit"
        return True, info
    fits = per_device <= safety * limit
    info["reason"] = ("fits" if fits else
                      f"per-device pool share {per_device} B exceeds {safety:.0%} of the {int(limit)} B device limit")
    return fits, info


def _assembling_data_fn(pool: SamplePool, data_fn: Callable) -> Callable:
    """The HBM guard's fallback: a resident ``data_fn`` (``(idx, active,
    n_samples)``) as a streamed one, each slab assembled on the host from
    the pool's twin (``pool[idx]``, the device gather's data movement)."""

    def wrapped(r):
        out = data_fn(r)
        if out is None:
            return None
        idx, active, n_samples = out
        images, masks = pool.assemble_round_slab(np.asarray(idx))
        return images, masks, active, n_samples

    return wrapped


def _host_tree(tree: Any) -> Any:
    """A host (numpy) copy of a tree of tensors: bit-exact."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t), tree)


def _save_round_checkpoint(checkpointer, round_idx, variables, record, history):
    """Persist the round boundary (a deliberate barrier between rounds)."""
    from fedcrack_tpu_torch.ckpt.manager import FedCheckpoint

    history.append({
        "round": round_idx + 1,
        "wall_clock_s": round(record.wall_clock_s, 3),
        "loss_mean": float(np.mean(record.metrics["loss"])),
    })
    checkpointer.save(FedCheckpoint(current_round=round_idx + 1, model_version=round_idx + 1,
                                    variables=_host_tree(variables), history=tuple(history)))


def _run_segmented_round(seg, variables, si, sm, active, n_samples, *, data_fn, round_idx, n_rounds,
                         overlap_staging, n_chunks, mesh, acct, pipelined=None):
    """One segmented round: the segments with the next round's slab
    streaming chunk by chunk between them, then the fold."""
    out: dict = {"next_buffers": None, "next_cohort": None, "next_bytes": 0, "next_data_s": 0.0}
    timeline: list[dict] = []
    if pipelined is None:
        active, n_samples = seg.check_inputs(si, active, n_samples)
        carry = seg.init(variables)
        raw_last = None
        start_k = 0
    else:
        active, n_samples = pipelined["active"], pipelined["n_samples"]
        carry, raw_last = pipelined["carry"], pipelined["raw"]
        timeline.append(pipelined["entry"])
        start_k = 1
    pending: list = []
    did_data = False

    def _pull_next_data():
        nonlocal pending, did_data
        did_data = True
        tdd = time.perf_counter()
        nxt = data_fn(round_idx + 1)
        out["next_data_s"] = time.perf_counter() - tdd
        if nxt is not None:
            ni, nm, na, nn = nxt
            out["next_cohort"] = (na, nn)
            out["next_bytes"] = int(ni.nbytes + nm.nbytes)
            nic, nmc = split_epoch_slab(ni, nm, n_chunks)
            pending = list(zip(nic, nmc))
            out["next_buffers"] = ([], [])

    for k in range(start_k, seg.n_segments):
        td = time.perf_counter()
        carry, raw_last = seg.segment(carry, variables, si, sm)
        entry = {"segment": k, "dispatch_s": round(time.perf_counter() - td, 4)}
        if overlap_staging and round_idx + 1 < n_rounds:
            if not did_data:
                _pull_next_data()
            if pending:
                take = len(pending) if n_chunks == 1 else 1
                tss = time.perf_counter()
                nb = 0
                for ci, cm in pending[:take]:
                    s_i, s_m = stage_round_data(ci, cm, mesh)
                    out["next_buffers"][0].append(s_i)
                    out["next_buffers"][1].append(s_m)
                    nb += int(ci.nbytes + cm.nbytes)
                del pending[:take]
                acct["live"] += nb
                acct["round_max"] = max(acct["round_max"], acct["live"])
                entry["staging_s"] = round(time.perf_counter() - tss, 4)
                entry["staged_bytes"] = nb
        timeline.append(entry)
    if overlap_staging and round_idx + 1 < n_rounds and not did_data:
        _pull_next_data()
    while pending:
        ci, cm = pending.pop(0)
        tss = time.perf_counter()
        s_i, s_m = stage_round_data(ci, cm, mesh)
        out["next_buffers"][0].append(s_i)
        out["next_buffers"][1].append(s_m)
        acct["live"] += int(ci.nbytes + cm.nbytes)
        acct["round_max"] = max(acct["round_max"], acct["live"])
        timeline.append({"segment": "drain", "staging_s": round(time.perf_counter() - tss, 4),
                         "staged_bytes": int(ci.nbytes + cm.nbytes)})
    variables, metrics = seg.finalize(carry, variables, active, n_samples, raw_last)
    out["timeline"] = timeline
    out["active"], out["n_samples"] = active, n_samples
    return variables, metrics, out


def _run_segmented_round_resident(seg, variables, pool_dev, idx_parts, host_idx, active, n_samples, *, data_fn,
                                  round_idx, n_rounds, overlap_staging, mesh, acct, pipelined=None):
    """One segmented round on the resident plane: each segment gathers by
    its own plan slice; the next round's plan stages after the first."""
    out: dict = {"next_buffers": None, "next_cohort": None, "next_bytes": 0, "next_data_s": 0.0,
                 "next_host_idx": None}
    timeline: list[dict] = []
    if pipelined is None:
        active, n_samples = seg.check_inputs(pool_dev, active, n_samples, idx=host_idx)
        carry = seg.init(variables)
        raw_last = None
        start_k = 0
    else:
        active, n_samples = pipelined["active"], pipelined["n_samples"]
        carry, raw_last = pipelined["carry"], pipelined["raw"]
        timeline.append(pipelined["entry"])
        start_k = 1
    did_data = False

    def _pull_next_plan(entry=None):
        nonlocal did_data
        did_data = True
        tdd = time.perf_counter()
        nxt = data_fn(round_idx + 1)
        out["next_data_s"] = time.perf_counter() - tdd
        if nxt is not None:
            nidx, na, nn = nxt
            nidx = np.ascontiguousarray(np.asarray(nidx, np.int32))
            out["next_cohort"] = (na, nn)
            out["next_host_idx"] = nidx
            out["next_bytes"] = int(nidx.nbytes)
            tss = time.perf_counter()
            out["next_buffers"] = stage_round_indices(nidx, mesh, seg)
            acct["live"] += out["next_bytes"]
            acct["round_max"] = max(acct["round_max"], acct["live"])
            if entry is not None:
                entry["staging_s"] = round(time.perf_counter() - tss, 4)
                entry["staged_bytes"] = out["next_bytes"]

    for k in range(start_k, seg.n_segments):
        td = time.perf_counter()
        carry, raw_last = seg.segment(carry, variables, pool_dev, idx_parts[k])
        entry = {"segment": k, "dispatch_s": round(time.perf_counter() - td, 4)}
        if overlap_staging and round_idx + 1 < n_rounds and not did_data:
            _pull_next_plan(entry)
        timeline.append(entry)
    if overlap_staging and round_idx + 1 < n_rounds and not did_data:
        _pull_next_plan()
    variables, metrics = seg.finalize(carry, variables, active, n_samples, raw_last)
    out["timeline"] = timeline
    out["active"], out["n_samples"] = active, n_samples
    return variables, metrics, out


def _dispatch_pipelined_segment(seg, out_vars, resident, *, si, sm, active, n_samples, host_idx_cur, segout,
                                next_buffers, next_cohort):
    """``round_overlap``: issue the next round's init and first segment
    against this round's output before the host reads this round's
    metrics. Same operations in the same stream order: bit-identical."""
    td = time.perf_counter()
    if resident:
        if next_buffers is not None:
            idx_parts, (na, nn), host_idx = next_buffers, next_cohort, segout["next_host_idx"]
        else:
            idx_parts, na, nn, host_idx = sm, active, n_samples, host_idx_cur
        pa, pn = seg.check_inputs(si, na, nn, idx=host_idx)
        carry = seg.init(out_vars)
        carry, raw = seg.segment(carry, out_vars, si, idx_parts[0])
    else:
        if next_buffers is not None:
            nsi, nsm = tuple(next_buffers[0]), tuple(next_buffers[1])
            na, nn = next_cohort
        else:
            nsi, nsm, na, nn = si, sm, active, n_samples
        pa, pn = seg.check_inputs(nsi, na, nn)
        carry = seg.init(out_vars)
        carry, raw = seg.segment(carry, out_vars, nsi, nsm)
    return {"carry": carry, "raw": raw, "active": pa, "n_samples": pn,
            "entry": {"segment": 0, "dispatch_s": round(time.perf_counter() - td, 4), "pipelined": True}}


def _metrics_to_host(metrics: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in metrics.items()}


def run_mesh_federation(
    round_fn: Callable,
    variables: Any,
    data_fn: Callable[[int], Any],
    n_rounds: int,
    mesh: SlotMesh,
    *,
    overlap_staging: bool = True,
    segment_overlap: bool = True,
    round_overlap: bool = False,
    data_placement: str = "streamed",
    sample_pool: SamplePool | None = None,
    streamed_round_fn: Callable | None = None,
    resident_limit_bytes: int | None = None,
    on_round: Callable[[RoundRecord, Any], None] | None = None,
    checkpointer: Any | None = None,
    start_round: int = 0,
    history: Sequence[dict] = (),
    max_round_retries: int = 0,
    fault_injector: Callable[[int, int], Any] | None = None,
    recompile_sentry: Any | None = None,
) -> tuple[Any, list[RoundRecord]]:
    """Drive rounds ``start_round .. n_rounds-1`` through ``round_fn`` (a
    ``build_federated_round`` program or a ``SegmentedRound``).

    ``data_fn(r)`` returns round r's ``(images, masks, active, n_samples)``
    numpy arrays (resident: ``(idx, active, n_samples)``), or None to
    reuse round r-1's staged data; ``data_fn(start_round)`` must return
    data. The knobs are the JAX driver's: ``overlap_staging`` (stage round
    r+1 while round r runs; False stages after the barrier, bit-identical),
    ``segment_overlap`` (segmented: one chunk per segment),
    ``round_overlap`` (segmented, overlapped, no retries: issue round
    r+1's first segment before reading round r's metrics),
    ``data_placement`` with ``sample_pool`` (resident: the pool staged
    once, plans per round), ``streamed_round_fn`` with
    ``resident_limit_bytes`` (the HBM guard's fallback), ``on_round(record,
    variables)``, ``checkpointer`` with ``start_round`` and ``history``,
    ``max_round_retries`` and ``fault_injector``. ``recompile_sentry``
    takes None only. Returns the final global (tensors on the device) and
    one :class:`RoundRecord` per round run.

    One process only, as the JAX driver: a job whose mesh spans processes
    drives its own loop around ``round_fn`` (``parallel.multihost``)."""
    if recompile_sentry is not None:
        raise ValueError(SENTRY_REFUSAL)
    _single_process(mesh)
    if n_rounds <= 0:
        raise ValueError(f"n_rounds must be positive, got {n_rounds}")
    if not 0 <= start_round < n_rounds:
        raise ValueError(f"start_round={start_round} outside [0, n_rounds={n_rounds})")
    if max_round_retries < 0:
        raise ValueError(f"max_round_retries must be >= 0, got {max_round_retries}")
    if data_placement not in ("streamed", "resident"):
        raise ValueError(f"data_placement must be 'streamed' or 'resident', got {data_placement!r}")
    resident = data_placement == "resident"
    if resident:
        if sample_pool is None:
            raise ValueError("data_placement='resident' needs a sample_pool")
        if getattr(round_fn, "data_placement", "streamed") != "resident":
            raise ValueError(
                "data_placement='resident' needs a round_fn built with "
                "data_placement='resident' (the gather-assembly data contract)"
            )
        fits, guard = resident_pool_fits(sample_pool.nbytes, mesh, limit_bytes=resident_limit_bytes)
        if not fits:
            if streamed_round_fn is None:
                raise RuntimeError(
                    f"resident sample pool does not fit HBM ({guard['reason']}) "
                    "and no streamed_round_fn fallback was provided"
                )
            if getattr(streamed_round_fn, "data_placement", "streamed") != "streamed":
                raise ValueError("streamed_round_fn must be a streamed-contract round")
            round_fn = streamed_round_fn
            data_fn = _assembling_data_fn(sample_pool, data_fn)
            resident = False
    elif getattr(round_fn, "data_placement", "streamed") != "streamed":
        raise ValueError(
            "round_fn was built with data_placement='resident' but the driver "
            "was asked to run streamed — pass data_placement='resident' plus "
            "the sample_pool (mismatched contracts would feed slabs to a "
            "gather program)"
        )
    seg = round_fn if isinstance(round_fn, SegmentedRound) else None
    if round_overlap:
        if seg is None:
            raise ValueError(
                "round_overlap=True requires a SegmentedRound — the segment "
                "boundaries are the interleave points (an HBM-guard fallback "
                "to a monolithic streamed_round_fn cannot pipeline)"
            )
        if not overlap_staging:
            raise ValueError(
                "round_overlap=True requires overlap_staging=True: the next "
                "round's data must be staged before its first segment can "
                "dispatch early"
            )
        if max_round_retries > 0:
            raise ValueError(
                "round_overlap does not compose with max_round_retries: a "
                "pipelined segment dispatched against a round that later "
                "fails its finiteness check would need unwinding — run "
                "preemption tolerance without round-overlap"
            )
    hist = list(history)

    t0 = time.perf_counter()
    first = data_fn(start_round)
    data_s = time.perf_counter() - t0
    if first is None:
        raise ValueError(f"data_fn({start_round}) returned None: the first round has no data")
    n_chunks = 1
    base_bytes = 0  # the resident pool: staged once, never rotating
    host_idx_cur = None
    ts = time.perf_counter()
    if resident:
        idx0, active, n_samples = first
        host_idx_cur = np.ascontiguousarray(np.asarray(idx0, np.int32))
        si = sample_pool.stage(mesh)
        sm = stage_round_indices(host_idx_cur, mesh, seg)
        base_bytes = sample_pool.nbytes
        staged_bytes = base_bytes + int(host_idx_cur.nbytes)
        cur_bytes = int(host_idx_cur.nbytes)
    else:
        images, masks, active, n_samples = first
        if seg is not None:
            n_chunks = seg.n_segments if segment_overlap else 1
            ic, mc = split_epoch_slab(images, masks, n_chunks)
            pairs = [stage_round_data(i, m, mesh) for i, m in zip(ic, mc)]
            si, sm = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
        else:
            si, sm = stage_round_data(images, masks, mesh)
        staged_bytes = int(images.nbytes + masks.nbytes)
        cur_bytes = staged_bytes
    pending_staging_s = time.perf_counter() - ts
    acct = {"live": base_bytes + cur_bytes, "round_max": base_bytes + cur_bytes}

    records: list[RoundRecord] = []
    pipelined_state: dict | None = None
    for r in range(start_round, n_rounds):
        # Snapshot what a replay needs: the round's input weights (a host
        # copy, bit-exact) and the round program's codec state.
        snapshot = _host_tree(variables) if max_round_retries > 0 else None
        codec_snapshot = (round_fn.codec_state()
                          if max_round_retries > 0 and hasattr(round_fn, "codec_state") else None)
        attempt = 0
        round_faults: list[str] = []
        while True:
            acct["round_max"] = acct["live"]
            next_buffers = None
            next_cohort = None
            next_bytes = 0
            next_data_s = 0.0
            next_staging_s = 0.0
            next_host_idx = None
            timeline: list[dict] = []
            segout = None

            t0 = time.perf_counter()
            try:
                post = None
                if fault_injector is not None:
                    post = fault_injector(r, attempt)
                if seg is None:
                    out_vars, metrics = round_fn(variables, si, sm, active, n_samples)
                    if post is not None:
                        out_vars, metrics = post(out_vars, metrics)
                    if overlap_staging and r + 1 < n_rounds:
                        # The round's kernels are queued; the next round's
                        # data and its copy ride under them.
                        td = time.perf_counter()
                        nxt = data_fn(r + 1)
                        next_data_s = time.perf_counter() - td
                        if nxt is not None:
                            if resident:
                                nidx, na, nn = nxt
                                next_host_idx = np.ascontiguousarray(np.asarray(nidx, np.int32))
                                next_cohort = (na, nn)
                                next_bytes = int(next_host_idx.nbytes)
                                next_buffers = stage_round_indices(next_host_idx, mesh, None)
                            else:
                                ni, nm, na, nn = nxt
                                next_cohort = (na, nn)
                                next_bytes = int(ni.nbytes + nm.nbytes)
                                next_buffers = stage_round_data(ni, nm, mesh)
                            acct["live"] += next_bytes
                            acct["round_max"] = max(acct["round_max"], acct["live"])
                elif resident:
                    out_vars, metrics, segout = _run_segmented_round_resident(
                        seg, variables, si, sm, host_idx_cur, active, n_samples, data_fn=data_fn, round_idx=r,
                        n_rounds=n_rounds, overlap_staging=overlap_staging, mesh=mesh, acct=acct,
                        pipelined=pipelined_state)
                    if post is not None:
                        out_vars, metrics = post(out_vars, metrics)
                    timeline = segout["timeline"]
                    next_buffers, next_cohort = segout["next_buffers"], segout["next_cohort"]
                    next_bytes, next_data_s = segout["next_bytes"], segout["next_data_s"]
                    next_host_idx = segout["next_host_idx"]
                    active, n_samples = segout["active"], segout["n_samples"]
                else:
                    out_vars, metrics, segout = _run_segmented_round(
                        seg, variables, si, sm, active, n_samples, data_fn=data_fn, round_idx=r,
                        n_rounds=n_rounds, overlap_staging=overlap_staging, n_chunks=n_chunks, mesh=mesh,
                        acct=acct, pipelined=pipelined_state)
                    if post is not None:
                        out_vars, metrics = post(out_vars, metrics)
                    timeline = segout["timeline"]
                    next_buffers, next_cohort = segout["next_buffers"], segout["next_cohort"]
                    next_bytes, next_data_s = segout["next_bytes"], segout["next_data_s"]
                    active, n_samples = segout["active"], segout["n_samples"]

                if max_round_retries > 0 and not (_tree_finite(metrics) and _tree_finite(out_vars)):
                    raise NonFiniteRound(f"round {r} produced non-finite weights/metrics")
                pipelined_state = None
                if round_overlap and r + 1 < n_rounds:
                    pipelined_state = _dispatch_pipelined_segment(
                        seg, out_vars, resident, si=si, sm=sm, active=active, n_samples=n_samples,
                        host_idx_cur=host_idx_cur, segout=segout, next_buffers=next_buffers,
                        next_cohort=next_cohort)
                # The round barrier: the metrics depend on every step.
                metrics_host = _metrics_to_host(metrics)
                variables = out_vars
                wall = time.perf_counter() - t0
                break
            except Exception as e:
                if attempt >= max_round_retries:
                    raise
                round_faults.append(f"{type(e).__name__}: {e}")
                attempt += 1
                # Whatever of the next round landed is dropped; the retry
                # produces it again (a deterministic data_fn).
                acct["live"] = base_bytes + cur_bytes
                if resident:
                    # A real device loss takes the resident pool with it:
                    # re-stage pool and plan from the host twin, bit for bit.
                    rs = time.perf_counter()
                    si = sample_pool.stage(mesh)
                    sm = stage_round_indices(host_idx_cur, mesh, seg)
                    pending_staging_s += time.perf_counter() - rs
                restored = None
                if checkpointer is not None:
                    try:
                        ck = checkpointer.restore(template=snapshot)
                        if ck is not None and ck.current_round == r:
                            restored = ck.variables
                    except Exception:
                        restored = None
                variables = restored if restored is not None else snapshot
                if codec_snapshot is not None:
                    round_fn.set_codec_state(codec_snapshot)

        if not overlap_staging and r + 1 < n_rounds:
            # Sequential: the next round's data and staging after the
            # barrier, charged to the next round's record.
            td = time.perf_counter()
            nxt = data_fn(r + 1)
            next_data_s = time.perf_counter() - td
            if nxt is not None:
                ts = time.perf_counter()
                if resident:
                    nidx, na, nn = nxt
                    next_host_idx = np.ascontiguousarray(np.asarray(nidx, np.int32))
                    next_cohort = (na, nn)
                    next_bytes = int(next_host_idx.nbytes)
                    next_buffers = stage_round_indices(next_host_idx, mesh, seg)
                elif seg is not None:
                    ni, nm, na, nn = nxt
                    next_cohort = (na, nn)
                    next_bytes = int(ni.nbytes + nm.nbytes)
                    nic, nmc = split_epoch_slab(ni, nm, n_chunks)
                    pairs = [stage_round_data(ci, cm, mesh) for ci, cm in zip(nic, nmc)]
                    next_buffers = ([p[0] for p in pairs], [p[1] for p in pairs])
                else:
                    ni, nm, na, nn = nxt
                    next_cohort = (na, nn)
                    next_bytes = int(ni.nbytes + nm.nbytes)
                    next_buffers = stage_round_data(ni, nm, mesh)
                next_staging_s = time.perf_counter() - ts
                acct["live"] += next_bytes
                acct["round_max"] = max(acct["round_max"], acct["live"])

        wpc = getattr(round_fn, "wire_bytes_per_client", None)
        bytes_per_round = None
        if wpc:
            bytes_per_round = int(wpc) * int(np.sum(np.asarray(active, np.float32) > 0.0))
        record = RoundRecord(
            round_idx=r,
            metrics=metrics_host,
            wall_clock_s=wall,
            data_fn_s=data_s,
            staging_s=pending_staging_s,
            staged_bytes=staged_bytes,
            overlapped=overlap_staging and next_buffers is not None,
            segments=tuple(timeline),
            max_live_staged_bytes=acct["round_max"],
            retries=attempt,
            faults=tuple(round_faults),
            data_placement="resident" if resident else "streamed",
            bytes_per_round=bytes_per_round,
        )
        records.append(record)
        _observe_round_record(record)
        if on_round is not None:
            on_round(record, variables)
        if checkpointer is not None:
            _save_round_checkpoint(checkpointer, r, variables, record, hist)

        data_s = next_data_s
        pending_staging_s = next_staging_s
        if next_buffers is not None:
            # Past the barrier the old buffers are unread: drop them, so
            # peak staged memory stays near two slabs. Resident: only the
            # plan rotates.
            if resident:
                sm = next_buffers
                host_idx_cur = next_host_idx
            elif seg is not None:
                si, sm = tuple(next_buffers[0]), tuple(next_buffers[1])
            else:
                si, sm = next_buffers
            acct["live"] -= cur_bytes
            cur_bytes = next_bytes
            active, n_samples = next_cohort
            staged_bytes = next_bytes
        else:
            staged_bytes = 0

    return variables, records


def _stage_group_resident(pool_i, pool_m, idx, mesh):
    """One group's resident pool slice and its full-round plan, landed."""
    device = _device_of(mesh)
    return ((_to_device_now(pool_i, device), _to_device_now(pool_m, device)),
            _to_device_now(np.asarray(idx).astype(np.int64), device))


def _prep_cohort_round(cohort_round: CohortRound, r: int, data, sample_pool: SamplePool | None,
                       resident: bool) -> dict:
    """Validate and pad one round's cohort into staging-ready form."""
    if data is None:
        raise ValueError(f"data_fn({r}) returned None: a cohort round never reuses")
    g = cohort_round.group_size
    prep: dict = {}
    if resident:
        idx, active, n_samples = data
        idx = np.ascontiguousarray(np.asarray(idx, np.int32))
        c = idx.shape[0]
        if sample_pool.n_clients != c:
            raise ValueError(
                f"sample_pool carries {sample_pool.n_clients} clients, round {r}'s plan {c} — the pool's "
                "client axis must align with the cohort"
            )
        prep["idx"] = idx
    else:
        images, masks, active, n_samples = data
        images, masks = np.asarray(images), np.asarray(masks)
        c = images.shape[0]
        cohort_round.seg.validate_data(images)
        prep["images"], prep["masks"] = images, masks
    active = np.asarray(active, np.float32)
    n_samples = np.asarray(n_samples, np.float32)
    if active.shape[0] != c:
        raise ValueError(f"cohort data carries {c} clients, mask {active.shape[0]}")
    if float(np.sum(active * n_samples)) <= 0.0:
        raise ValueError("non-positive total FedAvg weight: every cohort client dropped")
    n_groups = cohort_round.n_groups(c)
    c_pad = n_groups * g
    prep["active"] = pad_cohort_axis(active, c_pad)
    prep["n_samples"] = pad_cohort_axis(n_samples, c_pad)
    prep["c"], prep["n_groups"] = c, n_groups
    return prep


def _stage_cohort_group(prep: dict, gi: int, g: int, mesh, sample_pool, resident: bool):
    """Stage one group's slab (or pool slice and plan), padding only the
    last group's slice of a ragged cohort."""
    c = prep["c"]
    lo, hi = gi * g, (gi + 1) * g

    def slice_pad(arr):
        part = arr[lo:min(hi, c)]
        return part if part.shape[0] == hi - lo else pad_cohort_axis(part, hi - lo)

    ts = time.perf_counter()
    if resident:
        pi, pm, ix = slice_pad(sample_pool.images), slice_pad(sample_pool.masks), slice_pad(prep["idx"])
        bufs = _stage_group_resident(pi, pm, ix, mesh)
        nbytes = int(pi.nbytes + pm.nbytes + ix.nbytes)
    else:
        gi_imgs, gi_msks = slice_pad(prep["images"]), slice_pad(prep["masks"])
        bufs = stage_round_data(np.ascontiguousarray(gi_imgs), np.ascontiguousarray(gi_msks), mesh)
        nbytes = int(gi_imgs.nbytes + gi_msks.nbytes)
    return bufs, nbytes, time.perf_counter() - ts


def run_cohort_federation(
    cohort_round: CohortRound,
    variables: Any,
    data_fn: Callable[[int], Any],
    n_rounds: int,
    mesh: SlotMesh,
    *,
    sample_pool: SamplePool | None = None,
    round_overlap: bool = False,
    on_round: Callable[[RoundRecord, Any], None] | None = None,
    recompile_sentry: Any | None = None,
) -> tuple[Any, list[RoundRecord]]:
    """Drive a cohort federation: each round's C clients run as ``ceil(C /
    G)`` groups, group g+1 staged while group g runs and group g's buffers
    dropped at its barrier. ``data_fn(r)`` returns the round's cohort
    (streamed ``(images [C, ...], masks, active, n_samples)``; resident,
    with ``sample_pool``, ``(idx [C, epochs, steps, B], active,
    n_samples)``) and never None. ``round_overlap`` issues round r+1's
    data, first group's staging and first group before reading round r's
    metrics; bit-identical. Records carry a per-group timeline. One
    process only."""
    if recompile_sentry is not None:
        raise ValueError(SENTRY_REFUSAL)
    _single_process(mesh)
    if n_rounds <= 0:
        raise ValueError(f"n_rounds must be positive, got {n_rounds}")
    resident = sample_pool is not None
    if resident and cohort_round.data_placement != "resident":
        raise ValueError(
            "sample_pool given but cohort_round was built streamed — build "
            "it with data_placement='resident' for the pool/plan contract"
        )
    if not resident and cohort_round.data_placement == "resident":
        raise ValueError("cohort_round is resident but no sample_pool was given")
    g = cohort_round.group_size
    records: list[RoundRecord] = []
    pipeline: dict | None = None

    def run_group(sums, gvars, cur, active, n_samples, lo):
        (a, b) = cur
        return cohort_round.run_group(sums, gvars, a, b, active[lo:lo + g], n_samples[lo:lo + g])

    for r in range(n_rounds):
        if pipeline is None:
            td = time.perf_counter()
            data = data_fn(r)
            data_s = time.perf_counter() - td
            prep = _prep_cohort_round(cohort_round, r, data, sample_pool, resident)
            t0 = time.perf_counter()
            cur, cur_bytes, stage_s = _stage_cohort_group(prep, 0, g, mesh, sample_pool, resident)
            sums = cohort_round.zeros(variables)
            pre_raw = pre_entry = None
        else:
            prep, data_s, t0 = pipeline["prep"], pipeline["data_s"], pipeline["t0"]
            cur, cur_bytes, stage_s = pipeline["staged"]
            sums, pre_raw, pre_entry = pipeline["sums"], pipeline["raw"], pipeline["entry"]
            pipeline = None
        active, n_samples = prep["active"], prep["n_samples"]
        n_groups = prep["n_groups"]
        raw_lasts = []
        timeline: list[dict] = []
        staged_total = 0
        staging_total = 0.0
        live = cur_bytes
        round_max = live
        for gi in range(n_groups):
            if gi == 0 and pre_raw is not None:
                raw, entry = pre_raw, pre_entry
            else:
                tdp = time.perf_counter()
                sums, raw = run_group(sums, variables, cur, active, n_samples, gi * g)
                entry = {"group": gi, "dispatch_s": round(time.perf_counter() - tdp, 4),
                         "staging_s": round(stage_s, 4), "staged_bytes": cur_bytes}
            staged_total += cur_bytes
            staging_total += stage_s
            nxt = None
            if gi + 1 < n_groups:
                nxt, nxt_bytes, stage_s = _stage_cohort_group(prep, gi + 1, g, mesh, sample_pool, resident)
                live += nxt_bytes
                round_max = max(round_max, live)
            # Group g's buffers go with this reference: the allocator
            # keeps them until the queued steps that read them are done.
            raw_lasts.append(raw)
            live -= cur_bytes
            timeline.append(entry)
            if nxt is not None:
                cur, cur_bytes = nxt, nxt_bytes
        out_vars, metrics = cohort_round.finish(sums, variables, raw_lasts, active, prep["c"])
        if round_overlap and r + 1 < n_rounds:
            td = time.perf_counter()
            data2 = data_fn(r + 1)
            data2_s = time.perf_counter() - td
            prep2 = _prep_cohort_round(cohort_round, r + 1, data2, sample_pool, resident)
            t0n = time.perf_counter()
            cur2, cur2_bytes, stage2_s = _stage_cohort_group(prep2, 0, g, mesh, sample_pool, resident)
            sums2 = cohort_round.zeros(out_vars)
            tdp = time.perf_counter()
            sums2, raw2 = run_group(sums2, out_vars, cur2, prep2["active"], prep2["n_samples"], 0)
            pipeline = {"prep": prep2, "data_s": data2_s, "t0": t0n, "staged": (cur2, cur2_bytes, stage2_s),
                        "sums": sums2, "raw": raw2,
                        "entry": {"group": 0, "dispatch_s": round(time.perf_counter() - tdp, 4),
                                  "staging_s": round(stage2_s, 4), "staged_bytes": cur2_bytes,
                                  "pipelined": True}}
        metrics_host = _metrics_to_host(metrics)
        variables = out_vars
        wall = time.perf_counter() - t0
        record = RoundRecord(
            round_idx=r, metrics=metrics_host, wall_clock_s=wall, data_fn_s=data_s, staging_s=staging_total,
            staged_bytes=staged_total, overlapped=n_groups > 1 or pre_raw is not None,
            segments=tuple(timeline), max_live_staged_bytes=round_max,
            data_placement="resident" if resident else "streamed",
        )
        records.append(record)
        _observe_round_record(record)
        if on_round is not None:
            on_round(record, variables)
    return variables, records


def shuffled_epoch_data(pool_images: np.ndarray, pool_masks: np.ndarray, steps: int, batch_size: int,
                        rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One client's reshuffled epoch in the round layout ``[1, steps, B,
    ...]``: a fresh permutation of its fixed pool per round, drawn as the
    JAX package draws it."""
    n = pool_images.shape[0]
    need = steps * batch_size
    if n < need:
        raise ValueError(f"pool has {n} samples, round needs {need}")
    idx = rng.permutation(n)[:need]
    images = np.ascontiguousarray(pool_images[idx].reshape(1, steps, batch_size, *pool_images.shape[1:]))
    masks = np.ascontiguousarray(pool_masks[idx].reshape(1, steps, batch_size, *pool_masks.shape[1:]))
    return images, masks
