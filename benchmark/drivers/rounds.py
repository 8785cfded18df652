"""Whole federated rounds of the slot plane, driven by its own driver.

The round is ``parallel.fedavg_mesh.round_from_config`` of the
configuration's ``fed`` block, driven by
``parallel.driver.run_mesh_federation`` with overlapped staging, from a
global drawn from the seed. Round r's data is ``clients x steps x batch``
rows of a pool of (image, mask) pairs made in set-up from the seed: the
pool in a seeded order cut into round-sized slabs, taken in turn, so
that the rounds of one pass over the pool use rows that all differ.

Set-up runs the first ``check_rounds`` rounds through the same call and
feed as the window, and keeps each round's global and client losses: the
reference follows them after the window. The window continues the same
round object from there and ends on the round that is running when the
time is up.

Traffic parameters: ``pool``, ``steps``, ``check_rounds``,
``profile_rounds``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import trace
from benchmark.drivers.serving import sub_seed, widths
from benchmark.inputs.images import crack_images
from benchmark.inputs.weights import draw_variables
from benchmark.reference import fed as ref_fed
from benchmark.reference import resunet

# The gradient under which a leaf counts as untrained: a thousandth of the
# median leaf's (a conv bias before a batch-statistics BatchNorm).
UNTRAINED = 1e-3


class _WindowClosed(Exception):
    pass


def _fed_config(ctx):
    from fedcrack_tpu_torch.configs import FedConfig

    return FedConfig.from_dict(ctx.config["fed"])


def _shape(ctx) -> tuple[int, int, int, int]:
    fed = ctx.config["fed"]
    return fed["mesh_clients"], ctx.traffic["steps"], fed["data"]["batch_size"], fed["model"]["img_size"]


def _data_fn(ctx, images: np.ndarray, masks: np.ndarray):
    """Round r's data: slab ``r % k`` of the pool's ``k`` round-sized
    slabs, cut from one seeded permutation of the pool and laid out in
    set-up, so that feeding a round costs the host no copy."""
    c, steps, b, s = _shape(ctx)
    per_round = c * steps * b
    perm = np.random.default_rng([ctx.seed % (1 << 63), 5]).permutation(images.shape[0])
    slabs = []
    for k in range(images.shape[0] // per_round):
        rows = np.sort(perm[k * per_round:(k + 1) * per_round])
        slabs.append((np.ascontiguousarray(images[rows].reshape(c, steps, b, s, s, 3)),
                      np.ascontiguousarray(masks[rows].reshape(c, steps, b, s, s, 1))))
    n_samples = np.full(c, steps * b, np.float32)
    active = np.ones(c, np.float32)

    def data_fn(r):
        images_r, masks_r = slabs[r % len(slabs)]
        return images_r, masks_r, active, n_samples

    return data_fn


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _first_gradients(clients: int):
    """A hook on every optimizer's step that keeps, for the first
    ``clients`` optimizers to take a first step, the gradient as Adam got
    it: its first moment after one step over ``1 - beta1``, one tensor a
    parameter in the optimizer's order."""
    kept: list = []

    def hook(optimizer, args, kwargs):
        if len(kept) >= clients:
            return
        group = optimizer.param_groups[0]
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if not params or float(optimizer.state[params[0]].get("step", 0)) != 1.0:
            return
        beta1 = group["betas"][0]
        kept.append([optimizer.state[p]["exp_avg"].detach() / (1.0 - beta1) for p in params])

    return kept, register_optimizer_step_post_hook(hook)


def setup(ctx) -> dict:
    from fedcrack_tpu_torch.parallel import driver, fedavg_mesh

    fed = _fed_config(ctx)
    mesh, round_fn = fedavg_mesh.round_from_config(fed, device=ctx.device)
    c, steps, b, s = _shape(ctx)
    imgs, msks = crack_images(ctx.traffic["pool"], s, s, sub_seed(ctx.seed, 300), ctx.device)
    images, masks = imgs.cpu().numpy(), msks.cpu().numpy()
    del imgs, msks
    global0 = draw_variables(ctx.seed, widths({"model": ctx.config["fed"]["model"]}), ctx.device)
    data_fn = _data_fn(ctx, images, masks)
    globals_, losses = [_clone(global0)], []

    def keep(record, variables):
        globals_.append(_clone(variables))
        losses.append(np.asarray(record.metrics["loss"], np.float64))

    grads, handle = _first_gradients(c)
    try:
        variables, _ = driver.run_mesh_federation(
            round_fn, global0, data_fn, ctx.traffic["check_rounds"], mesh, overlap_staging=True,
            segment_overlap=fed.segment_overlap, data_placement=fed.data_placement, on_round=keep)
    finally:
        handle.remove()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"round_fn": round_fn, "mesh": mesh, "fed": fed, "variables": variables, "data_fn": data_fn,
            "next_round": ctx.traffic["check_rounds"], "globals": globals_, "losses": losses, "grads": grads,
            "images_per_round": c * steps * b, "steps_per_round": c * steps}


def _drive(ctx, state, n_rounds: int | None, stop_at: float | None) -> list[float]:
    """Rounds from ``state["next_round"]`` on: ``n_rounds`` of them, or as
    many as end by ``stop_at`` and the one running then. Returns each
    round's end time."""
    from fedcrack_tpu_torch.parallel import driver

    ends: list[float] = []
    start = state["next_round"]

    def on_round(record, variables):
        ends.append(time.perf_counter())
        state["variables"] = variables
        if stop_at is not None and ends[-1] >= stop_at:
            raise _WindowClosed

    fed = state["fed"]
    total = start + (n_rounds if n_rounds is not None else 1 << 30)
    try:
        driver.run_mesh_federation(state["round_fn"], state["variables"], state["data_fn"], total, state["mesh"],
                                   overlap_staging=True, segment_overlap=fed.segment_overlap,
                                   data_placement=fed.data_placement, on_round=on_round, start_round=start)
    except _WindowClosed:
        pass
    state["next_round"] = start + len(ends)
    return ends


def window(ctx, state, seconds: float, observe: bool) -> dict:
    t0 = time.perf_counter()
    ends = _drive(ctx, state, None, t0 + seconds)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    per = state["images_per_round"]
    records = [{"start": a, "end": b, "images": per, "steps": state["steps_per_round"]}
               for a, b in zip([t0] + ends[:-1], ends)]
    return {"requests": records, "attempted": len(ends), "failed": 0, "window_s": ends[-1] - t0}


def profile(ctx, state, attempts: int = 4) -> dict:
    from fedcrack_tpu_torch.ops import bce

    n = ctx.traffic["profile_rounds"]
    for _ in range(attempts):
        before = bce.bce_sums.launches
        with trace.profiled() as holder:
            _drive(ctx, state, n, None)
        launched = bce.bce_sums.launches - before
        t = holder.trace
        if t is not None and t.count_matching("bce_sums_kernel") == launched:
            t.gaps = trace.host_named_gaps(lambda: _drive(ctx, state, n, None))
            return {"trace": t, "steps": n * state["steps_per_round"], "rounds": n}
        kept = "no window" if t is None else t.count_matching("bce_sums_kernel")
        print(f"profiled window kept {kept} of {launched} bce_sums launches; retaking it", file=sys.stderr)
    raise RuntimeError("the profiler lost kernel records in every retake of the sub-window")


def release(state) -> None:
    for key in ("round_fn", "mesh", "variables"):
        state.pop(key, None)


def _norms(tree: dict, base: dict) -> dict:
    out = {}
    for path, v in ref_fed._leaves(tree):
        out[path] = float(torch.linalg.vector_norm(v.to(torch.float64) - resunet.get(base, path).to(
            torch.float64)))
    return out


def _gap(prog: dict, ref: dict, leaves: list) -> float:
    """The worst leaf's gap between the two norms, against the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[p] for p in leaves]))
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in leaves)


def _grad_norms(grads: list, paths: list) -> dict:
    """Per-leaf norms of the port's first gradients, given in its
    optimizer's parameter order, which is the tree's."""
    if len(grads) != len(paths):
        raise RuntimeError(f"the port's optimizer holds {len(grads)} parameters, the tree {len(paths)}")
    return {p: float(torch.linalg.vector_norm(g.to(torch.float64))) for p, g in zip(paths, grads)}


def compare(ctx, state, control: bool = False) -> list:
    """The checked rounds against the reference's:

    - ``loss_gap``: the first round's client losses (each the mean of the
      client's steps), the largest relative gap;
    - ``grad1_gap``: each client's first gradient in the first round as
      Adam got it (the port's, read from its state after one step), the
      worst leaf's gap between the two norms over the clients;
    - ``change<n>_gap``: the change of the global after the checked
      rounds, the worst leaf's gap between the two norms.

    A gap of norms is taken against the larger of the reference's norm of
    that leaf and of the median leaf. Parameters whose reference gradient
    is under a thousandth of the median leaf's (a conv bias before a
    batch-statistics BatchNorm) are left out of both. With ``control``,
    the reference computed in TF32 stands in the program's place."""
    from benchmark.harness import Check

    n = ctx.traffic["check_rounds"]
    lr = ctx.config["fed"]["learning_rate"]
    g0 = state["globals"][0]
    ref_globals, ref_losses, ref_grads = [g0], [], None
    ctl_globals, ctl_losses, ctl_grads = [g0], [], None
    for r in range(n):
        images, masks, _, n_samples = state["data_fn"](r)
        images, masks = torch.from_numpy(images).to(ctx.device), torch.from_numpy(masks).to(ctx.device)
        g, losses, grads = ref_fed.fedavg_round(ref_globals[-1], images, masks, n_samples, lr)
        ref_globals.append(g)
        ref_losses.append(np.mean(losses, axis=1))
        ref_grads = grads if ref_grads is None else ref_grads
        if control:
            g, losses, grads = ref_fed.fedavg_round(ctl_globals[-1], images, masks, n_samples, lr, tf32=True)
            ctl_globals.append(g)
            ctl_losses.append(np.mean(losses, axis=1))
            ctl_grads = grads if ctl_grads is None else ctl_grads
    paths = [p for p, _ in ref_fed._leaves(g0["params"])]
    ref_gnorms = [{p: float(torch.linalg.vector_norm(g[p].to(torch.float64))) for p in paths} for g in ref_grads]
    if control:
        prog_globals, prog_losses = ctl_globals, ctl_losses
        prog_gnorms = [{p: float(torch.linalg.vector_norm(g[p].to(torch.float64))) for p in paths}
                       for g in ctl_grads]
    else:
        prog_globals, prog_losses = state["globals"], state["losses"]
        prog_gnorms = [_grad_norms(g, paths) for g in state["grads"]]
    if len(prog_gnorms) != len(ref_gnorms):
        raise RuntimeError(f"{len(prog_gnorms)} first gradients read from the port, {len(ref_gnorms)} clients")
    floor = UNTRAINED * float(np.median(list(ref_gnorms[0].values())))
    trained = [p for p in paths if ref_gnorms[0][p] >= floor]
    leaves = [("params",) + p for p in trained] + [p for p, _ in ref_fed._leaves(g0) if p[0] == "batch_stats"]
    loss_gap = float(np.max(np.abs(np.asarray(prog_losses[0]) - ref_losses[0]) / np.abs(ref_losses[0])))
    grad_gap = max(_gap(pg, rg, trained) for pg, rg in zip(prog_gnorms, ref_gnorms))
    lim = ctx.limits
    return [
        Check("loss_gap", loss_gap, lim["loss_gap"]),
        Check("grad1_gap", grad_gap, lim["grad1_gap"]),
        Check(f"change{n}_gap", _gap(_norms(prog_globals[n], g0), _norms(ref_globals[n], g0), leaves),
              lim[f"change{n}_gap"]),
    ]
