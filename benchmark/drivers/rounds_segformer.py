"""Whole federated rounds of SegFormer on the slot plane.

The rounds driver (``benchmark/drivers/rounds.py``) with SegFormer's
global and reference: the round is ``parallel.fedavg_mesh.
round_from_config`` of the configuration's ``fed`` block (``model_type``
``segformer``), driven by ``parallel.driver.run_mesh_federation`` with
overlapped staging, from a global drawn from the seed
(``benchmark/inputs/segformer_weights.py``); round r's data is slab ``r %
k`` of the seeded pool cut into round-sized slabs. Set-up runs the first
``check_rounds`` rounds through the same call and feed as the window and
keeps each round's global, client losses and first gradients; the
window, the profiled sub-window (with its ``bce_sums`` record check) and
the release are ``rounds.py``'s.

Traffic parameters: ``pool``, ``steps``, ``check_rounds``,
``profile_rounds``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import rounds
from benchmark.drivers.rounds import _clone, _data_fn, _fed_config, _first_gradients, _gap, _grad_norms, _norms, _shape
from benchmark.drivers.serving import sub_seed
from benchmark.inputs.images import crack_images
from benchmark.inputs.segformer_weights import draw_variables
from benchmark.reference import fed_segformer
from benchmark.reference.fed import _leaves

window, profile, release = rounds.window, rounds.profile, rounds.release

# Pool images made on the card at a time: a 1024 x 1024 image's generator
# temporaries are ~40 MB.
POOL_CHUNK = 32


def _pool(ctx, n: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """The seeded pool on the host, made on the device in chunks of
    ``POOL_CHUNK`` images, each chunk from its own sub-seed."""
    images, masks = [], []
    for lo in range(0, n, POOL_CHUNK):
        imgs, msks = crack_images(min(POOL_CHUNK, n - lo), size, size, sub_seed(ctx.seed, 300 + lo), ctx.device)
        images.append(imgs.cpu().numpy())
        masks.append(msks.cpu().numpy())
    return np.concatenate(images), np.concatenate(masks)


def setup(ctx) -> dict:
    # The program's model first: a tree without SegFormer stops here.
    from fedcrack_tpu_torch.models.segformer import SegFormer  # noqa: F401
    from fedcrack_tpu_torch.parallel import driver, fedavg_mesh

    fed = _fed_config(ctx)
    mesh, round_fn = fedavg_mesh.round_from_config(fed, device=ctx.device)
    c, steps, b, s = _shape(ctx)
    images, masks = _pool(ctx, ctx.traffic["pool"], s)
    global0 = draw_variables(ctx.seed, ctx.config["fed"]["model"], ctx.device)
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


def _grad_norm_dicts(grads: list, paths: list) -> list:
    return [{p: float(torch.linalg.vector_norm(g[p].to(torch.float64))) for p in paths} for g in grads]


def compare(ctx, state, control: bool = False) -> list:
    """The checked rounds against the reference's
    (``benchmark/reference/fed_segformer.py``), as ``rounds.compare``
    defines them: ``loss_gap`` (the first round's client losses, the
    largest relative gap), ``grad1_gap`` (each client's first gradient as
    Adam got it, the worst leaf's gap between the two norms over the
    clients) and ``change<n>_gap`` (the global's change after the checked
    rounds, the worst leaf's gap between the two norms); a gap of norms
    taken against the larger of the reference's norm of that leaf and of
    the median leaf's, leaves whose reference gradient is under a
    thousandth of the median leaf's left out. With ``control``, the
    reference computed in TF32 stands in the program's place."""
    from benchmark.harness import Check

    n = ctx.traffic["check_rounds"]
    lr = ctx.config["fed"]["learning_rate"]
    heads = tuple(ctx.config["fed"]["model"]["num_heads"])
    g0 = state["globals"][0]
    paths = [p for p, _ in _leaves(g0["params"])]
    sides = {"ref": False, "ctl": True} if control else {"ref": False}
    out = {}
    for side, tf32 in sides.items():
        globals_, losses, gnorms = [g0], [], None
        for r in range(n):
            images, masks, _, n_samples = state["data_fn"](r)
            images, masks = torch.from_numpy(images).to(ctx.device), torch.from_numpy(masks).to(ctx.device)
            g, client_losses, grads = fed_segformer.fedavg_round(globals_[-1], images, masks, n_samples, lr, heads,
                                                                 tf32=tf32)
            globals_.append(g)
            losses.append(np.mean(client_losses, axis=1))
            gnorms = _grad_norm_dicts(grads, paths) if gnorms is None else gnorms
            del grads
        out[side] = (globals_, losses, gnorms)
    ref_globals, ref_losses, ref_gnorms = out["ref"]
    if control:
        prog_globals, prog_losses, prog_gnorms = out["ctl"]
    else:
        prog_globals, prog_losses = state["globals"], state["losses"]
        prog_gnorms = [_grad_norms(g, paths) for g in state["grads"]]
    if len(prog_gnorms) != len(ref_gnorms):
        raise RuntimeError(f"{len(prog_gnorms)} first gradients read from the port, {len(ref_gnorms)} clients")
    floor = rounds.UNTRAINED * float(np.median(list(ref_gnorms[0].values())))
    trained = [p for p in paths if ref_gnorms[0][p] >= floor]
    leaves = [("params",) + p for p in trained] + [p for p, _ in _leaves(g0) if p[0] == "batch_stats"]
    loss_gap = float(np.max(np.abs(np.asarray(prog_losses[0]) - ref_losses[0]) / np.abs(ref_losses[0])))
    grad_gap = max(_gap(pg, rg, trained) for pg, rg in zip(prog_gnorms, ref_gnorms))
    lim = ctx.limits
    return [
        Check("loss_gap", loss_gap, lim["loss_gap"]),
        Check("grad1_gap", grad_gap, lim["grad1_gap"]),
        Check(f"change{n}_gap", _gap(_norms(prog_globals[n], g0), _norms(ref_globals[n], g0), leaves),
              lim[f"change{n}_gap"]),
    ]
