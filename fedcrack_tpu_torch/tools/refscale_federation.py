"""The reference's whole federation at reference scale, on one device.

``python -m fedcrack_tpu_torch.tools.refscale_federation --out F.json``

The counterpart of ``fedcrack_tpu.tools.refscale_federation``. The
reference runs N registered clients for 5 rounds; each round every client
fits 10 local epochs of ~388 steps of batch 16 at 128 px over its own
6,213-sample shard, and the server averages the N uploads. This tool runs
that federation on one card:

- ``--clients`` clients, each with its own fixed pool of ``--samples``
  synthetic images (distinct seeds, distinct shards), reshuffled every
  round (``parallel.shuffled_epoch_data``, or a ``SamplePool`` gather plan
  with ``--data-placement resident``);
- each client's full local fit runs as one one-slot round
  (``parallel.build_federated_round``, or its segmented form with
  ``--segments``), serially on the device, every fit from the round's
  global;
- sample-weighted FedAvg over the N fits (``fed.algorithms.fedavg``), or a
  FedOpt server step, with each client's update norm and the distance
  between consecutive clients' fits recorded;
- uint8 staging, double-buffered: the next fit's epoch is shuffled and
  staged while the current fit's kernels run (``parallel.stage_round_data``);
- a held-out eval of each round's global after BatchNorm recalibration,
  over batches staged on the device once.

It writes every key of the JAX tool's artifact. A scaled-down run:

    python -m fedcrack_tpu_torch.tools.refscale_federation --clients 2 --rounds 2 \\
        --epochs 1 --samples 64 --img 32 --eval-samples 16 --out /tmp/smoke.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _now() -> float:
    return time.perf_counter()


def _params_l2_diff(a, b) -> float:
    """||params_a - params_b||_2 summed on the device, one scalar read."""
    import torch

    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))

    total = None
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        x = tensor(x).to(torch.float32)
        y = tensor(y).to(device=x.device, dtype=torch.float32)
        sq = torch.sum((x - y) ** 2)
        total = sq if total is None else total + sq
    return float(np.sqrt(float(total)))


def _host(tree):
    import torch

    from fedcrack_tpu_torch.fed.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def run_refscale_federation(args, device=None) -> dict:
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset, SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.algorithms import apply_server_opt, fedavg, make_server_optimizer
    from fedcrack_tpu_torch.parallel import (
        build_federated_round,
        build_federated_round_segments,
        make_mesh,
        resident_pool_fits,
        shuffled_epoch_data,
        stage_round_data,
        stage_round_indices,
    )
    from fedcrack_tpu_torch.train.local import create_train_state, evaluate, recalibrate_batch_stats

    config = ModelConfig(img_size=args.img, compute_dtype=args.dtype)
    steps = args.samples // args.batch
    if steps < 1:
        raise SystemExit(f"--samples {args.samples} < --batch {args.batch}")
    if args.clients < 1:
        raise SystemExit(f"--clients {args.clients} < 1")
    segments = int(getattr(args, "segments", 0) or 0)
    placement = getattr(args, "data_placement", "streamed") or "streamed"
    if placement not in ("streamed", "resident"):
        raise SystemExit(f"--data-placement must be streamed|resident, got {placement!r}")
    ckpt_dir = getattr(args, "ckpt_dir", "") or ""
    resume = bool(getattr(args, "resume", False))
    if resume and not ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")

    mesh = make_mesh(1, 1, device=device)
    dev = mesh.device

    # Each client's fixed shard: args.samples unique images under a
    # client-distinct seed, in uint8 transport encoding.
    t0 = _now()
    pools = []
    for c in range(args.clients):
        pf, pm = synth_crack_batch(args.samples, args.img, seed=args.seed + c * 104729)
        pools.append(to_uint8_transport(pf, pm))
        del pf, pm
    ev_images, ev_masks = synth_crack_batch(args.eval_samples, args.img, seed=args.seed + 7919)
    synth_s = _now() - t0
    eval_ds = ArrayDataset(ev_images, ev_masks, batch_size=args.batch, shuffle=False, drop_last=False)

    # The held-out eval batches live on the device for the session, staged
    # once and charged to the first round's eval_stage_s.
    t0 = _now()
    eval_batches = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in b) for b in eval_ds]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pending_eval_stage_s = _now() - t0
    eval_staged_bytes = int(ev_images.nbytes + ev_masks.nbytes)

    # Resident plane: every client's pool stays on the device for the
    # session (all share the card, so the guard prices the sum); per fit
    # only the gather plan ships.
    resident = placement == "resident"
    placement_guard = None
    sample_pools = staged_pools = None
    pool_stage_s = 0.0
    if resident:
        sample_pools = [SamplePool(pu[None], pmu[None]) for pu, pmu in pools]
        fits, placement_guard = resident_pool_fits(sum(p.nbytes for p in sample_pools), mesh)
        if fits:
            t0 = _now()
            staged_pools = [p.stage(mesh) for p in sample_pools]
            pool_stage_s = _now() - t0
        else:
            resident = False
            placement = "streamed"

    kind = "resident" if resident else "streamed"
    if segments:
        round_fn = build_federated_round_segments(mesh, config, learning_rate=args.lr, local_epochs=args.epochs,
                                                  pos_weight=args.pos_weight, segments=segments,
                                                  data_placement=kind)
    else:
        round_fn = build_federated_round(mesh, config, learning_rate=args.lr, local_epochs=args.epochs,
                                         pos_weight=args.pos_weight, data_placement=kind)
    state_tmpl = create_train_state(torch.Generator().manual_seed(args.seed), config, args.lr, device=dev)
    rngs = [np.random.default_rng(args.seed + 31 * c) for c in range(args.clients)]
    active = np.ones(1, np.float32)
    n_samples = np.full(1, float(steps * args.batch), np.float32)
    fit_weight = float(steps * args.batch)

    server_kind = getattr(args, "server_optimizer", "fedavg")
    server_tx = make_server_optimizer(server_kind, float(getattr(args, "server_lr", 1.0)),
                                      float(getattr(args, "server_momentum", 0.9)))

    def epoch_for(c: int):
        """One fit's data draw: one ``rng.permutation(samples)`` per call
        in either placement, so the trajectory does not depend on it."""
        if resident:
            return sample_pools[c].round_indices([rngs[c]], args.epochs, steps, args.batch)
        return shuffled_epoch_data(pools[c][0], pools[c][1], steps, args.batch, rngs[c])

    def stage_for(c: int, epoch_data):
        """Stage one fit's data: ``(round_fn data arguments, bytes)``."""
        if resident:
            return (staged_pools[c], stage_round_indices(epoch_data, mesh)), int(epoch_data.nbytes)
        imgs, msks = epoch_data
        return stage_round_data(imgs, msks, mesh), int(imgs.nbytes + msks.nbytes)

    global_vars = state_tmpl.variables
    server_opt_state = server_tx.init(global_vars["params"]) if server_tx is not None else None
    rounds_out = []
    start_round = 0
    ckptr = None
    if ckpt_dir:
        from fedcrack_tpu_torch.ckpt.manager import FedCheckpoint, FedCheckpointer

        ckptr = FedCheckpointer(ckpt_dir)
        if resume:
            ckpt = ckptr.restore()
            if ckpt is None:
                raise SystemExit(f"--resume: no checkpoint under {ckpt_dir!r}")
            start_round = int(ckpt.current_round)
            if start_round >= args.rounds:
                raise SystemExit(f"--resume: checkpoint already at round {start_round} >= --rounds {args.rounds}")
            global_vars = ckpt.variables
            rounds_out = [dict(h) for h in ckpt.history]
            if server_tx is not None:
                restored_opt = ckptr.restore_opt_state(server_tx.init(global_vars["params"]))
                if restored_opt is not None:
                    server_opt_state = restored_opt
            # Each client's rng drew one permutation per completed round.
            for rng in rngs:
                for _ in range(start_round):
                    rng.permutation(args.samples)

    schedule = [(r, c) for r in range(start_round, args.rounds) for c in range(args.clients)]
    t0 = _now()
    epoch0 = epoch_for(schedule[0][1])
    shuffle_s = _now() - t0
    staged, staged_bytes = stage_for(schedule[0][1], epoch0)

    client_vars: list = []
    fit_walls: list[float] = []
    round_t0 = _now()
    round_fits: list[dict] = []

    session_t0 = _now()
    for k, (r, c) in enumerate(schedule):
        fit_t0 = _now()
        new_vars, metrics = round_fn(global_vars, *staged, active, n_samples)

        # Double buffer: the fit's kernels are queued; the next fit's
        # shuffle and staging ride under them.
        staged_next = None
        next_shuffle_s = 0.0
        next_bytes = 0
        if k + 1 < len(schedule):
            td = _now()
            nxt_epoch = epoch_for(schedule[k + 1][1])
            next_shuffle_s = _now() - td
            staged_next, next_bytes = stage_for(schedule[k + 1][1], nxt_epoch)

        # The fit's barrier: its metrics depend on every step.
        train = {key: round(float(v.detach().cpu()[0]), 4) for key, v in metrics.items()}
        fit_wall = _now() - fit_t0
        fit_walls.append(fit_wall)
        client_vars.append(new_vars)
        round_fits.append({
            "client": c,
            "wall_clock_s": round(fit_wall, 3),
            "shuffle_s": round(shuffle_s, 3),
            "staged_bytes": staged_bytes,
            "overlapped_next_fit_staging": staged_next is not None,
            "train_last_epoch": train,
        })
        staged = staged_next
        shuffle_s = next_shuffle_s
        staged_bytes = next_bytes

        if c == args.clients - 1:
            agg_t0 = _now()
            update_l2 = [round(_params_l2_diff(cv, global_vars), 4) for cv in client_vars]
            divergence_l2 = ([round(_params_l2_diff(client_vars[i], client_vars[i + 1]), 4)
                              for i in range(len(client_vars) - 1)] if len(client_vars) > 1 else [])
            if len(client_vars) > 1:
                averaged = fedavg(client_vars, weights=[fit_weight] * len(client_vars))
            else:
                averaged = client_vars[0]
            if server_tx is not None:
                # FedOpt: the pseudo-gradient global - average, stepped by
                # the server optimizer on the host; BatchNorm statistics
                # plain-averaged.
                new_params, server_opt_state = apply_server_opt(
                    _host(global_vars["params"]), _host(averaged["params"]), server_tx, server_opt_state)
                new_global = {"params": new_params, "batch_stats": averaged["batch_stats"]}
            else:
                new_global = averaged
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            agg_s = _now() - agg_t0
            global_vars = new_global
            client_vars = []

            ev_t0 = _now()
            st = state_tmpl.replace_variables(global_vars)
            st = recalibrate_batch_stats(st, eval_batches)
            m = evaluate(st, eval_batches, pos_weight=args.pos_weight)
            eval_s = _now() - ev_t0
            eval_stage_s, pending_eval_stage_s = pending_eval_stage_s, 0.0

            rounds_out.append({
                "round": r + 1,
                "wall_clock_s": round(_now() - round_t0 - eval_s, 3),
                "fits": round_fits,
                "aggregation_s": round(agg_s, 3),
                "update_l2": update_l2,
                "client_divergence_l2": divergence_l2,
                "eval": {key: round(float(v), 4) for key, v in m.items()},
                "eval_s": round(eval_s, 2),
                "eval_stage_s": round(eval_stage_s, 6),
            })
            print(json.dumps(rounds_out[-1]), flush=True)
            if ckptr is not None:
                ckptr.save(FedCheckpoint(current_round=r + 1, model_version=r + 1, variables=_host(global_vars),
                                         history=tuple(rounds_out), server_opt_state=server_opt_state))
            round_fits = []
            round_t0 = _now()
    session_s = _now() - session_t0

    walls = [r["wall_clock_s"] for r in rounds_out]
    post_compile = walls[1:] if len(walls) > 1 else walls
    fit_post_compile = fit_walls[1:] if len(fit_walls) > 1 else fit_walls
    ious = [r["eval"]["iou"] for r in rounds_out]
    losses = [r["eval"]["loss"] for r in rounds_out]
    return {
        "generated_by": "fedcrack_tpu_torch.tools.refscale_federation",
        "hardware": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
        "workload": {
            "clients": args.clients,
            "rounds": args.rounds,
            "local_epochs": args.epochs,
            "steps_per_epoch": steps,
            "batch": args.batch,
            "img_size": args.img,
            "unique_samples_per_client": args.samples,
            "compute_dtype": args.dtype,
            "pos_weight": args.pos_weight,
            "learning_rate": args.lr,
            "eval_samples": args.eval_samples,
            "segments": segments,
            "server_optimizer": server_kind,
            "data_placement": placement,
            "placement_guard": placement_guard,
            "reference_parity": (
                "N-client cohort + round barrier + average "
                "(fl_server.py:59,116-117,92-102); 5 rounds (fl_server.py:18) "
                "x 10 epochs x 388 steps of batch 16 at 128 px over 6213 "
                "samples per client (client_fit_model.py:166,76,55-56); "
                "clients time-multiplexed serially on one device"
            ),
        },
        "rounds": rounds_out,
        "resumed_from": start_round,
        "summary": {
            "session_wall_clock_s": round(session_s, 2),
            "synthesis_s": round(synth_s, 2),
            "eval_staged_bytes": eval_staged_bytes,
            "pool_bytes_total": sum(p.nbytes for p in sample_pools) if resident else None,
            "pool_stage_s": round(pool_stage_s, 3) if resident else None,
            "round_wall_clock_s_median_post_compile": round(float(np.median(post_compile)), 3),
            "fit_wall_clock_s_median_post_compile": round(float(np.median(fit_post_compile)), 3),
            "compile_round_s": round(walls[0], 2),
            "rounds_wall_clock_total_s": round(float(np.sum(walls)), 2),
            # All rounds at the steady rate (round 0's one-time start-up
            # replaced by a typical round).
            "device_time_total_s_est": (round(float(np.sum(post_compile)) + float(np.median(post_compile)), 2)
                                        if len(walls) > 1 else round(float(np.sum(walls)), 2)),
            "eval_iou_trajectory": ious,
            "eval_loss_trajectory": losses,
            "learned": (bool(losses[-1] < losses[0] and ious[-1] > ious[0]) if len(rounds_out) >= 2 else None),
        },
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.refscale_federation", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--samples", type=int, default=6213)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--eval-samples", type=int, default=256)
    p.add_argument("--pos-weight", type=float, default=5.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device the fits run on (default cuda)")
    p.add_argument("--data-placement", default="streamed", choices=["streamed", "resident"],
                   help="'streamed' restages each fit's shuffled epoch; 'resident' stages every client's pool "
                   "once and ships only a per-fit gather plan (same trajectory); falls back to streamed, "
                   "recorded in the artifact, when the HBM guard says the pools do not fit")
    p.add_argument("--segments", type=int, default=0,
                   help="epoch-segmented fits: K segment calls instead of one (0 = monolithic; K must divide "
                   "--epochs; bit-identical either way)")
    p.add_argument("--server-optimizer", default="fedavg", choices=["fedavg", "fedavgm", "fedadam", "fedyogi"],
                   help="FedOpt server optimizer on the round pseudo-gradient; fedavg = the plain average")
    p.add_argument("--server-lr", type=float, default=1.0)
    p.add_argument("--server-momentum", type=float, default=0.9)
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint directory: weights, history and FedOpt moments at every round boundary")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint under --ckpt-dir with an identical trajectory")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="Prometheus /metrics over the live registry; 0 disables, -1 an ephemeral port")
    p.add_argument("--spans-path", default="", help="JSONL trace-span sink; empty disables")
    return p


def main(argv=None, *, device=None) -> int:
    args = build_parser().parse_args(argv)
    exporter = None
    if args.metrics_port:
        from fedcrack_tpu_torch.obs.promexp import start_exporter
        from fedcrack_tpu_torch.obs.sentries import LeakSentry

        exporter = start_exporter(args.metrics_port)
        if exporter is not None:
            print(f"metrics: {exporter.url}", flush=True)
            LeakSentry(sample_on_collect=True).mark()
    if args.spans_path:
        from fedcrack_tpu_torch.obs import spans as tracing

        tracing.install(args.spans_path)
    artifact = run_refscale_federation(args, device=device if device is not None else args.device)
    if exporter is not None:
        exporter.stop()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
