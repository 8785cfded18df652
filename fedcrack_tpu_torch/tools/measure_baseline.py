"""The BASELINE c1-c5 table, measured on one device.

``python -m fedcrack_tpu_torch.tools.measure_baseline --out F.json``

The counterpart of ``fedcrack_tpu.tools.measure_baseline``: one row per
BASELINE preset (``configs/c1..c5_*.json``) with its round wall, per-step
time, control- and data-plane bytes, validation loss, pixel accuracy and
crack IoU, under the JAX tool's flags, row keys and artifact schema.

- c1: the centralized trainer (``train.centralized.train_centralized``);
- c2 and c4: FedAvg over the port's gRPC ``FedServer`` and ``FedClient``s
  in process, over 127.0.0.1 (c4 non-IID with FedProx);
- c3: ``parallel.build_federated_round`` on a ``(8, 1)`` mesh; c5 on
  ``(4, 2)``, a 2-way ``batch`` axis, in bfloat16; their quality from the
  host-plane federation of the same config;
- c3q: a micro federation through the mesh round and its host-plane twin,
  side by side.

Workloads are scaled down from the presets' reference scale, and each row
records its workload and hardware: the card's name and power limit (from
``nvidia-smi``), never extrapolated. Quality is the held-out synthetic
eval with BatchNorm recalibration, as ``server --eval-synthetic``. The rows
run on CUDA unless ``--device`` names another device. A scaled run:

    python -m fedcrack_tpu_torch.tools.measure_baseline --configs c1,c2,c3,c5 \\
        --samples 32 --epochs 1 --rounds 1 --mesh-steps 2 --mesh-img 128 --out /tmp/baseline.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _now() -> float:
    return time.perf_counter()


def _power_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def _hardware(device) -> dict:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(device),
                "n_devices": torch.cuda.device_count(), "power_limit": _power_line()}
    return {"platform": device.type, "device_kind": device.type, "n_devices": 1, "power_limit": None}


def _load_preset(name: str):
    from fedcrack_tpu_torch.configs import FedConfig

    with open(os.path.join(ROOT, "configs", f"{name}.json"), encoding="utf-8") as f:
        return FedConfig.from_json(f.read())


def _state(model_cfg, device, learning_rate: float = 1e-3, seed: int = 0):
    import torch

    from fedcrack_tpu_torch.train.local import create_train_state

    return create_train_state(torch.Generator().manual_seed(seed), model_cfg, learning_rate, device=device)


def _eval_quality(variables, model_cfg, n_val: int, seed: int, device, pos_weight: float = 1.0) -> dict:
    """Held-out quality with BatchNorm recalibration (the server's eval)."""
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train.local import evaluate, recalibrate_batch_stats

    images, masks = synth_crack_batch(n_val, model_cfg.img_size, seed=seed)
    ds = ArrayDataset(images, masks, batch_size=8, shuffle=False, drop_last=False)
    st = _state(model_cfg, device).replace_variables(variables)
    recalibrate_batch_stats(st, ds)
    m = evaluate(st, ds, pos_weight=pos_weight)
    return {"val_loss": round(float(m["loss"]), 4), "pixel_acc": round(float(m["pixel_acc"]), 4),
            "iou": round(float(m["iou"]), 4)}


def measure_c1(args, device) -> dict:
    """c1: single-client local fit (the centralized trainer), reference
    128 px crops."""
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.train.centralized import train_centralized

    cfg = _load_preset("c1_single_client_cpu")
    img = cfg.model.img_size
    n_train, n_val = args.samples, max(16, args.samples // 4)
    images, masks = synth_crack_batch(n_train + n_val, img, seed=0)
    train_ds = ArrayDataset(images[:n_train], masks[:n_train], batch_size=cfg.data.batch_size, seed=0)
    val_ds = ArrayDataset(images[n_train:], masks[n_train:], batch_size=cfg.data.batch_size, shuffle=False,
                          drop_last=False)
    t0 = _now()
    _, history = train_centralized(train_ds, val_ds, cfg.model, epochs=args.epochs, learning_rate=cfg.learning_rate,
                                   pos_weight=args.pos_weight, log_fn=lambda s: None, device=device)
    total_s = _now() - t0
    steps = args.epochs * len(train_ds)
    best = min(history, key=lambda h: h["val_loss"])
    return {
        "config": "c1_single_client_cpu",
        "hardware": _hardware(device),
        "workload": {"img_size": img, "batch": cfg.data.batch_size, "train_samples": n_train,
                     "epochs": args.epochs, "pos_weight": args.pos_weight},
        "wall_clock_s": round(total_s, 2),
        "per_step_ms": round(total_s / steps * 1e3, 2),
        "epoch_s": round(total_s / args.epochs, 2),
        "val_loss": round(float(best["val_loss"]), 4),
        "pixel_acc": round(float(best["val_pixel_acc"]), 4),
        "iou": round(float(best["val_iou"]), 4),
        "notes": "best-val epoch; per_step includes the per-epoch BN recalibration + validation sweeps",
    }


def measure_c2(args, device, preset="c2_two_client_grpc", partition="iid", mu=None) -> dict:
    """c2/c4: K-client FedAvg over real localhost gRPC, end to end."""
    import threading

    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.train.federated import make_train_fn
    from fedcrack_tpu_torch.train.local import evaluate, recalibrate_batch_stats
    from fedcrack_tpu_torch.transport.client import FedClient
    from fedcrack_tpu_torch.transport.service import FedServer, ServerThread

    cfg = _load_preset(preset)
    n_clients = min(cfg.cohort_size, args.grpc_clients)
    img = cfg.model.img_size
    cfg = dataclasses.replace(
        cfg, cohort_size=n_clients, max_rounds=args.rounds, local_epochs=args.epochs, pos_weight=args.pos_weight,
        poll_period_s=0.2, registration_window_s=10.0, port=0,
        fedprox_mu=cfg.fedprox_mu if mu is None else mu,
        data=dataclasses.replace(cfg.data, img_size=img, batch_size=8),
    )
    # Held-out eval set (server side), a seed distinct from every client's.
    ev_images, ev_masks = synth_crack_batch(32, img, seed=999)
    eval_ds = ArrayDataset(ev_images, ev_masks, batch_size=8, shuffle=False, drop_last=False)
    state_tmpl = _state(cfg.model, device, seed=cfg.seed)
    template = state_tmpl.variables

    def eval_fn(blob: bytes) -> dict:
        st = state_tmpl.replace_variables(tree_from_bytes(blob, template=template))
        recalibrate_batch_stats(st, eval_ds)
        return evaluate(st, eval_ds, pos_weight=cfg.pos_weight)

    server = FedServer(cfg, template, tick_period_s=0.1, eval_fn=eval_fn)
    results, errors = {}, {}
    t0 = _now()
    with ServerThread(server) as st_thread:
        def run_client(i):
            try:
                # Non-IID (c4): per-client crack prevalence skew via crack_prob.
                crack_prob = 0.8 if partition == "iid" else (0.35 + 0.9 * i / max(1, n_clients - 1))
                imgs, msks = synth_crack_batch(args.samples, img, seed=10 + i, crack_prob=min(crack_prob, 1.0))
                ds = ArrayDataset(imgs, msks, batch_size=8, seed=i)
                train_fn, _ = make_train_fn(cfg, ds, batch_size=8, seed=i, device=device)
                results[i] = FedClient(cfg, train_fn, cname=f"c{i}", port=st_thread.port).run_session()
            except Exception as e:  # reported below: the row must not describe a degraded run
                errors[i] = repr(e)

        threads = [threading.Thread(target=run_client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # Evals run off the loop: wait for the last round's record.
        deadline = _now() + 120
        while len(server.eval_history) < args.rounds and _now() < deadline:
            time.sleep(0.5)
        history = list(st_thread.state.history)
        eval_hist = list(server.eval_history)
    total_s = _now() - t0
    if errors or len(results) != n_clients or not all(r.enrolled for r in results.values()):
        raise RuntimeError(f"{preset}: only {sorted(results)} of {n_clients} clients completed: {errors}")
    steps_per_round = n_clients * args.epochs * (args.samples // 8)
    round_wall = [h["wall_clock_s"] for h in history]
    last_eval = eval_hist[-1] if eval_hist else {}

    def _q(key):
        # None (JSON null) when the off-loop eval missed the deadline.
        v = last_eval.get(key)
        return None if v is None else round(float(v), 4)

    return {
        "config": preset if mu is None else "c4_noniid_fedprox",
        "hardware": _hardware(device),
        "workload": {"img_size": img, "batch": 8, "clients": n_clients, "rounds": args.rounds,
                     "local_epochs": args.epochs, "samples_per_client": args.samples, "partition": partition,
                     "fedprox_mu": cfg.fedprox_mu, "pos_weight": cfg.pos_weight},
        "session_wall_clock_s": round(total_s, 2),
        "round_wall_clock_s": round(float(np.median(round_wall)), 3),
        "per_step_ms": round(float(np.median(round_wall)) / steps_per_round * 1e3, 2),
        "control_plane_bytes": {
            "received_per_round": int(np.median([h["bytes_received"] for h in history])),
            "broadcast_per_round": int(np.median([h["bytes_broadcast"] for h in history])),
        },
        "val_loss": _q("loss"),
        "pixel_acc": _q("pixel_acc"),
        "iou": _q("iou"),
        "notes": "real localhost gRPC, real trainers; round wall-clock from the coordinator's round history; "
                 "quality = server-side eval of the final aggregated model on held-out fixtures",
    }


def _host_federation(vars0, q_data, model_cfg, cfg, args, device, batch: int):
    """The host-plane federation of a mesh row's config: per round each
    client a fresh state from the global, ``local_fit``, then FedAvg."""
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.fed.algorithms import fedavg
    from fedcrack_tpu_torch.train.local import local_fit, snapshot_params

    variables = vars0
    for _ in range(args.rounds):
        trained = []
        for ci, (images, masks) in enumerate(q_data):
            st = _state(model_cfg, device, cfg.learning_rate, cfg.seed).replace_variables(variables)
            ds = ArrayDataset(images, masks, batch_size=batch, seed=ci)
            st, _ = local_fit(st, ds, epochs=args.epochs_quality, pos_weight=args.pos_weight, mu=cfg.fedprox_mu,
                              anchor_params=snapshot_params(st))
            trained.append(st.variables)
        variables = fedavg(trained, weights=[float(args.samples)] * len(q_data))
    return variables


def measure_mesh(args, device, preset: str, n_clients: int, n_batch: int) -> dict:
    """c3/c5: mesh rounds through the driver; quality from the host-plane
    federation of the same config."""
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import build_federated_round, make_mesh, run_mesh_federation, stack_client_data

    cfg = _load_preset(preset)
    img = cfg.model.img_size if args.mesh_img is None else args.mesh_img
    model_cfg = dataclasses.replace(cfg.model, img_size=img)
    mesh = make_mesh(n_clients, n_batch, device=device)
    round_fn = build_federated_round(mesh, model_cfg, learning_rate=cfg.learning_rate, local_epochs=args.epochs,
                                     fedprox_mu=cfg.fedprox_mu, pos_weight=args.pos_weight)
    batch = cfg.data.batch_size
    per_client = [synth_crack_batch(args.mesh_steps * batch, img, seed=20 + i) for i in range(n_clients)]
    images, masks = stack_client_data(per_client, args.mesh_steps, batch)
    active = np.ones(n_clients, np.float32)
    n_samples = np.full(n_clients, float(args.mesh_steps * batch), np.float32)
    state0 = _state(model_cfg, device, seed=cfg.seed)
    # The local data is static across rounds: data_fn returns None after
    # round 0, so the slab is staged once.
    _, records = run_mesh_federation(round_fn, state0.variables,
                                     lambda r: (images, masks, active, n_samples) if r == 0 else None,
                                     args.rounds, mesh)
    times = [rec.wall_clock_s for rec in records]
    # The first round pays the process's first kernels: report the median
    # of the rest.
    round_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    steps_per_round = args.epochs * args.mesh_steps
    q_data = [synth_crack_batch(args.samples, img, seed=20 + i) for i in range(n_clients)]
    vars_q = _host_federation(state0.variables, q_data, model_cfg, cfg, args, device, batch)
    quality = _eval_quality(vars_q, model_cfg, n_val=32, seed=999, device=device, pos_weight=args.pos_weight)
    return {
        "config": preset,
        "hardware": _hardware(device),
        "workload": {
            "img_size": img, "batch": batch, "clients": n_clients, "batch_dp": n_batch, "rounds": args.rounds,
            "local_epochs": args.epochs, "steps_per_epoch": args.mesh_steps, "compute_dtype": model_cfg.compute_dtype,
            "pos_weight": args.pos_weight,
            "quality_workload": {"samples_per_client": args.samples, "local_epochs": args.epochs_quality,
                                 "rounds": args.rounds, "path": "host-plane equivalent"},
        },
        "round_wall_clock_s": round(round_s, 3),
        "compile_round_s": round(times[0], 2),
        "per_step_ms": round(round_s / steps_per_round * 1e3, 2),
        "data_plane_bytes_staged": int(images.nbytes + masks.nbytes),
        **quality,
        "notes": "the slot-plane round (client slots in order on one device, the ordered FedAvg fold) through the "
                 "driver for timing; quality = held-out eval of the host-plane federation of the same config "
                 "(local_fit + fedavg) at the quality_workload; compile_round_s is the first round, which pays "
                 "the process's first kernels (there is no compile)",
    }


def _flat_params(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_params(tree[k], path + (k,))
        else:
            v = tree[k]
            yield path + (k,), np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)


def measure_c3_mesh_program_quality(args, device) -> dict:
    """c3q: a quality-bearing micro federation through the mesh round, with
    its host-plane twin on the same seed, data and order: a few rounds at
    32 px through ``build_federated_round`` on 8 slots, the same workload
    through ``train_step`` and host ``fedavg``, and both finals' held-out
    eval side by side."""
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.algorithms import fedavg
    from fedcrack_tpu_torch.parallel import build_federated_round, make_mesh, run_mesh_federation, stack_client_data
    from fedcrack_tpu_torch.train.local import train_step

    cfg = _load_preset("c3_eight_client_mesh")
    n_clients = 8
    img = 32 if args.mesh_img is None else args.mesh_img
    batch = 4
    model_cfg = dataclasses.replace(cfg.model, img_size=img)
    mesh = make_mesh(n_clients, 1, device=device)
    round_fn = build_federated_round(mesh, model_cfg, learning_rate=cfg.learning_rate, local_epochs=args.epochs,
                                     pos_weight=args.pos_weight)
    per_client = [synth_crack_batch(args.mesh_steps * batch, img, seed=20 + i) for i in range(n_clients)]
    images, masks = stack_client_data(per_client, args.mesh_steps, batch)
    active = np.ones(n_clients, np.float32)
    n_samples = np.full(n_clients, float(args.mesh_steps * batch), np.float32)
    state0 = _state(model_cfg, device, seed=cfg.seed)

    t0 = _now()
    mesh_vars, records = run_mesh_federation(round_fn, state0.variables,
                                             lambda r: (images, masks, active, n_samples) if r == 0 else None,
                                             args.rounds, mesh)
    mesh_s = _now() - t0

    # The host-plane twin: the same rounds, a fresh optimizer per round, the
    # round's epoch-outer, step-inner order.
    t0 = _now()
    host_vars = state0.variables
    for _ in range(args.rounds):
        trained = []
        for c in range(n_clients):
            st = _state(model_cfg, device, cfg.learning_rate, cfg.seed).replace_variables(host_vars)
            for _e in range(args.epochs):
                for s in range(args.mesh_steps):
                    st, _ = train_step(st, (images[c, s], masks[c, s]), {}, 0.0, args.pos_weight)
            trained.append(st.variables)
        host_vars = fedavg(trained, weights=[float(n) for n in n_samples])
    host_s = _now() - t0

    # Two classes of leaf, as the golden test's: a conv bias feeding a
    # BatchNorm has a true gradient of 0, so Adam turns reassociation noise
    # into lr-sized steps there, while every other leaf stays at noise scale.
    max_diff_bn_bias = max_diff_rest = 0.0
    host_flat = dict(_flat_params(host_vars["params"]))
    for path, a in _flat_params(mesh_vars["params"]):
        d = float(np.max(np.abs(a - host_flat[path])))
        if path[-1] == "bias" and any(s in path[0] for s in ("stem_conv", "_sep", "_convT")):
            max_diff_bn_bias = max(max_diff_bn_bias, d)
        else:
            max_diff_rest = max(max_diff_rest, d)
    q_mesh = _eval_quality(mesh_vars, model_cfg, n_val=32, seed=999, device=device, pos_weight=args.pos_weight)
    q_host = _eval_quality(host_vars, model_cfg, n_val=32, seed=999, device=device, pos_weight=args.pos_weight)
    return {
        "config": "c3q_mesh_program_quality",
        "hardware": _hardware(device),
        "workload": {"img_size": img, "batch": batch, "clients": n_clients, "rounds": args.rounds,
                     "local_epochs": args.epochs, "steps_per_epoch": args.mesh_steps,
                     "compute_dtype": model_cfg.compute_dtype, "pos_weight": args.pos_weight},
        "mesh_program": {"wall_clock_s": round(mesh_s, 2), "compile_round_s": round(records[0].wall_clock_s, 2),
                         **{f"q_{k}": v for k, v in q_mesh.items()}},
        "host_plane_twin": {"wall_clock_s": round(host_s, 2), **{f"q_{k}": v for k, v in q_host.items()}},
        "max_abs_param_diff_bn_shadowed_bias": max_diff_bn_bias,
        "max_abs_param_diff_other_leaves": max_diff_rest,
        "quality_equal": bool(abs(float(q_mesh["iou"]) - float(q_host["iou"])) <= 0.005
                              and abs(float(q_mesh["pixel_acc"]) - float(q_host["pixel_acc"])) <= 0.005
                              and abs(float(q_mesh["val_loss"]) - float(q_host["val_loss"])) <= 0.01),
        "notes": "same seed, same data, same order through both planes; the slot round's steps are the host "
                 "path's train_step, so the planes differ only in the fold's rounding against fedavg's",
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.measure_baseline", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--configs", default="c1,c2,c3,c4,c5")
    p.add_argument("--samples", type=int, default=64, help="train samples per client")
    p.add_argument("--epochs", type=int, default=2, help="local epochs")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--grpc-clients", type=int, default=2)
    p.add_argument("--mesh-steps", type=int, default=8, help="steps per epoch (mesh rows)")
    p.add_argument("--mesh-img", type=int, default=None, help="override the mesh rows' crop")
    p.add_argument("--pos-weight", type=float, default=5.0)
    p.add_argument("--epochs-quality", type=int, default=2, dest="epochs_quality",
                   help="local epochs for the mesh rows' host-plane quality federation")
    p.add_argument("--device", default="cuda", help="torch device the rows run on (default cuda)")
    return p


def main(argv=None, *, device=None) -> int:
    args = build_parser().parse_args(argv)
    device = device if device is not None else args.device
    want = set(args.configs.split(","))
    rows = []
    for name, measure in (
        ("c1", lambda: measure_c1(args, device)),
        ("c2", lambda: measure_c2(args, device)),
        ("c3", lambda: measure_mesh(args, device, "c3_eight_client_mesh", 8, 1)),
        ("c4", lambda: measure_c2(args, device, preset="c4_noniid_fedprox", partition="skew", mu=0.01)),
        ("c5", lambda: measure_mesh(args, device, "c5_bf16_batch_dp", 4, 2)),
        ("c3q", lambda: measure_c3_mesh_program_quality(args, device)),
    ):
        if name in want:
            rows.append(measure())
            print(json.dumps(rows[-1]), flush=True)
    artifact = {"generated_by": "fedcrack_tpu_torch.tools.measure_baseline", "hardware": _hardware(device),
                "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
