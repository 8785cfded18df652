"""Profiled step decomposition of the production round at one shape.

The counterpart of ``fedcrack_tpu.tools.profile_step``:

- builds the production round (``parallel.build_federated_round`` on a
  one-slot mesh) at ``--img`` / ``--dtype``, stages one round of data,
  warms twice, then records ``--rounds`` chained rounds, each synced by a
  host readback of its loss, inside one ``obs.metrics.card_profile``
  window (its lead kernels open the window and are left out);
- writes the window's Chrome trace into ``--trace-dir`` (none is kept
  without it: at the defaults a trace is ~400 MB) and aggregates
  the CUDA kernels' self device time by category, from the kernel's name:
  convolution (cuDNN fprop / dgrad / wgrad), gemm, elementwise,
  reduction, batch_norm, optimizer (Adam's multi-tensor kernels),
  pooling, copy / memset, the port's own kernels (``bce_sums_kernel``,
  ``dequant_*``) and other, keeping the top kernels, and counts the
  window's ``bce_sums_kernel`` records against the one launch each step
  makes (``kernel_stats["bce_sums_records"]``): a window that lost records
  reads short, and then its fractions are not to be trusted;
- cross-checks the profile against the measured wall: the profiled device
  time per round against the round's wall clock. That wall is taken under
  the profiler, which slows the host: ``tools/ab_bce``'s per-step slope is
  the unprofiled step time.

The artifact keeps the JAX tool's schema, with ``hlo_stats`` as
``kernel_stats`` and ``xplane_files`` as ``trace_files``. ``kernel_stats``
is None on a device whose window holds no CUDA kernel (the CPU).

On the card (the 256 px north-star profile):
    python -m fedcrack_tpu_torch.tools.profile_step --img 256 --out profile_256.json

CPU smoke (tiny shape; exercises the round, the trace and the schema):
    python -m fedcrack_tpu_torch.tools.profile_step --img 32 --steps 2 --batch 2 \\
        --rounds 1 --dtype float32 --device cpu --out "$TMPDIR/profile.json"
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# (category, substrings of the lower-cased kernel name), first match wins:
# Adam's foreach kernels and the port's own before the patterns their
# template arguments contain; copies (cuDNN's layout transforms among
# them) before cuDNN's convolutions and the elementwise template that
# carries torch's copy.
CATEGORIES = (
    ("port_kernels", ("bce_sums_kernel", "dequant_")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("pooling", ("pool",)),
    ("copy_memset", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "im2col")),
    ("reduction", ("reduce",)),
    ("gemm", ("gemm", "gemv", "cutlass", "nvjet")),  # nvjet: cuBLAS's Hopper GEMMs
    ("elementwise", ("elementwise",)),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for category, needles in CATEGORIES:
        if any(n in low for n in needles):
            return category
    return "other"


def aggregate_kernel_stats(records, top_n: int) -> dict | None:
    """``(kernel name, self device time in us, occurrences)`` records ->
    ``{total_self_time_us, by_category, top_ops}``; None when there is no
    record. The counterpart of the JAX tool's ``_aggregate_hlo_stats``."""
    records = list(records)
    if not records:
        return None
    total_us = float(sum(us for _, us, _ in records))
    by_cat: dict[str, dict] = {}
    ops = []
    for name, self_us, count in records:
        cat = kernel_category(name)
        agg = by_cat.setdefault(cat, {"self_time_us": 0.0, "occurrences": 0})
        agg["self_time_us"] += float(self_us)
        agg["occurrences"] += int(count)
        ops.append({
            "name": name[:120],
            "category": cat,
            "self_time_us": round(float(self_us), 1),
            "occurrences": int(count),
            "self_time_percent": 100.0 * float(self_us) / total_us if total_us else None,
        })
    ops.sort(key=lambda o: -o["self_time_us"])
    for agg in by_cat.values():
        agg["fraction"] = round(agg["self_time_us"] / total_us, 4) if total_us else None
        agg["self_time_us"] = round(agg["self_time_us"], 1)
    return {
        "total_self_time_us": round(total_us, 1),
        "by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]["self_time_us"])),
        "top_ops": ops[:top_n],
    }


def run_profile(args) -> dict:
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.flops import mfu, train_step_flops
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile
    from fedcrack_tpu_torch.parallel import (
        build_federated_round,
        make_mesh,
        stack_client_data,
        stage_round_data,
    )
    from fedcrack_tpu_torch.tools.measure_baseline import _hardware

    config = ModelConfig(img_size=args.img, compute_dtype=args.dtype)
    mesh = make_mesh(1, 1, device=args.device)
    device = mesh.device
    round_fn = build_federated_round(mesh, config, learning_rate=1e-3, local_epochs=1)
    variables = init_variables(torch.Generator().manual_seed(args.seed), config)

    imgs, msks = synth_crack_batch(args.steps * args.batch, args.img, seed=args.seed)
    images, masks = stack_client_data([(imgs, msks)], args.steps, args.batch)
    si, sm = stage_round_data(images, masks, mesh)
    active = np.ones(1, np.float32)
    n_samp = np.full(1, float(args.steps * args.batch), np.float32)

    state = {"v": variables}

    def run():
        new_vars, metrics = round_fn(state["v"], si, sm, active, n_samp)
        state["v"] = new_vars
        float(metrics["loss"][0])

    run()  # first round: lazy allocations, cuDNN's algorithm choice
    run()  # the steady-state round the profiled ones repeat

    if device.type == "cuda":
        window = card_profile()
    else:
        from torch.profiler import ProfilerActivity, profile

        window = profile(activities=[ProfilerActivity.CPU])
    walls = []
    with window as prof:
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
    trace_dir, trace_files = args.trace_dir or None, []
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace_files.append(os.path.join(trace_dir, f"profile_step_{os.getpid()}.pt.trace.json"))
        prof.export_chrome_trace(trace_files[0])
    kernels = card_kernels(prof) if device.type == "cuda" else []
    stats = aggregate_kernel_stats(((e.key, e.self_device_time_total, e.count) for e in kernels), args.top)
    if stats is not None:
        stats["bce_sums_records"] = {
            "observed": sum(e.count for e in kernels if "bce_sums_kernel" in e.key),
            "expected": args.steps * args.rounds,
        }

    flops = train_step_flops(config, args.batch)
    wall_s = float(np.median(walls))
    step_s = wall_s / args.steps
    util = mfu(step_s, flops, device)
    out = {
        "generated_by": "fedcrack_tpu_torch.tools.profile_step",
        "hardware": _hardware(device),
        "workload": {
            "img_size": args.img,
            "dtype": args.dtype,
            "steps": args.steps,
            "batch": args.batch,
            "profiled_rounds": args.rounds,
        },
        "measured": {
            "round_wall_s_median": round(wall_s, 4),
            "naive_per_step_ms": round(step_s * 1e3, 3),
            "flops_per_step": flops,
            "naive_mfu": util,
            "note": (
                "naive division of a profiled round's wall (one readback per "
                "round); cross-check against tools/ab_bce's slope fit"
            ),
        },
        "trace_dir": trace_dir,
        "trace_files": trace_files,
        "kernel_stats": stats,
    }
    if stats is not None and stats["total_self_time_us"] > 0:
        # Device self time per profiled round against the measured wall:
        # the gap is host time the device waited through.
        out["measured"]["profiled_device_s_per_round"] = round(
            stats["total_self_time_us"] / 1e6 / args.rounds, 4
        )
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.profile_step", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--img", type=int, default=256)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace-dir", default="", help="where the Chrome trace is written (none without it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="the round's device (default: cuda)")
    return p


def main(argv=None, *, device=None) -> int:
    args = build_parser().parse_args(argv)
    if device is not None:
        args.device = device
    artifact = run_profile(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    if artifact["kernel_stats"] is not None:
        cats = {k: v["fraction"] for k, v in artifact["kernel_stats"]["by_category"].items()}
        print(json.dumps({"by_category_fraction": cats,
                          "bce_sums_records": artifact["kernel_stats"]["bce_sums_records"]}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
