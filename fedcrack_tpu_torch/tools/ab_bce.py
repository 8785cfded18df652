"""A/B: the ``bce_sums`` kernel against its plain version inside the train step.

The counterpart of ``fedcrack_tpu.tools.ab_pallas_bce``, named as
``ops/bce.py`` is named after ``ops/pallas_bce.py``. Both arms drive the
same one-client step loop, ``train.local.train_step`` (the step every slot
of a round takes), over batches staged on the device, and differ only in
the ``metrics_fn`` the step takes:

- ``cuda``: ``ops.bce.fused_segmentation_metrics``, which launches the
  hand-written kernel (``kernels/csrc/bce_sums.cu``); it needs a CUDA
  device and raises ``ValueError`` on another;
- ``plain``: the same metrics from ``ops.bce._bce_sums_plain``, the plain
  PyTorch version, on the same device.

The port routes ``bce_sums`` by device and has no switch to pin an
implementation; the arm is an argument, and no environment variable is
read or written. The timing is the JAX tool's: chained runs of ``steps``
and ``fit_factor * steps`` steps, each synced by a host readback of its
last loss, the arms' timed reps interleaved (A, B, A, B, ...) so drift
hits both, and the per-step time from the slope of the two lengths.

On the card:
    python -m fedcrack_tpu_torch.tools.ab_bce --out ab_bce.json

CPU smoke (the plain arm only; the kernel needs the card):
    python -m fedcrack_tpu_torch.tools.ab_bce --impls plain --sizes 32 --steps 2 \\
        --batch 2 --reps 1 --fit-factor 2 --dtype float32 --device cpu --out "$TMPDIR/ab.json"

Artifact schema (the JAX tool's): ``points[<dtype>_<size>] = {"impls":
{<impl>: {round_s_short, round_s_long, per_step_ms, mfu}},
"speedup_first_over_second": float?}``: per-arm dicts under "impls",
derived scalars as sibling keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

IMPLS = ("cuda", "plain")


def plain_segmentation_metrics(logits, labels, pos_weight=None) -> dict:
    """``ops.bce.fused_segmentation_metrics`` with the five sums from the
    plain version, on any device."""
    from fedcrack_tpu_torch.ops.bce import _bce_sums_plain, metrics_from_sums

    return metrics_from_sums(_bce_sums_plain(logits, labels), float(logits.numel()), pos_weight)


def metrics_fn(impl: str, device):
    """The arm's ``train_step`` ``metrics_fn``; the ``cuda`` arm refuses a
    device that is not CUDA rather than run the plain version."""
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics

    if impl == "cuda":
        if device.type != "cuda":
            raise ValueError(f"the cuda arm launches the bce_sums kernel and needs a CUDA device, got {device}")
        return fused_segmentation_metrics
    if impl == "plain":
        return plain_segmentation_metrics
    raise ValueError(f"unknown impl {impl!r}; known: {', '.join(IMPLS)}")


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _make_runner(state, images, masks, step_metrics):
    """Chained, readback-synced run: every step of ``images`` / ``masks``
    (``[steps, B, ...]`` on the device) on ``state``, which carries over to
    the next run, then one host read of the last loss."""
    from fedcrack_tpu_torch.train.local import snapshot_params, train_step

    anchor = snapshot_params(state)

    def run():
        metrics = None
        for s in range(images.shape[0]):
            _, metrics = train_step(state, (images[s], masks[s]), anchor, metrics_fn=step_metrics)
        float(metrics["loss"])

    return run


def run_ab(args) -> dict:
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.obs.flops import mfu, train_step_flops
    from fedcrack_tpu_torch.parallel import make_mesh, stack_client_data, stage_round_data
    from fedcrack_tpu_torch.tools.measure_baseline import _hardware
    from fedcrack_tpu_torch.train.local import create_train_state

    impls = [s.strip() for s in args.impls.split(",") if s.strip()]
    sizes = [int(s) for s in args.sizes.split(",")]
    mesh = make_mesh(1, 1, device=args.device)
    device = mesh.device
    fns = {impl: metrics_fn(impl, device) for impl in impls}
    fit = max(2, args.fit_factor)

    out: dict = {
        "generated_by": "fedcrack_tpu_torch.tools.ab_bce",
        "hardware": _hardware(device),
        "workload": {
            "impls": impls,
            "sizes": sizes,
            "steps": args.steps,
            "batch": args.batch,
            "reps": args.reps,
            "fit_factor": fit,
            "dtype": args.dtype,
        },
        "points": {},
    }

    for img in sizes:
        config = ModelConfig(img_size=img, compute_dtype=args.dtype)
        imgs, msks = synth_crack_batch(args.steps * args.batch, img, seed=args.seed)
        images, masks = stack_client_data([(imgs, msks)], args.steps, args.batch)
        si, sm = (x[0] for x in stage_round_data(images, masks, mesh))
        si_long, sm_long = torch.cat([si] * fit), torch.cat([sm] * fit)

        # Each arm and length chains its own state from the same seed.
        runners = {}
        for impl in impls:
            runners[impl] = tuple(
                _make_runner(create_train_state(torch.Generator().manual_seed(args.seed), config, device=device),
                             x, y, fns[impl])
                for x, y in ((si, sm), (si_long, sm_long))
            )
            for r in runners[impl]:
                r()  # first run: lazy allocations, cuDNN's algorithm choice
                r()  # the steady state the timed reps repeat

        # Interleaved timed reps: one (short, long) pair per arm per pass,
        # so slow drift is shared across arms.
        shorts = {impl: [] for impl in impls}
        longs = {impl: [] for impl in impls}
        for _ in range(args.reps):
            for impl in impls:
                shorts[impl].append(_timed(runners[impl][0]))
            for impl in impls:
                longs[impl].append(_timed(runners[impl][1]))

        flops = train_step_flops(config, args.batch)
        pts = {}
        for impl in impls:
            short_s = float(np.median(shorts[impl]))
            long_s = float(np.median(longs[impl]))
            slope = (long_s - short_s) / ((fit - 1) * args.steps)
            fit_ok = slope > 0.0
            util = mfu(slope, flops, device) if fit_ok else None
            pts[impl] = {
                "round_s_short": short_s,
                "round_s_long": long_s,
                "per_step_ms": round(slope * 1e3, 4) if fit_ok else None,
                "mfu": util,
            }
        point = {"impls": pts}
        if len(impls) == 2 and all(pts[i]["per_step_ms"] is not None for i in impls):
            a, b = impls
            point["speedup_first_over_second"] = round(pts[b]["per_step_ms"] / pts[a]["per_step_ms"], 4)
        out["points"][f"{args.dtype}_{img}"] = point
        del runners, si, sm, si_long, sm_long
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.ab_bce", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--impls", default="cuda,plain")
    p.add_argument("--sizes", default="128,256")
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--fit-factor", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="the steps' device (default: cuda)")
    return p


def main(argv=None, *, device=None) -> int:
    args = build_parser().parse_args(argv)
    if device is not None:
        args.device = device
    artifact = run_ab(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(json.dumps(artifact["points"]))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
