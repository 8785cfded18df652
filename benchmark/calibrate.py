"""Readings the correctness limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--controls 3] [--faults NAME ...] [--seconds 3] [--out FILE]

For each seed, one run of the cell (set-up, a short window at the cell's
own load, the comparison with the reference) prints the numbers compared:
the program's readings. On the first ``--controls`` seeds the same numbers
are read with the reference computed in TF32 in the program's place (the
control), and each fault of ``--faults`` (``benchmark/faults.py``) is
planted in the program for a run of its own on those seeds. One JSON line
per reading goes to standard output and to ``--out``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import faults, harness

    spec = harness.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}[args.workload]
    harness.require_cards(chips)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, checks, extra=None):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "checks": {c.name: c.value for c in checks}, **(extra or {})})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    catalogue = {**faults.SERVING, **faults.TRAINING}
    for i, seed in enumerate(args.seeds):
        control = i < args.controls
        result, checks, controls = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, device,
                                                    time.perf_counter(), control=control)
        emit("program", seed, checks, {"correct": result["correct"], "attempted": result["attempted"],
                                       "metrics": {k: v["value"] for k, v in result["metrics"].items()}})
        if control:
            emit("control", seed, controls)
            for name in args.faults:
                with catalogue[name]():
                    _, fchecks, _ = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, device,
                                                     time.perf_counter())
                emit(name, seed, fchecks)
    if out:
        out.close()
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
