"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``fedcrack_tpu_torch``),
on a machine with the CUDA cards the cell asks for. The last line of
standard output is the result's JSON object; the numbers the correctness
check compared, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without the cards, or if JAX,
``flax`` or the JAX package (``fedcrack_tpu``) was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and build caches at fixed paths inside the checkout, so that only a
# cell's first run in a checkout builds (the port's own kernel libraries
# build into fedcrack_tpu_torch/_build/, also inside it).
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; have {sorted(cells)}", file=sys.stderr)
        return 2
    try:
        harness.require_cards(cells[args.workload]["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    result, checks, _ = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                         torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
