"""A/B of the quantized forward's kernels between checkouts, on one card.

    python -m fedcrack_tpu_torch.tools.ab_conv --tree OLD --tree . --tree . --tree OLD \\
        --out chiprun_out/ab_conv.json

Each ``--tree`` runs in a process of its own with that checkout's package
first on ``sys.path``, in the order given, so a parent, change, change,
parent sequence compares two versions within one call on one card. A run
builds ``ModelConfig()`` on the fused int8 plane (the codes of seeded
weights; their values do not change a time) and records the arguments of
every ``dequant_conv3x3`` and ``dequant_matmul`` call of one bucket-256 x
batch-8 forward, their epilogue keywords included (a tree whose wrappers
take none records none). On those inputs it measures each kernel's device
time (torch.profiler) per call and per forward, and its wrapper's host µs
per call (the least of 5 runs of 200 back-to-back calls); and
``dequant_matmul``'s device time per forward again with the same codes as
fp8 e4m3 (``dequant_matmul_e4m3``). In a tree with epilogues, per
forward also: each kernel without its epilogue (``unfused_ms``, and per
call), the same followed by the torch ops the epilogue stands for
(``unfused_ops_ms``), and the library pair, ``torch.matmul`` or
``F.conv2d`` (channels-last, weights expanded once) followed by those ops
(``library_pair_ms``). Each tree's ``-Xptxas -v`` report of the two
kernels' instantiations (registers, spill stores and loads), from the
build's log. The depthwise stage's device time per
forward: in a tree whose forward calls ``dequant_dwconv3x3``, its six
launches on the recorded inputs; in a tree whose forward expands its
depthwise codes with ``dequant_codes_group`` and runs ``torch.relu``,
``F.pad`` and a grouped ``F.conv2d`` per stage, those kernels on the
recorded inputs of its six ``_sepconv`` calls (as that forward wrote them)
and the one ``dequant_codes`` launch. It then profiles 5 served batches for
their host ms, device busy ms, kernel launches per batch and idle share.
Last, ``bce_sums`` on seeded logits and masks at the train step's 16 x 128
x 128 and at 8 x 256 x 256: device time per call and the wrapper's host µs
per call. The card's name and power limit go beside every run. CUDA only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BUCKET, BATCH = 256, 8
KERNELS = ("dequant_conv3x3", "dequant_matmul")
DW_KERNEL = "dequant_dwconv3x3"
BCE_SHAPES = {"train_step": (16, 128, 128, 1), "256px": (8, 256, 256, 1)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_ms(torch, fns, n: int, per_pass: int | None = None) -> float:
    """Device time of one pass over ``fns``: the CUDA kernels, summed, over
    ``n`` passes after a warm one. A window that lost kernel records would
    read short, so it is taken again (up to 3 times) until it holds
    ``per_pass`` records a pass (one a call where not given)."""
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    want = n * (len(fns) if per_pass is None else per_pass)
    counts = []
    for _ in range(3):
        with card_profile() as prof:
            for _ in range(n):
                for fn in fns:
                    fn()
        kernels = card_kernels(prof)
        counts.append(sum(e.count for e in kernels))
        if counts[-1] == want:
            return sum(e.self_device_time_total for e in kernels) / n / 1e3
    raise RuntimeError(f"ab_conv: the profiler kept {counts} kernel records, want {want}")


def _host_us(torch, fn, calls: int = 200, runs: int = 5) -> float:
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        walls.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(walls)


def run_tree() -> dict:
    """One run in this process's checkout (see the module docstring)."""
    import numpy as np
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.kernels import forward as fused
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    if not torch.cuda.is_available():
        raise SystemExit("ab_conv: no CUDA device; it measures on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig()
    engine = InferenceEngine(cfg, ServeConfig(quant="int8", kernel_plane="fused_int8"))
    raw = init_variables(torch.Generator().manual_seed(0), cfg)
    weights = engine.prepare(quant_mod.quantize_for_plane(raw, "fused_int8"))
    batch = np.random.default_rng(1).integers(0, 256, (BATCH, BUCKET, BUCKET, 3), dtype=np.uint8)

    # The depthwise stage: the kernel where this tree's forward calls it,
    # else the parent's ReLU + pad + grouped conv and its grouped expansion.
    stage = DW_KERNEL if hasattr(fused, DW_KERNEL) else "_sepconv"
    recorded = KERNELS + (stage,) + (() if stage == DW_KERNEL else ("dequant_codes_group",))
    calls = {name: [] for name in recorded}
    wrapped = {name: getattr(fused, name) for name in recorded}

    def recorder(name):
        def record(*args, **kwargs):
            calls[name].append((args, kwargs))
            return wrapped[name](*args, **kwargs)
        return record

    for name in recorded:
        setattr(fused, name, recorder(name))
    try:
        engine.predict_bucket(weights, batch)
    finally:
        for name in recorded:
            setattr(fused, name, wrapped[name])
    torch.cuda.synchronize()

    out = {"card": card_line(), "device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for name in KERNELS:
        kernel = getattr(dequant, name)
        args = calls[name]
        per_call = [_device_ms(torch, [lambda a=a, k=k: kernel(*a, **k)], n=20) for a, k in args]
        out[name] = {
            "calls": len(args),
            "shapes": [[tuple(t.shape) for t in a[:2]] for a, _ in args],
            "epilogues": [_epilogue_text(k) for _, k in args],
            "device_ms_per_call": per_call,
            "device_ms_per_forward": _device_ms(torch, [lambda a=a, k=k: kernel(*a, **k) for a, k in args], n=10),
            "host_us_per_call": [_host_us(torch, lambda a=a, k=k: kernel(*a, **k)) for a, k in args],
        }
        if hasattr(dequant, "Epilogue"):
            out[name].update(_epilogue_times(torch, name, args))

    # The same GEMMs with e4m3 codes: every int8 code is exact in e4m3 but
    # +-127 (rounded to +-128), which changes no time.
    e4m3 = [((x, q.float().to(torch.float8_e4m3fn), s), k) for (x, q, s), k in calls["dequant_matmul"]]
    out["dequant_matmul_e4m3"] = {"device_ms_per_forward": _device_ms(
        torch, [lambda a=a, k=k: dequant.dequant_matmul(*a, **k) for a, k in e4m3], n=10)}

    out["depthwise_stage"] = _depthwise_stage(torch, stage, calls)

    engine.predict_bucket(weights, batch)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.predict_bucket(weights, batch)  # returns host numpy: synchronized
        lat.append((time.perf_counter() - t0) * 1e3)
    with card_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            engine.predict_bucket(weights, batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = card_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out["served_batch"] = {"host_ms_p50": float(np.percentile(lat, 50)), "profiled_host_ms": wall_us / 5e3,
                           "device_busy_ms": busy_us / 5e3, "idle_share": 1 - busy_us / wall_us,
                           "launches_per_batch": sum(e.count for e in kernels) / 5}
    out["bce_sums"] = _bce_sums_run(torch)
    out["ptxas"] = {lib.name: _ptxas_report(lib.build() + ".log")
                    for lib in (dequant.LIBRARY, dequant.CONV_LIBRARY)}
    return out


def _ptxas_report(path: str) -> list[dict]:
    """Each kernel instantiation of a build's ``-Xptxas -v`` log: its
    mangled name's template arguments, registers, spill stores and loads
    (bytes)."""
    import re

    with open(path, encoding="utf-8") as f:
        text = f.read()
    out = []
    for block in re.split(r"ptxas info\s*: Compiling entry function ", text)[1:]:
        name = re.match(r"'(\S+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if name is None or regs is None or "kernel" not in name.group(1):
            continue
        args = re.search(r"kernelI(.*?)EEv", name.group(1))
        out.append({"kernel": args.group(1) if args else name.group(1), "registers": int(regs.group(1)),
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None})
    return out


def _epilogue_text(kw: dict) -> str:
    """The steps a launch's keywords fuse, as text."""
    epi, parts = kw.get("epilogue"), []
    if epi is not None:
        parts += ["bias"] + ["bn"] * (epi.bn is not None) + ["relu"] * epi.relu
    parts += ["residual"] * (kw.get("residual") is not None) + ["relu_input"] * bool(kw.get("relu_input"))
    return "+".join(parts) or "none"


def _epilogue_times(torch, name: str, args: list) -> dict:
    """Per forward, on the recorded calls of ``name``: the kernel without
    its epilogue, the same followed by the epilogue's torch ops, and the
    library pair (see the module docstring)."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.kernels import dequant

    kernel = getattr(dequant, name)

    def bare(a, k):
        return (torch.relu(a[0]),) + tuple(a[1:]) if k.get("relu_input") else tuple(a)

    def ops(y, k):
        return dequant._torch_epilogue(y, k.get("epilogue"), k.get("residual"))

    if name == "dequant_matmul":
        def library(x, w, k):
            return ops(torch.matmul(x, w), k)

        pairs = [(x, q.float() * s, k) for (x, q, s), k in args]
    else:
        def library(x_nchw, w_oihw, k):
            xin = torch.relu(x_nchw) if k.get("relu_input") else x_nchw
            return ops(F.conv2d(xin, w_oihw, padding=1).permute(0, 2, 3, 1), k)

        pairs = [(x.permute(0, 3, 1, 2),
                  (q.float() * s).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), k)
                 for (x, q, s), k in args]
    unfused = [bare(a, k) for a, k in args]
    unfused_ops = [lambda a=a, k=k: ops(kernel(*a), k) for a, (_, k) in zip(unfused, args)]
    lib = [lambda p=p: library(*p) for p in pairs]
    return {
        "unfused_ms_per_call": [_device_ms(torch, [lambda a=a: kernel(*a)], n=20) for a in unfused],
        "unfused_ms_per_forward": _device_ms(torch, [lambda a=a: kernel(*a) for a in unfused], n=10),
        "unfused_ops_ms_per_forward": _device_ms(torch, unfused_ops, n=10,
                                                 per_pass=_kernel_count(torch, unfused_ops)),
        "library_pair_ms_per_forward": _device_ms(torch, lib, n=10, per_pass=_kernel_count(torch, lib)),
    }


def _depthwise_stage(torch, stage: str, calls: dict) -> dict:
    """The depthwise stage's device time per forward on the recorded inputs
    (see the module docstring) and its kernel launches per forward."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.kernels import dequant

    if stage == DW_KERNEL:
        fns = [lambda a=a: dequant.dequant_dwconv3x3(*a) for a, _ in calls[stage]]
    else:
        # The parent's stage: torch.relu before each _sepconv (its x is the
        # ReLU's output, the same shape as its input), then F.pad and the
        # grouped conv of _sepconv; and the forward's one grouped expansion.
        def parent_stage(x, kernel):
            relu = torch.relu(x)
            kern = kernel.permute(3, 2, 0, 1)
            xc = F.pad(relu.permute(0, 3, 1, 2), (1, 1, 1, 1))
            return F.conv2d(xc, kern, groups=xc.shape[1])

        fns = [lambda x=x, k=k: parent_stage(x, k) for (x, k, _), _ in calls[stage]]
        fns += [lambda g=g: dequant.dequant_codes_group(g) for (g,), _ in calls["dequant_codes_group"]]
    launches = _kernel_count(torch, fns)
    return {"kind": stage, "calls": len(calls[stage]),
            "shapes": [tuple(a[0].shape) for a, _ in calls[stage]],
            "device_ms_per_forward": _device_ms(torch, fns, n=10, per_pass=launches),
            "launches_per_forward": launches}


def _kernel_count(torch, fns) -> int:
    """Kernel records of one pass over ``fns`` after a warm one: the most of
    3 windows (a window may lose records, never gain them)."""
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with card_profile() as prof:
            for fn in fns:
                fn()
        counts.append(sum(e.count for e in card_kernels(prof)))
    return max(counts)


def _bce_sums_run(torch) -> dict:
    """``bce_sums`` in this tree (see the module docstring)."""
    from fedcrack_tpu_torch.ops import bce

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for label, shape in BCE_SHAPES.items():
        x = torch.randn(shape, generator=gen, device="cuda") * 2.0
        y = (torch.rand(shape, generator=gen, device="cuda") > 0.7).to(torch.float32)
        out[label] = {"n": x.numel(),
                      "device_us_per_call": _device_ms(torch, [lambda: bce.bce_sums(x, y)], n=50) * 1e3,
                      "host_us_per_call": _host_us(torch, lambda: bce.bce_sums(x, y))}
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", required=True,
                        help="a checkout to run, in order (repeat it: parent, change, change, parent)")
    parser.add_argument("--out", default=None, help="write every run's numbers here as JSON")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print("AB_CONV " + json.dumps(run_tree()), flush=True)
        return 0
    runs = []
    for tree in args.tree:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "--tree", root],
                              cwd=root, env=env, capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB_CONV ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"ab_conv: the run in {tree} failed ({proc.returncode})")
        run = json.loads(line[0][len("AB_CONV "):])
        run["tree"] = tree
        runs.append(run)
        print(f"{tree}: conv {run['dequant_conv3x3']['device_ms_per_forward']:.4f} ms a forward "
              f"({run['dequant_conv3x3']['calls']} calls), matmul "
              f"{run['dequant_matmul']['device_ms_per_forward']:.4f} ms ({run['dequant_matmul']['calls']}; "
              f"e4m3 {run['dequant_matmul_e4m3']['device_ms_per_forward']:.4f}), "
              f"served batch: device busy {run['served_batch']['device_busy_ms']:.3f} ms, host p50 "
              f"{run['served_batch']['host_ms_p50']:.3f} ms, idle share {run['served_batch']['idle_share']:.3f}; "
              f"host µs a call: conv {[round(x, 1) for x in run['dequant_conv3x3']['host_us_per_call']]}, "
              f"matmul {[round(x, 1) for x in run['dequant_matmul']['host_us_per_call']]} "
              f"[{run['card']}]", flush=True)
        print(f"{tree}: matmul ms a call {[round(x, 5) for x in run['dequant_matmul']['device_ms_per_call']]}",
              flush=True)
        for lib, kernels in run["ptxas"].items():
            print(f"{tree}: ptxas {lib}: " + "; ".join(
                f"{k['kernel']} {k['registers']} regs, spills {k['spill_stores']}/{k['spill_loads']} B"
                for k in kernels), flush=True)
        for name in KERNELS:
            if "unfused_ms_per_forward" in run[name]:
                k = run[name]
                print(f"{tree}: {name} a forward: with epilogues {k['device_ms_per_forward']:.4f} ms, without "
                      f"{k['unfused_ms_per_forward']:.4f} ms, without and the torch ops after "
                      f"{k['unfused_ops_ms_per_forward']:.4f} ms, library and the torch ops "
                      f"{k['library_pair_ms_per_forward']:.4f} ms [{run['card']}]", flush=True)
                print(f"{tree}: {name} without its epilogue, ms a call "
                      f"{[round(x, 5) for x in k['unfused_ms_per_call']]}", flush=True)
        dw, batch = run["depthwise_stage"], run["served_batch"]
        print(f"{tree}: depthwise stage ({dw['kind']}, {dw['calls']} calls) {dw['device_ms_per_forward']:.4f} ms "
              f"a forward in {dw['launches_per_forward']} kernels; served batch {batch['launches_per_batch']:.1f} "
              f"kernels, device busy {batch['device_busy_ms']:.4f} ms, idle share {batch['idle_share']:.3f} "
              f"[{run['card']}]", flush=True)
        sums = run["bce_sums"]
        print(f"{tree}: bce_sums device µs a call " + ", ".join(
            f"{label} (n={sums[label]['n']}) {sums[label]['device_us_per_call']:.4f}, host "
            f"{sums[label]['host_us_per_call']:.1f}" for label in BCE_SHAPES) + f" [{run['card']}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
