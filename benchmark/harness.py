"""The benchmark's engine: one cell run once, driven by data.

``BENCHMARK.json`` at the root names the cells. A cell names a
configuration and a traffic mix; the harness finds each by its name:

- ``benchmark/configs/<config>.json``: the fields the port's dataclasses
  take, with the configuration's source and what was cut;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters and the
  ``driver`` that runs it, ``benchmark/drivers/<driver>.py``;
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
- ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  returning the metric's value or None where the run holds nothing for it.

A driver module has ``setup(ctx)``, ``window(ctx, state, seconds,
observe)``, ``profile(ctx, state)``, ``release(state)`` and
``compare(ctx, state, control=False)``. A later change adds a cell, a mix,
a configuration or a metric by adding files and entries only.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fedcrack_tpu")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(path: str):
    name = "benchmark_" + os.path.relpath(path, ROOT).replace(os.sep, "_").replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Check:
    """One number the correctness check compares, with its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    root: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: str
    setup_s: float
    window_s: float
    requests: list            # per request: {"start", "end", "pixels", "tiles", ...}
    observed: dict            # the benchmark's own spans and counts (traced runs)
    trace: object             # benchmark.trace.Trace of the profiled sub-window, or None
    profiled: dict            # what the sub-window ran: forwards, lanes, steps ...
    config: dict
    traffic: dict


def context(root: str, workload: str, seed: int, device) -> Context:
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root, configs[cell["config"]]["file"])
    traffic = _json(root, "benchmark", "traffic", cell["traffic"] + ".json")
    limits = _json(root, "benchmark", "limits", workload + ".json")
    return Context(root, cell, config, traffic, limits, seed, device)


def driver(ctx: Context):
    return load_module(os.path.join(ctx.root, "benchmark", "drivers", ctx.traffic["driver"] + ".py"))


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones; a metric without ``workloads`` is every cell's."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the benchmark measures the port on the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA cards, {torch.cuda.device_count()} are visible")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def device_info(device, chips: int, trace) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
                "power_limit": power_limit()}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> tuple[dict, list[Check], list[Check]]:
    """Set up, measure, trace and check one cell. Returns the result
    line's object, the checks and, with ``control``, the same checks with
    the control in the program's place."""
    import torch

    ctx = context(root, workload, seed, device)
    drv = driver(ctx)
    state = drv.setup(ctx)
    setup_s = time.perf_counter() - t0
    win = drv.window(ctx, state, seconds, trace)
    prof = drv.profile(ctx, state) if trace else {"trace": None}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    info = device_info(device, ctx.cell["chips"], prof["trace"])
    drv.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.compare(ctx, state)
    controls = drv.compare(ctx, state, control=True) if control else []
    run = Run(workload, setup_s, win["window_s"], win["requests"], win.get("observed", {}), prof["trace"],
              prof, ctx.config, ctx.traffic)
    metrics = {}
    for m in cell_metrics(load_spec(root), workload, trace):
        value = load_module(os.path.join(root, "benchmark", "metrics", m["name"] + ".py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": win["failed"] == 0 and win["attempted"] > 0 and all(c.ok for c in checks),
        "attempted": win["attempted"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": info,
    }
    if prof["trace"] is not None:
        result["breakdown"] = {"device_ops": prof["trace"].top_ops(),
                               "idle_gaps": [[name, s] for name, s in prof["trace"].gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks, controls
