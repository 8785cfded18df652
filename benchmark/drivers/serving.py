"""What the drivers share: seeds and widths; for serving, the served
program, the callers' seeded orders, closed-loop callers and the profiled
sub-window's launch check."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

from benchmark import trace
from benchmark.inputs.weights import draw_variables, snap_to_int8_grid

# The port's launch counters checked against the profiler's records.
COUNTED = ("dequant_matmul", "dequant_conv3x3", "dequant_dwconv3x3")


def sub_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + k) % (1 << 63)


def widths(config: dict) -> dict:
    m = config["model"]
    return {k: m[k] for k in ("stem_features", "encoder_features", "decoder_features", "in_channels",
                              "num_classes")}


def build(ctx) -> dict:
    """The engine and its placed quantized weights, from the seed's
    weights snapped to the int8 grid (kept: the reference reads them)."""
    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.quant import quantize_for_plane

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    engine = InferenceEngine(ModelConfig(**fields(ctx.config["model"])), ServeConfig(**fields(ctx.config["serve"])),
                             device=ctx.device)
    weights = snap_to_int8_grid(draw_variables(ctx.seed, widths(ctx.config), ctx.device))
    payload = engine.prepare_quantized(quantize_for_plane(weights, engine.kernel_plane))
    return {"engine": engine, "payload": payload, "weights": weights,
            "tile": max(engine.bucket_sizes), "lanes": engine.max_batch}


def caller_orders(ctx, pool: int) -> list:
    """Each caller's seeded sequence of pool indices."""
    return [np.random.default_rng([ctx.seed % (1 << 63), 2, i]).integers(0, pool, 1 << 16)
            for i in range(ctx.traffic["callers"])]


def checked_requests(ctx) -> list[set]:
    """Each caller's seeded sample of ``check_per_caller`` of its first
    ``check_within`` requests, whose answers the reference checks."""
    p = ctx.traffic
    return [set(np.random.default_rng([ctx.seed % (1 << 63), 3, i]).choice(
        p["check_within"], p["check_per_caller"], replace=False).tolist()) for i in range(p["callers"])]


def in_threads(callers: int, body) -> None:
    """``body(caller)`` in one thread a caller, all joined."""
    threads = [threading.Thread(target=body, args=(i,)) for i in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def closed_loop(callers: int, seconds: float, request) -> tuple[list, int, int, float]:
    """``callers`` threads each calling ``request(caller, k)`` for its
    k-th request until ``seconds`` have passed since the start; the
    requests in flight then finish. Returns the records the calls
    returned, the attempted and failed counts and the window's seconds
    (start to the last completion)."""
    records: list = []
    counts = {"attempted": 0, "failed": 0}
    lock = threading.Lock()
    t_start = time.perf_counter()
    stop_at = t_start + seconds

    def loop(i):
        k = 0
        while time.perf_counter() < stop_at:
            with lock:
                counts["attempted"] += 1
            try:
                rec = request(i, k)
            except Exception as e:  # a failed request counts; the caller goes on
                with lock:
                    counts["failed"] += 1
                    if counts["failed"] == 1:
                        print(f"request failed: {e!r}", file=sys.stderr)
            else:
                with lock:
                    records.append(rec)
            k += 1

    threads = [threading.Thread(target=loop, args=(i,), daemon=True) for i in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_end = max([r["end"] for r in records], default=time.perf_counter())
    return records, counts["attempted"], counts["failed"], t_end - t_start


def profile_forwards(engine, body, attempts: int = 4) -> dict:
    """Run ``body`` in a profiled sub-window until the profiler kept a
    record of every launch the port counted, then once more with the
    host's ops recorded to name the idle gaps. Returns the trace and the
    forwards and lanes the first ran."""
    from fedcrack_tpu_torch.kernels import dequant

    counters = [(n, getattr(dequant, n)) for n in COUNTED if hasattr(getattr(dequant, n, None), "launches")]
    for _ in range(attempts):
        before = {n: w.launches for n, w in counters}
        f0 = engine.quantized_forwards
        with trace.profiled() as holder:
            body()
        t = holder.trace
        launched = {n: w.launches - before[n] for n, w in counters}
        if t is not None and all(t.count_matching(n + "_kernel") == launched[n] for n, _ in counters):
            forwards = engine.quantized_forwards - f0
            t.gaps = trace.host_named_gaps(body)
            return {"trace": t, "forwards": forwards, "lanes": engine.max_batch, "launches": launched}
        kept = "no window" if t is None else [t.count_matching(n + "_kernel") for n, _ in counters]
        print(f"profiled window kept {kept} of {list(launched.values())} launches; retaking it", file=sys.stderr)
    raise RuntimeError("the profiler lost kernel records in every retake of the sub-window")
