"""Closed-loop callers sending single patches to ``MicroBatcher.submit``.

Each caller is a thread that submits one bucket-sized patch and waits for
its future before it sends the next, as a robot or a drone stream does.
The patches are a pool made in set-up from the seed; each caller draws
from it in a seeded order. The answers checked are a seeded sample of
each caller's first ``check_within`` requests.

Traffic parameters: ``callers``, ``pool``, ``size``, ``check_per_caller``,
``check_within``, ``profile_per_caller``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.drivers import serving
from benchmark.inputs.images import crack_images
from benchmark.reference import resunet


def setup(ctx) -> dict:
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

    state = serving.build(ctx)
    p = ctx.traffic
    imgs, _ = crack_images(p["pool"], p["size"], p["size"], serving.sub_seed(ctx.seed, 200), ctx.device)
    state["patches"] = list(imgs.cpu().numpy())
    state["orders"] = serving.caller_orders(ctx, p["pool"])
    state["check"] = serving.checked_requests(ctx)
    state["batcher"] = batcher = MicroBatcher(state["engine"], StaticWeights(state["payload"]))
    # Warm-up at the window's own concurrency: one patch a caller.
    futures = [batcher.submit(state["patches"][i % p["pool"]]) for i in range(p["callers"])]
    for f in futures:
        f.result()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return state


def window(ctx, state, seconds: float, observe: bool) -> dict:
    engine, batcher, patches = state["engine"], state["batcher"], state["patches"]
    p = ctx.traffic
    kept = []
    lanes = {"real": 0, "computed": 0}
    if observe:
        # Lanes that carried a request against lanes computed.
        bucket = engine.predict_bucket
        lock = threading.Lock()

        def counted_bucket(variables, images):
            with lock:
                lanes["real"] += images.shape[0]
                lanes["computed"] += engine.max_batch
            return bucket(variables, images)

        engine.predict_bucket = counted_bucket

    def request(i, k):
        idx = int(state["orders"][i][k % len(state["orders"][i])])
        t0 = time.perf_counter()
        res = batcher.submit(patches[idx]).result()
        t1 = time.perf_counter()
        if k in state["check"][i]:
            kept.append((idx, res.probs))
        return {"start": t0, "end": t1, "pixels": p["size"] * p["size"], "tiles": 1, "queue_ms": res.queue_ms}

    try:
        records, attempted, failed, window_s = serving.closed_loop(p["callers"], seconds, request)
    finally:
        engine.__dict__.pop("predict_bucket", None)
    state["kept"] = kept
    return {"requests": records, "attempted": attempted, "failed": failed, "window_s": window_s,
            "observed": {"lanes": lanes}}


def profile(ctx, state) -> dict:
    batcher, patches = state["batcher"], state["patches"]

    def caller(i):
        for k in range(ctx.traffic["profile_per_caller"]):
            batcher.submit(patches[int(state["orders"][i][k])]).result()

    return serving.profile_forwards(state["engine"], lambda: serving.in_threads(ctx.traffic["callers"], caller))


def release(state) -> None:
    batcher = state.pop("batcher", None)
    if batcher is not None:
        batcher.close()
    state.pop("engine", None)
    state.pop("payload", None)


def compare(ctx, state, control: bool = False) -> list:
    """The widest gap between a checked patch's served probabilities and
    the reference's (with ``control``, the reference computed in TF32 in
    the program's place)."""
    from benchmark.harness import Check

    ids = sorted({idx for idx, _ in state["kept"]})
    batch = torch.from_numpy(np.stack([state["patches"][i] for i in ids])).to(ctx.device) if ids else None
    gap = float("inf")
    if ids:
        ref = dict(zip(ids, resunet.probabilities(state["weights"], batch)))
        if control:
            got = dict(zip(ids, resunet.probabilities(state["weights"], batch, tf32=True)))
        gap = 0.0
        for idx, out in state["kept"]:
            g = got[idx] if control else torch.from_numpy(np.ascontiguousarray(out)).to(ctx.device)
            gap = max(gap, float((g - ref[idx]).abs().max()))
    return [Check("max_prob_gap", gap, ctx.limits["max_prob_gap"])]
