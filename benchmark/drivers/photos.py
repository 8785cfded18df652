"""Closed-loop callers sending whole photos to ``InferenceEngine.predict_image``.

Each caller is a thread, as the serve plane's front door runs a tiled
request in a worker thread, and sends its next photo when the last one's
blended map is back. The photos are a pool made in set-up from the seed,
half in each orientation of ``shapes`` in a seeded order; each caller
draws its photos from the pool in a seeded order. The window's answers
checked are a seeded sample of each caller's first ``check_within``
requests.

Traffic parameters: ``callers``, ``pool``, ``shapes`` ([H, W] pairs),
``check_per_caller``, ``check_within``, ``profile_per_caller``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.drivers import serving
from benchmark.inputs.images import crack_images
from benchmark.reference import tiles


def _pool(ctx) -> list:
    p = ctx.traffic
    per_shape = p["pool"] // len(p["shapes"])
    photos = []
    for j, (h, w) in enumerate(p["shapes"]):
        imgs, _ = crack_images(per_shape, h, w, serving.sub_seed(ctx.seed, 100 + j), ctx.device)
        photos += list(imgs.cpu().numpy())
    order = np.random.default_rng([ctx.seed % (1 << 63), 1]).permutation(len(photos))
    return [photos[i] for i in order]


def setup(ctx) -> dict:
    state = serving.build(ctx)
    photos = state["photos"] = _pool(ctx)
    state["orders"] = serving.caller_orders(ctx, len(photos))
    state["check"] = serving.checked_requests(ctx)
    engine, payload = state["engine"], state["payload"]
    # Warm-up at the window's own concurrency and shapes: one photo a caller.
    serving.in_threads(ctx.traffic["callers"], lambda i: engine.predict_image(payload, photos[i % len(photos)]))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return state


def window(ctx, state, seconds: float, observe: bool) -> dict:
    engine, payload, photos = state["engine"], state["payload"], state["photos"]
    p = ctx.traffic
    kept = []
    host_ms = []
    predict = engine.predict_image
    if observe:
        # The engine's own host work per photo (tiling, stacking, blending):
        # predict_image's wall less its predict_bucket calls' walls.
        local = threading.local()
        bucket = engine.predict_bucket

        def timed_bucket(variables, images):
            t = time.perf_counter()
            try:
                return bucket(variables, images)
            finally:
                local.inner += time.perf_counter() - t

        engine.predict_bucket = timed_bucket

        def predict(variables, photo):
            local.inner = 0.0
            t = time.perf_counter()
            out = engine.predict_image(variables, photo)
            host_ms.append((time.perf_counter() - t - local.inner) * 1e3)
            return out

    def request(i, k):
        idx = int(state["orders"][i][k % len(state["orders"][i])])
        photo = photos[idx]
        t0 = time.perf_counter()
        out = predict(payload, photo)
        t1 = time.perf_counter()
        if k in state["check"][i]:
            kept.append((idx, out))
        h, w, _ = photo.shape
        return {"start": t0, "end": t1, "pixels": h * w, "tiles": tiles.tile_count(h, w, state["tile"],
                                                                                     engine.serve_config.tile_overlap)}

    try:
        records, attempted, failed, window_s = serving.closed_loop(p["callers"], seconds, request)
    finally:
        engine.__dict__.pop("predict_bucket", None)
    state["kept"] = kept
    return {"requests": records, "attempted": attempted, "failed": failed, "window_s": window_s,
            "observed": {"engine_host_ms": host_ms}}


def profile(ctx, state) -> dict:
    engine, payload, photos = state["engine"], state["payload"], state["photos"]

    def caller(i):
        for k in range(ctx.traffic["profile_per_caller"]):
            engine.predict_image(payload, photos[int(state["orders"][i][k])])

    return serving.profile_forwards(engine, lambda: serving.in_threads(ctx.traffic["callers"], caller))


def release(state) -> None:
    state.pop("engine", None)
    state.pop("payload", None)


def compare(ctx, state, control: bool = False) -> list:
    """The widest gap between a checked photo's served map and the
    reference's map of the same photo (with ``control``, the reference
    computed in TF32 in the program's place)."""
    from benchmark.harness import Check

    serve = ctx.config["serve"]
    tile, overlap = max(serve["bucket_sizes"]), serve["tile_overlap"]
    weights, pool = state["weights"], state["photos"]
    refs, controls = {}, {}
    gap = 0.0
    for idx, out in state["kept"]:
        if idx not in refs:
            photo = torch.from_numpy(pool[idx]).to(ctx.device)
            refs[idx] = tiles.photo_probabilities(weights, photo, tile, overlap)
            if control:
                controls[idx] = tiles.photo_probabilities(weights, photo, tile, overlap, tf32=True)
        got = controls[idx] if control else torch.from_numpy(np.ascontiguousarray(out)).to(ctx.device)
        gap = max(gap, float((got - refs[idx]).abs().max()))
    if not state["kept"]:
        gap = float("inf")
    return [Check("max_prob_gap", gap, ctx.limits["max_prob_gap"])]
