"""The engine's host time per photo (tiling, stacking, blending):
``predict_image``'s wall less its ``predict_bucket`` calls' walls, the
mean over the window's photos, timed around the calls by the benchmark."""


def read(run):
    ms = run.observed.get("engine_host_ms")
    return sum(ms) / len(ms) if ms else None
