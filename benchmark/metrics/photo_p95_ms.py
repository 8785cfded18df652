"""95th percentile of per-photo latency over every photo of the window,
host clock, from the call to the blended map (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile([(r["end"] - r["start"]) * 1e3 for r in run.requests], 95))
