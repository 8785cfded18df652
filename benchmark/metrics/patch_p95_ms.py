"""95th percentile of per-patch latency over every patch of the window,
host clock, from ``submit`` to the resolved future (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile([(r["end"] - r["start"]) * 1e3 for r in run.requests], 95))
