"""``dequant_matmul_kernel``'s share of its roofline: the least time of
the forward's 15 GEMMs (``benchmark/counts/layers.py``) over the
profiled forwards, against the device time of the kernels of that name,
in percent."""

from benchmark.counts.layers import launches, least_seconds

FAMILY = "dequant_matmul"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_matching(FAMILY + "_kernel")
    if seconds <= 0.0:
        return None
    tile = max(run.config["serve"]["bucket_sizes"])
    work = launches(run.config["model"], tile, run.profiled["lanes"])[FAMILY]
    return 100.0 * least_seconds(work) * run.profiled["forwards"] / seconds
