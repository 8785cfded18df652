"""Device milliseconds a train step in elementwise and BatchNorm kernels
over the profiled rounds."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * run.trace.seconds_in("elementwise", "batch_norm") / run.profiled["steps"]
