"""Device milliseconds a train step in convolution kernels (cuDNN's
forward, data- and weight-gradient kernels) over the profiled rounds."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * run.trace.seconds_in("convolution") / run.profiled["steps"]
