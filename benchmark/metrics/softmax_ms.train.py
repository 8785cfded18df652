"""Device milliseconds a train step in kernels whose names hold
``softmax`` in any case (the attention's softmax, forward and backward)
over the profiled rounds."""


def read(run):
    if run.trace is None:
        return None
    seconds = sum(v[0] for k, v in run.trace.by_name.items() if "softmax" in k.lower())
    return 1e3 * seconds / run.profiled["steps"]
