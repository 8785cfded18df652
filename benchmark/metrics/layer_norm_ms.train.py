"""Device milliseconds a train step in LayerNorm kernels, forward and
backward, over the profiled rounds: the kernels whose names, in lower
case, hold one of ``NEEDLES`` (PyTorch's ``vectorized_layer_norm_kernel``,
``layer_norm_grad_input_kernel`` and ``GammaBetaBackward`` kernels, and
the ``RowwiseMoments`` / ``LayerNormForward`` pair it takes on rows it
cannot vectorize)."""

NEEDLES = ("layer_norm", "layernorm", "gammabeta", "rowwisemoments")


def read(run):
    if run.trace is None:
        return None
    seconds = sum(v[0] for k, v in run.trace.by_name.items() if any(n in k.lower() for n in NEEDLES))
    return 1e3 * seconds / run.profiled["steps"]
