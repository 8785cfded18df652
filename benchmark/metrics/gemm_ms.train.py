"""Device milliseconds a train step in matrix-product kernels (the
``gemm`` category: cuBLAS's and CUTLASS's GEMMs, the Linear layers and the
attention's two batched products) over the profiled rounds."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * run.trace.seconds_in("gemm") / run.profiled["steps"]
