"""Set-up: process start to the first timed request (loading, weights,
inputs, quantization, kernel builds in a checkout's first run, warm-up)."""


def read(run):
    return run.setup_s
