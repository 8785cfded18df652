"""Megapixels of requested images segmented per second: every completed
request's pixels over the whole window."""


def read(run):
    return sum(r["pixels"] for r in run.requests) / run.window_s / 1e6
