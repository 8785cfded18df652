"""Training images stepped per second: every whole round's images over
the window, staging, fold and round overhead included."""


def read(run):
    return sum(r["images"] for r in run.requests) / run.window_s
