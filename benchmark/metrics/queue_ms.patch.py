"""The mean of ``PredictResult.queue_ms`` over every patch of the window:
the wait from ``submit`` to the batch's dispatch."""


def read(run):
    return sum(r["queue_ms"] for r in run.requests) / len(run.requests) if run.requests else None
