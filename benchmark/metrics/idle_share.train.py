"""Share of the profiled sub-window in which no kernel or copy ran on
the card, in percent."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
