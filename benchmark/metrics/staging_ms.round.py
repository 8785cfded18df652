"""Host milliseconds a round spends in the port's ``driver.stage`` span:
the next round's data function, its pinned copy and the host-to-device
copy until it has landed, overlapped with the round's own steps. The
median over the steady rounds of window (a) of
``benchmark/program_spans.py``."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None else spans["host"]["staging_ms"]
