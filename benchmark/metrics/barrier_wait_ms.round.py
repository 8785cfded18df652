"""Host milliseconds a round waits in the port's ``driver.barrier`` span
for the card to finish the round: the median over the steady rounds of
window (a) of ``benchmark/program_spans.py``."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None else spans["host"]["barrier_wait_ms"]
