"""Host milliseconds a round spends in the port's ``mesh.slot_init`` and
``mesh.fold`` spans (eight slots' weight loads and fresh Adam, and their
folds): the median over the steady rounds of window (a) of
``benchmark/program_spans.py``."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None else spans["host"]["slot_ms"]
