"""Host milliseconds a round spends in the port's ``data.pin`` spans, the
copy of the next round's slab into pinned memory inside its staging: the
median over the steady rounds of window (a) of
``benchmark/program_spans.py``."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None else spans["host"]["pin_ms"]
