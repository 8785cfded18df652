"""Share of window (b) of ``benchmark/program_spans.py`` (its steady
rounds, spanned and device-profiled) in which the card is idle while the
host is under no span or in ``driver.round``'s own time: the idle the
spans cannot name, in percent."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None or spans["device"] is None else spans["device"]["idle_unspanned_share"]
