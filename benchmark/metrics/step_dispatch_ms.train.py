"""Host milliseconds a train step spends in the port's ``train.forward``,
``train.backward`` and ``train.optimizer`` spans: the step's eager
dispatch. The median over the steady rounds of window (a) of
``benchmark/program_spans.py`` of each round's mean a step."""

from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return None if spans is None else spans["host"]["step_dispatch_ms"]
