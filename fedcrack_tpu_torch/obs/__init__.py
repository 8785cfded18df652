"""Observability (the counterpart of ``fedcrack_tpu.obs``): the JSONL
metrics sink with its TensorBoard tee, timing and profiler helpers, the
metric registry and its Prometheus endpoint, trace spans, the flight
recorder with its crash hooks, the leak sentries and the SLO watchdog
(``watchdog``), and ``flops.export_kernel_plane``. The rest of ``flops``
(the FLOPs model and an H100 peak) comes with the benchmark, ROADMAP
Queue 1 item 6."""

from fedcrack_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsLogger,
    profiler_trace,
    read_metrics,
    stopwatch,
)
from fedcrack_tpu_torch.obs.promexp import (  # noqa: F401
    MetricsExporter,
    parse_prometheus_text,
    scrape,
    start_exporter,
)
from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry  # noqa: F401
from fedcrack_tpu_torch.obs.sentries import LeakError, LeakSentry  # noqa: F401
from fedcrack_tpu_torch.obs.spans import SpanRecorder, read_spans, span  # noqa: F401
from fedcrack_tpu_torch.obs.tb import SummaryWriter, read_histograms, read_scalars  # noqa: F401
