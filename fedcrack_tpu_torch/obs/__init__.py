"""Observability (the counterpart of ``fedcrack_tpu.obs``): the JSONL
metrics sink with its TensorBoard tee, timing and profiler helpers, the
metric registry and its Prometheus endpoint, trace spans, the flight
recorder with its crash hooks, the leak sentries, the SLO watchdog
(``watchdog``), and ``flops``: the FLOPs model, the H100's peak and MFU,
and the kernel-plane gauge."""

from fedcrack_tpu_torch.obs.flops import (  # noqa: F401
    device_peak_flops,
    mfu,
    resunet_forward_flops,
    train_step_flops,
)
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
