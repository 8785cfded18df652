"""Which kernel plane answers quantized traffic, as a scrapeable gauge.

Of ``fedcrack_tpu.obs.flops`` only :func:`export_kernel_plane` is ported:
the FLOPs model and MFU accounting there count the TPU's MXU and have no
H100 counterpart yet (ROADMAP Queue 1 item 6, the benchmark).
"""

from __future__ import annotations


def export_kernel_plane(effective: str, *, requested: str | None = None, registry=None) -> None:
    """Export the ``serve_kernel_plane_info`` labeled gauge (the Prometheus
    info-metric idiom: constant 1, state in the labels). ``requested`` is
    the ``ServeConfig.kernel_plane`` asked for; earlier states' series drop
    to 0 so exactly one ``plane`` reads 1. The port never degrades a plane
    (torch has e4m3 on every device), so the two labels agree."""
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    fam = reg.gauge(
        "serve_kernel_plane_info",
        "which quantized-predict kernel plane answers quantized traffic "
        "(constant-1 info gauge; plane=effective program body, "
        "requested=the ServeConfig ask)",
        labels=("plane", "requested"),
    )
    req = requested if requested is not None else effective
    for key, child in fam._series():
        if key != (effective, req):
            child.set(0)
    fam.labels(plane=effective, requested=req).set(1)
