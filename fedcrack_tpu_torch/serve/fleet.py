"""The install-time quant decision of the serve fleet.

Of ``fedcrack_tpu.serve.fleet`` only the quant-gated payload preparation
is ported (the router, replicas and autoscaler come later): quantize for
the engine's kernel plane, run the quant gate against the
reference program, and on refusal log loudly and keep the reference
program, never a silent accuracy cliff.
"""

from __future__ import annotations

import logging
from typing import Any

from fedcrack_tpu_torch.serve import quant as quant_mod

log = logging.getLogger("fedcrack_torch.serve.fleet")


def prepare_gated_payload(
    engine: Any, host_variables: Any, serve_config: Any
) -> tuple[Any, quant_mod.QuantGateResult | None]:
    """``(payload, gate)`` for installing ``host_variables``: the placed
    quantized weights when ``serve_config.quant == "int8"`` and the gate
    passes, else the placed reference program; ``gate`` is None when no
    quantized build was asked for. The gate's knobs come from
    ``serve_config`` (the deployment's), not from the engine's."""
    reference = engine.prepare(host_variables)
    if serve_config.quant != "int8":
        return reference, None
    plane = engine.kernel_plane
    quantized = engine.prepare_quantized(
        quant_mod.quantize_for_plane(host_variables, plane)
    )
    gate = quant_mod.quant_gate(
        engine,
        reference,
        quantized,
        floor=serve_config.quant_iou_floor,
        probe_batch=serve_config.quant_probe_batch,
        probe_seed=serve_config.quant_probe_seed,
    )
    if not gate.passed:
        log.error(
            "quantized build (kernel_plane=%s) REFUSED: probe mask IoU %.4f "
            "< floor %.4f; serving the reference program",
            plane,
            gate.iou,
            gate.floor,
        )
        return reference, gate
    return quantized, gate
