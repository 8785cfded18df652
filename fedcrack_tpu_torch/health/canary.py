"""Canary evaluation of installed global versions.

The counterpart of ``fedcrack_tpu.health.canary``. Every hot swap installs
weights the serving path then trusts completely; the canary is the quality
check that runs off that path, against the seeded probe set the int8 quant
gate uses (``serve/quant.py``): synthetic crack batches at every bucket
size, masks compared by IoU.

The reference is the first version an evaluator sees; every later
version's probe masks are compared with the reference's, and the minimum
over buckets is the ``model_canary_iou_ratio`` gauge. A flush that drags
the global average shows here as an IoU cliff even when every update
passed sanitation.

Contract with the swap path: the version managers call :meth:`evaluate`
from their poll thread after the pointer flip, and a raising canary never
fails or blocks an install. The probes run the engine's own programs on
the engine's device, so on a quantized fleet every probe of the production
payload is a fused forward through the dequant kernels.
"""

from __future__ import annotations

import logging
from typing import Any

from fedcrack_tpu_torch.obs import flight
from fedcrack_tpu_torch.obs import spans as tracing
from fedcrack_tpu_torch.obs.registry import REGISTRY

log = logging.getLogger("fedcrack_torch.health.canary")


class CanaryEvaluator:
    """Seeded probe-set IoU across installed versions.

    Deterministic: the probe batches are seeded, buckets go in the
    engine's order, and the reference is the version evaluated first. Not
    safe against concurrent ``evaluate`` calls: one poll thread calls it.
    """

    def __init__(
        self,
        engine: Any,
        *,
        probe_batch: int | None = None,
        probe_seed: int | None = None,
        history_cap: int = 256,
        registry: Any = None,
        metrics: Any = None,
    ):
        cfg = engine.serve_config
        self.engine = engine
        self.probe_batch = cfg.quant_probe_batch if probe_batch is None else int(probe_batch)
        self.probe_seed = cfg.quant_probe_seed if probe_seed is None else int(probe_seed)
        self._history_cap = history_cap
        self._registry = registry if registry is not None else REGISTRY
        self._metrics = metrics
        self.reference_version: int | None = None
        self._reference_probs: dict[int, Any] = {}
        self.history: list[dict] = []
        self.last: dict | None = None

    def evaluate(self, version: int, device_variables: Any) -> dict:
        """Probe one installed version (its placed payload, a ``ResUNet``
        or ``QuantizedVariables``) against the reference. Appends the
        record to ``history``, sets the gauge, emits a ``health.canary``
        span joined to the version's flush lineage and a flight note, and
        returns the record."""
        from fedcrack_tpu_torch.serve.quant import mask_iou, probe_images

        version = int(version)
        fctx = tracing.flush_context(version)
        with tracing.span(
            "health.canary", trace=fctx.trace, remote_parent=fctx.to_wire(), version=version,
        ) as span_handle:
            per_bucket: dict[int, float] = {}
            is_reference = self.reference_version is None
            for size in self.engine.bucket_sizes:
                batch = probe_images(size, min(self.probe_batch, self.engine.max_batch), self.probe_seed)
                probs = self.engine.predict_bucket(device_variables, batch)
                if is_reference:
                    self._reference_probs[size] = probs
                    per_bucket[size] = 1.0
                else:
                    per_bucket[size] = mask_iou(self._reference_probs[size], probs)
            if is_reference:
                self.reference_version = version
            iou = min(per_bucket.values())
            if span_handle is not None:
                span_handle.set(iou=round(iou, 6), reference=is_reference)
        self._registry.gauge(
            "model_canary_iou_ratio",
            "min-over-buckets mask IoU of the installed global version vs "
            "the pinned canary reference on the seeded probe set (1.0 = "
            "identical masks)",
        ).set(iou)
        record = {
            "version": version,
            "iou": round(iou, 6),
            "per_bucket": {str(k): round(v, 6) for k, v in per_bucket.items()},
            "reference_version": int(self.reference_version),
            "probe_batch": self.probe_batch,
            "probe_seed": self.probe_seed,
        }
        self.history.append(record)
        del self.history[: max(0, len(self.history) - self._history_cap)]
        self.last = record
        flight.note(
            "health.canary", version=version, iou=record["iou"],
            reference_version=record["reference_version"],
        )
        if self._metrics is not None:
            self._metrics.log("canary_eval", **record)
        log.info("canary eval v%d: iou=%.4f (reference v%d)", version, iou, self.reference_version)
        return record

    def audit(self) -> dict:
        """Every evaluation finite in [0, 1] (not an IoU floor: thresholds
        belong to the rules an operator arms)."""
        ious = [h["iou"] for h in self.history]
        return {
            "evals": len(self.history),
            "reference_version": self.reference_version,
            "min_iou": min(ious) if ious else None,
            "all_finite_unit": all(0.0 <= i <= 1.0 for i in ious),
        }
