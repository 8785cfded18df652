"""Serve-side input and prediction drift detection.

The counterpart of ``fedcrack_tpu.health.drift``. A :class:`DriftMonitor`
profiles served traffic per bucket: the input intensity histogram (and its
mean and std), the prediction confidence and entropy histograms, and the
contour-derived crack fraction of ``tools/quantify.py``. A live profile is
compared against a frozen reference (captured at install time by
:meth:`DriftMonitor.capture_reference`) by the population stability index

    PSI = sum_i (q_i - p_i) * ln(q_i / p_i)

over eps-smoothed fractions of fixed bins on [0, 1], so two profiles are
always comparable (< 0.1 stable, 0.1-0.25 drifting, > 0.25 shifted). Each
(bucket, signal) PSI is exported as the ``serve_drift_psi_ratio`` gauge.

Nothing here runs on the serving hot path: the monitor consumes answered
requests, or the probe batches the shadow controller pushes through the
engine. Counts and sums make accumulation order-independent and outputs
are rounded, so profiles are deterministic and equal to the JAX
package's on the same (images, probabilities). Without OpenCV the
crack_fraction signal is absent from profiles and comparisons, never a
fake zero.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping

import numpy as np

N_BINS = 10
_EDGES = np.linspace(0.0, 1.0, N_BINS + 1)
# Histogram signals a profile may carry (crack_fraction only with cv2).
SIGNALS = ("input", "confidence", "entropy", "crack_fraction")


def _hist(values: np.ndarray) -> list[int]:
    """Fixed-bin counts over [0, 1]; values are clipped in, so drift past
    the domain lands in the edge bins."""
    clipped = np.clip(np.asarray(values, np.float64).ravel(), 0.0, 1.0)
    counts, _ = np.histogram(clipped, bins=_EDGES)
    return [int(c) for c in counts]


def psi(ref_counts: Any, cur_counts: Any, eps: float = 1e-4) -> float:
    """Population stability index between two same-length count vectors,
    rounded to 6 places: both are normalized to sum 1 after adding ``eps``
    per bin, so an empty bin never divides by zero and PSI(x, x) == 0."""
    ref = np.asarray(ref_counts, np.float64)
    cur = np.asarray(cur_counts, np.float64)
    if ref.shape != cur.shape:
        raise ValueError(f"bin count mismatch: {ref.shape} vs {cur.shape}")
    p = (ref + eps) / float(np.sum(ref + eps))
    q = (cur + eps) / float(np.sum(cur + eps))
    return round(float(np.sum((q - p) * np.log(q / p))), 6)


def _crack_fractions(probs: np.ndarray) -> list[float] | None:
    """Per-image crack fraction through ``tools/quantify.quantify_mask``,
    or None when OpenCV is unavailable (the signal is then omitted)."""
    from fedcrack_tpu_torch.tools.quantify import quantify_mask

    out = []
    try:
        for img_probs in probs:
            mask_u8 = (np.clip(np.asarray(img_probs, np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)
            stats = quantify_mask(mask_u8[..., 0] if mask_u8.ndim == 3 else mask_u8)
            out.append(float(stats.crack_fraction))
    except ImportError:
        # quantify_mask imports cv2 lazily.
        return None
    return out


def signal_values(images_u8: np.ndarray, probs: np.ndarray) -> dict[str, np.ndarray]:
    """The values each histogram signal counts for one batch: per pixel
    ``input`` (uint8 / 255), ``confidence`` (max(p, 1 - p)) and
    ``entropy`` (Bernoulli, in units of ln 2), per image
    ``crack_fraction`` (absent without OpenCV). ``images_u8`` [B, S, S, 3]
    uint8, ``probs`` [B, S, S, 1] float."""
    x = np.asarray(images_u8).astype(np.float64) / 255.0
    pc = np.clip(np.asarray(probs, np.float32), 1e-7, 1.0 - 1e-7)
    out = {
        "input": x,
        "confidence": np.maximum(pc, 1.0 - pc),
        "entropy": -(pc * np.log(pc) + (1.0 - pc) * np.log(1.0 - pc)) / math.log(2.0),
    }
    fractions = _crack_fractions(np.asarray(probs, np.float32))
    if fractions is not None:
        out["crack_fraction"] = np.asarray(fractions)
    return out


class DriftMonitor:
    """Per-bucket traffic profiles, compared against a frozen reference.

    ``observe`` adds to plain Python ints and lists under no lock: call it
    from one consumer thread."""

    def __init__(self, reference: Mapping | None = None):
        self.reference = dict(reference) if reference else None
        self._buckets: dict[int, dict] = {}

    @staticmethod
    def _empty_bucket() -> dict:
        return {
            "n_images": 0,
            "input_sum": 0.0,
            "input_sumsq": 0.0,
            "input_n": 0,
            "hist": {s: [0] * N_BINS for s in SIGNALS if s != "crack_fraction"},
            "crack_hist": None,  # [0]*N_BINS once cv2 produced a sample
        }

    def observe(self, images_u8: np.ndarray, probs: np.ndarray) -> None:
        """Fold one answered batch into the live profile: ``images_u8``
        [B, S, S, 3] (or [S, S, 3]) uint8, ``probs`` [B, S, S, 1] (or
        [S, S, 1]) float probabilities; the bucket key is S."""
        images = np.asarray(images_u8)
        p = np.asarray(probs, np.float32)
        if images.ndim == 3:
            images = images[None]
        if p.ndim == 3:
            p = p[None]
        size = int(images.shape[1])
        b = self._buckets.setdefault(size, self._empty_bucket())
        values = signal_values(images, p)
        x = values["input"]
        b["n_images"] += int(images.shape[0])
        b["input_sum"] += float(np.sum(x))
        b["input_sumsq"] += float(np.sum(x * x))
        b["input_n"] += int(x.size)
        for signal in ("input", "confidence", "entropy"):
            counts = _hist(values[signal])
            b["hist"][signal] = [a + c for a, c in zip(b["hist"][signal], counts)]
        if "crack_fraction" in values:
            if b["crack_hist"] is None:
                b["crack_hist"] = [0] * N_BINS
            counts = _hist(values["crack_fraction"])
            b["crack_hist"] = [a + c for a, c in zip(b["crack_hist"], counts)]

    # ---- profiles ----

    def profile(self) -> dict:
        """The canonical (sorted, rounded) JSON-safe profile that PSI
        compares."""
        buckets = {}
        for size in sorted(self._buckets):
            b = self._buckets[size]
            n = max(1, b["input_n"])
            mean = b["input_sum"] / n
            var = max(0.0, b["input_sumsq"] / n - mean * mean)
            hist = {s: list(b["hist"][s]) for s in sorted(b["hist"])}
            if b["crack_hist"] is not None:
                hist["crack_fraction"] = list(b["crack_hist"])
            buckets[str(size)] = {
                "n_images": b["n_images"],
                "input_mean": round(mean, 6),
                "input_std": round(math.sqrt(var), 6),
                "hist": hist,
            }
        return {"bins": N_BINS, "buckets": buckets}

    @classmethod
    def capture_reference(
        cls, engine: Any, device_variables: Any, *, n: int | None = None, seed: int | None = None,
    ) -> dict:
        """The frozen install-time reference: the seeded probe set (the
        quant gate's and the canary's) through ``engine`` at every bucket
        size, profiled once. A function of (weights, seed)."""
        from fedcrack_tpu_torch.serve.quant import probe_images

        cfg = engine.serve_config
        n = cfg.quant_probe_batch if n is None else int(n)
        seed = cfg.quant_probe_seed if seed is None else int(seed)
        monitor = cls()
        for size in engine.bucket_sizes:
            batch = probe_images(size, min(n, engine.max_batch), seed)
            monitor.observe(batch, engine.predict_bucket(device_variables, batch))
        return monitor.profile()

    def compare(self, reference: Mapping | None = None) -> dict:
        """``{'<bucket>/<signal>': psi}`` of the live profile against the
        reference, over the (bucket, signal) pairs present in both:
        missing traffic or a missing crack signal is absence, not drift."""
        ref = reference if reference is not None else self.reference
        if not ref:
            return {}
        current = self.profile()
        out: dict[str, float] = {}
        for size in sorted(current["buckets"]):
            if size not in ref.get("buckets", {}):
                continue
            cur_hist = current["buckets"][size]["hist"]
            ref_hist = ref["buckets"][size]["hist"]
            for signal in sorted(set(cur_hist) & set(ref_hist)):
                out[f"{size}/{signal}"] = psi(ref_hist[signal], cur_hist[signal])
        return out


def export_drift_metrics(psis: Mapping[str, float], registry=None) -> None:
    """One ``serve_drift_psi_ratio`` gauge child per (bucket, signal)."""
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    gauge = reg.gauge(
        "serve_drift_psi_ratio",
        "population stability index of live serve traffic vs the frozen "
        "install-time reference profile, per (bucket, signal); < 0.1 "
        "stable, > 0.25 shifted",
        labels=("bucket", "signal"),
    )
    for key in sorted(psis):
        bucket, signal = key.split("/", 1)
        gauge.labels(bucket=bucket, signal=signal).set(float(psis[key]))


def write_drift_json(
    path: str, *, reference: Mapping | None, current: Mapping | None, psis: Mapping[str, float] | None,
) -> None:
    """Reference, live profile and comparison in one deterministic JSON
    document (sorted keys, no timestamps): the JAX package's bytes."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    doc = {
        "reference": dict(reference) if reference else None,
        "current": dict(current) if current else None,
        "psi": {k: float(v) for k, v in (psis or {}).items()},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
