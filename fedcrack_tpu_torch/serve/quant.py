"""Post-training weight quantization for the serve plane, and its gate.

Weight-only, per-channel symmetric: every params leaf with a channel axis
(ndim >= 2) becomes 1-byte codes plus one float32 scale per output channel
(the LAST axis; flax kernels are HWIO), computed from the weights alone:
``scale = max|w| / 127`` for int8 codes (``np.rint``, half to even, clipped
to +-127) and ``max|w| / 448`` for fp8 e4m3 codes (``torch.float8_e4m3fn``,
round to nearest even). All-zero channels get scale 1.0. Biases, BatchNorm
affines and statistics stay float32. The codes and scales are bit-equal to
the JAX package's ``quantize_variables`` / ``quantize_variables_fp8``
(tests/test_torch_quant.py compares the uint8 views).

The tree keeps the flax layout and holds tensors (numpy has no fp8 type).

The install-time gate (:func:`quant_gate`) runs the quantized program and
the reference program over a seeded probe batch at every bucket size; the
worst per-bucket mask IoU must reach ``ServeConfig.quant_iou_floor``, or
the install is refused and the reference program keeps serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_leaves

QKEY, SKEY = "int8_code", "scale"
QKEY_FP8 = "fp8_code"

# e4m3's largest finite magnitude: the symmetric-scale analog of int8's 127.
FP8_E4M3_MAX = 448.0


class QuantizedVariables:
    """Marker wrapper around a quantized variables tree: the engine routes a
    weights snapshot on its type (quantized program vs reference program).
    ``depthwise``: the fused forward's depthwise codes as a prepared
    ``kernels.dequant.CodeGroup``, and ``epilogues``: its launches'
    epilogues as a ``kernels.forward.EpiloguePlan``
    (``InferenceEngine.prepare_quantized`` builds both beside the placed
    tree of a fused plane; the forward checks that they hold this tree's
    own tensors), else None."""

    def __init__(self, tree: Any, depthwise: Any = None, epilogues: Any = None):
        self.tree = tree
        self.depthwise = depthwise
        self.epilogues = epilogues


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, dict) and (
        set(node.keys()) == {QKEY, SKEY} or set(node.keys()) == {QKEY_FP8, SKEY}
    )


def _np(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _channel_scale(w: np.ndarray, qmax: float) -> np.ndarray:
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    return np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)


def quantize_leaf(w: Any) -> dict:
    """Per-channel symmetric int8 codes + scales for one weight tensor."""
    w = np.asarray(_np(w), np.float32)
    scale = _channel_scale(w, 127.0)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {QKEY: torch.from_numpy(q), SKEY: torch.from_numpy(scale)}


def quantize_leaf_fp8(w: Any) -> dict:
    """Per-channel symmetric fp8 e4m3 codes + scales for one weight tensor
    (448, the e4m3 finite max, in place of 127)."""
    w = np.asarray(_np(w), np.float32)
    scale = _channel_scale(w, FP8_E4M3_MAX)
    code = torch.from_numpy(np.asarray(w / scale, np.float32)).to(torch.float8_e4m3fn)
    return {QKEY_FP8: code, SKEY: torch.from_numpy(scale)}


def _quantize_tree(variables: Any, leaf_fn) -> QuantizedVariables:
    def walk(node, in_params: bool):
        if isinstance(node, dict):
            return {k: walk(v, in_params or k == "params") for k, v in node.items()}
        arr = _np(node)
        if in_params and arr.ndim >= 2:
            return leaf_fn(arr)
        return torch.from_numpy(np.array(arr))

    return QuantizedVariables(walk(variables, False))


def quantize_variables(variables: Any) -> QuantizedVariables:
    """int8-quantize every params leaf with a channel structure (ndim >= 2)
    of a flax-layout tree; a pure function of the weights."""
    return _quantize_tree(variables, quantize_leaf)


def quantize_variables_fp8(variables: Any) -> QuantizedVariables:
    """fp8 counterpart of :func:`quantize_variables` (same leaf selection)."""
    return _quantize_tree(variables, quantize_leaf_fp8)


def quantize_for_plane(variables: Any, kernel_plane: str) -> QuantizedVariables:
    """The quantized tree a kernel plane consumes: int8 codes for
    ``reference``/``fused_int8``, e4m3 codes for ``fp8``."""
    if kernel_plane == "fp8":
        return quantize_variables_fp8(variables)
    if kernel_plane in ("reference", "fused_int8"):
        return quantize_variables(variables)
    raise ValueError(f"unknown kernel_plane {kernel_plane!r}")


def dequantize_variables(qtree: Any) -> Any:
    """The float32 tree the quantized program computes with:
    ``float(code) * scale`` per quantized leaf, everything else as is."""

    def walk(node):
        if _is_qleaf(node):
            code = node[QKEY] if QKEY in node else node[QKEY_FP8]
            return code.to(torch.float32) * node[SKEY]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qtree)


def quantized_bytes(qtree: Any) -> tuple[int, int]:
    """(quantized_bytes, reference_bytes) over every leaf of the tree, as
    the JAX package counts them: an int8 leaf stands for 4 reference
    bytes per value, any other leaf (fp8 codes included) for its own
    itemsize."""
    q_bytes = ref_bytes = 0
    for leaf in tree_leaves(qtree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        q_bytes += t.numel() * t.element_size()
        ref_bytes += t.numel() * (4 if t.dtype == torch.int8 else t.element_size())
    return q_bytes, ref_bytes


def fake_quant_activations(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor symmetric int8 quantize-dequantize."""
    absmax = torch.max(torch.abs(x))
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def mask_iou(probs_a: np.ndarray, probs_b: np.ndarray, threshold: float = 0.5) -> float:
    """Intersection-over-union of the thresholded masks; both empty = 1.0."""
    a = np.asarray(probs_a) > threshold
    b = np.asarray(probs_b) > threshold
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum() / union)


@dataclasses.dataclass(frozen=True)
class QuantGateResult:
    """The install-time verdict: per-bucket mask IoU of the quantized
    program against the reference program on the seeded probe batch."""

    passed: bool
    iou: float                    # min over buckets: the gating number
    floor: float
    per_bucket: dict              # {bucket_size: iou}
    probe_batch: int
    probe_seed: int

    def to_json(self) -> dict:
        return {
            "passed": self.passed,
            "iou": round(self.iou, 6),
            "floor": self.floor,
            "per_bucket": {str(k): round(v, 6) for k, v in self.per_bucket.items()},
            "probe_batch": self.probe_batch,
            "probe_seed": self.probe_seed,
        }


def probe_images(size: int, n: int, seed: int) -> np.ndarray:
    """The seeded probe batch for one bucket: synthetic crack images as
    uint8 transport bytes, byte-equal to the JAX package's."""
    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    imgs_f, msks_f = synth_crack_batch(n, img_size=size, seed=seed)
    imgs_u8, _ = to_uint8_transport(imgs_f, msks_f)
    return imgs_u8


def quant_gate(
    engine: Any,
    reference_variables: Any,
    quantized_variables: QuantizedVariables,
    *,
    floor: float | None = None,
    probe_batch: int | None = None,
    probe_seed: int | None = None,
) -> QuantGateResult:
    """Both programs over the seeded probe batch at every bucket size; the
    worst per-bucket mask IoU must reach the floor. Both weight arguments
    must already be placed (``engine.prepare`` / ``engine.prepare_quantized``)."""
    cfg = engine.serve_config
    floor = cfg.quant_iou_floor if floor is None else floor
    n = cfg.quant_probe_batch if probe_batch is None else probe_batch
    seed = cfg.quant_probe_seed if probe_seed is None else probe_seed
    per_bucket: dict[int, float] = {}
    for size in engine.bucket_sizes:
        batch = probe_images(size, min(n, engine.max_batch), seed)
        ref = engine.predict_bucket(reference_variables, batch)
        quant = engine.predict_bucket(quantized_variables, batch)
        per_bucket[size] = mask_iou(ref, quant)
    worst = min(per_bucket.values())
    return QuantGateResult(
        passed=worst >= floor,
        iou=worst,
        floor=floor,
        per_bucket=per_bucket,
        probe_batch=n,
        probe_seed=seed,
    )
