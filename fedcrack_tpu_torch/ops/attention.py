"""The Mix Transformer's efficient self-attention, as one function.

SegFormer's attention (Xie et al., 2021) takes its queries from all N
tokens of a stage and its keys and values from the M = N / sr^2 tokens a
strided conv left (``models/segformer.py`` projects and reduces them):
``softmax(q k^T * scale) v`` per head. :func:`spatial_reduction_attention`
is that product and nothing else, so that a fused kernel can replace it
whole.

It is written as composed ``matmul`` / ``softmax`` / ``matmul``, the
scale applied to the queries: the published code scales the scores,
which at SegFormer's head size of 64 (a scale of 1/8, a power of two)
gives the same bits and costs a pass over the N x M scores forward and
backward. PyTorch's
float32 ``scaled_dot_product_attention`` dispatches to its
memory-efficient backend, whose backward is not deterministic run to run;
the repository treats bitwise-repeatable training as a contract
(``train.local.configure_backends``), and cuBLAS's products and the
softmax are deterministic.

Each call is counted in ``train_attention_total{stage, path}`` (path
``composed``). A call recorded into a CUDA graph's capture runs only when
the graph does: the capturing thread takes the calls it recorded
(:func:`take_captured_calls`) and adds them at each run of the graph
(:func:`count_calls`), as ``ops.bce`` counts its launches.
"""

from __future__ import annotations

import threading

import torch

from fedcrack_tpu_torch.obs.registry import REGISTRY

PATH = "composed"

ATTENTION_TOTAL = REGISTRY.counter(
    "train_attention_total", "attention calls by stage (1-4) and implementation (composed)",
    labels=("stage", "path"))

# Calls recorded into a CUDA graph by this thread's capture, not yet taken
# by it: {(stage, path): calls}.
_captured = threading.local()


def spatial_reduction_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                                stage: int) -> torch.Tensor:
    """``q`` ``[B, heads, N, d]``, ``k`` and ``v`` ``[B, heads, M, d]``:
    ``softmax(q k^T * scale) v``, ``[B, heads, N, d]``."""
    _count(stage)
    scores = torch.matmul(q * scale, k.transpose(-2, -1))
    return torch.matmul(scores.softmax(dim=-1), v)


def _count(stage: int) -> None:
    key = (str(stage), PATH)
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        calls = getattr(_captured, "calls", None)
        if calls is None:
            calls = _captured.calls = {}
        calls[key] = calls.get(key, 0) + 1
        return
    ATTENTION_TOTAL.labels(stage=key[0], path=key[1]).inc()


def take_captured_calls() -> dict:
    """The calls this thread recorded into CUDA graph captures since it
    last took them, ``{(stage, path): calls}``."""
    calls = getattr(_captured, "calls", None) or {}
    _captured.calls = {}
    return calls


def count_calls(calls: dict) -> None:
    """Add calls that ran with no call to
    :func:`spatial_reduction_attention`: a CUDA graph's, each time it
    runs."""
    for (stage, path), n in calls.items():
        ATTENTION_TOTAL.labels(stage=stage, path=path).inc(n)
