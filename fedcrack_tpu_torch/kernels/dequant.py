"""Fused dequantize kernels: int8 / fp8 e4m3 codes into an f32 product.

Two hand-written CUDA kernels for Hopper (``csrc/dequant.cu``) take the
place of the Pallas kernels of ``fedcrack_tpu.kernels.dequant``:

- :func:`dequant_matmul`: ``[M, K] f32 @ dequant([K, N] codes, [N] scales)``.
  Codes are converted in-tile, accumulation is plain f32 FMA, and the
  per-output-channel scale multiplies the finished accumulator once. The
  two orders differ from ``x @ (q * scale)`` only by float reassociation:
  per entry within one per-channel scale (the JAX package's bound).
- :func:`dequant_codes`: ``float(q) * scale`` with per-last-axis scales,
  bitwise equal to its plain version.

Routing is by device, never by fallback: a tensor on the CPU takes the
plain PyTorch version (what the CPU tests check against the JAX package),
a CUDA tensor launches the kernel or raises. Each wrapper counts its
launches in a plain integer attribute (``dequant_matmul.launches``), so a
run can show that its main path went through the kernels.

The kernels build at first use from the package's own sources with
``nvcc`` into ``fedcrack_tpu_torch/_build/`` (``kernels/build.py``: a
shared library with a plain C interface, loaded with ``ctypes``), keyed by
a hash of source and flags.
"""

from __future__ import annotations

import threading

import torch

from fedcrack_tpu_torch.kernels.build import I32, I64, PTR, KernelLibrary

CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)

# Every entry point: operand pointers, sizes, then the CUDA stream.
LIBRARY = KernelLibrary("dequant", {
    "fc_dequant_matmul_i8": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_matmul_e4m3": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_codes_i8": [PTR, PTR, PTR, I64, I32, PTR],
    "fc_dequant_codes_e4m3": [PTR, PTR, PTR, I64, I32, PTR],
})

_count_lock = threading.Lock()


def _count(wrapper) -> None:
    with _count_lock:  # batcher workers launch from several threads
        wrapper.launches += 1


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        dequant_matmul.launches = 0
        dequant_codes.launches = 0


def _check_codes(q: torch.Tensor) -> None:
    if q.dtype not in CODE_DTYPES:
        raise TypeError(f"dequant kernels want int8/fp8 e4m3 codes, got {q.dtype}")


def _check_operands(*tensors: torch.Tensor) -> None:
    """Same device, contiguous: what the kernels address directly."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"operands on different devices: {device} vs {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"operand of shape {tuple(t.shape)} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"dequant kernels run on cuda (or plain on cpu), got {device}")


# ---- fused dequant-matmul ----


def _dequant_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    # Expand the f32 weights, then contract.
    return x.float() @ (q.float() * scale)


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``[M, K] f32 @ dequant([K, N] codes, [N] scales) -> [M, N]`` f32."""
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"bad matmul shapes: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if tuple(scale.shape) != (q.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} != per-channel ({q.shape[1]},)")
    _check_codes(q)
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"x and scale must be float32, got {x.dtype} and {scale.dtype}")
    _check_operands(x, q, scale)
    if x.device.type == "cpu":
        return _dequant_matmul_plain(x, q, scale)
    m, k = x.shape
    n = q.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    name = "fc_dequant_matmul_i8" if q.dtype == torch.int8 else "fc_dequant_matmul_e4m3"
    LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n)
    _count(dequant_matmul)
    return y


dequant_matmul.launches = 0


# ---- elementwise dequant (weight expansion without a contraction) ----


def _dequant_codes_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def dequant_codes(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Expand ``[..., N]`` codes with per-last-axis scales to float32."""
    if q.ndim < 1 or tuple(scale.shape) != (q.shape[-1],):
        raise ValueError(
            f"scale {tuple(scale.shape)} != per-channel ({q.shape[-1] if q.ndim else None},)"
        )
    _check_codes(q)
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    _check_operands(q, scale)
    if q.device.type == "cpu":
        return _dequant_codes_plain(q, scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    total = q.numel()
    if total == 0:
        return out
    name = "fc_dequant_codes_i8" if q.dtype == torch.int8 else "fc_dequant_codes_e4m3"
    LIBRARY.launch(name, q.device, q.data_ptr(), scale.data_ptr(), out.data_ptr(), total, q.shape[-1])
    _count(dequant_codes)
    return out


dequant_codes.launches = 0
