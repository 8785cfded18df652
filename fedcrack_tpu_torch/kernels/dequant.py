"""Fused dequantize kernels: int8 / fp8 e4m3 codes into an f32 product.

Hand-written CUDA kernels for Hopper (``csrc/dequant.cu``) take the place
of the Pallas kernels of ``fedcrack_tpu.kernels.dequant``:

- :func:`dequant_matmul`: ``[M, K] f32 @ dequant([K, N] codes, [N] scales)``
  (``_matmul_kernel``), for the 1x1 convs and the stride-2 stem.
- :func:`dequant_conv3x3`: the stride-1 SAME 3x3 conv of an NHWC activation
  with HWIO codes, the same GEMM with the im2col fused into its A loads
  (``_matmul_kernel`` behind the JAX ``_conv3x3``, whose patches XLA
  materialises). It reads the activation once: no padded copy and no
  9x-wide patch matrix in device memory.
- :func:`dequant_codes`: ``float(q) * scale`` with per-last-axis scales,
  bitwise equal to its plain version (``_dequant_kernel``).

The two GEMMs run on the tensor cores (``mma.sync`` bf16, f32
accumulators). Codes are exact in bf16; the f32 activation is split into
three bf16 terms (hi, mid, lo) that carry its whole significand, each term
times a code is exact, and the sums accumulate in f32. The per-channel
scale multiplies the finished accumulator once. So each entry differs from
``x @ (q * scale)`` only by the order and rounding of its f32 sums: within
one per-channel scale (the JAX package's bound), in an order fixed by K and
N alone, never by M. The conv orders K as ``(kh, kw, c)`` against the plain
version's ``(c, kh, kw)``: float reassociation again, within the same bound.
On an H100, per bucket-256 x batch-8 forward, the 1x1 GEMMs are bound by
device-memory bytes (0.11 ms at 3.35 TB/s, their K being 27 to 256) and
the 3x3 convs by the three bf16 passes (0.08 ms at 989 TFLOP/s dense) once
they read their activation once. So the design keeps bytes off device
memory (the fused im2col), keeps copies in flight (a 3-stage ``cp.async``
ring for A) and keeps the tensor cores fed (tiles fitted to the layer's N
and M, independent MMAs back to back).

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
import torch.nn.functional as F

from fedcrack_tpu_torch.kernels.build import I32, I64, PTR, KernelLibrary
from fedcrack_tpu_torch.ops.pooling import same_pads

CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)

# Every entry point: operand pointers, sizes, then the CUDA stream.
LIBRARY = KernelLibrary("dequant", {
    "fc_dequant_matmul_i8": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_matmul_e4m3": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_conv3x3_i8": [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, PTR],
    "fc_dequant_conv3x3_e4m3": [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, PTR],
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
        dequant_conv3x3.launches = 0
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


def _check_offsets(a_elements: int) -> None:
    """The GEMM kernels address A (rows x K) with 32-bit offsets."""
    if a_elements >= 2**31:
        raise ValueError(f"A operand of {a_elements} elements exceeds the kernels' 2^31 offsets")


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
    _check_offsets(m * k)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    name = "fc_dequant_matmul_i8" if q.dtype == torch.int8 else "fc_dequant_matmul_e4m3"
    LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n)
    _count(dequant_matmul)
    return y


dequant_matmul.launches = 0


# ---- fused dequant 3x3 conv (stride 1, SAME) ----


def im2col3x3(x: torch.Tensor, stride: int) -> tuple[torch.Tensor, int, int]:
    """Rows of the SAME 3x3 patches of NHWC ``x``: ``[N*Ho*Wo, C*9]`` with
    ``(C, kh, kw)``-major patch channels, like
    ``lax.conv_general_dilated_patches``. Flax ``"SAME"`` padding is
    asymmetric at stride 2 (0 before, 1 after on an even grid), so the input
    is padded explicitly before the unfold."""
    n, h, w, c = x.shape
    ho, lo_h, hi_h = same_pads(h, 3, stride)
    wo, lo_w, hi_w = same_pads(w, 3, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h))
    patches = F.unfold(xc, kernel_size=3, stride=stride)  # [N, C*9, Ho*Wo]
    return patches.transpose(1, 2).reshape(n * ho * wo, c * 9).contiguous(), ho, wo


def _dequant_conv3x3_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    # Patches in (C, kh, kw) order, so the HWIO codes permute to match.
    n, h, w, _ = x.shape
    c, f = q.shape[2], q.shape[3]
    rows, _, _ = im2col3x3(x, 1)
    q2 = q.permute(2, 0, 1, 3).reshape(c * 9, f)
    return _dequant_matmul_plain(rows, q2, scale).reshape(n, h, w, f)


def dequant_conv3x3(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``conv3x3_SAME_stride1(x [N, H, W, C] f32, dequant(q [3, 3, C, F]
    codes, scale [F])) -> [N, H, W, F]`` f32. On CUDA, C must be a multiple
    of 4 (the kernel moves 4 channels per copy)."""
    if x.ndim != 4 or q.ndim != 4 or tuple(q.shape[:2]) != (3, 3) or q.shape[2] != x.shape[3]:
        raise ValueError(f"bad conv shapes: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if tuple(scale.shape) != (q.shape[3],):
        raise ValueError(f"scale {tuple(scale.shape)} != per-channel ({q.shape[3]},)")
    _check_codes(q)
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"x and scale must be float32, got {x.dtype} and {scale.dtype}")
    n, h, w, c = x.shape
    if x.device.type != "cpu" and c % 4:
        raise ValueError(f"dequant_conv3x3 on {x.device} wants C a multiple of 4, got C={c}")
    _check_operands(x, q, scale)
    if x.device.type == "cpu":
        return _dequant_conv3x3_plain(x, q, scale)
    f = q.shape[3]
    if x.data_ptr() % 16:
        raise ValueError("dequant_conv3x3 wants a 16-byte aligned activation")
    _check_offsets(n * h * w * 9 * c)
    y = torch.empty((n, h, w, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    name = "fc_dequant_conv3x3_i8" if q.dtype == torch.int8 else "fc_dequant_conv3x3_e4m3"
    LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), n, h, w, c, f)
    _count(dequant_conv3x3)
    return y


dequant_conv3x3.launches = 0


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
