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
- :func:`dequant_codes_group`: ``float(q) * scale`` with per-last-axis
  scales for up to 16 leaves in one launch, each leaf's result a view of
  one arena, bitwise equal to its plain version (``_dequant_kernel``);
  :func:`dequant_codes` is its one-leaf case. The fused forward expands its
  six depthwise kernels in one call, from a :class:`CodeGroup` validated
  once when the tree is placed.

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

import ctypes
import threading
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from fedcrack_tpu_torch.kernels.build import I32, PTR, KernelLibrary
from fedcrack_tpu_torch.ops.pooling import same_pads

CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)

# Every entry point: operand pointers, sizes, then the CUDA stream.
LIBRARY = KernelLibrary("dequant", {
    "fc_dequant_matmul_i8": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_matmul_e4m3": [PTR, PTR, PTR, PTR, I32, I32, I32, PTR],
    "fc_dequant_conv3x3_i8": [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, PTR],
    "fc_dequant_conv3x3_e4m3": [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, PTR],
    "fc_dequant_codes_i8": [PTR, PTR, PTR],
    "fc_dequant_codes_e4m3": [PTR, PTR, PTR],
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


MAX_SEGMENTS = 16  # leaves per grouped launch (csrc/dequant.cu)
SLICE_ALIGN = 4  # floats: every leaf's slice of the arena starts 16-byte aligned


class _CodeSegments(ctypes.Structure):
    """``CodeSegments`` of ``csrc/dequant.cu``, field for field."""

    _fields_ = [
        ("q", ctypes.c_void_p * MAX_SEGMENTS),
        ("scale", ctypes.c_void_p * MAX_SEGMENTS),
        ("out_offset", ctypes.c_longlong * MAX_SEGMENTS),
        ("numel", ctypes.c_longlong * MAX_SEGMENTS),
        ("unit_start", ctypes.c_longlong * (MAX_SEGMENTS + 1)),
        ("n", ctypes.c_int * MAX_SEGMENTS),
        ("count", ctypes.c_int),
    ]


def segment_layout(numels: Sequence[int]) -> tuple[list[int], int]:
    """``(offsets, total)``: where each leaf's slice starts in the arena (a
    multiple of :data:`SLICE_ALIGN` floats, in leaf order, disjoint) and the
    arena's size in floats."""
    if not numels:
        raise ValueError("a code group needs at least one leaf")
    if len(numels) > MAX_SEGMENTS:
        raise ValueError(f"a code group takes at most {MAX_SEGMENTS} leaves, got {len(numels)}")
    offsets, end = [], 0
    for numel in numels:
        offsets.append(end)
        end += -(-numel // SLICE_ALIGN) * SLICE_ALIGN
    return offsets, end


def _check_leaf(q: torch.Tensor, scale: torch.Tensor) -> None:
    if q.ndim < 1 or tuple(scale.shape) != (q.shape[-1],):
        raise ValueError(
            f"scale {tuple(scale.shape)} != per-channel ({q.shape[-1] if q.ndim else None},)"
        )
    _check_codes(q)
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")


class CodeGroup:
    """Leaves of one grouped expansion, ``(q [..., N_i] codes, scale [N_i]
    f32)`` pairs on one device with one code dtype, validated once. On CUDA
    it holds the kernel's segment table (read-only pointers into the
    leaves, which it keeps alive), so a call of :func:`dequant_codes_group`
    on it is one ``torch.empty``, one launch and one count. Each call
    writes a fresh arena: concurrent calls share no output memory."""

    def __init__(self, leaves: Sequence[tuple[torch.Tensor, torch.Tensor]]):
        self.leaves = [(q, scale) for q, scale in leaves]
        numels = [q.numel() for q, _ in self.leaves]
        self.offsets, self.total = segment_layout(numels)
        for q, scale in self.leaves:
            _check_leaf(q, scale)
        dtypes = {q.dtype for q, _ in self.leaves}
        if len(dtypes) > 1:
            raise TypeError(f"a code group takes one code dtype, got {sorted(map(str, dtypes))}")
        _check_operands(*(t for leaf in self.leaves for t in leaf))
        self.device = self.leaves[0][0].device
        # Each leaf's view of the arena: its shape, its (contiguous) strides, its offset.
        self.views = [(q.shape, q.stride(), offset) for (q, _), offset in zip(self.leaves, self.offsets)]
        self.units = sum(-(-numel // SLICE_ALIGN) for numel in numels)
        self.table = None
        if self.device.type == "cuda":
            int8 = self.leaves[0][0].dtype == torch.int8
            self.symbol = "fc_dequant_codes_i8" if int8 else "fc_dequant_codes_e4m3"
            self.table = segment_table(self.leaves, self.offsets)
            self.table_address = ctypes.addressof(self.table)


def segment_table(leaves: Sequence[tuple[torch.Tensor, torch.Tensor]], offsets: Sequence[int]) -> _CodeSegments:
    """The kernel's segment table for validated ``leaves`` whose slices
    start at ``offsets``: their pointers, sizes and the prefix sums of
    their 4-code units."""
    table = _CodeSegments(count=len(leaves))
    start = 0
    for i, ((q, scale), offset) in enumerate(zip(leaves, offsets)):
        table.q[i] = q.data_ptr()
        table.scale[i] = scale.data_ptr()
        table.out_offset[i] = offset
        table.numel[i] = q.numel()
        table.n[i] = max(q.shape[-1], 1)
        table.unit_start[i] = start
        start += -(-q.numel() // SLICE_ALIGN)
    table.unit_start[len(leaves)] = start
    return table


def dequant_codes_group(
    leaves: CodeGroup | Sequence[tuple[torch.Tensor, torch.Tensor]],
) -> list[torch.Tensor]:
    """Expand each ``(q [..., N_i] codes, scale [N_i])`` leaf to float32,
    ``float(q) * scale[i % N_i]``, all in one launch on CUDA: the results
    are views of one arena, each starting 16-byte aligned. ``leaves`` is a
    prepared :class:`CodeGroup` or the pairs themselves (validated per
    call)."""
    group = leaves if isinstance(leaves, CodeGroup) else CodeGroup(leaves)
    if group.device.type == "cpu":
        return [_dequant_codes_plain(q, scale) for q, scale in group.leaves]
    arena = torch.empty(group.total, dtype=torch.float32, device=group.device)
    if group.units:
        LIBRARY.launch(group.symbol, group.device, group.table_address, arena.data_ptr())
        _count(dequant_codes)
    return [arena.as_strided(shape, stride, offset) for shape, stride, offset in group.views]


def dequant_codes(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Expand ``[..., N]`` codes with per-last-axis scales to float32: the
    one-leaf case of :func:`dequant_codes_group`."""
    return dequant_codes_group([(q, scale)])[0]


dequant_codes.launches = 0
