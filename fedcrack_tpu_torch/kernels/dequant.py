"""Fused dequantize kernels: int8 / fp8 e4m3 codes into an f32 product.

Hand-written CUDA kernels for Hopper (``csrc/dequant.cu``,
``csrc/dequant_conv.cu``, ``csrc/dequant_dw.cu``) take the place of the
Pallas kernels of ``fedcrack_tpu.kernels.dequant``:

- :func:`dequant_matmul`: ``[M, K] f32 @ dequant([K, N] codes, [N] scales)``
  (``_matmul_kernel``), for the 1x1 convs and the stride-2 stem. One
  persistent block an SM keeps its column block's codes in shared memory
  across all its row tiles, a producer warp feeds A through a TMA ring
  (``cp.async`` where K % 4 != 0), and each tile leaves by a TMA store that
  drains under the next tile's loads. :func:`matmul_tile_plan` chooses its
  tiles.
- :func:`dequant_conv3x3`: the stride-1 SAME 3x3 conv of an NHWC activation
  with HWIO codes (``_matmul_kernel`` behind the JAX ``_conv3x3``, whose
  patches XLA materialises). Its own kernel: a block loads a halo tile of
  the activation per 32-channel chunk by TMA, zero-filled at the image's
  edge, and the nine taps read shifted windows of it; no padded copy and no
  9x-wide patch matrix exist in device memory. :func:`conv_tile_plan`
  chooses its tiles.
- :func:`dequant_codes_group`: ``float(q) * scale`` with per-last-axis
  scales for up to 16 leaves in one launch, each leaf's result a view of
  one arena, bitwise equal to its plain version (``_dequant_kernel``);
  :func:`dequant_codes` is its one-leaf case.
- :func:`dequant_dwconv3x3`: the stride-1 SAME depthwise 3x3 conv of
  ``relu(x)`` (NHWC) with ``float(q) * scale`` as its taps: the
  ``_dequant_kernel`` work of the depthwise kernel, expanded in the
  kernel's prologue, and the conv the JAX ``_sepconv`` leaves to XLA. A
  producer warp loads halo tiles by TMA, zero-filled at the image's edge
  (the SAME padding), and each lane of the consumer warps owns a channel.
  :func:`dwconv_tile_plan` chooses its tiles. The fused forward's six
  depthwise stages run here, so on its path the codes are never expanded
  into device memory.

Both contractions take a fused epilogue (:class:`Epilogue`): after the
scale, each output gets its channel's bias, then, in the mixes the fused
forward launches, an eval BatchNorm ``((v - mean) * inv) + beta`` and
``torch.relu``, or a residual add (the GEMM only), each step one correctly
rounded f32 operation, so a fused launch is bit for bit the launch without
it followed by the same torch ops (:func:`_torch_epilogue`);
``dequant_conv3x3`` can also take the ReLU of its input as it reads it
(``relu_input``). On the card the vectors travel as one table
(:func:`epilogue_table`, built once an :class:`Epilogue`), which the GEMM
reads through L1 and the conv stages a column block at a time in shared
memory past its plan's; each epilogue kind is a kernel instantiation of
its own, and the tile plans are the same with an epilogue as without.

The two contractions run on ``wgmma`` (bf16 operands, f32 accumulators).
Codes are exact in bf16; the f32 activation is split into three bf16 terms
(hi, mid, lo) that carry its whole significand, each term times a code is
exact, and the sums accumulate in f32. The per-channel scale multiplies the
finished accumulator once. So each entry differs from ``x @ (q * scale)``
only by the order and rounding of its f32 sums: within one per-channel
scale (the JAX package's bound), in an order fixed by K (for the conv, by
C) alone, never by the rows or the grid. The conv orders K as (32-channel
chunk, kh, kw, channel) against the plain version's ``(c, kh, kw)``: float
reassociation again, within the same bound. The depthwise conv has no
contraction to speak of: nine f32 multiplies and eight adds an output, in
a fixed order, bitwise equal to its plain version. On an H100, per
bucket-256 x batch-8 forward, the 1x1 GEMMs are bound by device-memory
bytes (0.11 ms at 3.35 TB/s, their K being 27 to 256), the 3x3 convs by
the three bf16 passes (0.08 ms at 989 TFLOP/s dense) and the depthwise
convs by bytes (0.053 ms). So the GEMM reads its codes once a
column block and keeps loads and stores of the activations in flight
together; the conv reads each activation about once per column block from
its halo tiles and keeps ``wgmma`` fed from a ring of TMA-loaded stages.

Routing is by device, never by fallback: a tensor on the CPU takes the
plain PyTorch version (what the CPU tests check against the JAX package),
a CUDA tensor launches the kernel or raises. Each wrapper counts its
launches in a plain integer attribute (``dequant_matmul.launches``), so a
run can show that its main path went through the kernels.

:func:`fake_quant_leaf` and :func:`fake_quant_params` are no kernels: the
straight-through int8 fake-quant of the slot plane's ``lowp`` twin, plain
PyTorch.

The kernels build at first use from the package's own sources with
``nvcc`` into ``fedcrack_tpu_torch/_build/`` (``kernels/build.py``: a
shared library with a plain C interface per source, loaded with
``ctypes``), keyed by a hash of sources and flags.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections.abc import Sequence
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fedcrack_tpu_torch.kernels.build import I32, PTR, KernelLibrary
from fedcrack_tpu_torch.ops.pooling import same_pads

CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)

# Every entry point: operand pointers, sizes, then the CUDA stream. The
# matmul's: x, q, scale, y; the epilogue's table and residual (each may be
# null), the table's row stride and the epilogue's kind (_KIND_*); M, K, N;
# the tile plan's BM, BN, stages, shared-memory bytes and blocks; the
# stream.
LIBRARY = KernelLibrary("dequant", {
    "fc_dequant_matmul_i8": [PTR] * 6 + [I32] * 10 + [PTR],
    "fc_dequant_matmul_e4m3": [PTR] * 6 + [I32] * 10 + [PTR],
    "fc_dequant_codes_i8": [PTR, PTR, PTR],
    "fc_dequant_codes_e4m3": [PTR, PTR, PTR],
})
# x, q, scale, y; the epilogue's table, its row stride and kind, then
# relu_input; N, H, W, C, F; the tile plan's TH, TW, BN, stages,
# shared-memory bytes and blocks; the stream.
CONV_LIBRARY = KernelLibrary("dequant_conv", {
    "fc_dequant_conv3x3_i8": [PTR] * 5 + [I32] * 14 + [PTR],
    "fc_dequant_conv3x3_e4m3": [PTR] * 5 + [I32] * 14 + [PTR],
})
# x, q, scale, y; N, H, W, C; the tile plan's TH, TW, channels a unit,
# stages, shared-memory bytes and blocks; the stream.
DW_LIBRARY = KernelLibrary("dequant_dw", {
    "fc_dequant_dwconv3x3_i8": [PTR, PTR, PTR, PTR] + [I32] * 10 + [PTR],
    "fc_dequant_dwconv3x3_e4m3": [PTR, PTR, PTR, PTR] + [I32] * 10 + [PTR],
})
LIBRARIES = (LIBRARY, CONV_LIBRARY, DW_LIBRARY)

_count_lock = threading.Lock()


def _count(wrapper) -> None:
    with _count_lock:  # batcher workers launch from several threads
        wrapper.launches += 1


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        dequant_matmul.launches = 0
        dequant_conv3x3.launches = 0
        dequant_dwconv3x3.launches = 0
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


# What the two tensor-core kernels share (csrc/dequant_common.cuh): TMA's
# 128-byte swizzle, the 64-byte row of bf16 a column of codes takes per
# 32-deep chunk (wgmma's B layout), the card's SMs and a block's shared
# memory.
_HALO_ALIGN = 1024  # TMA's 128-byte swizzle repeats every 1024 bytes
_ROW_BYTES = 64  # a pixel's or a column's chunk of 32 in bf16: one 64-byte swizzle row
_SMS = 132  # H100 SXM
_SMEM_PER_BLOCK = 232_448  # what one block may have (227 KB)


# ---- the epilogue of the two contractions ----


class Epilogue:
    """What a :func:`dequant_matmul` or :func:`dequant_conv3x3` launch does
    to each output ``v = acc * scale[n]`` of channel ``n`` before it is
    stored, in this order: ``v + bias[n]``; where ``bn`` is given, the eval
    BatchNorm ``((v - mean[n]) * inv[n]) + beta[n]``, then ``torch.relu``
    where ``relu``. (A GEMM's ``residual=`` then adds ``r + v`` to an
    epilogue without a BatchNorm.) Each step is one correctly rounded
    float32 operation, so a fused launch equals bit for bit the launch
    without an epilogue followed by the same torch ops
    (:func:`_torch_epilogue`).

    ``bias``: ``[N]`` float32; ``bn``: ``(mean, inv, beta)``, each ``[N]``
    float32, ``inv = gamma * rsqrt(var + eps)`` as the caller computes it;
    all contiguous, on one device. These are the mixes the fused forward
    launches; a ReLU comes only after a BatchNorm. Validated once, here: a
    launch checks only that ``N`` and the device match its own. On CUDA the
    kernels read the vectors as one table (:func:`epilogue_table`), built
    here once."""

    __slots__ = ("bias", "bn", "relu", "n", "device", "table")

    def __init__(self, *, bias: torch.Tensor,
                 bn: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None, relu: bool = False):
        if bn is not None and len(bn) != 3:
            raise ValueError(f"bn wants (mean, inv, beta), got {len(bn)} tensors")
        if relu and bn is None:
            raise ValueError("the kernels' epilogues take a ReLU only after a BatchNorm")
        vectors = [bias] + list(bn or ())
        for v in vectors:
            if not isinstance(v, torch.Tensor) or v.dtype != torch.float32 or v.ndim != 1:
                raise TypeError(f"epilogue vectors are [N] float32 tensors, got {_describe(v)}")
        if len({v.shape[0] for v in vectors}) > 1:
            raise ValueError(f"epilogue vectors of different lengths: {[tuple(v.shape) for v in vectors]}")
        _check_operands(*vectors)
        self.bias, self.bn, self.relu = bias, None if bn is None else tuple(bn), bool(relu)
        self.n, self.device = bias.shape[0], bias.device
        self.table = epilogue_table(self.n, bias, self.bn) if self.device.type == "cuda" else None


# The epilogue table's rows (csrc/dequant_common.cuh): bias, mean, inv,
# beta, each padded to a multiple of this many columns (a column block's
# widest), so a block's columns are always inside a row.
EPILOGUE_TABLE_COLUMNS = 128


def epilogue_table(n: int, bias: torch.Tensor,
                   bn: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """``[4, stride]`` float32 on ``bias``'s device: the rows bias, mean,
    inv and beta of an epilogue of ``n`` channels (the last three zero
    without a BatchNorm; the kernels then read none of them), ``stride``
    ``n`` rounded up to :data:`EPILOGUE_TABLE_COLUMNS`."""
    stride = -(-max(n, 1) // EPILOGUE_TABLE_COLUMNS) * EPILOGUE_TABLE_COLUMNS
    table = torch.zeros((4, stride), dtype=torch.float32, device=bias.device)
    for row, v in enumerate([bias] + list(bn or ())):
        table[row, :n] = v
    return table


# The kernels' epilogue kinds (csrc/dequant_common.cuh's EPI_*): the bias
# and the BatchNorm; the same then a ReLU; the bias then a residual where
# there is one (the GEMM only).
_KIND_NONE, _KIND_AFFINE, _KIND_AFFINE_RELU, _KIND_BIAS_RESIDUAL = 0, 1, 2, 3


def _kind(epilogue: Epilogue | None) -> int:
    if epilogue is None:
        return _KIND_NONE
    if epilogue.bn is None:
        return _KIND_BIAS_RESIDUAL
    return _KIND_AFFINE_RELU if epilogue.relu else _KIND_AFFINE


def _describe(t) -> str:
    return f"{t.dtype} of shape {tuple(t.shape)}" if isinstance(t, torch.Tensor) else type(t).__name__


def _check_epilogue(epilogue: Epilogue | None, residual: torch.Tensor | None, y_shape: tuple,
                    device: torch.device) -> None:
    """An epilogue and a residual fit a launch whose output is ``y_shape``
    on ``device``, in a mix the kernels run: a residual only after the
    bias alone."""
    if epilogue is None:
        raise ValueError("a residual is added after the conv's bias: pass its Epilogue with it")
    if not isinstance(epilogue, Epilogue):
        raise TypeError(f"epilogue must be a dequant.Epilogue, got {type(epilogue).__name__}")
    if epilogue.n != y_shape[-1] or epilogue.device != device:
        raise ValueError(f"epilogue of {epilogue.n} channels on {epilogue.device} does not fit an output "
                         f"{y_shape} on {device}")
    if residual is None:
        return
    if epilogue.bn is not None:
        raise ValueError("the kernels add a residual only after the bias alone, not after a BatchNorm")
    if not isinstance(residual, torch.Tensor) or residual.dtype != torch.float32:
        raise TypeError(f"residual must be a float32 tensor, got {_describe(residual)}")
    if tuple(residual.shape) != tuple(y_shape):
        raise ValueError(f"residual {tuple(residual.shape)} != output {tuple(y_shape)}")
    if residual.device != device or not residual.is_contiguous():
        raise ValueError(f"residual must be contiguous on {device}, got {residual.device}")
    if device.type == "cuda" and residual.data_ptr() % 16:
        raise ValueError("the kernel loads the residual by TMA: it must be 16-byte aligned")


def _torch_epilogue(y: torch.Tensor, epilogue: Epilogue | None, residual: torch.Tensor | None) -> torch.Tensor:
    # The torch ops the kernels' epilogue stands for, in its order.
    if epilogue is not None:
        y = y + epilogue.bias
        if epilogue.bn is not None:
            mean, inv, beta = epilogue.bn
            y = (y - mean) * inv + beta
        if epilogue.relu:
            y = torch.relu(y)
    if residual is not None:
        y = residual + y
    return y


# ---- fused dequant-matmul ----


def _dequant_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, epilogue: Epilogue | None = None,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    # Expand the f32 weights, contract, then the epilogue's torch ops.
    return _torch_epilogue(x.float() @ (q.float() * scale), epilogue, residual)


# The matmul kernel's tiling (csrc/dequant.cu): K runs over chunks of
# MATMUL_CHUNK, one 128-byte swizzle row of f32 a row of A; a unit of work
# is 64 rows a consumer warpgroup (one, two or four) by a column block of 8
# to 128.
MATMUL_CHUNK = 32
_MATMUL_WG_ROWS = 64
_MATMUL_BNS = (8, 16, 32, 64, 128)
_MATMUL_NARROW = 32  # column blocks this narrow over one chunk of K take four consumer warpgroups
_MATMUL_MAX_STAGES = 8
# What a unit costs beyond its bytes, counted as bytes in the plan's
# estimate: the ring's first round trip and the epilogue's barriers.
_MATMUL_UNIT_BYTES = 16384


class MatmulTilePlan(NamedTuple):
    """How ``dequant_matmul_kernel`` tiles one GEMM: a unit of work is
    ``bm`` rows and ``bn`` columns; ``chunk`` of K a pipeline stage,
    ``stages`` stages in the ring; ``units`` units, computed by ``blocks``
    persistent blocks (block ``b`` takes units ``b``, ``b + blocks``, ...);
    the dynamic shared memory of a block in bytes."""

    bm: int
    bn: int
    chunk: int
    stages: int
    units: int
    blocks: int
    smem: int


def matmul_smem_bytes(bm: int, bn: int, k: int, stages: int) -> int:
    """Shared memory of a matmul block (``matmul_smem`` in csrc/dequant.cu):
    per stage a chunk of ``bm`` rows of f32 and two barriers; two staged
    ``bm x bn`` f32 output tiles; the column block's codes in bf16 (a 64-byte
    row a column for each of ``ceil(k / 32)`` chunks) and its ``bn`` scales;
    the base's alignment slack. A launch with a residual adds
    :data:`MATMUL_RESIDUAL_SMEM`."""
    codes = -(-k // MATMUL_CHUNK) * bn * _ROW_BYTES
    return stages * (bm * 4 * MATMUL_CHUNK + 16) + 2 * bm * bn * 4 + codes + bn * 4 + _HALO_ALIGN


# What a matmul launch with a residual adds past its plan's shared memory:
# a barrier for each of up to 4 consumer warpgroups (RESIDUAL_SMEM in
# csrc/dequant.cu, which refuses a launch without that room; every plan
# of the forward has it).
MATMUL_RESIDUAL_SMEM = 32


@functools.lru_cache(maxsize=256)
def matmul_tile_plan(m: int, k: int, n: int) -> MatmulTilePlan:
    """The matmul kernel's tiles for ``x [m, k] @ q [k, n]``.

    ``chunk`` is fixed, so every entry's K order is a function of ``k``
    alone, and nothing else here changes a sum: each wgmma computes a
    column from its own k16 products whatever the tile (held on the card by
    chip_smoke.py's phase 3, which compares the leading rows of a launch
    over fewer rows, planned otherwise, bit for bit).
    The row tile is 128, two consumer warpgroups sharing each stage of A and
    the codes (on the card one warpgroup alone ran the deep GEMMs slower at
    every column block tried); 256, four warpgroups, where ``k`` is one
    chunk and the column block at most 32 wide (the stem, the head), whose
    short chains of dependent wgmma leave the tensor cores waiting on
    latency unless more warpgroups interleave theirs; 64 where ``m`` fits.
    Among column blocks of 8 to 128 (no wider than ``n`` needs) whose codes
    and two stages fit a block's 227 KB, it takes the one whose
    busiest block moves the fewest bytes: its units' rows of A and of the
    output, a fixed cost a unit, and the codes it loads once a column block.
    One block an SM walks over the units, and its ring holds up to 8 chunks
    (as many as fit, and no more than the block computes). Raises for a
    ``k`` whose codes no block can hold (past about 12,000)."""
    if min(m, k, n) < 1:
        raise ValueError(f"no matmul tiles for an empty shape: M {m}, K {k}, N {n}")
    widest = next((bn for bn in _MATMUL_BNS if bn >= n), _MATMUL_BNS[-1])
    best = None
    for bn in _MATMUL_BNS:
        if m <= _MATMUL_WG_ROWS:
            bm = _MATMUL_WG_ROWS
        elif bn <= _MATMUL_NARROW and k <= MATMUL_CHUNK and m > 2 * _MATMUL_WG_ROWS:
            bm = 4 * _MATMUL_WG_ROWS
        else:
            bm = 2 * _MATMUL_WG_ROWS
        if bn > widest or matmul_smem_bytes(bm, bn, k, 2) > _SMEM_PER_BLOCK:
            continue
        cols = -(-n // bn)
        units = -(-m // bm) * cols
        blocks = min(units, _SMS)
        per_block = -(-units // blocks)
        cost = per_block * (bm * (k + bn) * 4 + _MATMUL_UNIT_BYTES) + min(per_block, cols) * k * bn
        if best is None or cost < best[0]:
            best = (cost, bm, bn, units, blocks, per_block)
    if best is None:
        raise ValueError(f"dequant_matmul: the codes of K={k} do not fit a block's shared memory")
    _, bm, bn, units, blocks, per_block = best
    stages = min(per_block * -(-k // MATMUL_CHUNK), _MATMUL_MAX_STAGES)
    while stages > 1 and matmul_smem_bytes(bm, bn, k, stages) > _SMEM_PER_BLOCK:
        stages -= 1
    return MatmulTilePlan(bm, bn, MATMUL_CHUNK, stages, units, blocks, matmul_smem_bytes(bm, bn, k, stages))


def matmul_unit_origin(plan: MatmulTilePlan, m: int, unit: int) -> tuple[int, int]:
    """``(first row, first column)`` of work unit ``unit``: column block
    ``unit // mtiles``, then row tile ``unit % mtiles`` (the kernel's
    mapping)."""
    col, tile = divmod(unit, -(-m // plan.bm))
    return tile * plan.bm, col * plan.bn


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                   epilogue: Epilogue | None = None, residual: torch.Tensor | None = None) -> torch.Tensor:
    """``[M, K] f32 @ dequant([K, N] codes, [N] scales) -> [M, N]`` f32,
    then ``epilogue`` (an :class:`Epilogue` of N channels) and, after an
    epilogue without a BatchNorm, ``residual + y`` (``[M, N]`` float32,
    16-byte aligned on CUDA) where given, fused into the launch. On CUDA, K
    is at most what a block's shared memory holds codes for (see
    :func:`matmul_tile_plan`)."""
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"bad matmul shapes: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if tuple(scale.shape) != (q.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} != per-channel ({q.shape[1]},)")
    _check_codes(q)
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"x and scale must be float32, got {x.dtype} and {scale.dtype}")
    _check_operands(x, q, scale)
    m, k = x.shape
    n = q.shape[1]
    if epilogue is not None or residual is not None:
        _check_epilogue(epilogue, residual, (m, n), x.device)
    table = None if epilogue is None else epilogue.table
    if x.device.type == "cpu":
        return _dequant_matmul_plain(x, q, scale, epilogue=epilogue, residual=residual)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return _torch_epilogue(y.zero_(), epilogue, residual)
    plan = matmul_tile_plan(m, k, n)
    name = "fc_dequant_matmul_i8" if q.dtype == torch.int8 else "fc_dequant_matmul_e4m3"
    LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                   None if table is None else table.data_ptr(), None if residual is None else residual.data_ptr(),
                   0 if table is None else table.shape[1], _kind(epilogue), m, k, n, plan.bm, plan.bn,
                   plan.stages, plan.smem, plan.blocks)
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
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, epilogue: Epilogue | None = None,
    relu_input: bool = False,
) -> torch.Tensor:
    # Patches in (C, kh, kw) order, so the HWIO codes permute to match.
    n, h, w, _ = x.shape
    c, f = q.shape[2], q.shape[3]
    rows, _, _ = im2col3x3(torch.relu(x) if relu_input else x, 1)
    q2 = q.permute(2, 0, 1, 3).reshape(c * 9, f)
    return _torch_epilogue(_dequant_matmul_plain(rows, q2, scale).reshape(n, h, w, f), epilogue, None)


# The conv kernel's tiling (csrc/dequant_conv.cu): K runs over chunks of
# CONV_CHUNK input channels, one 128-byte swizzle row of f32 a halo pixel;
# a unit of work is 8 x 8 pixels (one consumer warpgroup) or 8 x 16 (two).
CONV_CHUNK = 32
_CONV_TH = 8
_CONV_MAX_STAGES = 4


class ConvTilePlan(NamedTuple):
    """How ``dequant_conv3x3_kernel`` tiles one conv: a unit of work is
    ``th`` x ``tw`` output pixels of one image and ``bn`` output channels;
    ``chunk`` input channels a pipeline stage, ``stages`` stages in the
    ring; ``units`` units, computed by ``blocks`` persistent blocks (block
    ``b`` takes units ``b``, ``b + blocks``, ...); the dynamic shared memory
    of a block in bytes."""

    th: int
    tw: int
    bn: int
    chunk: int
    stages: int
    units: int
    blocks: int
    smem: int


def conv_smem_bytes(th: int, tw: int, bn: int, stages: int) -> int:
    """Shared memory of a conv block (``conv_smem`` in csrc/dequant_conv.cu):
    per stage the f32 halo tile and the chunk's codes in bf16 for 9 taps,
    and two barriers; the halo's hi, mid and lo bf16 planes; the base's
    alignment slack. Tiles and planes are aligned for their swizzles."""
    pixels = (th + 2) * (tw + 2)
    halo = -(-pixels * CONV_CHUNK * 4 // _HALO_ALIGN) * _HALO_ALIGN
    plane = -(-pixels * _ROW_BYTES // _HALO_ALIGN) * _HALO_ALIGN
    codes = 9 * bn * _ROW_BYTES
    return stages * (halo + codes + 16) + 3 * plane + _HALO_ALIGN


def conv_epilogue_smem(bn: int) -> int:
    """What a conv launch with an epilogue adds past its plan's shared
    memory (``conv_epilogue_smem`` in csrc/dequant_conv.cu): the column
    block's rows of the epilogue table and its scales. Every plan
    :func:`conv_tile_plan` makes has room for it."""
    return (4 + 1) * bn * 4


@functools.lru_cache(maxsize=256)
def conv_tile_plan(n: int, h: int, w: int, c: int, f: int) -> ConvTilePlan:
    """The conv kernel's tiles for ``x [n, h, w, c]`` and ``f`` outputs.

    ``chunk`` is fixed, so every entry's K order is a function of ``c``
    alone, and nothing else here changes a sum: each wgmma computes a
    column from its own k16 products whatever the tile's rows and width
    (held on the card by chip_smoke.py's phase 3, which compares images
    alone, planned otherwise, with the same images in a batch of 8, bit for
    bit).
    The pixel tile is 8 x 16 (two consumer warpgroups share each stage of
    codes) unless the image is at most 8 wide. The column block is the
    narrowest of 16, 32 and 64 that holds ``f``, halved while the units
    would fill fewer than half the SMs (the deep decoder layers have few
    pixels and many channels). One block an SM walks over the units, and
    its ring holds up to 4 chunks (as many as fit in a block's 227 KB, and
    no more than the block computes), so the producer fills the next
    unit's stages during this one's tail."""
    if min(n, h, w, c, f) < 1:
        raise ValueError(f"no conv tiles for an empty shape: x {(n, h, w, c)}, F {f}")
    tw = 16 if w > 8 else 8
    tiles = n * -(-h // _CONV_TH) * -(-w // tw)
    bn = 16 if f <= 16 else 32 if f <= 32 else 64
    while bn > 16 and tiles * -(-f // bn) < _SMS // 2:
        bn //= 2
    units = tiles * -(-f // bn)
    blocks = min(units, _SMS)
    stages = min(-(-units // blocks) * -(-c // CONV_CHUNK), _CONV_MAX_STAGES)  # a block's chunks at most
    while stages > 1 and conv_smem_bytes(_CONV_TH, tw, bn, stages) > _SMEM_PER_BLOCK:
        stages -= 1
    return ConvTilePlan(_CONV_TH, tw, bn, CONV_CHUNK, stages, units, blocks,
                        conv_smem_bytes(_CONV_TH, tw, bn, stages))


def conv_unit_origin(plan: ConvTilePlan, n: int, h: int, w: int, unit: int) -> tuple[int, int, int, int]:
    """``(image, first row, first column, first output channel)`` of work
    unit ``unit``: column block ``unit // tiles``, then pixel tile ``unit %
    tiles`` of the images in order, tiles row-major within an image (the
    kernel's mapping)."""
    tiles_w = -(-w // plan.tw)
    per_image = tiles_w * -(-h // plan.th)
    col, tile = divmod(unit, per_image * n)
    img, t = divmod(tile, per_image)
    return img, t // tiles_w * plan.th, t % tiles_w * plan.tw, col * plan.bn


def dequant_conv3x3(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                    epilogue: Epilogue | None = None, relu_input: bool = False) -> torch.Tensor:
    """``conv3x3_SAME_stride1(x [N, H, W, C] f32, dequant(q [3, 3, C, F]
    codes, scale [F])) -> [N, H, W, F]`` f32, then ``epilogue`` (an
    :class:`Epilogue` of F channels with a BatchNorm, as the forward's
    decoder convs have) where given, fused into the launch; ``relu_input``
    convolves ``torch.relu(x)`` instead, taken as the kernel reads x. On
    CUDA, C must be a multiple of 4 and x 16-byte aligned (what the
    kernel's TMA loads address)."""
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
    f = q.shape[3]
    if epilogue is not None:
        _check_epilogue(epilogue, None, (n, h, w, f), x.device)
        if epilogue.bn is None:
            raise ValueError("dequant_conv3x3's epilogue is the decoder convs': a bias and a BatchNorm")
    if x.device.type == "cpu":
        return _dequant_conv3x3_plain(x, q, scale, epilogue=epilogue, relu_input=relu_input)
    if x.data_ptr() % 16:
        raise ValueError("dequant_conv3x3 wants a 16-byte aligned activation")
    if 9 * c * f >= 2**31:
        raise ValueError(f"codes of {9 * c * f} elements exceed the kernel's 2^31 offsets")
    y = torch.empty((n, h, w, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    plan = conv_tile_plan(n, h, w, c, f)
    name = "fc_dequant_conv3x3_i8" if q.dtype == torch.int8 else "fc_dequant_conv3x3_e4m3"
    CONV_LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                        None if epilogue is None else epilogue.table.data_ptr(),
                        0 if epilogue is None else epilogue.table.shape[1], _kind(epilogue), relu_input, n, h, w,
                        c, f, plan.th, plan.tw, plan.bn, plan.stages, plan.smem, plan.blocks)
    _count(dequant_conv3x3)
    return y


dequant_conv3x3.launches = 0


# ---- fused dequant depthwise 3x3 conv (stride 1, SAME, ReLU'd input) ----


def _dequant_dwconv3x3_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    # The kernel's arithmetic: v < 0 ? 0 : v (-0.0 and NaN pass), a zero
    # pad, the taps float(q) * scale, then the nine shifted products summed
    # in (dy, dx) row-major order, each product and each sum its own op.
    n, h, w, c = x.shape
    taps = _dequant_codes_plain(q, scale).reshape(9, c)
    xp = F.pad(x.masked_fill(x < 0, 0.0), (0, 0, 1, 1, 1, 1))
    acc = xp[:, :h, :w] * taps[0]
    for t in range(1, 9):
        dy, dx = divmod(t, 3)
        acc = acc + xp[:, dy:dy + h, dx:dx + w] * taps[t]
    return acc.contiguous()


# The depthwise kernel's tiling (csrc/dequant_dw.cu): a unit of work is TH
# x TW pixels of one image and UC channels (``chunk``), 32 of them to a
# warp's lanes; its consumer warps take COLS columns each, so TW x UC / 32 =
# DWCONV_SPAN, the warps times the columns.
DWCONV_CHUNK = 32
DWCONV_SPAN = 32
_DW_MAX_STAGES = 4
_DW_ALIGN = 128  # TMA's shared-memory destination


class DwTilePlan(NamedTuple):
    """How ``dequant_dwconv3x3_kernel`` tiles one depthwise conv: a unit of
    work is ``th`` x ``tw`` output pixels of one image and ``chunk``
    channels; ``stages`` halo tiles in the ring; ``units`` units, computed
    by ``blocks`` persistent blocks (block ``b`` takes units ``b``, ``b +
    blocks``, ...); the dynamic shared memory of a block in bytes."""

    th: int
    tw: int
    chunk: int
    stages: int
    units: int
    blocks: int
    smem: int


def dwconv_smem_bytes(th: int, tw: int, chunk: int, stages: int) -> int:
    """Shared memory of a depthwise block (``dw_smem`` in
    csrc/dequant_dw.cu): per stage the f32 halo tile of ``(th + 2) x (tw +
    2)`` pixels of ``chunk`` channels and two barriers; the base's
    alignment slack."""
    return stages * ((th + 2) * (tw + 2) * chunk * 4 + 16) + _DW_ALIGN


@functools.lru_cache(maxsize=256)
def dwconv_tile_plan(n: int, h: int, w: int, c: int) -> DwTilePlan:
    """The depthwise kernel's tiles for ``x [n, h, w, c]``.

    No tile changes a sum: an output is its own 3x3 window's nine products
    in a fixed order. A unit takes 64 channels where ``c`` is a multiple of
    64 (a whole pixel of the forward's 64-channel stages: its box reads
    contiguous rows), else 32; so 16 or 32 columns. Its rows: 16 where that
    still gives three quarters of the SMs a unit and 8 rows would not give
    each SM three, else 8 (on an H100 at the forward's six stages, the
    fewer units paid off only where 8 rows left a block one or two). One
    block an SM walks over the units, and its ring holds up to 4 halo tiles
    (as many as fit a block's 227 KB, and no more than the block
    computes)."""
    if min(n, h, w, c) < 1:
        raise ValueError(f"no depthwise tiles for an empty shape: x {(n, h, w, c)}")
    chunk = 2 * DWCONV_CHUNK if c % (2 * DWCONV_CHUNK) == 0 else DWCONV_CHUNK
    tw = DWCONV_SPAN * DWCONV_CHUNK // chunk

    def units(th: int) -> int:
        return n * -(-h // th) * -(-w // tw) * -(-c // chunk)

    th = 16 if units(16) >= _SMS * 3 // 4 and units(8) < 3 * _SMS else 8
    blocks = min(units(th), _SMS)
    stages = min(-(-units(th) // blocks), _DW_MAX_STAGES)
    while stages > 1 and dwconv_smem_bytes(th, tw, chunk, stages) > _SMEM_PER_BLOCK:
        stages -= 1
    return DwTilePlan(th, tw, chunk, stages, units(th), blocks, dwconv_smem_bytes(th, tw, chunk, stages))


def dwconv_unit_origin(plan: DwTilePlan, n: int, h: int, w: int, unit: int) -> tuple[int, int, int, int]:
    """``(image, first row, first column, first channel)`` of work unit
    ``unit``: channel block ``unit // tiles``, then pixel tile ``unit %
    tiles`` of the images in order, tiles row-major within an image (the
    kernel's mapping)."""
    tiles_w = -(-w // plan.tw)
    per_image = tiles_w * -(-h // plan.th)
    block, tile = divmod(unit, per_image * n)
    img, t = divmod(tile, per_image)
    return img, t // tiles_w * plan.th, t % tiles_w * plan.tw, block * plan.chunk


def dequant_dwconv3x3(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``depthwise_conv3x3_SAME_stride1(relu(x [N, H, W, C] f32),
    dequant(q [3, 3, 1, C] codes, scale [C])) -> [N, H, W, C]`` f32, a new
    contiguous tensor. The ReLU is ``v < 0 ? 0 : v``; on the card the
    result is bitwise equal to the plain version's."""
    if x.ndim != 4 or q.ndim != 4 or tuple(q.shape) != (3, 3, 1, x.shape[3]):
        raise ValueError(f"bad depthwise shapes: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if tuple(scale.shape) != (q.shape[3],):
        raise ValueError(f"scale {tuple(scale.shape)} != per-channel ({q.shape[3]},)")
    _check_codes(q)
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"x and scale must be float32, got {x.dtype} and {scale.dtype}")
    _check_operands(x, q, scale)
    if x.device.type == "cpu":
        return _dequant_dwconv3x3_plain(x, q, scale)
    n, h, w, c = x.shape
    y = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    plan = dwconv_tile_plan(n, h, w, c)
    name = "fc_dequant_dwconv3x3_i8" if q.dtype == torch.int8 else "fc_dequant_dwconv3x3_e4m3"
    DW_LIBRARY.launch(name, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                      n, h, w, c, plan.th, plan.tw, plan.chunk, plan.stages, plan.smem, plan.blocks)
    _count(dequant_dwconv3x3)
    return y


dequant_dwconv3x3.launches = 0


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


# ---- training-side straight-through fake-quant ----


def fake_quant_leaf(w: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Straight-through int8 fake-quant of one weight tensor: symmetric
    per-channel codes along ``channel_axis`` (the last axis of a flax
    HWIO kernel; axis 0 of a torch OIHW weight), an all-zero channel
    scaled 1.0, the math of ``serve.quant.quantize_leaf`` and the plain
    ``float(q) * scale`` expansion. The forward value is the dequantized
    int8 projection; the gradient passes straight through to ``w``."""
    w32 = w.to(torch.float32)
    axis = channel_axis % w.ndim
    dims = tuple(d for d in range(w.ndim) if d != axis)
    absmax = torch.amax(torch.abs(w32), dim=dims, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127.0, 127.0).to(torch.int8)
    wq = q.to(torch.float32) * scale
    return (w32 + (wq - w32).detach()).to(w.dtype)


def fake_quant_params(params, channel_axis: int = -1):
    """:func:`fake_quant_leaf` on every leaf with a channel structure
    (ndim >= 2) of a params dict or nested dict (the leaf set
    ``quantize_variables`` quantizes); biases and BatchNorm affines pass
    through."""
    if isinstance(params, dict):
        return {k: fake_quant_params(v, channel_axis) for k, v in params.items()}
    return fake_quant_leaf(params, channel_axis) if params.ndim >= 2 else params
