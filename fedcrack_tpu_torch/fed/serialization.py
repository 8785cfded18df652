"""Weight trees <-> msgpack bytes, byte for byte the JAX package's wire.

The counterpart of ``fedcrack_tpu.fed.serialization``, which encodes with
``flax.serialization.msgpack_serialize``. The port depends on neither
flax (absent on the card's machine) nor the ``msgpack`` package: it
carries its own packer and unpacker for the subset of msgpack that format
uses, and reproduces it:

- maps are written with their keys sorted (flax rebuilds the tree with
  ``jax.tree_util.tree_map`` first, which sorts dict keys);
- an array leaf (numpy array or torch tensor) is ext type 1 around the
  msgpack array ``[shape, dtype name, C-order bytes]`` (a numpy scalar
  too, made a 0-d array as ``jax.device_get`` makes it; flax's ext type 3
  for scalars is decoded), and ext headers take the smallest form that
  holds the payload (fixext 1/2/4/8/16, ext 8/16/32);
- Python floats are float64, strings are str (str8 allowed), bytes are bin;
- a leaf over ``MAX_CHUNK_SIZE`` bytes that is a dict value (or the whole
  tree) is written as flax's chunked form, the map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ...}}`` in that insertion order, its chunks flat
  slices of at most ``MAX_CHUNK_SIZE`` bytes; decoding joins them again;
- ``cast_dtype="bfloat16"`` writes the dtype name ``"bfloat16"`` and
  round-to-nearest-even bytes, made by torch's ``.to(torch.bfloat16)``
  (numpy has no bfloat16 without ``ml_dtypes``).

Decoding returns read-only numpy arrays, as flax's ``np.frombuffer``
gives them. A ``"bfloat16"`` leaf has no numpy form
here, so a raw decode (no template) returns it as a CPU ``torch.bfloat16``
tensor (the same bits); with a template it becomes the template's dtype
exactly (float32: the 16 bits shifted up). Errors mirror the msgpack
package's types (``ValueError`` for incomplete input, ``ExtraData``,
``FormatError``, ``UnicodeDecodeError``), since ``validate_update``'s
reasons name them.
"""

from __future__ import annotations

import collections
import struct
from typing import Any

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_unflatten

# flax.serialization.MAX_CHUNK_SIZE: a leaf above this many bytes is
# written as flat chunks of at most this many bytes. Read at call time.
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
BFLOAT16 = "bfloat16"
# The msgpack package's unpacker nests at most this deep.
_MAX_DEPTH = 1024

ExtType = collections.namedtuple("ExtType", "code data")


class ExtraData(ValueError):
    """Bytes left over after one complete object (msgpack's ExtraData)."""


class FormatError(ValueError):
    """A byte that starts no msgpack object (msgpack's FormatError)."""


class StackError(ValueError):
    """Nesting deeper than the unpacker's stack (msgpack's StackError)."""


# ---- packer ----

def _pack_int(v: int, out: list) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(struct.pack("B", v))
        elif v <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, v))
        elif v <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, v))
        elif v <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(struct.pack("b", v))
    elif v >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif v >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif v >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif v >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int | None, fix_max: int, markers: tuple, out: list) -> None:
    """The header of a str/bin/array/map of length ``n``: the fix form
    below ``fix_max`` where there is one, else 8-, 16- or 32-bit lengths
    (``markers`` lists the available ones, ``None`` where absent)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif markers[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", markers[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", markers[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", markers[2], n))
    else:
        raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _pack_bin(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_parts(x: Any) -> tuple[tuple[int, ...], str, bytes]:
    """``(shape, dtype name, C-order bytes)`` of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
            return tuple(t.shape), BFLOAT16, raw
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_payload(x: Any) -> bytes:
    shape, name, raw = _array_parts(x)
    out: list = [b"\x93"]
    _pack_len(len(shape), 0x90, 16, (None, 0xDC, 0xDD), out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bin(raw, out)
    return b"".join(out)


class _Chunked:
    """An array leaf to be written in flax's chunked form."""

    def __init__(self, arr: Any):
        self.arr = arr


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _pack_chunked(arr: Any, out: list) -> None:
    """flax's ``_chunk``: shape and chunks as maps keyed "0", "1", ... in
    index order, inside a map in insertion order."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + chunksize] for i in range(0, n, chunksize)]
    out.append(b"\x83")
    _pack_str(CHUNKED, out)
    out.append(b"\xc3")
    for key, values in (("shape", [int(d) for d in arr.shape]), ("chunks", chunks)):
        _pack_str(key, out)
        _pack_len(len(values), 0x80, 16, (None, 0xDE, 0xDF), out)
        for i, v in enumerate(values):
            _pack_str(str(i), out)
            _pack(v, out)


def _chunk_oversized(tree: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``: an array over the limit
    that is a dict value (through nested dicts only) or the whole tree."""
    if isinstance(tree, dict):
        return {
            k: _chunk_oversized(v) if isinstance(v, dict)
            else _Chunked(v) if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE
            else v
            for k, v in tree.items()
        }
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _Chunked(tree)
    return tree


def _unchunk(node: dict) -> Any:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``, as a copy."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) if isinstance(v, dict) else v for k, v in tree.items()}
    return tree


def _pack(obj: Any, out: list, sort_keys: bool = True) -> None:
    # Exact types only, as msgpack's strict_types packing in flax: a tuple
    # or a subclass of a builtin is not written as its base type.
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        _pack_str(obj, out)
    elif t is bytes:
        _pack_bin(obj, out)
    elif t is dict:
        # The tree_map rebuild in flax sorts every dict's keys.
        keys = sorted(obj) if sort_keys else list(obj)
        _pack_len(len(keys), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k in keys:
            _pack(k, out, sort_keys)
            _pack(obj[k], out, sort_keys)
    elif t is list:
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out, sort_keys)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif t is _Chunked:
        _pack_chunked(obj.arr, out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any, *, sort_keys: bool = True) -> bytes:
    """msgpack bytes of ``obj``. ``sort_keys`` writes every map with its
    keys sorted (flax's blob); without it maps keep insertion order, as
    ``msgpack.packb(obj, use_bin_type=True)`` writes them."""
    out: list = []
    _pack(obj, out, sort_keys)
    return b"".join(out)


# ---- unpacker ----

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.view[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _read(r: _Reader, depth: int, ext_hook) -> Any:
    if depth > _MAX_DEPTH:
        raise StackError("Unpack failed: stack depth exceeded")
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        return _text(r, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return [_read(r, depth + 1, ext_hook) for _ in range(b & 0x0F)]
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, depth, ext_hook)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _STR:
        return _text(r, r.unpack(_STR[b]))
    if b in _BIN:
        return bytes(r.take(r.unpack(_BIN[b])))
    if b in _ARRAY:
        return [_read(r, depth + 1, ext_hook) for _ in range(r.unpack(_ARRAY[b]))]
    if b in _MAP:
        return _read_map(r, r.unpack(_MAP[b]), depth, ext_hook)
    if b in _FIXEXT or b in _EXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_EXT[b])
        code = r.unpack(">b")
        return ext_hook(code, r.take(n))
    raise FormatError(f"Unpack failed: reserved byte 0x{b:02x}")


def _text(r: _Reader, n: int) -> Any:
    chunk = r.take(n)
    return bytes(chunk) if r.raw else str(chunk, "utf-8")


def _read_map(r: _Reader, n: int, depth: int, ext_hook) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, depth + 1, ext_hook)
        if type(key) not in (str, bytes):
            raise ValueError(f"{type(key).__name__} is not allowed for map key when strict_map_key=True")
        out[key] = _read(r, depth + 1, ext_hook)
    return out


def unpackb(data: bytes, *, raw: bool = False, ext_hook=ExtType) -> Any:
    r = _Reader(data, raw)
    obj = _read(r, 0, ext_hook)
    if r.pos != len(r.view):
        raise ExtraData(f"unpack(b) received extra data: {len(r.view) - r.pos} bytes")
    return obj


def _ndarray_from_payload(data: memoryview) -> Any:
    shape, name, buf = unpackb(data, raw=True, ext_hook=ExtType)
    if name == BFLOAT16.encode():
        bits = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_hook(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    return ExtType(code, bytes(data))


def msgpack_restore(blob: bytes) -> Any:
    """``flax.serialization.msgpack_restore``'s nested-dict decoding; a
    leaf written in chunks comes back whole."""
    return _unchunk_leaves(unpackb(blob, ext_hook=_ext_hook))


# ---- the wire API ----

def _host(leaf: Any) -> Any:
    """``jax.device_get`` of one leaf: tensors to the host, numpy scalars
    to 0-d arrays (so they are written as ext 1, not ext 3)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, np.generic):
        return np.asarray(leaf)
    return leaf


def _cast(leaf: Any, cast_dtype: str) -> Any:
    if cast_dtype == BFLOAT16:
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        return t.to(torch.bfloat16)
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return arr.astype(np.dtype(cast_dtype))


def tree_to_bytes(tree: Any, cast_dtype: str | None = None) -> bytes:
    """Serialize a tree of numpy arrays or torch tensors (any device) to
    the JAX package's msgpack bytes.

    ``cast_dtype="bfloat16"`` halves the wire size for weight broadcast
    and upload; the receiver restores float32 through its template in
    :func:`tree_from_bytes`. A leaf over ``MAX_CHUNK_SIZE`` bytes is
    written in chunks, as flax writes it.
    """
    leaves, treedef = tree_flatten(tree)
    host = [_host(leaf) for leaf in leaves]
    if cast_dtype is not None:
        host = [_cast(leaf, cast_dtype) for leaf in host]
    return packb(_chunk_oversized(tree_unflatten(treedef, host)))


def _shape(leaf: Any) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return np.shape(leaf)


def _as_float32(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float32).numpy()
    return np.asarray(leaf).astype(np.float32)


def _template_leaf(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def validate_update(blob: Any, template: Any) -> str | None:
    """Sanitation gate for an untrusted client update: the reason the blob
    must not enter the fold, or None when it is clean.

    In order: the bytes decode, the leaf count matches the template, every
    leaf's shape matches exactly (a same-size transpose would reshape into
    garbage weights), and every numeric leaf is finite. A bfloat16 wire
    cast passes: shape, not dtype, is the contract. ``blob`` may also be a
    decoded tree. The reasons are the JAX package's strings.
    """
    if isinstance(blob, (bytes, bytearray)):
        try:
            raw = msgpack_restore(bytes(blob))
        except Exception as e:  # the unpacker raises several families, as msgpack does
            return f"undecodable payload ({type(e).__name__})"
    else:
        raw = blob
    flat_raw = tree_leaves(raw)
    flat_template = tree_leaves(template)
    if len(flat_raw) != len(flat_template):
        return (
            f"leaf count mismatch: payload has {len(flat_raw)}, "
            f"template expects {len(flat_template)}"
        )
    for i, (r, t) in enumerate(zip(flat_raw, flat_template)):
        want = np.shape(_template_leaf(t))
        if _shape(r) != want:
            return f"leaf {i} shape mismatch: payload {_shape(r)}, template {want}"
        try:
            arr = _as_float32(r)
        except (TypeError, ValueError):
            return f"leaf {i} is non-numeric"
        if not np.isfinite(arr).all():
            return f"leaf {i} has non-finite values"
    return None


def tree_from_bytes(blob: bytes, template: Any | None = None) -> Any:
    """Deserialize msgpack bytes to a tree of numpy arrays.

    With a ``template`` tree the result takes the template's structure,
    leaf dtypes and shapes (a bfloat16 wire payload lands back in float32,
    exactly). Without one, returns the raw nested-dict decoding, where a
    ``"bfloat16"`` leaf is a CPU ``torch.bfloat16`` tensor.
    """
    raw = msgpack_restore(blob)
    if template is None:
        return raw
    flat_template, treedef = tree_flatten(template)
    flat_raw = tree_leaves(raw)
    if len(flat_raw) != len(flat_template):
        raise ValueError(
            f"payload has {len(flat_raw)} leaves, template expects {len(flat_template)}"
        )
    cast = []
    for r, t in zip(flat_raw, flat_template):
        t = _template_leaf(t)
        arr = _as_float32(r) if isinstance(r, torch.Tensor) else np.asarray(r)
        cast.append(arr.astype(t.dtype).reshape(np.shape(t)))
    return tree_unflatten(treedef, cast)
