"""The compressed-update wire frame: versioned, CRC-checked, self-describing.

The counterpart of ``fedcrack_tpu.compress.frames``, byte for byte. Layout
(little-endian)::

    MAGIC "FCWF" (4) | crc32c of body (4, LE uint32) | body

where ``body`` is one msgpack map, its keys in this insertion order::

    {"v": 1, "codec": str, "round": int, "base_version": int,
     "leaves": [{"shape": [...], "enc": "int8"|"topk", ...}, ...],
     "zlib": bool, "payload": bytes}

``payload`` is the per-leaf codes in leaf order (int8: ``n`` code bytes;
topk: ``k`` int32 indices then ``k`` float32 values), zlib-deflated when
``zlib`` is true. The CRC covers the whole body, so one flipped bit
anywhere is caught before any reconstruction. ``base_version`` is the
model version of the weights the delta was taken against; the server
refuses a frame whose base is not its current version. The magic cannot
collide with a raw update, whose msgpack map starts 0x8x / 0xde / 0xdf.

A decode that feeds the fold passes its reconstruction through
``fed.serialization.validate_update``: the CRC proves the bytes are the
client's, not that the tree is finite. The msgpack packer and unpacker
are the port's own (``fed.serialization``), whose exceptions carry the
msgpack package's type names, so the rejection reasons read the same.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_unflatten
from fedcrack_tpu_torch.fed.serialization import packb, unpackb
from fedcrack_tpu_torch.native import crc32c

MAGIC = b"FCWF"
FRAME_VERSION = 1

# Manifest and header bytes a frame adds over its raw payload; a
# conservative allowance (measured frames sit well under it).
FRAME_OVERHEAD_BYTES = 4096


def is_frame(blob: bytes) -> bool:
    return len(blob) >= 8 and blob[:4] == MAGIC


def expand_scales(scales: np.ndarray, bucket: int, n: int) -> np.ndarray:
    """Per-entry float32 scales from per-bucket scales, the one int8
    scale-expansion rule of both sides of the wire. An index gather, so a
    manifest declaring an absurd bucket cannot force a bucket-sized
    allocation."""
    return scales.astype(np.float32, copy=False)[np.arange(n) // int(bucket)]


@dataclass(frozen=True)
class Frame:
    codec: str
    round: int
    base_version: int
    leaves: tuple[dict, ...]
    payload: bytes


def encode_frame(
    codec: str,
    round: int,
    base_version: int,
    leaves: Sequence[dict],
    payload: bytes,
    *,
    compress: bool = True,
) -> bytes:
    """Wrap per-leaf codes into one CRC-checked frame; ``compress``
    deflates the payload at zlib level 1."""
    body_payload = zlib.compress(payload, 1) if compress else payload
    body = packb(
        {
            "v": FRAME_VERSION,
            "codec": codec,
            "round": int(round),
            "base_version": int(base_version),
            "leaves": list(leaves),
            "zlib": bool(compress),
            "payload": body_payload,
        },
        sort_keys=False,
    )
    return MAGIC + struct.pack("<I", crc32c(body)) + body


def _manifest_payload_bytes(leaves: Sequence[dict]) -> int:
    """Payload bytes the manifest claims (int8: n per leaf; topk: 8k)."""
    total = 0
    for i, spec in enumerate(leaves):
        try:
            n = 1
            for s in spec["shape"]:
                n *= int(s)
            enc = spec["enc"]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed manifest entry {i} ({e})") from e
        if enc == "int8":
            total += n
        elif enc == "topk":
            total += 8 * int(spec.get("k", 0))
        else:
            raise ValueError(f"leaf {i} has unknown encoding {enc!r}")
    return total


def decode_frame(blob: bytes, *, max_decoded_bytes: int | None = None) -> Frame:
    """Parse and integrity-check a frame; ``ValueError`` with the
    rejection reason otherwise. With ``max_decoded_bytes`` the manifest's
    implied payload must fit the bound and the inflate is capped at that
    size, so a zlib bomb is a ValueError, never a giant allocation."""
    if not is_frame(blob):
        raise ValueError("not a compressed-update frame (bad magic)")
    declared = struct.unpack("<I", blob[4:8])[0]
    body = blob[8:]
    got = crc32c(body)
    if got != declared:
        raise ValueError(
            f"frame checksum mismatch: computed {got:#010x}, "
            f"declared {declared:#010x}"
        )
    try:
        head = unpackb(body, raw=False)
    except Exception as e:  # the unpacker raises several families, as msgpack does
        raise ValueError(f"undecodable frame body ({type(e).__name__})") from e
    if not isinstance(head, dict) or head.get("v") != FRAME_VERSION:
        raise ValueError(
            f"unknown frame version {head.get('v') if isinstance(head, dict) else None!r}"
        )
    leaves = head.get("leaves")
    payload = head.get("payload")
    if not isinstance(leaves, list) or not isinstance(payload, (bytes, bytearray)):
        raise ValueError("malformed frame: missing leaves manifest or payload")
    payload = bytes(payload)
    if head.get("zlib"):
        if max_decoded_bytes is not None:
            implied = _manifest_payload_bytes(leaves)
            if implied > max_decoded_bytes:
                raise ValueError(
                    f"frame manifest implies {implied} payload bytes, "
                    f"caller bound is {max_decoded_bytes}"
                )
            try:
                payload = zlib.decompressobj().decompress(payload, implied + 1)
            except zlib.error as e:
                raise ValueError(f"frame payload inflate failed ({e})") from e
            if len(payload) > implied:
                raise ValueError(
                    "frame payload inflates past its own manifest "
                    f"({implied} bytes declared)"
                )
        else:
            try:
                payload = zlib.decompress(payload)
            except zlib.error as e:
                raise ValueError(f"frame payload inflate failed ({e})") from e
    try:
        # A CRC-valid body can still carry junk-typed fields: every
        # coercion failure surfaces as ValueError, the one family the
        # server's rejection path catches.
        return Frame(
            codec=str(head.get("codec", "")),
            round=int(head.get("round", 0)),
            base_version=int(head.get("base_version", 0)),
            leaves=tuple(dict(l) for l in leaves),
            payload=payload,
        )
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed frame fields ({e})") from e


def _reconstruct_deltas(frame: Frame) -> list[np.ndarray]:
    """Per-leaf float32 deltas from the manifest and payload, with exact
    size accounting: a manifest lying about shapes or k is a ValueError,
    never a silent mis-slice."""
    out: list[np.ndarray] = []
    off = 0
    buf = frame.payload
    for i, spec in enumerate(frame.leaves):
        try:
            shape = tuple(int(s) for s in spec["shape"])
            enc = spec["enc"]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed manifest entry {i} ({e})") from e
        n = int(np.prod(shape)) if shape else 1
        if enc == "int8":
            bucket = int(spec.get("bucket", 0))
            scales_raw = spec.get("scales", b"")
            if bucket < 1 or not isinstance(scales_raw, (bytes, bytearray)):
                raise ValueError(f"leaf {i} int8 manifest missing bucket/scales")
            scales = np.frombuffer(bytes(scales_raw), np.float32)
            if scales.size != max(1, -(-n // bucket)):
                raise ValueError(
                    f"leaf {i} carries {scales.size} scales for "
                    f"{n} entries at bucket {bucket}"
                )
            end = off + n
            if end > len(buf):
                raise ValueError(f"frame payload truncated at leaf {i}")
            q = np.frombuffer(buf, np.int8, count=n, offset=off)
            off = end
            out.append((q.astype(np.float32) * expand_scales(scales, bucket, n)).reshape(shape))
        elif enc == "topk":
            k = int(spec.get("k", 0))
            if k < 0 or k > n:
                raise ValueError(f"leaf {i} declares k={k} outside [0, {n}]")
            end = off + 8 * k
            if end > len(buf):
                raise ValueError(f"frame payload truncated at leaf {i}")
            idx = np.frombuffer(buf, np.int32, count=k, offset=off)
            vals = np.frombuffer(buf, np.float32, count=k, offset=off + 4 * k)
            off = end
            if k and (idx.min() < 0 or idx.max() >= n):
                raise ValueError(
                    f"leaf {i} sparse index out of range for {n} entries"
                )
            dense = np.zeros(n, np.float32)
            dense[idx] = vals
            out.append(dense.reshape(shape))
        else:
            raise ValueError(f"leaf {i} has unknown encoding {enc!r}")
    if off != len(buf):
        raise ValueError(
            f"frame payload has {len(buf) - off} trailing bytes past the manifest"
        )
    return out


def decode_update(
    blob: bytes,
    template: Any,
    base: Any,
    *,
    expected_base_version: int | None = None,
    expected_round: int | None = None,
) -> tuple[Any, Frame]:
    """A framed update as a full weight tree: ``base`` (the round-base
    tree) plus the frame's deltas, in ``template``'s structure and dtypes.
    ``expected_base_version`` pins the delta to the server's model
    version (stale base: rejected). ``ValueError`` on any integrity or
    consistency failure; the caller validates the result before the fold.
    """
    flat_template, treedef = tree_flatten(template)
    # The inflate bound comes from the template, not the manifest: the
    # largest honest payload is 8 bytes per entry (topk).
    total_entries = sum(
        int(np.prod(np.shape(t))) if np.shape(t) else 1 for t in flat_template
    )
    frame = decode_frame(blob, max_decoded_bytes=8 * total_entries + 1024)
    if expected_base_version is not None and frame.base_version != expected_base_version:
        raise ValueError(
            f"stale round base: frame delta is against model_version "
            f"{frame.base_version}, server is at {expected_base_version}"
        )
    if expected_round is not None and frame.round != expected_round:
        raise ValueError(
            f"frame round {frame.round} does not match message round "
            f"{expected_round}"
        )
    flat_base = tree_leaves(base)
    if len(flat_base) != len(flat_template):
        raise ValueError(
            f"base has {len(flat_base)} leaves, template expects "
            f"{len(flat_template)}"
        )
    if len(frame.leaves) != len(flat_template):
        raise ValueError(
            f"frame carries {len(frame.leaves)} leaves, template expects "
            f"{len(flat_template)}"
        )
    # Manifest shapes are pinned to the template before reconstruction:
    # the declared shape sizes every allocation below.
    for i, (spec, t) in enumerate(zip(frame.leaves, flat_template)):
        try:
            declared = tuple(int(s) for s in spec["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed manifest entry {i} ({e})") from e
        t_shape = tuple(np.shape(t))
        if declared != t_shape:
            raise ValueError(
                f"leaf {i} shape mismatch: frame {declared}, template "
                f"{t_shape}"
            )
    deltas = _reconstruct_deltas(frame)
    leaves = []
    for d, b, t in zip(deltas, flat_base, flat_template):
        t_arr = np.asarray(t)
        leaves.append(
            (np.asarray(b, np.float32) + d).astype(t_arr.dtype).reshape(t_arr.shape)
        )
    return tree_unflatten(treedef, leaves), frame
