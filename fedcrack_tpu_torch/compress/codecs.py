"""Client-side update codecs: how a round's weight update becomes wire bytes.

The counterpart of ``fedcrack_tpu.compress.codecs``, frame for frame.
Three codecs, negotiated in band (the server advertises ``update_codec``
at enroll):

- :class:`NullCodec` returns the msgpack blob unchanged: the wire carries
  exactly the raw bytes.
- :class:`Int8Codec` quantizes the round delta (trained weights minus the
  round-base global the client pulled) QSGD-style: fixed-size buckets per
  leaf, each scaled by ``||bucket||_2 / 127`` (float32 scales in the frame
  manifest), codes rounded stochastically (``floor(x/scale + u)``) from a
  numpy generator seeded by (client, round, base version, leaf), so an
  encode is a pure function of its inputs and byte-equal to the JAX
  package's. Most codes land in {-1, 0, 1} and the frame's zlib pass
  packs them well below 8 bits.
- :class:`TopKDeltaCodec` sends the k largest-magnitude entries of
  (delta + accumulated residual) per leaf and carries the rest forward
  (Lin et al.'s error feedback): nothing is lost, only delayed.

Every codec works on the client's msgpack blobs. Delta math is float32
numpy: a bfloat16 wire blob decodes to CPU ``torch.bfloat16`` tensors
(numpy has no bfloat16), which are widened exactly to float32 first.
Codec instances are per client: the top-k residual is client state.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.compress import frames
from fedcrack_tpu_torch.fed.pytree import tree_leaves
from fedcrack_tpu_torch.fed.serialization import tree_from_bytes

CODEC_NULL = "null"
CODEC_INT8 = "int8"
CODEC_TOPK = "topk_delta"
CODEC_NAMES = (CODEC_NULL, CODEC_INT8, CODEC_TOPK)

# Default top-k keep fraction: 1% of each leaf's entries (8 bytes per kept
# entry against 4 per dense float32: 50x before framing).
DEFAULT_TOPK_FRACTION = 0.01

# Int8Codec (QSGD) bucket size: larger buckets give sparser codes and
# better zlib ratios at more relative quantization noise (sqrt(B)/127).
QSGD_BUCKET = 16384


def _f32(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def _f32_leaves(blob: bytes) -> list[np.ndarray]:
    """A blob's leaves as float32 numpy arrays, in the JAX package's leaf
    order; a bfloat16 wire leaf widens exactly."""
    return [_f32(leaf) for leaf in tree_leaves(tree_from_bytes(blob))]


def _delta_leaves(blob: bytes, base_blob: bytes) -> list[np.ndarray]:
    update = _f32_leaves(blob)
    base = _f32_leaves(base_blob)
    if len(update) != len(base):
        raise ValueError(
            f"update has {len(update)} leaves, round base has {len(base)} — "
            "cannot form a delta (did the model change mid-federation?)"
        )
    out = []
    for i, (u, b) in enumerate(zip(update, base)):
        if u.shape != b.shape:
            raise ValueError(
                f"leaf {i} shape mismatch vs round base: {u.shape} vs {b.shape}"
            )
        out.append(u - b)
    return out


def qsgd_scales(flat: np.ndarray, bucket: int = QSGD_BUCKET) -> np.ndarray:
    """Per-bucket QSGD scales of a flat leaf: ``||bucket||_2 / 127``, and
    1.0 for an all-zero bucket."""
    n = flat.size
    n_buckets = max(1, -(-n // bucket))
    scales = np.empty(n_buckets, np.float32)
    for bi in range(n_buckets):
        norm = float(np.linalg.norm(flat[bi * bucket : (bi + 1) * bucket]))
        scales[bi] = norm / 127.0 if norm > 0.0 else 1.0
    return scales


def int8_quantize(
    flat: np.ndarray,
    *,
    bucket: int = QSGD_BUCKET,
    seed: Sequence[int] = (0,),
) -> tuple[np.ndarray, np.ndarray]:
    """QSGD int8 codes of a flat leaf: per-bucket norm scale, stochastic
    rounding ``floor(x/scale + u)`` with ``u`` from
    ``np.random.default_rng(seed)``, unbiased and deterministic per seed.
    Codes stay within |127| since ``|x| <= ||bucket||_2``. Returns
    ``(codes int8, scales float32)``."""
    scales = qsgd_scales(flat, bucket)
    rng = np.random.default_rng(list(seed))
    q = np.empty(flat.size, np.int8)
    for bi in range(scales.size):
        seg = flat[bi * bucket : (bi + 1) * bucket]
        codes = np.floor(seg / scales[bi] + rng.random(seg.size))
        q[bi * bucket : bi * bucket + seg.size] = np.clip(codes, -127, 127)
    return q, scales


def int8_dequantize(
    q: np.ndarray, scales: np.ndarray, bucket: int = QSGD_BUCKET
) -> np.ndarray:
    """Inverse of :func:`int8_quantize` (flat float32), through the one
    shared rule :func:`frames.expand_scales`."""
    return q.astype(np.float32) * frames.expand_scales(scales, bucket, q.size)


def topk_select(leaf: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest-|value| entries of a leaf, ascending; ties
    go to the lowest index, so an encode is deterministic."""
    flat = np.abs(leaf.ravel())
    k = min(k, flat.size)
    order = np.argsort(-flat, kind="stable")[:k]
    return np.sort(order).astype(np.int32)


def leaf_k(n: int, fraction: float) -> int:
    """Per-leaf keep count: ceil(fraction * n), at least one entry."""
    return max(1, min(n, math.ceil(fraction * n)))


class Codec:
    """One client's update encoder: trained blob (and the round-base blob
    it pulled) to wire bytes. The server-side decode is
    :func:`frames.decode_update`."""

    name: str = "base"

    def encode_update(
        self,
        blob: bytes,
        base_blob: bytes | None,
        *,
        round: int = 0,
        base_version: int = 0,
    ) -> bytes:
        raise NotImplementedError

    def reset(self) -> None:
        """Drop any cross-round state (error-feedback residuals)."""

    def rollback_last(self) -> None:
        """Undo the last encode's cross-round state commit: the transport
        calls this when the server did not average that upload (a
        straggler resynced past quorum), so its transmitted mass comes
        back into the residual. No-op for stateless codecs."""


class NullCodec(Codec):
    """Identity: the wire carries exactly the raw msgpack bytes."""

    name = CODEC_NULL

    def encode_update(
        self,
        blob: bytes,
        base_blob: bytes | None = None,
        *,
        round: int = 0,
        base_version: int = 0,
    ) -> bytes:
        return blob


class Int8Codec(Codec):
    """QSGD bucketed int8 quantization of the round delta. ``client_tag``
    (the transport passes the client's name) decorrelates the rounding
    streams across the cohort, so the averaged model's quantization noise
    shrinks with the cohort instead of adding up."""

    name = CODEC_INT8

    def __init__(self, bucket: int = QSGD_BUCKET, client_tag: str = ""):
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.bucket = int(bucket)
        self.client_seed = zlib.crc32(client_tag.encode("utf-8"))

    def encode_update(
        self,
        blob: bytes,
        base_blob: bytes | None,
        *,
        round: int = 0,
        base_version: int = 0,
    ) -> bytes:
        if base_blob is None:
            raise ValueError("int8 codec needs the round-base blob (delta codec)")
        manifest = []
        payload = bytearray()
        for i, d in enumerate(_delta_leaves(blob, base_blob)):
            if not np.isfinite(d).all():
                # Quantizing a NaN/Inf delta would hide the poison in a
                # plausible frame; the raw path ships it to the server's gate.
                raise ValueError(
                    f"leaf {i} delta is non-finite; refusing to encode"
                )
            q, scales = int8_quantize(
                d.ravel(),
                bucket=self.bucket,
                seed=(
                    self.client_seed,
                    round & 0xFFFFFFFF,
                    base_version & 0xFFFFFFFF,
                    i,
                ),
            )
            manifest.append(
                {
                    "shape": list(d.shape),
                    "enc": "int8",
                    "scales": scales.tobytes(),
                    "bucket": self.bucket,
                }
            )
            payload += q.tobytes()
        return frames.encode_frame(
            self.name, round, base_version, manifest, bytes(payload)
        )


class TopKDeltaCodec(Codec):
    """Top-k sparsified round delta with an error-feedback residual: each
    round sends, per leaf, the ``ceil(fraction * n)`` largest-magnitude
    entries of ``delta + residual`` and keeps the rest for the next."""

    name = CODEC_TOPK

    def __init__(self, fraction: float = DEFAULT_TOPK_FRACTION):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        # Per-leaf residuals, zero at the first encode and dropped when the
        # leaf structure changes.
        self._residual: list[np.ndarray] | None = None
        # The last encode's delta + residual: the rollback target while that
        # upload may still be refused.
        self._rollback: list[np.ndarray] | None = None

    def reset(self) -> None:
        self._residual = None
        self._rollback = None

    def rollback_last(self) -> None:
        if self._rollback is not None:
            self._residual = self._rollback
            self._rollback = None

    def residual_mass(self) -> float:
        """Total |residual| mass."""
        if self._residual is None:
            return 0.0
        return float(sum(np.sum(np.abs(r)) for r in self._residual))

    def encode_update(
        self,
        blob: bytes,
        base_blob: bytes | None,
        *,
        round: int = 0,
        base_version: int = 0,
        ef_decay: float = 1.0,
    ) -> bytes:
        """``ef_decay`` scales the residual kept for the next round (1.0:
        the classic accumulator)."""
        if not 0.0 <= ef_decay <= 1.0:
            raise ValueError(f"ef_decay must be in [0, 1], got {ef_decay}")
        if base_blob is None:
            raise ValueError("topk_delta codec needs the round-base blob")
        deltas = _delta_leaves(blob, base_blob)
        if self._residual is not None and (
            len(self._residual) != len(deltas)
            or any(r.shape != d.shape for r, d in zip(self._residual, deltas))
        ):
            self._residual = None  # the model's structure changed
        if self._residual is None:
            self._residual = [np.zeros_like(d) for d in deltas]
        manifest = []
        payload = bytearray()
        new_residual = []
        for i, (d, r) in enumerate(zip(deltas, self._residual)):
            if not np.isfinite(d).all():
                # NaNs sort last, so a poisoned delta would send a finite
                # top-k and keep the NaNs in the residual forever.
                raise ValueError(
                    f"leaf {i} delta is non-finite; refusing to encode"
                )
            eff = (d + r).ravel()
            k = leaf_k(eff.size, self.fraction)
            idx = topk_select(eff, k)
            vals = eff[idx].astype(np.float32)
            manifest.append({"shape": list(d.shape), "enc": "topk", "k": int(k)})
            payload += idx.tobytes() + vals.tobytes()
            rem = eff.copy()
            rem[idx] = 0.0
            if ef_decay != 1.0:
                rem = rem * np.float32(ef_decay)
            new_residual.append(rem.reshape(d.shape))
        self._rollback = [(d + r) for d, r in zip(deltas, self._residual)]
        self._residual = new_residual
        return frames.encode_frame(
            self.name, round, base_version, manifest, bytes(payload)
        )


def get_codec(
    name: str,
    *,
    topk_fraction: float = DEFAULT_TOPK_FRACTION,
    client_tag: str = "",
) -> Codec:
    """A fresh codec per call (top-k state is per client)."""
    if name in ("", CODEC_NULL, None):
        return NullCodec()
    if name == CODEC_INT8:
        return Int8Codec(client_tag=client_tag)
    if name == CODEC_TOPK:
        return TopKDeltaCodec(fraction=topk_fraction)
    raise ValueError(f"unknown update codec {name!r}; known: {CODEC_NAMES}")


def encoded_bytes_model(
    leaf_sizes: Sequence[int],
    codec: str,
    *,
    topk_fraction: float = DEFAULT_TOPK_FRACTION,
) -> int:
    """Analytic pre-zlib wire bytes of one update under ``codec``: dense
    float32 for null, one byte per entry plus the scales for int8, eight
    bytes per kept entry for topk, and 16 bytes of manifest per leaf."""
    per_leaf_overhead = 16
    if codec in ("", CODEC_NULL):
        return int(sum(4 * n for n in leaf_sizes))
    if codec == CODEC_INT8:
        return int(
            sum(
                n + 4 * max(1, -(-n // QSGD_BUCKET)) + per_leaf_overhead
                for n in leaf_sizes
            )
        )
    if codec == CODEC_TOPK:
        return int(
            sum(8 * leaf_k(n, topk_fraction) + per_leaf_overhead for n in leaf_sizes)
        )
    raise ValueError(f"unknown update codec {codec!r}; known: {CODEC_NAMES}")
