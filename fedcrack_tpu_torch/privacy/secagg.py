"""Pairwise-mask secure aggregation (Bonawitz et al. 2017, CCS).

The counterpart of ``fedcrack_tpu.privacy.secagg``, byte for byte:

- Updates are encoded in fixed point, ``round(x * 2^bits)`` as int64, and
  all arithmetic is modular over 2^64 in numpy ``uint64``, whose
  wraparound is exactly the two's-complement residue ring, so pairwise
  masks cancel exactly. (torch has no full uint64 arithmetic, so this
  module stays in numpy.)
- Client ``i`` uploads ``n_i * fp(x_i) + sum_{j != i} s_ij * PRG(pair_seed(i,
  j))`` with ``s_ij = +1`` if ``i`` sorts before ``j``, else ``-1``. Over the
  full cohort the masks telescope to zero and the server is left with the
  weighted fixed-point sum, which it divides by ``sum n_i``.
- Dropout: a masker that uploaded nothing leaves every survivor's mask
  against it uncancelled; the server rebuilds those masks from the seeds
  exchanged at enroll and takes them out, so the round closes on the
  survivors.

Scope: the per-client seeds go to the server at enroll in band (no key
agreement, no secret sharing), so this hides updates from other clients
and from the wire, not from the server. The masked blob is
``SECAGG_MAGIC`` followed by the port's msgpack of ``{"bits", "cohort",
"leaves", "n"}``: keys sorted, as flax's serializer writes them, and each
uint64 leaf an ndarray ext. Every mask derives from an explicit
sha256-rooted seed.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_unflatten
from fedcrack_tpu_torch.fed.serialization import msgpack_restore, packb

# Wire magic of a masked upload; the acceptance gate branches on it.
SECAGG_MAGIC = b"FSA1"

# Fixed-point fractional bits by default: 2^24 keeps |x| < 2^39 exact per
# client in int64 headroom for cohort sums.
DEFAULT_BITS = 24

_U64 = np.uint64
_FULL64 = np.iinfo(np.uint64).max


def client_seed(cname: str, nonce: int = 0) -> int:
    """The per-client masking seed sent at enroll: sha256 of the client
    name (and a nonce), truncated to 63 bits so it fits the wire's signed
    int64 scalar."""
    digest = hashlib.sha256(f"fedcrack-secagg-client:{cname}:{int(nonce)}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def pair_seed(name_a: str, seed_a: int, name_b: str, seed_b: int) -> int:
    """The per-pair PRG seed, symmetric in its arguments."""
    (n1, s1), (n2, s2) = sorted(((name_a, seed_a), (name_b, seed_b)))
    digest = hashlib.sha256(f"fedcrack-secagg-pair:{n1}:{int(s1)}:{n2}:{int(s2)}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def round_roster(roster: Mapping[str, int], round_idx: int) -> dict[str, int]:
    """Mix the round index into every seed of the enroll-time roster, so
    the masks of two rounds are independent streams (a reused pad would
    leak the difference of two updates)."""
    return {
        name: int.from_bytes(
            hashlib.sha256(f"fedcrack-secagg-round:{int(seed)}:{int(round_idx)}".encode()).digest()[:8],
            "big",
        )
        for name, seed in roster.items()
    }


def pair_mask(seed: int, shapes: Iterable[tuple]) -> list[np.ndarray]:
    """One uint64 array per leaf shape, drawn from a Philox stream keyed on
    the pair seed (counter-based, the same on every platform)."""
    rng = np.random.Generator(np.random.Philox(key=int(seed)))
    return [rng.integers(0, _FULL64, size=shape, dtype=_U64, endpoint=True) for shape in shapes]


def _float64(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float64).numpy()
    return np.asarray(leaf, np.float64)


def fixed_point_encode(tree: Any, bits: int = DEFAULT_BITS) -> list[np.ndarray]:
    """Per-leaf ``round(x * 2^bits)`` as uint64 residues (the two's-
    complement view of the signed value), in flatten order."""
    scale = float(1 << int(bits))
    return [np.round(_float64(leaf) * scale).astype(np.int64).view(_U64) for leaf in tree_leaves(tree)]


def fixed_point_decode(leaves: Iterable[np.ndarray], divisor: int, bits: int, template: Any) -> Any:
    """Back to float: each residue as signed int64, divided by ``2^bits *
    divisor`` in float64, in the (numpy) template's structure, dtypes and
    shapes."""
    scale = float(1 << int(bits)) * float(divisor)
    t_leaves, treedef = tree_flatten(template)
    out = [
        (np.asarray(leaf, _U64).view(np.int64).astype(np.float64) / scale)
        .astype(np.asarray(t).dtype)
        .reshape(np.shape(t))
        for leaf, t in zip(leaves, t_leaves)
    ]
    return tree_unflatten(treedef, out)


def weighted_fixed_sum(trees: Iterable[Any], samples: Iterable[int], bits: int = DEFAULT_BITS) -> list[np.ndarray]:
    """The plaintext ``sum n_i * fp(x_i)`` in the residue ring: what the
    unmasked cohort sum must equal bit for bit."""
    total: list[np.ndarray] | None = None
    for tree, ns in zip(trees, samples):
        scaled = [leaf * _U64(int(ns)) for leaf in fixed_point_encode(tree, bits)]
        total = scaled if total is None else [a + b for a, b in zip(total, scaled)]
    if total is None:
        raise ValueError("weighted_fixed_sum over zero trees")
    return total


def mask_update(
    tree: Any,
    *,
    cname: str,
    n_samples: int,
    roster: Mapping[str, int],
    bits: int = DEFAULT_BITS,
) -> bytes:
    """Encode and mask one client's update for the wire. ``roster`` is the
    closed cohort's ``{name: seed}`` map, self included; the blob records
    the cohort it was masked against, so the server refuses a stale-roster
    upload instead of corrupting the sum."""
    if cname not in roster:
        raise ValueError(f"{cname!r} not in the masking roster")
    if int(n_samples) <= 0:
        raise ValueError(f"n_samples must be positive, got {n_samples}")
    leaves = [leaf * _U64(int(n_samples)) for leaf in fixed_point_encode(tree, bits)]
    shapes = [leaf.shape for leaf in leaves]
    for other in sorted(roster):
        if other == cname:
            continue
        mask = pair_mask(pair_seed(cname, roster[cname], other, roster[other]), shapes)
        if cname < other:
            leaves = [a + m for a, m in zip(leaves, mask)]
        else:
            leaves = [a - m for a, m in zip(leaves, mask)]
    payload = packb({"bits": int(bits), "n": int(n_samples), "cohort": list(sorted(roster)), "leaves": list(leaves)})
    return SECAGG_MAGIC + payload


def is_masked_blob(blob: bytes) -> bool:
    return isinstance(blob, (bytes, bytearray)) and bytes(blob[: len(SECAGG_MAGIC)]) == SECAGG_MAGIC


def decode_masked(blob: bytes) -> dict:
    """Parse a masked upload; raises ValueError on anything malformed."""
    if not is_masked_blob(blob):
        raise ValueError("not a secagg masked blob (bad magic)")
    try:
        doc = msgpack_restore(bytes(blob[len(SECAGG_MAGIC):]))
    except Exception as e:  # the unpacker raises several families, as msgpack does
        raise ValueError(f"undecodable masked payload ({type(e).__name__})")
    if not isinstance(doc, dict) or not {"bits", "n", "cohort", "leaves"} <= set(doc):
        raise ValueError("masked payload missing required fields")
    return doc


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaf_shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(np.asarray(leaf))


def validate_masked(blob: bytes, template: Any, *, bits: int, cohort: Iterable[str]) -> str | None:
    """The secagg arm of the acceptance gate: the reason this masked blob
    must not enter the fold, or None. Masked residues are uniformly random,
    so the contract is structural: magic, fixed-point bits, the exact
    cohort the server closed, and leaf count, shape and dtype against the
    template. The reasons are the JAX package's strings."""
    try:
        doc = decode_masked(blob)
    except ValueError as e:
        return str(e)
    if int(doc["bits"]) != int(bits):
        return f"fixed-point bits mismatch: blob {doc['bits']}, server {bits}"
    want = sorted(cohort)
    got = [str(c) for c in doc["cohort"]]
    if got != want:
        return f"mask roster mismatch: blob {got}, cohort {want}"
    t_leaves = tree_leaves(template)
    leaves = doc["leaves"]
    if len(leaves) != len(t_leaves):
        return f"leaf count mismatch: payload has {len(leaves)}, template expects {len(t_leaves)}"
    for i, (leaf, t) in enumerate(zip(leaves, t_leaves)):
        name = _dtype_name(leaf)
        if name != "uint64":
            return f"leaf {i} is {name}, wants uint64 residues"
        if _leaf_shape(leaf) != _leaf_shape(t):
            return f"leaf {i} shape mismatch: payload {_leaf_shape(leaf)}, template {_leaf_shape(t)}"
    return None


def unmask_sum(
    uploads: Mapping[str, dict],
    roster: Mapping[str, int],
    bits: int = DEFAULT_BITS,
) -> tuple[list[np.ndarray], int, list[str]]:
    """The server's fold and seed-recovery step. ``uploads`` maps each
    surviving masker to its decoded blob, ``roster`` is the full cohort's
    seed map. Survivors' residues are summed in sorted-name order, then
    every (survivor, dropped) mask is rebuilt from the seeds and taken
    out. Returns ``(sum leaves, total samples, recovered drop-out names)``."""
    survivors = sorted(uploads)
    if not survivors:
        raise ValueError("secagg fold over zero uploads")
    dropped = sorted(set(roster) - set(survivors))
    unknown = sorted(set(survivors) - set(roster))
    if unknown:
        raise ValueError(f"uploads from outside the roster: {unknown}")
    total: list[np.ndarray] | None = None
    total_samples = 0
    for name in survivors:
        doc = uploads[name]
        leaves = [np.asarray(leaf, _U64) for leaf in doc["leaves"]]
        total = leaves if total is None else [a + b for a, b in zip(total, leaves)]
        total_samples += int(doc["n"])
    shapes = [leaf.shape for leaf in total]
    for d in dropped:
        for s in survivors:
            mask = pair_mask(pair_seed(s, roster[s], d, roster[d]), shapes)
            if s < d:  # s added +mask for the pair: take it back out
                total = [a - m for a, m in zip(total, mask)]
            else:
                total = [a + m for a, m in zip(total, mask)]
    return total, total_samples, dropped


def unmasked_mean(
    total_leaves: Iterable[np.ndarray],
    total_samples: int,
    template: Any,
    bits: int = DEFAULT_BITS,
) -> Any:
    """The FedAvg mean from the unmasked weighted sum."""
    if int(total_samples) <= 0:
        raise ValueError(f"total_samples must be positive, got {total_samples}")
    return fixed_point_decode(total_leaves, int(total_samples), bits, template)
