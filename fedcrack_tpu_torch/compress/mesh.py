"""Encode∘decode twins of the update codecs for the slot plane.

The counterpart of ``fedcrack_tpu.compress.mesh``. The gRPC plane
compresses real wire bytes (``codecs``, ``frames``); the slot plane
(``parallel.fedavg_mesh``) has no wire, and what a codec changes there is
the trajectory: quantization error and sparsification delay perturb each
client's contribution before the average. These twins apply the codec's
value map to each client's round delta on the device, inside the round, so
a federation can be run with the compressed trajectory at no host cost.

- int8: QSGD bucketed symmetric quantization, a per-bucket scale
  ``||bucket||_2 / 127`` (the host codec's :func:`codecs.qsgd_scales`
  rule) and stochastic rounding ``floor(x / scale + u)``. The JAX package
  draws ``u`` from ``jax.random``; the port draws it from a
  ``torch.Generator`` seeded from the same chain (the per-call seed, the
  client, the leaf, :func:`mesh_seed`). So, as between the JAX twin and
  the host codec, the parity is distributional: the same scales, codes
  within ``[-127, 127]``, every value within one scale of its input, an
  unbiased rounding, and the same bits for the same seed on one device.
- topk_delta: per leaf, the ``leaf_k`` largest magnitudes of delta plus
  the error-feedback residual; the rest carries to the next round.
  ``torch.topk`` promises no order among equal magnitudes on CUDA, so the
  keep set comes from a stable descending sort of ``|x|``: ties go to the
  lowest index, as in ``lax.top_k`` and the host codec's stable argsort.
"""

from __future__ import annotations

import hashlib
from typing import Any

import torch

from fedcrack_tpu_torch.compress.codecs import CODEC_NAMES, QSGD_BUCKET, leaf_k
from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

MESH_CODECS = CODEC_NAMES  # same registry, same names


def mesh_seed(*parts: int) -> int:
    """A 63-bit generator seed from a chain of integers (sha256 of their
    decimal forms): the port's stand-in for ``jax.random.fold_in``."""
    text = "fedcrack-mesh:" + ":".join(str(int(p)) for p in parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "big") >> 1


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def int8_bucket_scales(segs: torch.Tensor) -> torch.Tensor:
    """Per-bucket scales of ``[n_buckets, bucket]`` float32 rows:
    ``||row||_2 / 127``, and 1.0 for an all-zero row."""
    norms = torch.sqrt(torch.sum(segs * segs, dim=1))
    return torch.where(norms > 0.0, norms / 127.0, torch.ones_like(norms))


def int8_roundtrip(tree: Any, key: tuple, bucket: int = QSGD_BUCKET) -> Any:
    """QSGD bucketed int8 quantize-dequantize of every leaf (the Int8Codec
    value map). ``key`` is the seed chain so far (per call, per client);
    leaf ``i`` draws its uniforms from ``mesh_seed(*key, i)``."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for i, x in enumerate(leaves):
        flat = x.to(torch.float32).reshape(-1)
        n = flat.numel()
        n_buckets = max(1, -(-n // bucket))
        segs = torch.nn.functional.pad(flat, (0, n_buckets * bucket - n)).reshape(n_buckets, bucket)
        scales = int8_bucket_scales(segs)
        u = torch.rand(segs.shape, generator=generator(mesh_seed(*key, i), flat.device),
                       dtype=torch.float32, device=flat.device)
        q = torch.clamp(torch.floor(segs / scales[:, None] + u), -127.0, 127.0)
        deq = (q * scales[:, None]).reshape(-1)[:n]
        out.append(deq.reshape(x.shape).to(x.dtype))
    return tree_unflatten(treedef, out)


def topk_keep(eff: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``|eff|`` of a flat tensor, ties to
    the lowest index (a stable descending sort)."""
    order = torch.sort(torch.abs(eff), descending=True, stable=True).indices
    return order[:k]


def topk_roundtrip(tree: Any, residual: Any, fraction: float) -> tuple[Any, Any]:
    """Per-leaf top-k keep of ``delta + residual``; returns ``(kept, new
    residual)``, each in ``tree``'s structure. ``k`` is ``leaf_k(n,
    fraction)``, a function of the leaf's size only."""
    flat_x, treedef = tree_flatten(tree)
    flat_r = tree_leaves(residual)
    kept_out, res_out = [], []
    for x, r in zip(flat_x, flat_r):
        eff = (x.to(torch.float32) + r.to(torch.float32)).reshape(-1)
        idx = topk_keep(eff, leaf_k(eff.numel(), fraction))
        kept = torch.zeros_like(eff)
        kept[idx] = eff[idx]
        kept_out.append(kept.reshape(x.shape).to(x.dtype))
        res_out.append((eff - kept).reshape(x.shape))
    return tree_unflatten(treedef, kept_out), tree_unflatten(treedef, res_out)


def zero_residual_like(tree: Any) -> Any:
    """A float32 zero accumulator matching ``tree``: the error-feedback
    state's round-0 value."""
    return tree_map(lambda x: torch.zeros(tuple(x.shape), dtype=torch.float32, device=x.device), tree)


def validate_mesh_codec(codec: str | None) -> str:
    name = codec or "null"
    if name not in MESH_CODECS:
        raise ValueError(f"unknown update codec {name!r}; known: {MESH_CODECS}")
    return name
