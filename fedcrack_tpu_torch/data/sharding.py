"""Client shard assignment for federated training (the counterpart of
``fedcrack_tpu.data.sharding``): IID, or non-IID skewed by per-sample
crack density. Every client computes the same deterministic assignment and
takes its own row, so shards are disjoint and cover without coordination.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def partition_iid(n_samples: int, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    """Uniform random disjoint shards of near-equal size."""
    if num_clients <= 0:
        raise ValueError("num_clients must be positive")
    order = np.arange(n_samples)
    np.random.default_rng(seed).shuffle(order)
    return [np.sort(s) for s in np.array_split(order, num_clients)]


def partition_skew(
    scores: Sequence[float],
    num_clients: int,
    alpha: float = 0.3,
    seed: int = 0,
) -> list[np.ndarray]:
    """Non-IID shards skewed by a per-sample score: samples are bucketed
    into ``num_clients`` score quantiles and a Dirichlet(alpha) draw per
    bucket, biased toward its home client, spreads each bucket over the
    clients (small alpha: each client sees mostly one density regime).
    Shards are disjoint and cover; none is empty when the data allows."""
    if num_clients <= 0:
        raise ValueError("num_clients must be positive")
    scores = np.asarray(scores, np.float64)
    n = scores.shape[0]
    rng = np.random.default_rng(seed)
    buckets = np.array_split(np.argsort(scores, kind="stable"), num_clients)

    shards: list[list[int]] = [[] for _ in range(num_clients)]
    for b, bucket in enumerate(buckets):
        props = rng.dirichlet(np.full(num_clients, alpha) + (np.arange(num_clients) == b))
        counts = np.floor(props * len(bucket)).astype(int)
        counts[b] += len(bucket) - counts.sum()  # the remainder stays home
        perm = rng.permutation(bucket)
        start = 0
        for c in range(num_clients):
            shards[c].extend(perm[start : start + counts[c]].tolist())
            start += counts[c]
    # An empty shard would drop a client at startup: move one sample from
    # the largest shard until none is empty, where the dataset allows it.
    if n >= num_clients:
        while any(len(s) == 0 for s in shards):
            src = max(range(num_clients), key=lambda c: len(shards[c]))
            dst = next(c for c in range(num_clients) if not shards[c])
            shards[dst].append(shards[src].pop())
    return [np.sort(np.asarray(s, dtype=np.int64)) for s in shards]


def crack_density(masks: np.ndarray) -> np.ndarray:
    """Per-sample fraction of crack pixels, the default skew score."""
    masks = np.asarray(masks)
    return masks.reshape(masks.shape[0], -1).mean(axis=1)


def mask_density_scores(pairs: Sequence[tuple[str, str]], img_size: int = 64) -> np.ndarray:
    """Crack-density score per (image, mask) pair from the masks decoded
    at a small size, on a thread pool.

    Always PIL and the compiled resize, never OpenCV: every client must
    compute bit-identical scores or the uncoordinated assignment stops
    being disjoint, and OpenCV's and PIL's grayscale conversions can differ
    by a bit."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from fedcrack_tpu_torch import native

    def score_one(pair):
        with Image.open(pair[1]) as im:
            mask = np.asarray(im.convert("L"))
        return float(native.resize_binarize(mask, img_size).mean())

    with ThreadPoolExecutor(max_workers=8) as pool:
        scores = list(pool.map(score_one, pairs))
    return np.asarray(scores, np.float64)


def shard_pairs(
    pairs: Sequence[tuple[str, str]],
    num_clients: int,
    client_index: int,
    partition: str = "iid",
    alpha: float = 0.3,
    seed: int = 0,
) -> list[tuple[str, str]]:
    """This client's shard of the pair list (``partition``: iid or skew)."""
    if not 0 <= client_index < num_clients:
        raise ValueError(f"client_index {client_index} out of range for {num_clients} clients")
    if num_clients == 1:
        return list(pairs)
    if partition == "iid":
        shards = partition_iid(len(pairs), num_clients, seed=seed)
    elif partition == "skew":
        shards = partition_skew(mask_density_scores(pairs), num_clients, alpha=alpha, seed=seed)
    else:
        raise ValueError(f"unknown partition {partition!r} (iid or skew)")
    return [pairs[i] for i in shards[client_index]]
