"""Input pipeline: transport encoding, in-memory batching, prefetch.

Images travel as uint8 bytes and become the model's float32-in-[0, 1]
contract on the device. The JAX package multiplies by the float32
reciprocal of 255 rather than dividing (XLA rewrites the divide into that
multiply), so the port multiplies by the same constant to stay bit-exact.

Batching follows ``fedcrack_tpu.data.pipeline``: epoch ``e`` of a dataset
seeded ``s`` shuffles with ``np.random.default_rng(s + e)``, so the two
packages draw the same batches in the same order from the same arrays.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

_INV255 = np.float32(1.0 / 255.0)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 transport bytes -> float32 in [0, 1]; float32 passes through."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) * float(_INV255)
    return images


def to_uint8_transport(
    images: np.ndarray, masks: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """float32 images in [0, 1] -> round-to-nearest uint8; masks {0, 1} ->
    uint8 {0, 1}. The inverse of :func:`normalize_images`."""
    images_u8 = np.clip(np.rint(images * np.float32(255.0)), 0, 255).astype(np.uint8)
    return images_u8, masks.astype(np.uint8)


def as_model_batch(
    images: torch.Tensor, masks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """A transport batch (uint8 or float32) in the model contract: float32
    [0, 1] images, float32 {0, 1} masks."""
    images = normalize_images(images)
    if masks.dtype == torch.uint8:
        masks = masks.to(torch.float32)
    return images, masks


def _num_batches(n_samples: int, batch_size: int, drop_last: bool) -> int:
    n = n_samples // batch_size
    if not drop_last and n_samples % batch_size:
        n += 1
    return n


def _epoch_order(n_samples: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n_samples)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


def _check_yields_batches(n_samples: int, batch_size: int, drop_last: bool) -> None:
    if _num_batches(n_samples, batch_size, drop_last) == 0:
        raise ValueError(
            f"{n_samples} samples with batch_size={batch_size} and "
            f"drop_last={drop_last} would yield zero batches — training would "
            "silently be a no-op"
        )


class ArrayDataset:
    """In-memory (images, masks) batcher yielding numpy batches; every
    iteration is one epoch with its own shuffle."""

    def __init__(
        self,
        images: np.ndarray,
        masks: np.ndarray,
        batch_size: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if len(images) != len(masks) or len(images) == 0:
            raise ValueError("images/masks length mismatch or empty")
        _check_yields_batches(len(images), batch_size, drop_last)
        self.images, self.masks = images, masks
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        return _num_batches(len(self.images), self.batch_size, self.drop_last)

    def __iter__(self):
        order = _epoch_order(len(self.images), self.shuffle, self.seed, self._epoch)
        self._epoch += 1
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            yield self.images[idx], self.masks[idx]


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        # Pinned staging lets the copy run asynchronously on the stream.
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, device: torch.device | str, size: int = 2):
    """Overlap host batching with device compute: copy each numpy batch to
    ``device`` ``size`` batches ahead of the one being consumed (pinned
    host memory and ``non_blocking`` copies on CUDA)."""
    device = torch.device(device)
    buf = collections.deque()
    it = iter(iterator)

    def put(batch):
        return tuple(_to_device(np.asarray(a), device) for a in batch)

    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield nxt


def dataset_from_source(
    synthetic: int,
    image_dir: str | None,
    mask_dir: str | None,
    *,
    img_size: int,
    batch_size: int,
    seed: int = 0,
    drop_last: bool = True,
):
    """One dataset from either source the entry points accept:
    ``synthetic=N`` generated fixtures (-> :class:`ArrayDataset`, the batch
    clamped to the dataset size), or an image/mask directory pair, whose
    decode (``CrackDataset``) is not ported yet."""
    if synthetic:
        images, masks = synth_crack_batch(synthetic, img_size, seed=seed)
        return ArrayDataset(
            images,
            masks,
            batch_size=max(1, min(batch_size, len(images))),
            seed=seed,
            drop_last=drop_last,
        )
    if not (image_dir and mask_dir):
        raise ValueError("need an image/mask directory pair or synthetic=N")
    raise NotImplementedError(
        "image-directory datasets (CrackDataset: decode, resize, prefetch "
        "workers) belong to a later slice of the port; use synthetic=N"
    )
