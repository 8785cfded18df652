"""Input pipeline: pairing and decoding image files, transport encoding,
batching, prefetch.

The counterpart of ``fedcrack_tpu.data.pipeline``. An image directory and
a mask directory pair their files by stem (:func:`list_pairs`); the
reference's seeded split takes the train side (:func:`reference_split`);
:func:`load_example` decodes one pair to the model's contract (RGB,
resized, /255; the mask resized, then ``> 0``) with OpenCV where it
imports, else PIL and the port's compiled resize (``native/resize.cpp``),
the JAX package's choice of backend. :class:`CrackDataset` decodes batches
on a thread pool ahead of the consumer.

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
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

_INV255 = np.float32(1.0 / 255.0)

_CV2 = None
_CV2_PROBED = False


def _cv2():
    """OpenCV, or None where it does not import; probed once per process
    (a failed import is not cached by Python, and the probe sits on the
    per-sample decode path)."""
    global _CV2, _CV2_PROBED
    if not _CV2_PROBED:
        try:
            import cv2 as _mod

            _CV2 = _mod
        except ImportError:
            _CV2 = None
        _CV2_PROBED = True
    return _CV2


def list_pairs(image_dir: str, mask_dir: str) -> list[tuple[str, str]]:
    """(image_path, mask_path) pairs matched by filename stem, sorted by
    stem; hidden files and other extensions are skipped."""

    def stems(d: str) -> dict[str, str]:
        out = {}
        for fname in sorted(os.listdir(d)):
            if fname.startswith(".") or not fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                continue
            out[os.path.splitext(fname)[0]] = os.path.join(d, fname)
        return out

    imgs, masks = stems(image_dir), stems(mask_dir)
    common = sorted(imgs.keys() & masks.keys())
    if not common:
        raise FileNotFoundError(f"no paired images/masks between {image_dir!r} and {mask_dir!r}")
    return [(imgs[s], masks[s]) for s in common]


def reference_split(
    pairs: Sequence[tuple[str, str]],
    train_samples: int = 6213,
    seed: int = 1337,
) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """The reference's seeded split: shuffle with ``random.Random(seed)``
    and take the first ``train_samples`` as train (at most all but one),
    the rest as validation. Pairs shuffle together."""
    shuffled = list(pairs)
    random.Random(seed).shuffle(shuffled)
    train_samples = min(train_samples, max(1, len(shuffled) - 1))
    return shuffled[:train_samples], shuffled[train_samples:]


def load_example(
    image_path: str,
    mask_path: str,
    img_size: int,
    transport_dtype: str = "float32",
) -> tuple[np.ndarray, np.ndarray]:
    """Decode one pair: images ``[S, S, 3]`` RGB, masks ``[S, S, 1]`` in
    {0, 1}; float32 (images in [0, 1]) or, for ``transport_dtype="uint8"``,
    the resized uint8 bytes that :func:`normalize_images` turns into the
    float32 contract on the device.

    On the OpenCV path the float32 images are the uint8 bytes times the
    float32 1/255, so the two transport dtypes are bit-identical after
    normalisation. On the PIL path the float32 images interpolate in float,
    within 1/510 of the uint8 ones. Masks are bit-identical on both."""
    cv2 = _cv2()
    want_u8 = transport_dtype == "uint8"
    if cv2 is not None:
        img = cv2.imread(image_path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(image_path)
        img = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (img_size, img_size))
        m = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(mask_path)
        m = cv2.resize(m, (img_size, img_size))
        if want_u8:
            return img, (m > 0).astype(np.uint8)[..., None]
        return img.astype(np.float32) * _INV255, (m > 0).astype(np.float32)[..., None]

    from PIL import Image

    from fedcrack_tpu_torch import native

    with Image.open(image_path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    with Image.open(mask_path) as im:
        gray = np.asarray(im.convert("L"), np.uint8)
    if want_u8:
        return native.resize_u8(rgb, img_size), native.resize_binarize_u8(gray, img_size)
    return native.resize_normalize(rgb, img_size), native.resize_binarize(gray, img_size)


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
    [0, 1] images, float32 {0, 1} masks. The images may be packed by
    :func:`space_to_depth_images` for a space-to-depth model: the
    normalization is elementwise."""
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
    host memory and ``non_blocking`` copies on CUDA); a batch of tensors
    already there passes through."""
    device = torch.device(device)
    buf = collections.deque()
    it = iter(iterator)

    def put(batch):
        return tuple(a.to(device) if isinstance(a, torch.Tensor) else _to_device(np.asarray(a), device)
                     for a in batch)

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


def _to_device_now(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh device copy of ``array``, landed before this returns (the
    staging barrier). On CUDA the copy runs from pinned memory on a side
    stream, and the tensor is marked as used by the current stream, so
    the caching allocator keeps it until that stream is done with it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.clone()
    side = torch.cuda.Stream(device=device)
    with torch.cuda.stream(side):
        out = t.pin_memory().to(device, non_blocking=True)
    side.synchronize()
    out.record_stream(torch.cuda.current_stream(device))
    return out


class CrackDataset:
    """Batched, shuffled iterator over paired image files, decoding ahead
    of the consumer on ``num_workers`` threads. Yields numpy ``(images
    [B, S, S, 3], masks [B, S, S, 1])`` in ``transport_dtype``; every
    iteration is one epoch, shuffled as :class:`ArrayDataset` shuffles."""

    def __init__(
        self,
        pairs: Sequence[tuple[str, str]],
        img_size: int = 128,
        batch_size: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        transport_dtype: str = "float32",
    ):
        if not pairs:
            raise ValueError("empty dataset")
        if transport_dtype not in ("float32", "uint8"):
            raise ValueError(f"transport_dtype must be float32 or uint8, got {transport_dtype!r}")
        _check_yields_batches(len(pairs), batch_size, drop_last)
        self.pairs = list(pairs)
        self.img_size = img_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.transport_dtype = transport_dtype
        self._epoch = 0

    def __len__(self) -> int:
        return _num_batches(len(self.pairs), self.batch_size, self.drop_last)

    def _batch_indices(self) -> list[np.ndarray]:
        order = _epoch_order(len(self.pairs), self.shuffle, self.seed, self._epoch)
        return [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]

    def _load_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        dt = np.uint8 if self.transport_dtype == "uint8" else np.float32
        images = np.empty((len(idx), self.img_size, self.img_size, 3), dt)
        masks = np.empty((len(idx), self.img_size, self.img_size, 1), dt)
        for j, i in enumerate(idx):
            images[j], masks[j] = load_example(*self.pairs[i], self.img_size, transport_dtype=self.transport_dtype)
        return images, masks

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        batches = self._batch_indices()
        self._epoch += 1
        if self.num_workers <= 0:
            for idx in batches:
                yield self._load_batch(idx)
            return

        # Bounded producer/consumer: at most num_workers + prefetch batches
        # are decoding or queued (submission is lazy, so a slow consumer
        # bounds memory), and every put watches `stop`, so a consumer that
        # leaves early never strands the producer thread.
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            max_outstanding = self.num_workers + max(1, self.prefetch)
            batch_iter = iter(batches)
            pending: collections.deque = collections.deque()
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    while len(pending) < max_outstanding:
                        idx = next(batch_iter, None)
                        if idx is None:
                            break
                        pending.append(pool.submit(self._load_batch, idx))
                    if not pending:
                        break
                    fut = pending.popleft()
                    try:
                        item = ("ok", fut.result())
                    except Exception as e:  # raised again in the consumer
                        item = ("err", e)
                    if not put_or_abort(item) or item[0] == "err":
                        break
                for fut in pending:
                    fut.cancel()
            put_or_abort(("end", None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            # Unblock a producer mid-put; it leaves through the stop check.
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def space_to_depth_images(images: np.ndarray) -> np.ndarray:
    """Host-side space-to-depth for staging: ``[..., H, W, C] -> [...,
    H/2, W/2, 4C]`` in ``models.resunet.space_to_depth``'s
    block-position-major channel order, over any leading dims (a batch or
    the ``[C, steps, B, ...]`` round layout) and any dtype; a space-to-depth
    model takes either layout. Masks are never packed: the loss runs at
    full resolution."""
    *lead, h, w, c = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth_images needs even H,W; got {(h, w)}")
    x = images.reshape(*lead, h // 2, 2, w // 2, 2, c)
    n = len(lead)
    x = x.transpose(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return np.ascontiguousarray(x.reshape(*lead, h // 2, w // 2, 4 * c))


class SamplePool:
    """Deduplicated per-client sample pool: the resident data plane's
    source of truth (the counterpart of ``fedcrack_tpu.data.pipeline.
    SamplePool``).

    The streamed plane ships the same samples every round in a new shuffle
    order (``parallel.driver.shuffled_epoch_data``). This class keeps the
    deduplicated pool as a host twin (``images [C, N, H, W, ch]``,
    ``masks [C, N, H, W, 1]``, uint8 transport canon) and stages it once on
    the device (:meth:`stage`); per round only an ``[C, epochs, steps,
    batch]`` int32 gather plan ships, and the round gathers each step's
    batch on the device (``parallel.fedavg_mesh``,
    ``data_placement="resident"``). The plans consume the numpy generators
    exactly as the JAX package's do, so both draw the same plans.

    ``layout="s2d"`` stores the images packed by
    :func:`space_to_depth_images`: gathering from the packed pool equals
    packing the gathered slab, since the packing is per sample. Masks are
    never packed.

    The host twin is kept: a replay (``max_round_retries``) re-stages the
    pool from it bit for bit, and the HBM guard's fallback assembles
    streamed epoch slabs from it (:meth:`assemble_round_slab`).
    """

    LAYOUTS = ("reference", "s2d")

    def __init__(self, images: np.ndarray, masks: np.ndarray, *, layout: str = "reference"):
        if layout not in self.LAYOUTS:
            raise ValueError(f"layout must be one of {self.LAYOUTS}, got {layout!r}")
        images = np.asarray(images)
        masks = np.asarray(masks)
        if images.ndim != 5 or masks.ndim != 5:
            raise ValueError(
                "SamplePool wants [C, N, H, W, ch] images and [C, N, H, W, 1] "
                f"masks; got {images.shape} / {masks.shape}"
            )
        if images.shape[:2] != masks.shape[:2]:
            raise ValueError(
                f"images/masks disagree on [C, N]: {images.shape[:2]} vs "
                f"{masks.shape[:2]}"
            )
        if layout == "s2d":
            images = space_to_depth_images(images)
        self.images = np.ascontiguousarray(images)
        self.masks = np.ascontiguousarray(masks)
        self.layout = layout
        # Growable-pool bookkeeping (round 13 satellite, the serve→train
        # flywheel's prerequisite): per-client VALID counts (capacity may
        # exceed them after evictions) and per-client content digests of
        # the STORED sample bytes, so append() preserves the pool's
        # dedup invariant byte-exactly.
        self._counts = np.full(self.images.shape[0], self.images.shape[1], np.int64)
        # Built lazily on the first append/evict: hashing a reference-scale
        # pool costs seconds, and read-only pools (every pre-flywheel user)
        # never pay it.
        self._digests: list[dict[bytes, int]] | None = None

    @classmethod
    def stack(
        cls, client_pools: Sequence[tuple[np.ndarray, np.ndarray]], *, layout: str = "reference"
    ) -> "SamplePool":
        """Pool from per-client ``(images [N, ...], masks [N, ...])`` pairs.
        Every client must hold the same N (static shapes — the mesh round
        is one program over all clients)."""
        if not client_pools:
            raise ValueError("no client pools")
        ns = {p[0].shape[0] for p in client_pools}
        if len(ns) != 1:
            raise ValueError(f"clients disagree on pool size: {sorted(ns)}")
        return cls(
            np.stack([p[0] for p in client_pools]),
            np.stack([p[1] for p in client_pools]),
            layout=layout,
        )

    @property
    def n_clients(self) -> int:
        return self.images.shape[0]

    @property
    def n_samples(self) -> int:
        """Pool CAPACITY per client (the device array's sample axis);
        :meth:`counts` gives the per-client valid counts, which trail
        capacity after evictions."""
        return self.images.shape[1]

    @property
    def nbytes(self) -> int:
        return int(self.images.nbytes + self.masks.nbytes)

    def counts(self) -> np.ndarray:
        """Per-client valid sample counts ``[C]`` (gather plans index only
        ``[0, counts[c])``; capacity lanes past them are retired padding)."""
        return self._counts.copy()

    @staticmethod
    def _digest(image: np.ndarray, mask: np.ndarray) -> bytes:
        import hashlib

        h = hashlib.sha256(np.ascontiguousarray(image).tobytes())
        h.update(np.ascontiguousarray(mask).tobytes())
        return h.digest()

    def _ensure_digests(self) -> list[dict[bytes, int]]:
        if self._digests is None:
            self._digests = [
                {
                    self._digest(self.images[c, i], self.masks[c, i]): i
                    for i in range(int(self._counts[c]))
                }
                for c in range(self.n_clients)
            ]
        return self._digests

    def append(self, client: int, images: np.ndarray, masks: np.ndarray) -> int:
        """Grow one client's pool by the given ``[k, H, W, ch]`` samples
        (REFERENCE layout in; an ``s2d`` pool packs on the way in, exactly
        like the constructor), skipping any sample whose stored bytes are
        already in that client's pool — the dedup invariant the resident
        plane was built on survives growth. Returns how many samples were
        actually kept.

        Capacity grows for ALL clients when one client outgrows it (the
        mesh round's static shapes want one rectangular ``[C, N, ...]``
        placement); other clients' new lanes are zero padding outside
        their valid counts. The host twin stays the byte oracle: a staged
        device pool is a bit-exact copy of these arrays, so re-staging
        after an append reproduces gathers over the old indices exactly.
        """
        if not 0 <= client < self.n_clients:
            raise ValueError(f"client {client} outside [0, {self.n_clients})")
        images = np.asarray(images)
        masks = np.asarray(masks)
        if images.ndim != 4 or masks.ndim != 4:
            raise ValueError(
                "append wants [k, H, W, ch] images and [k, H, W, 1] masks; "
                f"got {images.shape} / {masks.shape}"
            )
        if images.shape[0] != masks.shape[0]:
            raise ValueError(
                f"images/masks disagree on k: {images.shape[0]} vs {masks.shape[0]}"
            )
        if self.layout == "s2d":
            images = space_to_depth_images(images)
        if images.shape[1:] != self.images.shape[2:]:
            raise ValueError(
                f"sample shape {images.shape[1:]} does not match pool "
                f"{self.images.shape[2:]}"
            )
        if masks.shape[1:] != self.masks.shape[2:]:
            raise ValueError(
                f"mask shape {masks.shape[1:]} does not match pool "
                f"{self.masks.shape[2:]}"
            )
        images = images.astype(self.images.dtype, copy=False)
        masks = masks.astype(self.masks.dtype, copy=False)
        fresh_i, fresh_m, fresh_d = [], [], []
        seen = self._ensure_digests()[client]
        for i in range(images.shape[0]):
            d = self._digest(images[i], masks[i])
            if d in seen or any(d == fd for fd in fresh_d):
                continue
            fresh_i.append(images[i])
            fresh_m.append(masks[i])
            fresh_d.append(d)
        if not fresh_i:
            return 0
        need = int(self._counts[client]) + len(fresh_i)
        if need > self.n_samples:
            grow = need - self.n_samples
            self.images = np.ascontiguousarray(
                np.concatenate(
                    [
                        self.images,
                        np.zeros(
                            (self.n_clients, grow) + self.images.shape[2:],
                            self.images.dtype,
                        ),
                    ],
                    axis=1,
                )
            )
            self.masks = np.ascontiguousarray(
                np.concatenate(
                    [
                        self.masks,
                        np.zeros(
                            (self.n_clients, grow) + self.masks.shape[2:],
                            self.masks.dtype,
                        ),
                    ],
                    axis=1,
                )
            )
        base = int(self._counts[client])
        for j, (im, mk, d) in enumerate(zip(fresh_i, fresh_m, fresh_d)):
            self.images[client, base + j] = im
            self.masks[client, base + j] = mk
            seen[d] = base + j
        self._counts[client] = base + len(fresh_i)
        return len(fresh_i)

    def evict(self, client: int, indices) -> int:
        """Retire samples from one client's pool by index. The survivors
        compact to the front IN ORDER (so a plan regenerated from the new
        counts stays dense) and the freed tail lanes zero out; capacity
        never shrinks — the device placement's shape is stable until the
        next capacity growth. Returns how many samples were evicted.
        Out-of-range / already-invalid indices are an error (silently
        ignoring them would desync the dedup digests)."""
        if not 0 <= client < self.n_clients:
            raise ValueError(f"client {client} outside [0, {self.n_clients})")
        self._ensure_digests()
        n_valid = int(self._counts[client])
        drop = sorted(set(int(i) for i in np.atleast_1d(np.asarray(indices))))
        if not drop:
            return 0
        if drop[0] < 0 or drop[-1] >= n_valid:
            raise ValueError(
                f"evict indices {drop} outside the valid range [0, {n_valid})"
            )
        drop_set = set(drop)
        keep = [i for i in range(n_valid) if i not in drop_set]
        new_imgs = self.images[client, keep]
        new_msks = self.masks[client, keep]
        self.images[client, : len(keep)] = new_imgs
        self.masks[client, : len(keep)] = new_msks
        self.images[client, len(keep) : n_valid] = 0
        self.masks[client, len(keep) : n_valid] = 0
        self._counts[client] = len(keep)
        # Remap the surviving digests to their compacted indices instead of
        # re-hashing the whole surviving pool (hashing a reference-scale
        # client costs seconds; the digests already exist).
        remap = {old: new for new, old in enumerate(keep)}
        self._digests[client] = {
            d: remap[i]
            for d, i in self._digests[client].items()
            if i in remap
        }
        return len(drop)

    def round_indices(
        self,
        rngs: Sequence[np.random.Generator],
        epochs: int,
        steps: int,
        batch_size: int,
    ) -> np.ndarray:
        """One round's gather plan: ``[C, epochs, steps, batch]`` int32.

        Per client, ONE fresh permutation of the pool per round — drawn
        exactly like ``parallel.driver.shuffled_epoch_data``
        (``rng.permutation(n)[:steps*batch]``), then tiled across the
        epochs axis (the mesh round consumes one epoch slab for all local
        epochs). Same rng state in, same trajectory out — that equivalence
        is what makes resident == streamed byte-identical (test-pinned).
        """
        if len(rngs) != self.n_clients:
            raise ValueError(f"{len(rngs)} rngs for {self.n_clients} clients")
        need = steps * batch_size
        per_client = []
        for c, rng in enumerate(rngs):
            # Permute each client's VALID samples only (== the whole pool
            # until the first append/evict, so untouched pools consume the
            # rng identically to the pre-growable plane — the byte-oracle
            # parity the resident tests pin).
            n_valid = int(self._counts[c])
            if n_valid < need:
                raise ValueError(
                    f"client {c} pool has {n_valid} valid samples, round "
                    f"needs {need}"
                )
            perm = rng.permutation(n_valid)[:need].reshape(steps, batch_size)
            per_client.append(np.broadcast_to(perm, (max(1, epochs), steps, batch_size)))
        return np.ascontiguousarray(np.stack(per_client).astype(np.int32))

    def assemble_round_slab(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host-assembled ``[C, steps, B, ...]`` epoch slab from a round's
        index array — the HBM-guard fallback's bridge back to the streamed
        plane, and the byte-identity test oracle (``pool[idx]`` on host is
        the same data movement the device gather performs).

        Requires the index array to be constant along the epochs axis (the
        round layout holds ONE epoch of data; a per-epoch-varying plan has
        no streamed equivalent)."""
        idx = np.asarray(idx)
        if idx.ndim != 4 or idx.shape[0] != self.n_clients:
            raise ValueError(
                f"idx must be [C={self.n_clients}, epochs, steps, batch]; got {idx.shape}"
            )
        if not (idx == idx[:, :1]).all():
            raise ValueError(
                "idx varies across the epochs axis: no streamed-slab equivalent"
            )
        e0 = idx[:, 0]  # [C, steps, B]
        images = np.ascontiguousarray(
            np.stack([self.images[c][e0[c]] for c in range(self.n_clients)])
        )
        masks = np.ascontiguousarray(
            np.stack([self.masks[c][e0[c]] for c in range(self.n_clients)])
        )
        return images, masks

    def stage(self, mesh) -> tuple:
        """Device placement on ``mesh.device`` (a ``parallel.make_mesh``
        value, or a device): one copy of each array, from pinned host
        memory on CUDA, waited for before returning. Returns the
        ``(images, masks)`` tensor pair the resident rounds gather from.
        Re-staging from the host twin is bit-identical (the replay
        contract)."""
        device = torch.device(getattr(mesh, "device", mesh))
        return tuple(_to_device_now(a, device) for a in (self.images, self.masks))


def split_epoch_slab(
    images: np.ndarray, masks: np.ndarray, n_chunks: int
) -> tuple[tuple[np.ndarray, ...], tuple[np.ndarray, ...]]:
    """Split one round's ``[C, steps, B, ...]`` epoch slab into ``n_chunks``
    contiguous step-range chunks (zero-copy views) for segment-grain staging.

    The chunks concatenate back to the original along the steps axis, so a
    round program consuming them in order is byte-identical to one consuming
    the monolithic slab (``parallel.fedavg_mesh.SegmentedRound``). Chunk
    boundaries follow ``np.array_split`` (first ``steps % n_chunks`` chunks
    one step longer); ``n_chunks`` is clamped to ``steps`` so tiny rounds
    never produce empty chunks. The counterpart of
    ``fedcrack_tpu.data.pipeline.split_epoch_slab``."""
    if images.shape[:3] != masks.shape[:3]:
        raise ValueError(
            f"images/masks round layouts disagree: {images.shape[:3]} vs "
            f"{masks.shape[:3]}"
        )
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    steps = images.shape[1]
    n_chunks = min(n_chunks, steps)
    bounds = np.array_split(np.arange(steps), n_chunks)
    img_chunks = tuple(images[:, b[0] : b[-1] + 1] for b in bounds)
    msk_chunks = tuple(masks[:, b[0] : b[-1] + 1] for b in bounds)
    return img_chunks, msk_chunks


def dataset_from_source(
    synthetic: int,
    image_dir: str | None,
    mask_dir: str | None,
    *,
    img_size: int,
    batch_size: int,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int | None = None,
    prefetch: int | None = None,
    pair_filter=None,
    transport_dtype: str = "float32",
):
    """One dataset from either source the entry points accept:
    ``synthetic=N`` generated fixtures (-> :class:`ArrayDataset`), or an
    image/mask directory pair (-> :class:`CrackDataset`), of which
    ``pair_filter`` selects a subset (one side of :func:`reference_split`,
    a client's shard). The batch is clamped to the dataset size."""
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
        raise ValueError("need --image-dir/--mask-dir or --synthetic N")
    pairs = list_pairs(image_dir, mask_dir)
    if pair_filter is not None:
        pairs = pair_filter(pairs)
    if not pairs:
        raise ValueError(f"no image/mask pairs selected from {image_dir!r}/{mask_dir!r}")
    kw = {}
    if num_workers is not None:
        kw["num_workers"] = num_workers
    if prefetch is not None:
        kw["prefetch"] = prefetch
    return CrackDataset(
        pairs,
        img_size=img_size,
        batch_size=max(1, min(batch_size, len(pairs))),
        seed=seed,
        drop_last=drop_last,
        transport_dtype=transport_dtype,
        **kw,
    )
