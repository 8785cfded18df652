"""The port's image data (native/resize.cpp, data/pipeline.py,
data/sharding.py) held against the JAX package on the same directories.

Images are made from a seed with numpy and written to ``tmp_path``: JPEG
images and PNG masks by OpenCV (``write_synthetic_dataset``), and PNGs of
odd sizes by PIL. Both decode backends run in both packages; the PIL path
is forced by setting each package's OpenCV probe to "absent". Decoded
bytes, batches, splits and shards must be equal, not close. The compiled
resize is byte-equal to its numpy version at every size, and to the JAX
package's at the power-of-two sizes the pipeline decodes to (the JAX
build fuses a multiply-add in the source geometry, which moves its bytes
at other ratios; ROADMAP Queue 3).
"""

import os
import threading

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def cv2_dirs(tmp_path_factory):
    from fedcrack_tpu_torch.data.synthetic import write_synthetic_dataset

    return write_synthetic_dataset(str(tmp_path_factory.mktemp("cv2ds")), n=13, img_size=48, seed=7)


@pytest.fixture(scope="module")
def pil_dirs(tmp_path_factory):
    """PNG pairs of odd, differing sizes written by PIL, plus files that
    must not pair: an unpaired image, a hidden file, another extension."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pilds")
    image_dir, mask_dir = str(root / "images"), str(root / "masks")
    os.makedirs(image_dir)
    os.makedirs(mask_dir)
    rng = np.random.default_rng(3)
    for i in range(9):
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(f"{image_dir}/p{i:02d}.png")
        mask = (rng.random((h, w)) > 0.8).astype(np.uint8) * 255
        Image.fromarray(mask).save(f"{mask_dir}/p{i:02d}.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(f"{image_dir}/unpaired.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(f"{mask_dir}/.hidden.png")
    with open(f"{image_dir}/notes.txt", "w") as f:
        f.write("not an image")
    return image_dir, mask_dir


@pytest.fixture(params=["cv2", "pil"])
def backend(request, monkeypatch):
    """Both packages on one decode backend: OpenCV, or PIL with the
    compiled resize (each package's OpenCV probe set to absent)."""
    from fedcrack_tpu.data import pipeline as jp
    from fedcrack_tpu_torch.data import pipeline as tp

    if request.param == "pil":
        for mod in (jp, tp):
            monkeypatch.setattr(mod, "_CV2", None)
            monkeypatch.setattr(mod, "_CV2_PROBED", True)
    else:
        assert jp._cv2() is not None and tp._cv2() is not None
    return request.param


def _packages():
    from fedcrack_tpu.data import pipeline as jp
    from fedcrack_tpu_torch.data import pipeline as tp

    return jp, tp


def test_list_pairs_and_reference_split_match_jax(cv2_dirs, pil_dirs):
    jp, tp = _packages()
    for dirs in (cv2_dirs, pil_dirs):
        pairs = tp.list_pairs(*dirs)
        assert pairs == jp.list_pairs(*dirs)
        assert all(os.path.basename(i)[:-4] == os.path.basename(m)[:-4] for i, m in pairs)
        for n_train, seed in ((6213, 1337), (5, 1337), (3, 7), (0, 2)):
            assert tp.reference_split(pairs, n_train, seed) == jp.reference_split(pairs, n_train, seed)
    assert len(tp.list_pairs(*pil_dirs)) == 9
    with pytest.raises(FileNotFoundError):
        tp.list_pairs(pil_dirs[0], cv2_dirs[1])


@pytest.mark.parametrize("transport", ["uint8", "float32"])
@pytest.mark.parametrize("size", [32, 64])
def test_load_example_byte_equal_to_jax(backend, transport, size, cv2_dirs, pil_dirs):
    jp, tp = _packages()
    for dirs in (cv2_dirs, pil_dirs):
        for img_path, mask_path in tp.list_pairs(*dirs):
            got = tp.load_example(img_path, mask_path, size, transport_dtype=transport)
            want = jp.load_example(img_path, mask_path, size, transport_dtype=transport)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == (np.uint8 if transport == "uint8" else np.float32)
                assert g.shape == w.shape and g.tobytes() == w.tobytes(), (backend, img_path)
    with pytest.raises(FileNotFoundError):
        tp.load_example(os.path.join(dirs[0], "missing.png"), mask_path, size)


def test_transport_contracts_on_both_backends(backend, cv2_dirs, pil_dirs):
    """OpenCV: uint8 transport normalizes to the float32 decode bit for
    bit. PIL: within half a uint8 step (1/510). Masks: equal on both."""
    import torch

    _, tp = _packages()
    for dirs in (cv2_dirs, pil_dirs):
        for img_path, mask_path in tp.list_pairs(*dirs):
            ui, um = tp.load_example(img_path, mask_path, 32, transport_dtype="uint8")
            fi, fm = tp.load_example(img_path, mask_path, 32, transport_dtype="float32")
            ni, nm = (t.numpy() for t in tp.as_model_batch(torch.from_numpy(ui), torch.from_numpy(um)))
            if backend == "cv2":
                np.testing.assert_array_equal(ni, fi)
            else:
                np.testing.assert_allclose(ni, fi, rtol=0, atol=0.5 / 255.0 + 1e-6)
            np.testing.assert_array_equal(nm, fm)
            assert set(np.unique(fm)) <= {0.0, 1.0}


@pytest.mark.parametrize("fn", ["resize_normalize", "resize_binarize", "resize_u8", "resize_binarize_u8"])
def test_native_resize_byte_equal_to_jax_and_to_numpy(fn):
    from fedcrack_tpu import native as jn
    from fedcrack_tpu_torch import native as tn

    binarize, u8 = "binarize" in fn, fn.endswith("u8")
    rng = np.random.default_rng(5)
    for size in (16, 32, 64, 128, 300):
        for h, w in ((97, 203), (448, 448), (16, 16), (1, 5), (301, 77)):
            if binarize:
                img = (rng.random((h, w)) > 0.7).astype(np.uint8) * 255
                src = img[..., None]
            else:
                img = src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            got = getattr(tn, fn)(img, size)
            plain = tn._resize_numpy(src, size, 1.0 if (binarize or u8) else 1.0 / 255.0, binarize, 0.5,
                                     np.uint8 if u8 else np.float32)
            want = getattr(jn, fn)(img, size)
            assert got.dtype == plain.dtype == want.dtype and got.shape == plain.shape == want.shape
            assert got.tobytes() == plain.tobytes(), (size, h, w)
            if size & (size - 1) == 0:
                assert got.tobytes() == want.tobytes(), (size, h, w)
            elif u8:
                assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
            elif binarize:
                assert (got != want).mean() < 0.01
            else:
                # A fused multiply-add moves a source coordinate by at most
                # one float32 ulp of the source extent; a pixel step is at
                # most 1 after the /255.
                atol = float(np.spacing(np.float32(max(h, w))))
                np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    with pytest.raises(ValueError):
        tn.resize_u8(np.zeros((2, 2, 2, 2), np.uint8), 4)


@pytest.mark.parametrize("transport", ["uint8", "float32"])
@pytest.mark.parametrize("workers", [0, 3])
def test_crack_dataset_batches_byte_equal_to_jax(backend, transport, workers, cv2_dirs, pil_dirs):
    """Two epochs (each reshuffled from seed + epoch), ragged last batch
    kept and dropped."""
    jp, tp = _packages()
    for dirs, drop_last in ((cv2_dirs, True), (pil_dirs, False)):
        pairs = tp.list_pairs(*dirs)
        kw = dict(img_size=32, batch_size=4, seed=11, num_workers=workers, prefetch=1, drop_last=drop_last,
                  transport_dtype=transport)
        got_ds, want_ds = tp.CrackDataset(pairs, **kw), jp.CrackDataset(pairs, **kw)
        assert len(got_ds) == len(want_ds) == (len(pairs) // 4 if drop_last else -(-len(pairs) // 4))
        for _ in range(2):
            got, want = list(got_ds), list(want_ds)
            assert len(got) == len(want) == len(got_ds)
            for (gi, gm), (wi, wm) in zip(got, want):
                assert gi.dtype == wi.dtype and gi.tobytes() == wi.tobytes()
                assert gm.dtype == wm.dtype and gm.tobytes() == wm.tobytes()
        assert got_ds._epoch == want_ds._epoch == 2


def test_crack_dataset_early_exit_and_errors(cv2_dirs, tmp_path):
    _, tp = _packages()
    pairs = tp.list_pairs(*cv2_dirs)
    before = threading.active_count()
    for _ in range(3):
        it = iter(tp.CrackDataset(pairs, img_size=32, batch_size=2, prefetch=1, num_workers=2))
        next(it)
        it.close()  # the consumer leaves mid-epoch
    assert threading.active_count() <= before + 1, "producer threads leaked"
    # A decode error in a worker reaches the consumer, and no thread stays.
    broken = pairs[:3] + [(str(tmp_path / "gone.png"), pairs[0][1])]
    with pytest.raises(FileNotFoundError):
        list(tp.CrackDataset(broken, img_size=32, batch_size=2, shuffle=False, num_workers=2))
    assert threading.active_count() <= before + 1
    with pytest.raises(ValueError):
        tp.CrackDataset([], img_size=32)
    with pytest.raises(ValueError):
        tp.CrackDataset(pairs, img_size=32, transport_dtype="bfloat16")
    with pytest.raises(ValueError, match="zero batches"):
        tp.CrackDataset(pairs[:3], img_size=32, batch_size=4)


@pytest.mark.parametrize("partition", ["iid", "skew"])
@pytest.mark.parametrize("num_clients", [1, 2, 3])
def test_shard_pairs_match_jax(partition, num_clients, cv2_dirs, pil_dirs):
    from fedcrack_tpu.data import sharding as js
    from fedcrack_tpu_torch.data import sharding as ts

    _, tp = _packages()
    for dirs in (cv2_dirs, pil_dirs):
        pairs = tp.list_pairs(*dirs)
        shards = []
        for i in range(num_clients):
            got = ts.shard_pairs(pairs, num_clients, i, partition=partition, alpha=0.3, seed=5)
            assert got == js.shard_pairs(pairs, num_clients, i, partition=partition, alpha=0.3, seed=5)
            shards += got
        assert sorted(shards) == sorted(pairs)  # disjoint and covering
    with pytest.raises(ValueError):
        ts.shard_pairs(pairs, 2, 2)
    with pytest.raises(ValueError):
        ts.shard_pairs(pairs, 2, 0, partition="dirichlet")


def test_mask_density_scores_and_partitions_bit_equal_to_jax(backend, cv2_dirs, pil_dirs):
    """The scores take PIL and the compiled resize on either backend."""
    from fedcrack_tpu.data import sharding as js
    from fedcrack_tpu_torch.data import sharding as ts

    _, tp = _packages()
    for dirs in (cv2_dirs, pil_dirs):
        pairs = tp.list_pairs(*dirs)
        for size in (32, 64):
            got, want = ts.mask_density_scores(pairs, size), js.mask_density_scores(pairs, size)
            assert got.dtype == want.dtype == np.float64 and got.tobytes() == want.tobytes()
    rng = np.random.default_rng(2)
    scores = rng.random(40)
    for k, alpha, seed in ((3, 0.3, 0), (5, 0.05, 4), (40, 1.0, 1), (50, 0.3, 2)):
        got, want = ts.partition_skew(scores, k, alpha, seed), js.partition_skew(scores, k, alpha, seed)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        got, want = ts.partition_iid(40, k, seed), js.partition_iid(40, k, seed)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    masks = (rng.random((4, 8, 8, 1)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(ts.crack_density(masks), js.crack_density(masks))


def test_dataset_from_source_image_branch_matches_jax(backend, cv2_dirs):
    jp, tp = _packages()

    def first_half(pairs):
        return pairs[: len(pairs) // 2]

    for kw in (dict(batch_size=4, pair_filter=first_half, transport_dtype="uint8"),
               dict(batch_size=64, drop_last=False, num_workers=0, prefetch=1)):
        got = tp.dataset_from_source(0, *cv2_dirs, img_size=32, seed=3, **kw)
        want = jp.dataset_from_source(0, *cv2_dirs, img_size=32, seed=3, **kw)
        assert isinstance(got, tp.CrackDataset)
        assert (got.pairs, got.batch_size, got.num_workers, got.prefetch, got.transport_dtype) == (
            want.pairs, want.batch_size, want.num_workers, want.prefetch, want.transport_dtype)
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.tobytes() == wi.tobytes() and gm.tobytes() == wm.tobytes()
    with pytest.raises(ValueError, match="no image/mask pairs"):
        tp.dataset_from_source(0, *cv2_dirs, img_size=32, batch_size=4, pair_filter=lambda p: [])
    with pytest.raises(ValueError):
        tp.dataset_from_source(0, cv2_dirs[0], None, img_size=32, batch_size=4)
