"""The port's crack quantification (``tools/quantify.py``) held against the
JAX package's on the CPU, on the same masks, images and weights.

- ``quantify_mask``: equal ``CrackStats`` (every contour's area, perimeter
  and both ``approxPolyDP`` vertex counts) on an empty mask, a square,
  two cracks, {0,1} float and [H, W, 1] masks, and seeded random blobs.
- ``annotate``: the same bytes, for uint8 and float images.
- ``quantify_mask_dir`` and the ``--pred-dir`` command line: the same
  records, totals, stdout lines and ``--out-json`` bytes.
- ``predict_and_quantify`` on weights converted from the JAX package's
  init, at the tiny width: masks equal apart from pixels whose
  probability lies within the two packages' largest probability distance
  of the 0.5 threshold, and, where the masks are equal, equal overlays
  and stats.
- The port's ``main --weights`` on the CPU writes masks whose stats equal
  ``quantify_mask`` over the written files.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port


def _blobs(seed: int, size: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = np.zeros((size, size), np.uint8)
    for _ in range(5):
        y, x = rng.integers(0, size - 12, 2)
        h, w = rng.integers(2, 12, 2)
        mask[y:y + h, x:x + w] = 255
    mask[rng.random((size, size)) < 0.02] = 255
    return mask


def _square() -> np.ndarray:
    mask = np.zeros((64, 64), np.uint8)
    mask[20:40, 20:40] = 255
    return mask


def _two_cracks() -> np.ndarray:
    mask = np.zeros((64, 64), np.uint8)
    mask[5:15, 5:15] = 255
    mask[40:60, 40:50] = 255
    return mask


def _float01() -> np.ndarray:
    mask = np.zeros((32, 32), np.float32)
    mask[8:16, 8:24] = 1.0
    mask[20:22, 2:30] = 0.7
    return mask


MASKS = {
    "empty": lambda: np.zeros((32, 32), np.uint8),
    "square": _square,
    "two_cracks": _two_cracks,
    "float01": _float01,
    "hw1": lambda: _two_cracks()[..., None],
    "blobs0": lambda: _blobs(0),
    "blobs1": lambda: _blobs(1, 96),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_quantify_mask_matches_jax(name):
    from fedcrack_tpu.tools.quantify import quantify_mask as jax_quantify
    from fedcrack_tpu_torch.tools.quantify import quantify_mask

    mask = MASKS[name]()
    got, want = quantify_mask(mask), jax_quantify(mask)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "square":
        assert got.contour_count == 1 and got.contours[0].approx_points_10pct == 4
    if name == "empty":
        assert got.contour_count == 0 and got.crack_fraction == 0.0


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_annotate_matches_jax(dtype):
    from fedcrack_tpu.tools.quantify import annotate as jax_annotate
    from fedcrack_tpu_torch.tools.quantify import annotate

    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    if dtype == "float32":
        image = image.astype(np.float32) / 255.0
    mask = _blobs(2)
    got, want = annotate(image, mask), jax_annotate(image, mask)
    assert got.dtype == np.uint8 and got.tobytes() == np.asarray(want).tobytes()


def _write_masks(out_dir, masks: dict) -> None:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for name, mask in masks.items():
        assert cv2.imwrite(os.path.join(out_dir, name), mask)


def test_quantify_mask_dir_and_pred_dir_cli_match_jax(tmp_path, capsys):
    from fedcrack_tpu.tools import quantify as jq
    from fedcrack_tpu_torch.tools import quantify as tq

    pred = tmp_path / "pred"
    _write_masks(str(pred), {"mask_00002.png": _square(), "mask_00000.png": np.zeros((64, 64), np.uint8),
                             "mask_00001.png": _blobs(4), "b.bmp": _two_cracks()})
    (pred / "notes.txt").write_text("not a mask")
    assert tq.quantify_mask_dir(str(pred)) == jq.quantify_mask_dir(str(pred))
    assert tq.quantify_mask_dir(str(pred), threshold=200) == jq.quantify_mask_dir(str(pred), threshold=200)
    outs = {}
    for label, mod in (("port", tq), ("jax", jq)):
        out_json = tmp_path / f"{label}.json"
        mod.main(["--pred-dir", str(pred), "--out-json", str(out_json)])
        outs[label] = (capsys.readouterr().out, out_json.read_bytes())
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].strip().splitlines()
    assert len(lines) == 5 and json.loads(lines[-1])["totals"]["images"] == 4
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no mask images"):
        tq.quantify_mask_dir(str(empty))
    with pytest.raises(ValueError, match="not a directory"):
        tq.quantify_mask_dir(str(tmp_path / "missing"))
    with pytest.raises(SystemExit):
        tq.main(["--synthetic", "2"])
    assert "--weights is required" in capsys.readouterr().err


def test_predict_and_quantify_matches_jax(tmp_path):
    import cv2
    import jax
    import torch

    from fedcrack_tpu.tools.quantify import predict_and_quantify as jax_predict
    from fedcrack_tpu.train import create_train_state
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.tools.quantify import predict_and_quantify

    variables = jax_variables(TINY_KW, seed=3)
    # Batch statistics away from (0, 1), so eval mode is not train mode.
    rng = np.random.default_rng(0)

    def perturb(node):
        if "mean" in node and "var" in node:
            node["mean"] = rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
        for child in node.values():
            if isinstance(child, dict):
                perturb(child)

    perturb(variables["batch_stats"])
    state = create_train_state(jax.random.key(0), jax_config(TINY_KW)).replace_variables(variables)
    model = from_flax_variables(variables, ResUNet(port_config(TINY_KW), device="cpu"))
    model.train()
    images, masks = synth_crack_batch(6, 32, seed=11)
    u8 = (images * 255).round().astype(np.uint8)
    dataset = [(u8[:4], masks[:4]), (u8[4:], masks[4:])]
    got = predict_and_quantify(model, dataset, out_dir=str(tmp_path / "port"), max_images=5)
    want = jax_predict(state, dataset, out_dir=str(tmp_path / "jax"), max_images=5)
    assert model.training  # the caller's mode comes back

    x = u8.astype(np.float32) * np.float32(1 / 255)
    p_jax = np.asarray(jax.nn.sigmoid(state.apply_fn(state.variables, x, train=False)))[..., 0]
    with torch.inference_mode():
        model.eval()
        p_port = torch.sigmoid(model(torch.from_numpy(x))).numpy()[..., 0]
        model.train()
    dist = float(np.abs(p_jax - p_port).max())
    assert dist < 1e-4
    assert len(got) == len(want) == 5 and [r["image"] for r in got] == list(range(5))
    for i in range(5):
        ours = cv2.imread(str(tmp_path / "port" / f"pred_{i:03d}.png"), cv2.IMREAD_GRAYSCALE)
        theirs = cv2.imread(str(tmp_path / "jax" / f"pred_{i:03d}.png"), cv2.IMREAD_GRAYSCALE)
        assert ours.shape == (32, 32)
        differ = ours != theirs
        assert np.all(np.abs(p_port[i][differ] - 0.5) <= dist), "a mask pixel away from the threshold differs"
        if not differ.any():
            assert got[i] == want[i]
            for name in (f"overlay_{i:03d}.png", f"pred_{i:03d}.png"):
                assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_quantify_main_with_weights_on_cpu(tmp_path, capsys):
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.tools import quantify as tq

    weights = tmp_path / "w.msgpack"
    weights.write_bytes(tree_to_bytes(init_variables(torch.Generator().manual_seed(4), ModelConfig(img_size=32))))
    out_dir, out_json = tmp_path / "out", tmp_path / "stats.json"
    tq.main(["--weights", str(weights), "--synthetic", "3", "--img-size", "32", "--batch", "2",
             "--out-dir", str(out_dir), "--max-images", "3", "--out-json", str(out_json)], device="cpu")
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert json.loads(out_json.read_text())["images"] == printed
    assert sorted(os.listdir(out_dir)) == [f"{k}_{i:03d}.png" for k in ("overlay", "pred") for i in range(3)]
    redone = tq.quantify_mask_dir(str(out_dir))["images"]
    preds = [r for r in redone if r["image"].startswith("pred_")]
    for rec, again in zip(printed, preds):
        assert {k: v for k, v in rec.items() if k != "image"} == {k: v for k, v in again.items() if k != "image"}
