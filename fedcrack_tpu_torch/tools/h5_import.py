"""Keras h5 -> the port's ResUNet weights (the flax-layout numpy tree).

The counterpart of ``fedcrack_tpu.tools.h5_import``. The reference's
centralized trainer checkpoints its best U-Net to ``crack_segmentation.h5``
(reference: test/Segmentation.py:177-179); this importer seeds the port's
global model from such a file, tensor for tensor. It reads weights-only
files (``model.save_weights``) and full-model files (``model.save``,
``ModelCheckpoint``: weights under ``model_weights``).

Kernel conversions into the flax layout (the tree ``models.convert``
carries onto the port's ``ResUNet``):

- ``Conv2D``: kernel ``(kh, kw, in, out)``, unchanged;
- ``SeparableConv2D``: depthwise ``(kh, kw, in, 1)`` -> ``(kh, kw, 1, in)``
  (last two axes swapped), pointwise unchanged, the bias on the pointwise
  stage;
- ``Conv2DTranspose``: Keras's gradient-of-conv ``(kh, kw, out, in)`` ->
  ``(kh, kw, in, out)``, both spatial axes flipped;
- ``BatchNormalization``: gamma / beta -> params ``scale`` / ``bias``,
  moving mean / variance -> ``batch_stats`` ``mean`` / ``var``.

Layers are matched by type (read from the weight names), in model order
within each type, and every tensor is shape-checked against the target: a
mismatch raises rather than mis-seeding. The layouts never reach the
importer (parameter shapes do not depend on them), so one file seeds every
layout.

``h5py`` is imported inside the functions that read files; the card's
machine does not promise it.

    python -m fedcrack_tpu_torch.tools.h5_import crack_segmentation.h5 global.msgpack [--config c.json]
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from fedcrack_tpu_torch.configs import ModelConfig


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for Keras h5 import and export") from e
    return h5py


@dataclasses.dataclass(frozen=True)
class _Layer:
    name: str
    kind: str  # conv | separable | convT | bn
    weights: dict[str, np.ndarray]  # canonical name -> array


_CANONICAL = (
    "depthwise_kernel",
    "pointwise_kernel",
    "moving_mean",
    "moving_variance",
    "kernel",
    "bias",
    "gamma",
    "beta",
)


def _canon(weight_name: str) -> str:
    base = weight_name.split("/")[-1].split(":")[0]
    for cand in _CANONICAL:  # the *_kernel names before kernel
        if base == cand or base.endswith(cand):
            return cand
    raise ValueError(f"unrecognized weight name {weight_name!r}")


def _classify(layer_name: str, weights: dict[str, np.ndarray]) -> str:
    if "gamma" in weights:
        return "bn"
    if "depthwise_kernel" in weights:
        return "separable"
    if "transpose" in layer_name:
        return "convT"
    return "conv"


def _as_str(name: Any) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def read_keras_h5(path: str) -> list[_Layer]:
    """The weighted layers of a Keras h5 file, in model order."""
    h5py = _h5py()
    layers: list[_Layer] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in (_as_str(n) for n in root.attrs["layer_names"]):
            group = root[lname]
            weight_names = [_as_str(n) for n in group.attrs["weight_names"]]
            if not weight_names:
                continue  # activation, pooling and add layers carry no weights
            weights = {_canon(wn): np.asarray(group[wn]) for wn in weight_names}
            layers.append(_Layer(lname, _classify(lname, weights), weights))
    return layers


def _conv_targets(config: ModelConfig) -> list[str]:
    """The plain Conv2D layers' module names, in Keras model order."""
    return (["stem_conv"] + [f"enc{i}_res" for i in range(len(config.encoder_features))]
            + [f"dec{i}_res" for i in range(len(config.decoder_features))] + ["head"])


def _bn_targets(config: ModelConfig) -> list[str]:
    names = ["stem_bn"]
    for i in range(len(config.encoder_features)):
        names += [f"enc{i}_bn1", f"enc{i}_bn2"]
    for i in range(len(config.decoder_features)):
        names += [f"dec{i}_bn1", f"dec{i}_bn2"]
    return names


def _sep_targets(config: ModelConfig) -> list[str]:
    return [f"enc{i}_sep{j}" for i in range(len(config.encoder_features)) for j in (1, 2)]


def _convT_targets(config: ModelConfig) -> list[str]:
    return [f"dec{i}_convT{j}" for i in range(len(config.decoder_features)) for j in (1, 2)]


def _check(src: np.ndarray, dst_shape: tuple, layer: str, tensor: str) -> np.ndarray:
    if tuple(src.shape) != tuple(dst_shape):
        raise ValueError(
            f"shape mismatch importing {layer}/{tensor}: "
            f"h5 {tuple(src.shape)} vs model {tuple(dst_shape)}"
        )
    return src


def _copy_tree(tree: Any) -> Any:
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def _to_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def import_resunet_h5(path: str, config: ModelConfig | None = None, template: dict | None = None) -> dict:
    """A Keras ResUNet h5 checkpoint as the flax-layout ``{'params',
    'batch_stats'}`` numpy tree. ``template`` (an initial variables tree)
    gives the target structure and shapes; it is the port's
    ``init_variables`` of ``config`` when omitted. Extra or missing layers
    and any shape mismatch raise."""
    from fedcrack_tpu_torch.models.resunet import init_variables

    config = config or ModelConfig()
    if template is None:
        import torch

        template = init_variables(torch.Generator().manual_seed(0), config)
    params = _copy_tree(template["params"])
    stats = _copy_tree(template["batch_stats"])

    by_kind: dict[str, list[_Layer]] = {}
    for layer in read_keras_h5(path):
        by_kind.setdefault(layer.kind, []).append(layer)
    targets = {
        "conv": _conv_targets(config),
        "separable": _sep_targets(config),
        "convT": _convT_targets(config),
        "bn": _bn_targets(config),
    }
    for kind, expected in targets.items():
        got = by_kind.get(kind, [])
        if len(got) != len(expected):
            raise ValueError(
                f"layer count mismatch for {kind}: h5 has {len(got)} "
                f"({[l.name for l in got]}), model needs {len(expected)} ({expected})"
            )

    for layer, target in zip(by_kind.get("conv", []), targets["conv"]):
        w, p = layer.weights, params[target]
        p["kernel"] = _check(w["kernel"], p["kernel"].shape, target, "kernel")
        p["bias"] = _check(w["bias"], p["bias"].shape, target, "bias")

    for layer, target in zip(by_kind.get("separable", []), targets["separable"]):
        w, p = layer.weights, params[target]
        dw = np.transpose(w["depthwise_kernel"], (0, 1, 3, 2))  # (kh,kw,in,1) -> (kh,kw,1,in)
        p["depthwise"]["kernel"] = _check(dw, p["depthwise"]["kernel"].shape, target, "depthwise")
        p["pointwise"]["kernel"] = _check(w["pointwise_kernel"], p["pointwise"]["kernel"].shape, target,
                                          "pointwise")
        p["pointwise"]["bias"] = _check(w["bias"], p["pointwise"]["bias"].shape, target, "bias")

    for layer, target in zip(by_kind.get("convT", []), targets["convT"]):
        w, p = layer.weights, params[target]
        # Gradient-of-conv orientation -> flax: flip spatial, swap channels.
        kt = np.transpose(w["kernel"][::-1, ::-1], (0, 1, 3, 2))
        p["kernel"] = _check(kt, p["kernel"].shape, target, "kernel")
        p["bias"] = _check(w["bias"], p["bias"].shape, target, "bias")

    for layer, target in zip(by_kind.get("bn", []), targets["bn"]):
        w, p, s = layer.weights, params[target], stats[target]
        p["scale"] = _check(w["gamma"], p["scale"].shape, target, "scale")
        p["bias"] = _check(w["beta"], p["bias"].shape, target, "bias")
        s["mean"] = _check(w["moving_mean"], s["mean"].shape, target, "mean")
        s["var"] = _check(w["moving_variance"], s["var"].shape, target, "var")

    return {"params": _to_f32(params), "batch_stats": _to_f32(stats)}


def model_config_from_args(img_size: int, config_path: str | None) -> ModelConfig:
    """``--config``'s model section when given, else ``ModelConfig(img_size=)``."""
    if config_path:
        from fedcrack_tpu_torch.configs import FedConfig

        with open(config_path, encoding="utf-8") as f:
            return FedConfig.from_json(f.read()).model
    return ModelConfig(img_size=img_size)


def main(argv: list[str] | None = None) -> int:
    """``python -m fedcrack_tpu_torch.tools.h5_import ckpt.h5 out.msgpack``."""
    import argparse

    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.ioutils import atomic_write_bytes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("h5_path")
    p.add_argument("out_path", help="msgpack tree output (fed/serialization format)")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--config", help="JSON FedConfig file; its model section wins")
    args = p.parse_args(argv)
    variables = import_resunet_h5(args.h5_path, model_config_from_args(args.img_size, args.config))
    atomic_write_bytes(args.out_path, tree_to_bytes(variables))
    print(f"imported {args.h5_path} -> {args.out_path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
