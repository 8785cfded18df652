"""The port's ResUNet weights -> a Keras h5 (the inverse of
``tools/h5_import.py``).

The counterpart of ``fedcrack_tpu.tools.h5_export``: a federation-trained
global (the server's ``--best-path`` msgpack, a flax-layout tree) written
as the legacy full-model h5 weight schema (a ``model_weights`` group with
``layer_names`` / ``weight_names`` attributes) that
``keras.Model.load_weights`` reads. Only weighted layers are listed, in
the reference model's creation order; Keras's legacy loader matches by
order, not by name.

The conversions are the exact inverses of the importer's: ``Conv2D``
unchanged; depthwise ``(kh, kw, 1, in)`` -> ``(kh, kw, in, 1)``; a
transposed conv's flax ``(kh, kw, in, out)`` flipped on both spatial axes
and its channels swapped to Keras's ``(kh, kw, out, in)``, under a layer
name carrying ``transpose`` so the importer classifies it back;
BatchNorm's ``scale`` / ``bias`` and statistics to gamma / beta and the
moving mean / variance.

    python -m fedcrack_tpu_torch.tools.h5_export global.msgpack out.h5 [--config c.json]
"""

from __future__ import annotations

import numpy as np

from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.tools.h5_import import _h5py, model_config_from_args


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _layer_entries(variables: dict, config: ModelConfig) -> list[tuple[str, dict]]:
    """``(layer_name, {weight_base: array})`` in the Keras model's creation
    order: stem conv and bn; per encoder block sep1, bn1, sep2, bn2, res;
    per decoder block convT1, bn1, convT2, bn2, res; the head."""
    p = variables["params"]
    s = variables["batch_stats"]

    def conv(name):
        return name, {"kernel": _f32(p[name]["kernel"]), "bias": _f32(p[name]["bias"])}

    def bn(name):
        return name, {
            "gamma": _f32(p[name]["scale"]),
            "beta": _f32(p[name]["bias"]),
            "moving_mean": _f32(s[name]["mean"]),
            "moving_variance": _f32(s[name]["var"]),
        }

    def sep(name):
        dw = _f32(p[name]["depthwise"]["kernel"])  # (kh, kw, 1, in)
        return name, {
            "depthwise_kernel": np.transpose(dw, (0, 1, 3, 2)),  # -> (kh, kw, in, 1)
            "pointwise_kernel": _f32(p[name]["pointwise"]["kernel"]),
            "bias": _f32(p[name]["pointwise"]["bias"]),
        }

    def convT(flax_name, file_name):
        k = _f32(p[flax_name]["kernel"])  # (kh, kw, in, out), unflipped
        return file_name, {
            "kernel": np.transpose(k[::-1, ::-1], (0, 1, 3, 2)),  # -> (kh, kw, out, in)
            "bias": _f32(p[flax_name]["bias"]),
        }

    entries = [conv("stem_conv"), bn("stem_bn")]
    for i in range(len(config.encoder_features)):
        entries += [sep(f"enc{i}_sep1"), bn(f"enc{i}_bn1"), sep(f"enc{i}_sep2"), bn(f"enc{i}_bn2"),
                    conv(f"enc{i}_res")]
    for i in range(len(config.decoder_features)):
        entries += [convT(f"dec{i}_convT1", f"dec{i}_conv_transpose1"), bn(f"dec{i}_bn1"),
                    convT(f"dec{i}_convT2", f"dec{i}_conv_transpose2"), bn(f"dec{i}_bn2"),
                    conv(f"dec{i}_res")]
    entries.append(conv("head"))
    return entries


def _check_structure(variables: dict, config: ModelConfig) -> None:
    """Every module of ``variables`` must be written: a config with fewer
    blocks than the weights would give a well-formed h5 with blocks
    missing, and the importer's rule is that a mismatch raises."""
    expected_params = {"stem_conv", "stem_bn", "head"}
    expected_stats = {"stem_bn"}
    for i in range(len(config.encoder_features)):
        expected_params |= {f"enc{i}_sep1", f"enc{i}_bn1", f"enc{i}_sep2", f"enc{i}_bn2", f"enc{i}_res"}
        expected_stats |= {f"enc{i}_bn1", f"enc{i}_bn2"}
    for i in range(len(config.decoder_features)):
        expected_params |= {f"dec{i}_convT1", f"dec{i}_bn1", f"dec{i}_convT2", f"dec{i}_bn2", f"dec{i}_res"}
        expected_stats |= {f"dec{i}_bn1", f"dec{i}_bn2"}
    for tree, expected, label in ((variables["params"], expected_params, "params"),
                                  (variables["batch_stats"], expected_stats, "batch_stats")):
        got = set(tree.keys())
        if got != expected:
            raise ValueError(
                f"{label} structure does not match the export config: "
                f"unconsumed {sorted(got - expected)}, "
                f"missing {sorted(expected - got)}"
            )


def export_resunet_h5(variables: dict, path: str, config: ModelConfig | None = None) -> None:
    """Write a ``{'params', 'batch_stats'}`` tree as a Keras-loadable
    legacy h5."""
    h5py = _h5py()
    config = config or ModelConfig()
    _check_structure(variables, config)
    entries = _layer_entries(variables, config)
    str_dt = h5py.special_dtype(vlen=str)
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for g in (f, root):
            g.attrs["backend"] = "tensorflow"
            g.attrs["keras_version"] = "3"
        root.attrs.create("layer_names", [name for name, _ in entries], dtype=str_dt)
        for name, weights in entries:
            group = root.create_group(name)
            group.attrs.create("weight_names", [f"{name}/{base}" for base in weights], dtype=str_dt)
            for base, arr in weights.items():
                group.create_dataset(f"{name}/{base}", data=arr)


def main(argv: list[str] | None = None) -> int:
    """``python -m fedcrack_tpu_torch.tools.h5_export model.msgpack out.h5``."""
    import argparse

    import torch

    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.models.resunet import init_variables

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("msgpack_path", help="msgpack tree (fed/serialization format, e.g. the server's "
                   "--best-path or centralized best.msgpack)")
    p.add_argument("out_path", help="Keras h5 output")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--config", help="JSON FedConfig file; its model section wins")
    args = p.parse_args(argv)
    config = model_config_from_args(args.img_size, args.config)
    template = init_variables(torch.Generator().manual_seed(0), config)
    with open(args.msgpack_path, "rb") as f:
        variables = tree_from_bytes(f.read(), template=template)
    export_resunet_h5(variables, args.out_path, config)
    print(f"exported {args.msgpack_path} -> {args.out_path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
