"""Crack quantification from predicted masks (host-side post-processing).

The counterpart of ``fedcrack_tpu.tools.quantify``: threshold a predicted
mask at 127/255, extract contours (``RETR_TREE``, ``CHAIN_APPROX_SIMPLE``),
measure each crack's area and perimeter, simplify each contour with
``approxPolyDP`` at epsilon = 1% and 10% of its perimeter, and write
annotated overlays. Contour tracing is irregular, data-dependent work on a
handful of masks, so it stays on the host in OpenCV, imported lazily.

:func:`predict_and_quantify` runs the port's ``ResUNet`` in eval mode on
its own device (the card in the command line and the client) and writes
``pred_*.png`` and ``overlay_*.png``; :func:`quantify_mask_dir` quantifies
a directory of masks without a model, such as the served masks
``tools/load_gen.py --out-dir`` writes.

    python -m fedcrack_tpu_torch.tools.quantify --weights best.msgpack --synthetic 8
    python -m fedcrack_tpu_torch.tools.quantify --pred-dir masks/ --out-json stats.json
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ContourInfo:
    area_px: float
    perimeter_px: float
    approx_points_1pct: int   # vertices of the eps=1% polygon
    approx_points_10pct: int  # vertices of the eps=10% polygon


@dataclass
class CrackStats:
    contour_count: int = 0
    total_area_px: float = 0.0
    total_perimeter_px: float = 0.0
    crack_fraction: float = 0.0  # crack pixels / image pixels
    contours: list[ContourInfo] = field(default_factory=list)


def _binary(mask: np.ndarray, threshold: int) -> np.ndarray:
    """``mask`` ([H, W] or [H, W, 1], {0,1} floats or 0..255 uint8)
    thresholded to 0/255 uint8 (> ``threshold`` on the 0..255 scale)."""
    import cv2

    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.dtype != np.uint8:
        mask = (np.clip(mask, 0.0, 1.0) * 255).astype(np.uint8)
    _, binary = cv2.threshold(mask, threshold, 255, cv2.THRESH_BINARY)
    return binary


def quantify_mask(mask: np.ndarray, threshold: int = 127) -> CrackStats:
    """Measure the cracks in one mask: per contour its area, perimeter and
    the vertex counts of its two simplified polygons, and the crack
    fraction of the thresholded mask."""
    import cv2

    binary = _binary(mask, threshold)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    stats = CrackStats(crack_fraction=float((binary > 0).mean()))
    for contour in contours:
        area = float(cv2.contourArea(contour))
        perim = float(cv2.arcLength(contour, True))
        approx1 = cv2.approxPolyDP(contour, 0.01 * perim, True)
        approx10 = cv2.approxPolyDP(contour, 0.10 * perim, True)
        stats.contours.append(
            ContourInfo(
                area_px=area,
                perimeter_px=perim,
                approx_points_1pct=len(approx1),
                approx_points_10pct=len(approx10),
            )
        )
        stats.total_area_px += area
        stats.total_perimeter_px += perim
    stats.contour_count = len(stats.contours)
    return stats


def annotate(image: np.ndarray, mask: np.ndarray, threshold: int = 127) -> np.ndarray:
    """The (RGB float or uint8) image as uint8 with the mask's crack
    contours drawn on it in red."""
    import cv2

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    img = img.copy()
    contours, _ = cv2.findContours(_binary(mask, threshold), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    cv2.drawContours(img, contours, -1, (255, 0, 0), 1)
    return img


def _stats_record(name, s: CrackStats) -> dict:
    return {
        "image": name,
        "contours": s.contour_count,
        "area_px": s.total_area_px,
        "perimeter_px": s.total_perimeter_px,
        "crack_fraction": s.crack_fraction,
    }


def predict_and_quantify(
    state,
    dataset,
    out_dir: str,
    threshold: float = 0.5,
    max_images: int = 8,
) -> list[dict]:
    """Predict masks for the first ``max_images`` images of ``dataset``
    with ``state``'s model (a ``TrainState`` or a ``ResUNet``) in eval mode
    on its device, write ``pred_NNN.png`` and ``overlay_NNN.png`` under
    ``out_dir``, and return one crack-stats record per image."""
    import cv2
    import torch

    from fedcrack_tpu_torch.data.pipeline import normalize_images

    model = getattr(state, "model", state)
    device = next(model.parameters()).device
    was_training = model.training
    os.makedirs(out_dir, exist_ok=True)
    reports: list[dict] = []
    done = 0
    model.eval()
    try:
        for images, _ in dataset:
            # uint8 transport bytes or float32 in [0, 1]: normalized as
            # training saw them.
            images = normalize_images(torch.as_tensor(np.asarray(images))).numpy()
            with torch.inference_mode():
                probs = torch.sigmoid(model(torch.from_numpy(images).to(device))).cpu().numpy()
            for i in range(len(images)):
                if done >= max_images:
                    return reports
                pred = (probs[i, :, :, 0] > threshold).astype(np.uint8) * 255
                cv2.imwrite(os.path.join(out_dir, f"pred_{done:03d}.png"), pred)
                overlay = annotate(images[i], pred)
                cv2.imwrite(
                    os.path.join(out_dir, f"overlay_{done:03d}.png"),
                    cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR),
                )
                reports.append(_stats_record(done, quantify_mask(pred)))
                done += 1
    finally:
        model.train(was_training)
    return reports


MASK_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def quantify_mask_dir(pred_dir: str, threshold: int = 127) -> dict:
    """Quantify every mask image in ``pred_dir`` (sorted by name) without
    a model. Returns ``{"images": [per-image stats], "totals": {...}}``."""
    import cv2

    if not os.path.isdir(pred_dir):
        raise ValueError(f"--pred-dir {pred_dir} is not a directory")
    names = sorted(n for n in os.listdir(pred_dir) if n.lower().endswith(MASK_EXTENSIONS))
    if not names:
        raise ValueError(f"no mask images ({'/'.join(MASK_EXTENSIONS)}) in {pred_dir}")
    images = []
    totals = {"contours": 0, "area_px": 0.0, "perimeter_px": 0.0}
    for name in names:
        mask = cv2.imread(os.path.join(pred_dir, name), cv2.IMREAD_GRAYSCALE)
        if mask is None:
            raise ValueError(f"unreadable mask image: {name}")
        s = quantify_mask(mask, threshold=threshold)
        images.append(_stats_record(name, s))
        totals["contours"] += s.contour_count
        totals["area_px"] += s.total_area_px
        totals["perimeter_px"] += s.total_perimeter_px
    totals["images"] = len(images)
    totals["mean_crack_fraction"] = float(np.mean([r["crack_fraction"] for r in images]))
    return {"images": images, "totals": totals}


def main(argv=None, *, device=None) -> None:
    """``python -m fedcrack_tpu_torch.tools.quantify``: load trained
    weights, predict masks on ``device`` (the card unless given), write
    overlays and print per-image stats; ``--pred-dir`` quantifies a
    directory of masks with no model. ``--out-json`` writes the stats in
    either mode."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.tools.quantify", description=__doc__)
    p.add_argument("--weights", help="msgpack pytree (best.msgpack)")
    p.add_argument("--image-dir")
    p.add_argument("--mask-dir")
    p.add_argument("--synthetic", type=int, default=0, help="use N generated samples")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out-dir", default="contour")
    p.add_argument("--max-images", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pred-dir",
                   help="batch mode: quantify every predicted-mask image in this directory "
                   "(no model/weights needed)")
    p.add_argument("--mask-threshold", type=int, default=127,
                   help="binarization threshold on the 0..255 scale")
    p.add_argument("--out-json", help="write machine-readable stats JSON here")
    args = p.parse_args(argv)

    if args.pred_dir:
        try:
            report = quantify_mask_dir(args.pred_dir, threshold=args.mask_threshold)
        except ValueError as e:
            p.error(str(e))
        for r in report["images"]:
            print(json.dumps(r))
        print(json.dumps({"totals": report["totals"]}))
        if args.out_json:
            with open(args.out_json, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        return

    if not args.weights:
        p.error("--weights is required unless --pred-dir is given")

    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import dataset_from_source
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    model = ResUNet(ModelConfig(img_size=args.img_size), generator=torch.Generator().manual_seed(args.seed),
                    device=device)
    with open(args.weights, "rb") as f:
        from_flax_variables(tree_from_bytes(f.read(), template=to_flax_variables(model)), model)
    # Inference sees every image: drop_last=False keeps the tail batch.
    try:
        dataset = dataset_from_source(
            args.synthetic, args.image_dir, args.mask_dir, img_size=args.img_size,
            batch_size=args.batch, seed=args.seed, drop_last=False,
        )
    except ValueError as e:
        p.error(str(e))
    reports = predict_and_quantify(model, dataset, out_dir=args.out_dir, max_images=args.max_images)
    for r in reports:
        print(json.dumps(r))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"images": reports}, f, indent=2, sort_keys=True)


if __name__ == "__main__":
    main()
