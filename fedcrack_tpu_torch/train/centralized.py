"""Centralized (non-federated) baseline trainer:
``python -m fedcrack_tpu_torch.train.centralized``.

The counterpart of ``fedcrack_tpu.train.centralized``, the reference's
standalone training script as a command line: the same ResUNet on the
whole dataset for N epochs with a held-out validation split, keeping the
weights of the lowest validation loss (``best.msgpack``) and the last
(``final.msgpack``), both flax msgpack trees that either package loads.
Training runs on the card unless ``main`` is given another ``device``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable

import torch

from fedcrack_tpu_torch.configs import SLOT_PLANE_ONLY, ModelConfig, SegFormerConfig
from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
from fedcrack_tpu_torch.ioutils import atomic_write_bytes
from fedcrack_tpu_torch.train.local import (
    TrainState,
    create_train_state,
    evaluate,
    local_fit,
    recalibrate_batch_stats,
)


def train_centralized(
    train_batches: Iterable,
    val_batches: Iterable,
    model_config: ModelConfig | None = None,
    epochs: int = 60,
    learning_rate: float = 1e-3,
    out_dir: str | None = None,
    seed: int = 0,
    log_fn=print,
    recalibrate_bn: bool = True,
    pos_weight: float = 1.0,
    metrics=None,
    device: torch.device | str | None = None,
) -> tuple[TrainState, list[dict]]:
    """Returns the final state and the per-epoch history; writes
    ``best.msgpack`` (lowest validation loss) and ``final.msgpack`` to
    ``out_dir``.

    With ``recalibrate_bn`` the BatchNorm running statistics are estimated
    again from the train set before each validation pass and checkpoint
    (at momentum 0.99 they need about 500 steps to converge); training
    carries on from its own running statistics, as in the JAX package,
    and the checkpoints and the returned state hold the calibrated ones.
    """
    if isinstance(model_config, SegFormerConfig):
        raise ValueError(SLOT_PLANE_ONLY.format(what="centralized training"))
    state = create_train_state(torch.Generator().manual_seed(seed), model_config, learning_rate, device)
    history: list[dict] = []
    best_loss = float("inf")
    eval_variables = None
    for epoch in range(epochs):
        state, train_metrics = local_fit(state, train_batches, epochs=1, pos_weight=pos_weight)
        carried = None
        if recalibrate_bn:
            carried = {k: v.clone() for k, v in state.model.named_buffers()}
            recalibrate_batch_stats(state, train_batches)
        # The weighted loss selects the best checkpoint, as it trains.
        val_metrics = evaluate(state, val_batches, pos_weight=pos_weight)
        eval_variables = state.variables
        if carried is not None:
            with torch.no_grad():
                for k, buf in state.model.named_buffers():
                    buf.copy_(carried[k])
        entry = {
            "epoch": epoch,
            **{f"train_{k}": v for k, v in train_metrics.items()},
            **{f"val_{k}": v for k, v in val_metrics.items()},
        }
        history.append(entry)
        if metrics is not None:
            metrics.log("epoch", **entry)
        log_fn(
            f"epoch {epoch}: train_loss={train_metrics['loss']:.4f} "
            f"val_loss={val_metrics['loss']:.4f} val_iou={val_metrics['iou']:.4f}"
        )
        if out_dir and val_metrics["loss"] < best_loss:
            best_loss = val_metrics["loss"]
            atomic_write_bytes(os.path.join(out_dir, "best.msgpack"), tree_to_bytes(eval_variables))
    if eval_variables is not None:
        state.replace_variables(eval_variables)
    if out_dir:
        atomic_write_bytes(os.path.join(out_dir, "final.msgpack"), tree_to_bytes(state.variables))
    return state, history


def _build_datasets(args, model_config: ModelConfig):
    """Train and validation datasets from paired directories (the
    reference's seeded split, validation the held-out tail) or synthetic
    fixtures (the first fifth held out)."""
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset, dataset_from_source, reference_split
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    if args.synthetic:
        if args.synthetic < 2:
            raise SystemExit("--synthetic needs at least 2 samples (train + val)")
        n_val = max(1, args.synthetic // 5)
        images, masks = synth_crack_batch(args.synthetic, model_config.img_size, seed=args.seed)
        train = ArrayDataset(
            images[n_val:], masks[n_val:], batch_size=min(args.batch, args.synthetic - n_val), seed=args.seed
        )
        val = ArrayDataset(images[:n_val], masks[:n_val], batch_size=min(args.batch, n_val), seed=args.seed)
        return train, val

    def split_side(i):
        def pick(pairs):
            return reference_split(pairs, args.train_samples, args.split_seed)[i]

        return pick

    try:
        train, val = (
            dataset_from_source(
                0, args.image_dir, args.mask_dir, img_size=model_config.img_size, batch_size=args.batch,
                seed=args.seed, pair_filter=split_side(i), transport_dtype=args.transport_dtype,
            )
            for i in (0, 1)
        )
    except ValueError as e:
        raise SystemExit(str(e))
    return train, val


def main(argv: list[str] | None = None, *, device: torch.device | str | None = None) -> int:
    """Parse ``argv`` and train; on ``device`` (the card unless given)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image-dir")
    p.add_argument("--mask-dir")
    p.add_argument("--synthetic", type=int, default=0, help="use N generated samples")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--pos-weight",
        type=float,
        default=1.0,
        help="crack-pixel BCE weight (>1 counters foreground imbalance; 1 = plain BCE)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--transport-dtype",
        choices=("uint8", "float32"),
        default="uint8",
        help="host->device staging dtype for file datasets; uint8 ships 1/4 "
        "the bytes and is bit-identical (normalization happens on the device)",
    )
    p.add_argument("--train-samples", type=int, default=6213)
    p.add_argument("--split-seed", type=int, default=1337)
    p.add_argument("--out-dir", default="centralized_out")
    p.add_argument("--metrics", dest="metrics_path", help="JSONL file for per-epoch metrics")
    p.add_argument("--tb-dir", dest="tb_dir", help="TensorBoard event-file directory for per-epoch scalars")
    args = p.parse_args(argv)

    metrics = None
    if args.metrics_path or args.tb_dir:
        from fedcrack_tpu_torch.obs import MetricsLogger

        metrics = MetricsLogger(args.metrics_path or os.devnull, tb_dir=args.tb_dir or None)
    model_config = ModelConfig(img_size=args.img_size)
    train, val = _build_datasets(args, model_config)
    try:
        _, history = train_centralized(
            train,
            val,
            model_config=model_config,
            epochs=args.epochs,
            learning_rate=args.lr,
            out_dir=args.out_dir,
            seed=args.seed,
            pos_weight=args.pos_weight,
            metrics=metrics,
            device=device,
        )
    finally:
        if metrics is not None:
            metrics.close()
    best = min(h["val_loss"] for h in history)
    print(f"done: {len(history)} epochs, best val_loss={best:.4f} -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
