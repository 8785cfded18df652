"""Federated client entry point: ``python -m fedcrack_tpu_torch.client``.

The counterpart of ``python -m fedcrack_tpu.client``, with the same
flags: one federated session against a server of either package. The
local dataset is ``--image-dir/--mask-dir`` (paired crack images, matched
by stem; the train side of the reference's seeded split, then this
client's shard) or ``--synthetic N``. Every local fit runs on the card
unless ``main`` is given another ``device``. With ``--predict-dir``
the client predicts masks for its data with the last fit's model after
the session and quantifies them (``tools/quantify.predict_and_quantify``:
``pred_*.png``, ``overlay_*.png`` and a logged JSON report). With
``--dp-clip-norm`` each round's trained tree is privatized on the host
before upload (``privacy/dpsgd.dp_update_host``: the delta to the round's
base clipped, one Gaussian draw of ``--dp-noise-multiplier`` times the
clip added, seeded from ``(--dp-seed, name, round)``). The exit code is 0
when the client enrolled, else 1.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import zlib

import numpy as np
import torch

from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.data.pipeline import dataset_from_source, reference_split
from fedcrack_tpu_torch.data.sharding import shard_pairs
from fedcrack_tpu_torch.train.federated import make_train_fn


def local_shard(cfg: FedConfig, num_clients: int, client_index: int):
    """The client's pair filter: the train side of the reference's seeded
    split, then this client's disjoint shard (iid or crack-density skew),
    which every client computes alike."""

    def pick(pairs):
        train_pairs, _ = reference_split(pairs, cfg.data.train_samples, cfg.data.split_seed)
        return shard_pairs(
            train_pairs,
            num_clients,
            client_index,
            partition=cfg.data.partition,
            alpha=cfg.data.skew_alpha,
            seed=cfg.data.split_seed,
        )

    return pick


def _cast_like(leaf, ref):
    """``leaf`` in the leaf type and dtype of ``ref`` (a numpy array, or a
    CPU tensor where the wire carried bfloat16)."""
    if isinstance(ref, torch.Tensor):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        return t.to(ref.dtype)
    arr = leaf.to(torch.float32).numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return arr.astype(np.asarray(ref).dtype)


def private_train_fn(train_fn, cfg: FedConfig, cname: str):
    """``train_fn`` with update-level DP on its output: the round's blob
    (the base) and the trained blob decode on the host, the trained tree
    in the base's dtypes, and ``dp_update_host`` privatizes it before it is
    encoded again. Its noise is keyed on ``(cfg.dp_seed, cname, round)``,
    so a retried upload of a round is the same bytes."""
    from fedcrack_tpu_torch.fed.pytree import tree_map
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu_torch.privacy.dpsgd import dp_update_host

    def private(blob, rnd, *rest):
        out_blob, n_samples, metrics = train_fn(blob, rnd, *rest)
        base = tree_from_bytes(blob)
        trained = tree_map(_cast_like, tree_from_bytes(out_blob), base)
        privatized = dp_update_host(
            trained,
            base,
            clip_norm=cfg.dp_clip_norm,
            noise_multiplier=cfg.dp_noise_multiplier,
            dp_seed=cfg.dp_seed,
            cname=cname,
            round_idx=rnd,
        )
        return tree_to_bytes(privatized), n_samples, metrics

    return private


def main(argv: list[str] | None = None, *, device: torch.device | str | None = None) -> int:
    """Parse ``argv`` and run one session; local fits on ``device`` (the
    card unless given). glibc's mmap threshold is pinned first, as in the
    server command (``obs.sentries.pin_mmap_threshold``)."""
    from fedcrack_tpu_torch.obs import sentries
    from fedcrack_tpu_torch.transport.client import FedClient, default_cname

    sentries.pin_mmap_threshold()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="JSON FedConfig file")
    p.add_argument("--host")
    p.add_argument("--port", type=int)
    p.add_argument("--name", help="client name (default: random unique)")
    p.add_argument("--image-dir")
    p.add_argument("--mask-dir")
    p.add_argument("--synthetic", type=int, default=0, help="use N generated samples")
    p.add_argument(
        "--transport-dtype",
        choices=("uint8", "float32"),
        default="uint8",
        help="host->device staging dtype for file datasets; uint8 ships 1/4 "
        "the bytes and is bit-identical (normalization happens on device)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--num-clients",
        type=int,
        default=None,
        help="total cohort size for data sharding: each client takes a "
        "disjoint shard of the train split (cfg.data.partition: iid or "
        "crack-density skew). Defaults to the config's cohort_size when "
        "--client-index is given.",
    )
    p.add_argument(
        "--client-index", type=int, default=None, help="this client's shard row"
    )
    p.add_argument(
        "--predict-dir", help="write final-round mask predictions here"
    )
    p.add_argument("--metrics", dest="metrics_path", help="JSONL metrics file")
    p.add_argument(
        "--tb-dir",
        dest="tb_dir",
        help="TensorBoard event-file directory for per-round local-fit "
        "scalars and weight histograms",
    )
    p.add_argument(
        "--profile-dir",
        dest="profile_dir",
        help="torch.profiler trace dir wrapping each round's local fit",
    )
    p.add_argument(
        "--auth-token",
        dest="auth_token",
        help="shared enrollment token (must match the server's)",
    )
    p.add_argument(
        "--allow-insecure-token",
        dest="allow_insecure_token",
        action="store_const",
        const=True,
        default=None,
        help="accept --auth-token over a plaintext channel (the secret then "
        "travels in cleartext on every message; loopback/testing only)",
    )
    p.add_argument(
        "--tls-ca",
        dest="tls_ca",
        help="root CA (PEM) to verify the server over TLS; plaintext if unset",
    )
    p.add_argument("--tls-cert", dest="tls_cert", help="client certificate for mTLS (PEM)")
    p.add_argument("--tls-key", dest="tls_key", help="client private key for mTLS (PEM)")
    p.add_argument(
        "--max-message-mb",
        type=int,
        dest="max_message_mb",
        help="gRPC send/receive cap in MiB (must cover the server's dense "
        "weight broadcast regardless of the negotiated upload codec)",
    )
    p.add_argument(
        "--dp-clip-norm",
        type=float,
        dest="dp_clip_norm",
        help="update-level local DP (McMahan et al. 2018): clip this "
        "round's (trained - base) delta to this L2 norm before upload "
        "(0 disables)",
    )
    p.add_argument(
        "--dp-noise-multiplier",
        type=float,
        dest="dp_noise_multiplier",
        help="update-level DP noise: one seeded Gaussian N(0, "
        "(sigma*clip)^2) draw added to the clipped delta; the seed is "
        "derived from (dp_seed, name, round) so retried uploads are "
        "bit-identical",
    )
    p.add_argument(
        "--dp-seed",
        type=int,
        dest="dp_seed",
        help="root seed of the per-(client, round) DP noise derivation",
    )
    args = p.parse_args(argv)
    # Flags merge into the raw config dict before FedConfig is built, so its
    # validation sees the merged config (a --tls-ca or
    # --allow-insecure-token flag can rescue a config file).
    if args.config:
        import json

        with open(args.config) as f:
            raw = json.load(f)
    else:
        raw = {}
    overrides = {
        k: v
        for k, v in [
            ("host", args.host),
            ("port", args.port),
            ("metrics_path", args.metrics_path),
            ("tb_dir", args.tb_dir),
            ("profile_dir", args.profile_dir),
            ("auth_token", args.auth_token),
            ("allow_insecure_token", args.allow_insecure_token),
            ("tls_ca", args.tls_ca),
            ("tls_cert", args.tls_cert),
            ("tls_key", args.tls_key),
            ("max_message_mb", args.max_message_mb),
            ("dp_clip_norm", args.dp_clip_norm),
            ("dp_noise_multiplier", args.dp_noise_multiplier),
            ("dp_seed", args.dp_seed),
        ]
        if v is not None
    }
    raw.update(overrides)
    cfg = FedConfig.from_dict(raw)

    batch = cfg.data.batch_size
    if args.num_clients is not None:
        num_clients = args.num_clients
    elif args.client_index is not None:
        num_clients = cfg.cohort_size  # the presets' cohort is the shard count
    else:
        num_clients = 1
    if num_clients > 1 and args.client_index is None:
        # Shard 0 for every client would leave the rest of the data untrained.
        p.error("--num-clients > 1 requires --client-index")
    client_index = args.client_index if args.client_index is not None else 0
    cname = args.name or default_cname()
    data_seed = args.seed + client_index
    if args.synthetic and args.client_index is None and cfg.cohort_size > 1:
        # Without --client-index every synthetic member would draw the same
        # data; the unique client name seeds a distinct shard instead.
        data_seed = args.seed + zlib.crc32(cname.encode())
        logging.warning(
            "synthetic data with no --client-index in a %d-member cohort: "
            "deriving the data seed (%d) from client name %r so cohort "
            "members train distinct shards; pass --client-index for "
            "reproducible sharding",
            cfg.cohort_size,
            data_seed,
            cname,
        )
    if num_clients == 1 and cfg.cohort_size > 1 and not args.synthetic:
        logging.warning(
            "data sharding is OFF (every client would train the same data): "
            "pass --client-index (and optionally --num-clients) so each of "
            "the %d cohort members takes a disjoint shard",
            cfg.cohort_size,
        )

    try:
        dataset = dataset_from_source(
            args.synthetic,
            args.image_dir,
            args.mask_dir,
            img_size=cfg.model.img_size,
            batch_size=batch,
            seed=data_seed,
            num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch,
            pair_filter=local_shard(cfg, num_clients, client_index),
            transport_dtype=args.transport_dtype,
        )
    except ValueError as e:
        p.error(str(e))

    metrics_logger = None
    if cfg.metrics_path or cfg.tb_dir:
        from fedcrack_tpu_torch.obs import MetricsLogger

        metrics_logger = MetricsLogger(cfg.metrics_path or os.devnull, tb_dir=cfg.tb_dir or None)
    try:
        train_fn, holder = make_train_fn(
            cfg, dataset, batch, seed=args.seed, device=device, metrics_logger=metrics_logger
        )
        if cfg.dp_clip_norm > 0:
            train_fn = private_train_fn(train_fn, cfg, cname)
        client = FedClient(cfg, train_fn, cname=cname)
        result = client.run_session()
        if metrics_logger is not None:
            metrics_logger.log("session", enrolled=result.enrolled, rounds_completed=result.rounds_completed)
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
    if cfg.metrics_path and result.enrolled:
        # The whole JSONL, session record included (hence after the close),
        # to the server's log sink; best effort, since the server lingers
        # only briefly after FIN.
        try:
            client.upload_file(cfg.metrics_path)
        except Exception:
            logging.warning("metrics upload failed", exc_info=True)
    logging.info("session done: enrolled=%s rounds=%d", result.enrolled, result.rounds_completed)
    for entry in result.history:
        logging.info("round metrics: %s", entry)
    if args.predict_dir and result.final_weights is not None:
        import json

        from fedcrack_tpu_torch.tools.quantify import predict_and_quantify

        report = predict_and_quantify(holder["state"], dataset, out_dir=args.predict_dir)
        logging.info("crack quantification: %s", json.dumps(report))
    return 0 if result.enrolled else 1


if __name__ == "__main__":
    sys.exit(main())
