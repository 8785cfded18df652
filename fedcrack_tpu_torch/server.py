"""Federation coordinator entry point: ``python -m fedcrack_tpu_torch.server``.

The counterpart of ``python -m fedcrack_tpu.server``, with the same flags
and the same config-file merge: build the initial global model, then serve
FedAvg (or FedBuff) over gRPC until the last round. The per-round eval of
each new global (``--eval-*``) recalibrates BatchNorm on the eval set and
evaluates on the card unless ``main`` is given another ``device``.

The initial global comes from ``torch.Generator().manual_seed(seed)``, not
from ``jax.random.key(seed)``, so one ``--seed`` gives the two packages
different weights; ``--init-weights`` (a flax msgpack tree) starts both
from the same ones. ``--ckpt-dir`` saves a round checkpoint after each
aggregation and resumes from the latest one at boot (``ckpt/manager.py``;
the port's own format, not orbax's). ``--secagg`` runs pairwise-mask
secure aggregation, ``--dp-noise-multiplier`` charges each round to the
RDP accountant, and at the end the privacy summary is logged and, with
``--privacy-summary``, written as JSON (``fed.rounds.privacy_summary``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
import threading
from typing import Any

import torch

from fedcrack_tpu_torch.configs import FedConfig

def build_config(argv: list[str] | None = None) -> tuple[FedConfig, Any]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="JSON FedConfig file (flags override it)")
    p.add_argument("--rounds", type=int, help="max federation rounds")
    p.add_argument("--cohort", type=int, help="target cohort size")
    p.add_argument("--port", type=int)
    p.add_argument("--host")
    p.add_argument("--registration-window", type=float, dest="registration_window_s")
    p.add_argument("--round-deadline", type=float, dest="round_deadline_s")
    p.add_argument(
        "--quorum-fraction",
        type=float,
        dest="quorum_fraction",
        help="aggregate at ceil(f * cohort) received updates instead of the "
        "full barrier (Bonawitz et al.); stragglers are re-synced, the "
        "round deadline stays as backstop; 1.0 = full barrier",
    )
    p.add_argument(
        "--state-path",
        dest="state_path",
        help="mid-round durable server state (atomic msgpack snapshot of "
        "cohort/phase/received): a server killed mid-round resumes the "
        "SAME round with the already-received updates intact",
    )
    p.add_argument(
        "--mode",
        dest="mode",
        help="federation mode: sync (barrier rounds, the default) or "
        "buffered (FedBuff async aggregation — updates fold into a "
        "K-sized staleness-weighted buffer as they arrive; no round "
        "barrier, clients loop pull->train->push continuously)",
    )
    p.add_argument(
        "--buffer-k",
        type=int,
        dest="buffer_k",
        help="buffered mode: flush to a new global version after this many "
        "accepted updates (FedBuff's K); buffer_k = cohort with "
        "staleness-alpha 0 reproduces sync FedAvg bit-exactly",
    )
    p.add_argument(
        "--staleness-alpha",
        type=float,
        dest="staleness_alpha",
        help="buffered mode: polynomial staleness decay exponent — an "
        "update s versions stale weighs ns * (1+s)^-alpha (FedAsync); "
        "0 disables decay",
    )
    p.add_argument(
        "--max-staleness",
        type=int,
        dest="max_staleness",
        help="buffered mode: updates staler than this many versions are "
        "rejected into the history and the sender re-synced; also bounds "
        "the retained past-broadcast window for delta decode",
    )
    p.add_argument("--fedprox-mu", type=float, dest="fedprox_mu")
    p.add_argument(
        "--pos-weight",
        type=float,
        dest="pos_weight",
        help="crack-pixel BCE weight for every client's local fit (>1 "
        "counters the foreground imbalance; 1 = reference's plain BCE)",
    )
    p.add_argument(
        "--aggregation",
        dest="aggregation",
        help="how accepted updates combine (fed/aggregation.py): fedavg "
        "(sample-weighted mean, the default), trimmed_mean, median/"
        "coordinate_median, krum, multi_krum — the robust combines ignore "
        "client-reported sample counts",
    )
    p.add_argument(
        "--trim-fraction",
        type=float,
        dest="trim_fraction",
        help="trimmed_mean's beta: drop floor(beta*n) per coordinate from "
        "each tail; [0, 0.5)",
    )
    p.add_argument(
        "--byzantine-f",
        type=int,
        dest="byzantine_f",
        help="krum/multi_krum's assumed Byzantine count f",
    )
    p.add_argument(
        "--quarantine-z",
        type=float,
        dest="quarantine_z",
        help="exclude a client from the fold when its flush-time robust-z "
        "anomaly score reaches this threshold (0 disables; 3.5 matches "
        "the ledger's alert line)",
    )
    p.add_argument(
        "--secagg",
        dest="secagg",
        action="store_const",
        const=True,
        default=None,
        help="pairwise-mask secure aggregation: "
        "the cohort uploads fixed-point masked updates whose masks cancel "
        "exactly in the fold; a dropped masker is recovered from its "
        "enroll-time seed. Requires aggregation=fedavg, quarantine_z=0 "
        "and update_codec=null (validated loudly)",
    )
    p.add_argument(
        "--secagg-bits",
        type=int,
        dest="secagg_bits",
        help="fixed-point fractional bits for masked uploads (default 24)",
    )
    p.add_argument(
        "--dp-clip-norm",
        type=float,
        dest="dp_clip_norm",
        help="DP-SGD per-step L2 clip norm C for the cohort's local fits "
        "(0 disables the DP twin; required > 0 when noise is on)",
    )
    p.add_argument(
        "--dp-noise-multiplier",
        type=float,
        dest="dp_noise_multiplier",
        help="DP-SGD Gaussian noise multiplier sigma: per-step noise is "
        "N(0, (sigma*C)^2); drives the RDP accountant's per-client "
        "epsilon in round history",
    )
    p.add_argument(
        "--dp-sample-rate",
        type=float,
        dest="dp_sample_rate",
        help="accountant's per-step subsampling rate q (default 0.01)",
    )
    p.add_argument(
        "--dp-delta",
        type=float,
        dest="dp_delta",
        help="accountant's target delta (default 1e-5)",
    )
    p.add_argument(
        "--dp-steps-per-round",
        type=int,
        dest="dp_steps_per_round",
        help="noise steps the accountant charges each contributor per "
        "round close (default 0 = local_epochs)",
    )
    p.add_argument(
        "--dp-seed",
        type=int,
        dest="dp_seed",
        help="root seed of the per-(client, round, leaf) DP noise key "
        "chain (kept in the persisted config; clients pass their own "
        "--dp-seed, which must match for a coherent replay story)",
    )
    p.add_argument(
        "--dp-epsilon-budget",
        type=float,
        dest="dp_epsilon_budget",
        help="refuse further rounds once any client's accounted epsilon "
        "reaches this budget (0 = unlimited)",
    )
    p.add_argument(
        "--privacy-summary",
        dest="privacy_summary_path",
        help="write the final privacy summary (per-client epsilon, secagg "
        "roster facts) as JSON here at federation end",
    )
    p.add_argument(
        "--server-optimizer",
        dest="server_optimizer",
        help="FedOpt server update: avg (plain FedAvg), momentum/fedavgm, "
        "adam/fedadam, yogi/fedyogi",
    )
    p.add_argument("--server-lr", type=float, dest="server_lr")
    p.add_argument("--server-momentum", type=float, dest="server_momentum")
    p.add_argument(
        "--wire-dtype",
        dest="wire_dtype",
        help="weight payload dtype on the control plane: float32 or "
        "bfloat16 (halves upload+broadcast bytes; server math stays f32)",
    )
    p.add_argument(
        "--update-codec",
        dest="update_codec",
        help="compressed update transport (compress/): null "
        "(today's raw bytes, bit-exact), int8 (quantized round delta), or "
        "topk_delta (top-k sparsified delta with client-side error "
        "feedback); advertised to the cohort in-band at enroll",
    )
    p.add_argument(
        "--topk-fraction",
        type=float,
        dest="topk_fraction",
        help="topk_delta keep fraction per leaf (default 0.01 = ~50x fewer "
        "upload bytes before framing)",
    )
    p.add_argument(
        "--max-message-mb",
        type=int,
        dest="max_message_mb",
        help="gRPC send/receive cap in MiB, both directions; startup checks "
        "that the worst-case weight message under the configured codec fits",
    )
    p.add_argument(
        "--seed",
        type=int,
        help="seed of the initial global model (torch.Generator: not the JAX "
        "package's weights for the same seed; --init-weights shares a start)",
    )
    p.add_argument(
        "--ckpt-dir",
        dest="ckpt_dir",
        help="round checkpoint directory; when it already holds a checkpoint "
        "the federation resumes from the latest round",
    )
    p.add_argument(
        "--metrics",
        dest="metrics_path",
        help="JSONL file for structured per-round metrics",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        dest="metrics_port",
        default=0,
        help="serve the live metric registry as Prometheus text format on "
        "http://127.0.0.1:<port>/metrics; 0 disables, -1 binds an "
        "ephemeral port (logged)",
    )
    p.add_argument(
        "--spans-path",
        dest="spans_path",
        help="JSONL trace-span sink (fed.flush / client.push correlation "
        "spans); empty disables span recording",
    )
    p.add_argument(
        "--tb-dir",
        dest="tb_dir",
        help="TensorBoard event-file directory: per-round metrics become "
        "TensorBoard scalars",
    )
    p.add_argument(
        "--eval-synthetic",
        type=int,
        default=0,
        help="evaluate the global model each round on N generated samples",
    )
    p.add_argument("--eval-image-dir", help="server-side eval images")
    p.add_argument("--eval-mask-dir", help="server-side eval masks")
    p.add_argument(
        "--best-path",
        dest="best_path",
        help="keep the best global model by server-side eval loss here "
        "(msgpack + .json metrics sidecar); requires --eval-*",
    )
    p.add_argument(
        "--logs-dir",
        dest="logs_dir",
        help="sink directory for client-uploaded log files; empty keeps "
        "uploads in memory",
    )
    p.add_argument(
        "--init-weights",
        dest="init_weights",
        help="seed the global model from a flax msgpack tree (either "
        "package's tree_to_bytes, or a checkpoint such as best.msgpack)",
    )
    p.add_argument(
        "--auth-token",
        dest="auth_token",
        help="shared enrollment token: every client message must carry it "
        "or is REJECTED",
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
    p.add_argument("--tls-cert", dest="tls_cert", help="server TLS certificate (PEM)")
    p.add_argument("--tls-key", dest="tls_key", help="server TLS private key (PEM)")
    p.add_argument(
        "--tls-ca",
        dest="tls_ca",
        help="CA bundle (PEM); on the server this also demands client "
        "certificates (mTLS)",
    )
    args = p.parse_args(argv)

    # Flags merge into the RAW config dict before FedConfig construction:
    # __post_init__ validation (TLS pairing, plaintext-token refusal) must
    # see the final merged config, or a flag meant to resolve a validation
    # error (--allow-insecure-token, --tls-*) could never rescue a config
    # file that fails it.
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    else:
        raw = {}
    overrides = {}
    for flag, field in [
        ("rounds", "max_rounds"),
        ("cohort", "cohort_size"),
        ("port", "port"),
        ("host", "host"),
        ("registration_window_s", "registration_window_s"),
        ("round_deadline_s", "round_deadline_s"),
        ("quorum_fraction", "quorum_fraction"),
        ("state_path", "state_path"),
        ("mode", "mode"),
        ("buffer_k", "buffer_k"),
        ("staleness_alpha", "staleness_alpha"),
        ("max_staleness", "max_staleness"),
        ("fedprox_mu", "fedprox_mu"),
        ("pos_weight", "pos_weight"),
        ("aggregation", "aggregation"),
        ("trim_fraction", "trim_fraction"),
        ("byzantine_f", "byzantine_f"),
        ("quarantine_z", "quarantine_z"),
        ("secagg", "secagg"),
        ("secagg_bits", "secagg_bits"),
        ("dp_clip_norm", "dp_clip_norm"),
        ("dp_noise_multiplier", "dp_noise_multiplier"),
        ("dp_sample_rate", "dp_sample_rate"),
        ("dp_delta", "dp_delta"),
        ("dp_steps_per_round", "dp_steps_per_round"),
        ("dp_seed", "dp_seed"),
        ("dp_epsilon_budget", "dp_epsilon_budget"),
        ("server_optimizer", "server_optimizer"),
        ("server_lr", "server_lr"),
        ("server_momentum", "server_momentum"),
        ("wire_dtype", "wire_dtype"),
        ("update_codec", "update_codec"),
        ("topk_fraction", "topk_fraction"),
        ("max_message_mb", "max_message_mb"),
        ("ckpt_dir", "ckpt_dir"),
        ("seed", "seed"),
        ("metrics_path", "metrics_path"),
        ("tb_dir", "tb_dir"),
        ("logs_dir", "logs_dir"),
        ("init_weights", "init_weights"),
        ("best_path", "best_path"),
        ("auth_token", "auth_token"),
        ("allow_insecure_token", "allow_insecure_token"),
        ("tls_cert", "tls_cert"),
        ("tls_key", "tls_key"),
        ("tls_ca", "tls_ca"),
    ]:
        val = getattr(args, flag)
        if val is not None:
            overrides[field] = val
    raw.update(overrides)
    cfg = FedConfig.from_dict(raw)
    shown = json.loads(cfg.to_json())
    if shown.get("auth_token"):
        shown["auth_token"] = "<redacted>"  # the secret must not hit logs
    logging.info("config: %s", shown)
    return cfg, args


def make_eval_fn(cfg: FedConfig, dataset, template: dict, device: torch.device | str | None = None):
    """``eval_fn(global_blob) -> metrics`` for ``FedServer``: load the blob
    into one evaluator model on ``device``, estimate its BatchNorm
    statistics again from the eval images (a fresh average carries mixed,
    under-converged running statistics), then evaluate. Calls are
    serialized: the server may evaluate two rounds' globals at once."""
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes
    from fedcrack_tpu_torch.train.local import create_train_state, evaluate, recalibrate_batch_stats

    state = create_train_state(torch.Generator().manual_seed(cfg.seed), cfg.model, cfg.learning_rate, device)
    lock = threading.Lock()

    def eval_fn(blob: bytes) -> dict:
        with lock:
            st = state.replace_variables(tree_from_bytes(blob, template=template))
            st = recalibrate_batch_stats(st, dataset)
            return evaluate(st, dataset, pos_weight=cfg.pos_weight)

    return eval_fn


def main(argv: list[str] | None = None, *, device: torch.device | str | None = None) -> int:
    """Parse ``argv``, serve the federation to its end; the per-round eval
    runs on ``device`` (the card unless given). glibc's mmap threshold is
    pinned first: a long FedBuff root churns multi-MB weight blobs
    (``obs.sentries.pin_mmap_threshold``)."""
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs import sentries
    from fedcrack_tpu_torch.transport.service import FedServer

    sentries.pin_mmap_threshold()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg, args = build_config(argv)
    variables = init_variables(torch.Generator().manual_seed(cfg.seed), cfg.model)
    eval_fn = None
    if args.eval_synthetic or (args.eval_image_dir and args.eval_mask_dir):
        from fedcrack_tpu_torch.data.pipeline import dataset_from_source

        eval_dataset = dataset_from_source(
            args.eval_synthetic,
            args.eval_image_dir,
            args.eval_mask_dir,
            img_size=cfg.model.img_size,
            batch_size=cfg.data.batch_size,
            seed=cfg.seed + 1,  # never the clients' train fixtures
            drop_last=False,
        )
        eval_fn = make_eval_fn(cfg, eval_dataset, variables, device)
    if cfg.best_path and eval_fn is None:
        logging.warning(
            "--best-path %s is set but server-side eval is off (no --eval-*): "
            "no best model will ever be written",
            cfg.best_path,
        )
    if cfg.init_weights:
        from fedcrack_tpu_torch.fed.serialization import tree_from_bytes

        with open(cfg.init_weights, "rb") as f:
            variables = tree_from_bytes(f.read(), template=variables)
        logging.info("seeded global model from %s", cfg.init_weights)
    metrics = None
    if cfg.metrics_path or cfg.tb_dir:
        from fedcrack_tpu_torch.obs import MetricsLogger

        metrics = MetricsLogger(cfg.metrics_path or os.devnull, tb_dir=cfg.tb_dir or None)
    exporter = None
    if args.metrics_port:
        from fedcrack_tpu_torch.obs.promexp import start_exporter

        exporter = start_exporter(args.metrics_port)
        if exporter is not None:
            logging.info("metrics: %s", exporter.url)
    from fedcrack_tpu_torch.obs import spans as tracing

    if args.spans_path:
        tracing.install(args.spans_path)
    checkpointer = None
    if cfg.ckpt_dir:
        from fedcrack_tpu_torch.ckpt import FedCheckpointer

        checkpointer = FedCheckpointer(cfg.ckpt_dir)
    try:
        server = FedServer(cfg, variables, checkpointer=checkpointer, metrics=metrics, eval_fn=eval_fn)
        final = asyncio.run(server.serve_until_finished())
    finally:
        if exporter is not None:
            exporter.stop()
        if metrics is not None:
            metrics.close()
        if args.spans_path:
            tracing.uninstall()
    for entry in server.eval_history:
        logging.info("server eval %s", entry)
    if args.privacy_summary_path or cfg.dp_noise_multiplier > 0 or cfg.secagg:
        from fedcrack_tpu_torch.fed.rounds import privacy_summary

        summary = privacy_summary(final)
        logging.info("privacy summary: %s", summary)
        if args.privacy_summary_path:
            from fedcrack_tpu_torch.ioutils import atomic_write_bytes

            atomic_write_bytes(
                args.privacy_summary_path, json.dumps(summary, sort_keys=True, indent=2).encode("utf-8")
            )
            logging.info("privacy summary -> %s", args.privacy_summary_path)
    logging.info(
        "federation finished: %d rounds, final cohort %s", len(final.history), sorted(final.cohort)
    )
    for entry in final.history:
        logging.info("round %s: clients=%s", entry["round"], entry["clients"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
