"""``python -m fedcrack_tpu_torch.serve``: boot the crack-segmentation endpoint.

The counterpart of ``python -m fedcrack_tpu.serve``, with the same flags.
It resolves the initial weights (``--weights`` msgpack file, then the
statefile, then the latest round checkpoint of ``--ckpt-dir``, then a
seeded init, in that order), builds the engine on the card (``main``
takes another ``device``), starts the hot-swap poller over the statefile
and the checkpoint directory, and serves ``fedcrack.ServePlane`` ``Predict`` and
``StreamPredict`` until SIGTERM or SIGINT. With ``quant != "none"``,
``replicas > 1``, ``min_replicas > 0`` or ``shadow_fraction > 0`` it
serves through the ``ServeFleet`` (the fleet's manager owns the quant
gate; the autoscaler and shadow delivery run only on the fleet);
otherwise through one ``MicroBatcher`` and a ``ModelVersionManager``.
With ``shadow_fraction > 0`` the ``ShadowController`` runs the statefile
poll in place of the manager's: each publish stages through the shadow
lane and is promoted or rolled back on its verdict.

It prints exactly one ``SERVING <host>:<port> ...`` line to stdout once
ready (with ``--port 0``, the bound port); at shutdown with
``--metrics-path`` it prints one ``{"serve_stats": ...}`` line, the
autoscaler's and the shadow controller's audits included. It exits
non-zero when a phase of its start-up fails.

``--compute-dtype bfloat16`` runs the reference programs in bfloat16
(``serve/engine.py``); the fused planes ignore it. ``--ckpt-dir`` reads
the port's round checkpoints (``ckpt/manager.py``), not orbax's.
``--compile-cache-dir`` configures an XLA cache, which the port has no
use for: its kernels build once into ``fedcrack_tpu_torch/_build/``, and
the flag is accepted and logged. In place of the JAX command's recompile
sentry, ``serve_recompiles_total`` counts the kernel libraries built or
loaded after the warm-up (``serve.engine.watch_kernel_compiles``), the
port's only run-time compiles. glibc's mmap threshold is pinned first
(``obs.sentries.pin_mmap_threshold``): a long serve fleet churns multi-MB
weight trees. A seeded model is not the JAX package's
(``torch.Generator`` against ``jax.random.key``); pass ``--weights`` to
serve the same model from both.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fedcrack_tpu_torch.serve", description=__doc__)
    p.add_argument("--config", help="FedConfig JSON preset (serve + model sections)")
    p.add_argument("--weights", help="msgpack pytree to serve initially")
    p.add_argument("--ckpt-dir", help="round checkpoint dir to hot-swap from")
    p.add_argument("--state-path", help="federation statefile to hot-swap from")
    p.add_argument("--host")
    p.add_argument("--port", type=int)
    p.add_argument("--buckets", help="comma-separated bucket sizes, e.g. 128,256")
    p.add_argument("--max-batch", type=int)
    p.add_argument("--max-delay-ms", type=float)
    p.add_argument("--tile-overlap", type=int,
                   help="sliding-window overlap px (must be < smallest bucket)")
    p.add_argument("--swap-poll-s", type=float)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    p.add_argument("--replicas", type=int,
                   help="replica workers behind the fleet router (>1 serves through the fleet: "
                   "least-outstanding dispatch, two-phase hot swap, admission control)")
    p.add_argument("--quant", choices=["none", "int8"],
                   help="post-training weight quantization of the predict program; int8 installs "
                   "are A/B-gated on probe mask IoU vs the reference program and refused below "
                   "--quant-iou-floor")
    p.add_argument("--quant-iou-floor", type=float)
    p.add_argument("--min-replicas", type=int,
                   help="arm the SLO autoscaler: fleet floor (>= 1; pairs with --max-replicas; "
                   "--replicas is the boot size inside the band)")
    p.add_argument("--max-replicas", type=int, help="autoscaler fleet ceiling (>= --min-replicas)")
    p.add_argument("--scale-interval-s", type=float, help="autoscaler control-loop period")
    p.add_argument("--scale-cooldown-s", type=float,
                   help="dead time after any scaling action (anti-flap)")
    p.add_argument("--shadow-fraction", type=float,
                   help="traffic mirrored to a shadow candidate lane (> 0: publishes stage through "
                   "the shadow and are promoted or rolled back instead of installed at once)")
    p.add_argument("--slo-p95-ms", type=float,
                   help="shed (RESOURCE_EXHAUSTED) when rolling p95 breaches this; 0 off")
    p.add_argument("--queue-bound", type=int,
                   help="shed when queued requests across replicas reach this; 0 off")
    p.add_argument("--stream-cache-tiles", type=int,
                   help="per-stream tile cache bound for video sessions (entries = tiles, keyed "
                   "on (model_version, tile hash)); 0 disables caching: every frame is a full "
                   "re-run")
    p.add_argument("--stream-max-sessions", type=int,
                   help="open video sessions the serve process will hold at once")
    p.add_argument("--compile-cache-dir",
                   help="an XLA cache directory in the JAX package; accepted and unused here "
                   "(the kernels build once into fedcrack_tpu_torch/_build/)")
    p.add_argument("--metrics-path", help="JSONL metrics sink (serve_batch/serve_fleet_swap)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="Prometheus /metrics endpoint for the live registry; 0 disables, -1 "
                   "binds an ephemeral port")
    p.add_argument("--spans-path",
                   help="JSONL trace-span sink (serve.batch/serve.swap spans); empty disables")
    p.add_argument("--seed", type=int, default=0, help="init seed when no weights found")
    return p


# The flags that override the config file's ServeConfig field of their name.
_OVERRIDES = (
    "max_batch", "max_delay_ms", "tile_overlap", "swap_poll_s", "port", "replicas", "quant",
    "quant_iou_floor", "slo_p95_ms", "queue_bound", "stream_cache_tiles", "stream_max_sessions",
    "min_replicas", "max_replicas", "scale_interval_s", "scale_cooldown_s", "shadow_fraction",
)


def resolve_config(args):
    """``(ModelConfig, ServeConfig)`` from ``--config`` and the flags."""
    from fedcrack_tpu_torch.configs import SLOT_PLANE_ONLY, FedConfig, SegFormerConfig

    if args.config:
        with open(args.config) as f:
            fed = FedConfig.from_json(f.read())
    else:
        fed = FedConfig()
    if isinstance(fed.model, SegFormerConfig):
        raise ValueError(SLOT_PLANE_ONLY.format(what="serving"))
    overrides = {name: getattr(args, name) for name in _OVERRIDES if getattr(args, name) is not None}
    if args.buckets:
        overrides["bucket_sizes"] = tuple(int(s) for s in args.buckets.split(",") if s.strip())
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    if args.host:
        overrides["host"] = args.host
    serve = dataclasses.replace(fed.serve, **overrides) if overrides else fed.serve
    return fed.model, serve


def resolve_initial_weights(args, template, seed: int):
    """``(version, variables)``: the ``--weights`` file, else the statefile,
    else the latest round checkpoint, else the seeded ``template``."""
    from fedcrack_tpu_torch.serve.hot_swap import read_statefile_weights

    if args.weights:
        from fedcrack_tpu_torch.fed.serialization import tree_from_bytes

        with open(args.weights, "rb") as f:
            return 0, tree_from_bytes(f.read(), template=template)
    if args.state_path:
        got = read_statefile_weights(args.state_path, template=template)
        if got is not None:
            return got
    if args.ckpt_dir:
        import os

        from fedcrack_tpu_torch.ckpt.manager import FedCheckpointer

        if os.path.isdir(args.ckpt_dir):
            with FedCheckpointer(args.ckpt_dir) as ckptr:
                ckpt = ckptr.restore(template)
            if ckpt is not None:
                return ckpt.model_version, ckpt.variables
    print(
        "no weights source found; serving seed-initialized model "
        f"(seed {seed}) until the first hot-swap",
        file=sys.stderr,
    )
    return 0, template


async def _serve(args, device) -> int:
    import torch

    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.promexp import start_exporter
    from fedcrack_tpu_torch.serve.engine import watch_kernel_compiles
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeService
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager

    model_config, serve_config = resolve_config(args)
    if args.compile_cache_dir:
        logging.info(
            "--compile-cache-dir %s unused: the port compiles no programs per shape; its kernels "
            "build once into fedcrack_tpu_torch/_build/", args.compile_cache_dir,
        )
    template = init_variables(torch.Generator().manual_seed(args.seed), model_config)
    version, variables = resolve_initial_weights(args, template, args.seed)

    metrics = None
    if args.metrics_path:
        from fedcrack_tpu_torch.obs.metrics import MetricsLogger

        metrics = MetricsLogger(args.metrics_path)

    fleet = None
    if (serve_config.replicas > 1 or serve_config.quant != "none" or serve_config.min_replicas > 0
            or serve_config.shadow_fraction > 0):
        from fedcrack_tpu_torch.serve.fleet import ServeFleet

        fleet = ServeFleet(
            model_config,
            serve_config,
            variables,
            initial_version=version,
            ckpt_dir=args.ckpt_dir,
            state_path=args.state_path,
            template=template,
            metrics=metrics,
            device=device,
        )
        engine, batcher_like, manager = fleet.engine, fleet.router, fleet.manager
    else:
        from fedcrack_tpu_torch.serve.batcher import MicroBatcher
        from fedcrack_tpu_torch.serve.engine import InferenceEngine
        from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

        engine = InferenceEngine(model_config, serve_config, device=device)
        manager = ModelVersionManager(
            engine,
            variables,
            initial_version=version,
            ckpt_dir=args.ckpt_dir,
            state_path=args.state_path,
            poll_s=serve_config.swap_poll_s,
            template=template,
        )
        engine.warmup(manager.snapshot()[1])
        batcher_like = MicroBatcher(engine, manager, metrics=metrics)
    watch_kernel_compiles()
    exporter = start_exporter(args.metrics_port)
    if args.spans_path:
        from fedcrack_tpu_torch.obs import spans as tracing

        tracing.install(args.spans_path)
    # Video sessions pin snapshots from the same manager as the still path,
    # so a hot swap invalidates stream caches through the version key.
    stream_manager = StreamSessionManager(engine, manager)
    server = ServeServer(
        ServeService(engine, batcher_like, manager, stream_manager=stream_manager),
        host=serve_config.host,
        port=serve_config.port,
        max_message_mb=serve_config.max_message_mb,
    )
    autoscaler = None
    if fleet is not None and serve_config.min_replicas > 0:
        from fedcrack_tpu_torch.serve.autoscaler import FleetAutoscaler

        autoscaler = FleetAutoscaler(fleet)
        autoscaler.start()
    shadow_ctrl = None
    if fleet is not None and serve_config.shadow_fraction > 0:
        from fedcrack_tpu_torch.serve.shadow import ShadowController

        # The controller runs the delivery poll; the manager's own
        # auto-install loop stays off, or a publish would install unjudged.
        shadow_ctrl = ShadowController(fleet, metrics=metrics)
        shadow_ctrl.start()
    else:
        manager.start()
    port = await server.start()
    metrics_note = f" metrics_port={exporter.bound_port}" if exporter is not None else ""
    print(
        f"SERVING {serve_config.host}:{port} "
        f"buckets={','.join(str(s) for s in serve_config.bucket_sizes)} "
        f"max_batch={serve_config.max_batch} version={manager.version}"
        f" replicas={serve_config.replicas} quant={serve_config.quant}"
        f"{metrics_note}",
        flush=True,
    )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    await stop.wait()
    await server.stop()
    if autoscaler is not None:
        autoscaler.stop()
    if shadow_ctrl is not None:
        shadow_ctrl.stop()
    if fleet is not None:
        fleet.close()
    else:
        manager.stop()
        batcher_like.close()
    if exporter is not None:
        exporter.stop()
    if metrics is not None:
        stats = fleet.stats() if fleet is not None else batcher_like.stats()
        if autoscaler is not None:
            stats["autoscaler"] = autoscaler.audit()
        if shadow_ctrl is not None:
            stats["shadow"] = shadow_ctrl.audit()
        stats["stream"] = stream_manager.stats()
        print(json.dumps({"serve_stats": stats}), flush=True)
        metrics.close()
    return 0


def main(argv=None, *, device=None) -> int:
    """Parse ``argv`` and serve until SIGTERM/SIGINT on ``device`` (the
    card unless given)."""
    from fedcrack_tpu_torch.obs import sentries

    sentries.pin_mmap_threshold()
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    return asyncio.run(_serve(args, device))


if __name__ == "__main__":
    sys.exit(main())
