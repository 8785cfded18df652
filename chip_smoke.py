#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``fedcrack_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``; it imports neither JAX nor ``fedcrack_tpu``. Phases (each raises
on failure, so any failure exits non-zero and prints no result):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles ``fedcrack_tpu_torch/kernels/csrc/dequant.cu`` and
   ``bce_sums.cu`` (sm_90a), one nvcc each, started together;
3. kernels vs plain, int8 and e4m3 codes: ``dequant_matmul`` at the 15
   GEMMs and ``dequant_conv3x3`` at the 8 decoder convs the fused forward
   launches at bucket 256 x batch 8 with ``ModelConfig()``, each plus a
   ragged sweep: per entry within the per-channel scale + 1e-6 of the
   plain version (the largest |kernel - plain| / scale is logged), bitwise
   equal run to run and over a launch of fewer rows; ``dequant_codes_group``
   bitwise equal to its plain version at every leaf of the forward's six
   depthwise kernels in one call, of a ragged group, of a group with a
   misaligned leaf, and of one-leaf calls. Per forward: device time
   (profiler) of kernel, plain version and library call (``torch.matmul``
   / ``F.conv2d`` on channels-last input, weights expanded once, TF32 off;
   6 x ``torch.mul(q, s)``), CUDA-event times beside them, and the bound
   (bytes at 3.35 TB/s with A read once, or three bf16 passes at 989
   TFLOP/s; the f32-FMA bound logged beside it);
4. serve at full width (the main path): ``ModelConfig()`` with
   ``ServeConfig(quant="int8", kernel_plane="fused_int8")``, install through
   ``ModelVersionManager.install`` (the quant gate must pass at both
   buckets), then requests through ``MicroBatcher.submit`` (16 at 256^2,
   8 at 128^2, 2 padded) and one tiled 512 x 384 image through
   ``predict_image``, twice. Launch counts are reset right before and read
   right after (15 ``dequant_matmul``, 8 ``dequant_conv3x3`` and 1
   ``dequant_codes`` per forward); fused vs reference plane on the probe
   batch; throughput; a profile of one bucket-256 batch;
5. the fp8 plane: the same with ``kernel_plane="fp8"``, one batch served;
6. ``bce_sums`` vs plain at the train step's logits (16 x 128 x 128), at
   8 x 256 x 256, and over a ragged sweep: count lanes equal, BCE lanes
   within rtol 1e-5 / atol 1e-3, bitwise equal run to run, back to back at
   alternating sizes and on two streams at once; one kernel per call by
   the profiler; device time (``ms``) and CUDA-event time (``event_ms``)
   of kernel, plain version and ``F.binary_cross_entropy_with_logits``
   (``library_ms``, ``library_event_ms``), and the bound;
7. the federation at full width (the training path's main path):
   ``ModelConfig()`` at 128 px, batch 16, two clients of 64 seeded
   synthetic samples and 32 held out. The server is
   ``fed.rounds.initial_state(FedConfig(max_rounds=2, cohort_size=2,
   local_epochs=1))``; each client runs Ready, PullWeights,
   TrainingNotice, ``train_fn(blob, round, reply.config)`` (the blob form
   of ``make_train_fn``), TrainDone and VersionPoll under a synthetic
   clock until FIN, and each new global is evaluated. Checked: the status
   sequence, the two history entries, ``bce_sums`` launches equal to
   train steps plus eval batches, and each round's broadcast blob bitwise
   equal to the global of a tree-level loop (``fold(FedAvg())`` over a
   second set of the same clients). Logged: blob bytes, host ms of
   ``tree_to_bytes`` / ``tree_from_bytes``, of the transition that closes
   each round, and each round's wall. Then one train step on the card
   against the same step on the CPU, two local fits bitwise equal, step
   throughput and a profile of one step;
8. a robust round at full width through the protocol: three clients of
   32 samples, a bfloat16 wire, ``aggregation="trimmed_mean"``
   (``trim_fraction=0.34``), ``server_optimizer="fedadam"``
   (``server_lr=0.01``) and a 30 s round deadline. The third client
   uploads a NaN leaf and is REJECTED; the deadline's Tick closes the
   round on the other two; the history records the rejection; FedAdam
   moves no parameter by more than its learning rate; the closing
   transition's parts are timed alone (``server_breakdown``);
9. FedAvg over gRPC at full width: a ``transport.FedServer`` in a
   ``ServerThread`` on 127.0.0.1 (port 0) and two ``transport.FedClient``
   threads, each running ``make_train_fn`` on the card with phase 7's
   data, names, seeds and ``FedConfig`` (f32 wire, ``update_codec="null"``,
   poll period 0.05 s), the server's ``eval_fn`` over phase 7's 32
   held-out samples. Checked: both sessions complete 2 rounds, each
   round's global is byte-equal to phase 7's, and ``bce_sums`` launches
   equal train steps plus eval batches. Logged: each round's wall and
   server ms, the wire bytes up and down, and the wall against phase 7's;
10. a compressed federation over gRPC: the same with
    ``update_codec="int8"``. Checked: every upload is an int8 frame, and
    each round's global is byte-equal to ``fed.rounds.transition`` fed the
    same frames in process (a client subclass records what it sends).
    Logged: frame bytes against dense bytes, encode and decode ms, and
    the compiled CRC32C's MiB/s;
11. FedBuff over gRPC at full width: phase 9's setup with
    ``FedConfig(mode="buffered", buffer_k=2, staleness_alpha=0.5,
    max_staleness=4, max_rounds=3)``, a ``state_path`` in a temp dir and
    the server's ``eval_fn``; the two clients run the buffered
    pull -> train -> push loop until FIN. The server records every event
    in the order it applied them, and the record is replayed through
    ``fed.rounds.transition`` in process. Checked: each flushed global
    byte-equal to the replay's, the replay's replies, history and
    accepted uploads (client, ``seq``, pulled-at version) the server's;
    every history entry buffered with its staleness list and
    ``updates_per_sec``; the statefile on disk decoding with
    ``server_state_from_bytes`` and re-encoding to its bytes at version 3;
    ``bce_sums`` launches equal train steps plus eval batches. Logged:
    flush walls, statefile bytes, snapshot encode and write ms,
    ``async_summary``;
12. a mid-buffer stop, resume and hot swap at full width: a buffered
    server (K = 2) takes one card fit into its buffer and is stopped once
    the snapshot is on disk; a fresh ``FedServer`` boots from the same
    ``state_path`` with the buffer intact and flushes on the second fit,
    bit-identical to an uninterrupted in-process replay of the two
    uploads. A ``ModelVersionManager`` on a ``fused_int8`` engine watches
    that statefile: ``poll_once`` installs the flushed version, its gate
    deciding as a CPU engine's does on the same weights (IoU logged), then
    the flushed weights snapped to the code grid, published with
    ``publish_statefile`` at version 2, pass the gate and are installed;
    one bucket-256 batch on them launches 15 ``dequant_matmul``, 8
    ``dequant_conv3x3`` and 1 ``dequant_codes`` kernel (wrapper counts
    and profiler). Logged: install ms (gate included).

Before phase 2, ``main`` logs which of jax, flax, optax, msgpack,
ml_dtypes, grpc, google (protobuf) and ``fedcrack_tpu`` the machine has,
and blocks all but grpc in ``sys.modules``: the codec, gate, ledger,
robust folds, FedOpt and the transport's wire codec run without them.

The last three lines: the card's name and power limit, the per-kernel JSON
object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense rates, at the 700 W limit): device
# memory bandwidth; the f32 rate outside the tensor cores (bce_sums and
# dequant_codes, and the f32-FMA bound of the dequant GEMMs, kept in the
# log for comparison); the bf16 tensor-core rate, which the dequant GEMMs use
# three times per product (hi, mid and lo terms of the f32 activation).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
BF16_PASSES = 3

SWEEP_SHAPES = [(4, 7, 5), (8, 128, 128), (33, 130, 129), (1, 256, 3), (16, 9, 17)]
# Ragged GEMMs beside the JAX tests' sweep: the stem's K = 27 and the head's
# N = 1, and M, K, N that are multiples of no tile.
MATMUL_SWEEP = SWEEP_SHAPES + [(1000, 27, 1), (129, 36, 33), (70, 2304, 257), (300, 20, 8)]
# Ragged convs (N, H, W, C, F): odd grids, a 1x1 image, C and F off every tile.
CONV_SWEEP = [(1, 5, 7, 8, 12), (2, 6, 6, 4, 9), (1, 1, 1, 4, 3), (3, 9, 11, 36, 17),
              (2, 17, 13, 132, 40), (1, 33, 31, 64, 129)]
BUCKET, BATCH = 256, 8
# The largest probability difference allowed between a served batch and
# the same weights through another plane or on the CPU (phases 4, 5, 12).
SERVE_PROB_TOL = 1e-3
# The training path: the reference's client shape, and the JAX kernel
# test's ragged sizes for bce_sums.
TRAIN_SIZE, TRAIN_BATCH = 128, 16
BCE_SWEEP = [1, 100, 128, 32768, 32769, 100_000]
# Ragged code groups: 1 and 17 codes, 1000 x 37, 4099, and 45 (a
# depthwise kernel of 5 channels): numels on and off the kernel's 4-code units.
CODES_RAGGED = [(1,), (17,), (1000, 37), (4099,), (3, 3, 1, 5)]
# bce_sums reads x and y (8 bytes) and does ~20 operations per element.
BCE_OPS_PER_ELEMENT = 20
# The JAX package, its stack and the wire packages it encodes with; the
# port uses grpc alone of them (its transport), so every other one is
# blocked for the run.
REFERENCE_STACK = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "ml_dtypes", "grpc",
                   "google", "fedcrack_tpu")
PORT_NEEDS = ("grpc",)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def matmul_shapes(cfg, size: int, batch: int) -> list[tuple[str, int, int, int]]:
    """(layer, M, K, N) of every dequant_matmul of the fused forward, in
    launch order: the stem, 3 per encoder block, each decoder block's
    residual, the head."""
    shapes = []
    g = -(-size // 2)
    shapes.append(("stem_conv", batch * g * g, 9 * cfg.in_channels, cfg.stem_features))
    cin = cfg.stem_features
    for i, f in enumerate(cfg.encoder_features):
        shapes.append((f"enc{i}_sep1", batch * g * g, cin, f))
        shapes.append((f"enc{i}_sep2", batch * g * g, f, f))
        g = -(-g // 2)
        shapes.append((f"enc{i}_res", batch * g * g, cin, f))
        cin = f
    for i, f in enumerate(cfg.decoder_features):
        shapes.append((f"dec{i}_res", batch * g * g, cin, f))
        cin = f
        if i + 1 < len(cfg.decoder_features):
            g *= 2
    shapes.append(("head", batch * g * g, cin, cfg.num_classes))
    return shapes


def conv_shapes(cfg, size: int, batch: int) -> list[tuple[str, int, int, int, int, int]]:
    """(layer, N, H, W, C, F) of every dequant_conv3x3 of the fused forward:
    each decoder block's convT1 and convT2."""
    g = -(-size // 2)
    for _ in cfg.encoder_features:
        g = -(-g // 2)
    shapes, cin = [], cfg.encoder_features[-1]
    for i, f in enumerate(cfg.decoder_features):
        shapes.append((f"dec{i}_convT1", batch, g, g, cin, f))
        shapes.append((f"dec{i}_convT2", batch, g, g, f, f))
        cin = f
        if i + 1 < len(cfg.decoder_features):
            g *= 2
    return shapes


def depthwise_shapes(cfg) -> list[tuple[int, int, int, int]]:
    """Shape of every depthwise kernel the fused forward expands (two per
    encoder block), in forward order."""
    out, cin = [], cfg.stem_features
    for f in cfg.encoder_features:
        out += [(3, 3, 1, cin), (3, 3, 1, f)]
        cin = f
    return out


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, n: int = 5, launches: int | None = None) -> float:
    """Device time of one pass over ``fns``: every CUDA kernel they launch,
    summed, from torch.profiler (n passes after one warm pass).

    A profile that lost kernel records would read short, so the count of
    kernels seen is checked: against ``launches`` per pass where the caller
    knows it (one per wrapper call), else against a second profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        count = sum(e.count for e in kernels)
        if count and (count == n * launches if launches is not None else count in counts):
            return sum(e.self_device_time_total for e in kernels) / n / 1e3
        counts.append(count)
    raise AssertionError(f"the profiler's kernel counts disagree: {counts} (want {launches} x {n})")


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_against_plain(torch, label: str, kernel, plain, args, scale, part=None) -> tuple[float, float]:
    """The kernel within one per-channel scale + 1e-6 of its plain version
    per entry, bitwise equal run to run and, given ``part`` = (args of a
    launch over the leading rows, those rows), bitwise equal on them.
    Returns the largest |kernel - plain| and |kernel - plain| / scale."""
    y = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = (y - want).abs()
    if not bool((err <= scale + 1e-6).all()):
        raise AssertionError(f"{label} exceeds the per-channel bound: "
                             f"max |kernel - plain| / scale {float((err / scale).max()):.3g}")
    if not torch.equal(y, again):
        raise AssertionError(f"{label} not deterministic run to run")
    if part is not None:
        part_args, rows = part
        if not torch.equal(kernel(*part_args), y[:rows]):
            raise AssertionError(f"{label}: the leading rows change with the launch's M")
    if not err.numel():
        return 0.0, 0.0
    return float(err.max()), float((err / scale).max())


def time_cases(torch, card: str, name: str, kernel, plain, library: str, cases) -> dict:
    """Times of one forward's launches of a dequant kernel. Per shape, CUDA
    events over back-to-back calls (host-inclusive: at tens of microseconds
    they time the wrapper as much as the kernel); per forward, device time
    from the profiler for the kernel, its plain version and the library
    call. Each case: (layer, shape text, args, library closure, bytes,
    operations)."""
    row = {"event_ms": 0.0, "plain_event_ms": 0.0, "library_event_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "fp32_bound_ms": 0.0}
    for layer, shape, args, lib, n_bytes, n_flops in cases:
        t_k = cuda_ms(torch, lambda: kernel(*args))
        t_p = cuda_ms(torch, lambda: plain(*args))
        t_l = cuda_ms(torch, lib)
        b_ms, b_by = bound_ms(n_bytes, BF16_PASSES * n_flops, BF16_TC_FLOPS_PER_S)
        f_ms, _ = bound_ms(n_bytes, n_flops)
        row["event_ms"] += t_k
        row["plain_event_ms"] += t_p
        row["library_event_ms"] += t_l
        row["bound_ms"] += b_ms
        row["fp32_bound_ms"] += f_ms
        row["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
        row["ops_ms"] += BF16_PASSES * n_flops / BF16_TC_FLOPS_PER_S * 1e3
        log(f"{name} {layer} {shape}: events kernel {t_k:.4f} ms, plain {t_p:.4f} ms, {library} {t_l:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}), f32-FMA bound {f_ms:.4f} ms [{card}]")
    row["ms"] = device_ms(torch, [lambda a=args: kernel(*a) for _, _, args, _, _, _ in cases],
                          launches=len(cases))
    row["plain_ms"] = device_ms(torch, [lambda a=args: plain(*a) for _, _, args, _, _, _ in cases])
    row["library_ms"] = device_ms(torch, [lib for _, _, _, lib, _, _ in cases])
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
    log(f"{name} one forward ({len(cases)} launches), device time: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, {library} {row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; bytes {row['bytes_ms']:.4f}, bf16 x{BF16_PASSES} {row['ops_ms']:.4f}), "
        f"f32-FMA bound {row['fp32_bound_ms']:.4f} ms; CUDA events: kernel {row['event_ms']:.4f} ms, "
        f"plain {row['plain_event_ms']:.4f} ms, {library} {row['library_event_ms']:.4f} ms [{card}]")
    return row


def kernel_phase(torch, card: str) -> dict:
    """Phase 3: each dequant kernel against its plain version on the card,
    at the fused forward's shapes (bucket 256 x batch 8) and ragged sweeps."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.serve.quant import QKEY, QKEY_FP8, SKEY, quantize_leaf, quantize_leaf_fp8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = ModelConfig()
    rows = {}
    for flavor, leaf_fn, key in (("int8", quantize_leaf, QKEY), ("e4m3", quantize_leaf_fp8, QKEY_FP8)):
        def codes(shape):
            leaf = leaf_fn((torch.randn(shape, generator=gen, device=dev) * 0.1).cpu().numpy())
            return leaf[key].to(dev), leaf[SKEY].to(dev)

        # dequant_matmul: the 15 GEMMs of a forward, then the ragged sweep.
        name = f"dequant_matmul[{flavor}]"
        cases, errs = [], [0.0, 0.0]
        main = matmul_shapes(cfg, BUCKET, BATCH)
        for layer, m, k, n in main + [(f"sweep{s}", *s) for s in MATMUL_SWEEP]:
            x = torch.randn((m, k), generator=gen, device=dev)
            q, s = codes((k, n))
            rows_part = m // 3 + 1
            err = check_against_plain(torch, f"{name} {layer}", dequant.dequant_matmul,
                                      dequant._dequant_matmul_plain, (x, q, s), s,
                                      ((x[:rows_part].contiguous(), q, s), rows_part))
            errs = [max(a, b) for a, b in zip(errs, err)]
            if not layer.startswith("sweep"):
                wd = q.float() * s
                cases.append((layer, f"M={m} K={k} N={n}", (x, q, s), lambda x=x, wd=wd: torch.matmul(x, wd),
                              4 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n))
        log(f"{name}: {len(main)} main-path GEMMs and {len(MATMUL_SWEEP)} ragged within the per-channel bound, "
            f"bitwise repeatable; max |kernel - plain| {errs[0]:.3g}, max |kernel - plain| / scale {errs[1]:.3g}")
        rows[name] = time_cases(torch, card, name, dequant.dequant_matmul, dequant._dequant_matmul_plain,
                                "torch.matmul", cases)
        rows[name].update(max_abs_err=errs[0], max_err_over_scale=errs[1])

        # dequant_conv3x3: the 8 decoder convs of a forward, then the ragged sweep.
        name = f"dequant_conv3x3[{flavor}]"
        cases, errs = [], [0.0, 0.0]
        main = conv_shapes(cfg, BUCKET, BATCH)
        for layer, n_img, h, w, c, f in main + [(f"sweep{s}", *s) for s in CONV_SWEEP]:
            x = torch.randn((n_img, h, w, c), generator=gen, device=dev)
            q, s = codes((3, 3, c, f))
            part = ((x[:1].contiguous(), q, s), 1) if n_img > 1 else None
            err = check_against_plain(torch, f"{name} {layer}", dequant.dequant_conv3x3,
                                      dequant._dequant_conv3x3_plain, (x, q, s), s, part)
            errs = [max(a, b) for a, b in zip(errs, err)]
            if not layer.startswith("sweep"):
                # cuDNN on the channels-last view of the same NHWC tensor, f32 weights expanded once.
                w_oihw = (q.float() * s).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                x_nchw = x.permute(0, 3, 1, 2)
                pixels = n_img * h * w
                cases.append((layer, f"N={n_img} H={h} W={w} C={c} F={f}", (x, q, s),
                              lambda x_nchw=x_nchw, w_oihw=w_oihw: F.conv2d(x_nchw, w_oihw, padding=1),
                              4 * pixels * c + 9 * c * f + 4 * f + 4 * pixels * f, 2 * pixels * 9 * c * f))
        log(f"{name}: {len(main)} main-path convs and {len(CONV_SWEEP)} ragged within the per-channel bound, "
            f"bitwise repeatable; max |kernel - plain| {errs[0]:.3g}, max |kernel - plain| / scale {errs[1]:.3g}")
        rows[name] = time_cases(torch, card, name, dequant.dequant_conv3x3, dequant._dequant_conv3x3_plain,
                                "F.conv2d(channels_last)", cases)
        rows[name].update(max_abs_err=errs[0], max_err_over_scale=errs[1])

        # dequant_codes: bitwise, grouped as the forward calls it.
        name = f"dequant_codes[{flavor}]"
        rows[name] = codes_case(torch, card, name, flavor, codes, cfg)
    return rows


def codes_case(torch, card: str, name: str, flavor: str, codes, cfg) -> dict:
    """``dequant_codes_group`` bitwise against its plain version: the six
    depthwise leaves of ``cfg`` in one call (from a prepared ``CodeGroup``,
    as the served forward calls it), a ragged group, a group with a
    misaligned leaf, and one leaf at a time; every call twice. Times per
    forward: the kernel's one launch (profiler, launch count checked) and
    CUDA events, beside the plain version's and 6 x ``torch.mul``'s on both
    clocks; the same leaves as 6 one-leaf calls and as a group validated
    per call, on CUDA events."""
    from fedcrack_tpu_torch.kernels import dequant

    leaves = [codes(shape) for shape in depthwise_shapes(cfg)]
    ragged = [codes(shape) for shape in CODES_RAGGED]
    # A leaf that starts one byte into its storage: its 32-bit code loads
    # would be misaligned, so every unit of it takes the scalar path.
    q, s = codes((1000, 37))
    buf = torch.zeros(q.numel() + 1, dtype=torch.uint8, device=q.device)
    buf[1:] = q.view(torch.uint8).flatten()
    misaligned = [ragged[0], (buf[1:].view(q.dtype).view(q.shape), s), ragged[-1]]
    group = dequant.CodeGroup(leaves)
    calls = [("depthwise (prepared)", lambda: dequant.dequant_codes_group(group), leaves)]
    calls += [(label, lambda pairs=pairs: dequant.dequant_codes_group(pairs), pairs)
              for label, pairs in (("depthwise", leaves), ("ragged", ragged), ("misaligned", misaligned))]
    calls += [(f"one leaf {tuple(q.shape)}", lambda q=q, s=s: [dequant.dequant_codes(q, s)], [(q, s)])
              for q, s in leaves + ragged]
    for label, call, pairs in calls:
        got = call()
        again = call()
        torch.cuda.synchronize()
        for (q, s), out, out2 in zip(pairs, got, again):
            if out.data_ptr() % 16:
                raise AssertionError(f"{name} {label}: slice of {tuple(q.shape)} not 16-byte aligned")
            if not (torch.equal(out, dequant._dequant_codes_plain(q, s)) and torch.equal(out, out2)):
                raise AssertionError(f"{name} {label}: {tuple(q.shape)} differs from its plain version")
    log(f"{name}: {len(calls)} groups (6 depthwise leaves, ragged numels {[q.numel() for q, _ in ragged]}, a "
        f"misaligned leaf, one-leaf calls) bitwise equal to the plain version, twice")

    numel = sum(q.numel() for q, _ in leaves)
    n_bytes = numel + sum(4 * s.numel() for _, s in leaves) + 4 * numel
    row = {"max_abs_err": 0.0, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
           "ops_ms": numel / FP32_FLOPS_PER_S * 1e3}
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, numel)

    def plain():
        return [dequant._dequant_codes_plain(q, s) for q, s in leaves]

    def library():
        return [torch.mul(q, s) for q, s in leaves]

    row["ms"] = device_ms(torch, [lambda: dequant.dequant_codes_group(group)], launches=1)
    row["plain_ms"] = device_ms(torch, [plain])
    row["event_ms"] = cuda_ms(torch, lambda: dequant.dequant_codes_group(group))
    row["plain_event_ms"] = cuda_ms(torch, plain)
    row["six_calls_event_ms"] = cuda_ms(torch, lambda: [dequant.dequant_codes(q, s) for q, s in leaves])
    row["unprepared_event_ms"] = cuda_ms(torch, lambda: dequant.dequant_codes_group(leaves))
    # torch.mul has no fp8 kernel, so the e4m3 row has no library call.
    row["library_ms"] = device_ms(torch, [library]) if flavor == "int8" else None
    row["library_event_ms"] = cuda_ms(torch, library) if flavor == "int8" else None
    log(f"{name} one forward (1 launch, {len(leaves)} leaves, {numel} codes), device time: kernel "
        f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, 6 x torch.mul {row['library_ms']}; "
        f"bound {row['bound_ms']:.7f} ms ({row['bound_by']}); CUDA events: kernel {row['event_ms']:.6f} ms, "
        f"plain {row['plain_event_ms']:.6f} ms, 6 x torch.mul {row['library_event_ms']}, "
        f"6 one-leaf calls {row['six_calls_event_ms']:.6f} ms, group validated per call "
        f"{row['unprepared_event_ms']:.6f} ms [{card}]")
    return row


def serve_phase(torch, card: str, kernel_plane: str, requests: bool) -> dict:
    """Phases 4 and 5: the quantized serving path through its entry points."""
    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    cfg = ModelConfig()
    sc = ServeConfig(quant="int8", kernel_plane=kernel_plane)
    engine = InferenceEngine(cfg, sc)
    raw = init_variables(torch.Generator().manual_seed(0), cfg)
    # Glorot-random weights at full width are chaotic: a perturbation the
    # size of int8 rounding flips about a fifth of the probe-mask pixels, and
    # the gate rightly refuses them (installed below; the JAX package's gate
    # refuses the same weights with the same IoU, see
    # tests/test_torch_gate_fullwidth.py). A served model comes out of
    # training; the stand-in is the same seeded weights snapped to the
    # plane's code grid, as a model trained through fake quantization serves.
    # On them quantization is exact, so the gate below measures the fused
    # kernel path against the cuDNN reference program and nothing else.
    host = quant_mod.dequantize_variables(quant_mod.quantize_for_plane(raw, kernel_plane).tree)
    manager = ModelVersionManager(engine, host)
    rng = np.random.default_rng(1)
    per_forward = {"dequant_matmul": len(matmul_shapes(cfg, BUCKET, BATCH)),
                   "dequant_conv3x3": len(conv_shapes(cfg, BUCKET, BATCH)),
                   "dequant_codes": 1}  # the forward's depthwise leaves, grouped

    # ---- the main path, counted ----
    dequant.reset_launch_counts()
    fwd0 = engine.quantized_forwards
    t0 = time.monotonic()
    if not manager.install(1, host):
        raise AssertionError("install of version 1 did not happen")
    gate = manager.last_quant_gate
    log(f"[{kernel_plane}] quant gate: {json.dumps(gate)} (install {time.monotonic() - t0:.3f} s)")
    if not gate["passed"] or set(gate["per_bucket"]) != {"128", "256"}:
        raise AssertionError(f"[{kernel_plane}] quant gate did not pass at both buckets")
    version, payload = manager.snapshot()
    if not isinstance(payload, quant_mod.QuantizedVariables):
        raise AssertionError("the served payload is not the quantized program")
    engine.warmup(payload)
    outputs = []
    with MicroBatcher(engine, manager) as batcher:
        if requests:
            futs = [(256, None, batcher.submit(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)))
                    for _ in range(16)]
            futs += [(128, None, batcher.submit(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)))
                     for _ in range(8)]
            for _ in range(2):  # padded requests: the front door pads into a bucket and crops
                img = rng.integers(0, 256, (200, 180, 3), dtype=np.uint8)
                canvas = np.zeros((256, 256, 3), np.uint8)
                canvas[:200, :180] = img
                futs.append(((200, 180), img, batcher.submit(canvas)))
        else:
            futs = [(256, None, batcher.submit(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)))
                    for _ in range(BATCH)]
        for shape, img, fut in futs:
            res = fut.result(timeout=300)
            if res.model_version != version:
                raise AssertionError("request served from another version")
            probs = res.probs
            if isinstance(shape, tuple):
                probs = probs[: shape[0], : shape[1]]
                direct = engine.predict_image(payload, img)
                if not np.array_equal(probs, direct):
                    raise AssertionError("padded request differs from predict_image")
            outputs.append(probs)
        stats = batcher.stats()
    if requests:
        big = rng.integers(0, 256, (512, 384, 3), dtype=np.uint8)
        tiled = [engine.predict_image(payload, big) for _ in range(2)]
        if tiled[0].tobytes() != tiled[1].tobytes():
            raise AssertionError("tiled output not byte-identical across runs")
        if tiled[0].shape != (512, 384, 1):
            raise AssertionError(f"tiled output shape {tiled[0].shape}")
        outputs += tiled
    torch.cuda.synchronize()
    forwards = engine.quantized_forwards - fwd0
    launches = {name: getattr(dequant, name).launches for name in per_forward}
    log(f"[{kernel_plane}] main path: {forwards} quantized forwards, launches {launches}, "
        f"batcher {json.dumps(stats)}")
    if forwards == 0 or any(launches[name] != n * forwards for name, n in per_forward.items()):
        raise AssertionError(f"launch counts {launches} != {per_forward} per forward x {forwards}")
    for out in outputs:
        if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
            raise AssertionError("served probabilities not finite in [0, 1]")
        if out.ndim != 3 or out.shape[-1] != 1:
            raise AssertionError(f"served output shape {out.shape}")

    # ---- checks and timings after the counted run ----
    ref_engine = InferenceEngine(cfg, ServeConfig(quant="int8", kernel_plane="reference"))
    qtree = quant_mod.quantize_for_plane(host, kernel_plane)
    oracle = ref_engine.prepare_quantized(qtree)
    probe = quant_mod.probe_images(BUCKET, sc.quant_probe_batch, sc.quant_probe_seed)
    fused = engine.predict_bucket(payload, probe)
    want = ref_engine.predict_bucket(oracle, probe)
    diff = float(np.max(np.abs(fused.astype(np.float64) - want.astype(np.float64))))
    iou = quant_mod.mask_iou(fused, want)
    log(f"[{kernel_plane}] fused vs reference plane (dequantize + ResUNet) on the probe batch: "
        f"max prob diff {diff:.3g}, mask IoU {iou:.6f}")
    if diff >= SERVE_PROB_TOL or iou < 0.99:
        raise AssertionError(f"[{kernel_plane}] fused plane disagrees with the reference plane")

    # The raw random weights through the same install: whatever the gate
    # decides, the served program must be the one it chose.
    manager.install(2, raw)
    gate_raw = manager.last_quant_gate
    log(f"[{kernel_plane}] quant gate on the raw random weights: {json.dumps(gate_raw)}")
    _, served = manager.snapshot()
    if gate_raw["passed"] != isinstance(served, quant_mod.QuantizedVariables):
        raise AssertionError("served program does not follow the gate's verdict")
    if not gate_raw["passed"]:
        got = engine.predict_bucket(served, probe)
        if not np.array_equal(got, engine.predict_bucket(engine.prepare(raw), probe)):
            raise AssertionError("refused install does not serve the reference program exactly")

    perf = {}
    reference = engine.prepare(host)
    for size in sc.bucket_sizes:
        batch = rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
        for name, weights in (("fused", payload), ("reference", reference)):
            engine.predict_bucket(weights, batch)
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                engine.predict_bucket(weights, batch)  # returns host numpy: synchronized
                lat.append((time.perf_counter() - t0) * 1e3)
            p50, p95 = np.percentile(lat, [50, 95])
            perf[f"{name}_{size}"] = {"img_per_s": BATCH * 1e3 / float(np.mean(lat)),
                                      "p50_ms": float(p50), "p95_ms": float(p95)}
            log(f"[{kernel_plane}] {name} program bucket {size} batch {BATCH}: "
                f"{perf[f'{name}_{size}']['img_per_s']:.1f} img/s, batch latency p50 {p50:.3f} ms "
                f"p95 {p95:.3f} ms [{card}]")
    if requests:
        profile_batches(torch, engine, payload, rng.integers(0, 256, (BATCH, BUCKET, BUCKET, 3),
                                                             dtype=np.uint8), card)
    return {"launches": launches, "forwards": forwards, "perf": perf}


def profile_batches(torch, engine, weights, batch, card: str, n: int = 5) -> None:
    """Where one bucket-256 batch's time goes: CUDA kernel time by name and
    the device's idle share of the host-clock window (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.predict_bucket(weights, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.predict_bucket(weights, batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log("profile: the profiler saw no CUDA kernels; device time not measured")
        return
    log(f"profile: {n} fused batches (bucket {BUCKET}, batch {BATCH}) in {wall_us / n / 1e3:.3f} ms "
        f"each on the host clock, device busy {busy_us / n / 1e3:.3f} ms each, "
        f"idle share {1 - busy_us / wall_us:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile: {e.self_device_time_total / n / 1e3:8.4f} ms/batch "
            f"{e.count // n:4d} calls/batch  {e.key[:110]}")


def bce_phase(torch, card: str) -> dict:
    """Phase 6: ``bce_sums`` against its plain version on the card: at the
    train step's logits, at 8 x 256 x 256 and over a ragged sweep; calls at
    alternating sizes back to back (the ticket's reset), and on two streams
    at once (one workspace each); one kernel per call by the profiler."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.ops import bce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [("train_step", (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 1)), ("256px", (8, 256, 256, 1))]
    cases += [(f"n={n}", (n,)) for n in BCE_SWEEP]
    row, inputs, single = {"max_abs_err": 0.0}, {}, {}
    for label, shape in cases:
        x = torch.randn(shape, generator=gen, device=dev) * 2.0
        y = (torch.rand(shape, generator=gen, device=dev) > 0.7).to(torch.float32)
        inputs[label] = (x, y)
        got = single[label] = bce.bce_sums(x, y)
        torch.cuda.synchronize()
        again = bce.bce_sums(x, y)
        plain = bce._bce_sums_plain(x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"bce_sums {label}: not bitwise equal run to run")
        if not torch.equal(got[1:4], plain[1:4]):
            raise AssertionError(f"bce_sums {label}: count lanes {got[1:4].tolist()} != {plain[1:4].tolist()}")
        err = (got - plain).abs()
        if not bool((err <= 1e-3 + 1e-5 * plain.abs()).all()):
            raise AssertionError(f"bce_sums {label}: BCE lanes {got.tolist()} vs plain {plain.tolist()}")
        row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))

    # Back to back at alternating sizes (grids of 1 to 256 blocks), no
    # synchronisation between calls: each must equal the same call made alone.
    order = [label for _ in range(3) for label, _ in cases]
    outs = [bce.bce_sums(*inputs[label]) for label in order]
    torch.cuda.synchronize()
    for label, out in zip(order, outs):
        if not torch.equal(out, single[label]):
            raise AssertionError(f"bce_sums {label}: back-to-back call differs from the single call")
    # Two streams at once, each with its own workspace.
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pairs = [("train_step", "256px"), ("n=100000", "n=32769")]
    results = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(10):
        for s, labels in zip(streams, pairs):
            with torch.cuda.stream(s):
                results += [(label, bce.bce_sums(*inputs[label])) for label in labels]
    torch.cuda.synchronize()
    for label, out in results:
        if not torch.equal(out, single[label]):
            raise AssertionError(f"bce_sums {label}: a call on a second stream differs from the single call")
    log(f"bce_sums: {len(cases)} shapes within rtol 1e-5 / atol 1e-3 of plain (count lanes equal), bitwise "
        f"repeatable, {len(order)} back-to-back calls at alternating sizes and {len(results)} calls on two "
        f"streams bitwise equal to single calls; max |kernel - plain| {row['max_abs_err']:.3g}")

    for label in ("train_step", "256px"):
        x, y = inputs[label]
        n = x.numel()
        kernels = kernel_device_us(torch, lambda: bce.bce_sums(x, y))
        names = list(kernels)
        if len(names) != 1 or "bce_sums_kernel" not in names[0] or kernels[names[0]][1] != 1:
            raise AssertionError(f"bce_sums {label}: want one bce_sums_kernel per call, the profiler saw {kernels}")
        us = kernels[names[0]][0]

        def library():
            return F.binary_cross_entropy_with_logits(x, y, reduction="sum")

        case = {"ms": us / 1e3,
                "plain_ms": device_ms(torch, [lambda: bce._bce_sums_plain(x, y)]),
                "library_ms": device_ms(torch, [library]),
                "event_ms": cuda_ms(torch, lambda: bce.bce_sums(x, y), iters=50),
                "plain_event_ms": cuda_ms(torch, lambda: bce._bce_sums_plain(x, y), iters=50),
                "library_event_ms": cuda_ms(torch, library, iters=50)}
        case["bound_ms"], case["bound_by"] = bound_ms(8 * n + 4 * 5, BCE_OPS_PER_ELEMENT * n)
        log(f"bce_sums {label} {tuple(x.shape)} (n={n}), one kernel per call: device time kernel "
            f"{case['ms']:.6f} ms, plain {case['plain_ms']:.6f} ms, F.binary_cross_entropy_with_logits "
            f"(lane 0 only) {case['library_ms']:.6f} ms; CUDA events kernel {case['event_ms']:.6f} ms, plain "
            f"{case['plain_event_ms']:.6f} ms, library {case['library_event_ms']:.6f} ms; bound "
            f"{case['bound_ms']:.6f} ms ({case['bound_by']}) [{card}]")
        if label == "train_step":
            row.update(case)
    return row


def kernel_device_us(torch, fn, n: int = 20) -> dict[str, tuple[float, float]]:
    """Per CUDA kernel that ``fn`` launches: device time per call (us) and
    launches per call, from torch.profiler. A profile that lost kernel
    records would read short, so a profile whose launch counts are not
    whole multiples of ``n`` is taken again (up to three times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        out = {e.key: (e.self_device_time_total / n, e.count / n) for e in kernels}
        if out and all(e.count % n == 0 for e in kernels):
            return out
        seen.append(out)
    raise AssertionError(f"the profiler's kernel counts are not whole per call: {seen}")


def _flat_tree(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_tree(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _bn_fed_bias(name: str) -> bool:
    """Biases of the convs that feed a train-mode BatchNorm: the batch mean
    subtracts them again, so their true gradient is exactly 0."""
    return name.endswith(".bias") and (
        name.startswith("stem_conv.") or ".pointwise." in name
        or "_convT1." in name or "_convT2." in name)


def check_one_step(torch, start_tree, one_step, lr: float) -> None:
    """One train step from the same weights and batch on the card (cuDNN)
    and on the CPU (oneDNN, the plain BCE version). Tolerances and why:

    - loss: one float32 reduction over 262,144 pixels after two conv
      stacks that sum in other orders: 1e-4 relative;
    - gradients: per leaf within 5e-3 of the leaf's largest gradient (the
      conv algorithms' other summation orders, then the BatchNorm backward
      subtracts two means of 65,536 terms); a bias feeding a train-mode
      BatchNorm has a true gradient of 0, so there both sides stay at
      noise, below 1e-4 of the largest gradient of the net;
    - parameters: Adam's first step is lr*g/(|g| + 1e-7), so where the two
      gradients agree in sign and both exceed 2e-5 the steps differ by at
      most lr*1e-7/2e-5 = 5e-3*lr; held to 1e-2*lr there. Elsewhere (sign
      flips of noise-level gradients, the BatchNorm-fed biases) each side
      moves at most lr (plus float32 rounding of the sum, 1e-3*lr), so the
      two stay within 2*lr;
    - running statistics: 0.99 * carried + 0.01 * batch moments, within
      1e-5 + 0.01*lr."""
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict

    (loss_card, card), (loss_cpu, cpu) = one_step["cuda"], one_step["cpu"]
    start = flax_to_state_dict(start_tree)
    cpu_params = dict(cpu.named_parameters())
    grads = {k: (p.grad.detach().cpu(), cpu_params[k].grad) for k, p in card.named_parameters()}
    g_max = max(float(g.abs().max()) for _, g in grads.values())
    worst = {"loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu), "grad_rel": 0.0,
             "bn_fed_bias_grad_rel": 0.0, "params_signed": 0.0, "params_flipped": 0.0,
             "flipped_elements": 0, "elements": 0, "batch_stats": 0.0}
    for name, p in card.named_parameters():
        g_card, g_cpu = grads[name]
        got, want = p.detach().cpu(), cpu_params[name].detach()
        if _bn_fed_bias(name):
            worst["bn_fed_bias_grad_rel"] = max(worst["bn_fed_bias_grad_rel"],
                                                float(torch.maximum(g_card.abs(), g_cpu.abs()).max()) / g_max)
        else:
            worst["grad_rel"] = max(worst["grad_rel"],
                                    float((g_card - g_cpu).abs().max()) / float(g_cpu.abs().max()))
        signed = (torch.sign(g_card) == torch.sign(g_cpu)) & (g_card.abs() > 2e-5) & (g_cpu.abs() > 2e-5)
        diff = (got - want).abs()
        worst["elements"] += diff.numel()
        if signed.any():
            worst["params_signed"] = max(worst["params_signed"], float(diff[signed].max()))
        if (~signed).any():
            flipped = float(diff[~signed].max())
            if flipped > worst["params_flipped"]:
                i = int(torch.where(~signed, diff, -1.0).argmax())
                worst["worst_flip"] = {"param": name, "g_card": float(g_card.flatten()[i]),
                                       "g_cpu": float(g_cpu.flatten()[i]),
                                       "leaf_max_g": float(g_cpu.abs().max())}
            worst["params_flipped"] = max(worst["params_flipped"], flipped)
            worst["flipped_elements"] += int((diff[~signed] > 1e-2 * lr).sum())
        for side in (got, want):
            if float((side - start[name]).abs().max()) > lr * (1 + 1e-3):
                raise AssertionError(f"{name}: moved more than Adam's one-step bound lr")
    cpu_buffers = dict(cpu.named_buffers())
    for name, buf in card.named_buffers():
        worst["batch_stats"] = max(worst["batch_stats"], float((buf.cpu() - cpu_buffers[name]).abs().max()))
    log(f"[train] card vs CPU, one step: loss {loss_card:.7f} vs {loss_cpu:.7f}; {json.dumps(worst)}")
    if worst["loss_rel"] > 1e-4 or worst["grad_rel"] > 5e-3 or worst["bn_fed_bias_grad_rel"] > 1e-4 \
            or worst["params_signed"] > 1e-2 * lr or worst["params_flipped"] > 2 * lr * (1 + 1e-3) \
            or worst["batch_stats"] > 1e-5 + 0.01 * lr:
        raise AssertionError(f"card and CPU disagree on one train step: {worst}")


def _first_leaf_nan(ser, blob: bytes, template, wire_dtype: str) -> bytes:
    """``blob`` with a NaN in its first leaf (sorted key order), re-encoded
    with the round's wire cast: a poisoned client's upload."""
    tree = ser.tree_from_bytes(blob, template=template)
    _, leaf = next(_flat_tree(tree))
    leaf.flat[0] = float("nan")
    return ser.tree_to_bytes(tree, cast_dtype="bfloat16" if wire_dtype == "bfloat16" else None)


def drive_federation(R, ser, config, global_vars, fit, names, poison=(), on_round=None) -> dict:
    """One sync federation through ``R.transition``, as a transport feeds
    it: the clients ``names`` enroll, then each round every client pulls
    the global, notifies, fits (``fit(name, blob, round, config_map) ->
    (blob, n_samples)``), uploads and polls, under a synthetic clock, until
    FIN. A client in ``poison`` uploads its fit with a NaN in its first
    leaf. A round still short of its quorum after every upload is closed
    by a ``Tick`` at its deadline. ``R``/``ser`` are a rounds module and its
    serialization (the port's here; the CPU tests pass the JAX package's
    too). ``on_round(round, broadcast_blob)`` runs after each close.

    Returns the statuses ``(client, event, status)``, the final state, and
    per round: its base and broadcast blobs, the uploads, the host ms of
    the transition that closed it (decode, ledger, fold, FedOpt and
    encode) and of all its transitions, and its wall seconds."""
    state = R.initial_state(config, global_vars)
    now = 0.0
    statuses = []
    server_ms = [0.0]

    def send(name, event):
        nonlocal state
        t0 = time.perf_counter()
        state, reply = R.transition(state, event)
        ms = (time.perf_counter() - t0) * 1e3
        server_ms[0] += ms
        statuses.append((name, type(event).__name__, reply.status))
        return reply, ms

    for name in names:
        send(name, R.Ready(name, now=now))
        now += 1.0
    rounds = []
    while state.phase != R.PHASE_FINISHED:
        rnd, version = state.current_round, state.model_version
        base = state.broadcast_blob
        t_round = time.perf_counter()
        server_ms[0] = 0.0
        closed, uploads = None, {}
        for name in names:
            pull, _ = send(name, R.PullWeights(name, now=now))
            send(name, R.TrainingNotice(name, now=now))
            blob, n_samples = fit(name, pull.blob, rnd, dict(pull.config))
            if name in poison:
                blob = _first_leaf_nan(ser, blob, state.template, pull.config["wire_dtype"])
            uploads[name] = (blob, n_samples)
            reply, ms = send(name, R.TrainDone(name, round=rnd, blob=blob, num_samples=n_samples, now=now))
            now += 1.0
            if reply.status in (R.RESP_ARY, R.FIN):
                closed = ms
        if closed is None:
            if config.round_deadline_s <= 0 or state.phase != R.PHASE_RUNNING:
                raise AssertionError(f"round {rnd} did not close: {statuses[-3:]}")
            now = state.round_started_at + config.round_deadline_s
            _, closed = send("server", R.Tick(now=now))
            if state.model_version != version + 1:
                raise AssertionError(f"round {rnd}: the deadline did not close it")
        wall = time.perf_counter() - t_round
        if on_round is not None:
            on_round(rnd, state.broadcast_blob)
        rounds.append({"round": rnd, "blob": state.broadcast_blob, "base": base, "uploads": uploads,
                       "close_ms": closed, "server_ms": server_ms[0], "wall_s": wall})
        for name in names:
            send(name, R.VersionPoll(name, model_version=version, round=rnd, now=now))
    return {"statuses": statuses, "state": state, "rounds": rounds}


def federation_setup(torch) -> dict:
    """Phase 7's federation, shared by phases 9 and 10: ``ModelConfig()``
    at 128 px, batch 16, two clients of 64 seeded synthetic samples and 32
    held out, the seeded global, ``FedConfig(max_rounds=2, cohort_size=2,
    local_epochs=1)``, ``client_fn(i, name)`` (a fresh ``make_train_fn``
    on the card, seed ``i``) and an evaluator state."""
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.train import local
    from fedcrack_tpu_torch.train.federated import make_train_fn

    cfg = FedConfig(model=ModelConfig(), data=DataConfig(img_size=TRAIN_SIZE, batch_size=TRAIN_BATCH))
    imgs, msks = synth_crack_batch(160, TRAIN_SIZE, seed=0)
    shards = {"client_0": slice(0, 64), "client_1": slice(64, 128)}

    def client_fn(i, name):
        data = ArrayDataset(imgs[shards[name]], msks[shards[name]], batch_size=TRAIN_BATCH, seed=i)
        return make_train_fn(cfg, data, TRAIN_BATCH, seed=i)[0]

    return {
        "cfg": cfg, "server_cfg": FedConfig(max_rounds=2, cohort_size=2, local_epochs=1),
        "imgs": imgs, "msks": msks,
        "held": ArrayDataset(imgs[128:], msks[128:], batch_size=TRAIN_BATCH, shuffle=False),
        "global0": init_variables(torch.Generator().manual_seed(0), cfg.model),
        "names": sorted(shards), "client_fn": client_fn,
        "evaluator": local.create_train_state(torch.Generator().manual_seed(0), cfg.model, cfg.learning_rate),
    }


def train_phase(torch, card: str) -> dict:
    """Phase 7: the federation at full width through the round protocol,
    held bitwise against a tree-level loop over the same clients."""
    import numpy as np

    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.train import local

    fs = federation_setup(torch)
    cfg, server_cfg, imgs, msks, held, global0, names, client_fn, evaluator = (
        fs[k] for k in ("cfg", "server_cfg", "imgs", "msks", "held", "global0", "names", "client_fn",
                        "evaluator"))
    lr = cfg.learning_rate

    # ---- the reference: the tree-level loop over a second set of clients ----
    ref_clients = {name: client_fn(i, name) for i, name in enumerate(names)}
    tree, ref_globals = global0, []
    for rnd in (1, 2):
        triples = []
        for name in names:
            blob, n_samples, _ = ref_clients[name](serialization.tree_to_bytes(tree), rnd, {"local_epochs": 1})
            triples.append((name, n_samples, serialization.tree_from_bytes(blob, template=global0)))
        tree = fold(FedAvg(), triples)
        ref_globals.append(tree)

    # ---- the main path, counted: the federation through the protocol ----
    clients = {name: client_fn(i, name) for i, name in enumerate(names)}
    counts = {"steps": 0, "eval_batches": 0}
    history = []
    previous = [serialization.tree_to_bytes(global0)]

    def fit(name, blob, rnd, hparams):
        out, n_samples, metrics = clients[name](blob, rnd, hparams)
        counts["steps"] += n_samples // TRAIN_BATCH
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"round {rnd} {name}: non-finite train metrics {metrics}")
        history.append({"round": rnd, "client": name, "train": metrics})
        return out, n_samples

    def on_round(rnd, blob):
        if blob == previous[-1]:
            raise AssertionError(f"round {rnd}: the global did not change")
        previous.append(blob)
        new_global = serialization.tree_from_bytes(blob, template=global0)
        for _, leaf in _flat_tree(new_global):
            if not np.isfinite(leaf).all():
                raise AssertionError(f"round {rnd}: non-finite global weights")
        ev = local.evaluate(evaluator.replace_variables(new_global), held)
        counts["eval_batches"] += ev["num_batches"]
        if not all(np.isfinite(v) for v in ev.values()):
            raise AssertionError(f"round {rnd}: non-finite eval metrics {ev}")
        history.append({"round": rnd, "eval": ev})
        log(f"[train] round {rnd}: last client's train {json.dumps(history[-2]['train'])}; "
            f"global eval {json.dumps(ev)}")

    bce.reset_launch_counts()
    t0 = time.monotonic()
    run = drive_federation(rounds, serialization, server_cfg, global0, fit, names, on_round=on_round)
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    steps, eval_batches = counts["steps"], counts["eval_batches"]
    log(f"[train] main path: 2 rounds x 2 clients through fed.rounds.transition, {steps} train steps + "
        f"{eval_batches} eval batches in {time.monotonic() - t0:.2f} s, bce_sums launches {launches}")
    if launches != steps + eval_batches or steps != 16:
        raise AssertionError(f"bce_sums launches {launches} != {steps} steps + {eval_batches} eval batches")
    want = [(n, "Ready", rounds.SW) for n in names]
    for last in (rounds.RESP_ARY, rounds.FIN):
        for n, status in zip(names, (rounds.RESP_ACY, last)):
            want += [(n, "PullWeights", "OK"), (n, "TrainingNotice", "OK"), (n, "TrainDone", status)]
        want += [(n, "VersionPoll", rounds.NOT_WAIT if last == rounds.RESP_ARY else rounds.FIN) for n in names]
    if run["statuses"] != want:
        raise AssertionError(f"protocol statuses {run['statuses']} != {want}")
    state = run["state"]
    if [(h["round"], h["clients"], h["samples"], h["rejected"], h["quarantined"]) for h in state.history] \
            != [(r, names, [64, 64], {}, {}) for r in (1, 2)]:
        raise AssertionError(f"history {state.history}")
    for r, ref in zip(run["rounds"], ref_globals):
        if r["blob"] != serialization.tree_to_bytes(ref):
            raise AssertionError(f"round {r['round']}: the broadcast blob differs from the tree-level loop's global")
        if state.history[r["round"] - 1]["bytes_broadcast"] != len(r["blob"]):
            raise AssertionError(f"round {r['round']}: bytes_broadcast {state.history[r['round'] - 1]}")
    log("[train] each round's broadcast blob is bitwise the tree-level loop's global; statuses and history as expected")
    blob_stats = blob_timings(serialization, ref_globals[-1], global0)
    fed = {"blob_bytes": len(run["rounds"][-1]["blob"]), **blob_stats,
           "close_transition_ms": [r["close_ms"] for r in run["rounds"]],
           "server_ms": [r["server_ms"] for r in run["rounds"]],
           "round_wall_s": [r["wall_s"] for r in run["rounds"]]}
    log(f"[train] federation {json.dumps(fed)} [{card}]")
    log(f"[train] server breakdown, round 2 {json.dumps(server_breakdown(server_cfg, global0, run['rounds'][-1]))} "
        f"[{card}]")

    # ---- card vs CPU, one step from the same tree and batch ----
    batch = (imgs[:TRAIN_BATCH], msks[:TRAIN_BATCH])
    one_step = {}
    for device in ("cuda", "cpu"):
        st = local.create_train_state(torch.Generator().manual_seed(0), cfg.model, lr, device=device)
        st.replace_variables(global0)
        st, m = local.train_step(st, batch, local.snapshot_params(st), 0.0, 1.0)
        one_step[device] = (float(m["loss"]), st.model)
    check_one_step(torch, global0, one_step, lr)

    # ---- determinism: two local fits from the same start ----
    start = serialization.tree_to_bytes(global0)
    fits = [client_fn(0, "client_0")(start, 1, {"local_epochs": 1})[0] for _ in range(2)]
    if fits[0] != fits[1]:
        raise AssertionError("two local fits from one start differ")
    log("[train] two local fits from the same start: bitwise equal blobs")

    # ---- throughput and where the time goes ----
    st = local.create_train_state(torch.Generator().manual_seed(0), cfg.model, lr)
    st.replace_variables(global0)
    dev_batch = tuple(torch.from_numpy(a).cuda() for a in batch)
    anchor = local.snapshot_params(st)
    for _ in range(3):
        local.train_step(st, dev_batch, anchor)
    torch.cuda.synchronize()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        local.train_step(st, dev_batch, anchor)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p95 = np.percentile(lat, [50, 95])
    perf = {"img_per_s": TRAIN_BATCH * 1e3 / float(np.mean(lat)), "p50_ms": float(p50), "p95_ms": float(p95)}
    log(f"[train] train_step ModelConfig() {TRAIN_SIZE} px batch {TRAIN_BATCH}: {perf['img_per_s']:.1f} img/s, "
        f"step p50 {p50:.3f} ms p95 {p95:.3f} ms over 20 steps [{card}]")
    profile_steps(torch, lambda: local.train_step(st, dev_batch, anchor), card)
    return {"launches": launches, "steps": steps, "eval_batches": eval_batches, "perf": perf,
            "history": history, "fed": fed, "globals": [r["blob"] for r in run["rounds"]]}


def blob_timings(ser, tree, template, n: int = 5) -> dict:
    """Host ms (median of ``n``) of ``tree_to_bytes`` and of
    ``tree_from_bytes`` with a template, at float32 and on a bfloat16 wire."""
    import numpy as np

    out = {}
    for wire, cast in (("f32", None), ("bf16", "bfloat16")):
        enc, dec = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            blob = ser.tree_to_bytes(tree, cast_dtype=cast)
            t1 = time.perf_counter()
            ser.tree_from_bytes(blob, template=template)
            dec.append((time.perf_counter() - t1) * 1e3)
            enc.append((t1 - t0) * 1e3)
        out[f"{wire}_bytes"] = len(blob)
        out[f"{wire}_encode_ms"] = float(np.median(enc))
        out[f"{wire}_decode_ms"] = float(np.median(dec))
    return out


def robust_round_phase(torch, card: str) -> dict:
    """Phase 8: one round at full width through the protocol with a
    bfloat16 wire, the trimmed mean, FedAdam and a round deadline; the
    third of three clients uploads a NaN leaf, is rejected, and the
    deadline closes the round on the other two."""
    import numpy as np

    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.train.federated import make_train_fn

    cfg = FedConfig(model=ModelConfig(), data=DataConfig(img_size=TRAIN_SIZE, batch_size=TRAIN_BATCH))
    server_cfg = robust_round_config()
    imgs, msks = synth_crack_batch(96, TRAIN_SIZE, seed=1)
    names = [f"client_{i}" for i in range(3)]
    global0 = init_variables(torch.Generator().manual_seed(1), cfg.model)
    clients = {name: make_train_fn(cfg, ArrayDataset(imgs[32 * i:32 * (i + 1)], msks[32 * i:32 * (i + 1)],
                                                     batch_size=TRAIN_BATCH, seed=i), TRAIN_BATCH, seed=i)[0]
               for i, name in enumerate(names)}
    steps = [0]

    def fit(name, blob, rnd, hparams):
        out, n_samples, _ = clients[name](blob, rnd, hparams)
        steps[0] += n_samples // TRAIN_BATCH
        return out, n_samples

    bce.reset_launch_counts()
    run = drive_federation(rounds, serialization, server_cfg, global0, fit, names, poison=(names[2],))
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    check_robust_round(rounds, run, names)
    state = run["state"]
    final = serialization.tree_from_bytes(state.global_blob, template=global0)
    moved = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(_flat_tree(final["params"]),
                                                                     _flat_tree(global0["params"])))
    # FedAdam's first step is lr * 0.1 g / (0.1 |g| + eps) per element: at most lr.
    if not 0 < moved <= server_cfg.server_lr * (1 + 1e-6):
        raise AssertionError(f"FedAdam moved a parameter by {moved}, outside (0, lr]")
    if launches != steps[0] or steps[0] != 6:
        raise AssertionError(f"bce_sums launches {launches} != {steps[0]} train steps")
    r = run["rounds"][0]
    out = {"launches": launches, "steps": steps[0], "blob_bytes": len(state.broadcast_blob),
           "close_ms": r["close_ms"], "server_ms": r["server_ms"], "round_wall_s": r["wall_s"],
           "largest_param_move": moved}
    log(f"[robust] {json.dumps(out)}; history {json.dumps(state.history[0])} [{card}]")
    log(f"[robust] server breakdown {json.dumps(server_breakdown(server_cfg, global0, r))} [{card}]")
    return out


def grpc_federation(torch, fs: dict, server_cfg, eval_fn=None, server_cls=None) -> dict:
    """One federation over loopback gRPC: a ``FedServer`` in a
    ``ServerThread`` (port 0) and one ``FedClient`` thread per client of
    ``fs`` (phase 7's setup), each fitting with ``make_train_fn`` on the
    card. Returns the final state, the sessions, per client the blobs it
    trained on and the uploads it sent (a client subclass records each
    ``TrainDone``), per round the weight bytes the clients received (the
    pulls count to the first round, a reply to a ``TrainDone`` or a poll to
    the round it names), the steps, the server's transition seconds per round,
    and the clients' host seconds summed by kind: each RPC kind (a call
    waits for its reply, so ``done`` holds the server's gate and the
    closing transition) and ``fit``, the local fits. ``server_cls`` replaces
    ``FedServer``."""
    import threading

    from fedcrack_tpu_torch.transport import FedClient, FedServer
    from fedcrack_tpu_torch.transport.service import ServerThread

    trained_on, uploads, steps, client_s, down = {}, [], [0], {}, {}
    lock = threading.Lock()

    def spent(kind, seconds):
        with lock:
            client_s[kind] = client_s.get(kind, 0.0) + seconds

    class RecordingClient(FedClient):
        def _call(self, method, msg):
            if msg.kind == "done":
                with lock:
                    uploads.append((self.cname, msg.msg.round, msg.msg.weights, msg.msg.sample_count))
            t0 = time.perf_counter()
            try:
                rep = super()._call(method, msg)
            finally:
                spent(msg.kind, time.perf_counter() - t0)
            if rep.weights:
                rnd = msg.msg.round if msg.kind in ("done", "poll") else 1
                with lock:
                    down[rnd] = down.get(rnd, 0) + len(rep.weights)
            return rep

    def fit_fn(i, name):
        fit = fs["client_fn"](i, name)

        def train_fn(blob, rnd, hparams):
            t0 = time.perf_counter()
            out, n_samples, metrics = fit(blob, rnd, hparams)
            spent("fit", time.perf_counter() - t0)
            with lock:
                trained_on[(name, rnd)] = blob
                steps[0] += n_samples // TRAIN_BATCH
            return out, n_samples, metrics

        return train_fn

    server = (server_cls or FedServer)(server_cfg, fs["global0"], tick_period_s=0.05, eval_fn=eval_fn)
    results, errors = {}, []
    with ServerThread(server) as st:
        clients = [RecordingClient(server_cfg, fit_fn(i, name), cname=name, port=st.port)
                   for i, name in enumerate(fs["names"])]

        def run(c):
            try:
                results[c.cname] = c.run_session()
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"a gRPC client failed or hung: {errors}")
        state = st.state
    torch.cuda.synchronize()
    return {"state": state, "results": results, "trained_on": trained_on, "uploads": uploads,
            "bytes_down": [down.get(r, 0) for r in range(1, server_cfg.max_rounds + 1)], "steps": steps[0], "server_s": dict(server.transition_s), "wall_s": wall, "server": server,
            "client_ms": {k: 1e3 * v for k, v in sorted(client_s.items())}}


def _round_globals(run: dict, names, rounds: int) -> list[bytes]:
    """Each round's global as the clients received it: the blob every
    client trained on in the next round, and the final weights."""
    out = []
    for rnd in range(1, rounds + 1):
        got = {run["trained_on"][(n, rnd + 1)] if rnd < rounds else run["results"][n].final_weights
               for n in names}
        if len(got) != 1:
            raise AssertionError(f"round {rnd}: the clients received different globals")
        out.append(got.pop())
    return out


def grpc_phase(torch, card: str, train: dict) -> dict:
    """Phase 9: phase 7's federation over loopback gRPC, each round's
    global held byte-equal to phase 7's."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.ops import bce

    fs = federation_setup(torch)
    server_cfg = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05)
    eval_batches = [0]
    bce.reset_launch_counts()
    run = grpc_federation(torch, fs, server_cfg, eval_fn=held_out_eval(fs, eval_batches))
    launches = bce.bce_sums.launches
    state, names = run["state"], fs["names"]
    if any(run["results"][n].rounds_completed != 2 for n in names) or state.model_version != 2:
        raise AssertionError(f"sessions {run['results']}, state at version {state.model_version}")
    got = _round_globals(run, names, 2)
    for rnd, (blob, want) in enumerate(zip(got, train["globals"]), start=1):
        if blob != want:
            raise AssertionError(f"round {rnd}: the gRPC global differs from phase 7's")
    check_server_evals(run["server"], [1, 2])
    if launches != run["steps"] + eval_batches[0] or run["steps"] != 16:
        raise AssertionError(f"bce_sums launches {launches} != {run['steps']} steps + {eval_batches[0]} eval batches")
    walls = [h["wall_clock_s"] for h in state.history]
    out = {
        "launches": launches, "steps": run["steps"], "eval_batches": eval_batches[0],
        "round_wall_s": walls,
        "server_ms": [1e3 * run["server_s"].get(r, 0.0) for r in (1, 2)],
        "bytes_up": [h["bytes_received"] for h in state.history],
        "bytes_down": run["bytes_down"],
        "session_wall_s": run["wall_s"],
        "client_ms_by_kind": run["client_ms"],
        "wall_ratio_grpc_over_in_process": float(np.mean(walls) / np.mean(train["fed"]["round_wall_s"])),
    }
    log(f"[grpc] each round's global is byte-equal to phase 7's; {json.dumps(out)} "
        f"(bytes_down: the weight bytes in the replies the clients received, the pulls in round 1) [{card}]")
    return out


def int8_round_error(frames, serialization, template, uploads, base: bytes, got: bytes, exact: bytes) -> dict:
    """How far an int8 round's global ``got`` sits from ``exact``, the
    same round with the same fits uploaded raw, as a multiple of its
    limit. Per entry the limit is the sample-weighted mean of the uploads'
    quantization steps (a QSGD code is off by less than one step, its
    bucket's scale; 1e-5 of it covers the f32 rounding of ``x / scale``)
    plus 8 ulps of the weight for the reconstruction and the fold. Raises
    unless ``got`` is within the limit and the limit rejects the round
    base (every frame dropped) and the base averaged with the first
    upload alone (the second frame dropped)."""
    import numpy as np

    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    def leaves(tree):
        return [np.asarray(leaf, np.float32).ravel() for leaf in tree_leaves(tree)]

    total = sum(u[3] for u in uploads)
    steps = [0.0] * len(tree_leaves(template))
    for _, _, frame, n_samples in uploads:
        for i, m in enumerate(frames.decode_frame(frame).leaves):
            scale = np.frombuffer(m["scales"], np.float32)
            steps[i] = steps[i] + n_samples / total * frames.expand_scales(scale, m["bucket"],
                                                                            int(np.prod(m["shape"])))
    want = leaves(serialization.tree_from_bytes(exact, template=template))

    def worst(candidate):
        return max(float(np.max(np.abs(c - w) / ((1 + 1e-5) * s + 8 * np.spacing(np.maximum(abs(c), abs(w))))))
                   for c, w, s in zip(candidate, want, steps))

    base_tree = serialization.tree_from_bytes(base, template=template)
    first = leaves(frames.decode_update(uploads[0][2], template, base_tree)[0])
    ratios = {
        "global": worst(leaves(serialization.tree_from_bytes(got, template=template))),
        "frames_dropped": worst(leaves(base_tree)),
        "second_frame_dropped": worst([0.5 * (a + b) for a, b in zip(first, leaves(base_tree))]),
    }
    if not ratios["global"] <= 1.0 < min(ratios["frames_dropped"], ratios["second_frame_dropped"]):
        raise AssertionError(f"int8 round error over its limit (or a limit that cannot tell): {ratios}")
    return ratios


def framed_grpc_phase(torch, card: str, train: dict) -> dict:
    """Phase 10: phase 7's federation over gRPC with int8 frames, each
    round's global held byte-equal to the in-process round machine fed
    the same frames, and round 1's global (both phases start from the
    seeded global) held to phase 7's within the int8 step."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.compress import frames
    from fedcrack_tpu_torch.compress.codecs import get_codec
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.native import crc32c
    from fedcrack_tpu_torch.ops import bce

    fs = federation_setup(torch)
    server_cfg = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05,
                                     update_codec="int8")
    bce.reset_launch_counts()
    run = grpc_federation(torch, fs, server_cfg)
    launches = bce.bce_sums.launches
    state, names = run["state"], fs["names"]
    if launches != run["steps"] or run["steps"] != 16:
        raise AssertionError(f"bce_sums launches {launches} != {run['steps']} train steps")
    if any(h["codecs"] != {n: "int8" for n in names} for h in state.history) \
            or len(run["uploads"]) != 4 or not all(frames.is_frame(u[2]) for u in run["uploads"]):
        raise AssertionError(f"not every upload is an int8 frame: {[h['codecs'] for h in state.history]}")
    # The same frames through the round machine in process.
    ref = rounds.initial_state(server_cfg, fs["global0"])
    for name in names:
        ref, _ = rounds.transition(ref, rounds.Ready(name, now=0.0))
    want = []
    for rnd in (1, 2):
        for name, r, frame, n_samples in sorted(u for u in run["uploads"] if u[1] == rnd):
            ref, reply = rounds.transition(ref, rounds.TrainDone(name, round=r, blob=frame, num_samples=n_samples,
                                                                 now=float(rnd)))
        want.append(ref.global_blob)
    got = _round_globals(run, names, 2)
    if got != want or state.history[-1]["codecs"] != ref.history[-1]["codecs"]:
        raise AssertionError("the gRPC globals differ from the in-process round machine's on the same frames")
    # Round 1 starts from the seeded global in phases 7 and 10 alike, with the
    # same fits: the int8 global is phase 7's up to the quantization step.
    int8_err = int8_round_error(frames, serialization, ref.template, sorted(u for u in run["uploads"] if u[1] == 1),
                                run["trained_on"][(names[0], 1)], got[0], train["globals"][0])
    # Codec costs on round 2's first upload, timed alone (median of 3).
    name = names[0]
    base = run["trained_on"][(name, 2)]
    frame = next(u[2] for u in run["uploads"] if u[:2] == (name, 2))
    base_tree = serialization.tree_from_bytes(base, template=ref.template)
    trained = serialization.tree_to_bytes(frames.decode_update(frame, ref.template, base_tree)[0])

    def median_ms(fn, n=3):
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    buf = np.random.default_rng(0).integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    crc_ms = median_ms(lambda: crc32c(buf))
    out = {
        "launches": launches, "steps": run["steps"],
        "frame_bytes": [len(u[2]) for u in sorted(run["uploads"])],
        "dense_bytes": len(state.global_blob),
        "frame_ratio": float(len(state.global_blob) / np.mean([len(u[2]) for u in run["uploads"]])),
        "encode_ms": median_ms(lambda: get_codec("int8", client_tag=name).encode_update(trained, base, round=2,
                                                                                        base_version=1)),
        "decode_ms": median_ms(lambda: frames.decode_update(frame, ref.template, base_tree,
                                                            expected_base_version=1)),
        "crc32c_mib_per_s": 64 * 1e3 / crc_ms,
        "round_wall_s": [h["wall_clock_s"] for h in state.history],
        "server_ms": [1e3 * run["server_s"].get(r, 0.0) for r in (1, 2)],
        "bytes_up": [h["bytes_received"] for h in state.history],
        "bytes_down": run["bytes_down"],
        "round1_err_over_int8_step": int8_err,
        "session_wall_s": run["wall_s"],
        "client_ms_by_kind": run["client_ms"],
    }
    log(f"[framed] every upload is an int8 frame, each round's global is byte-equal to the in-process "
        f"round machine's on the same frames, and round 1's is phase 7's within the int8 step; "
        f"{json.dumps(out)} [{card}]")
    return out


def buffered_config(fs: dict, **over):
    """Phases 11-12's FedBuff server: phase 7's, buffered (K = 2, alpha
    0.5, max staleness 4, three versions), on 127.0.0.1."""
    import dataclasses

    kw = dict(host="127.0.0.1", port=0, poll_period_s=0.05, mode="buffered", buffer_k=2, staleness_alpha=0.5,
              max_staleness=4, max_rounds=3)
    return dataclasses.replace(fs["server_cfg"], **{**kw, **over})


def held_out_eval(fs: dict, counter: list):
    """The server's ``eval_fn`` over phase 7's 32 held-out samples; adds
    the eval batches to ``counter[0]``. The server logs and drops what an
    ``eval_fn`` raises, so a phase holds ``server.eval_history`` to
    :func:`check_server_evals` as well."""
    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.train import local

    def eval_fn(blob):
        ev = local.evaluate(fs["evaluator"].replace_variables(
            serialization.tree_from_bytes(blob, template=fs["global0"])), fs["held"])
        counter[0] += ev["num_batches"]
        return ev

    return eval_fn


def check_server_evals(server, versions) -> None:
    """Raises unless the server evaluated each of ``versions`` once (a
    failed eval leaves no entry) and every metric is finite."""
    import numpy as np

    evals = server.eval_history
    if sorted(e["model_version"] for e in evals) != list(versions):
        raise AssertionError(f"server evals {evals}, want one for each version of {list(versions)}")
    for e in evals:
        if not all(np.isfinite(v) for v in e.values()):
            raise AssertionError(f"non-finite server eval {e}")


def recording_server_class():
    """A ``FedServer`` that records every event with its reply status in
    the order the round machine applied them (an event is appended just
    before ``_apply`` takes the server's lock, which wakes its waiters
    first in, first out), and the global it published at each version."""
    from fedcrack_tpu_torch.transport import FedServer

    class RecordingServer(FedServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.applied, self.published = [], {}

        async def _apply(self, event):
            record = [event, None]
            self.applied.append(record)
            reply = await super()._apply(event)
            record[1] = reply.status
            self.published.setdefault(self.state.model_version, self.state.global_blob)
            return reply

    return RecordingServer


def replay_events(rounds, config, global0, applied) -> dict:
    """A recording server's events through ``rounds.transition`` in
    process, each reply status held to the server's. Returns the final
    state, the global at each version, and the uploads accepted into the
    buffer, each with its client, ``seq``, the version it was pulled at and
    the version it was accepted at, its blob and its sample count."""
    state = rounds.initial_state(config, global0)
    globals_, accepted = {}, []
    for event, status in applied:
        prev = state
        state, reply = rounds.transition(state, event)
        if reply.status != status:
            raise AssertionError(f"replay of {type(event).__name__} gave {reply.status}, the server {status}")
        if isinstance(event, rounds.TrainDone) and (
                reply.status in (rounds.RESP_ACY, rounds.RESP_ARY)
                or (reply.status == rounds.FIN and state.model_version != prev.model_version)):
            accepted.append({"client": event.cname, "seq": sum(e["cname"] == event.cname for e in prev.buffer),
                             "pulled_at": prev.pulled[event.cname], "version_at": prev.model_version,
                             "blob": event.blob, "ns": event.num_samples})
        if state.model_version != prev.model_version:
            globals_[state.model_version] = state.global_blob
    return {"state": state, "globals": globals_, "accepted": accepted}


def check_flushes(config, global0, accepted, history, published) -> dict:
    """Each flushed global against the uploads it folded, computed apart
    from the round machine: version ``v`` folds the uploads accepted at
    version ``v - 1``. A flush of fresh uploads only is byte-equal to the
    tree-level FedAvg of those uploads (phase 7's loop); every flush is
    within 8 f32 ulps, per entry, of the float64 closed form, the mean
    weighted by ``ns * (1 + staleness)^-alpha`` anchored on the previous
    global by the mean staleness weight. Returns the largest error of each
    version in those ulps."""
    import numpy as np

    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold

    if config.aggregation != "fedavg" or config.server_optimizer != "avg":
        raise AssertionError("the closed form covers plain FedAvg only")

    def tree(blob):
        return serialization.tree_from_bytes(blob, template=global0)

    prev, err = serialization.tree_to_bytes(global0), {}
    for v, h in enumerate(history, start=1):
        buffered = [a for a in accepted if a["version_at"] == v - 1]
        if sorted(a["version_at"] - a["pulled_at"] for a in buffered) != sorted(h["staleness"]):
            raise AssertionError(f"version {v}: buffered uploads {buffered} against history {h}")
        group = sorted((a for a in buffered if a["client"] not in h["quarantined"]),
                       key=lambda a: (a["client"], a["seq"]))
        staleness = [a["version_at"] - a["pulled_at"] for a in group]
        if not group:
            raise AssertionError(f"version {v}: every upload quarantined {h}")
        got = tree(published[v])
        if not any(staleness):
            want = fold(FedAvg(), [(a["client"], a["ns"], tree(a["blob"])) for a in group])
            if serialization.tree_to_bytes(want) != published[v]:
                raise AssertionError(f"version {v}: the flush differs from the tree-level FedAvg of its uploads")
        eff = [a["ns"] * (1.0 + s) ** -config.staleness_alpha for a, s in zip(group, staleness)]
        mix = sum(eff) / sum(a["ns"] for a in group)
        flat = [dict(_flat_tree(tree(a["blob"]))) for a in group]
        base = dict(_flat_tree(tree(prev)))
        worst = 0.0
        for key, leaf in _flat_tree(got):
            ups = [np.asarray(f[key], np.float64) for f in flat]
            mean = sum(w * u for w, u in zip(eff, ups)) / sum(eff)
            old = np.asarray(base[key], np.float64)
            want = mean if mix == 1.0 else (1.0 - mix) * old + mix * mean
            scale = np.maximum.reduce([np.abs(old)] + [np.abs(u) for u in ups])
            ulps = np.abs(np.asarray(leaf, np.float64) - want) / np.spacing(scale.astype(np.float32))
            worst = max(worst, float(np.max(ulps, initial=0.0)))
        if worst > 8.0:
            raise AssertionError(f"version {v}: the flush is {worst} ulps from the closed-form staleness mean")
        err[v], prev = worst, published[v]
    return err


def buffered_grpc_phase(torch, card: str) -> dict:
    """Phase 11: FedBuff over loopback gRPC at full width, each flushed
    global byte-equal to the in-process replay of the server's events."""
    import tempfile

    from fedcrack_tpu_torch.ckpt import server_state_from_bytes, server_state_to_bytes
    from fedcrack_tpu_torch.fed import rounds
    from fedcrack_tpu_torch.fed.buffered import async_summary
    from fedcrack_tpu_torch.ops import bce

    fs = federation_setup(torch)
    eval_batches = [0]
    with tempfile.TemporaryDirectory() as tmp:
        server_cfg = buffered_config(fs, state_path=os.path.join(tmp, "state.msgpack"))
        bce.reset_launch_counts()
        run = grpc_federation(torch, fs, server_cfg, eval_fn=held_out_eval(fs, eval_batches),
                              server_cls=recording_server_class())
        launches = bce.bce_sums.launches
        with open(server_cfg.state_path, "rb") as f:
            statefile = f.read()
    state, server = run["state"], run["server"]
    if state.phase != rounds.PHASE_FINISHED or state.model_version != 3 or len(state.history) != 3:
        raise AssertionError(f"buffered federation ended at {state.phase}, version {state.model_version}")
    for h in state.history:
        if h.get("mode") != "buffered" or not isinstance(h.get("staleness"), list) or "updates_per_sec" not in h:
            raise AssertionError(f"buffered history entry {h}")
    replay = replay_events(rounds, server_cfg, fs["global0"], server.applied)
    for version in (1, 2, 3):
        if server.published.get(version) != replay["globals"].get(version):
            raise AssertionError(f"version {version}: the flushed global differs from the replay's")
    if replay["state"].history != state.history or replay["state"].global_blob != state.global_blob:
        raise AssertionError("the replay's history or final global differs from the server's")
    accepted = replay["accepted"]
    if len(accepted) != sum(h["buffer_fill"] for h in state.history):
        raise AssertionError(f"accepted uploads {accepted} against history {state.history}")
    flush_ulps = check_flushes(server_cfg, fs["global0"], accepted, state.history, server.published)
    check_server_evals(server, [1, 2, 3])
    restored = server_state_from_bytes(statefile, server_cfg)
    if server_state_to_bytes(restored) != statefile or restored.model_version != state.model_version:
        raise AssertionError("the statefile on disk does not re-encode to its bytes at the final version")
    if launches != run["steps"] + eval_batches[0] or run["steps"] == 0:
        raise AssertionError(f"bce_sums launches {launches} != {run['steps']} steps + {eval_batches[0]} eval batches")
    snaps = server.snapshots
    snap_ms = sorted(s["ms"] for s in snaps)
    out = {
        "launches": launches, "steps": run["steps"], "eval_batches": eval_batches[0],
        "accepted": [{k: v for k, v in a.items() if k != "blob"} for a in accepted],
        "flush_err_ulps": flush_ulps,
        "flush_wall_s": [h["wall_clock_s"] for h in state.history],
        "updates_per_sec": [h["updates_per_sec"] for h in state.history],
        "staleness": [h["staleness"] for h in state.history],
        "server_ms": {r: 1e3 * v for r, v in sorted(run["server_s"].items())},
        "statefile_bytes": len(statefile), "snapshots": len(snaps),
        "snapshot_bytes_max": max(s["bytes"] for s in snaps),
        "snapshot_ms_median": snap_ms[len(snaps) // 2], "snapshot_ms_max": snap_ms[-1],
        "session_wall_s": run["wall_s"], "client_ms_by_kind": run["client_ms"],
        "async_summary": async_summary(state.history),
    }
    log(f"[buffered] 3 flushes over gRPC, each byte-equal to the in-process replay of the server's events "
        f"and within 8 ulps of the closed-form staleness mean of its uploads; one finite server eval per version; "
        f"the statefile re-encodes to its {len(statefile)} bytes; {json.dumps(out)} [{card}]")
    return out


def resume_and_swap_phase(torch, card: str) -> dict:
    """Phase 12: a FedBuff server stopped with one card fit in its buffer
    resumes from its statefile and flushes the global an uninterrupted
    replay flushes; a ``ModelVersionManager`` on the fused_int8 engine
    watches the statefile and installs the flushed version (the gate
    decides as on the CPU), then the code-grid-snapped weights published
    at the next version, and serves a bucket-256 batch on them through
    the dequant kernels."""
    import tempfile

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager, publish_statefile
    from fedcrack_tpu_torch.transport import FedClient, FedServer, wire
    from fedcrack_tpu_torch.transport.service import ServerThread

    fs = federation_setup(torch)
    names = fs["names"]
    fits = {name: fs["client_fn"](i, name) for i, name in enumerate(names)}
    steps, uploads = [0], {}

    def fit(name, pull):
        rnd = int(pull.config["current_round"])
        blob, n_samples, _ = fits[name](pull.weights, rnd, dict(pull.config))
        steps[0] += n_samples // TRAIN_BATCH
        uploads[name] = (blob, n_samples)
        return wire.TrainDone(round=rnd, weights=blob, sample_count=n_samples)

    def callers(port):
        """Per client, its channel and a one-message call on it."""
        out = {}
        for name in names:
            client = FedClient(cfg, fits[name], cname=name, port=port)
            channel, method = client._connect()
            out[name] = (channel, lambda body, c=client, m=method: c._call(m, c._msg(body)))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.msgpack")
        cfg = buffered_config(fs, max_rounds=2, state_path=path)
        bce.reset_launch_counts()
        with ServerThread(FedServer(cfg, fs["global0"], tick_period_s=0.05)) as st:
            calls = callers(st.port)
            for name in names:
                calls[name][1](wire.ReadyReq(config={"current_round": 0}))
            pulls = {name: calls[name][1](wire.PullReq()) for name in names}
            if calls[names[0]][1](fit(names[0], pulls[names[0]])).status != rounds.RESP_ACY:
                raise AssertionError("the first fit was not buffered")
            deadline = time.monotonic() + 60
            while (snap := load_state_file(path, cfg)) is None or len(snap.buffer) != 1:
                if time.monotonic() > deadline:
                    raise AssertionError("the mid-buffer snapshot never reached the disk")
                time.sleep(0.02)
            for channel, _ in calls.values():
                channel.close()
        resumed_server = FedServer(cfg, fs["global0"], tick_period_s=0.05)
        if [(e["cname"], e["seq"]) for e in resumed_server.state.buffer] != [(names[0], 0)]:
            raise AssertionError(f"the resumed server's buffer {resumed_server.state.buffer}")
        with ServerThread(resumed_server) as st:
            calls = callers(st.port)
            reply = calls[names[1]][1](fit(names[1], pulls[names[1]]))
            for channel, _ in calls.values():
                channel.close()
            resumed = st.state
        torch.cuda.synchronize()
        launches = bce.bce_sums.launches
        if reply.status != rounds.RESP_ARY or resumed.model_version != 1:
            raise AssertionError(f"the resumed server answered {reply.status} at version {resumed.model_version}")
        replay = rounds.initial_state(cfg, fs["global0"])
        events = [rounds.Ready(n, now=0.0) for n in names] + [rounds.PullWeights(n, now=0.0) for n in names]
        events += [rounds.TrainDone(n, round=1, blob=uploads[n][0], num_samples=uploads[n][1], now=1.0 + i)
                   for i, n in enumerate(names)]
        for event in events:
            replay, _ = rounds.transition(replay, event)
        if replay.model_version != 1 or replay.global_blob != resumed.global_blob:
            raise AssertionError("the resumed flush differs from the uninterrupted replay's global")
        if launches != steps[0] or steps[0] != 8:
            raise AssertionError(f"bce_sums launches {launches} != {steps[0]} train steps")
        log(f"[resume] stopped with 1 buffered update, resumed from the statefile, flushed version 1 "
            f"bit-identical to the uninterrupted replay; bce_sums launches {launches} = {steps[0]} steps")

        # ---- the serving plane watches the same statefile ----
        model_cfg = fs["cfg"].model
        sc = ServeConfig(quant="int8", kernel_plane="fused_int8")
        engine = InferenceEngine(model_cfg, sc)
        manager = ModelVersionManager(engine, fs["global0"], state_path=path, template=fs["global0"])
        if not manager.poll_once() or manager.version != 1:
            raise AssertionError(f"poll_once did not install the flushed version (at {manager.version})")
        gate_fed = manager.last_quant_gate
        flushed = serialization.tree_from_bytes(resumed.global_blob, template=fs["global0"])
        _, gate_cpu = prepare_gated_payload(InferenceEngine(model_cfg, sc, device="cpu"), flushed, sc)
        # The gate's IoU compares crack masks: the share of probe pixels the
        # reference program calls crack says what it had to compare.
        probe = quant_mod.probe_images(BUCKET, sc.quant_probe_batch, sc.quant_probe_seed)
        positive = float(np.mean(engine.predict_bucket(engine.prepare(flushed), probe) > 0.5))
        log(f"[swap] flushed version 1 installed in {manager.last_swap['load_ms']:.1f} ms (gate included); "
            f"gate on the card {json.dumps(gate_fed)}, on the CPU {json.dumps(gate_cpu.to_json())}; "
            f"crack share of the bucket-{BUCKET} probe under the reference program {positive} [{card}]")
        if gate_fed["passed"] != gate_cpu.passed:
            raise AssertionError("the card's quant gate decides otherwise than the CPU's on the flushed weights")
        if isinstance(manager.snapshot()[1], quant_mod.QuantizedVariables) != gate_fed["passed"]:
            raise AssertionError("the served program does not follow the gate's verdict")
        batch = np.random.default_rng(5).integers(0, 256, (BATCH, BUCKET, BUCKET, 3), dtype=np.uint8)
        probs_v1 = engine.predict_bucket(manager.snapshot()[1], batch)
        # Version 2: the seeded global snapped to the code grid, the weights
        # phases 4-5 serve (the flushed global snapped would quantize to
        # version 1's codes, and the checks below could not tell them apart).
        snapped = quant_mod.dequantize_variables(quant_mod.quantize_for_plane(fs["global0"], "fused_int8").tree)
        publish_statefile(path, snapped, model_version=2)
        if not manager.poll_once() or manager.version != 2 or not manager.last_quant_gate["passed"]:
            raise AssertionError(f"the snapped weights were not installed quantized: {manager.last_quant_gate}")
    version, payload = manager.snapshot()
    if version != 2 or not isinstance(payload, quant_mod.QuantizedVariables):
        raise AssertionError("the served payload is not version 2's quantized program")
    # The installed codes and scales are those of the published weights.
    want_q = quant_mod.quantize_for_plane(snapped, "fused_int8")
    placed, wanted = list(_flat_tree(payload.tree)), list(_flat_tree(want_q.tree))
    def host(leaf):
        return leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)

    if [k for k, _ in placed] != [k for k, _ in wanted] or not all(
            np.array_equal(host(a), host(b)) for (_, a), (_, b) in zip(placed, wanted)):
        raise AssertionError("the installed payload is not the published weights' codes and scales")
    engine.predict_bucket(payload, batch)
    torch.cuda.synchronize()
    dequant.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        probs = engine.predict_bucket(payload, batch)
        torch.cuda.synchronize()
    counted = {name: getattr(dequant, name).launches for name in ("dequant_matmul", "dequant_conv3x3", "dequant_codes")}
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    profiled = {name: sum(e.count for e in kernels if f"{name}_kernel" in e.key) for name in counted}
    want = {"dequant_matmul": 15, "dequant_conv3x3": 8, "dequant_codes": 1}
    if counted != want or profiled != want:
        raise AssertionError(f"served batch launches: wrappers {counted}, profiler {profiled}, want {want}")
    if not (np.isfinite(probs).all() and probs.shape == (BATCH, BUCKET, BUCKET, 1)):
        raise AssertionError("served probabilities not finite of the bucket's shape")
    # The served batch against the CPU engine (plain kernels) on the
    # published weights, within phase 4's limit of the fused plane against
    # the reference plane; version 1's output must lie outside it.
    cpu = InferenceEngine(model_cfg, sc, device="cpu")
    want = cpu.predict_bucket(cpu.prepare(want_q), batch)
    err = float(np.max(np.abs(probs.astype(np.float64) - want)))
    err_v1 = float(np.max(np.abs(probs_v1.astype(np.float64) - want)))
    if not err < SERVE_PROB_TOL <= err_v1:
        raise AssertionError(f"served batch {err} from the CPU engine on version 2's weights, version 1's "
                             f"{err_v1}: want < {SERVE_PROB_TOL} and >= it")
    install_ms = [s["load_ms"] for s in manager.swaps]
    out = {"launches": launches, "steps": steps[0], "resumed_version": resumed.model_version,
           "gate_flushed_card": gate_fed, "gate_flushed_cpu": gate_cpu.to_json(), "probe_crack_share": positive,
           "install_ms": install_ms, "served_launches": counted, "served_max_abs_err_vs_cpu": err,
           "version1_max_abs_diff": err_v1}
    log(f"[swap] snapped weights installed as version 2 in {install_ms[-1]:.1f} ms (gate included, passed), codes "
        f"and scales equal to the published weights'; one bucket-{BUCKET} batch of {BATCH} on it launched "
        f"{json.dumps(profiled)} (profiler), max prob diff {err} from the CPU engine on the same weights "
        f"(version 1's output: {err_v1}) [{card}]")
    return out


def server_breakdown(config, template, rnd: dict, n: int = 3) -> dict:
    """Host ms (median of ``n``) of each step the round machine takes on
    one round's accepted uploads: the gate per upload (validate, decode,
    update norm), the flush (decode, ``observe_flush``), the fold, FedOpt
    and the two encodes. The parts of the closing transition, timed alone."""
    import numpy as np

    from fedcrack_tpu_torch.fed import aggregation, algorithms, serialization as ser
    from fedcrack_tpu_torch.health import ledger

    base = ser.tree_from_bytes(rnd["base"], template=template)
    uploads = {k: v for k, v in sorted(rnd["uploads"].items()) if ser.validate_update(v[0], template) is None}

    def timed(fn):
        out, ms = None, []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(ms))

    parts = {}
    blob0 = next(iter(uploads.values()))[0]
    _, parts["gate_validate"] = timed(lambda: ser.validate_update(blob0, template))
    tree0, parts["gate_decode"] = timed(lambda: ser.tree_from_bytes(blob0, template=template))
    _, parts["gate_norm"] = timed(lambda: ledger.update_norm(tree0, base))
    trees, parts["flush_decode_all"] = timed(
        lambda: [ser.tree_from_bytes(b, template=template) for b, _ in uploads.values()])
    items = list(zip(uploads, trees))
    _, parts["observe_flush"] = timed(lambda: ledger.observe_flush({}, items, base))
    triples = [(k, c, t) for (k, (_, c)), t in zip(uploads.items(), trees)]
    avg, parts["fold_" + config.aggregation] = timed(
        lambda: aggregation.fold(aggregation.from_config(config), triples))
    tx = algorithms.make_server_optimizer(config.server_optimizer, config.server_lr, config.server_momentum)
    if tx is not None:
        _, parts["fedopt_" + config.server_optimizer] = timed(
            lambda: algorithms.apply_server_opt(base["params"], avg["params"], tx, tx.init(base["params"])))
    _, parts["encode_f32"] = timed(lambda: ser.tree_to_bytes(avg))
    if config.wire_dtype == "bfloat16":
        _, parts["encode_bf16"] = timed(lambda: ser.tree_to_bytes(avg, cast_dtype="bfloat16"))
    return parts


def robust_round_config():
    """Phase 8's server: one round, three clients, a bfloat16 wire, the
    trimmed mean (floor(0.34 * 2) = 0 trimmed of the two that pass),
    FedAdam and a round deadline that closes the round the rejected client
    leaves short of its quorum."""
    from fedcrack_tpu_torch.configs import FedConfig

    return FedConfig(max_rounds=1, cohort_size=3, local_epochs=1, wire_dtype="bfloat16",
                     aggregation="trimmed_mean", trim_fraction=0.34, server_optimizer="fedadam",
                     server_lr=0.01, round_deadline_s=30.0)


def check_robust_round(R, run: dict, names) -> None:
    """Phase 8's protocol contract: the poisoned third client is REJECTED
    for its non-finite leaf, the deadline closes the round on the other
    two, the history records the rejection, and every poll sees FIN."""
    bad = names[2]
    want = [(n, "Ready", R.SW) for n in names]
    for n, status in zip(names, (R.RESP_ACY, R.RESP_ACY, R.REJECTED)):
        want += [(n, "PullWeights", "OK"), (n, "TrainingNotice", "OK"), (n, "TrainDone", status)]
    want += [("server", "Tick", R.PHASE_FINISHED)] + [(n, "VersionPoll", R.FIN) for n in names]
    if run["statuses"] != want:
        raise AssertionError(f"protocol statuses {run['statuses']} != {want}")
    state = run["state"]
    (entry,) = state.history
    if entry["clients"] != names[:2] or entry["cohort_size"] != 2 \
            or set(entry["rejected"]) != {bad} or "non-finite" not in entry["rejected"][bad] \
            or state.departed != frozenset({bad}) or state.server_opt_state is None:
        raise AssertionError(f"robust round history {entry}, departed {state.departed}")


def profile_steps(torch, step, card: str, n: int = 3) -> None:
    """Where one train step's time goes: CUDA kernel time by name and the
    device's idle share of the host-clock window (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler saw no CUDA kernels; device time not measured")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile: {n} train steps in {wall_us / n / 1e3:.3f} ms each on the host clock, device busy "
        f"{busy_us / n / 1e3:.3f} ms each, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(e.count for e in kernels) // n} kernel launches per step [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile: {e.self_device_time_total / n / 1e3:8.4f} ms/step "
            f"{e.count // n:4d} calls/step  {e.key[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only", file=sys.stderr)
        return 2
    # The port needs none of these: block them for this run, so an import
    # of one fails the smoke on a machine that has it installed.
    installed = [m for m in REFERENCE_STACK if importlib.util.find_spec(m) is not None]
    for m in REFERENCE_STACK:
        if m not in PORT_NEEDS:
            sys.modules.setdefault(m, None)
    sys.path.insert(0, HERE)
    from fedcrack_tpu_torch.kernels import build, dequant
    from fedcrack_tpu_torch.ops import bce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1 device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}, card: {card}")
    log(f"installed on this machine: {installed}; blocked for this run: "
        f"{[m for m in REFERENCE_STACK if m in sys.modules and sys.modules[m] is None]}")

    t0 = time.monotonic()
    libs = build.build_all([dequant.LIBRARY, bce.LIBRARY])
    log(f"phase 2 build: {time.monotonic() - t0:.2f} s "
        f"({', '.join(os.path.relpath(lib, HERE) for lib in libs)})")
    for lib in libs:
        with open(f"{lib}.log", encoding="utf-8") as f:
            log(f.read())

    rows = kernel_phase(torch, card)
    log("phase 3 kernels vs plain: ok")
    int8 = serve_phase(torch, card, "fused_int8", requests=True)
    log("phase 4 serve fused_int8: ok")
    fp8 = serve_phase(torch, card, "fp8", requests=False)
    log("phase 5 serve fp8: ok")
    bce_row = bce_phase(torch, card)
    log("phase 6 bce_sums vs plain: ok")
    train = train_phase(torch, card)
    log("phase 7 federation at full width through the round protocol: ok")
    robust = robust_round_phase(torch, card)
    log("phase 8 robust round (bf16 wire, trimmed mean, FedAdam, deadline) at full width: ok")
    grpc_run = grpc_phase(torch, card, train)
    log("phase 9 FedAvg over gRPC at full width: ok")
    framed = framed_grpc_phase(torch, card, train)
    log("phase 10 int8-framed FedAvg over gRPC at full width: ok")
    buffered = buffered_grpc_phase(torch, card)
    log("phase 11 FedBuff over gRPC at full width: ok")
    swap = resume_and_swap_phase(torch, card)
    log("phase 12 mid-buffer kill, resume and statefile hot swap at full width: ok")

    kernels = []
    replaces = {"dequant_matmul": "fedcrack_tpu/kernels/dequant.py:88",
                "dequant_conv3x3": ("fedcrack_tpu/kernels/dequant.py:88 "
                                    "(with fedcrack_tpu/kernels/forward.py:76, the JAX _conv3x3)"),
                "dequant_codes": "fedcrack_tpu/kernels/dequant.py:175"}
    for flavor, served in (("int8", int8), ("e4m3", fp8)):
        for name in ("dequant_matmul", "dequant_conv3x3", "dequant_codes"):
            row = rows[f"{name}[{flavor}]"]
            kernels.append({
                "name": f"{name}[{flavor}]",
                "route": "cuda",
                "source": "fedcrack_tpu_torch/kernels/csrc/dequant.cu",
                "replaces": replaces[name],
                "launches": served["launches"][name],
                **({"launches_phase12": swap["served_launches"][name]} if flavor == "int8" else {}),
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "event_ms": row["event_ms"],
                "library_event_ms": row["library_event_ms"],
            })
    kernels.append({
        "name": "bce_sums",
        "route": "cuda",
        "source": "fedcrack_tpu_torch/kernels/csrc/bce_sums.cu",
        "replaces": "fedcrack_tpu/ops/pallas_bce.py:57",
        "launches": train["launches"],
        "launches_phase8": robust["launches"],
        "launches_phase9": grpc_run["launches"],
        "launches_phase10": framed["launches"],
        "launches_phase11": buffered["launches"],
        "launches_phase12": swap["launches"],
        **bce_row,
    })
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
