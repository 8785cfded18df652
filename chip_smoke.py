#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``fedcrack_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``; it imports neither JAX nor ``fedcrack_tpu``. Phases (each raises
on failure, so any failure exits non-zero and prints no result):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles ``fedcrack_tpu_torch/kernels/csrc/dequant.cu`` and
   ``bce_sums.cu`` (sm_90a), one nvcc each, started together;
3. kernels vs plain: ``dequant_matmul`` (int8 and e4m3 codes) at every GEMM
   shape the fused forward launches at bucket 256 x batch 8 with
   ``ModelConfig()``, plus a ragged sweep: per entry within the per-channel
   scale + 1e-6 of the plain version, bitwise equal run to run;
   ``dequant_codes`` bitwise equal to its plain version. Kernel, plain and
   library times (CUDA events) beside the bound;
4. serve at full width (the main path): ``ModelConfig()`` with
   ``ServeConfig(quant="int8", kernel_plane="fused_int8")``, install through
   ``ModelVersionManager.install`` (the quant gate must pass at both
   buckets), then requests through ``MicroBatcher.submit`` (16 at 256^2,
   8 at 128^2, 2 padded) and one tiled 512 x 384 image through
   ``predict_image``, twice. Launch counts are reset right before and read
   right after; fused vs reference plane on the probe batch; throughput;
5. the fp8 plane: the same with ``kernel_plane="fp8"``, one batch served;
6. ``bce_sums`` vs plain at the train step's logits (16 x 128 x 128), at
   8 x 256 x 256, and over a ragged sweep: count lanes equal, BCE lanes
   within rtol 1e-5 / atol 1e-3, bitwise equal run to run; kernel, plain,
   library and bound times;
7. train at full width (the training path's main path): ``ModelConfig()``
   at 128 px, batch 16, two clients of 64 seeded synthetic samples and 32
   held out; two rounds of ``make_train_fn`` per client (one local epoch),
   ``fold(FedAvg())`` over the sorted triples and ``evaluate`` of each new
   global. ``bce_sums`` launches must equal train steps plus eval batches.
   Then one train step on the card against the same step on the CPU, two
   local fits bitwise equal, step throughput and a profile of one step.

The last three lines: the card's name and power limit, the per-kernel JSON
object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory
# bandwidth, and the f32 rate outside the tensor cores (the kernels' FMA).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SWEEP_SHAPES = [(4, 7, 5), (8, 128, 128), (33, 130, 129), (1, 256, 3), (16, 9, 17)]
BUCKET, BATCH = 256, 8
# The training path: the reference's client shape, and the JAX kernel
# test's ragged sizes for bce_sums.
TRAIN_SIZE, TRAIN_BATCH = 128, 16
BCE_SWEEP = [1, 100, 128, 32768, 32769, 100_000]
# bce_sums reads x and y (8 bytes) and does ~20 operations per element.
BCE_OPS_PER_ELEMENT = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gemm_shapes(cfg, size: int, batch: int) -> list[tuple[str, int, int, int]]:
    """(layer, M, K, N) of every dequant_matmul of the fused forward, in
    launch order: 1 stem + 3 per encoder block + 3 per decoder block + head."""
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
    prev = cin
    for i, f in enumerate(cfg.decoder_features):
        shapes.append((f"dec{i}_convT1", batch * g * g, 9 * cin, f))
        shapes.append((f"dec{i}_convT2", batch * g * g, 9 * f, f))
        shapes.append((f"dec{i}_res", batch * g * g, prev, f))
        cin = prev = f
        if i + 1 < len(cfg.decoder_features):
            g *= 2
    shapes.append(("head", batch * g * g, cin, cfg.num_classes))
    return shapes


def depthwise_channels(cfg) -> list[int]:
    """Channel count of every dequant_codes launch (two per encoder block)."""
    out, cin = [], cfg.stem_features
    for f in cfg.encoder_features:
        out += [cin, f]
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, card: str) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.serve.quant import QKEY, QKEY_FP8, SKEY, quantize_leaf, quantize_leaf_fp8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    main_shapes = gemm_shapes(ModelConfig(), BUCKET, BATCH)
    sweep = [(f"sweep{s}", *s) for s in SWEEP_SHAPES]
    rows = {}
    for flavor, leaf_fn, key in (("int8", quantize_leaf, QKEY), ("e4m3", quantize_leaf_fp8, QKEY_FP8)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0}
        for layer, m, k, n in main_shapes + sweep:
            x = torch.randn((m, k), generator=gen, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.1
            leaf = leaf_fn(w.cpu().numpy())
            q, s = leaf[key].to(dev), leaf[SKEY].to(dev)
            y = dequant.dequant_matmul(x, q, s)
            y2 = dequant.dequant_matmul(x, q, s)
            plain = dequant._dequant_matmul_plain(x, q, s)
            torch.cuda.synchronize()
            err = (y - plain).abs()
            if not bool((err <= s[None, :] + 1e-6).all()):
                raise AssertionError(f"dequant_matmul[{flavor}] {layer} exceeds the per-channel bound")
            if not torch.equal(y, y2):
                raise AssertionError(f"dequant_matmul[{flavor}] {layer} not deterministic run to run")
            max_err = float(err.max()) if err.numel() else 0.0
            if layer.startswith("sweep"):
                tot["max_abs_err"] = max(tot["max_abs_err"], max_err)
                continue
            wd = q.float() * s
            t_k = cuda_ms(torch, lambda: dequant.dequant_matmul(x, q, s))
            t_p = cuda_ms(torch, lambda: dequant._dequant_matmul_plain(x, q, s))
            t_l = cuda_ms(torch, lambda: torch.matmul(x, wd))
            n_bytes = 4 * m * k + k * n + 4 * n + 4 * m * n
            b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["library_ms"] += t_l
            tot["bound_ms"] += b_ms
            tot["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += 2 * m * k * n / FP32_FLOPS_PER_S * 1e3
            tot["max_abs_err"] = max(tot["max_abs_err"], max_err)
            log(f"dequant_matmul[{flavor}] {layer} M={m} K={k} N={n}: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, torch.matmul {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"max_abs_err {max_err:.3g} [{card}]")
        rows[f"dequant_matmul[{flavor}]"] = tot
        log(f"dequant_matmul[{flavor}] one forward ({len(main_shapes)} GEMMs): "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
            f"torch.matmul {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms [{card}]")

        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0 if flavor == "int8" else None,
               "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0}
        for c in depthwise_channels(ModelConfig()) + [17, 1000, 4099]:
            shape = (3, 3, 1, c) if c in depthwise_channels(ModelConfig()) else (c, 37)
            w = torch.randn(shape, generator=gen, device=dev) * 0.1
            leaf = leaf_fn(w.cpu().numpy())
            q, s = leaf[key].to(dev), leaf[SKEY].to(dev)
            out = dequant.dequant_codes(q, s)
            plain = dequant._dequant_codes_plain(q, s)
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"dequant_codes[{flavor}] {shape} differs from its plain version")
            if len(shape) != 4:
                continue  # ragged check only
            t_k = cuda_ms(torch, lambda: dequant.dequant_codes(q, s))
            t_p = cuda_ms(torch, lambda: dequant._dequant_codes_plain(q, s))
            numel = q.numel()
            n_bytes = numel + 4 * shape[-1] + 4 * numel
            b_ms, b_by = bound_ms(n_bytes, numel)
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["bound_ms"] += b_ms
            tot["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += numel / FP32_FLOPS_PER_S * 1e3
            if flavor == "int8":
                tot["library_ms"] += cuda_ms(torch, lambda: torch.mul(q, s))
            log(f"dequant_codes[{flavor}] {shape}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}) [{card}]")
        rows[f"dequant_codes[{flavor}]"] = tot
    return rows


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
    n_matmul = len(gemm_shapes(cfg, BUCKET, BATCH))
    n_codes = len(depthwise_channels(cfg))

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
    launches = {"dequant_matmul": dequant.dequant_matmul.launches,
                "dequant_codes": dequant.dequant_codes.launches}
    log(f"[{kernel_plane}] main path: {forwards} quantized forwards, launches {launches}, "
        f"batcher {json.dumps(stats)}")
    if forwards == 0 or launches["dequant_matmul"] != n_matmul * forwards \
            or launches["dequant_codes"] != n_codes * forwards:
        raise AssertionError(
            f"launch counts {launches} != {n_matmul}/{n_codes} per forward x {forwards}")
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
    if diff >= 1e-3 or iou < 0.99:
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
    """Phase 6: ``bce_sums`` against its plain version on the card."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.ops import bce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [("train_step", (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 1)), ("256px", (8, 256, 256, 1))]
    cases += [(f"n={n}", (n,)) for n in BCE_SWEEP]
    row = {"max_abs_err": 0.0}
    for label, shape in cases:
        x = torch.randn(shape, generator=gen, device=dev) * 2.0
        y = (torch.rand(shape, generator=gen, device=dev) > 0.7).to(torch.float32)
        got = bce.bce_sums(x, y)
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
        if len(shape) == 1:
            continue
        n = x.numel()
        t_k = cuda_ms(torch, lambda: bce.bce_sums(x, y), iters=50)
        t_p = cuda_ms(torch, lambda: bce._bce_sums_plain(x, y), iters=50)
        t_l = cuda_ms(torch, lambda: F.binary_cross_entropy_with_logits(x, y, reduction="sum"), iters=50)
        b_ms, b_by = bound_ms(8 * n + 4 * 5, BCE_OPS_PER_ELEMENT * n)
        log(f"bce_sums {label} {tuple(shape)} (n={n}): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"F.binary_cross_entropy_with_logits (lane 0 only) {t_l:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), max_abs_err {float(err.max()):.3g} [{card}]")
        if label == "train_step":
            row.update(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
            dev_us = kernel_device_us(torch, lambda: bce.bce_sums(x, y), ("bce_partials", "bce_final"))
            log(f"bce_sums {label}: device time per call (torch.profiler) "
                f"{json.dumps({k: round(v, 3) for k, v in dev_us.items()})} us; the CUDA-event time above "
                f"includes the host's per-call work between back-to-back launches [{card}]")
    return row


def kernel_device_us(torch, fn, names: tuple[str, ...], n: int = 20) -> dict[str, float]:
    """Device time per call of each named kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    out[name] += e.self_device_time_total / n
    return out


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


def train_phase(torch, card: str) -> dict:
    """Phase 7: one client's round at full width, twice, on the card."""
    import numpy as np

    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.aggregation import FedAvg, fold
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.train import local
    from fedcrack_tpu_torch.train.federated import make_train_fn

    cfg = FedConfig(model=ModelConfig(), data=DataConfig(img_size=TRAIN_SIZE, batch_size=TRAIN_BATCH))
    lr = cfg.learning_rate
    imgs, msks = synth_crack_batch(160, TRAIN_SIZE, seed=0)
    shards = {"client_0": slice(0, 64), "client_1": slice(64, 128)}
    held = ArrayDataset(imgs[128:], msks[128:], batch_size=TRAIN_BATCH, shuffle=False)
    global0 = init_variables(torch.Generator().manual_seed(0), cfg.model)

    def client_fn(i, name):
        data = ArrayDataset(imgs[shards[name]], msks[shards[name]], batch_size=TRAIN_BATCH, seed=i)
        return make_train_fn(cfg, data, TRAIN_BATCH, seed=i)[0]

    clients = {name: client_fn(i, name) for i, name in enumerate(sorted(shards))}
    evaluator = local.create_train_state(torch.Generator().manual_seed(0), cfg.model, lr)

    # ---- the main path, counted ----
    bce.reset_launch_counts()
    t0 = time.monotonic()
    tree, steps, eval_batches, history = global0, 0, 0, []
    for rnd in range(2):
        triples = []
        for name in sorted(clients):
            new, n_samples, metrics = clients[name](tree, rnd, {"local_epochs": 1})
            steps += n_samples // TRAIN_BATCH
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"round {rnd} {name}: non-finite train metrics {metrics}")
            triples.append((name, n_samples, new))
        new_global = fold(FedAvg(), triples)
        if all(np.array_equal(a, b) for (_, a), (_, b) in zip(_flat_tree(new_global), _flat_tree(tree))):
            raise AssertionError(f"round {rnd}: the global did not change")
        ev = local.evaluate(evaluator.replace_variables(new_global), held)
        eval_batches += ev["num_batches"]
        if not all(np.isfinite(v) for v in ev.values()):
            raise AssertionError(f"round {rnd}: non-finite eval metrics {ev}")
        for _, leaf in _flat_tree(new_global):
            if not np.isfinite(leaf).all():
                raise AssertionError(f"round {rnd}: non-finite global weights")
        history.append({"round": rnd, "train": metrics, "eval": ev})
        log(f"[train] round {rnd}: last client's train {json.dumps(metrics)}; global eval {json.dumps(ev)}")
        tree = new_global
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    log(f"[train] main path: 2 rounds x 2 clients, {steps} train steps + {eval_batches} eval batches "
        f"in {time.monotonic() - t0:.2f} s, bce_sums launches {launches}")
    if launches != steps + eval_batches or steps != 16:
        raise AssertionError(f"bce_sums launches {launches} != {steps} steps + {eval_batches} eval batches")

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
    fits = [client_fn(0, "client_0")(global0, 0, {"local_epochs": 1})[0] for _ in range(2)]
    for (path, a), (_, b) in zip(_flat_tree(fits[0]), _flat_tree(fits[1])):
        if not np.array_equal(a, b):
            raise AssertionError(f"two local fits from one start differ at {'/'.join(path)}")
    log("[train] two local fits from the same start: bitwise equal")

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
            "history": history}


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
    sys.path.insert(0, HERE)
    from fedcrack_tpu_torch.kernels import build, dequant
    from fedcrack_tpu_torch.ops import bce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1 device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}, card: {card}")

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
    log("phase 7 train at full width: ok")

    kernels = []
    for name, launches_from in (("dequant_matmul", int8), ("dequant_codes", int8),
                                ("dequant_matmul", fp8), ("dequant_codes", fp8)):
        flavor = "int8" if launches_from is int8 else "e4m3"
        row = rows[f"{name}[{flavor}]"]
        kernels.append({
            "name": f"{name}[{flavor}]",
            "route": "cuda",
            "source": "fedcrack_tpu_torch/kernels/csrc/dequant.cu",
            "replaces": ("fedcrack_tpu/kernels/dequant.py:88" if name == "dequant_matmul"
                         else "fedcrack_tpu/kernels/dequant.py:175"),
            "launches": launches_from["launches"][name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
            "library_ms": row["library_ms"],
        })
    kernels.append({
        "name": "bce_sums",
        "route": "cuda",
        "source": "fedcrack_tpu_torch/kernels/csrc/bce_sums.cu",
        "replaces": "fedcrack_tpu/ops/pallas_bce.py:57",
        "launches": train["launches"],
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
