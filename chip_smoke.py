#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``fedcrack_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``; it imports neither JAX nor ``fedcrack_tpu``. Phases (each raises
on failure, so any failure exits non-zero and prints no result):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles ``fedcrack_tpu_torch/kernels/csrc/dequant.cu`` (sm_90a);
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
5. the fp8 plane: the same with ``kernel_plane="fp8"``, one batch served.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fedcrack_tpu_torch.kernels import dequant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1 device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}, card: {card}")

    t0 = time.monotonic()
    lib = dequant.build_library()
    log(f"phase 2 build: {time.monotonic() - t0:.2f} s ({os.path.relpath(lib, HERE)})")
    with open(f"{lib}.log", encoding="utf-8") as f:
        log(f.read())

    rows = kernel_phase(torch, card)
    log("phase 3 kernels vs plain: ok")
    int8 = serve_phase(torch, card, "fused_int8", requests=True)
    log("phase 4 serve fused_int8: ok")
    fp8 = serve_phase(torch, card, "fp8", requests=False)
    log("phase 5 serve fp8: ok")

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
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
