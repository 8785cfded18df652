#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``fedcrack_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-ticks 0.05,1.0   # phase 14 alone, per tick
    python3 chip_smoke.py --step-graph             # phase 25 alone
    python3 chip_smoke.py --segformer              # phase 26 alone

Runs from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``; it imports neither JAX nor ``fedcrack_tpu``. Phases (each raises
on failure, so any failure exits non-zero and prints no result):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles ``fedcrack_tpu_torch/kernels/csrc/dequant.cu``,
   ``dequant_conv.cu``, ``dequant_dw.cu`` and ``bce_sums.cu`` (sm_90a), one
   nvcc each, started together;
3. kernels vs plain, int8 and e4m3 codes: ``dequant_matmul`` at the 15
   GEMMs and ``dequant_conv3x3`` at the 8 decoder convs the fused forward
   launches at bucket 256 x batch 8 with ``ModelConfig()``, each plus a
   ragged sweep: per entry within the per-channel scale + 1e-6 of the
   plain version (the largest |kernel - plain| / scale is logged), bitwise
   equal run to run and over a launch of fewer rows (for the conv, the
   first image alone, and the last image alone, equal to the same images
   inside the batch); then each launch with the epilogue the forward
   gives it (its bias; the BatchNorm, ReLU, residual add and input ReLU of
   ``forward_epilogue``), the sweep shapes with the forward's mixes in
   turn, each of ``MATMUL_MIXES`` / ``CONV_MIXES`` on ``EPILOGUE_MATMULS``
   / ``EPILOGUE_CONVS`` with -0.0 and NaN in x and the residual and a ReLU
   of -0.0, bit for bit equal to the same kernel without its epilogue
   followed by the torch ops it stands for (``check_fused``), and over
   fewer rows or the last image alone; a misaligned residual refused; a
   -0.0 input giving the bits of +0.0, with and without ``relu_input``; each GEMM's ``matmul_tile_plan`` and conv's
   ``conv_tile_plan``, both kernels' ``-Xptxas -v`` lines (registers,
   shared memory, spills) and both wrappers' host µs per call, logged;
   ``dequant_dwconv3x3`` at the 6 depthwise stages of that forward and a
   ragged sweep (C of 1, 3, 17, 36, 40, 64, 80, odd grids, a 1x1 image,
   batch 1 and 3), on inputs holding -0.0, NaN and negatives and on an activation
   TMA cannot address: bitwise equal to its plain version, run to run, and
   for the first and the last image alone; each stage's
   ``dwconv_tile_plan``, its ``-Xptxas -v`` lines and the wrapper's host
   µs logged, one kernel per call by the profiler, the kernel, the plain
   version and ``F.conv2d(groups=C)`` on ``relu(x)`` timed per forward
   beside the bound (bytes at 3.35 TB/s);
   ``dequant_codes_group``
   bitwise equal to its plain version at every leaf of the forward's six
   depthwise kernels in one call, of a ragged group, of a group with a
   misaligned leaf, and of one-leaf calls. Per forward: device time
   (profiler) of kernel, plain version and library call (``torch.matmul``
   / ``F.conv2d`` on channels-last input, weights expanded once, TF32 off,
   followed by the epilogue's torch ops; 6 x ``torch.mul(q, s)``), of the
   two contractions without their epilogues and with the torch ops after
   them, CUDA-event times beside them, and the bound (bytes at 3.35 TB/s
   with A and the residual read once, or three bf16 passes at 989 TFLOP/s
   and the epilogue's f32 operations at 67; the f32-FMA bound logged
   beside it);
4. serve at full width (the main path): ``ModelConfig()`` with
   ``ServeConfig(quant="int8", kernel_plane="fused_int8")``, install through
   ``ModelVersionManager.install`` (the quant gate must pass at both
   buckets), then requests through ``MicroBatcher.submit`` (16 at 256^2,
   8 at 128^2, 2 padded) and one tiled 512 x 384 image through
   ``predict_image``, twice. Launch counts are reset right before and read
   right after (15 ``dequant_matmul``, 8 ``dequant_conv3x3``, 6
   ``dequant_dwconv3x3`` and 0 ``dequant_codes`` per forward); fused vs
   reference plane on the probe
   batch; throughput; a profile of one bucket-256 batch: its device busy
   time, its kernels by name and count, and no kernel of the torch ops the
   epilogues replaced (``EPILOGUE_OP_KERNELS``);
5. the fp8 plane: the same with ``kernel_plane="fp8"``, one batch served;
6. ``bce_sums`` vs plain at the train step's logits (16 x 128 x 128), at
   8 x 256 x 256, and over a ragged sweep: count lanes equal, BCE lanes
   within rtol 1e-5 / atol 1e-3, bitwise equal run to run, back to back at
   alternating sizes and on two streams at once, each size's plan
   (``bce_plan``) logged; one kernel per call by the profiler; device time
   (``ms``) and CUDA-event time (``event_ms``) of kernel, plain version and
   ``F.binary_cross_entropy_with_logits`` (``library_ms``,
   ``library_event_ms``), the bound, and the card's launch floor (the
   device time of a one-element ``zero_()``, ``launch_floor_us``, also in
   the ``dequant_codes`` rows);
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
    ``dequant_conv3x3``, 6 ``dequant_dwconv3x3`` and no ``dequant_codes``
    kernel (wrapper counts and profiler). Logged: install ms (gate included);
13. the command lines at full width, one process per client: 129 train
    and 32 eval PNG pairs at 448 px from ``synth_crack_batch`` in a temp
    directory (OpenCV decodes them to 128 px; the reference split leaves
    128, two iid shards of 64), the seeded global as a flax msgpack file;
    ``python -m fedcrack_tpu_torch.server`` (2 rounds, cohort 2,
    ``--init-weights``, ``--state-path``, ``--metrics``, ``--tb-dir``,
    ``--spans-path``, ``--best-path``, ``--eval-*`` over the 32 pairs) and
    two ``python -m fedcrack_tpu_torch.client`` (``--num-clients 2
    --client-index i --transport-dtype uint8``, the second with
    ``--predict-dir``), each through a shim that
    blocks the reference stack and reports its ``bce_sums`` launches at
    exit. Checked: all exit 0; the statefile decodes with two history
    entries and its global is byte-equal to ``cli_in_process_drive`` of
    the same shards, seeds and init; the metrics, TensorBoard (CRCs),
    flush spans and ``best.msgpack``; each process's launches equal its
    train steps plus eval batches; the second client's ``pred_*.png`` and
    ``overlay_*.png`` at 128 px, its logged report equal to
    ``quantify_mask`` over the written masks. Then ``python -m
    fedcrack_tpu_torch.train.centralized --epochs 1`` on the 129 pairs:
    ``final.msgpack`` and ``best.msgpack`` byte-equal to an in-process
    ``train_centralized``, the val loss finite. Logged: each process's
    wall and start-up (to its first launch), the round walls beside phases
    7 and 9, each fit's ms, the decode rate (1, 4 and 8 threads) against
    the step's.
14. the serve command line at full width: ``python -m
    fedcrack_tpu_torch.serve`` through the same shim (it also reports the
    dequant launches and the engines' quantized forwards), with
    ``ModelConfig()``, ``quant="int8"``, ``kernel_plane="fused_int8"``
    (from a ``--config`` file), buckets 128 and 256, 8 lanes, phase 4's
    snapped weights as ``--weights``, ``--replicas 1 --min-replicas 1
    --max-replicas 2``, a ``--state-path`` and ``--port 0``. A client on the
    port's wire codec sends on one Predict stream a 128^2, a 256^2, a
    padded 200 x 180 and two tiled images (200 x 300, 600 x 400) in CRC32C
    chunks and one with a wrong CRC (REJECTED with the JAX title); each OK
    mask byte-equal to an in-process engine on the card, and away from the
    threshold to a CPU engine. Then per-bucket latency, bursts on 16
    streams until the autoscaler scales up (read from ``--metrics-port``),
    and a 512 x 768 StreamPredict session: a first frame (full re-run),
    the same frame (0 tiles), a moved band (some tiles), three repeats (0
    tiles); version 2 (seed 1, snapped) published to the statefile, served
    on the first frame after (a full re-run), the band and three repeats;
    every frame byte-equal to Predict of the same image at its version,
    versions never going back. The autoscaler ticks every 0.05 s. Before
    the stream, one tile's probabilities must be bitwise the same in lane
    0 and lane 5 of a batch on the card and beside zero lanes (the
    sessions pack their misses on this), and the same frames are timed
    through a StreamSession in this process. At
    SIGTERM: exit 0, both gates passed, at least one scale-up, no failed
    or shed request, every live replica at version 2, dequant launches 15
    / 8 / 6 / 0 per quantized forward. Logged: the latencies, the frames, the
    swap's pause, start-up and wall.
15. progressive delivery under load: ``python -m fedcrack_tpu_torch.serve``
    through the shim at phase 14's config, weights and buckets, one
    replica, a ``--state-path`` and ``--shadow-fraction 0.5`` (the shadow
    controller runs the statefile poll every 0.1 s), and
    ``python -m fedcrack_tpu_torch.tools.load_gen`` against it: a closed
    loop of 4 streams, 1,600 requests at 128^2 and 256^2, ``--out-dir``,
    ``--metrics-url`` and ``--swap-statefile`` publishing its seeded init
    as version 3 after 400 answers. Once traffic flows the smoke publishes
    version 2, production with one BatchNorm bias moved by 1e-3. Checked:
    version 2 promoted (IoU >= 0.98, PSI <= 0.25, shadow p95 <= 3x
    production's) and version 3 rolled back on the canary IoU and never
    staged again; both verdicts' PSI carry ``crack_fraction``; no response
    stamped 3, sampled masks byte-equal to the card engine in process at
    their stamped version; ``serve_stats["shadow"]`` staged 2, promoted 1,
    rolled back 1, mirrored requests and no shadow failure; each verdict's
    IoU and PSI equal to the same probes on the card in process, and within
    the flip bound of a CPU engine's (``check_flip_bound``) with the same
    verdict; 15 / 8 / 6 / 0 dequant launches per quantized forward, probe
    forwards included; ``python -m fedcrack_tpu_torch.tools.quantify
    --pred-dir`` over the served masks equal to ``quantify_mask``. Logged:
    the probe's crack share, publish to served and to each verdict, the
    verdicts, load_gen's summary, start-up and wall.

16. the privacy plane and the round checkpointer at phase 7's width,
    over loopback gRPC with port peers only. (a) Phase 9's federation with
    update-level DP on both clients (the client command line's
    ``private_train_fn``: clip 0.01, noise multiplier 0.5, seed 11) and
    the server's accountant (4 steps a round, q = 16 / 64), the server
    evaluating each global: every upload byte-equal to ``dp_update_host``
    of the (trained, base) pair its client fitted, each round's epsilon
    equal to ``compute_epsilon``, the privacy summary clean under
    ``tools/health_report``, ``bce_sums`` launches equal to train steps
    plus eval batches. (b) Secure aggregation: three clients enroll with
    their seeds, two fit and upload masked trees, the third announces,
    uploads its plaintext (REJECTED) and stops; the 10 s deadline closes
    the round on the two, the dropped masks recovered from the seeds; the
    global bit-equal to the survivors' fixed-point mean computed from
    their plaintext fits and to the unmask of their uploads, and within
    the fixed-point step of their float FedAvg. (c) A ``FedServer`` with
    a ``FedCheckpointer`` runs round 1 and is stopped; a new one resumes
    at round 2 with round 1's global and runs round 2; a fused_int8
    ``ModelVersionManager(ckpt_dir=)`` installs version 2 (the gate must
    pass) and serves one bucket-256 batch with 15 / 8 / 6 / 0 dequant launches
    (wrappers and profiler), within phase 4's limit of a CPU engine.
    Logged: walls, epsilons, host DP, masking and unmasking ms, the
    masked-to-plain wire ratio, checkpoint save and restore ms.
17. the chaos plane, bf16 compute and the watch layer. (a) Phase 7's
    model and data cut into three clients of 32 samples over loopback
    gRPC with ``FedClient(chaos=ClientChaos(plan))`` and a 5 s round
    deadline, the server a recording ``FedServer``: federation A (raw
    msgpack) rides out a two-call network flap in round 1, then rejects a
    NaN upload ("non-finite", never averaged) while a crash before upload
    leaves the deadline to close round 2 on the survivor; federation B
    (int8 frames, a statefile) rejects a frame with a flipped bit on its
    CRC, then is killed (``ServerThread.kill``) with round 2 half
    received and restarted from the statefile on the same port, which must
    resume that round. Checked: each history entry's clients and rejected
    clients (with a fragment of the reason) as the plans predict, every
    session's outcome, each round's global and every reply byte-equal to
    ``fed.rounds.transition`` fed the same wire bytes, ``bce_sums``
    launches equal to the steps plus the eval batches. (b) A fused_int8
    ``MicroBatcher`` with ``ServeChaos``: a device loss on batch 0
    (retried, nothing dropped), version 2 installed under batch 1 after
    its snapshot (it answers from version 1), batch 2 on version 2; a
    two-replica ``ServeFleet(chaos=)`` taking a device loss, a grown slot
    carrying the hook; a ``StreamSession`` with a ``StreamChaos`` reset,
    each frame byte-equal to ``predict_tiled``; masks byte-equal to the
    card engine at each batch's version, 15 / 8 / 6 / 0 dequant launches per
    quantized forward, the gates' included. (c) bf16 at c5's shapes
    (``ModelConfig(compute_dtype="bfloat16")``, 256 px, batch 32): a fit
    and an eval batch through ``bce_sums``, float32 leaves; one card step
    against a CPU step at 256 px batch 4 within the bounds
    ``check_bf16_step`` derives; train and reference-program throughput
    beside float32; ``python -m fedcrack_tpu_torch.serve --compute-dtype
    bfloat16`` at ``--quant none`` and at ``--quant int8 --kernel-plane
    fused_int8`` (on the fit's weights: the gate passes, 15 / 8 / 6 / 0
    launches per forward), masks held to the card engine in process. (d)
    A ``LeakSentry`` marked after (a)-(c) and steady after 10 bf16 steps
    and 4 fused batches; a ``Watchdog`` on ``configs/slo_default.json``
    over the bf16 serve process's ``/metrics`` with no breach; and
    ``tools.trace_stitch`` over federation B's span file and that of a
    manager that installs its last global from the statefile and serves
    one batch: one complete client -> fed -> serve chain.
18. the hierarchical aggregation tree and the chaos drills at phase 7's
    width. (a) The main path: ``fed.tree.run_tree_federation`` over eight
    leaves of 32 seeded synthetic samples, four a round from
    ``sample_cohort(8, 4, r, 18)``, two edges, two rounds, each leaf one
    local fit on the card from its base blob (recorded), the final global
    evaluated on 32 held-out samples: ``bce_sums`` launches equal to the
    leaf steps plus the eval batches, the root's and the edges' peak
    blobs within the edge count and the leaf fan-in, each round's global
    within ``fold_bound`` (derived in its docstring) of the flat FedAvg of
    its recorded leaves, and the tree re-run over the recorded blobs
    giving the same ``global_sha256``. (b) The same rounds over loopback
    gRPC: a port ``FedServer`` root (``cohort_size=2``), one
    ``EdgeRelay`` per edge, ``edge-0`` killed after its first leaf by a
    ``FaultPlan`` ``EDGE_AGGREGATOR_CRASH`` and restored from its
    statefile; its partial byte-equal to an unkilled edge's, each root
    global byte-equal to the in-process tree's. (c) The final global
    served ``fused_int8`` at bucket 128, batch 8: 15 / 8 / 6 / 0 dequant
    launches (wrappers and profiler), fused within ``SERVE_PROB_TOL`` of
    the reference plane. (d) ``python -m fedcrack_tpu_torch.tools.chaos_drill``
    through ``CLI_SHIM``: exit 0, every verdict of its eleven drills true,
    ``dp_replay`` recorded as not ported. Logged: root bytes against flat
    bytes, the edge's restore and recover seconds, the drills' timings,
    the phase's wall.
19. several clients per round on one card at phase 7's width: 4 slots, 2
    rounds x 2 epochs x 2 steps through ``parallel.run_mesh_federation``
    (the main path, each slot bit-equal to a host fit), then the
    sequential, segmented, resident, cohort, codec and DP-under-chaos runs
    bit-equal to it, the global served ``fused_int8`` and
    ``tools.refscale_federation`` as a process.
20. a client's step split into shards with sync-BN, at full width. (a)
    ``build_spatial_predict`` at S = 4 on two 1024 x 256 images against
    the single-device forward (f32, TF32 off): the probabilities within
    ``SERVE_PROB_TOL``, mask flips within the flip bound; S = 1, S = 4 and
    the single-device forward timed. (b) One ``build_spatial_train_step``
    step at S = 4 with SGD(1.0) against the single-device ``train_step``:
    per leaf ||d|| <= 5e-3 ||ref|| + 1e-5, the statistics within rtol
    1e-4, one ``bce_sums`` launch (wrapper and profiler). (c) The main
    path: ``build_spatial_federated_round`` over 2 clients x 2 bands, 2
    rounds x 2 steps of 2 images at 512 x 256, 8 launches, each round's
    global within atol 1e-4 (BN-fed biases 5e-3) of the (2, 1) round's,
    served ``fused_int8`` at 15 / 8 / 6 / 0. (d) ``round_from_config`` on
    ``configs/c5_bf16_batch_dp.json``'s (4, 2) mesh at 128 px, batch 16:
    within atol 5e-5 of the (4, 1) round in float32, finite in bfloat16.
    (e) ``python -m fedcrack_tpu_torch.tools.measure_baseline`` over c1,
    c2, c3 and c5 at a scaled workload: exit 0, four rows with the JAX
    rows' keys, the card's name in ``hardware``.
21. two processes sharing the card, joined by ``parallel.multihost``
    over gloo (a ``file://`` store in a temp dir), each this script as
    ``--multihost-worker`` through ``CLI_SHIM``. (a) Phase 19's main round
    (4 slots, 2 rounds x 2 epochs x 2 steps at 128 px batch 16) with two
    slots per process, null and int8: every round's global and metrics
    bit-equal on both ranks and to the same round in this process, 16
    ``bce_sums`` launches per process per build. (b) Phase 20's 2 x 1024 x
    256 images at S = 4, two bands per process: the predict within 1e-5 of
    the one-process S = 4 predict with no mask flip; one SGD(1.0) step
    against the one-process S = 4 step by phase 20's criteria, the
    stepped weights bit-equal on both ranks, one launch per process. (c)
    The two-process global served ``fused_int8`` at 15 / 8 / 6 / 0. (d) The
    cohort round at 128 px, batch 16: six clients in groups of four (the
    last ragged), streamed and resident, two slots of every group per
    process (its padding slots on rank 1): every global and metric
    bit-equal on both ranks and to the same cohort in this process, 8
    ``bce_sums`` launches per process per run. Logged: the round walls and
    the gather beside phase 19's, the predict and step times with their
    host-staged exchanges beside phase 20's, the cohort's walls.
22. ``configs/c6_s2d_layout.json`` on the card: c6's 8 slots, bfloat16,
    ``s2d`` stem and ``packed`` residuals at ``ModelConfig()``'s widths,
    128 px, batch 16, through ``parallel.round_from_config`` and
    ``run_mesh_federation``, cut to 32 samples a client (256 of 6,213),
    1 local epoch (of 10) and 2 rounds (of 5). (a) The main path three
    ways, images packed on the device, pre-packed by
    ``space_to_depth_images``, resident from ``SamplePool(layout="s2d")``:
    bit-equal, 32 ``bce_sums`` launches a run. (b) The reference layouts'
    round: bit-equal, or every parameter within Adam's per-step bound
    (logged which). (c) The global on the reference plane, float32 and
    int8 at buckets 128 and 256, ``max_batch`` 8, held to a
    reference-layout engine by ``check_flip_bound``; images/s. (d)
    ``fused_int8`` and ``fp8`` refuse the layouts with the JAX message. (e)
    At 2 x 128 x 128, float32: packed input ``torch.equal`` to unpacked for
    ``s2d`` and ``s2d_full``; ``s2d_full`` within atol and rtol 1e-4 of the
    reference layout; ``s2d`` + ``packed`` bit-equal or within it (logged).
    (f) Where ``h5py`` is installed, ``tools.h5_export`` then
    ``tools.h5_import`` byte-equal, served once; else logged as not run.
23. the concurrent soak and fedlint. (a) ``tools.soak.run_soak`` on the
    card at the JAX soak's shape (its tiny model, 8 s of traffic): a
    buffered federation of three gRPC clients and an edge shard under a
    straggler storm, poisons and a root kill -> restart, the reference
    serve plane (bucket 16, batch 4) hot-swapping off the live statefile
    with the canary and drift probes, a driver leg and the EF twin; the
    audit clean by tests/test_telemetry.py's ``_assert_soak_clean`` (no
    recompile arm), a swap and the kill; every engine forward on CUDA
    (engine, weights, device 0 in every thread), no kernel launched.
    (b) The same at ``ModelConfig()``'s widths (img_size 32) for 20 s
    with the RSS slack derived from ``SOAK_LIVE_TREES``. (c) ``python -m
    fedcrack_tpu_torch.tools.soak --duration 5 --out F`` through
    ``CLI_SHIM``: exit 0, a clean artifact, no launch. (d) ``python -m
    fedcrack_tpu_torch.tools.fedlint fedcrack_tpu_torch --baseline
    fedlint_torch_baseline.json``: exit 0, no finding, the lock graph's
    nodes and cycles equal to ``analysis/serve_lock_graph.json``. Logged:
    requests, flushes, swaps, p50 / p99, planes, RSS and device
    watermarks, the root's wire bytes, walls.
24. the FLOPs model, a profiled round and the ``bce_sums`` A/B, through
    each tool's ``main`` in this process. (a) ``obs.flops`` equals the JAX
    package's counts at three configs (``FLOPS_WANT``), and
    ``device_peak_flops`` knows the card (logged beside its name and power
    limit). (b) ``python -m fedcrack_tpu_torch.tools.profile_step`` at 256
    px, bfloat16, batch 16, 8 steps x 2 rounds: ``kernel_stats`` present,
    the category fractions summing to 1 +- 0.02, exactly 16
    ``bce_sums_kernel`` records (the artifact's
    ``kernel_stats["bce_sums_records"]``; the window retaken once if it
    lost records), 32 launches counted by the wrapper from 0,
    the profiled device time a round within the round's wall, 0 <
    ``naive_mfu`` <= 1. (c) ``python -m fedcrack_tpu_torch.tools.ab_bce`` at
    128 and 256 px, bfloat16, batch 16, 8 steps, 3 reps, fit factor 4,
    both arms: ``bce_sums`` launches, counted from 0, exactly the cuda
    arm's 400 steps (warm-up and timed), none from the plain arm; both arms' metrics on
    the first step's logits within phase 6's tolerance, count lanes exact.
    Logged: the FLOPs, the peak, the category split, both arms'
    ``per_step_ms`` and MFU, the speedup.

25. the train step's CUDA graph (``train.local.StepGraphs``) at the
    benchmark cell's round shape: 8 slots x 2 steps x batch 16 at 256 px,
    float32. From one start, two rounds through the slot plane on the graph
    path and two with ``forward`` set (eager, the same arithmetic): each
    slot's weights and statistics, every step's Adam moments, the globals
    and the metrics bit-equal; ``bce_sums`` launches 32 on each; the
    counter's paths 1 eager, 1 capture, 30 replays against 32 eager. A
    third graphed round under ``torch.cuda.set_sync_debug_mode("warn")``
    makes no synchronizing call (two synchronizing copies as the
    control); a profiled graphed round holds a ``bce_sums_kernel`` record
    for each of its 16 steps; the released rounds leave at most 64 MB
    allocated. Logged: both rounds' walls in turns, the peak memory.

26. SegFormer-B5 (``configs.SegFormerConfig()``, every published width,
    all 52 blocks) on the slot plane at 1024 x 1024: 2 slots x 2 steps x
    batch 2, float32. From one start, a round with ``forward`` set (eager)
    and two rounds on the graph path (the first warms up, captures and
    replays, the second replays only): the globals, each slot's trained
    weights and statistics and the metrics of all three bit-equal;
    ``train_attention_total`` counts 3 / 6 / 40 / 3 ``composed`` calls by
    stage on every step of each round; ``bce_sums`` launches equal to the
    steps. Logged: the step paths, the rounds' walls, the peak memory.

``python3 chip_smoke.py --step-graph`` builds ``bce_sums.cu`` and runs
only phase 25; ``--segformer`` builds it and runs only phase 26.

``python3 chip_smoke.py --serve-ticks 0.05,1.0,1.0,0.05`` builds
``dequant.cu`` and runs only phase 14, once per autoscaler tick given, and
prints one ``TICK`` JSON line per run (the frames served and in process,
the autoscaler's audit, the phase's seconds).

Before phase 2, ``main`` logs which of jax, flax, optax, msgpack,
ml_dtypes, grpc, google (protobuf) and ``fedcrack_tpu`` the machine has,
and blocks all but grpc in ``sys.modules``: the codec, gate, ledger,
robust folds, FedOpt and the transport's wire codec run without them.

The last three lines: the card's name and power limit, the per-kernel JSON
object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import signal
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
# N = 1, and M, K, N that are multiples of no tile; then shapes whose plans
# take the wide tiles raggedly: TMA loads and stores with every block
# changing column block (30000 x 64 -> 200), TMA loads and stores from
# registers (-> 66), and the cp.async ring at BM 128 (K = 33) and BM 64 (K = 50).
MATMUL_SWEEP = SWEEP_SHAPES + [(1000, 27, 1), (129, 36, 33), (70, 2304, 257), (300, 20, 8),
                               (30000, 64, 200), (20000, 36, 66), (9000, 33, 18), (2500, 50, 130)]
# Ragged convs (N, H, W, C, F): odd grids, a 1x1 image, C and F off every tile.
CONV_SWEEP = [(1, 5, 7, 8, 12), (2, 6, 6, 4, 9), (1, 1, 1, 4, 3), (3, 9, 11, 36, 17),
              (2, 17, 13, 132, 40), (1, 33, 31, 64, 129)]
BUCKET, BATCH = 256, 8
# How often a card_profile window (fedcrack_tpu_torch.obs.metrics) that
# lost kernel records is taken again before a count check fails.
PROFILE_TRIES = 3
# The largest probability difference allowed between a served batch and
# the same weights through another plane or on the CPU (phases 4, 5, 12).
SERVE_PROB_TOL = 1e-3
# The training path: the reference's client shape, and the JAX kernel
# test's ragged sizes for bce_sums.
TRAIN_SIZE, TRAIN_BATCH = 128, 16
BCE_SWEEP = [1, 100, 128, 32768, 32769, 100_000]
# Ragged depthwise convs (N, H, W, C): C of 1, 3 and 17 (no TMA map: the
# producer loads the halo itself), 36, 40, 64 and 80 (TMA, C off the unit's
# 32 or 64 channels), odd grids, a 1x1 image, batch 1 and 3; and shapes
# whose plans take 8- and 16-row tiles of 32 and 64 channels raggedly.
DW_SWEEP = [(1, 5, 7, 1), (3, 9, 11, 3), (1, 1, 1, 17), (3, 13, 17, 40), (1, 33, 31, 64), (3, 1, 1, 36),
            (8, 70, 130, 40), (8, 70, 40, 64), (6, 50, 70, 80)]
# The quantized forward's kernel wrappers, as they count their launches.
DEQUANT_KERNELS = ("dequant_matmul", "dequant_conv3x3", "dequant_dwconv3x3", "dequant_codes")
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


def dwconv_shapes(cfg, size: int, batch: int) -> list[tuple[str, int, int, int, int]]:
    """(layer, N, H, W, C) of every dequant_dwconv3x3 of the fused forward:
    each encoder block's sep1 and sep2."""
    shapes, g, cin = [], -(-size // 2), cfg.stem_features
    for i, f in enumerate(cfg.encoder_features):
        shapes.append((f"enc{i}_sep1", batch, g, g, cin))
        shapes.append((f"enc{i}_sep2", batch, g, g, f))
        g = -(-g // 2)
        cin = f
    return shapes


def forward_launches(cfg) -> dict:
    """Each dequant wrapper's launches in one fused forward of ``cfg``
    (15 / 8 / 6 / 0 at ``ModelConfig()``): the depthwise stages expand
    their codes inside ``dequant_dwconv3x3``, so ``dequant_codes`` is not
    launched."""
    return {"dequant_matmul": len(matmul_shapes(cfg, BUCKET, BATCH)),
            "dequant_conv3x3": len(conv_shapes(cfg, BUCKET, BATCH)),
            "dequant_dwconv3x3": len(dwconv_shapes(cfg, BUCKET, BATCH)), "dequant_codes": 0}


def depthwise_shapes(cfg) -> list[tuple[int, int, int, int]]:
    """Shape of every depthwise kernel of the fused forward (two per
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
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile, lead_kept

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(PROFILE_TRIES):
        with card_profile() as prof:
            for _ in range(n):
                for fn in fns:
                    fn()
        kernels = card_kernels(prof)
        count = sum(e.count for e in kernels)
        if count and (count == n * launches if launches is not None else count in counts):
            return sum(e.self_device_time_total for e in kernels) / n / 1e3
        counts.append(count)
        if launches is not None or len(counts) > 1:  # an unknown count needs two windows anyway
            log(f"profile retaken: {count} kernel records (want {launches} x {n})")
    raise AssertionError(f"the profiler's kernel counts disagree: {counts} (want {launches} x {n}); "
                         f"{lead_kept()}")


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


def forward_epilogue(layer: str) -> dict:
    """What the fused forward's launch at ``layer`` (a name of
    ``matmul_shapes`` or ``conv_shapes``) does after the scale besides its
    bias: a BatchNorm (the stem, the encoder's pointwise convs, the decoder
    convs), a ReLU after it (the stem, each decoder block's first conv), a
    residual add (the residual convs) and the ReLU of its input (each
    decoder block's first conv)."""
    return {"bn": layer == "stem_conv" or "_sep" in layer or "_convT" in layer,
            "relu": layer == "stem_conv" or layer.endswith("_convT1"),
            "residual": layer.endswith("_res"), "relu_input": layer.endswith("_convT1")}


def make_epilogue(torch, gen, n: int, bn: bool, relu: bool):
    """A seeded ``dequant.Epilogue`` of ``n`` channels: a bias, a BatchNorm
    where asked (running mean, a variance in [0.5, 1.5), scale and bias;
    its ``inv`` computed as the forward's plan computes it) and a ReLU
    where asked."""
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.models.resunet import BN_EPSILON

    dev = torch.device("cuda")

    def vec(std):
        return torch.randn(n, generator=gen, device=dev) * std

    vectors = None
    if bn:
        var = torch.rand(n, generator=gen, device=dev) + 0.5
        vectors = (vec(0.1), vec(1.0) * torch.rsqrt(var + BN_EPSILON), vec(0.1))
    return dequant.Epilogue(bias=vec(0.1), bn=vectors, relu=relu)


def epilogue_text(kw: dict) -> str:
    """The steps a launch's keyword arguments fuse, as text."""
    epi, parts = kw.get("epilogue"), []
    if epi is not None:
        parts += ["bias"] + ["bn"] * (epi.bn is not None) + ["relu"] * epi.relu
    parts += ["residual"] * (kw.get("residual") is not None) + ["relu_input"] * bool(kw.get("relu_input"))
    return "+".join(parts) or "no epilogue"


def epilogue_f32_ops(kw: dict, outputs: int) -> int:
    """The f32 operations of a launch's epilogue: the scale's multiply and
    one a step (three for the BatchNorm) an output."""
    epi = kw.get("epilogue")
    per = 1 + (kw.get("residual") is not None)
    if epi is not None:
        per += 1 + 3 * (epi.bn is not None) + epi.relu
    return per * outputs


def unfused_args(torch, args, kw: dict) -> tuple:
    """The launch's positional arguments for the kernel without its
    epilogue: ``relu_input``'s ReLU taken first, by torch."""
    return (torch.relu(args[0]),) + tuple(args[1:]) if kw.get("relu_input") else tuple(args)


def unfused(torch, kernel, args, kw: dict):
    """The launch without its epilogue, then the torch ops the epilogue
    stands for: what the forward ran before the epilogues were fused."""
    from fedcrack_tpu_torch.kernels import dequant

    return dequant._torch_epilogue(kernel(*unfused_args(torch, args, kw)), kw.get("epilogue"), kw.get("residual"))


def check_fused(torch, label: str, kernel, args, kw: dict):
    """The launch with its epilogue bit for bit equal to :func:`unfused`
    on the card and to itself run to run; returns its output."""
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    want = unfused(torch, kernel, args, kw)
    torch.cuda.synchronize()
    if not same_floats(torch, got, want):
        diff = got.view(torch.int32) != want.view(torch.int32)
        raise AssertionError(
            f"{label} ({epilogue_text(kw)}): {int(diff.sum())} of {got.numel()} outputs differ from the kernel "
            f"without its epilogue followed by the torch ops, max |diff| "
            f"{float((got - want).abs().nan_to_num().max()):.3g}")
    if not same_floats(torch, got, again):
        raise AssertionError(f"{label} ({epilogue_text(kw)}): not bitwise equal run to run")
    return got


def time_cases(torch, card: str, name: str, kernel, plain, library: str, cases) -> dict:
    """Times of one forward's launches of a dequant kernel, each with the
    epilogue the forward gives it. Per shape, CUDA events over back-to-back
    calls (host-inclusive: at tens of microseconds they time the wrapper as
    much as the kernel); per forward, device time from the profiler for the
    kernel, its plain version, the library call followed by the torch ops
    the epilogue stands for (``library_ms``), and the kernel without its
    epilogue (``unfused_ms``) and with those ops after it
    (``unfused_ops_ms``, the forward before the epilogues). Each case:
    (layer, shape text, args, keyword args, library closure, bytes,
    tensor-core operations, f32 operations). The bound adds the f32
    operations' time at the f32 rate to the tensor cores'."""
    row = {"event_ms": 0.0, "plain_event_ms": 0.0, "library_event_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "fp32_bound_ms": 0.0}
    for layer, shape, args, kw, lib, n_bytes, n_flops, n_f32 in cases:
        t_k = cuda_ms(torch, lambda: kernel(*args, **kw))
        t_p = cuda_ms(torch, lambda: plain(*args, **kw))
        t_l = cuda_ms(torch, lib)
        ops_ms = (BF16_PASSES * n_flops / BF16_TC_FLOPS_PER_S + n_f32 / FP32_FLOPS_PER_S) * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
        f_ms, _ = bound_ms(n_bytes, n_flops + n_f32)
        row["event_ms"] += t_k
        row["plain_event_ms"] += t_p
        row["library_event_ms"] += t_l
        row["bound_ms"] += b_ms
        row["fp32_bound_ms"] += f_ms
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
        log(f"{name} {layer} {shape} {epilogue_text(kw)}: events kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"{library} {t_l:.4f} ms; bound {b_ms:.4f} ms ({b_by}), f32-FMA bound {f_ms:.4f} ms [{card}]")
    row["ms"] = device_ms(torch, [lambda a=args, k=kw: kernel(*a, **k) for _, _, args, kw, *_ in cases],
                          launches=len(cases))
    row["plain_ms"] = device_ms(torch, [lambda a=args, k=kw: plain(*a, **k) for _, _, args, kw, *_ in cases])
    row["library_ms"] = device_ms(torch, [lib for _, _, _, _, lib, *_ in cases])
    row["unfused_ms"] = device_ms(torch, [lambda a=unfused_args(torch, args, kw): kernel(*a)
                                          for _, _, args, kw, *_ in cases], launches=len(cases))
    row["unfused_ops_ms"] = device_ms(torch, [lambda a=args, k=kw: unfused(torch, kernel, a, k)
                                              for _, _, args, kw, *_ in cases])
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
    log(f"{name} one forward ({len(cases)} launches with their epilogues), device time: kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, {library} and the epilogue's torch ops {row['library_ms']:.4f} ms; "
        f"the kernel without its epilogue {row['unfused_ms']:.4f} ms, with the torch ops after it "
        f"{row['unfused_ops_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
        f"{row['bytes_ms']:.4f}, bf16 x{BF16_PASSES} and the epilogue's f32 {row['ops_ms']:.4f}), f32-FMA bound "
        f"{row['fp32_bound_ms']:.4f} ms; CUDA events: kernel {row['event_ms']:.4f} ms, plain "
        f"{row['plain_event_ms']:.4f} ms, {library} {row['library_event_ms']:.4f} ms [{card}]")
    return row


def ptxas_lines(build_log: str, kernel: str) -> list[str]:
    """``-Xptxas -v``'s report for each instantiation of ``kernel``, one line
    each: its template arguments (from the mangled name), registers,
    barriers, stack and spills."""
    import re

    out, current = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = None
            if kernel in name:
                args = re.match(r"I(a|13__nv_fp8_e4m3)((?:Li\d+E)*)", name[name.index(kernel) + len(kernel):])
                params = ["int8" if args.group(1) == "a" else "e4m3"] + re.findall(r"Li(\d+)E", args.group(2))
                current = f"{kernel}<{', '.join(params)}>:"
                out.append(current)
        elif current is not None and ("spill" in line or "Used" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip() if "Used" in line else " " + line.strip() + ";"
    return out


def wrapper_host_us(torch, kernel, calls_at, calls: int = 200, runs: int = 5) -> dict:
    """Host µs per call of a kernel's wrapper at each ``(layer, args,
    keyword args)`` of ``calls_at``: the
    least of ``runs`` walls of ``calls`` back-to-back calls, the device
    synchronised before and after each run (its queue can take them all)."""
    out = {}
    for layer, args, kw in calls_at:
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                kernel(*args, **kw)
            walls.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[layer] = min(walls)
    return out


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

        # dequant_matmul: the 15 GEMMs of a forward, then the ragged sweep;
        # without an epilogue against the plain version, then with the
        # forward's epilogue at its layers (its mixes in turn on the sweep)
        # bit for bit against the same kernel followed by the epilogue's
        # torch ops.
        name = f"dequant_matmul[{flavor}]"
        cases, errs = [], [0.0, 0.0]
        main = matmul_shapes(cfg, BUCKET, BATCH)
        for i, (layer, m, k, n) in enumerate(main + [(f"sweep{s}", *s) for s in MATMUL_SWEEP]):
            x = torch.randn((m, k), generator=gen, device=dev)
            q, s = codes((k, n))
            rows_part = m // 3 + 1
            err = check_against_plain(torch, f"{name} {layer}", dequant.dequant_matmul,
                                      dequant._dequant_matmul_plain, (x, q, s), s,
                                      ((x[:rows_part].contiguous(), q, s), rows_part))
            errs = [max(a, b) for a, b in zip(errs, err)]
            sweep = layer.startswith("sweep")
            steps = (dict(zip(("bn", "relu", "residual"), MATMUL_MIXES[i % len(MATMUL_MIXES)])) if sweep
                     else forward_epilogue(layer))
            kw = {"epilogue": make_epilogue(torch, gen, n, steps["bn"], steps["relu"])}
            if steps["residual"]:
                kw["residual"] = torch.randn((m, n), generator=gen, device=dev)
            y = check_fused(torch, f"{name} {layer}", dequant.dequant_matmul, (x, q, s), kw)
            part_kw = dict(kw, **({"residual": kw["residual"][:rows_part]} if steps["residual"] else {}))
            if not same_floats(torch, dequant.dequant_matmul(x[:rows_part].contiguous(), q, s, **part_kw),
                               y[:rows_part]):
                raise AssertionError(f"{name} {layer}: with its epilogue, the leading rows change with the M")
            if not sweep:
                wd = q.float() * s
                vectors = 1 + 3 * steps["bn"]
                cases.append((layer, f"M={m} K={k} N={n}", (x, q, s), kw,
                              lambda x=x, wd=wd, kw=kw: dequant._torch_epilogue(
                                  torch.matmul(x, wd), kw["epilogue"], kw.get("residual")),
                              4 * m * k + k * n + 4 * n + 4 * m * n * (1 + steps["residual"]) + 4 * n * vectors,
                              2 * m * k * n, epilogue_f32_ops(kw, m * n)))
        fused = matmul_epilogue_sweep(torch, name, codes, gen)
        log(f"{name}: {len(main)} main-path GEMMs and {len(MATMUL_SWEEP)} ragged within the per-channel bound, "
            f"bitwise repeatable; max |kernel - plain| {errs[0]:.3g}, max |kernel - plain| / scale {errs[1]:.3g}; "
            f"with epilogues ({len(main)} as the forward's, {len(MATMUL_SWEEP)} ragged with its mixes, {fused} more "
            f"step subsets and -0.0 / NaN inputs) bitwise equal to the kernel followed by the torch ops, and over "
            f"fewer rows")
        for layer, m, k, n in main:
            log(f"{name} {layer} tile plan {dequant.matmul_tile_plan(m, k, n)}")
        rows[name] = time_cases(torch, card, name, dequant.dequant_matmul, dequant._dequant_matmul_plain,
                                "torch.matmul", cases)
        rows[name].update(max_abs_err=errs[0], max_err_over_scale=errs[1],
                          host_us=wrapper_host_us(torch, dequant.dequant_matmul, [c[:1] + c[2:4] for c in cases]))
        log(f"{name} wrapper host µs per call (min of 5 runs of 200 back-to-back calls per layer): "
            f"{json.dumps(rows[name]['host_us'])} [{card}]")

        # dequant_conv3x3: the 8 decoder convs of a forward, then the ragged
        # sweep; checked as the GEMM is, the last image alone equal to it in
        # the batch with and without the epilogue.
        name = f"dequant_conv3x3[{flavor}]"
        cases, errs = [], [0.0, 0.0]
        main = conv_shapes(cfg, BUCKET, BATCH)
        for i, (layer, n_img, h, w, c, f) in enumerate(main + [(f"sweep{s}", *s) for s in CONV_SWEEP]):
            x = torch.randn((n_img, h, w, c), generator=gen, device=dev)
            q, s = codes((3, 3, c, f))
            part = ((x[:1].contiguous(), q, s), 1) if n_img > 1 else None
            err = check_against_plain(torch, f"{name} {layer}", dequant.dequant_conv3x3,
                                      dequant._dequant_conv3x3_plain, (x, q, s), s, part)
            errs = [max(a, b) for a, b in zip(errs, err)]
            if n_img > 1 and not torch.equal(dequant.dequant_conv3x3(x[-1:].contiguous(), q, s),
                                             dequant.dequant_conv3x3(x, q, s)[-1:]):
                raise AssertionError(f"{name} {layer}: the last image alone differs from it in the batch")
            sweep = layer.startswith("sweep")
            steps = ({"relu": CONV_MIXES[i % len(CONV_MIXES)], "relu_input": i % 2 == 0} if sweep
                     else forward_epilogue(layer))
            kw = {"epilogue": make_epilogue(torch, gen, f, True, steps["relu"]), "relu_input": steps["relu_input"]}
            y = check_fused(torch, f"{name} {layer}", dequant.dequant_conv3x3, (x, q, s), kw)
            if n_img > 1:
                if not same_floats(torch, dequant.dequant_conv3x3(x[-1:].contiguous(), q, s, **kw), y[-1:]):
                    raise AssertionError(f"{name} {layer}: with its epilogue, the last image alone differs from it "
                                         f"in the batch")
            if not sweep:
                # cuDNN on the channels-last view of the same NHWC tensor, f32 weights expanded once,
                # then the torch ops the epilogue stands for on the NHWC view of its output.
                w_oihw = (q.float() * s).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                x_nchw = x.permute(0, 3, 1, 2)
                pixels = n_img * h * w

                def library(x_nchw=x_nchw, w_oihw=w_oihw, kw=kw):
                    xin = torch.relu(x_nchw) if kw["relu_input"] else x_nchw
                    out = F.conv2d(xin, w_oihw, padding=1).permute(0, 2, 3, 1)
                    return dequant._torch_epilogue(out, kw["epilogue"], None)

                cases.append((layer, f"N={n_img} H={h} W={w} C={c} F={f}", (x, q, s), kw, library,
                              4 * pixels * c + 9 * c * f + 4 * f + 4 * pixels * f + 4 * f * 4,
                              2 * pixels * 9 * c * f, epilogue_f32_ops(kw, pixels * f)))
        fused = conv_epilogue_sweep(torch, name, codes, gen)
        log(f"{name}: {len(main)} main-path convs and {len(CONV_SWEEP)} ragged within the per-channel bound, "
            f"bitwise repeatable, an image alone equal to it in the batch; max |kernel - plain| {errs[0]:.3g}, "
            f"max |kernel - plain| / scale {errs[1]:.3g}; with epilogues ({len(main)} as the forward's, "
            f"{len(CONV_SWEEP)} ragged with its mixes and relu_input, {fused} more cases: the mixes, -0.0 and "
            f"NaN inputs, relu_input on -0.0) bitwise equal to the kernel followed by the torch ops, the last image "
            f"alone equal to it in the batch")
        for layer, *shape in main:
            log(f"{name} {layer} tile plan {dequant.conv_tile_plan(*shape)}")
        rows[name] = time_cases(torch, card, name, dequant.dequant_conv3x3, dequant._dequant_conv3x3_plain,
                                "F.conv2d(channels_last)", cases)
        rows[name].update(max_abs_err=errs[0], max_err_over_scale=errs[1],
                          host_us=wrapper_host_us(torch, dequant.dequant_conv3x3, [c[:1] + c[2:4] for c in cases]))
        log(f"{name} wrapper host µs per call (min of 5 runs of 200 back-to-back calls per layer): "
            f"{json.dumps(rows[name]['host_us'])} [{card}]")

        # dequant_dwconv3x3: bitwise, the 6 depthwise stages of a forward, then the ragged sweep.
        name = f"dequant_dwconv3x3[{flavor}]"
        rows[name] = dwconv_case(torch, card, name, codes, gen, cfg)

        # dequant_codes: bitwise, grouped as the port's dequant_codes API calls it.
        name = f"dequant_codes[{flavor}]"
        rows[name] = codes_case(torch, card, name, flavor, codes, cfg)
    return rows


# The mixes of the forward's fused launches, each after the conv's bias:
# the GEMM's (BatchNorm, ReLU, residual), the head's the bias alone; the
# conv's ReLU after its BatchNorm.
MATMUL_MIXES = [(False, False, False), (True, False, False), (True, True, False), (False, False, True)]
CONV_MIXES = [False, True]
# The mixes' GEMMs: the register store path (N % 4 != 0: N 33, 1, 130)
# and the TMA one (N 8, 96), the cp.async ring (K 36, 27, 50) and TMA's (K
# 20 is one chunk, A_SPAN); the convs: ragged grids, C 4 and 36, F 9 and 17.
EPILOGUE_MATMULS = [(129, 36, 33), (300, 20, 8), (1000, 27, 1), (2500, 50, 130), (4000, 64, 96)]
EPILOGUE_CONVS = [(2, 6, 6, 4, 9), (3, 9, 11, 36, 17), (2, 17, 13, 32, 40)]


def mix_kw(torch, gen, shape: tuple, n: int, mix: tuple) -> dict:
    """A GEMM launch's epilogue keywords for one of ``MATMUL_MIXES``, the
    residual of ``shape``."""
    bn, relu, residual = mix
    kw = {"epilogue": make_epilogue(torch, gen, n, bn, relu)}
    if residual:
        kw["residual"] = torch.randn(shape, generator=gen, device="cuda")
    return kw


def negative_zero_epilogue(torch, n: int):
    """An epilogue whose BatchNorm turns a zero accumulator into -0.0
    before its ReLU: bias -0.0, mean +0.0, inv -1, beta -0.0."""
    from fedcrack_tpu_torch.kernels import dequant

    zeros = torch.zeros(n, device="cuda")
    return dequant.Epilogue(bias=-zeros, bn=(zeros, -torch.ones(n, device="cuda"), -zeros), relu=True)


def matmul_epilogue_sweep(torch, name: str, codes, gen) -> int:
    """``dequant_matmul`` with each of ``MATMUL_MIXES`` on
    ``EPILOGUE_MATMULS``; with the residual mix and the BatchNorm-ReLU mix
    on inputs holding -0.0 rows and NaN in x and the residual; with zero
    rows of x through :func:`negative_zero_epilogue` (a ReLU of -0.0): each
    bit for bit the kernel followed by the torch ops. A residual off TMA's
    16-byte alignment is refused. Returns the cases checked."""
    from fedcrack_tpu_torch.kernels import dequant

    count = 0
    for m, k, n in EPILOGUE_MATMULS:
        x = torch.randn((m, k), generator=gen, device="cuda")
        q, s = codes((k, n))
        for mix in MATMUL_MIXES:
            check_fused(torch, f"{name} mix M={m} K={k} N={n}", dequant.dequant_matmul, (x, q, s),
                        mix_kw(torch, gen, (m, n), n, mix))
            count += 1
        x[0] = -0.0
        x[5, k // 2] = float("nan")
        kw = mix_kw(torch, gen, (m, n), n, MATMUL_MIXES[3])
        kw["residual"][1] = -0.0
        kw["residual"][9, 0] = float("nan")
        check_fused(torch, f"{name} special values M={m} K={k} N={n}", dequant.dequant_matmul, (x, q, s), kw)
        check_fused(torch, f"{name} special values M={m} K={k} N={n}", dequant.dequant_matmul, (x, q, s),
                    mix_kw(torch, gen, (m, n), n, MATMUL_MIXES[2]))
        x[:8] = 0.0
        check_fused(torch, f"{name} relu of -0.0 M={m} K={k} N={n}", dequant.dequant_matmul, (x, q, s),
                    {"epilogue": negative_zero_epilogue(torch, n)})
        buf = torch.randn(m * n + 2, generator=gen, device="cuda")
        try:
            dequant.dequant_matmul(x, q, s, epilogue=kw["epilogue"], residual=buf[2:].view(m, n))
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} M={m} K={k} N={n}: a residual 8 bytes off TMA's alignment was launched")
        count += 4
    return count


def conv_epilogue_sweep(torch, name: str, codes, gen) -> int:
    """``dequant_conv3x3`` as :func:`matmul_epilogue_sweep` checks the GEMM
    (each of ``CONV_MIXES`` with and without ``relu_input``), on
    ``EPILOGUE_CONVS``; and an input holding -0.0 gives the bits the same
    input with +0.0 gives, with and without ``relu_input``: the accumulator
    starts at +0.0, so the sign of a zero input reaches no output. Returns
    the cases checked."""
    from fedcrack_tpu_torch.kernels import dequant

    count = 0
    for n_img, h, w, c, f in EPILOGUE_CONVS:
        x = torch.randn((n_img, h, w, c), generator=gen, device="cuda")
        q, s = codes((3, 3, c, f))
        for relu in CONV_MIXES:
            for relu_input in (False, True):
                kw = {"epilogue": make_epilogue(torch, gen, f, True, relu), "relu_input": relu_input}
                check_fused(torch, f"{name} mix {(n_img, h, w, c, f)}", dequant.dequant_conv3x3, (x, q, s), kw)
                count += 1
        x[0, 0] = -0.0
        x[-1, h // 2, :, : c // 2] = -0.0
        signed = x.clone()
        x[n_img // 2, h // 2, w // 2, :] = float("nan")
        kw = {"epilogue": make_epilogue(torch, gen, f, True, True), "relu_input": True}
        check_fused(torch, f"{name} special values {(n_img, h, w, c, f)}", dequant.dequant_conv3x3, (x, q, s), kw)
        unsigned = torch.where(signed == 0, torch.zeros_like(signed), signed)  # -0.0 -> +0.0
        for relu_input in (False, True):
            if not same_floats(torch, dequant.dequant_conv3x3(signed, q, s, relu_input=relu_input),
                               dequant.dequant_conv3x3(unsigned, q, s, relu_input=relu_input)):
                raise AssertionError(f"{name} {(n_img, h, w, c, f)}: -0.0 inputs change an output bit "
                                     f"(relu_input={relu_input})")
        x[:, :2] = 0.0
        check_fused(torch, f"{name} relu of -0.0 {(n_img, h, w, c, f)}", dequant.dequant_conv3x3, (x, q, s),
                    {"epilogue": negative_zero_epilogue(torch, f)})
        count += 4
    return count


def same_floats(torch, a, b) -> bool:
    """Bit for bit: NaN payloads and the sign of zero included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def dwconv_case(torch, card: str, name: str, codes, gen, cfg) -> dict:
    """``dequant_dwconv3x3`` bitwise against its plain version at the six
    depthwise stages of a bucket-256 x batch-8 forward and over
    ``DW_SWEEP``, bitwise run to run, the first and the last image alone
    bitwise equal to the same images in the batch; inputs holding -0.0,
    NaN and negatives bitwise equal to the plain version and, value for
    value, to the same taps over ``torch.relu(x)`` (what torch.relu does to
    -0.0 and NaN on the card is logged); an activation 4 bytes off TMA's
    alignment (the producer loads its halo by hand) bitwise equal too. Per
    forward: device time (profiler, one kernel per call) and CUDA-event
    time of the kernel, the plain version and ``F.conv2d(padding=1,
    groups=C)`` on ``relu(x)`` channels-last with the weights expanded once
    (``library_ms``; with the ReLU's launch, ``library_relu_ms``), the
    bound, each stage's tile plan and the wrapper's host µs per call."""
    import torch.nn.functional as F

    from fedcrack_tpu_torch.kernels import dequant

    dev = torch.device("cuda")

    def check(label, x, q, s):
        y = dequant.dequant_dwconv3x3(x, q, s)
        again = dequant.dequant_dwconv3x3(x, q, s)
        want = dequant._dequant_dwconv3x3_plain(x, q, s)
        torch.cuda.synchronize()
        if not same_floats(torch, y, want):
            diff = y.view(torch.int32) != want.view(torch.int32)
            raise AssertionError(f"{name} {label}: {int(diff.sum())} outputs differ from the plain version, max "
                                 f"|kernel - plain| {float((y - want).abs().nan_to_num().max()):.3g}")
        if not same_floats(torch, y, again):
            raise AssertionError(f"{name} {label}: not bitwise equal run to run")
        for i in {0, x.shape[0] - 1} if x.shape[0] > 1 else ():
            if not same_floats(torch, dequant.dequant_dwconv3x3(x[i:i + 1].contiguous(), q, s), y[i:i + 1]):
                raise AssertionError(f"{name} {label}: image {i} alone differs from it in the batch")
        return y

    def relu_taps(x, q, s):
        # The parent forward's stage: torch.relu, F.pad, the nine taps of the expanded kernel.
        n, h, w, c = x.shape
        taps = (q.float() * s).reshape(9, c)
        xp = F.pad(torch.relu(x), (0, 0, 1, 1, 1, 1))
        acc = xp[:, :h, :w] * taps[0]
        for t in range(1, 9):
            acc = acc + xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w] * taps[t]
        return acc

    main = dwconv_shapes(cfg, BUCKET, BATCH)
    cases = []
    for layer, n_img, h, w, c in main + [(f"sweep{s}", *s) for s in DW_SWEEP]:
        x = torch.randn((n_img, h, w, c), generator=gen, device=dev)
        q, s = codes((3, 3, 1, c))
        check(layer, x, q, s)
        if not layer.startswith("sweep"):
            # cuDNN on the channels-last view of relu(x), its weights expanded once.
            relu_nchw = torch.relu(x).permute(0, 3, 1, 2)
            w_oihw = (q.float() * s).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cases.append((layer, f"N={n_img} H={h} W={w} C={c}", (x, q, s),
                          lambda r=relu_nchw, k=w_oihw: F.conv2d(r, k, padding=1, groups=k.shape[0]),
                          8 * x.numel() + 9 * c + 4 * c, 17 * x.numel()))

    # Signed zeros, NaN and negatives, on the TMA path (C = 40) and the hand-loaded one (C = 3).
    for c in (40, 3):
        x = torch.randn((3, 9, 11, c), generator=gen, device=dev)
        x[0, 0, :, :] = -0.0
        x[1, 4, 5, :] = float("nan")
        x[2, :, 3, : c // 2 + 1] = -0.0
        x[2, 8, 10, 0] = float("nan")
        q, s = codes((3, 3, 1, c))
        y = check(f"special values C={c}", x, q, s)
        ref = relu_taps(x, q, s)
        if not (torch.equal(torch.isnan(y), torch.isnan(ref)) and torch.equal(y.nan_to_num(), ref.nan_to_num())):
            raise AssertionError(f"{name} special values C={c}: differs from the taps over torch.relu(x)")
    probe = torch.tensor([-0.0, float("nan"), -1.0, 1.0, 0.0], device=dev)
    log(f"{name}: torch.relu on the card maps [-0.0, nan, -1, 1, 0] to bits "
        f"{[hex(v & 0xFFFFFFFF) for v in torch.relu(probe).view(torch.int32).tolist()]}; the kernel's clamp "
        f"(v < 0 ? 0 : v) to {[hex(v & 0xFFFFFFFF) for v in probe.masked_fill(probe < 0, 0.0).view(torch.int32).tolist()]}")

    # An activation 4 bytes into its storage: no TMA map, the producer loads the halo.
    buf = torch.randn(2 * 17 * 19 * 32 + 1, generator=gen, device=dev)
    x = buf[1:].view(2, 17, 19, 32)
    if x.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned activation is aligned")
    check("misaligned x", x, *codes((3, 3, 1, 32)))
    log(f"{name}: {len(main)} main-path stages, {len(DW_SWEEP)} ragged shapes, special values (-0.0, NaN, "
        f"negatives) on both load paths and a misaligned activation bitwise equal to the plain version, bitwise "
        f"repeatable, the first and last image alone equal to them in the batch")
    for layer, *shape in main:
        log(f"{name} {layer} tile plan {dequant.dwconv_tile_plan(*shape)}")

    row = {"max_abs_err": 0.0, "event_ms": 0.0, "plain_event_ms": 0.0, "library_event_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0}
    for layer, shape, args, lib, n_bytes, n_ops in cases:
        t_k = cuda_ms(torch, lambda: dequant.dequant_dwconv3x3(*args))
        t_p = cuda_ms(torch, lambda: dequant._dequant_dwconv3x3_plain(*args))
        t_l = cuda_ms(torch, lib)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        row["event_ms"] += t_k
        row["plain_event_ms"] += t_p
        row["library_event_ms"] += t_l
        row["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
        row["ops_ms"] += n_ops / FP32_FLOPS_PER_S * 1e3
        log(f"{name} {layer} {shape}: events kernel {t_k:.4f} ms, plain {t_p:.4f} ms, F.conv2d {t_l:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}) [{card}]")
    row["bound_ms"], row["bound_by"] = max(row["bytes_ms"], row["ops_ms"]), (
        "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations")
    calls = [lambda a=args: dequant.dequant_dwconv3x3(*a) for _, _, args, _, _, _ in cases]
    row["ms"] = device_ms(torch, calls, launches=len(cases))
    row["plain_ms"] = device_ms(torch, [lambda a=args: dequant._dequant_dwconv3x3_plain(*a)
                                        for _, _, args, _, _, _ in cases])
    row["library_ms"] = device_ms(torch, [lib for _, _, _, lib, _, _ in cases])
    relu_libs = [lambda a=args, lib=lib: (torch.relu(a[0]), lib()) for _, _, args, lib, _, _ in cases]
    row["library_relu_ms"] = device_ms(torch, relu_libs)
    row["host_us"] = wrapper_host_us(torch, dequant.dequant_dwconv3x3, [(c[0], c[2], {}) for c in cases])
    log(f"{name} one forward ({len(cases)} launches), device time: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.conv2d(groups=C) on relu(x) {row['library_ms']:.4f} ms (with torch.relu's "
        f"launches {row['library_relu_ms']:.4f} ms); bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
        f"{row['bytes_ms']:.4f}, f32 {row['ops_ms']:.4f}), {row['bound_ms'] / row['ms']:.3f} of the bound; CUDA "
        f"events: kernel {row['event_ms']:.4f} ms, plain {row['plain_event_ms']:.4f} ms, F.conv2d "
        f"{row['library_event_ms']:.4f} ms [{card}]")
    log(f"{name} wrapper host µs per call (min of 5 runs of 200 back-to-back calls per layer): "
        f"{json.dumps(row['host_us'])} [{card}]")
    return row


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
    per_forward = forward_launches(cfg)

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
    profile = {}
    if requests:
        profile = profile_batches(torch, engine, payload, rng.integers(0, 256, (BATCH, BUCKET, BUCKET, 3),
                                                                       dtype=np.uint8), card)
    return {"launches": launches, "forwards": forwards, "perf": perf, "profile": profile}


# Kernels of the torch ops the fused epilogues replaced (the bias, the
# BatchNorm's sub / mul / add and its rsqrt, torch.relu, the residual add):
# none may run in a served batch. The one scalar multiply that normalizes
# the uint8 images is an AUnaryFunctor, not a BinaryFunctor.
EPILOGUE_OP_KERNELS = ("CUDAFunctor_add", "BinaryFunctor<float, float, float, binary_internal::MulFunctor",
                       "clamp", "rsqrt")


def profile_batches(torch, engine, weights, batch, card: str, n: int = 5) -> dict:
    """Where one bucket-256 batch's time goes: CUDA kernel time by name and
    the device's idle share of the host-clock window (torch.profiler), the
    kernels a batch launches, and the batch's MFU (``obs.flops``: the
    canonical forward FLOPs over the card's bf16 peak). No kernel of
    ``EPILOGUE_OP_KERNELS`` may run: the fused launches' epilogues do that
    work."""
    import dataclasses

    from fedcrack_tpu_torch.obs.flops import mfu, resunet_forward_flops
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile

    engine.predict_bucket(weights, batch)
    with card_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.predict_bucket(weights, batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = card_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log("profile: the profiler saw no CUDA kernels; device time not measured")
        return {}
    flops = resunet_forward_flops(dataclasses.replace(engine.model_config, img_size=BUCKET), BATCH)
    launches = sum(e.count for e in kernels) / n
    log(f"profile: {n} fused batches (bucket {BUCKET}, batch {BATCH}) in {wall_us / n / 1e3:.3f} ms "
        f"each on the host clock, device busy {busy_us / n / 1e3:.4f} ms each, {launches:.1f} kernels each, "
        f"idle share {1 - busy_us / wall_us:.3f}; {flops:.6g} FLOP a batch, MFU "
        f"{mfu(busy_us / n / 1e6, flops, 0):.5f} of device busy, {mfu(wall_us / n / 1e6, flops, 0):.5f} of the "
        f"host clock [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile: {e.self_device_time_total / n / 1e3:8.4f} ms/batch "
            f"{e.count // n:4d} calls/batch  {e.key[:110]}")
    log("profile: every kernel of a batch: " + "; ".join(
        f"{e.count / n:g} x {e.key[:90]}" for e in sorted(kernels, key=lambda e: -e.count)))
    leftover = [e.key for e in kernels if any(op in e.key for op in EPILOGUE_OP_KERNELS)]
    if leftover:
        raise AssertionError(f"a served batch still runs the epilogues' torch ops: {leftover}")
    return {"launches_per_batch": launches, "device_busy_ms": busy_us / n / 1e3,
            "host_ms": wall_us / n / 1e3}


def bce_phase(torch, card: str) -> dict:
    """Phase 6: ``bce_sums`` against its plain version on the card: at the
    train step's logits, at 8 x 256 x 256 and over a ragged sweep, each
    size's ``bce_plan`` logged; calls at
    alternating sizes back to back (the ticket's reset), and on two streams
    at once (one workspace each); one kernel per call by the profiler. The
    card's launch floor: the device time of one launch that stores 4 bytes
    (``launch_floor_us``)."""
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
        log(f"bce_sums {label} (n={x.numel()}): plan {bce.bce_plan(x.numel())._asdict()}, max |kernel - plain| "
            f"{float(err.max()):.3g}")

    # Back to back at alternating sizes (grids of 1 to 132 blocks, which
    # share the stream's workspace), no
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

    # The launch floor: one kernel that stores 4 bytes, timed as below.
    cell = torch.zeros(1, device=dev)
    kernels = kernel_device_us(torch, cell.zero_)
    if len(kernels) != 1 or next(iter(kernels.values()))[1] != 1:
        raise AssertionError(f"launch floor: want one kernel per zero_(), the profiler saw {kernels}")
    row["launch_floor_us"] = next(iter(kernels.values()))[0]
    log(f"launch_floor_us {row['launch_floor_us']:.4f}: device time of one one-element zero_() "
        f"({next(iter(kernels))}) [{card}]")

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
            f"{case['bound_ms']:.6f} ms ({case['bound_by']}), launch floor {row['launch_floor_us'] / 1e3:.6f} ms "
            f"[{card}]")
        if label == "train_step":
            row.update(case)
    return row


def kernel_device_us(torch, fn, n: int = 20) -> dict[str, tuple[float, float]]:
    """Per CUDA kernel that ``fn`` launches: device time per call (us) and
    launches per call, from torch.profiler. A profile that lost kernel
    records would read short, so a profile whose launch counts are not
    whole multiples of ``n`` is taken again (up to three times)."""
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile, lead_kept

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES):
        with card_profile() as prof:
            for _ in range(n):
                fn()
        kernels = card_kernels(prof)
        out = {e.key: (e.self_device_time_total / n, e.count / n) for e in kernels}
        if out and all(e.count % n == 0 for e in kernels):
            return out
        seen.append(out)
        log(f"profile retaken: kernel records not whole per call over {n} calls")
    raise AssertionError(f"the profiler's kernel counts are not whole per call: {seen}; "
                         f"{lead_kept()}")


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
    from fedcrack_tpu_torch.obs.flops import mfu, train_step_flops
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
    flops = train_step_flops(cfg.model, TRAIN_BATCH)
    log(f"[train] train_step ModelConfig() {TRAIN_SIZE} px batch {TRAIN_BATCH}: {perf['img_per_s']:.1f} img/s, "
        f"step p50 {p50:.3f} ms p95 {p95:.3f} ms over 20 steps; {flops:.6g} FLOP a step, MFU at p50 "
        f"{mfu(p50 / 1e3, flops, 0):.5f} [{card}]")
    profile_steps(torch, lambda: local.train_step(st, dev_batch, anchor), card, flops)
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


def one_message_callers(cfg, names, port) -> dict:
    """Per client name, its channel and a call of one message on it."""
    from fedcrack_tpu_torch.transport import FedClient

    out = {}
    for name in names:
        client = FedClient(cfg, lambda blob, rnd: None, cname=name, port=port)
        channel, method = client._connect()
        out[name] = (channel, lambda body, c=client, m=method: c._call(m, c._msg(body)))
    return out


def served_batch_launches(torch, engine, payload, batch) -> tuple[dict, dict, object]:
    """One bucket batch on a quantized payload after a warm one: its
    dequant launches on the wrappers' counts and on the profiler's (15 /
    8 / 6 / 0 per forward), a window that lost records taken again with a
    new batch. Returns both counts and the batch's probabilities, finite
    and of the bucket's shape."""
    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile, lead_kept

    engine.predict_bucket(payload, batch)
    torch.cuda.synchronize()
    want = forward_launches(ModelConfig())
    seen = []
    for _ in range(PROFILE_TRIES):
        dequant.reset_launch_counts()
        with card_profile(cpu=False) as prof:
            probs = engine.predict_bucket(payload, batch)
        counted = {name: getattr(dequant, name).launches for name in want}
        kernels = card_kernels(prof)
        profiled = {name: sum(e.count for e in kernels if f"{name}_kernel" in e.key) for name in want}
        if counted != want:
            raise AssertionError(f"served batch launches: wrappers {counted}, want {want}")
        if profiled == want:
            break
        seen.append(profiled)
        log(f"profile retaken: {profiled} kernel records (want {want})")
    else:
        raise AssertionError(f"served batch launches: profiler {seen}, want {want}; {lead_kept()}")
    if not (np.isfinite(probs).all() and probs.shape == (len(batch), batch.shape[1], batch.shape[2], 1)):
        raise AssertionError("served probabilities not finite of the bucket's shape")
    return counted, profiled, probs


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

    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import prepare_gated_payload
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager, publish_statefile
    from fedcrack_tpu_torch.transport import FedServer, wire
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

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.msgpack")
        cfg = buffered_config(fs, max_rounds=2, state_path=path)
        bce.reset_launch_counts()
        with ServerThread(FedServer(cfg, fs["global0"], tick_period_s=0.05)) as st:
            calls = one_message_callers(cfg, names, st.port)
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
            calls = one_message_callers(cfg, names, st.port)
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
    counted, profiled, probs = served_batch_launches(torch, engine, payload, batch)
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


# Phase 13's image directory: 128 train pairs after the reference split
# (two shards of 64: four steps of 16 per epoch) and 32 eval pairs, decoded
# from 448 px sources to the model's 128.
CLI_PAIRS, CLI_EVAL_PAIRS, CLI_SOURCE_SIZE = 129, 32, 448
CLI_NAMES = ("client_0", "client_1")
CLI_TIMEOUT_S = 420.0
# Runs an entry point as ``python -m`` would, after blocking the reference
# stack as main() does (a child process does not inherit that block), and
# prints one line at exit: its bce_sums and dequant launches, the quantized
# forwards of its engines, and the wall time of the first bce_sums and the
# first dequant launch.
CLI_SHIM = """
import atexit, json, runpy, sys, time
for name in {blocked!r}:
    sys.modules.setdefault(name, None)
sys.path.insert(0, {root!r})
from fedcrack_tpu_torch.kernels import dequant
from fedcrack_tpu_torch.ops import bce
from fedcrack_tpu_torch.serve import engine as serve_engine
first = {{}}
kernel = bce._bce_sums_kernel
def counted(x, y):
    first.setdefault("bce", time.time())
    return kernel(x, y)
bce._bce_sums_kernel = counted
launch = dequant.LIBRARY.launch
def dequant_launch(*args):
    first.setdefault("dequant", time.time())
    return launch(*args)
dequant.LIBRARY.launch = dequant_launch
engines = []
engine_init = serve_engine.InferenceEngine.__init__
def tracked(self, *args, **kwargs):
    engine_init(self, *args, **kwargs)
    engines.append(self)
serve_engine.InferenceEngine.__init__ = tracked
atexit.register(lambda: print("CLI_SHIM " + json.dumps({{
    "bce_sums_launches": bce.bce_sums.launches,
    "dequant_launches": {{name: getattr(dequant, name).launches for name in {kernels!r}}},
    "quantized_forwards": sum(e.quantized_forwards for e in engines),
    "first_launch_unix": first.get("bce"),
    "first_dequant_launch_unix": first.get("dequant")}}), flush=True))
sys.argv = [{module!r}] + sys.argv[1:]
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
"""


def write_pairs(root: str, n: int, size: int, seed: int) -> tuple[str, str]:
    """``n`` pairs from ``synth_crack_batch(n, size, seed)`` as PNG images
    and masks with equal stems under ``root/images`` and ``root/masks``
    (the reference dataset's layout); returns the two directories."""
    import cv2

    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    dirs = os.path.join(root, "images"), os.path.join(root, "masks")
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    images, masks = to_uint8_transport(*synth_crack_batch(n, size, seed=seed))
    for i in range(n):
        if not (cv2.imwrite(os.path.join(dirs[0], f"crack_{i:04d}.png"), cv2.cvtColor(images[i], cv2.COLOR_RGB2BGR))
                and cv2.imwrite(os.path.join(dirs[1], f"crack_{i:04d}.png"), masks[i, :, :, 0] * 255)):
            raise OSError(f"could not write pair {i} under {root}")
    return dirs


def cli_in_process_drive(server_cfg, client_cfg, image_dir: str, mask_dir: str, global0, seed: int = 0,
                         transport_dtype: str = "uint8", device=None) -> dict:
    """The command-line federation of ``CLI_NAMES`` in one process: each
    client's ``make_train_fn`` (seed ``seed``) over ``dataset_from_source``
    with the client command line's shard filter and data seed (``seed`` +
    its index), driven through ``fed.rounds.transition`` by
    :func:`drive_federation` from ``global0``."""
    from fedcrack_tpu_torch import client as client_cli
    from fedcrack_tpu_torch.data.pipeline import dataset_from_source
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.train.federated import make_train_fn

    fits = {}
    for i, name in enumerate(CLI_NAMES):
        data = dataset_from_source(
            0, image_dir, mask_dir, img_size=client_cfg.model.img_size, batch_size=client_cfg.data.batch_size,
            seed=seed + i, num_workers=client_cfg.data.num_workers, prefetch=client_cfg.data.prefetch,
            pair_filter=client_cli.local_shard(client_cfg, len(CLI_NAMES), i), transport_dtype=transport_dtype)
        fits[name] = make_train_fn(client_cfg, data, client_cfg.data.batch_size, seed=seed, device=device)[0]

    def fit(name, blob, rnd, hparams):
        return fits[name](blob, rnd, hparams)[:2]

    return drive_federation(rounds, serialization, server_cfg, global0, fit, list(CLI_NAMES))


class CliProcess:
    """One entry point in its own interpreter through ``CLI_SHIM``, its
    output in ``<log_dir>/<label>.log``."""

    def __init__(self, label: str, module: str, args: list[str], log_dir: str):
        blocked = tuple(m for m in REFERENCE_STACK if m not in PORT_NEEDS)
        code = CLI_SHIM.format(blocked=blocked, root=HERE, module=module, kernels=DEQUANT_KERNELS)
        self.label, self.path = label, os.path.join(log_dir, f"{label}.log")
        self._out = open(self.path, "w", encoding="utf-8")
        self.started = time.time()
        self.proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=HERE, stdout=self._out,
                                     stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONUNBUFFERED="1"))
        self.wall_s = None

    def text(self) -> str:
        with open(self.path, encoding="utf-8") as f:
            return f.read()

    def wait(self, deadline: float) -> int:
        rc = self.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        self.wall_s = time.time() - self.started
        self._out.close()
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._out.close()

    def report(self) -> dict:
        """The shim's exit line: launches, quantized forwards, and the CUDA
        start-up (process start to the first bce_sums and the first dequant
        launch)."""
        lines = [ln for ln in self.text().splitlines() if ln.startswith("CLI_SHIM ")]
        if len(lines) != 1:
            raise AssertionError(f"{self.label}: no exit line from the shim:\n{self.text()[-4000:]}")
        out = json.loads(lines[0][len("CLI_SHIM "):])
        for key in ("first_launch", "first_dequant_launch"):
            first = out.pop(f"{key}_unix")
            out[f"start_to_{key}_s"] = None if first is None else first - self.started
        out["wall_s"] = self.wall_s
        return out


def run_processes(procs: list, deadline: float) -> None:
    """Wait for every process; on a timeout or a non-zero exit, kill the
    rest and raise with the failing log's tail."""
    try:
        for p in procs:
            rc = p.wait(deadline)
            if rc != 0:
                raise AssertionError(f"{p.label} exited {rc}:\n{p.text()[-6000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 13 timed out after {CLI_TIMEOUT_S} s: "
                             + "; ".join(f"{p.label}: {p.text()[-1500:]}" for p in procs)) from None
    finally:
        for p in procs:
            p.kill()


def check_predict_dir(pred_dir: str, client_log: str, size: int) -> list:
    """The client's ``--predict-dir`` output: ``pred_NNN.png`` and
    ``overlay_NNN.png`` at ``size`` px for every image of the report it
    logged, the report equal to ``quantify_mask`` over the written masks."""
    import re

    import cv2

    from fedcrack_tpu_torch.tools.quantify import quantify_mask

    found = re.findall(r"crack quantification: (\[.*\])$", client_log, re.M)
    if len(found) != 1:
        raise AssertionError(f"{len(found)} crack quantification reports in the client's log")
    report = json.loads(found[0])
    names = sorted(os.listdir(pred_dir))
    if not report or names != sorted(f"{k}_{r['image']:03d}.png" for r in report for k in ("overlay", "pred")):
        raise AssertionError(f"--predict-dir wrote {names} for {len(report)} reports")
    for rec in report:
        mask = cv2.imread(os.path.join(pred_dir, f"pred_{rec['image']:03d}.png"), cv2.IMREAD_GRAYSCALE)
        overlay = cv2.imread(os.path.join(pred_dir, f"overlay_{rec['image']:03d}.png"))
        st = quantify_mask(mask)
        want = {"image": rec["image"], "contours": st.contour_count, "area_px": st.total_area_px,
                "perimeter_px": st.total_perimeter_px, "crack_fraction": st.crack_fraction}
        if mask.shape != (size, size) or overlay.shape != (size, size, 3) or rec != want:
            raise AssertionError(f"--predict-dir image {rec['image']}: {mask.shape}, {overlay.shape}, {rec} != {want}")
    return report


def wait_for_port(server, deadline: float) -> int:
    """The bound port from the server's ``serving on host:port`` line."""
    import re

    while time.monotonic() < deadline:
        found = re.search(r"serving on [^:\s]+:(\d+)", server.text())
        if found:
            return int(found.group(1))
        if server.proc.poll() is not None:
            raise AssertionError(f"the server exited {server.proc.returncode} before serving:\n{server.text()[-6000:]}")
        time.sleep(0.1)
    raise AssertionError("the server did not report its port in time")


def cli_phase(torch, card: str, train: dict, grpc_run: dict) -> dict:
    """Phase 13: the command lines at full width, one process per client,
    and the centralized trainer, each held byte-equal to an in-process run
    of the same data and seeds."""
    import argparse
    import tempfile

    import numpy as np

    from fedcrack_tpu_torch import server as server_cli
    from fedcrack_tpu_torch.ckpt.statefile import server_state_from_bytes
    from fedcrack_tpu_torch.configs import FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import CrackDataset, _cv2, list_pairs, reference_split
    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs import read_metrics, read_scalars, read_spans
    from fedcrack_tpu_torch.train import centralized

    if _cv2() is None:
        raise AssertionError("phase 13 decodes with OpenCV, which this machine lacks")
    out: dict = {"decode_backend": "cv2"}
    with tempfile.TemporaryDirectory(prefix="fedcrack_cli_") as tmp:
        t0 = time.monotonic()
        image_dir, mask_dir = write_pairs(os.path.join(tmp, "train"), CLI_PAIRS, CLI_SOURCE_SIZE, seed=13)
        eval_dirs = write_pairs(os.path.join(tmp, "eval"), CLI_EVAL_PAIRS, CLI_SOURCE_SIZE, seed=14)
        global0 = init_variables(torch.Generator().manual_seed(0), ModelConfig())
        init_path = os.path.join(tmp, "init.msgpack")
        with open(init_path, "wb") as f:
            f.write(serialization.tree_to_bytes(global0))
        config_path = os.path.join(tmp, "fed.json")
        with open(config_path, "w", encoding="utf-8") as f:
            json.dump({"data": {"img_size": TRAIN_SIZE, "batch_size": TRAIN_BATCH, "num_workers": 4, "prefetch": 2},
                       "local_epochs": 1, "poll_period_s": 0.05}, f)
        log(f"[cli] wrote {CLI_PAIRS} + {CLI_EVAL_PAIRS} PNG pairs at {CLI_SOURCE_SIZE} px and the seeded "
            f"global in {time.monotonic() - t0:.2f} s; decode backend cv2 {_cv2().__version__}")
        p = {k: os.path.join(tmp, v) for k, v in (
            ("state", "state.bin"), ("metrics", "server.jsonl"), ("tb", "tb"), ("spans", "spans.jsonl"),
            ("best", "best.msgpack"), ("cent", "centralized"), ("cent_metrics", "centralized.jsonl"))}
        server_args = ["--config", config_path, "--host", "127.0.0.1", "--port", "0", "--rounds", "2",
                       "--cohort", "2", "--registration-window", "120", "--init-weights", init_path,
                       "--state-path", p["state"], "--metrics", p["metrics"], "--tb-dir", p["tb"],
                       "--spans-path", p["spans"], "--best-path", p["best"],
                       "--eval-image-dir", eval_dirs[0], "--eval-mask-dir", eval_dirs[1]]

        # ---- the main path, counted in each process: server and two clients ----
        deadline = time.monotonic() + CLI_TIMEOUT_S
        procs = [CliProcess("server", "fedcrack_tpu_torch.server", server_args, tmp)]
        try:
            port = wait_for_port(procs[0], deadline)
            for i, name in enumerate(CLI_NAMES):
                procs.append(CliProcess(name, "fedcrack_tpu_torch.client", [
                    "--config", config_path, "--host", "127.0.0.1", "--port", str(port), "--name", name,
                    "--image-dir", image_dir, "--mask-dir", mask_dir, "--num-clients", "2",
                    "--client-index", str(i), "--transport-dtype", "uint8",
                    "--metrics", os.path.join(tmp, f"{name}.jsonl"),
                    *(["--predict-dir", os.path.join(tmp, "pred")] if i == 1 else [])], tmp))
        except BaseException:
            for pr in procs:
                pr.kill()
            raise
        run_processes(procs, deadline)
        reports = {pr.label: pr.report() for pr in procs}

        # ---- what the processes left ----
        server_cfg, _ = server_cli.build_config(server_args)
        with open(p["state"], "rb") as f:
            state = server_state_from_bytes(f.read(), server_cfg)
        if len(state.history) != 2 or state.model_version != 2:
            raise AssertionError(f"statefile at version {state.model_version}, history {state.history}")
        rounds_rec, evals = read_metrics(p["metrics"], "round"), read_metrics(p["metrics"], "server_eval")
        if len(rounds_rec) != 2 or len(evals) != 2:
            raise AssertionError(f"server metrics: {len(rounds_rec)} round and {len(evals)} server_eval records")
        if not all(np.isfinite(e[k]) for e in evals for k in ("loss", "pixel_acc", "iou")):
            raise AssertionError(f"non-finite server eval {evals}")
        fits = {}
        for i, name in enumerate(CLI_NAMES):
            fits[name] = read_metrics(os.path.join(tmp, f"{name}.jsonl"), "local_fit")
            sessions = read_metrics(os.path.join(tmp, f"{name}.jsonl"), "session")
            if len(fits[name]) != 2 or len(sessions) != 1 or sessions[0]["rounds_completed"] != 2:
                raise AssertionError(f"{name}: {len(fits[name])} local_fit records, sessions {sessions}")
        (tb_file,) = os.listdir(p["tb"])
        scalars = read_scalars(os.path.join(p["tb"], tb_file))  # raises on a bad CRC
        if not any(tag.startswith("round/") for tag, _, _ in scalars):
            raise AssertionError(f"no round/ scalars among {sorted({t for t, _, _ in scalars})}")
        flushes = read_spans(p["spans"], "fed.flush")
        if [s["version"] for s in flushes] != [1, 2]:
            raise AssertionError(f"flush spans {flushes}")
        with open(p["best"], "rb") as f:
            serialization.tree_from_bytes(f.read(), template=global0)
        steps = {name: sum(r["num_samples"] for r in fits[name]) // TRAIN_BATCH for name in CLI_NAMES}
        eval_batches = sum(e["num_batches"] for e in evals)
        want = {"server": eval_batches, **steps}
        got = {label: r["bce_sums_launches"] for label, r in reports.items()}
        if got != want or steps != {name: 8 for name in CLI_NAMES} or eval_batches != 4:
            raise AssertionError(f"bce_sums launches per process {got} != steps + eval batches {want}")
        predicted = check_predict_dir(os.path.join(tmp, "pred"), procs[2].text(), TRAIN_SIZE)
        log(f"[cli] {CLI_NAMES[1]} --predict-dir: {len(predicted)} pred/overlay pairs at {TRAIN_SIZE} px, the "
            f"logged report equal to quantify_mask over the written masks: {json.dumps(predicted)}")

        # ---- the same federation in process: the global byte for byte ----
        with open(config_path, encoding="utf-8") as f:
            client_cfg = FedConfig.from_json(f.read())
        drive = cli_in_process_drive(server_cfg, client_cfg, image_dir, mask_dir, global0)
        if drive["state"].global_blob != state.global_blob:
            raise AssertionError("the statefile's global differs from the in-process drive of the same shards")
        log("[cli] three processes exited 0; the statefile's final global is byte-equal to the in-process "
            "drive; metrics, TensorBoard (CRCs), spans and best.msgpack as expected")

        # ---- the centralized trainer: a process against the same run in process ----
        cent_args = ["--image-dir", image_dir, "--mask-dir", mask_dir, "--epochs", "1", "--seed", "0",
                     "--out-dir", p["cent"], "--metrics", p["cent_metrics"]]
        cent = CliProcess("centralized", "fedcrack_tpu_torch.train.centralized", cent_args, tmp)
        run_processes([cent], time.monotonic() + CLI_TIMEOUT_S)
        reports["centralized"] = cent.report()
        (epoch,) = read_metrics(p["cent_metrics"], "epoch")
        if not np.isfinite(epoch["val_loss"]):
            raise AssertionError(f"centralized val loss {epoch['val_loss']}")
        cent_want = epoch["train_num_steps"] + epoch["val_num_batches"]
        if reports["centralized"]["bce_sums_launches"] != cent_want:
            raise AssertionError(f"centralized bce_sums launches {reports['centralized']} != {cent_want}")
        args = argparse.Namespace(synthetic=0, image_dir=image_dir, mask_dir=mask_dir, batch=TRAIN_BATCH,
                                  seed=0, train_samples=6213, split_seed=1337, transport_dtype="uint8")
        model_config = ModelConfig(img_size=TRAIN_SIZE)
        in_process = os.path.join(tmp, "centralized_in_process")
        centralized.train_centralized(*centralized._build_datasets(args, model_config), model_config=model_config,
                                      epochs=1, out_dir=in_process, seed=0, log_fn=lambda _: None)
        for name in ("final.msgpack", "best.msgpack"):
            with open(os.path.join(p["cent"], name), "rb") as f, open(os.path.join(in_process, name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"centralized {name} differs from the in-process run")
        log(f"[cli] centralized: final.msgpack and best.msgpack byte-equal to the in-process run; "
            f"val loss {epoch['val_loss']:.6f}")

        # ---- the host decode against the step: 4 threads as the clients ran, and 1 and 8 ----
        train_pairs, _ = reference_split(list_pairs(image_dir, mask_dir))
        decode_img_per_s = {}
        for workers in (4, 1, 8):
            ds = CrackDataset(train_pairs, img_size=TRAIN_SIZE, batch_size=TRAIN_BATCH, num_workers=workers,
                              transport_dtype="uint8")
            t0 = time.perf_counter()
            n_images = sum(len(b[0]) for b in ds)
            decode_img_per_s[workers] = n_images / (time.perf_counter() - t0)

    walls = [h["wall_clock_s"] for h in state.history]
    out.update({
        "launches": sum(got.values()) + reports["centralized"]["bce_sums_launches"],
        "processes": reports,
        "round_wall_s": walls,
        "round_wall_s_phase9_threads": grpc_run["round_wall_s"],
        "round_wall_s_phase7_in_process": train["fed"]["round_wall_s"],
        "fit_ms": {name: [1e3 * r["wall_clock_s"] for r in fits[name]] for name in CLI_NAMES},
        "decode_img_per_s": decode_img_per_s[4],
        "decode_img_per_s_by_threads": decode_img_per_s,
        "train_step_img_per_s": train["perf"]["img_per_s"],
        "server_eval": evals,
    })
    log(f"[cli] {json.dumps(out)} (decode: {CLI_SOURCE_SIZE} -> {TRAIN_SIZE} px, uint8, one dataset alone, "
        f"{os.cpu_count()} host cores) [{card}]")
    return out


# Phase 14: the serve command line. Buckets and batch are ServeConfig's
# defaults (128 and 256, 8 lanes).
SERVE_TIMEOUT_S = 240.0
SERVE_CHUNKS = 3
# The Predict mix: two exact buckets, a padded image (phase 4's) and two
# tiled ones (200 x 300 exceeds the 256 bucket in one dimension).
SERVE_MIX = {1: (128, 128), 2: (256, 256), 3: (200, 180), 4: (200, 300), 5: (600, 400)}
SERVE_PROBES = 20
SERVE_BURST_STREAMS, SERVE_BURST_REQUESTS = 16, 12
SERVE_MAX_BURSTS = 12  # until a tick of the autoscaler lands in one
# A short tick, so that a burst trips a scale-up and the calm after it a
# scale-down within the phase (--serve-ticks: stream frames are no slower
# than at ServeConfig's default 1.0 s).
SERVE_SCALE_INTERVAL_S = 0.05
SERVE_REPEATS = 3  # 0-tile frames timed before and after the swap
STREAM_H, STREAM_W = 512, 768
STREAM_BAND = slice(100, 140)  # rows of the moved band: one row of tiles


class ServeClient:
    """The port's wire codec over one gRPC channel to the serve process."""

    def __init__(self, port: int):
        import grpc

        from fedcrack_tpu_torch.transport import wire

        self.wire = wire
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(self.channel).result(timeout=60)
        self._predict = self.channel.stream_stream(
            "/fedcrack.ServePlane/Predict", request_serializer=wire.PredictRequest.encode,
            response_deserializer=wire.PredictResponse.decode)
        self._stream = self.channel.stream_stream(
            "/fedcrack.ServePlane/StreamPredict", request_serializer=wire.StreamRequest.encode,
            response_deserializer=wire.StreamResponse.decode)

    def chunks(self, rid: int, image, n: int = SERVE_CHUNKS, bad_crc: bool = False) -> list:
        """``image`` as ``n`` Predict chunks, each with its CRC32C (the
        first one's wrong with ``bad_crc``)."""
        from fedcrack_tpu_torch.native import crc32c

        blob = image.tobytes()
        step = -(-len(blob) // n)
        return [self.wire.PredictRequest(
            request_id=rid, height=image.shape[0], width=image.shape[1], channels=3, image=blob[o:o + step],
            offset=o, last=o + step >= len(blob), crc32c=(crc32c(blob[o:o + step]) ^ int(bad_crc and o == 0)))
            for o in range(0, len(blob), step)]

    def predict(self, requests: list) -> list:
        return list(self._predict(iter(requests), timeout=SERVE_TIMEOUT_S))

    def open_stream(self):
        """A StreamPredict call fed one exchange at a time: ``send(reqs)``
        returns the one response to the last of ``reqs``."""
        import queue

        q: queue.Queue = queue.Queue()
        responses = self._stream(iter(q.get, None), timeout=SERVE_TIMEOUT_S)

        class Call:
            def send(self, reqs):
                for r in reqs:
                    q.put(r)
                return next(responses)

            def close(self):
                q.put(None)

        return Call()

    def close(self) -> None:
        self.channel.close()


def _mask(probs, threshold: float = 0.5) -> bytes:
    return ((probs[..., 0] > threshold).astype("uint8") * 255).tobytes()


def check_lane_invariance(torch, engine, payload) -> dict:
    """One tile's probabilities must be bitwise the same in lane 0 and in
    lane 5 of a bucket-256 batch with other tiles beside it, and alone
    beside zero lanes: the stream sessions pack their misses on this."""
    import numpy as np

    rng = np.random.default_rng(14)
    batch = rng.integers(0, 256, (BATCH, BUCKET, BUCKET, 3), dtype=np.uint8)
    moved = batch.copy()
    moved[[0, 5]] = moved[[5, 0]]
    a, b = engine.predict_bucket(payload, batch), engine.predict_bucket(payload, moved)
    alone = engine.predict_bucket(payload, batch[:1])
    out = {"lane0_vs_lane5_bitwise": bool(np.array_equal(a[0], b[5])),
           "lane0_vs_lane5_max_abs": float(np.abs(a[0].astype(np.float64) - b[5]).max()),
           "with_neighbours_vs_zero_lanes_bitwise": bool(np.array_equal(a[0], alone[0]))}
    if not (out["lane0_vs_lane5_bitwise"] and out["with_neighbours_vs_zero_lanes_bitwise"]):
        raise AssertionError(f"a tile's probabilities depend on its lane or its neighbours: {out}")
    return out


def session_frame_ms(engine, payload, frames) -> list:
    """Server-side ``latency_ms`` of each frame through a StreamSession in
    this process (tracking on, the card engine, no gRPC and no autoscaler
    beside it): the session's own cost, against which the served frames
    are read."""
    from fedcrack_tpu_torch.serve.batcher import StaticWeights
    from fedcrack_tpu_torch.serve.stream import StreamSession

    session = StreamSession(engine, StaticWeights(payload), height=STREAM_H, width=STREAM_W, track=True)
    out = []
    for image in frames:
        r = session.process_frame(image)
        out.append({"tiles_computed": r.tiles_computed, "ms": r.latency_ms})
    return out


def serve_cli_phase(torch, card: str, scale_interval_s: float = SERVE_SCALE_INTERVAL_S) -> dict:
    """Phase 14: ``python -m fedcrack_tpu_torch.serve`` at full width as a
    process through CLI_SHIM, driven over gRPC with the port's codec:
    Predict (exact, padded and tiled, CRC32C chunks, a wrong CRC), bursts
    until the autoscaler (ticking every ``scale_interval_s``) scales up, a
    StreamPredict session across a statefile hot swap, and SIGTERM."""
    import re
    import statistics
    import tempfile
    import threading

    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.promexp import sample_value, scrape
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile

    cfg, sc = ModelConfig(), ServeConfig(quant="int8", kernel_plane="fused_int8")
    # Phase 4's stand-in for a trained model: seeded weights snapped to the
    # code grid, which pass the gate (version 0 from --weights; version 2
    # from seed 1 through the statefile).
    weights = {v: quant_mod.dequantize_variables(quant_mod.quantize_for_plane(
        init_variables(torch.Generator().manual_seed(seed), cfg), sc.kernel_plane).tree)
        for v, seed in ((0, 0), (2, 1))}
    rng = np.random.default_rng(14)
    mix = {rid: rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for rid, (h, w) in SERVE_MIX.items()}
    frame0 = rng.integers(0, 256, (STREAM_H, STREAM_W, 3), dtype=np.uint8)
    frame_moved = frame0.copy()
    frame_moved[STREAM_BAND] = rng.integers(0, 256, frame_moved[STREAM_BAND].shape, dtype=np.uint8)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="fedcrack_serve_") as tmp:
        p = {k: os.path.join(tmp, v) for k, v in (
            ("weights", "v0.msgpack"), ("config", "serve.json"), ("state", "state.bin"), ("metrics", "serve.jsonl"))}
        with open(p["weights"], "wb") as f:
            f.write(serialization.tree_to_bytes(weights[0]))
        with open(p["config"], "w", encoding="utf-8") as f:
            json.dump({"serve": {"quant": sc.quant, "kernel_plane": sc.kernel_plane}}, f)
        args = ["--config", p["config"], "--weights", p["weights"], "--state-path", p["state"],
                "--host", "127.0.0.1", "--port", "0", "--replicas", "1", "--min-replicas", "1",
                "--max-replicas", "2", "--scale-interval-s", str(scale_interval_s), "--scale-cooldown-s", "1.0",
                "--swap-poll-s", "0.2", "--metrics-path", p["metrics"], "--metrics-port", "-1"]
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        server = CliProcess("serve", "fedcrack_tpu_torch.serve", args, tmp)
        client = None
        try:
            # ---- meanwhile, the same programs in this process ----
            engine = InferenceEngine(cfg, sc)
            payloads = {v: engine.prepare_quantized(quant_mod.quantize_for_plane(w, sc.kernel_plane))
                        for v, w in weights.items()}
            lanes = check_lane_invariance(torch, engine, payloads[0])
            log(f"[serve] one tile in lane 0 vs lane 5 of a bucket-{BUCKET} batch of {BATCH} on the card: "
                f"{json.dumps(lanes)} [{card}]")
            in_process = session_frame_ms(engine, payloads[0], [frame0, frame0, frame_moved]
                                          + [frame_moved] * SERVE_REPEATS)
            log(f"[serve] stream frames through a StreamSession in this process (no gRPC, no autoscaler): "
                f"{json.dumps(in_process)} [{card}]")
            found = None
            while time.monotonic() < deadline:
                found = re.search(r"^SERVING \S+:(\d+) .* metrics_port=(\d+)", server.text(), re.M)
                if found or server.proc.poll() is not None:
                    break
                time.sleep(0.1)
            if not found:
                raise AssertionError(f"the serve process did not report SERVING:\n{server.text()[-6000:]}")
            t_serving = time.time() - server.started
            port, metrics_url = int(found.group(1)), f"http://127.0.0.1:{found.group(2)}/metrics"
            client = ServeClient(port)

            # ---- Predict: the mix on one stream, chunked with CRC32C, and a wrong CRC ----
            responses = client.predict([r for rid, img in mix.items() for r in client.chunks(rid, img)]
                                       + client.chunks(9, mix[1], bad_crc=True))
            by_id = {r.request_id: r for r in responses}
            if sorted(by_id) != sorted([*mix, 9]) or len(responses) != len(mix) + 1:
                raise AssertionError(f"Predict answered {[r.request_id for r in responses]}")
            bad = by_id[9]
            if bad.status != "REJECTED" or not bad.title.startswith("image chunk checksum mismatch at offset 0: "):
                raise AssertionError(f"the wrong CRC was answered {bad.status} {bad.title!r}")
            for rid, img in mix.items():
                r = by_id[rid]
                if r.status != "OK" or r.model_version != 0 or (r.height, r.width) != img.shape[:2]:
                    raise AssertionError(f"request {rid}: {r.status} {r.title!r} v{r.model_version}")
                if r.mask != _mask(engine.predict_image(payloads[0], img)):
                    raise AssertionError(f"request {rid} {img.shape[:2]}: the mask differs from the card engine's")
            log(f"[serve] Predict mix {SERVE_MIX}: every mask byte-equal to the card engine in process; "
                f"the wrong CRC REJECTED: {bad.title!r}")

            # ---- per-bucket latency, one request per call ----
            latency = {}
            for size in sc.bucket_sizes:
                img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                wall, served, queued = [], [], []
                for i in range(SERVE_PROBES):
                    t0 = time.perf_counter()
                    (r,) = client.predict(client.chunks(100 + i, img, n=1))
                    wall.append((time.perf_counter() - t0) * 1e3)
                    served.append(r.latency_ms)
                    queued.append(r.queue_ms)
                latency[size] = {"client_p50_ms": float(np.percentile(wall, 50)),
                                 "client_p95_ms": float(np.percentile(wall, 95)),
                                 "server_latency_p50_ms": float(np.percentile(served, 50)),
                                 "server_queue_p50_ms": float(np.percentile(queued, 50))}
            log(f"[serve] Predict latency per bucket, {SERVE_PROBES} sequential single-request calls: "
                f"{json.dumps(latency)} [{card}]")

            # ---- a burst on concurrent streams until the autoscaler scales up ----
            def burst(version: int, streams: int, per_stream: int) -> list:
                got, errors = [], []
                img = rng.integers(0, 256, (BUCKET, BUCKET, 3), dtype=np.uint8)

                def one(k):
                    try:
                        reqs = [c for i in range(per_stream) for c in client.chunks(1000 * k + i, img, n=1)]
                        got.extend(client.predict(reqs))
                    except Exception as e:  # re-raised below
                        errors.append(e)

                threads = [threading.Thread(target=one, args=(k,)) for k in range(streams)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=max(1.0, deadline - time.monotonic()))
                if errors or len(got) != streams * per_stream:
                    raise AssertionError(f"burst: {len(got)} answers, errors {errors[:3]}")
                wrong = [(r.status, r.model_version) for r in got if r.status != "OK" or r.model_version != version]
                if wrong:
                    raise AssertionError(f"burst answers off version {version} or not OK: {wrong[:5]}")
                return got

            scale_ups, bursts = 0.0, 0
            while scale_ups < 1 and bursts < SERVE_MAX_BURSTS and time.monotonic() < deadline:
                burst(0, SERVE_BURST_STREAMS, SERVE_BURST_REQUESTS)
                bursts += 1
                scale_ups = sample_value(scrape(metrics_url), "serve_scale_events_total", {"direction": "up"}) or 0
            if scale_ups < 1:
                raise AssertionError(f"no scale-up after {bursts} bursts of {SERVE_BURST_STREAMS} streams")
            log(f"[serve] {bursts} burst(s) of {SERVE_BURST_STREAMS} streams x {SERVE_BURST_REQUESTS} "
                f"bucket-{BUCKET} requests, all OK at version 0; the autoscaler scaled up")

            # ---- StreamPredict across a hot swap ----
            w = client.wire
            call = client.open_stream()
            frames, seen = [], 0

            def frame(fid, image):
                nonlocal seen
                t0 = time.perf_counter()
                r = call.send([w.StreamRequest("cam", w.StreamFrame(fid, image.tobytes(), 0, True))])
                wall = (time.perf_counter() - t0) * 1e3
                if r.status != "OK" or r.model_version < seen:
                    raise AssertionError(f"frame {fid}: {r.status} {r.title!r} v{r.model_version} after v{seen}")
                seen = r.model_version
                (pred,) = client.predict(client.chunks(10_000 + fid, image))
                if pred.model_version != r.model_version or pred.mask != r.mask:
                    raise AssertionError(f"frame {fid} (v{r.model_version}) differs from Predict of the same "
                                         f"image (v{pred.model_version})")
                frames.append({"frame": fid, "version": r.model_version, "tiles_total": r.tiles_total,
                               "tiles_computed": r.tiles_computed, "cache_hits": r.cache_hits,
                               "full_rerun": r.full_rerun, "tracks": len(json.loads(r.tracks_json)),
                               "server_ms": r.latency_ms, "client_ms": wall})
                return r

            def repeat_frames(first_id):
                for k in range(SERVE_REPEATS):
                    r = frame(first_id + k, frame_moved)
                    if r.tiles_computed != 0:
                        raise AssertionError(f"a repeated frame computed {r.tiles_computed} tiles")

            opened = call.send([w.StreamRequest("cam", w.StreamOpen(STREAM_H, STREAM_W, 3, 0.0, True))])
            if opened.status != "OK" or opened.title != "OPENED":
                raise AssertionError(f"StreamOpen answered {opened.status} {opened.title!r}")
            first, same, moved = frame(1, frame0), frame(2, frame0), frame(3, frame_moved)
            if not first.full_rerun or first.tiles_computed != first.tiles_total:
                raise AssertionError(f"the first frame computed {first.tiles_computed}/{first.tiles_total} tiles")
            if same.tiles_computed != 0:
                raise AssertionError(f"the repeated frame computed {same.tiles_computed} tiles")
            if not 0 < moved.tiles_computed < moved.tiles_total:
                raise AssertionError(f"the moved band computed {moved.tiles_computed}/{moved.tiles_total} tiles")
            repeat_frames(10)

            publish_statefile(p["state"], weights[2], model_version=2)
            t_publish, polls = time.monotonic(), 0
            while True:
                (r,) = client.predict(client.chunks(20_000 + polls, mix[1], n=1))
                polls += 1
                if r.model_version < seen:
                    raise AssertionError(f"Predict went back from v{seen} to v{r.model_version}")
                seen = r.model_version
                if seen == 2:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError("version 2 was never served")
                time.sleep(0.05)
            swap_seen_s = time.monotonic() - t_publish
            after = frame(4, frame0)
            if after.model_version != 2 or not after.full_rerun:
                raise AssertionError(f"the first frame on v2: v{after.model_version}, full_rerun {after.full_rerun}")
            frame(5, frame_moved)
            repeat_frames(20)
            if call.send([w.StreamRequest("cam", w.StreamClose())]).title != "CLOSED":
                raise AssertionError("StreamClose was not answered CLOSED")
            call.close()
            burst(2, SERVE_BURST_STREAMS // 2, 4)
            log(f"[serve] stream frames: {json.dumps(frames)}; version 2 served {swap_seen_s:.3f} s after the "
                f"publish; every frame byte-equal to Predict of the same image at its version [{card}]")
            client.close()
            client = None
            server.proc.send_signal(signal.SIGTERM)
            rc = server.wait(deadline)
        finally:
            if client is not None:
                client.close()
            server.kill()
        text = server.text()
        if rc != 0:
            raise AssertionError(f"the serve process exited {rc}:\n{text[-6000:]}")
        report = server.report()
        stats_lines = [ln for ln in text.splitlines() if ln.startswith('{"serve_stats"')]
        if len(stats_lines) != 1:
            raise AssertionError(f"{len(stats_lines)} serve_stats lines:\n{text[-4000:]}")
        stats = json.loads(stats_lines[0])["serve_stats"]

    # ---- what the process reported ----
    forwards = report["quantized_forwards"]
    per_forward = forward_launches(cfg)
    launches = report["dequant_launches"]
    if forwards == 0 or launches != {name: n * forwards for name, n in per_forward.items()}:
        raise AssertionError(f"dequant launches {launches} != {per_forward} per forward x {forwards}")
    gates = [s["quant_gate"] for s in stats["swaps"]] + [stats["quant_gate"]]
    if not all(g is not None and g["passed"] for g in gates) or [s["to_version"] for s in stats["swaps"]] != [2]:
        raise AssertionError(f"swaps {stats['swaps']}, gate {stats['quant_gate']}")
    audit, replicas = stats["autoscaler"], stats["router"]["per_replica"]
    live = [int(i) for i, r in replicas.items() if r["alive"]]
    failed = sum(r["failed"] for r in replicas.values())
    if audit["scale_ups"] < 1 or failed or stats["router"]["shed"]:
        raise AssertionError(f"autoscaler {audit}, failed {failed}, shed {stats['router']['shed']}")
    if any(stats["replica_versions"][i] != 2 for i in live):
        raise AssertionError(f"live replicas {live} hold versions {stats['replica_versions']}")

    # ---- the same requests on a CPU engine: probabilities within SERVE_PROB_TOL ----
    cpu = InferenceEngine(cfg, sc, device="cpu")
    cpu_payload = cpu.prepare_quantized(quant_mod.quantize_for_plane(weights[0], sc.kernel_plane))
    cpu_diff = {}
    for rid in (1, 3, 5):
        probs = cpu.predict_image(cpu_payload, mix[rid])[..., 0]
        got = np.frombuffer(by_id[rid].mask, np.uint8).reshape(probs.shape)
        far = np.abs(probs - 0.5) > SERVE_PROB_TOL
        if not np.array_equal(got[far], ((probs > 0.5).astype(np.uint8) * 255)[far]):
            raise AssertionError(f"request {rid}: the served mask disagrees with a CPU engine away from the threshold")
        cpu_diff[rid] = int((~far).sum())
    out.update({
        "launches": launches,
        "quantized_forwards": forwards,
        "latency_ms": latency,
        "stream_frames": frames,
        "stream": stats["stream"],
        "swaps": stats["swaps"],
        "autoscaler": {k: audit[k] for k in ("evaluations", "scale_ups", "scale_downs", "replica_seconds", "live")},
        "lanes": lanes,
        "in_process_frames": in_process,
        "scale_interval_s": scale_interval_s,
        "start_to_serving_s": t_serving,
        "start_to_first_dequant_launch_s": report["start_to_first_dequant_launch_s"],
        "wall_s": report["wall_s"],
        "cpu_pixels_within_tol_of_threshold": cpu_diff,
    })
    log(f"[serve] exit 0; {forwards} quantized forwards, dequant launches {launches}; gate passed at both "
        f"installs; autoscaler {out['autoscaler']}; fleet swap {stats['swaps'][0]['pause_ms']} ms pause, "
        f"{stats['swaps'][0]['load_ms']} ms prepare; start-up to the first dequant launch "
        f"{report['start_to_first_dequant_launch_s']:.2f} s, to SERVING {t_serving:.2f} s, process wall "
        f"{report['wall_s']:.2f} s; masks agree with a CPU engine away from the threshold "
        f"(pixels within {SERVE_PROB_TOL} of it: {cpu_diff}) [{card}]")
    return out


# ---- phase 15's verdict numbers and their CPU-card bound ----


def probe_probs(engine, payloads: dict) -> dict:
    """``{bucket: (probe batch, {name: probabilities})}``: the shadow's
    seeded probe batch at each of ``engine``'s buckets through each placed
    payload, as the canary and PSI probes run it."""
    from fedcrack_tpu_torch.serve.quant import probe_images

    cfg = engine.serve_config
    out = {}
    for size in engine.bucket_sizes:
        batch = probe_images(size, min(cfg.quant_probe_batch, engine.max_batch), cfg.quant_probe_seed)
        out[size] = (batch, {name: engine.predict_bucket(w, batch) for name, w in payloads.items()})
    return out


def verdict_numbers(probes: dict, prod: str, cand: str) -> dict:
    """The canary IoU (per bucket and its minimum, rounded as the canary
    rounds) and the PSI of candidate ``cand`` against production ``prod``,
    computed from ``probe_probs`` as ``ShadowController.stage`` computes
    them on the engine."""
    from fedcrack_tpu_torch.health.drift import DriftMonitor
    from fedcrack_tpu_torch.serve.quant import mask_iou

    per_bucket = {size: mask_iou(probs[prod], probs[cand]) for size, (_, probs) in probes.items()}
    ref, cur = DriftMonitor(), DriftMonitor()
    for batch, probs in probes.values():
        ref.observe(batch, probs[prod])
        cur.observe(batch, probs[cand])
    return {"iou": round(min(per_bucket.values()), 6), "per_bucket": per_bucket,
            "psi": cur.compare(ref.profile())}


def check_flip_bound(label: str, probes_a: dict, probes_b: dict, got_a: dict, got_b: dict,
                     prod: str, cand: str) -> dict:
    """Hold two sides' verdict numbers (``got_a``, ``got_b``: ``iou``,
    ``per_bucket`` and ``psi``, e.g. a CPU engine's and the card's) to
    their probe probabilities (``probes_a``, ``probes_b``): they may differ
    only by what the values within the two sides' distance of a threshold
    can move. Per bucket, with ``d`` the largest probability distance, the
    k probe pixels within ``d`` of 0.5 bound the IoU to [(I - k) / (U + k),
    (I + k) / (U - k)] of side a's intersection and union; per (bucket,
    signal), the histogram counts may differ by at most twice the values
    of side a within that signal's distance of an interior bin edge, and
    a PSI whose counts agree must be equal. Raises on a violation;
    returns the distances and counts."""
    import numpy as np

    from fedcrack_tpu_torch.health.drift import _EDGES, _hist, signal_values

    d = max(float(np.abs(pa[k].astype(np.float64) - probes_b[size][1][k]).max())
            for size, (_, pa) in probes_a.items() for k in (prod, cand))
    out = {"max_prob_distance": d, "pixels_near_threshold": {}, "values_near_edge": 0}
    bad = []
    for size, (batch, pa) in probes_a.items():
        ma, ca = pa[prod] > 0.5, pa[cand] > 0.5
        k = int(sum(int((np.abs(pa[n] - 0.5) <= d).sum()) for n in (prod, cand)))
        inter, union = int((ma & ca).sum()), int((ma | ca).sum())
        want, got = got_a["per_bucket"][size], got_b["per_bucket"][size]
        out["pixels_near_threshold"][size] = k
        if k == 0:
            ok = round(got, 6) == round(want, 6)
        elif union == 0:
            ok = 0.0 <= got <= 1.0
        else:
            lo = max(0, inter - k) / (union + k)
            hi = 1.0 if union - k <= 0 else min(1.0, (inter + k) / (union - k))
            ok = lo - 5e-7 <= got <= hi + 5e-7
        if not ok:
            bad.append(f"bucket {size} iou {got} vs {want} with {k} pixels within {d:.3g} of 0.5")
        moved = set()
        for role in (prod, cand):
            va, vb = signal_values(batch, pa[role]), signal_values(batch, probes_b[size][1][role])
            if set(va) != set(vb):
                bad.append(f"bucket {size} signals {sorted(va)} vs {sorted(vb)}")
                continue
            for sig in va:
                a, b = np.asarray(va[sig], np.float64).ravel(), np.asarray(vb[sig], np.float64).ravel()
                delta = float(np.abs(a - b).max()) if a.size else 0.0
                near = int((np.abs(a[:, None] - _EDGES[None, 1:-1]) <= delta).any(axis=1).sum()) if delta else 0
                l1 = int(np.abs(np.asarray(_hist(a)) - np.asarray(_hist(b))).sum())
                out["values_near_edge"] += near
                if l1 > 2 * near:
                    bad.append(f"{size}/{sig} ({role}): counts differ by {l1} with {near} values near an edge")
                if l1:
                    moved.add(f"{size}/{sig}")
        for key in sorted(set(got_a["psi"]) | set(got_b["psi"])):
            if key.startswith(f"{size}/") and key not in moved and got_a["psi"].get(key) != got_b["psi"].get(key):
                bad.append(f"psi {key}: {got_b['psi'].get(key)} vs {got_a['psi'].get(key)} with equal counts")
    if bad:
        raise AssertionError(f"{label}: outside the flip bound: {bad}")
    return out


# Phase 15: progressive delivery under load. load_gen's closed loop runs
# SHADOW_REQUESTS requests at 128^2 and 256^2 and publishes version 3 (its
# seeded init) after SHADOW_SWAP_AFTER completions; version 2 is published
# by the smoke as soon as traffic flows, so the controller (polling every
# SHADOW_POLL_S) reads it long before version 3 replaces it in the file.
SHADOW_FRACTION = 0.5
SHADOW_REQUESTS, SHADOW_SWAP_AFTER, SHADOW_CONCURRENCY = 900, 400, 4
SHADOW_POLL_S = 0.1
SHADOW_TIMEOUT_S = 240.0
SHADOW_MASK_SAMPLE = 8
# Version 2: production with the last decoder BatchNorm's bias moved (the
# quantizer keeps BN biases in f32, so the codes and the gate are
# production's). The seeded net is chaotic: on the H100 a move of 1e-3
# flipped enough pixels near 0.5 for an IoU of 0.947 and a PSI of 0.27, a
# rollback (PERF.md).
SHADOW_MOVED_BY = 1e-5


def _counter_sum(parsed: dict, name: str, labels: dict | None = None) -> float:
    """The sum of a scraped family's samples whose labels include ``labels``."""
    fam = parsed.get(name) or {"samples": {}}
    want = set((labels or {}).items())
    return sum(v for k, v in fam["samples"].items() if want <= set(k))


def shadow_cli_phase(torch, card: str) -> dict:
    """Phase 15: ``python -m fedcrack_tpu_torch.serve --shadow-fraction 0.5``
    at full width through CLI_SHIM, ``python -m fedcrack_tpu_torch.tools.load_gen``
    driving it, a promoted and a rolled-back candidate, and
    ``python -m fedcrack_tpu_torch.tools.quantify --pred-dir`` over the served
    masks; each verdict's numbers held to the card in process and to a CPU
    engine within the flip bound."""
    import copy
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.promexp import scrape
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import publish_statefile
    from fedcrack_tpu_torch.tools.load_gen import make_images
    from fedcrack_tpu_torch.tools.quantify import quantify_mask

    t_phase = time.monotonic()
    cfg, sc = ModelConfig(), ServeConfig(quant="int8", kernel_plane="fused_int8")
    prod = quant_mod.dequantize_variables(quant_mod.quantize_for_plane(
        init_variables(torch.Generator().manual_seed(0), cfg), sc.kernel_plane).tree)
    cand = copy.deepcopy(prod)
    moved = cand["params"][f"dec{len(cfg.decoder_features) - 1}_bn2"]
    moved["bias"] = moved["bias"] + np.float32(SHADOW_MOVED_BY)
    # load_gen's --swap-seed 1 init, as it publishes it.
    seeded = init_variables(torch.Generator().manual_seed(1), ModelConfig(img_size=128))
    sizes = tuple(sc.bucket_sizes)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="fedcrack_shadow_") as tmp:
        p = {k: os.path.join(tmp, v) for k, v in (
            ("weights", "v0.msgpack"), ("config", "serve.json"), ("state", "state.bin"),
            ("metrics", "serve.jsonl"), ("masks", "masks"), ("quantify", "quantify.json"))}
        with open(p["weights"], "wb") as f:
            f.write(serialization.tree_to_bytes(prod))
        with open(p["config"], "w", encoding="utf-8") as f:
            json.dump({"serve": {"quant": sc.quant, "kernel_plane": sc.kernel_plane}}, f)
        args = ["--config", p["config"], "--weights", p["weights"], "--state-path", p["state"],
                "--host", "127.0.0.1", "--port", "0", "--replicas", "1", "--shadow-fraction", str(SHADOW_FRACTION),
                "--swap-poll-s", str(SHADOW_POLL_S), "--metrics-path", p["metrics"], "--metrics-port", "-1"]
        deadline = time.monotonic() + SHADOW_TIMEOUT_S
        server = CliProcess("shadow_serve", "fedcrack_tpu_torch.serve", args, tmp)
        procs = [server]
        client = None
        try:
            # ---- meanwhile, the probes in this process: the card and a CPU engine ----
            t0 = time.monotonic()
            engine = InferenceEngine(cfg, sc)
            # Production's payload at versions 0 and 2 (after the promote),
            # and the candidates as the shadow lane places them.
            def place(eng):
                return {0: eng.prepare_quantized(quant_mod.quantize_for_plane(prod, sc.kernel_plane)),
                        2: eng.prepare_quantized(quant_mod.quantize_for_plane(cand, sc.kernel_plane)),
                        "cand": eng.prepare(cand), "seeded": eng.prepare(seeded)}

            served = place(engine)
            card_probes = probe_probs(engine, served)
            cpu = InferenceEngine(cfg, sc, device="cpu")
            cpu_probes = probe_probs(cpu, place(cpu))
            crack_share = {f"v{v}/{size}": float((probs[v] > 0.5).mean())
                           for size, (_, probs) in card_probes.items() for v in (0, 2)}
            if min(crack_share.values()) <= 0:
                raise AssertionError(f"production's probe masks hold no crack pixel: {crack_share}")
            log(f"[shadow] probes on the card and a CPU engine in {time.monotonic() - t0:.2f} s; production's "
                f"probe crack share per version and bucket {crack_share} [{card}]")

            found = None
            while time.monotonic() < deadline:
                found = re.search(r"^SERVING \S+:(\d+) .* metrics_port=(\d+)", server.text(), re.M)
                if found or server.proc.poll() is not None:
                    break
                time.sleep(0.1)
            if not found:
                raise AssertionError(f"the serve process did not report SERVING:\n{server.text()[-6000:]}")
            t_serving = time.time() - server.started
            port, metrics_url = int(found.group(1)), f"http://127.0.0.1:{found.group(2)}/metrics"
            gen = CliProcess("load_gen", "fedcrack_tpu_torch.tools.load_gen", [
                "--target", f"127.0.0.1:{port}", "--requests", str(SHADOW_REQUESTS), "--concurrency",
                str(SHADOW_CONCURRENCY), "--sizes", ",".join(str(s) for s in sizes), "--out-dir", p["masks"],
                "--metrics-url", metrics_url, "--swap-statefile", p["state"], "--swap-after", str(SHADOW_SWAP_AFTER),
                "--swap-version", "3", "--timeout-s", str(SHADOW_TIMEOUT_S)], tmp)
            procs.append(gen)

            # ---- version 2 once traffic flows; then both verdicts ----
            while _counter_sum(scrape(metrics_url), "serve_requests_total") == 0:
                if gen.proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"no traffic reached the server:\n{gen.text()[-4000:]}")
                time.sleep(0.02)
            publish_statefile(p["state"], cand, model_version=2)
            t_publish = time.monotonic()
            client = ServeClient(port)
            probe_image = np.random.default_rng(15).integers(0, 256, (sizes[0], sizes[0], 3), dtype=np.uint8)
            seen, polls, served_s = [], 0, None
            while served_s is None and time.monotonic() < deadline:
                if _counter_sum(scrape(metrics_url), "serve_shadow_verdicts_total", {"verdict": "rollback"}):
                    server.proc.send_signal(signal.SIGTERM)
                    server.wait(deadline)
                    raise AssertionError(f"version 2 was rolled back:\n{server.text()[-6000:]}")
                (r,) = client.predict(client.chunks(50_000 + polls, probe_image, n=1))
                polls += 1
                seen.append(r.model_version)
                if r.model_version == 2:
                    served_s = time.monotonic() - t_publish
                time.sleep(0.02)
            if served_s is None:
                raise AssertionError(f"version 2 was never served:\n{server.text()[-4000:]}")
            verdict_s = {}
            while len(verdict_s) < 2 and time.monotonic() < deadline:
                parsed = scrape(metrics_url)
                for v in ("promote", "rollback"):
                    if v not in verdict_s and _counter_sum(parsed, "serve_shadow_verdicts_total", {"verdict": v}):
                        verdict_s[v] = time.monotonic() - t_publish
                time.sleep(0.02)
            rc_gen = gen.wait(deadline)
            time.sleep(5 * SHADOW_POLL_S)  # later polls: version 3 must not stage again
            parsed = scrape(metrics_url)
            mirrored = _counter_sum(parsed, "serve_shadow_mirrored_total")
            failures = _counter_sum(parsed, "serve_shadow_failures_total")
            client.close()
            client = None
            server.proc.send_signal(signal.SIGTERM)
            rc = server.wait(deadline)
        finally:
            if client is not None:
                client.close()
            for pr in procs:
                pr.kill()
        text = server.text()
        if rc != 0 or rc_gen != 0:
            raise AssertionError(f"serve exited {rc}, load_gen {rc_gen}:\n{text[-4000:]}\n{gen.text()[-4000:]}")
        report = server.report()
        (stats_line,) = [ln for ln in text.splitlines() if ln.startswith('{"serve_stats"')]
        stats = json.loads(stats_line)["serve_stats"]
        (gen_line,) = [ln for ln in gen.text().splitlines() if ln.startswith('{"mode"')]
        summary = json.loads(gen_line)

        # ---- what the client saw ----
        if summary["dropped"] or summary["rejected"] or summary["shed"] or not summary["swap_published"]:
            raise AssertionError(f"load_gen: {gen_line[:2000]}")
        versions = {int(v) for v in summary["versions_observed"]} | set(seen)
        if not versions <= {0, 1, 2} or 2 not in versions:
            raise AssertionError(f"responses stamped {sorted(versions)}; 0 or 1 and 2 expected, never 3")
        images = make_images(SHADOW_REQUESTS, sizes, 0)
        stamped = {int(k): v for k, v in summary["mask_versions"].items()}
        sample = []
        for v in (0, 2):
            rids = sorted(r for r in stamped if stamped[r] == v)
            sample += rids[:: max(1, len(rids) // (SHADOW_MASK_SAMPLE // 2))][: SHADOW_MASK_SAMPLE // 2]
        for rid in sample:
            got = cv2.imread(os.path.join(p["masks"], f"mask_{rid:05d}.png"), cv2.IMREAD_GRAYSCALE)
            if got.tobytes() != _mask(engine.predict_image(served[stamped[rid]], images[rid])):
                raise AssertionError(f"mask {rid} differs from the card engine at version {stamped[rid]}")
        log(f"[shadow] load_gen: {summary['completed']} answered in {summary['wall_s']} s "
            f"({summary['throughput_rps']} req/s), versions {summary['versions_observed']}, client p50/p95 "
            f"{summary['latency_ms']['p50']:.2f}/{summary['latency_ms']['p95']:.2f} ms, server p50/p95 "
            f"{summary['server_latency_ms']['p50']:.2f}/{summary['server_latency_ms']['p95']:.2f} ms, replicas "
            f"{summary['fleet']['replicas_min']}-{summary['fleet']['replicas_max']}; {len(sample)} sampled "
            f"masks byte-equal to the card engine at their stamped version [{card}]")

        # ---- the verdicts ----
        shadow = stats["shadow"]
        if (shadow["staged"], shadow["promoted"], shadow["rolled_back"]) != (2, 1, 1):
            raise AssertionError(f"shadow audit {json.dumps(shadow)[:3000]}")
        promoted, rolled = shadow["verdicts"]
        checks = {
            "promote": promoted["version"] == 2 and promoted["verdict"] == "promote" and promoted["installed"]
            and promoted["iou"] >= 0.98 and promoted["psi_max"] <= 0.25 and promoted["latency_factor"] is not None
            and promoted["latency_factor"] <= 3.0 and promoted["completed"] >= sc.shadow_min_samples,
            "rollback": rolled["version"] == 3 and rolled["verdict"] == "rollback" and not rolled["installed"]
            and any(r.startswith("canary iou") for r in rolled["reasons"]),
            "crack_fraction": all(f"{s}/crack_fraction" in v["psi"] for v in (promoted, rolled) for s in sizes),
            "mirrored": mirrored > 0 and failures == 0 and promoted["shadow_failures"] == rolled["shadow_failures"] == 0,
            "swaps": [w["to_version"] for w in stats["swaps"]] == [2] and stats["replica_versions"] == [2]
            and all(w["quant_gate"]["passed"] for w in stats["swaps"]),
        }
        if not all(checks.values()):
            raise AssertionError(f"phase 15 checks {checks}: {json.dumps(shadow)[:4000]}")
        bounds = {}
        if (promoted["baseline_version"], rolled["baseline_version"]) != (0, 2):
            raise AssertionError(f"baselines {promoted['baseline_version']}, {rolled['baseline_version']} != 0, 2")
        for record, name in ((promoted, "cand"), (rolled, "seeded")):
            base = record["baseline_version"]
            card_n = verdict_numbers(card_probes, base, name)
            if card_n["iou"] != record["iou"] or card_n["psi"] != record["psi"]:
                raise AssertionError(f"v{record['version']}: the server's iou {record['iou']} / psi {record['psi']} "
                                     f"!= the card in process {card_n['iou']} / {card_n['psi']}")
            cpu_n = verdict_numbers(cpu_probes, base, name)
            bounds[record["version"]] = check_flip_bound(f"v{record['version']}", cpu_probes, card_probes, cpu_n,
                                                         card_n, base, name)
            cpu_axes = (cpu_n["iou"] >= sc.shadow_iou_floor, max(cpu_n["psi"].values()) <= sc.shadow_psi_ceiling)
            card_axes = (record["iou"] >= sc.shadow_iou_floor, record["psi_max"] <= sc.shadow_psi_ceiling)
            if cpu_axes != card_axes:
                raise AssertionError(f"v{record['version']}: the CPU engine decides {cpu_axes}, the card {card_axes}")
            bounds[record["version"]].update(cpu_iou=cpu_n["iou"], cpu_psi_max=max(cpu_n["psi"].values()))
        per_forward = forward_launches(cfg)
        forwards, launches = report["quantized_forwards"], report["dequant_launches"]
        if forwards == 0 or launches != {name: n * forwards for name, n in per_forward.items()}:
            raise AssertionError(f"dequant launches {launches} != {per_forward} per forward x {forwards}")

        # ---- the served masks through the quantify command line ----
        def stats(name):
            st = quantify_mask(cv2.imread(os.path.join(p["masks"], name), cv2.IMREAD_GRAYSCALE))
            return {"image": name, "contours": st.contour_count, "area_px": st.total_area_px,
                    "perimeter_px": st.total_perimeter_px, "crack_fraction": st.crack_fraction}

        quant = CliProcess("quantify", "fedcrack_tpu_torch.tools.quantify",
                           ["--pred-dir", p["masks"], "--out-json", p["quantify"]], tmp)
        with ThreadPoolExecutor(os.cpu_count()) as pool:  # cv2 releases the GIL
            want = list(pool.map(stats, sorted(os.listdir(p["masks"]))))
        run_processes([quant], time.monotonic() + SHADOW_TIMEOUT_S)
        quantify_s = quant.wall_s
        with open(p["quantify"], encoding="utf-8") as f:
            quantified = json.load(f)
        if quantified["images"] != want or quantified["totals"]["images"] != SHADOW_REQUESTS \
                or quantified["totals"]["contours"] != sum(r["contours"] for r in want):
            raise AssertionError("quantify --pred-dir disagrees with quantify_mask over the same PNGs")
    out.update({
        "launches": launches,
        "quantized_forwards": forwards,
        "verdicts": [{k: v[k] for k in ("version", "verdict", "reasons", "iou", "psi_max", "latency_factor",
                                         "shadow_p95_ms", "production_p95_ms", "mirrored", "completed")}
                     for v in (promoted, rolled)],
        "flip_bounds": bounds,
        "probe_crack_share": crack_share,
        "publish_to_served_s": served_s,
        "publish_to_verdict_s": verdict_s,
        "mirrored_total": mirrored,
        "load_gen": {k: summary[k] for k in ("completed", "wall_s", "throughput_rps", "versions_observed",
                                             "latency_ms", "server_latency_ms", "fleet")},
        "quantify": {"images": quantified["totals"]["images"], "contours": quantified["totals"]["contours"],
                     "seconds": quantify_s},
        "start_to_serving_s": t_serving,
        "start_to_first_dequant_launch_s": report["start_to_first_dequant_launch_s"],
        "wall_s": report["wall_s"],
        "phase_s": time.monotonic() - t_phase,
    })
    log(f"[shadow] verdicts {json.dumps(out['verdicts'])}; version 2 served {served_s:.3f} s after its publish, "
        f"verdicts at {json.dumps(verdict_s)} s; flip bounds {json.dumps(bounds)}; {forwards} quantized forwards, "
        f"dequant launches {launches}; mirrored {mirrored:.0f}, 0 shadow failures; quantify --pred-dir over "
        f"{quantified['totals']['images']} masks in {quantify_s:.2f} s equal to quantify_mask; start-up to SERVING "
        f"{t_serving:.2f} s, serve wall {report['wall_s']:.2f} s, phase {out['phase_s']:.2f} s [{card}]")
    return out


# Phase 16's update-level DP: each client's clip norm, noise multiplier
# (noise of standard deviation 0.005 per parameter) and seed, and the
# accountant's noise steps per round (one epoch of 64 samples at batch 16)
# and sampling rate (a batch of a shard). The secagg round's deadline, long
# enough for two full-width fits, their masking and uploads.
DP_CLIP, DP_SIGMA, DP_SEED, DP_STEPS = 0.01, 0.5, 11, 4
SECAGG_DEADLINE_S = 10.0


def dp_grpc_run(torch, fs: dict, card: str) -> dict:
    """Phase 16 (a): phase 9's federation over gRPC with update-level DP on
    both clients (the client command line's ``private_train_fn``) and the
    server charging the accountant and evaluating each global. Each upload
    is held to ``dp_update_host`` of the (trained, base) pair its client
    fitted, each round's epsilon to ``compute_epsilon``, and the privacy
    summary to ``tools/health_report``."""
    import dataclasses
    import tempfile

    from fedcrack_tpu_torch.client import private_train_fn
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.health.ledger import write_ledger_jsonl
    from fedcrack_tpu_torch.ioutils import atomic_write_bytes
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.privacy.accountant import compute_epsilon
    from fedcrack_tpu_torch.privacy.dpsgd import dp_update_host
    from fedcrack_tpu_torch.tools.health_report import build_report, validate_report

    q = TRAIN_BATCH / 64
    server_cfg = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05,
                                     dp_clip_norm=DP_CLIP, dp_noise_multiplier=DP_SIGMA, dp_sample_rate=q,
                                     dp_steps_per_round=DP_STEPS)
    client_cfg = dataclasses.replace(fs["cfg"], dp_clip_norm=DP_CLIP, dp_noise_multiplier=DP_SIGMA, dp_seed=DP_SEED)
    pairs = {}

    def dp_client_fn(i, name):
        fit = fs["client_fn"](i, name)

        def recording(blob, rnd, hparams):
            out, n_samples, metrics = fit(blob, rnd, hparams)
            pairs[(name, rnd)] = (blob, out)
            return out, n_samples, metrics

        return private_train_fn(recording, client_cfg, name)

    eval_batches = [0]
    bce.reset_launch_counts()
    run = grpc_federation(torch, dict(fs, client_fn=dp_client_fn), server_cfg, eval_fn=held_out_eval(fs, eval_batches))
    launches = bce.bce_sums.launches
    state, names = run["state"], fs["names"]
    if any(run["results"][n].rounds_completed != 2 for n in names) or state.model_version != 2:
        raise AssertionError(f"DP sessions {run['results']}, state at version {state.model_version}")
    if sorted((u[0], u[1]) for u in run["uploads"]) != sorted(pairs):
        raise AssertionError(f"DP uploads {[(u[0], u[1]) for u in run['uploads']]}, fits {sorted(pairs)}")
    dp_ms = []
    for name, rnd, upload, _ in run["uploads"]:
        base_blob, trained_blob = pairs[(name, rnd)]
        t0 = time.perf_counter()
        base = serialization.tree_from_bytes(base_blob)
        private = dp_update_host(serialization.tree_from_bytes(trained_blob, template=base), base,
                                 clip_norm=DP_CLIP, noise_multiplier=DP_SIGMA, dp_seed=DP_SEED, cname=name,
                                 round_idx=rnd)
        want = serialization.tree_to_bytes(private)
        dp_ms.append(1e3 * (time.perf_counter() - t0))
        if upload != want or upload == trained_blob:
            raise AssertionError(f"{name} round {rnd}: the upload is not dp_update_host of its fit")
    for h in state.history:
        want = {n: round(compute_epsilon(q, DP_SIGMA, DP_STEPS * h["round"], server_cfg.dp_delta), 6) for n in names}
        if h["epsilon"] != want:
            raise AssertionError(f"round {h['round']}: epsilon {h['epsilon']}, the accountant gives {want}")
    check_server_evals(run["server"], [1, 2])
    if launches != run["steps"] + eval_batches[0] or run["steps"] != 16:
        raise AssertionError(f"bce_sums launches {launches} != {run['steps']} steps + {eval_batches[0]} eval batches")
    summary = rounds.privacy_summary(state)
    with tempfile.TemporaryDirectory() as tmp:
        ledger_path, privacy_path = os.path.join(tmp, "ledger.jsonl"), os.path.join(tmp, "privacy.json")
        write_ledger_jsonl(state.ledger, ledger_path)
        atomic_write_bytes(privacy_path, json.dumps(summary, sort_keys=True, indent=2).encode("utf-8"))
        problems = validate_report(build_report(ledger_path, privacy_path=privacy_path))
    if problems:
        raise AssertionError(f"health_report on the privacy summary: {problems}")
    out = {"launches": launches, "steps": run["steps"], "eval_batches": eval_batches[0],
           "epsilon": [h["epsilon"] for h in state.history], "max_epsilon": summary["dp"]["max_epsilon"],
           "round_wall_s": [h["wall_clock_s"] for h in state.history], "session_wall_s": run["wall_s"],
           "host_dp_ms": dp_ms, "eval_loss": [e["loss"] for e in run["server"].eval_history]}
    log(f"[privacy] DP over gRPC: every upload byte-equal to dp_update_host of its kept (trained, base) pair, "
        f"each round's epsilon equal to compute_epsilon, health_report clean; {json.dumps(out)} [{card}]")
    return out


def secagg_dropout_run(torch, fs: dict, card: str) -> dict:
    """Phase 16 (b): secure aggregation over gRPC. Three clients enroll
    with their seeds; client_0 and client_1 fit on the card and upload
    masked trees (port ``FedClient`` sessions), client_2 announces, uploads
    its plaintext (REJECTED) and stops, and the deadline closes the round
    on the two survivors. The global must be bit for bit the survivors'
    fixed-point mean computed here from their plaintext fits, within the
    fixed-point step of their float FedAvg."""
    import dataclasses
    import threading

    import numpy as np

    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.fed.algorithms import fedavg
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.privacy import secagg
    from fedcrack_tpu_torch.transport import FedClient, FedServer, wire
    from fedcrack_tpu_torch.transport.service import ServerThread

    names, dropped = fs["names"], "client_2"
    cfg = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05, max_rounds=1,
                              cohort_size=3, secagg=True, round_deadline_s=SECAGG_DEADLINE_S)
    fits, uploads, plain = {}, {}, {}

    class RecordingClient(FedClient):
        def _call(self, method, msg):
            if msg.kind == "done":
                uploads[self.cname] = (msg.msg.weights, msg.msg.sample_count)
            return super()._call(method, msg)

    def train_fn(i, name):
        fit = fs["client_fn"](i, name)

        def recording(blob, rnd, hparams):
            out, n_samples, metrics = fit(blob, rnd, hparams)
            plain[name] = (out, n_samples)
            return out, n_samples, metrics

        return recording

    bce.reset_launch_counts()
    server = FedServer(cfg, fs["global0"], tick_period_s=0.05)
    results, errors = {}, []
    with ServerThread(server) as st:
        clients = [RecordingClient(cfg, train_fn(i, n), cname=n, port=st.port) for i, n in enumerate(names)]

        def run(c):
            try:
                results[c.cname] = c.run_session()
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        calls = one_message_callers(cfg, [dropped], st.port)
        channel, call = calls[dropped]
        call(wire.ReadyReq(config={"current_round": 0, "__secagg_seed": secagg.client_seed(dropped)}))
        deadline = time.monotonic() + 60
        while "__secagg_roster" not in (notice := call(wire.TrainingNotice(round=1))).config:
            if time.monotonic() > deadline:
                raise AssertionError("the secagg roster never reached the third client")
            time.sleep(0.05)
        plaintext = call(wire.TrainDone(round=1, weights=serialization.tree_to_bytes(fs["global0"]), sample_count=64))
        channel.close()  # the third client stops here
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"a secagg client failed or hung: {errors}")
        state = st.state
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    roster = json.loads(notice.config["__secagg_roster"])
    if plaintext.status != rounds.REJECTED or "bad magic" not in plaintext.config["reason"]:
        raise AssertionError(f"the plaintext upload was answered {plaintext.status} {dict(plaintext.config)}")
    entry = state.history[-1] if state.history else {}
    if state.model_version != 1 or entry.get("secagg") != {"maskers": names, "recovered": [dropped], "bits": 24}:
        raise AssertionError(f"secagg round: version {state.model_version}, history {entry}")
    if sorted(roster) != [*names, dropped] or entry["rejected"].get(dropped) != "not a secagg masked blob (bad magic)":
        raise AssertionError(f"roster {sorted(roster)}, rejected {entry['rejected']}")
    if any(results[n].rounds_completed != 1 or results[n].final_weights != state.global_blob for n in names):
        raise AssertionError(f"survivor sessions {results}")
    trees = [serialization.tree_from_bytes(plain[n][0], template=fs["global0"]) for n in names]
    counts = [plain[n][1] for n in names]
    t0 = time.perf_counter()
    mixed = secagg.round_roster(roster, 1)
    masked = [secagg.mask_update(t, cname=n, n_samples=c, roster=mixed) for n, t, c in zip(names, trees, counts)]
    mask_ms = 1e3 * (time.perf_counter() - t0) / len(names)
    if masked != [uploads[n][0] for n in names]:
        raise AssertionError("a survivor's upload is not mask_update of its fit against the roster")
    t0 = time.perf_counter()
    total, n_total, recovered = secagg.unmask_sum({n: secagg.decode_masked(uploads[n][0]) for n in names}, mixed)
    unmasked = secagg.unmasked_mean(total, n_total, serialization.tree_from_bytes(state.global_blob))
    unmask_ms = 1e3 * (time.perf_counter() - t0)
    exact = secagg.fixed_point_decode(secagg.weighted_fixed_sum(trees, counts), sum(counts), 24, fs["global0"])
    if serialization.tree_to_bytes(exact) != state.global_blob or recovered != [dropped]:
        raise AssertionError("the secagg global is not the survivors' fixed-point mean")
    if serialization.tree_to_bytes(unmasked) != state.global_blob:
        raise AssertionError("the uploads do not unmask to the server's global")
    step = 2.0 ** -24
    steps_off = 0.0
    for g, f in zip(tree_leaves(exact), tree_leaves(fedavg(trees, counts))):
        g32, f32 = np.asarray(g, np.float32), np.asarray(f, np.float32)
        g64, f64 = g32.astype(np.float64), f32.astype(np.float64)
        # The fixed-point step, and an ulp of each float32 rounding.
        bound = step + 2 * np.spacing(np.maximum(np.abs(g32), np.abs(f32))).astype(np.float64)
        if not (np.abs(g64 - f64) <= bound).all():
            raise AssertionError("the secagg global is not within the fixed-point step of the float FedAvg")
        steps_off = max(steps_off, float(np.max(np.abs(g64 - f64))) / step)
    if launches != 8:  # two survivors, one epoch of 4 steps each
        raise AssertionError(f"bce_sums launches {launches} != 8 survivor steps")
    out = {"launches": launches, "steps": 8, "round_wall_s": entry["wall_clock_s"], "session_wall_s": wall,
           "mask_ms": mask_ms, "unmask_ms": unmask_ms, "close_transition_ms": 1e3 * server.transition_s.get(1, 0.0),
           "masked_bytes": len(uploads[names[0]][0]), "plain_bytes": len(plain[names[0]][0]),
           "wire_ratio_masked_over_plain": len(uploads[names[0]][0]) / len(plain[names[0]][0]),
           "max_diff_vs_float_fedavg_in_fixed_point_steps": steps_off}
    log(f"[privacy] secagg over gRPC with a dropout: {dropped}'s plaintext REJECTED, the deadline closed the round "
        f"on {names}, the global bit-equal to their fixed-point mean and to the unmask of their uploads; "
        f"{json.dumps(out)} [{card}]")
    return out


def ckpt_resume_serve_run(torch, fs: dict, card: str) -> dict:
    """Phase 16 (c): a ``FedServer(checkpointer=)`` runs round 1 with card
    fits and is stopped; a new one on the same directory resumes at round 2
    with round 1's global and runs round 2; then a fused_int8
    ``ModelVersionManager(ckpt_dir=)`` installs the checkpointed version 2
    and serves one bucket batch through the dequant kernels (15 / 8 / 6 / 0),
    within phase 4's limit of a CPU engine on the same weights."""
    import dataclasses
    import tempfile

    import numpy as np

    from fedcrack_tpu_torch.ckpt import FedCheckpointer, restore_server_state
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager
    from fedcrack_tpu_torch.transport import FedServer, wire
    from fedcrack_tpu_torch.transport.service import ServerThread

    names = fs["names"]
    cfg = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05)
    fits = {name: fs["client_fn"](i, name) for i, name in enumerate(names)}

    def one_round(server):
        """Every client enrolls, pulls, fits on the card and uploads, one
        message a call; returns the pulled blob and the last reply."""
        with ServerThread(server) as st:
            calls = one_message_callers(cfg, names, st.port)
            for name in names:
                calls[name][1](wire.ReadyReq(config={"current_round": 0}))
            for name in names:
                pull = calls[name][1](wire.PullReq())
                rnd = int(pull.config["current_round"])
                calls[name][1](wire.TrainingNotice(round=rnd))
                blob, n_samples, _ = fits[name](pull.weights, rnd, dict(pull.config))
                reply = calls[name][1](wire.TrainDone(round=rnd, weights=blob, sample_count=n_samples))
            for channel, _ in calls.values():
                channel.close()
        return pull.weights, reply

    bce.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        first = FedServer(cfg, fs["global0"], tick_period_s=0.05, checkpointer=FedCheckpointer(ckpt_dir))
        _, reply = one_round(first)  # the stop drains the checkpoint save
        if reply.status != rounds.RESP_ARY or [c["model_version"] for c in first.checkpoints] != [1]:
            raise AssertionError(f"round 1 answered {reply.status}, checkpoints {list(first.checkpoints)}")
        t0 = time.perf_counter()
        restored = restore_server_state(FedCheckpointer(ckpt_dir), cfg, fs["global0"])
        restore_ms = 1e3 * (time.perf_counter() - t0)
        second = FedServer(cfg, fs["global0"], tick_period_s=0.05, checkpointer=FedCheckpointer(ckpt_dir))
        resumed = second.state
        if (resumed.current_round, resumed.model_version, resumed.phase) != (2, 1, rounds.PHASE_ENROLL) or \
                resumed.global_blob != first.state.global_blob or restored.global_blob != resumed.global_blob:
            raise AssertionError(f"resumed at round {resumed.current_round}, version {resumed.model_version}, "
                                 f"phase {resumed.phase}, same global {resumed.global_blob == first.state.global_blob}")
        pulled, reply = one_round(second)
        if pulled != first.state.global_blob or reply.status != rounds.FIN or second.state.model_version != 2:
            raise AssertionError(f"round 2 after the resume: {reply.status} at version {second.state.model_version}")
        if [c["model_version"] for c in second.checkpoints] != [2] or len(second.state.history) != 2:
            raise AssertionError(f"checkpoints {list(second.checkpoints)}, history {len(second.state.history)}")
        launches = bce.bce_sums.launches
        if launches != 16:
            raise AssertionError(f"bce_sums launches {launches} != 16 train steps")
        sc = ServeConfig(quant="int8", kernel_plane="fused_int8")
        engine = InferenceEngine(fs["cfg"].model, sc)
        manager = ModelVersionManager(engine, fs["global0"], ckpt_dir=ckpt_dir, template=fs["global0"])
        if not manager.poll_once() or manager.version != 2:
            raise AssertionError(f"poll_once did not install checkpoint version 2 (at {manager.version})")
    gate = manager.last_quant_gate
    _, payload = manager.snapshot()
    weights = serialization.tree_from_bytes(second.state.global_blob, template=fs["global0"])
    # What the gate's IoU compared: the probe's crack share under the
    # reference program.
    probe = quant_mod.probe_images(BUCKET, sc.quant_probe_batch, sc.quant_probe_seed)
    positive = float(np.mean(engine.predict_bucket(engine.prepare(weights), probe) > 0.5))
    if not gate["passed"] or not isinstance(payload, quant_mod.QuantizedVariables):
        raise AssertionError(f"the checkpointed version is not served quantized: gate {gate}, crack share {positive}")
    batch = np.random.default_rng(6).integers(0, 256, (BATCH, BUCKET, BUCKET, 3), dtype=np.uint8)
    counted, profiled, probs = served_batch_launches(torch, engine, payload, batch)
    cpu = InferenceEngine(fs["cfg"].model, sc, device="cpu")
    want = cpu.predict_bucket(cpu.prepare(quant_mod.quantize_for_plane(weights, "fused_int8")), batch)
    err = float(np.max(np.abs(probs.astype(np.float64) - want)))
    if not err < SERVE_PROB_TOL:
        raise AssertionError(f"served batch {err} from the CPU engine on the checkpointed weights")
    saves = [c["ms"] for c in first.checkpoints] + [c["ms"] for c in second.checkpoints]
    out = {"launches": launches, "steps": 16, "checkpoint_save_ms": saves, "checkpoint_restore_ms": restore_ms,
           "install_ms": manager.last_swap["load_ms"], "gate": gate, "probe_crack_share": positive,
           "served_launches": counted,
           "served_max_abs_err_vs_cpu": err}
    log(f"[ckpt] a FedServer stopped after round 1 resumed from its checkpoint at round 2 with round 1's global, "
        f"ran round 2, and ModelVersionManager(ckpt_dir=) served version 2 quantized; one bucket-{BUCKET} batch "
        f"of {BATCH} launched {json.dumps(profiled)} (profiler); {json.dumps(out)} [{card}]")
    return out


def privacy_ckpt_phase(torch, card: str) -> dict:
    """Phase 16: the privacy plane and the round checkpointer at phase 7's
    full width over loopback gRPC, port peers only: (a) DP, (b) secagg with
    a dropout, (c) a checkpoint resume served through the dequant
    kernels. Returns the ``bce_sums`` launches of all three and the served
    batch's dequant launches."""
    t0 = time.monotonic()
    fs = federation_setup(torch)
    dp = dp_grpc_run(torch, fs, card)
    sa = secagg_dropout_run(torch, fs, card)
    ck = ckpt_resume_serve_run(torch, fs, card)
    out = {"launches": dp["launches"] + sa["launches"] + ck["launches"], "served_launches": ck["served_launches"],
           "phase_s": time.monotonic() - t0}
    log(f"[privacy] phase 16 wall {out['phase_s']:.2f} s; bce_sums launches {out['launches']} = "
        f"{dp['steps'] + sa['steps'] + ck['steps']} train steps + {dp['eval_batches']} eval batches [{card}]")
    return out


# ---- phase 17: the chaos plane, bf16 compute and the watch layer ----

CHAOS_NAMES = ("client_0", "client_1", "client_2")
CHAOS_SHARD = 32  # samples per chaos client: two steps of TRAIN_BATCH
# The round deadline: many times a round of three fits on the card, so only
# a dead or rejected client ever waits for it.
CHAOS_DEADLINE_S = 5.0
CHAOS_TIMEOUT_S = 300.0
# configs/c5_bf16_batch_dp.json's image size and batch; the card-vs-CPU
# step runs at c5's image size on BF16_CHECK_BATCH images (phase 7's
# pixels per step, so the CPU side costs what phase 7's does).
BF16_SIZE, BF16_BATCH, BF16_CHECK_BATCH = 256, 32, 4
BF16_STEP = 2.0 ** -8
WATCH_RULES = "configs/slo_default.json"


def chaos_setup(torch) -> dict:
    """Phase 7's model, image size, data and held-out set, cut into three
    clients of ``CHAOS_SHARD`` samples."""
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.train.federated import make_train_fn

    fs = federation_setup(torch)
    shards = {name: slice(CHAOS_SHARD * i, CHAOS_SHARD * (i + 1)) for i, name in enumerate(CHAOS_NAMES)}

    def client_fn(i, name):
        data = ArrayDataset(fs["imgs"][shards[name]], fs["msks"][shards[name]], batch_size=TRAIN_BATCH, seed=i)
        return make_train_fn(fs["cfg"], data, TRAIN_BATCH, seed=i)[0]

    return {**fs, "names": list(CHAOS_NAMES), "client_fn": client_fn}


def chaos_federation(torch, fs: dict, server_cfg, plans: dict, eval_counter: list, kill: dict | None = None) -> dict:
    """One federation over loopback gRPC with a ``ClientChaos`` per client
    named in ``plans``, the server a ``recording_server_class`` one: every
    ``TrainDone`` it applied, as it crossed the wire (poison included), in
    the order it applied them, with its reply's status, is in ``sent``. A
    client's exception is its result. With ``kill``
    (``round``, ``survivor``, ``victim``) the victim's fit of that round
    waits until the statefile holds the survivor's upload, the server is
    killed (``ServerThread.kill``), a fresh ``FedServer`` boots from the
    statefile on the same port and must resume that round, and the victim
    goes on against it."""
    import dataclasses
    import threading

    from fedcrack_tpu_torch.chaos import ClientChaos
    from fedcrack_tpu_torch.ckpt import load_state_file
    from fedcrack_tpu_torch.fed import rounds
    from fedcrack_tpu_torch.transport import FedClient
    from fedcrack_tpu_torch.transport.service import ServerThread

    server_cls = recording_server_class()
    steps, lock = [0], threading.Lock()
    waiting, release = threading.Event(), threading.Event()

    def fit_fn(i, name):
        fit = fs["client_fn"](i, name)

        def train_fn(blob, rnd, hparams):
            if kill is not None and (name, rnd) == (kill["victim"], kill["round"]):
                waiting.set()
                if not release.wait(CHAOS_TIMEOUT_S):
                    raise AssertionError("the restarted server never released the victim")
            out, n_samples, metrics = fit(blob, rnd, hparams)
            with lock:
                steps[0] += n_samples // TRAIN_BATCH
            return out, n_samples, metrics

        return train_fn

    def eval_fn(blob):
        return held_out_eval(fs, eval_counter)(blob)

    servers = [server_cls(server_cfg, fs["global0"], tick_period_s=0.05, eval_fn=eval_fn)]
    st = ServerThread(servers[0]).__enter__()
    results, out = {}, {}
    t0 = time.perf_counter()
    try:
        clients = [FedClient(server_cfg, fit_fn(i, name), cname=name, port=st.port, max_retries=8,
                             chaos=ClientChaos(plans[name]) if name in plans else None)
                   for i, name in enumerate(fs["names"])]

        def run(c):
            try:
                results[c.cname] = c.run_session()
            except Exception as e:  # the exception is the result; checked by the caller
                results[c.cname] = e

        threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
        for t in threads:
            t.start()
        if kill is not None:
            deadline = time.monotonic() + CHAOS_TIMEOUT_S
            while True:
                s = load_state_file(server_cfg.state_path, server_cfg)
                if (s is not None and s.current_round == kill["round"] and kill["survivor"] in s.received
                        and waiting.is_set()):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError("never reached the mid-round kill point")
                time.sleep(0.01)
            st.kill()
            t_kill = time.perf_counter()
            servers.append(server_cls(dataclasses.replace(server_cfg, port=st.port), fs["global0"],
                                      tick_period_s=0.05, eval_fn=eval_fn))
            resumed = (servers[-1].state.current_round, sorted(servers[-1].state.received))
            if resumed != (kill["round"], [kill["survivor"]]):
                raise AssertionError(f"the restarted server resumed at {resumed}, want round {kill['round']} "
                                     f"holding {kill['survivor']}'s upload")
            st = ServerThread(servers[-1]).__enter__()
            out["restart_s"] = time.perf_counter() - t_kill
            release.set()
        for t in threads:
            t.join(timeout=CHAOS_TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a chaos client hung")
        state = st.state
    finally:
        release.set()
        st.__exit__(None, None, None)
    torch.cuda.synchronize()
    sent = [(e.cname, e.round, e.blob, e.num_samples, status)
            for s in servers for e, status in s.applied if isinstance(e, rounds.TrainDone)]
    out.update({"state": state, "results": results, "sent": sent, "steps": steps[0], "servers": servers,
                "wall_s": time.perf_counter() - t0})
    return out


def replay_chaos(server_cfg, global0, names, sent) -> tuple:
    """``fed.rounds.transition`` in process fed what reached the server:
    Ready in name order, each round's uploads in the order the server
    applied them, and where the round is still open after them, the
    deadline's Tick. Returns the final state, each round's global and the
    replay's reply statuses beside the server's."""
    from fedcrack_tpu_torch.fed import rounds

    state = rounds.initial_state(server_cfg, global0)
    t = 0.0
    for name in names:
        state, _ = rounds.transition(state, rounds.Ready(name, now=t))
    globals_, statuses = [], []
    for rnd in range(1, server_cfg.max_rounds + 1):
        for name, r, blob, n_samples, status in [u for u in sent if u[1] == rnd]:
            t += 1e-3
            state, reply = rounds.transition(state, rounds.TrainDone(name, round=r, blob=blob,
                                                                     num_samples=n_samples, now=t))
            statuses.append((name, r, reply.status, status))
        if state.current_round == rnd:
            t += server_cfg.round_deadline_s + 1.0
            state, _ = rounds.transition(state, rounds.Tick(now=t))
        globals_.append(state.global_blob)
    return state, globals_, statuses


def check_chaos_run(label: str, run: dict, server_cfg, fs: dict, want_history: list, want_results: dict) -> dict:
    """The run's history against what its plan predicts (each round's
    clients, and its rejected clients each with a fragment of its reason),
    every session's outcome, and each round's global byte-equal to the
    in-process round machine fed the same wire bytes (whose fold takes only
    the accepted uploads)."""
    state = run["state"]
    got = [(h["round"], sorted(h["clients"]), {k: v for k, v in h["rejected"].items()}) for h in state.history]
    if [(r, c, sorted(rej)) for r, c, rej in got] != [(r, c, sorted(rej)) for r, c, rej in want_history]:
        raise AssertionError(f"[{label}] history {got} != the plan's {want_history}")
    for (_, _, rej), (_, _, want) in zip(got, want_history):
        for name, frag in want.items():
            if frag not in rej[name]:
                raise AssertionError(f"[{label}] {name} rejected for {rej[name]!r}, want {frag!r}")
    for name, want in want_results.items():
        res = run["results"][name]
        if isinstance(want, type):
            if not isinstance(res, want):
                raise AssertionError(f"[{label}] {name} ended with {res!r}, want {want.__name__}")
        elif isinstance(res, Exception) or res.rounds_completed != want:
            raise AssertionError(f"[{label}] {name} ended with {res!r}, want {want} rounds")
    replay, globals_, statuses = replay_chaos(server_cfg, fs["global0"], fs["names"], run["sent"])
    if any(a != b for _, _, a, b in statuses):
        raise AssertionError(f"[{label}] the in-process replies {statuses} differ from the server's")
    if [h["rejected"] for h in replay.history] != [h["rejected"] for h in state.history]:
        raise AssertionError(f"[{label}] the in-process rejections differ from the server's")
    if replay.global_blob != state.global_blob or globals_[-1] != state.global_blob:
        raise AssertionError(f"[{label}] the final global differs from the in-process fold")
    finals = {r.final_weights for r in run["results"].values() if not isinstance(r, Exception)}
    if finals != {state.global_blob}:
        raise AssertionError(f"[{label}] the surviving clients hold another final global")
    return {"globals": globals_, "replay_statuses": [s[:3] for s in statuses]}


def chaos_grpc_run(torch, card: str, spans_dir: str) -> dict:
    """Phase 17 (a): the chaos plane over gRPC at phase 7's width with
    three clients. Federation A (raw msgpack uploads): a two-call network
    flap in round 1 ridden out by retries, then in round 2 a NaN upload
    (REJECTED, never averaged) and a crash before upload, the deadline
    closing the round on the survivor. Federation B (int8 frames): a
    corrupted frame in round 1 (the CRC rejects it), the deadline closing
    the round on two, then ``ServerThread.kill`` mid round 2 and a restart
    from the statefile that resumes the round. Spans of B go to
    ``spans_dir``, and a f32 version manager then installs B's last
    global from the statefile and serves one batch on it (for (d)'s
    stitch)."""
    import dataclasses
    import tempfile

    import numpy as np

    from fedcrack_tpu_torch.chaos import (
        CORRUPT_COMPRESSED_FRAME,
        CRASH_BEFORE_UPLOAD,
        NAN_UPDATE,
        NETWORK_FLAP,
        Fault,
        FaultPlan,
        InjectedCrash,
    )
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.obs import spans as tracing
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    fs = chaos_setup(torch)
    c0, c1, c2 = fs["names"]
    base = dataclasses.replace(fs["server_cfg"], host="127.0.0.1", port=0, poll_period_s=0.05, cohort_size=3,
                               round_deadline_s=CHAOS_DEADLINE_S)
    eval_batches = [0]
    bce.reset_launch_counts()

    # ---- federation A: flap, NaN upload, crash before upload ----
    cfg_a = base
    plans_a = {c1: FaultPlan([Fault(NETWORK_FLAP, round=1, client=c1, count=2), Fault(NAN_UPDATE, round=2, client=c1)]),
               c2: FaultPlan([Fault(CRASH_BEFORE_UPLOAD, round=2, client=c2)])}
    run_a = chaos_federation(torch, fs, cfg_a, plans_a, eval_batches)
    check_a = check_chaos_run("A", run_a, cfg_a, fs, [(1, [c0, c1, c2], {}), (2, [c0], {c1: "non-finite"})],
                              {c0: 2, c1: RuntimeError, c2: InjectedCrash})
    for name, plan in plans_a.items():
        if plan.pending:
            raise AssertionError(f"[A] {name}'s faults never fired: {plan.pending}")

    # ---- federation B: a corrupted frame, then a kill and restart mid round 2 ----
    with tempfile.TemporaryDirectory(prefix="fedcrack_chaos_") as tmp:
        cfg_b = dataclasses.replace(base, update_codec="int8", state_path=os.path.join(tmp, "state.bin"))
        plans_b = {c1: FaultPlan([Fault(CORRUPT_COMPRESSED_FRAME, round=1, client=c1)])}
        tracing.install(os.path.join(spans_dir, "federation.jsonl"))
        try:
            run_b = chaos_federation(torch, fs, cfg_b, plans_b, eval_batches,
                                     kill={"round": 2, "survivor": c0, "victim": c2})
        finally:
            tracing.uninstall()
        check_b = check_chaos_run("B", run_b, cfg_b, fs, [(1, [c0, c2], {c1: "checksum mismatch"}),
                                                          (2, [c0, c2], {})],
                                  {c0: 2, c1: RuntimeError, c2: 2})
        if plans_b[c1].pending:
            raise AssertionError(f"[B] {c1}'s fault never fired")
        if len(run_b["servers"]) != 2:
            raise AssertionError("federation B was not killed and restarted")
        launches = bce.bce_sums.launches
        steps = run_a["steps"] + run_b["steps"]
        if launches != steps + eval_batches[0]:
            raise AssertionError(f"bce_sums launches {launches} != {steps} train steps + {eval_batches[0]} eval batches")
        evals = [e for r in (run_a, run_b) for s in r["servers"] for e in s.eval_history]
        if sorted(e["model_version"] for e in evals) != [1, 1, 2, 2] or not all(
                np.isfinite(v) for e in evals for v in e.values()):
            raise AssertionError(f"server evals {evals}")
        # For (d)'s stitch: federation B's last global, installed from the
        # statefile and served once (the f32 reference program).
        tracing.install(os.path.join(spans_dir, "serve.jsonl"))
        try:
            engine = InferenceEngine(fs["cfg"].model, ServeConfig())
            manager = ModelVersionManager(engine, fs["global0"], state_path=cfg_b.state_path,
                                          template=fs["global0"])
            if not manager.poll_once() or manager.version != 2:
                raise AssertionError(f"the statefile install served version {manager.version}")
            with MicroBatcher(engine, manager) as batcher:
                answer = batcher.submit(np.zeros((BUCKET, BUCKET, 3), np.uint8)).result(timeout=120)
            if answer.model_version != 2:
                raise AssertionError(f"the stitch's batch answered from version {answer.model_version}")
        finally:
            tracing.uninstall()
    out = {
        "launches": launches, "steps": steps, "eval_batches": eval_batches[0],
        "round_wall_s": {"A": [h["wall_clock_s"] for h in run_a["state"].history],
                         "B": [h["wall_clock_s"] for h in run_b["state"].history]},
        "session_wall_s": {"A": run_a["wall_s"], "B": run_b["wall_s"]},
        "restart_s": run_b["restart_s"],
        "rejected": {"A": [h["rejected"] for h in run_a["state"].history],
                     "B": [h["rejected"] for h in run_b["state"].history]},
        "frame_bytes": sorted(len(u[2]) for u in run_b["sent"]),
    }
    log(f"[chaos] A: flap ridden out, NaN upload REJECTED, crash before upload, the deadline closing round 2 on "
        f"{c0}; B: the corrupted frame REJECTED by its CRC, the server killed mid round 2 and resumed from the "
        f"statefile; every round's global byte-equal to fed.rounds.transition fed the same wire bytes, the replies "
        f"equal; {json.dumps(out)} [{card}]")
    return out


def snapped_weights(torch, cfg, plane: str, seeds) -> dict:
    """Phase 4's stand-in for trained weights: seeded weights snapped to
    the plane's code grid (``{seed: host tree}``)."""
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.serve import quant as quant_mod

    return {seed: quant_mod.dequantize_variables(quant_mod.quantize_for_plane(
        init_variables(torch.Generator().manual_seed(seed), cfg), plane).tree) for seed in seeds}


def serve_chaos_run(torch, card: str) -> dict:
    """Phase 17 (b): serve chaos through the fused_int8 plane at full
    width. A ``MicroBatcher`` with a ``ServeChaos`` plan takes three
    bucket-256 batches: batch 0 loses its device (retried, nothing
    dropped), batch 1 has version 2 installed under it after its snapshot
    (it answers entirely from version 1), batch 2 is served by version 2.
    A two-replica ``ServeFleet`` sharing the engine takes a device loss
    too, and a replica grown later carries the hook. A ``StreamSession``
    with a ``StreamChaos`` reset re-runs the reset frame in full, each
    frame byte-equal to ``predict_tiled``. Masks are byte-equal to the card
    engine at the version each batch snapshotted, and every quantized
    forward (the retried batch's and the install gate's included) launches
    15 / 8 / 6 / 0 dequant kernels. Returns the launches and what the leak
    check repeats."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.chaos import (
        SERVE_DEVICE_LOSS,
        SERVE_STREAM_RESET,
        SERVE_SWAP_MIDFLIGHT,
        Fault,
        FaultPlan,
        ServeChaos,
        StreamChaos,
    )
    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager
    from fedcrack_tpu_torch.serve.stream import StreamSession

    cfg, sc = ModelConfig(), ServeConfig(quant="int8", kernel_plane="fused_int8")
    per_forward = forward_launches(cfg)
    weights = snapped_weights(torch, cfg, sc.kernel_plane, (0, 1))
    engine = InferenceEngine(cfg, sc)
    manager = ModelVersionManager(engine, weights[0])
    if not manager.install(1, weights[0]) or not manager.last_quant_gate["passed"]:
        raise AssertionError(f"version 1 was not installed quantized: {manager.last_quant_gate}")
    payloads = {1: manager.snapshot()[1]}
    engine.warmup(payloads[1])
    rng = np.random.default_rng(17)
    bursts = [rng.integers(0, 256, (BATCH, BUCKET, BUCKET, 3), dtype=np.uint8) for _ in range(4)]
    plan = FaultPlan([Fault(SERVE_DEVICE_LOSS, round=0), Fault(SERVE_SWAP_MIDFLIGHT, round=1)])
    chaos = ServeChaos(plan, swap_hook=lambda: manager.install(2, weights[1]))
    torch.cuda.synchronize()

    # ---- the main path, counted: the batcher, the fleet and a stream under chaos ----
    dequant.reset_launch_counts()
    fwd0 = engine.quantized_forwards
    with MicroBatcher(engine, manager, max_delay_ms=200.0, chaos=chaos) as batcher:
        answers = [[f.result(timeout=300) for f in [batcher.submit(img) for img in burst]] for burst in bursts[:3]]
        stats = batcher.stats()
    payloads[2] = manager.snapshot()[1]
    fleet_chaos = ServeChaos(FaultPlan([Fault(SERVE_DEVICE_LOSS, round=0)]))
    fleet = ServeFleet(cfg, dataclasses.replace(sc, replicas=2), weights[1], initial_version=2, chaos=fleet_chaos,
                       shared_engine=engine, warmup=False)
    try:
        fleet_answers = [f.result(timeout=300) for f in [fleet.submit(img) for img in bursts[3]]]
        fleet_stats = fleet.stats()
        grown = fleet.add_replica(warm=False)
        fleet_payload = fleet.manager.snapshot()[1]
    finally:
        fleet.close()
    stream_plan = FaultPlan([Fault(SERVE_STREAM_RESET, round=2)])
    session = StreamSession(engine, manager, height=384, width=384, chaos=StreamChaos(stream_plan), stream_id="cam")
    frame = rng.integers(0, 256, (384, 384, 3), dtype=np.uint8)
    frames = [session.process_frame(frame) for _ in range(4)]
    torch.cuda.synchronize()
    launches = {name: getattr(dequant, name).launches for name in per_forward}
    forwards = engine.quantized_forwards - fwd0

    # ---- what the main path did ----
    if launches != {name: n * forwards for name, n in per_forward.items()}:
        raise AssertionError(f"dequant launches {launches} != {per_forward} per forward x {forwards}")
    gate = manager.last_quant_gate
    # 3 batcher batches (the lost one never dispatched), 2 gate probes
    # (one per bucket), the fleet's gate probes, its batches, 4 frames'
    # misses (frames 0 and 2).
    if [f.kind for f in plan.triggered] != [SERVE_DEVICE_LOSS, SERVE_SWAP_MIDFLIGHT] or not gate["passed"]:
        raise AssertionError(f"serve faults fired {plan.triggered}, gate {gate}")
    if (stats["completed"], stats["failed"], stats["batch_retries"], stats["batches"]) != (3 * BATCH, 0, 1, 3):
        raise AssertionError(f"batcher stats {stats}")
    versions = [sorted({a.model_version for a in burst}) for burst in answers]
    if versions != [[1], [1], [2]]:
        raise AssertionError(f"batch versions {versions}, want [1], [1] (its snapshot), [2]")
    bitwise = True
    for burst, got, v in zip(bursts, answers, (1, 1, 2)):
        want = engine.predict_bucket(payloads[v], burst)
        for a, w in zip(got, want):
            if _mask(a.probs) != _mask(w):
                raise AssertionError(f"a version-{v} mask differs from the card engine's at that version")
            bitwise &= bool(np.array_equal(a.probs, w))
    per_replica = fleet_stats["router"]["per_replica"]
    if (sum(r["completed"] for r in per_replica.values()) != BATCH or sum(r["failed"] for r in per_replica.values())
            or [f.kind for f in fleet_chaos.plan.triggered] != [SERVE_DEVICE_LOSS]
            or grown.batcher._chaos is not fleet_chaos or {a.model_version for a in fleet_answers} != {2}):
        raise AssertionError(f"fleet under chaos: {fleet_stats}")
    want = engine.predict_bucket(fleet_payload, bursts[3])
    if any(_mask(a.probs) != _mask(w) for a, w in zip(fleet_answers, want)):
        raise AssertionError("a fleet mask differs from the card engine's")
    tiled = engine.predict_tiled(payloads[2], frame).tobytes()
    if [f.full_rerun for f in frames] != [True, False, True, False] or len(stream_plan.triggered) != 1:
        raise AssertionError(f"stream frames {[(f.full_rerun, f.tiles_computed) for f in frames]}")
    if any(f.probs.tobytes() != tiled for f in frames) or session.totals["resets"] != 1:
        raise AssertionError("a stream frame differs from predict_tiled across the reset")
    out = {"launches": launches, "quantized_forwards": forwards, "probs_bitwise_equal": bitwise,
           "gate_iou": gate["iou"], "stream_tiles": [f.tiles_computed for f in frames],
           "stream_frame_ms": [f.latency_ms for f in frames]}
    log(f"[serve chaos] device loss retried (1 retry, 0 failed, {3 * BATCH} answered), the in-flight batch answered "
        f"from version 1 with version 2 installed under it, the fleet's loss retried with nothing dropped, the "
        f"stream reset frame a full re-run byte-equal to predict_tiled; masks byte-equal to the card engine at each "
        f"batch's version; {json.dumps(out)} [{card}]")
    return {**out, "engine": engine, "manager": manager, "bursts": bursts}


def time_batches(engine, payload, size: int, n: int = 20) -> dict:
    """Host ms of ``n`` full bucket batches (``predict_bucket``, copy in
    and probabilities back included), after two warm ones."""
    import numpy as np

    batch = np.random.default_rng(size).integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
    for _ in range(2):
        engine.predict_bucket(payload, batch)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.predict_bucket(payload, batch)
        ms.append((time.perf_counter() - t0) * 1e3)
    p50, p95 = np.percentile(ms, [50, 95])
    return {"img_per_s": BATCH * 1e3 / float(np.mean(ms)), "batch_p50_ms": float(p50), "batch_p95_ms": float(p95)}


def time_steps(torch, state, batch, n: int = 20) -> dict:
    """Host ms of ``n`` train steps ending in a synchronize, after three warm ones."""
    import numpy as np

    from fedcrack_tpu_torch.train import local

    anchor = local.snapshot_params(state)
    for _ in range(3):
        local.train_step(state, batch, anchor)
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        local.train_step(state, batch, anchor)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    p50, p95 = np.percentile(ms, [50, 95])
    return {"img_per_s": len(batch[0]) * 1e3 / float(np.mean(ms)), "step_p50_ms": float(p50),
            "step_p95_ms": float(p95)}


def check_bf16_step(torch, cfg, global0, batch, lr: float) -> dict:
    """One bfloat16 train step from the same weights and batch on the card
    (cuDNN) and on the CPU (oneDNN), the bounds of
    tests/test_torch_bf16.py:

    - the train-mode logits before the step: both sides round to bfloat16
      at the same ``n`` points (every conv and BatchNorm); a value landing
      on the other side of a rounding boundary moves one step, 2^-8, and
      each flip adds at most a step on the way out, so every logit within
      ``n * 2^-8 * max|logits|``, and, flips adding in quadrature, the
      mean difference within ``sqrt(n) * 2^-8 * mean|logits|``;
    - the loss: the per-pixel BCE is 1-Lipschitz in the logit, so the two
      losses within the measured mean logit difference (plus 1e-5 of the
      loss for the two float32 reductions);
    - the parameters (as ``check_one_step``): Adam's first step is
      ``lr * g / (|g| + 1e-7)``, at most ``lr`` on each side, so within
      ``2 * lr`` everywhere; where both gradients have one sign and exceed
      2e-5 the steps differ by at most ``lr * 1e-7 / 2e-5``, held to
      1e-2·lr, whatever precision the gradients were computed in;
    - the running statistics move by 0.01 of the batch moments, which carry
      at most ``n`` flips of 2^-8 each: within
      ``0.01 * n * 2^-8 * (max|batch moment| + 1)``."""
    import numpy as np

    from fedcrack_tpu_torch.data.pipeline import as_model_batch
    from fedcrack_tpu_torch.models.convert import flax_to_state_dict
    from fedcrack_tpu_torch.models.resunet import BatchNorm, Conv
    from fedcrack_tpu_torch.train import local

    side = {}
    for device in ("cuda", "cpu"):
        st = local.create_train_state(torch.Generator().manual_seed(0), cfg, lr, device=device)
        st.replace_variables(global0)
        images, _ = as_model_batch(*(torch.as_tensor(a, device=device) for a in batch))
        st.model.train()
        with torch.no_grad():
            logits = st.model(images).cpu().numpy()
        st.replace_variables(global0)  # the forward moved the running statistics
        st, m = local.train_step(st, batch, local.snapshot_params(st), 0.0, 1.0)
        side[device] = (float(m["loss"]), logits, st.model)
    n = sum(isinstance(mod, (Conv, BatchNorm)) for mod in side["cpu"][2].modules())
    (loss_card, lg_card, card_model), (loss_cpu, lg_cpu, cpu_model) = side["cuda"], side["cpu"]
    diff = np.abs(lg_card - lg_cpu)
    out = {"roundings": n, "logit_max_over_bound": float(diff.max() / (n * BF16_STEP * np.abs(lg_cpu).max())),
           "logit_mean_over_bound": float(diff.mean() / (np.sqrt(n) * BF16_STEP * np.abs(lg_cpu).mean())),
           "loss": [loss_card, loss_cpu], "mean_logit_diff": float(diff.mean())}
    if out["logit_max_over_bound"] > 1 or out["logit_mean_over_bound"] > 1 \
            or abs(loss_card - loss_cpu) > float(diff.mean()) + 1e-5 * abs(loss_cpu):
        raise AssertionError(f"bf16 card and CPU forwards disagree past their bound: {out}")
    start = flax_to_state_dict(global0)
    cpu_params = dict(cpu_model.named_parameters())
    worst = {"params_signed": 0.0, "params_flipped": 0.0, "batch_stats_over_bound": 0.0}
    for name, p in card_model.named_parameters():
        g_card, g_cpu = p.grad.detach().cpu(), cpu_params[name].grad
        got, want = p.detach().cpu(), cpu_params[name].detach()
        if {p.dtype, g_card.dtype, want.dtype, g_cpu.dtype} != {torch.float32}:
            raise AssertionError(f"{name}: a parameter or gradient is not float32 after a bf16 step")
        for side_p in (got, want):
            if float((side_p - start[name]).abs().max()) > lr * (1 + 1e-3):
                raise AssertionError(f"{name}: moved more than Adam's one-step bound lr")
        signed = (torch.sign(g_card) == torch.sign(g_cpu)) & (g_card.abs() > 2e-5) & (g_cpu.abs() > 2e-5)
        step_diff = (got - want).abs()
        if signed.any():
            worst["params_signed"] = max(worst["params_signed"], float(step_diff[signed].max()))
        if (~signed).any():
            worst["params_flipped"] = max(worst["params_flipped"], float(step_diff[~signed].max()))
    cpu_buffers = dict(cpu_model.named_buffers())
    for name, buf in card_model.named_buffers():
        w, s0 = cpu_buffers[name], start[name]
        moment = (w - 0.99 * s0) / 0.01
        tol = 0.01 * n * BF16_STEP * (float(moment.abs().max()) + 1.0)
        worst["batch_stats_over_bound"] = max(worst["batch_stats_over_bound"],
                                             float((buf.cpu() - w).abs().max()) / tol)
    out.update(worst)
    if worst["params_signed"] > 1e-2 * lr or worst["params_flipped"] > 2 * lr * (1 + 1e-3) \
            or worst["batch_stats_over_bound"] > 1.0:
        raise AssertionError(f"bf16 card and CPU steps disagree past their bound: {out}")
    return out


def serve_cli_requests(client, engine, payload, sizes, rng, n: int = SERVE_PROBES) -> dict:
    """``n`` sequential single-image Predict calls per bucket size against
    the serve process: each mask held to ``engine`` in this process away
    from the threshold (``SERVE_PROB_TOL``), and the client's p50 / p95."""
    import numpy as np

    latency = {}
    for size in sizes:
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        probs = engine.predict_image(payload, img)[..., 0]
        far = np.abs(probs - 0.5) > SERVE_PROB_TOL
        want = (probs > 0.5).astype(np.uint8) * 255
        wall = []
        for i in range(n):
            t0 = time.perf_counter()
            (r,) = client.predict(client.chunks(1000 * size + i, img, n=1))
            wall.append((time.perf_counter() - t0) * 1e3)
            got = np.frombuffer(r.mask, np.uint8).reshape(probs.shape)
            if r.status != "OK" or not np.array_equal(got[far], want[far]):
                raise AssertionError(f"bucket {size}: {r.status} {r.title!r}, or a mask away from the threshold "
                                     "differs from the card engine in process")
        latency[size] = {"client_p50_ms": float(np.percentile(wall, 50)),
                         "client_p95_ms": float(np.percentile(wall, 95)),
                         "pixels_within_tol_of_threshold": int((~far).sum())}
    return latency


def bf16_serve_process(torch, card: str, tmp: str, label: str, serve: dict, weights, engine, payload,
                       watch=None) -> dict:
    """``python -m fedcrack_tpu_torch.serve --compute-dtype bfloat16``
    through ``CLI_SHIM`` at ``ModelConfig()`` with the ``serve`` section
    of its ``--config`` file: its Predict masks against ``engine`` in this
    process, then SIGTERM. ``watch(metrics_url)`` runs against its live
    ``/metrics`` before the SIGTERM. Returns the shim's report, the
    serve_stats, the latencies and what ``watch`` returned."""
    import re

    import numpy as np

    from fedcrack_tpu_torch.fed import serialization

    p = {k: os.path.join(tmp, f"{label}_{v}") for k, v in (("weights", "w.msgpack"), ("config", "serve.json"),
                                                            ("metrics", "serve.jsonl"), ("spans", "spans.jsonl"))}
    with open(p["weights"], "wb") as f:
        f.write(serialization.tree_to_bytes(weights))
    with open(p["config"], "w", encoding="utf-8") as f:
        json.dump({"serve": serve}, f)
    args = ["--config", p["config"], "--weights", p["weights"], "--compute-dtype", "bfloat16", "--host", "127.0.0.1",
            "--port", "0", "--metrics-path", p["metrics"], "--metrics-port", "-1"]
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    server = CliProcess(label, "fedcrack_tpu_torch.serve", args, tmp)
    client, watched = None, None
    try:
        found = None
        while time.monotonic() < deadline:
            found = re.search(r"^SERVING \S+:(\d+) .* metrics_port=(\d+)", server.text(), re.M)
            if found or server.proc.poll() is not None:
                break
            time.sleep(0.1)
        if not found:
            raise AssertionError(f"{label}: no SERVING line:\n{server.text()[-6000:]}")
        t_serving = time.time() - server.started
        client = ServeClient(int(found.group(1)))
        rng = np.random.default_rng(23)
        latency = serve_cli_requests(client, engine, payload, engine.bucket_sizes, rng)
        if watch is not None:
            watched = watch(f"http://127.0.0.1:{found.group(2)}/metrics", client, rng)
        client.close()
        client = None
        server.proc.send_signal(signal.SIGTERM)
        rc = server.wait(deadline)
    finally:
        if client is not None:
            client.close()
        server.kill()
    text = server.text()
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}:\n{text[-6000:]}")
    stats_lines = [ln for ln in text.splitlines() if ln.startswith('{"serve_stats"')]
    if len(stats_lines) != 1:
        raise AssertionError(f"{label}: {len(stats_lines)} serve_stats lines:\n{text[-4000:]}")
    return {"report": server.report(), "stats": json.loads(stats_lines[0])["serve_stats"], "latency_ms": latency,
            "start_to_serving_s": t_serving, "watch": watched}


def bf16_run(torch, card: str, tmp: str, watch) -> dict:
    """Phase 17 (c): bfloat16 at configs/c5_bf16_batch_dp.json's model and
    shapes, ``ModelConfig(compute_dtype="bfloat16")``, 256 px, batch 32.
    A client fit (``make_train_fn``, two steps) and an eval batch on the
    card through ``bce_sums``, every leaf float32; one step on the card
    against the CPU (``check_bf16_step``); train images/s and step p50 /
    p95 beside float32 at the same shape; the f32 and bf16 reference
    programs' batches per bucket in process; then ``python -m
    fedcrack_tpu_torch.serve --compute-dtype bfloat16`` at ``--quant
    none`` (the bf16 reference program on cuDNN; ``watch`` runs against
    its ``/metrics``) and at ``--quant int8 --kernel-plane fused_int8``
    serving the bf16 fit's weights snapped to the code grid (the gate,
    fused against the bf16 reference program, passes; 15 / 8 / 6 / 0 dequant
    launches per forward). The gate is also logged on phase 4's seeded
    snapped weights, where bf16 rounding flips pixels of a chaotic net."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig, ServeConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed import serialization
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.train import local
    from fedcrack_tpu_torch.train.federated import make_train_fn

    cfg16 = ModelConfig(img_size=BF16_SIZE, compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32")
    fed = FedConfig(model=cfg16, data=DataConfig(img_size=BF16_SIZE, batch_size=BF16_BATCH), local_epochs=1)
    lr = fed.learning_rate
    imgs, msks = synth_crack_batch(3 * BF16_BATCH, BF16_SIZE, seed=5)
    global0 = init_variables(torch.Generator().manual_seed(0), cfg16)

    # ---- the main path, counted: a client fit and an eval batch in bf16 ----
    bce.reset_launch_counts()
    train_fn, holder = make_train_fn(fed, ArrayDataset(imgs[:2 * BF16_BATCH], msks[:2 * BF16_BATCH],
                                                       batch_size=BF16_BATCH, seed=0), BF16_BATCH, seed=0)
    blob, n_samples, metrics = train_fn(serialization.tree_to_bytes(global0), 1, {"local_epochs": 1})
    state = holder["state"]
    ev = local.evaluate(state, ArrayDataset(imgs[2 * BF16_BATCH:], msks[2 * BF16_BATCH:], batch_size=BF16_BATCH,
                                            shuffle=False))
    torch.cuda.synchronize()
    launches, steps = bce.bce_sums.launches, n_samples // BF16_BATCH
    if launches != steps + ev["num_batches"] or steps != 2:
        raise AssertionError(f"bce_sums launches {launches} != {steps} steps + {ev['num_batches']} eval batches")
    leaves = list(_flat_tree(serialization.tree_from_bytes(blob)))
    if state.model.compute_dtype != torch.bfloat16 or any(
            getattr(leaf, "dtype", None) != np.float32 or not np.isfinite(leaf).all() for _, leaf in leaves):
        raise AssertionError("the bf16 fit's upload is not finite float32 leaves on a bf16 model")
    if not all(np.isfinite(v) for v in [*metrics.values(), *ev.values()]):
        raise AssertionError(f"non-finite bf16 metrics {metrics} {ev}")
    log(f"[bf16] fit of {steps} steps at {BF16_SIZE} px batch {BF16_BATCH} and {ev['num_batches']} eval batch: "
        f"bce_sums launches {launches}; train {json.dumps(metrics)}, eval {json.dumps(ev)}; "
        f"{len(leaves)} float32 leaves uploaded")

    check = check_bf16_step(torch, cfg16, global0, (imgs[:BF16_CHECK_BATCH], msks[:BF16_CHECK_BATCH]), lr)
    log(f"[bf16] card vs CPU, one step at {BF16_SIZE} px batch {BF16_CHECK_BATCH}: {json.dumps(check)}")

    batch = tuple(torch.from_numpy(a[:BF16_BATCH]).cuda() for a in (imgs, msks))
    train_perf = {}
    for name, mc in (("float32", cfg32), ("bfloat16", cfg16)):
        st = local.create_train_state(torch.Generator().manual_seed(0), mc, lr).replace_variables(global0)
        train_perf[name] = time_steps(torch, st, batch)
    log(f"[bf16] train_step at {BF16_SIZE} px batch {BF16_BATCH}, 20 steps each: {json.dumps(train_perf)} [{card}]")

    serve_perf, engines = {}, {}
    for name in ("float32", "bfloat16"):
        engines[name] = InferenceEngine(ModelConfig(), ServeConfig(compute_dtype=name))
        payload = engines[name].prepare(global0)
        serve_perf[name] = {size: time_batches(engines[name], payload, size) for size in engines[name].bucket_sizes}
    log(f"[bf16] reference program batches of {BATCH} per bucket in process, 20 each: {json.dumps(serve_perf)} "
        f"[{card}]")

    # ---- the serve command in bf16: the reference program, then fused_int8 ----
    ref_engine = engines["bfloat16"]
    ref = bf16_serve_process(torch, card, tmp, "serve_bf16_ref", {"quant": "none"}, global0, ref_engine,
                             ref_engine.prepare(global0), watch=watch)
    if ref["report"]["dequant_launches"] != dict.fromkeys(DEQUANT_KERNELS, 0):
        raise AssertionError(f"the bf16 reference program launched dequant kernels: {ref['report']}")
    # The fused plane accumulates in float32 and the gate holds it against
    # the bf16 reference program, so on top of int8 rounding the gate sees
    # bf16 rounding. On the chaotic seeded net that flips probe pixels
    # (logged); the served model is the bf16 fit above, trained in bf16 and
    # served in bf16, snapped to the code grid as phase 4's weights are.
    sc = ServeConfig(quant="int8", kernel_plane="fused_int8", compute_dtype="bfloat16")
    fused_engine = InferenceEngine(ModelConfig(), sc)
    gates = {}
    for label, host in (("seeded", snapped_weights(torch, ModelConfig(), "fused_int8", (0,))[0]),
                        ("bf16_fit", quant_mod.dequantize_variables(quant_mod.quantize_for_plane(
                            serialization.tree_from_bytes(blob, template=global0), "fused_int8").tree))):
        reference = fused_engine.prepare(host)
        probe = quant_mod.probe_images(BUCKET, sc.quant_probe_batch, sc.quant_probe_seed)
        gates[label] = {**quant_mod.quant_gate(fused_engine, reference, fused_engine.prepare_quantized(
            quant_mod.quantize_for_plane(host, "fused_int8"))).to_json(),
            "probe_crack_share_256": float((fused_engine.predict_bucket(reference, probe) > 0.5).mean())}
    log(f"[bf16] quant gate in process, fused_int8 against the bf16 reference program: {json.dumps(gates)} [{card}]")
    if not gates["bf16_fit"]["passed"]:
        raise AssertionError(f"the bf16 fit's gate fails in process: {gates['bf16_fit']}")
    snapped = quant_mod.dequantize_variables(quant_mod.quantize_for_plane(
        serialization.tree_from_bytes(blob, template=global0), "fused_int8").tree)
    fused = bf16_serve_process(torch, card, tmp, "serve_bf16_fused", {"quant": "int8", "kernel_plane": "fused_int8"},
                               snapped, fused_engine,
                               fused_engine.prepare_quantized(quant_mod.quantize_for_plane(snapped, "fused_int8")))
    per_forward = forward_launches(ModelConfig())
    forwards = fused["report"]["quantized_forwards"]
    gate = fused["stats"]["quant_gate"]
    if forwards == 0 or fused["report"]["dequant_launches"] != {k: v * forwards for k, v in per_forward.items()}:
        raise AssertionError(f"bf16 fused serve: dequant launches {fused['report']} != {per_forward} x {forwards}")
    if gate is None or not gate["passed"]:
        raise AssertionError(f"the bf16 fused serve's gate did not pass: {gate}")
    log(f"[bf16] serve --compute-dtype bfloat16 --quant none: client latency {json.dumps(ref['latency_ms'])}, "
        f"SERVING after {ref['start_to_serving_s']:.2f} s; --quant int8 --kernel-plane fused_int8: gate "
        f"{json.dumps(gate)} against the bf16 reference program, {forwards} quantized forwards, dequant launches "
        f"{fused['report']['dequant_launches']}, client latency {json.dumps(fused['latency_ms'])} [{card}]")
    return {"launches": launches, "served_launches": fused["report"]["dequant_launches"], "check": check,
            "train_perf": train_perf, "serve_perf": serve_perf, "serve_cli_latency_ms": {
                "bfloat16_reference": ref["latency_ms"], "bfloat16_fused_int8": fused["latency_ms"]},
            "gate": gate, "gates_in_process": gates, "watch": ref["watch"], "state": holder["state"],
            "batch": batch}


def watch_serve_metrics(rules_path: str):
    """(d)'s watchdog: ``Watchdog(load_rules(rules_path))`` evaluated over a
    serve process's live ``/metrics`` twice, 1.1 s apart with requests in
    between (rate rules read two scrapes). No breach is allowed; the rules
    whose metric the process does not export stay indeterminate and are
    reported."""
    import numpy as np

    from fedcrack_tpu_torch.obs.promexp import scrape
    from fedcrack_tpu_torch.obs.watchdog import Watchdog, load_rules

    def watch(url, client, rng):
        wd = Watchdog(load_rules(rules_path))
        first = wd.enforce(scrape(url))
        t_end = time.monotonic() + 1.1
        img = rng.integers(0, 256, (BUCKET, BUCKET, 3), dtype=np.uint8)
        while time.monotonic() < t_end:
            client.predict(client.chunks(77, img, n=1))
        second = wd.enforce(scrape(url))
        audit = wd.audit()
        if audit["breaches"] or first["breaches"] or second["breaches"]:
            raise AssertionError(f"SLO breach over the serve process's /metrics: {audit}")
        return {"audit": audit, "values": {r["rule"]: r["value"] for r in second["results"]}}

    return watch


def chaos_bf16_watch_phase(torch, card: str) -> dict:
    """Phase 17: (a) chaos over gRPC, (b) serve chaos, (c) bf16 compute,
    and (d) the watch layer: a ``LeakSentry`` marked after (a)-(c) and
    checked after a repeat of their steady work, the watchdog over the bf16
    serve process's ``/metrics`` (run inside (c)), and ``tools.trace_stitch``
    over (a)'s span files."""
    import gc
    import tempfile

    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.obs.sentries import LeakSentry
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher
    from fedcrack_tpu_torch.tools import trace_stitch
    from fedcrack_tpu_torch.train import local

    t0 = time.monotonic()
    sentry = LeakSentry(registry=MetricsRegistry())
    with tempfile.TemporaryDirectory(prefix="fedcrack_phase17_") as tmp:
        chaos = chaos_grpc_run(torch, card, tmp)
        served = serve_chaos_run(torch, card)
        bf16 = bf16_run(torch, card, tmp, watch_serve_metrics(os.path.join(HERE, WATCH_RULES)))
        log(f"[watch] watchdog on {WATCH_RULES} over the bf16 serve process's /metrics: "
            f"{json.dumps(bf16['watch'])}")

        # ---- (d) the leak sentry: steady work after the mark ----
        gc.collect()
        torch.cuda.synchronize()
        marked = sentry.mark()
        anchor = local.snapshot_params(bf16["state"])
        for _ in range(10):
            local.train_step(bf16["state"], bf16["batch"], anchor)
        with MicroBatcher(served["engine"], served["manager"]) as batcher:
            for burst in served["bursts"]:
                [f.result(timeout=300) for f in [batcher.submit(img) for img in burst]]
        del anchor
        gc.collect()
        torch.cuda.synchronize()
        sentry.assert_steady()
        leak = {"mark": marked, **sentry.summary(), "memory_allocated": torch.cuda.memory_allocated(),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log(f"[watch] leak sentry steady after 10 bf16 steps and 4 fused batches past the mark: {json.dumps(leak)} "
            f"[{card}]")

        # ---- (d) the stitch over (a)'s span files ----
        paths = [os.path.join(tmp, "federation.jsonl"), os.path.join(tmp, "serve.jsonl")]
        stitched = trace_stitch.summarize(trace_stitch.stitch_files(paths))
        if not stitched["complete"] or stitched["planes_crossed"] != ["client", "fed", "serve"]:
            raise AssertionError(f"trace_stitch over the phase's span files: {stitched}")
        log(f"[watch] trace_stitch over the federation's and the serving manager's span files: {json.dumps(stitched)}")
    out = {"launches": chaos["launches"] + bf16["launches"],
           "served_launches": {k: served["launches"][k] + bf16["served_launches"][k] for k in served["launches"]},
           "phase_s": time.monotonic() - t0}
    log(f"[phase17] wall {out['phase_s']:.2f} s; bce_sums launches {out['launches']}; dequant launches "
        f"{out['served_launches']} [{card}]")
    return out


# ---- phase 18: the hierarchical aggregation tree and the chaos drills ----

TREE_CLIENTS, TREE_SHARD, TREE_COHORT, TREE_EDGES, TREE_ROUNDS = 8, 32, 4, 2, 2
TREE_SEED = 18
TREE_HELD = 32  # held-out samples the final global is evaluated on
TREE_BUCKET = 128
DRILL_TIMEOUT_S = 300.0
# float32's unit roundoff, and the magnitude below which its spacing stops
# scaling (the subnormals).
U32, TINY32 = 2.0 ** -24, 2.0 ** -149


def fold_bound(leaf_vals, weights, shard_sizes) -> "np.ndarray":
    """Per coordinate, how far a two-level tree FedAvg may lie from the
    flat FedAvg of the same leaves. The host fold (``fed.algorithms``)
    rounds ``acc + w * x`` once per update (w an integer count, so the
    product is exact in float64) and twice more in ``* fl(1 / total)``.
    With M = sum_i (w_i / W) |x_i|: the flat fold is within (n + 2) u M of
    the exact mean; an edge's partial within (n_e + 2) u M_e of its
    shard's, which the root carries at weight W_e / W (at most
    (max n_e + 2) u M in all), and the root's own fold of E partials adds
    (E + 2) u M. So |tree - flat| <= (n + max n_e + E + 6) u M, plus one
    subnormal spacing per rounding."""
    import numpy as np

    w = np.asarray(weights, np.float64)
    m = np.tensordot(w / w.sum(), np.abs(np.stack([np.asarray(x, np.float64) for x in leaf_vals])), axes=1)
    k = len(leaf_vals) + max(shard_sizes) + len(shard_sizes) + 6
    return k * U32 * m + k * TINY32


def tree_setup(torch) -> dict:
    """Phase 18's leaves: ``ModelConfig()`` at 128 px, batch 16, eight
    clients of 32 seeded synthetic samples (their own ``make_train_fn``
    on the card, seed = client index, made at first use) and 32 held
    out."""
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.train import local
    from fedcrack_tpu_torch.train.federated import make_train_fn

    cfg = FedConfig(model=ModelConfig(), data=DataConfig(img_size=TRAIN_SIZE, batch_size=TRAIN_BATCH))
    n = TREE_CLIENTS * TREE_SHARD
    imgs, msks = synth_crack_batch(n + TREE_HELD, TRAIN_SIZE, seed=TREE_SEED)
    fits = {}

    def fit(idx):
        if idx not in fits:
            part = slice(idx * TREE_SHARD, (idx + 1) * TREE_SHARD)
            data = ArrayDataset(imgs[part], msks[part], batch_size=TRAIN_BATCH, seed=idx)
            fits[idx] = make_train_fn(cfg, data, TRAIN_BATCH, seed=idx)[0]
        return fits[idx]

    return {
        "cfg": cfg, "fit": fit,
        "held": ArrayDataset(imgs[n:], msks[n:], batch_size=TRAIN_BATCH, shuffle=False),
        "global0": init_variables(torch.Generator().manual_seed(0), cfg.model),
        "evaluator": local.create_train_state(torch.Generator().manual_seed(0), cfg.model, cfg.learning_rate),
    }


def tree_in_process(torch, ts: dict, card: str) -> dict:
    """Phase 18 (a), the main path: ``run_tree_federation`` over 8 leaves,
    4 a round from ``sample_cohort(8, 4, r, 18)``, 2 edges, 2 rounds, each
    leaf one local fit on the card from the base blob, recorded; then the
    final global evaluated on the held-out samples. Checked: the memory
    bounds, each round's global against the flat FedAvg of its recorded
    leaves within ``fold_bound``, ``bce_sums`` launches equal to the leaf
    steps plus the eval batches, and a second tree over the recorded
    blobs giving the same ``global_sha256``."""
    import numpy as np

    from fedcrack_tpu_torch.fed import rounds, serialization
    from fedcrack_tpu_torch.fed.algorithms import fedavg, sample_cohort
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.fed.tree import partition_cohort, run_tree_federation
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.train import local

    kwargs = dict(n_clients=TREE_CLIENTS, cohort_size=TREE_COHORT, n_rounds=TREE_ROUNDS, n_edges=TREE_EDGES,
                  cohort_seed=TREE_SEED)
    leaves, counts = {}, {"steps": 0}

    def make_update(idx, r, base_blob, base_version):
        blob, n_samples, metrics = ts["fit"](idx)(base_blob, r + 1, {"local_epochs": 1})
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"leaf {idx} round {r}: non-finite train metrics {metrics}")
        counts["steps"] += n_samples // TRAIN_BATCH
        leaves[(idx, r)] = {"blob": blob, "ns": n_samples, "base": base_blob, "base_version": base_version}
        return blob, n_samples

    # ---- the main path, counted ----
    bce.reset_launch_counts()
    t0 = time.monotonic()
    res = run_tree_federation(ts["global0"], make_update, **kwargs)
    final = serialization.tree_from_bytes(res.state.global_blob, template=ts["global0"])
    ev = local.evaluate(ts["evaluator"].replace_variables(final), ts["held"])
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    wall = time.monotonic() - t0
    steps = counts["steps"]
    if launches != steps + ev["num_batches"] or steps != TREE_ROUNDS * TREE_COHORT * TREE_SHARD // TRAIN_BATCH:
        raise AssertionError(f"bce_sums launches {launches} != {steps} leaf steps + {ev['num_batches']} eval batches")
    if not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite eval of the tree's global: {ev}")

    cohorts = [[int(i) for i in sample_cohort(TREE_CLIENTS, TREE_COHORT, r, TREE_SEED)] for r in range(TREE_ROUNDS)]
    if res.state.phase != rounds.PHASE_FINISHED or res.cohorts != cohorts:
        raise AssertionError(f"tree ended at {res.state.phase}, cohorts {res.cohorts} != {cohorts}")
    if not (res.root_peak_blobs <= res.n_edges and res.edge_peak_blobs <= res.max_leaf_fan_in):
        raise AssertionError(f"peaks: root {res.root_peak_blobs} of {res.n_edges} edges, edge "
                             f"{res.edge_peak_blobs} of fan-in {res.max_leaf_fan_in}")
    if res.leaf_updates != TREE_ROUNDS * TREE_COHORT or res.leaf_rejections != 0:
        raise AssertionError(f"{res.leaf_updates} leaf updates, {res.leaf_rejections} rejected")

    # ---- each round's global against the flat FedAvg of its leaves ----
    globals_ = [leaves[(cohorts[1][0], 1)]["base"], res.state.global_blob]
    if any(leaves[(i, 1)]["base"] != globals_[0] for i in cohorts[1]):
        raise AssertionError("round 2's leaves trained from different bases")
    fold = []
    for r in range(TREE_ROUNDS):
        recs = [leaves[(i, r)] for i in cohorts[r]]
        trees = [serialization.tree_from_bytes(rec["blob"], template=ts["global0"]) for rec in recs]
        flat = tree_leaves(fedavg(trees, [rec["ns"] for rec in recs]))
        got = tree_leaves(serialization.tree_from_bytes(globals_[r], template=ts["global0"]))
        shards = [len(s) for s in partition_cohort(cohorts[r], TREE_EDGES)]
        worst, err = 0.0, 0.0
        for j, (g, f) in enumerate(zip(got, flat)):
            bound = fold_bound([tree_leaves(t)[j] for t in trees], [rec["ns"] for rec in recs], shards)
            diff = np.abs(np.asarray(g, np.float64) - np.asarray(f, np.float64))
            if not (diff <= bound).all():
                raise AssertionError(f"round {r + 1} leaf {j}: tree global {diff.max()} from the flat FedAvg, "
                                     f"over the fold bound")
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / bound).max()))
        fold.append({"max_abs_diff": err, "max_diff_over_bound": worst})

    # ---- the same tree over the recorded blobs ----
    def replay(idx, r, base_blob, base_version):
        rec = leaves[(idx, r)]
        if base_blob != rec["base"] or base_version != rec["base_version"]:
            raise AssertionError(f"replay: leaf {idx} round {r} offered another base")
        return rec["blob"], rec["ns"]

    again = run_tree_federation(ts["global0"], replay, **kwargs)
    if again.global_sha256 != res.global_sha256:
        raise AssertionError("the tree over the recorded blobs gave another global")
    out = {"launches": launches, "steps": steps, "eval_batches": ev["num_batches"], "wall_s": wall,
           "cohorts": cohorts, "root_peak_blobs": res.root_peak_blobs, "edge_peak_blobs": res.edge_peak_blobs,
           "max_leaf_fan_in": res.max_leaf_fan_in, "bytes_at_root": res.bytes_at_root,
           "bytes_flat_equiv": res.bytes_flat_equiv, "fold_vs_flat": fold, "eval": ev,
           "global_sha256": res.global_sha256}
    log(f"[tree] main path: run_tree_federation, 2 rounds x 4 of 8 leaves over 2 edges, {steps} leaf steps on the "
        f"card + {ev['num_batches']} eval batches in {wall:.2f} s, bce_sums launches {launches}; each round's "
        f"global within fold_bound of the flat FedAvg of its recorded leaves; the replay gives the same "
        f"global_sha256; {json.dumps(out)} [{card}]")
    return {**out, "leaves": leaves, "globals": globals_}


def tree_grpc_run(torch, ts: dict, tree: dict, card: str) -> dict:
    """Phase 18 (b): the same tree over loopback gRPC with the recorded
    leaves. A port ``FedServer`` is the root (``cohort_size=2``); each edge
    pushes through its own ``EdgeRelay``. In round 1 ``edge-0`` is killed
    after its first leaf (``FaultPlan`` ``EDGE_AGGREGATOR_CRASH``),
    restored from its statefile, and takes the rest: its partial must be
    byte-equal to an unkilled edge's over the same blobs, and each round's
    root global byte-equal to the in-process tree's."""
    import tempfile

    from fedcrack_tpu_torch.chaos.plan import EDGE_AGGREGATOR_CRASH, Fault, FaultPlan
    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.fed import rounds
    from fedcrack_tpu_torch.fed.tree import EdgeAggregator, partition_cohort
    from fedcrack_tpu_torch.transport import FedServer
    from fedcrack_tpu_torch.transport.edge import EdgeRelay
    from fedcrack_tpu_torch.transport.service import ServerThread

    cfg = FedConfig(max_rounds=TREE_ROUNDS, cohort_size=TREE_EDGES, registration_window_s=30.0,
                    round_deadline_s=120.0, host="127.0.0.1", port=0)
    plan = FaultPlan([Fault(kind=EDGE_AGGREGATOR_CRASH, round=1, client="edge-0")])
    root = FedServer(cfg, ts["global0"], tick_period_s=0.05)
    template = root.state.template
    t0 = time.monotonic()
    timings = {}
    with tempfile.TemporaryDirectory(prefix="fedcrack_phase18_") as tmp, ServerThread(root) as st:
        state_path = os.path.join(tmp, "edge-0.msgpack")
        relays = {f"edge-{e}": EdgeRelay(f"edge-{e}", st.port, timeout_s=60.0) for e in range(TREE_EDGES)}
        try:
            hello = [relay.enroll() for relay in relays.values()]
            rnd, version = int(hello[0]["current_round"]), int(hello[0]["model_version"])
            edges = {"edge-0": EdgeAggregator("edge-0", template, state_path=state_path),
                     "edge-1": EdgeAggregator("edge-1", template)}
            for r in range(TREE_ROUNDS):
                base = relays["edge-0"].pull()
                if base != tree["leaves"][(tree["cohorts"][r][0], r)]["base"]:
                    raise AssertionError(f"round {r + 1}: the root's base is not the in-process tree's")
                shards = partition_cohort(tree["cohorts"][r], TREE_EDGES)
                for e, (name, relay) in enumerate(relays.items()):
                    edge = edges[name]
                    shard = [int(i) for i in shards[e]]
                    edge.begin_round(rnd, base, version, [f"client-{i}" for i in shard])
                    for k, idx in enumerate(shard):
                        rec = tree["leaves"][(idx, r)]
                        ok, why = edge.offer(f"client-{idx}", rec["blob"], rec["ns"])
                        if not ok:
                            raise AssertionError(f"edge {name} refused client-{idx}: {why}")
                        if name == "edge-0" and k == 0 and plan.take(EDGE_AGGREGATOR_CRASH, client=name, round=rnd):
                            t_kill = time.perf_counter()
                            del edge, edges[name]
                            edge = EdgeAggregator.restore(state_path, template)
                            timings["restore_s"] = time.perf_counter() - t_kill
                            if edge is None or sorted(edge.received) != [f"client-{idx}"] or edge.round != rnd:
                                raise AssertionError("edge-0 did not resume its round from the statefile")
                            edges[name] = edge
                    partial, total = edge.partial()
                    if name == "edge-0" and r == 0:
                        twin = EdgeAggregator("edge-0", template)
                        twin.begin_round(rnd, base, version, [f"client-{i}" for i in shard])
                        for idx in shard:
                            rec = tree["leaves"][(idx, r)]
                            twin.offer(f"client-{idx}", rec["blob"], rec["ns"])
                        if twin.partial() != (partial, total):
                            raise AssertionError("the restored edge's partial differs from an unkilled edge's")
                    status, weights, config = relay.push_partial(rnd, partial, total, edge.last_partial_ctx)
                    edge.end_round()
                want = rounds.FIN if r == TREE_ROUNDS - 1 else rounds.RESP_ARY
                if status != want or weights != tree["globals"][r]:
                    raise AssertionError(f"round {r + 1}: root answered {status}; global equal to the in-process "
                                         f"tree's: {weights == tree['globals'][r]}")
                if r == 0:
                    timings["kill_to_recover_s"] = time.perf_counter() - t_kill
                if status == rounds.RESP_ARY:
                    rnd, version = int(config["current_round"]), int(config["model_version"])
        finally:
            for relay in relays.values():
                relay.close()
        state = st.state
    if [f.kind for f in plan.triggered] != [EDGE_AGGREGATOR_CRASH]:
        raise AssertionError(f"the edge crash did not fire: {plan.triggered}")
    if [h["clients"] for h in state.history] != [["edge-0", "edge-1"]] * TREE_ROUNDS:
        raise AssertionError(f"root history {state.history}")
    out = {**timings, "wall_s": time.monotonic() - t0,
           "root_bytes_received": [h["bytes_received"] for h in state.history]}
    log(f"[tree] over gRPC: edge-0 killed after its first leaf in round 1 and restored from its statefile, its "
        f"partial byte-equal to an unkilled edge's; each round's root global byte-equal to the in-process tree's; "
        f"{json.dumps(out)} [{card}]")
    return out


def serve_global(torch, model, weights, card: str, label: str, seed: int) -> dict:
    """A federation's global served through ``ServeConfig(quant="int8",
    kernel_plane="fused_int8")`` at bucket 128, batch 8: 15 / 8 / 6 / 0 dequant
    launches for the forward (wrappers and profiler), and the fused output
    held to the reference plane on the same codes as phase 4 holds it."""
    import numpy as np

    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    sc = ServeConfig(quant="int8", kernel_plane="fused_int8")
    engine = InferenceEngine(model, sc)
    qtree = quant_mod.quantize_for_plane(weights, "fused_int8")
    payload = engine.prepare(qtree)
    batch = np.random.default_rng(seed).integers(0, 256, (BATCH, TREE_BUCKET, TREE_BUCKET, 3), dtype=np.uint8)
    counted, profiled, _ = served_batch_launches(torch, engine, payload, batch)
    ref_engine = InferenceEngine(model, ServeConfig(quant="int8", kernel_plane="reference"))
    probe = quant_mod.probe_images(TREE_BUCKET, sc.quant_probe_batch, sc.quant_probe_seed)
    fused = engine.predict_bucket(payload, probe)
    want = ref_engine.predict_bucket(ref_engine.prepare(qtree), probe)
    diff = float(np.max(np.abs(fused.astype(np.float64) - want.astype(np.float64))))
    iou = quant_mod.mask_iou(fused, want)
    if diff >= SERVE_PROB_TOL or iou < 0.99:
        raise AssertionError(f"{label}: fused plane {diff} from the reference plane, mask IoU {iou}")
    out = {"served_launches": counted, "fused_vs_reference_max_diff": diff, "mask_iou": iou,
           "probe_crack_share": float(np.mean(want > 0.5))}
    log(f"[{label}] the global served fused_int8 at bucket {TREE_BUCKET} batch {BATCH}: {json.dumps(profiled)} "
        f"(profiler); {json.dumps(out)} [{card}]")
    return out


def tree_serve_run(torch, ts: dict, tree: dict, card: str) -> dict:
    """Phase 18 (c): the tree's final global served (:func:`serve_global`)."""
    from fedcrack_tpu_torch.fed import serialization

    weights = serialization.tree_from_bytes(tree["globals"][-1], template=ts["global0"])
    return serve_global(torch, ts["cfg"].model, weights, card, "tree", 18)


def drill_run(card: str) -> dict:
    """Phase 18 (d): ``python -m fedcrack_tpu_torch.tools.chaos_drill --out
    F`` on the card through ``CLI_SHIM``; it must exit 0 with every boolean
    verdict of its twelve drills true, ``dp_replay``'s retried DP round on
    the card bit-identical to the unkilled one."""
    import tempfile

    def verdicts(node, path=()):
        if isinstance(node, dict):
            for key, value in node.items():
                yield from verdicts(value, path + (key,))
        elif isinstance(node, bool):
            yield path, node

    with tempfile.TemporaryDirectory(prefix="fedcrack_drill_") as tmp:
        out_path = os.path.join(tmp, "drill.json")
        proc = CliProcess("chaos_drill", "fedcrack_tpu_torch.tools.chaos_drill", ["--out", out_path], tmp)
        try:
            rc = proc.wait(time.monotonic() + DRILL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"the drill command timed out:\n{proc.text()[-4000:]}")
        if rc != 0:
            raise AssertionError(f"the drill command exited {rc}:\n{proc.text()[-4000:]}")
        with open(out_path, encoding="utf-8") as f:
            artifact = json.load(f)
        report = proc.report()
    drills = sorted(k for k in artifact if k != "generated_by")
    false = [path for path, value in verdicts(artifact) if not value]
    dp = artifact.get("dp_replay", {})
    if len(drills) != 12 or false or dp.get("replay_bit_identical") is not True or dp.get("retries_round_0") != 1:
        raise AssertionError(f"drills {drills}; false verdicts {false}; dp_replay {dp}")
    timings = {name: {k: artifact[name][k] for k in ("restore_s", "kill_to_recover_s", "session_s")
                      if k in artifact[name]}
               for name in ("kill_restart", "edge_crash", "buffered_kill")}
    out = {"drills": drills, "verdicts": sum(1 for _ in verdicts(artifact)), "timings": timings,
           "storm": {arm: artifact["straggler_storm"][arm]["updates_per_sec"] for arm in ("sync", "buffered")},
           "command_wall_s": report["wall_s"]}
    out["dp_replay_s"] = dp.get("drill_s")
    log(f"[drill] python -m fedcrack_tpu_torch.tools.chaos_drill: {out['verdicts']} verdicts true over "
        f"{len(drills)} drills, dp_replay's retried DP round bit-identical; {json.dumps(out)} [{card}]")
    return out


def tree_drill_phase(torch, card: str) -> dict:
    """Phase 18: the tree in process (the main path), over gRPC with a
    killed edge, its global served quantized, and the drill command."""
    t0 = time.monotonic()
    ts = tree_setup(torch)
    tree = tree_in_process(torch, ts, card)
    grpc = tree_grpc_run(torch, ts, tree, card)
    served = tree_serve_run(torch, ts, tree, card)
    drill = drill_run(card)
    out = {"launches": tree["launches"], "served_launches": served["served_launches"],
           "bytes_at_root": tree["bytes_at_root"], "bytes_flat_equiv": tree["bytes_flat_equiv"],
           "edge_restore_s": grpc["restore_s"], "edge_kill_to_recover_s": grpc["kill_to_recover_s"],
           "drill_timings": drill["timings"], "phase_s": time.monotonic() - t0}
    log(f"[phase18] {json.dumps(out)} [{card}]")
    return out


# ---- phase 19: several clients per round on one card ----

SLOT_ACTIVE = (1.0, 1.0, 1.0, 0.0)
SLOT_SAMPLES = (32.0, 32.0, 64.0, 32.0)
SLOT_STEPS, SLOT_EPOCHS, SLOT_ROUNDS = 2, 2, 2
SLOT_POOL = 40  # samples in each slot's pool; a round draws 32
SLOT_SEED = 19
SLOT_TOPK = 0.01
REFSCALE_ARGS = ["--clients", "2", "--rounds", "2", "--epochs", "1", "--samples", "64", "--img", "128",
                 "--eval-samples", "16"]
REFSCALE_TIMEOUT_S = 300.0


def jax_refscale_keys(root: str = HERE) -> dict:
    """The keys of the JAX package's ``tools/refscale_federation`` artifact,
    read from its source with ``ast`` (nothing of it is imported): the
    dict ``run_refscale_federation`` returns, its nested sections, and the
    keys of a round entry (``_round``) and of a fit entry (``_fit``)."""
    import ast

    with open(os.path.join(root, "fedcrack_tpu", "tools", "refscale_federation.py"), encoding="utf-8") as f:
        module = ast.parse(f.read())
    fn = next(n for n in module.body if isinstance(n, ast.FunctionDef) and n.name == "run_refscale_federation")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1].value

    def keys(d):
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None) for k, v in zip(d.keys, d.values)}

    out = keys(ret)
    appended = [keys(n.args[0]) for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "append" and n.args and isinstance(n.args[0], ast.Dict)]
    out["_round"] = next(a for a in appended if "round" in a)
    out["_fit"] = next(a for a in appended if "client" in a)
    return out


def check_refscale_artifact(artifact: dict, want: dict) -> None:
    """Every key of the JAX artifact, and finite train and eval losses."""
    import math

    if set(artifact) != {k for k in want if not k.startswith("_")}:
        raise AssertionError(f"refscale artifact keys {sorted(artifact)}")
    for section in ("hardware", "workload", "summary"):
        if set(artifact[section]) != set(want[section]):
            raise AssertionError(f"refscale {section} keys {sorted(artifact[section])} != {sorted(want[section])}")
    for rnd in artifact["rounds"]:
        if set(rnd) != set(want["_round"]) or any(set(f) != set(want["_fit"]) for f in rnd["fits"]):
            raise AssertionError(f"refscale round keys {sorted(rnd)}")
        losses = [f["train_last_epoch"]["loss"] for f in rnd["fits"]] + [rnd["eval"]["loss"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"refscale round {rnd['round']}: non-finite losses {losses}")


def slot_setup(torch) -> dict:
    """Phase 19's federation: ``ModelConfig()`` at 128 px, batch 16, 4
    slots (``active = [1, 1, 1, 0]``, ``n_samples = [32, 32, 64, 32]``),
    each a 40-sample uint8 pool from which every round draws 2 steps, one
    seeded global. ``slab_fn`` is the streamed data (``pool[idx]``),
    ``plan_fn`` the resident one; both pure functions of the round."""
    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables

    cfg = ModelConfig()
    n = len(SLOT_ACTIVE)
    pool = SamplePool.stack([to_uint8_transport(*synth_crack_batch(SLOT_POOL, TRAIN_SIZE, seed=SLOT_SEED * 100 + c))
                             for c in range(n)])
    active, ns = np.asarray(SLOT_ACTIVE, np.float32), np.asarray(SLOT_SAMPLES, np.float32)

    def plan(r):
        rngs = [np.random.default_rng([SLOT_SEED, r, c]) for c in range(n)]
        return pool.round_indices(rngs, SLOT_EPOCHS, SLOT_STEPS, TRAIN_BATCH)

    def slab_fn(r):
        return (*pool.assemble_round_slab(plan(r)), active, ns)

    return {"cfg": cfg, "pool": pool, "active": active, "ns": ns, "slab_fn": slab_fn,
            "plan_fn": lambda r: (plan(r), active, ns),
            "global0": init_variables(torch.Generator().manual_seed(SLOT_SEED), cfg)}


def slot_run(torch, ss: dict, label: str, round_fn, mesh, launches: int, *, cohort: bool = False,
             data_fn=None, **kwargs) -> dict:
    """One counted 2-round run through the driver from the seeded global:
    ``bce_sums`` launches must be exactly ``launches``; the weights and
    metrics finite."""
    import numpy as np

    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import run_cohort_federation, run_mesh_federation

    torch.cuda.synchronize()
    bce.reset_launch_counts()
    t0 = time.monotonic()
    drive = run_cohort_federation if cohort else run_mesh_federation
    variables, records = drive(round_fn, ss["global0"], data_fn or ss["slab_fn"], SLOT_ROUNDS, mesh, **kwargs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = bce.bce_sums.launches
    if got != launches:
        raise AssertionError(f"[slots] {label}: bce_sums launches {got}, want {launches}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(variables)):
        raise AssertionError(f"[slots] {label}: non-finite global")
    if not all(np.isfinite(v).all() and v.shape == (len(SLOT_ACTIVE),) for r in records for v in r.metrics.values()):
        raise AssertionError(f"[slots] {label}: metrics not finite [C] vectors")
    return {"variables": variables, "records": records, "wall_s": wall, "launches": got,
            "round_walls_s": [r.wall_clock_s for r in records], "retries": [r.retries for r in records]}


def host_tree(tree):
    from fedcrack_tpu_torch.fed.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def same_bits(a, b) -> bool:
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    la = [t.detach().cpu().numpy() if hasattr(t, "detach") else t for t in tree_leaves(a)]
    lb = [t.detach().cpu().numpy() if hasattr(t, "detach") else t for t in tree_leaves(b)]
    return len(la) == len(lb) and all(x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def check_same_run(label: str, got: dict, want: dict) -> None:
    if not same_bits(got["variables"], want["variables"]):
        raise AssertionError(f"[slots] {label}: the global differs from the monolithic streamed run's")
    for rg, rw in zip(got["records"], want["records"]):
        for k in rw.metrics:
            if rg.metrics[k].tobytes() != rw.metrics[k].tobytes():
                raise AssertionError(f"[slots] {label}: round {rw.round_idx} metric {k} differs")


def slot_host_path(torch, ss: dict, inputs: list, slots: dict, card: str) -> dict:
    """Phase 19 (a)'s host path on the card: each slot of each round a
    fresh ``train.local`` state loaded with the round's input global,
    ``train_step`` over its slab, then ``fed.algorithms.fedavg`` over the
    active slots. Each slot's weights must equal the round's slot bit for
    bit, and each round's global lie within ``fold_bound`` of the host
    FedAvg of the same slots (the two folds round differently)."""
    import numpy as np

    from fedcrack_tpu_torch.fed.algorithms import fedavg
    from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.train import local

    cfg, n = ss["cfg"], len(SLOT_ACTIVE)
    state = local.create_train_state(torch.Generator().manual_seed(0), cfg, 1e-3)
    torch.cuda.synchronize()
    bce.reset_launch_counts()
    walls, trained = [], {}
    for r in range(SLOT_ROUNDS):
        images, masks, _, _ = ss["slab_fn"](r)
        images, masks = torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()
        snaps = []
        t0 = time.monotonic()
        for c in range(n):
            state.replace_variables(inputs[r])
            state.optimizer = local.make_optimizer(state.model.parameters(), 1e-3)
            anchor = local.snapshot_params(state)
            for _ in range(SLOT_EPOCHS):
                for s in range(SLOT_STEPS):
                    local.train_step(state, (images[c, s], masks[c, s]), anchor)
            # A device clone, as the round's slot_hook takes inside its
            # timed run; the copy to the host comes after the clock stops.
            snaps.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        for c, snap in enumerate(snaps):
            state.model.load_state_dict(snap)
            trained[(r, c)] = tree_map(np.array, state.variables)
    launches = bce.bce_sums.launches
    if launches != n * SLOT_STEPS * SLOT_EPOCHS * SLOT_ROUNDS:
        raise AssertionError(f"[slots] host path: bce_sums launches {launches}")
    worst = []
    for r in range(SLOT_ROUNDS):
        for c in range(n):
            if not same_bits(trained[(r, c)], host_tree(slots[(r, c)])):
                raise AssertionError(f"[slots] round {r} slot {c}: the host fit differs from the round's slot")
        keep = [c for c in range(n) if SLOT_ACTIVE[c] > 0]
        w = [SLOT_SAMPLES[c] for c in keep]
        host = tree_leaves(fedavg([trained[(r, c)] for c in keep], w))
        got = tree_leaves(host_tree(inputs[r + 1]))
        ratio = 0.0
        for j, (g, h) in enumerate(zip(got, host)):
            bound = fold_bound([tree_leaves(trained[(r, c)])[j] for c in keep], w, [len(keep)])
            diff = np.abs(np.asarray(g, np.float64) - np.asarray(h, np.float64))
            if not (diff <= bound).all():
                raise AssertionError(f"[slots] round {r} leaf {j}: the round's global {diff.max()} from the host "
                                     "FedAvg, over the fold bound")
            ratio = max(ratio, float((diff / bound).max()))
        worst.append(ratio)
    return {"round_walls_s": walls, "launches": launches, "global_diff_over_fold_bound": worst}


def slot_codec_checks(torch, ss: dict, card: str, mesh) -> dict:
    """Phase 19 (f): the top-k twin keeps, per leaf of each slot's round-0
    delta, the entries the host ``TopKDeltaCodec`` keeps (its
    ``topk_select`` with ``leaf_k``); the int8 twin leaves every value
    within one bucket scale of its delta. Both runs 2 rounds, counted."""
    from fedcrack_tpu_torch.compress.codecs import QSGD_BUCKET, leaf_k, topk_select
    from fedcrack_tpu_torch.compress.mesh import int8_bucket_scales, int8_roundtrip, topk_keep
    from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map
    from fedcrack_tpu_torch.parallel import build_federated_round

    n = len(SLOT_ACTIVE)
    want = n * SLOT_STEPS * SLOT_EPOCHS * SLOT_ROUNDS
    g0 = tree_map(lambda a: torch.from_numpy(a).cuda(), ss["global0"])
    out = {}
    for codec in ("topk_delta", "int8"):
        rf = build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, update_codec=codec,
                                   topk_fraction=SLOT_TOPK)
        slots = {}
        rf.slot_hook = lambda c, v: slots.setdefault(c, v)  # round 0's slots
        run = slot_run(torch, ss, codec, rf, mesh, want)
        kept = checked = 0
        for c in range(n):
            delta = tree_map(lambda t, b: t.float() - b.float(), slots[c], g0)
            if codec == "topk_delta":
                for d in tree_leaves(delta):
                    eff = (d + torch.zeros_like(d)).reshape(-1)
                    k = leaf_k(eff.numel(), SLOT_TOPK)
                    card_keep = torch.sort(topk_keep(eff, k)).values.cpu().numpy()
                    if card_keep.tolist() != topk_select(eff.cpu().numpy(), k).tolist():
                        raise AssertionError(f"[slots] top-k slot {c}: the card's keep set differs from the host's")
                    kept += k
            else:
                q = int8_roundtrip(delta, (0, c))
                for d, v in zip(tree_leaves(delta), tree_leaves(q)):
                    flat = d.reshape(-1)
                    nb = -(-flat.numel() // QSGD_BUCKET)
                    segs = torch.nn.functional.pad(flat, (0, nb * QSGD_BUCKET - flat.numel())).reshape(nb, -1)
                    scale = int8_bucket_scales(segs).repeat_interleave(QSGD_BUCKET)[: flat.numel()]
                    if not bool((torch.abs(v.reshape(-1) - flat) <= scale * (1 + 1e-6)).all()):
                        raise AssertionError(f"[slots] int8 slot {c}: a value is more than one scale from its delta")
                    checked += flat.numel()
        out[codec] = {"round_walls_s": run["round_walls_s"], "launches": run["launches"],
                      "bytes_per_round": run["records"][0].bytes_per_round,
                      **({"kept_entries": kept} if codec == "topk_delta" else {"values_checked": checked})}
    return out


def slot_dp_chaos(torch, ss: dict, mesh) -> dict:
    """Phase 19 (g): DP-SGD (clip 1.0, noise 1.1) clean, then under
    ``MeshChaos`` with ``MESH_DEVICE_FAIL`` (the attempt raises before a
    step: no extra launch) and ``MESH_NONFINITE`` (a whole round runs, is
    poisoned and replayed: one round's launches more) at round 0, each with
    ``max_round_retries=1``, each bit-equal to the clean run."""
    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, MESH_NONFINITE, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.parallel import build_federated_round

    n = len(SLOT_ACTIVE)
    per_round = n * SLOT_STEPS * SLOT_EPOCHS

    def build():
        return build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, dp_clip_norm=1.0,
                                     dp_noise_multiplier=1.1, dp_seed=42)

    clean = slot_run(torch, ss, "dp", build(), mesh, per_round * SLOT_ROUNDS)
    out = {"dp": {"round_walls_s": clean["round_walls_s"], "launches": clean["launches"]}}
    for kind, extra in ((MESH_DEVICE_FAIL, 0), (MESH_NONFINITE, per_round)):
        plan = FaultPlan([Fault(kind, round=0)])
        run = slot_run(torch, ss, f"dp+{kind}", build(), mesh, per_round * SLOT_ROUNDS + extra,
                       max_round_retries=1, fault_injector=MeshChaos(plan))
        if plan.pending or run["retries"] != [1, 0] or not same_bits(run["variables"], clean["variables"]):
            raise AssertionError(f"[slots] dp under {kind}: retries {run['retries']}, pending {plan.pending}, "
                                 "or the global differs from the clean DP run")
        out[f"dp+{kind}"] = {"round_walls_s": run["round_walls_s"], "launches": run["launches"]}
    return out


def refscale_run(card: str) -> dict:
    """``python -m fedcrack_tpu_torch.tools.refscale_federation`` at the
    JAX docstring's smoke flags but 128 px, on the card through
    ``CLI_SHIM``: exit 0, every key of the JAX artifact, finite losses, and
    ``bce_sums`` launches = 2 clients x 2 rounds x 4 steps + 2 eval
    batches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fedcrack_refscale_") as tmp:
        out_path = os.path.join(tmp, "refscale.json")
        proc = CliProcess("refscale", "fedcrack_tpu_torch.tools.refscale_federation", REFSCALE_ARGS + ["--out", out_path],
                          tmp)
        try:
            rc = proc.wait(time.monotonic() + REFSCALE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"the refscale command timed out:\n{proc.text()[-4000:]}")
        if rc != 0:
            raise AssertionError(f"the refscale command exited {rc}:\n{proc.text()[-4000:]}")
        with open(out_path, encoding="utf-8") as f:
            artifact = json.load(f)
        report = proc.report()
    check_refscale_artifact(artifact, jax_refscale_keys())
    if report["bce_sums_launches"] != 2 * 2 * 4 + 2:
        raise AssertionError(f"the refscale command: bce_sums launches {report['bce_sums_launches']}, want 18")
    out = {"command_wall_s": report["wall_s"], "start_to_first_launch_s": report["start_to_first_launch_s"],
           "bce_sums_launches": report["bce_sums_launches"], "summary": artifact["summary"],
           "device_kind": artifact["hardware"]["device_kind"]}
    log(f"[slots] python -m fedcrack_tpu_torch.tools.refscale_federation {' '.join(REFSCALE_ARGS)}: "
        f"{json.dumps(out)} [{card}]")
    return out


def slots_phase(torch, card: str) -> dict:
    """Phase 19, several clients per round on one card: the monolithic
    streamed round through the driver (the main path, each slot's weights
    held to a host fit), then the staging, segmented, resident, cohort,
    codec and DP-under-chaos runs, each against it; the global served
    quantized; the refscale command."""
    import numpy as np

    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round,
        build_federated_round_segments,
        make_mesh,
    )

    t0 = time.monotonic()
    ss = slot_setup(torch)
    split = {"setup": time.monotonic() - t0}
    n = len(SLOT_ACTIVE)
    want = n * SLOT_STEPS * SLOT_EPOCHS * SLOT_ROUNDS
    images = want * TRAIN_BATCH
    mesh = make_mesh(n)
    main_fn = build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS)
    slots, inputs = {}, [ss["global0"]]
    main_fn.slot_hook = lambda c, v: slots.__setitem__((len(slots) // n, c), v)

    # ---- (a) the main path, counted ----
    main = slot_run(torch, ss, "main", main_fn, mesh, want, on_round=lambda rec, v: inputs.append(v))
    main_fn.slot_hook = None
    t_host = time.monotonic()
    host = slot_host_path(torch, ss, inputs, slots, card)
    split["host_path"] = time.monotonic() - t_host
    runs = {"a_main": main}
    # ---- (b)-(e) against the main path ----
    runs["b_sequential"] = slot_run(torch, ss, "sequential", main_fn, mesh, want, overlap_staging=False)
    seg = build_federated_round_segments(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, segments=2)
    runs["c_segmented"] = slot_run(torch, ss, "segmented", seg, mesh, want)
    res = build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, data_placement="resident")
    runs["d_resident"] = slot_run(torch, ss, "resident", res, mesh, want, data_fn=ss["plan_fn"],
                                  data_placement="resident", sample_pool=ss["pool"])
    cohort = build_federated_cohort_round(make_mesh(2), ss["cfg"], local_epochs=SLOT_EPOCHS)
    runs["e_cohort"] = slot_run(torch, ss, "cohort", cohort, make_mesh(2), want, cohort=True)
    # ---- the overlap knobs, each against its sequential form, ABBA ----
    overlap_runs = {
        "overlapped_1": (main_fn, {}), "overlapped_2": (main_fn, {}),
        "sequential_2": (main_fn, {"overlap_staging": False}),
        "segmented_round_overlap_1": (seg, {"round_overlap": True}),
        "segmented_round_overlap_2": (seg, {"round_overlap": True}), "segmented_2": (seg, {}),
    }
    for label, (fn, kw) in overlap_runs.items():
        runs[label] = slot_run(torch, ss, label, fn, mesh, want, **kw)
    for label in ("b_sequential", "c_segmented", "d_resident", "e_cohort", *overlap_runs):
        check_same_run(label, runs[label], main)

    def walls_of(*labels):
        # Each run's round walls and its whole 2-round wall (the driver
        # call, between-round work included).
        return [{"rounds": runs[k]["round_walls_s"], "run": runs[k]["wall_s"]} for k in labels]

    overlap_walls = {
        "overlap_staging": {"sequential": walls_of("b_sequential", "sequential_2"),
                            "overlapped": walls_of("overlapped_1", "overlapped_2")},
        "round_overlap": {"off": walls_of("c_segmented", "segmented_2"),
                          "on": walls_of("segmented_round_overlap_1", "segmented_round_overlap_2")},
    }
    plan_bytes = n * SLOT_EPOCHS * SLOT_STEPS * TRAIN_BATCH * 4
    staged = [r.staged_bytes for r in runs["d_resident"]["records"]]
    if staged != [ss["pool"].nbytes + plan_bytes, plan_bytes]:
        raise AssertionError(f"[slots] resident staged bytes {staged}, want the pool once and the plan")
    split["slot_runs_a_to_e_and_overlap"] = time.monotonic() - t_host - split["host_path"]
    t_rest = time.monotonic()
    codecs = slot_codec_checks(torch, ss, card, mesh)
    split["codecs"] = time.monotonic() - t_rest
    dp = slot_dp_chaos(torch, ss, mesh)
    split["dp_under_chaos"] = time.monotonic() - t_rest - split["codecs"]
    t_rest = time.monotonic()
    serve = serve_global(torch, ss["cfg"], host_tree(main["variables"]), card, "slots", SLOT_SEED)
    split["serve"] = time.monotonic() - t_rest
    t_rest = time.monotonic()
    refscale = refscale_run(card)
    split["refscale_process"] = time.monotonic() - t_rest
    walls = {k: v["round_walls_s"] for k, v in runs.items()}
    walls.update({k: v["round_walls_s"] for k, v in {**codecs, **dp}.items()})
    out = {
        "launches": main["launches"], "served_launches": serve["served_launches"],
        "images_per_s": images / main["wall_s"], "host_loop_images_per_s": images / sum(host["round_walls_s"]),
        "images_per_s_by_round": [images / SLOT_ROUNDS / w for w in main["round_walls_s"]],
        "host_loop_images_per_s_by_round": [images / SLOT_ROUNDS / w for w in host["round_walls_s"]],
        "host_loop_round_walls_s": host["round_walls_s"], "round_walls_s": walls, "overlap_walls_s": overlap_walls,
        "global_diff_over_fold_bound": host["global_diff_over_fold_bound"],
        "resident_staged_bytes": staged, "codecs": {k: {kk: vv for kk, vv in v.items() if kk != "round_walls_s"}
                                                    for k, v in codecs.items()},
        "launches_by_run": {k: v["launches"] for k, v in {**runs, **dp}.items()},
        "refscale_command_s": refscale["command_wall_s"], "phase_s": time.monotonic() - t0,
        "main_run_s": main["wall_s"], "split_s": split,
        "slot_round_walls_total_s": sum(sum(v) for v in walls.values()),
    }
    log(f"[slots] main path: 4 slots (active {list(SLOT_ACTIVE)}, n_samples {list(SLOT_SAMPLES)}), 2 rounds x 2 "
        f"epochs x 2 steps at 128 px batch 16: {out['images_per_s']:.1f} images/s through the driver (by round "
        f"{out['images_per_s_by_round']}) against {out['host_loop_images_per_s']:.1f} through the host loop (by "
        f"round {out['host_loop_images_per_s_by_round']}) [{card}]")
    log(f"[slots] round walls (s) per run: {json.dumps(walls)} [{card}]")
    log(f"[slots] overlap knobs, walls (s), run in the order sequential, overlapped, overlapped, sequential "
        f"and off, on, on, off: {json.dumps(overlap_walls)} [{card}]")
    log(f"[phase19] {json.dumps(out)} [{card}]")
    if not np.isfinite(out["images_per_s"]):
        raise AssertionError("[slots] no images/s")
    return out


# ---- phase 20: a client's step split into shards with sync-BN ----

SPATIAL_SEED = 20
SPATIAL_TALL = (2, 1024, 256)  # B, H, W of (a) and (b): the tall images the spatial plane exists for
SPATIAL_SHARDS = 4
SPATIAL_ROUND = {"clients": 2, "space": 2, "steps": 2, "batch": 2, "rounds": 2, "h": 512, "w": 256}
# tests/test_parallel.py::TestSpatialFederatedRound's shapes: 4 clients x 2
# bands, 2 epochs x 2 steps of 4 images at 32 px, the tiny U-Net.
SPATIAL_JAX_TEST = {"clients": 4, "space": 2, "steps": 2, "batch": 4, "epochs": 2, "img": 32,
                    "model": {"stem_features": 4, "encoder_features": (8,), "decoder_features": (8, 4)}}
C5_IMG, C5_BATCH, C5_STEPS = 128, 16, 2
BASELINE_ARGS = ["--configs", "c1,c2,c3,c5", "--samples", "32", "--epochs", "1", "--rounds", "1",
                 "--mesh-steps", "2", "--mesh-img", "128", "--epochs-quality", "1"]
BASELINE_TIMEOUT_S = 300.0


def tall_batch(n: int, h: int, w: int, seed: int):
    """``n`` seeded synthetic crack images of ``h x w`` and their masks
    (``synth_crack_batch`` at ``h``, its first ``w`` columns)."""
    import numpy as np

    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    images, masks = synth_crack_batch(n, h, seed=seed)
    return np.ascontiguousarray(images[:, :, :w]), np.ascontiguousarray(masks[:, :, :w])


def trees_within(label: str, got, want, atol: float, bn_atol: float = 5e-3) -> dict:
    """``tests/test_parallel.py::_assert_trees_match`` on two flax-layout
    trees: every leaf within ``atol``, a bias feeding a BatchNorm within
    ``bn_atol`` (its true gradient is 0, so Adam turns noise into lr-sized
    steps there). Returns the largest difference of each class."""
    import numpy as np

    worst = {"other": 0.0, "bn_fed_bias": 0.0}
    want_flat = dict(_flat_tree(host_tree(want)))
    for path, g in _flat_tree(host_tree(got)):
        name = ".".join(path[1:-1] + (path[-1] if path[-1] != "kernel" else "weight",))
        kind = "bn_fed_bias" if path[0] == "params" and _bn_fed_bias(name) else "other"
        d = float(np.max(np.abs(np.asarray(g, np.float64) - np.asarray(want_flat[path], np.float64))))
        worst[kind] = max(worst[kind], d)
    if worst["other"] > atol or worst["bn_fed_bias"] > bn_atol:
        raise AssertionError(f"[spatial] {label}: {worst} over atol {atol} (BN-fed biases {bn_atol})")
    return worst


def adam_step_bound(steps: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most one bias-corrected Adam step (optax's, eps aside) can move
    an element, in units of the learning rate, over the first ``steps``
    steps: ``|m_hat| / sqrt(v_hat) <= sqrt(sum_i a_i^2 / b_i)`` (Cauchy-
    Schwarz), ``a_i`` and ``b_i`` the weights of gradient ``i`` in
    ``m_hat`` and ``v_hat``."""
    import math

    worst = 0.0
    for t in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        worst = max(worst, math.sqrt(sum(x * x / y for x, y in zip(a, b))))
    return worst


def spatial_predict_run(torch, cfg, variables, images, card: str) -> dict:
    """Phase 20 (a): ``build_spatial_predict`` at S = 4 against the
    single-device forward on the card, f32 with TF32 off: the largest
    probability difference within ``SERVE_PROB_TOL``, and no more mask
    flips than pixels within that difference of 0.5 (the flip bound).
    S = 1, S = 4 and the single-device forward are timed."""
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet
    from fedcrack_tpu_torch.parallel import build_spatial_predict, make_spatial_mesh

    model = from_flax_variables(variables, ResUNet(cfg)).eval()
    x = torch.from_numpy(images).cuda()
    with torch.no_grad():
        want = torch.sigmoid(model(x))
    fns = {s: build_spatial_predict(make_spatial_mesh(s), cfg) for s in (1, SPATIAL_SHARDS)}
    out = {}
    for s, fn in fns.items():
        got = fn(model, x)
        diff = float((got - want).abs().max())
        flips = int(((got > 0.5) != (want > 0.5)).sum())
        near = int(((want - 0.5).abs() <= diff).sum())
        if not diff < SERVE_PROB_TOL or flips > near or got.shape != want.shape:
            raise AssertionError(f"[spatial] predict S={s}: {diff} from the single-device forward, {flips} flips "
                                 f"against {near} pixels within it of 0.5, shape {tuple(got.shape)}")
        out[f"S{s}"] = {"max_prob_diff": diff, "flips": flips, "pixels_near_threshold": near,
                        "ms": cuda_ms(torch, lambda fn=fn: fn(model, x), iters=5, warmup=2)}

    def single():
        with torch.no_grad():
            return torch.sigmoid(model(x))

    out["single_device_ms"] = cuda_ms(torch, single, iters=5, warmup=2)
    out["crack_share"] = float((want > 0.5).float().mean())
    log(f"[spatial] (a) predict {SPATIAL_TALL[0]} x {SPATIAL_TALL[1]} x {SPATIAL_TALL[2]}: {json.dumps(out)} [{card}]")
    return out


def step_criteria(torch, label: str, start: dict, got_params: dict, want_params: dict, got_buffers: dict,
                  want_buffers: dict) -> dict:
    """Phase 20 (b)'s criteria for one SGD(1.0) step from ``start`` (so a
    parameter's move is its gradient) against a reference step: per leaf
    ||d|| <= 5e-3 ||ref|| + 1e-5, a BN-fed bias's gradient norm on either
    side below 1e-4 of the largest gradient (see :func:`spatial_step_run`),
    the running statistics within rtol 1e-4 / atol 1e-6. Returns the worst
    ratios."""
    worst = {"grad_err_over_bound": 0.0, "bn_fed_bias_err_over_bound": 0.0, "bn_fed_bias_norm_over_g_max": 0.0,
             "stats_rel": 0.0}
    grads = {name: ((start[name] - p.detach()).double(), (start[name] - want_params[name].detach()).double())
             for name, p in got_params.items()}
    g_max = max(float(g_1.abs().max()) for _, g_1 in grads.values())
    bad = []
    for name, (g_s, g_1) in grads.items():
        err, bound = float(torch.linalg.vector_norm(g_s - g_1)), 5e-3 * float(torch.linalg.vector_norm(g_1)) + 1e-5
        if _bn_fed_bias(name):
            noise = max(float(torch.linalg.vector_norm(g_s)), float(torch.linalg.vector_norm(g_1))) / g_max
            worst["bn_fed_bias_err_over_bound"] = max(worst["bn_fed_bias_err_over_bound"], err / bound)
            worst["bn_fed_bias_norm_over_g_max"] = max(worst["bn_fed_bias_norm_over_g_max"], noise)
            if noise > 1e-4:
                bad.append(f"{name}: a BN-fed bias's gradient norm at {noise:.3e} of the largest gradient")
        else:
            worst["grad_err_over_bound"] = max(worst["grad_err_over_bound"], err / bound)
            if err > bound:
                bad.append(f"{name}: gradient off by ||d|| = {err:.3e}, bound {bound:.3e}")
    if bad:
        raise AssertionError(f"{label} {bad}; {json.dumps(worst)}")
    for name, b in got_buffers.items():
        want = want_buffers[name]
        if not torch.allclose(b, want, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{label} {name}: running statistics {float((b - want).abs().max())} apart")
        worst["stats_rel"] = max(worst["stats_rel"], float(((b - want).abs() / want.abs().clamp_min(1e-6)).max()))
    return worst


def spatial_step_run(torch, cfg, variables, images, masks, card: str) -> dict:
    """Phase 20 (b): one ``build_spatial_train_step`` step at S = 4 with
    SGD(1.0), so a parameter's move is its gradient, against the
    single-device ``train_step`` from the same weights: per leaf ||d|| <=
    5e-3 ||ref|| + 1e-5 (``tests/test_spatial.py``'s criterion), the
    running statistics within rtol 1e-4 / atol 1e-6, the loss within rtol
    1e-5; one ``bce_sums`` launch for all bands, on its wrapper count and
    the profiler's. Both steps are then timed.

    A bias feeding a train-mode BatchNorm has a true gradient of exactly
    0: both sides hold rounding noise there, which at these 524,288
    pixels reaches JAX's 1e-5 floor (calibrated at 8,192) on the CPU too
    (2 x 256 x 128 at full width: ||d|| 1.25e-5 against a bound of
    1.004e-5, both sides' norms ~9e-6). Those leaves are held as phase 7
    holds them: each side's gradient norm below 1e-4 of the largest
    gradient of the net. Their JAX-criterion ratio is logged."""
    import numpy as np

    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import build_spatial_train_step, make_spatial_mesh
    from fedcrack_tpu_torch.train import local

    step = build_spatial_train_step(make_spatial_mesh(SPATIAL_SHARDS), cfg,
                                    optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
    batch = (torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda())
    start = {k: v.detach().clone() for k, v in step.init(variables).model.named_parameters()}
    sharded, single = step.init(variables), step.init(variables)
    torch.cuda.synchronize()
    bce.reset_launch_counts()
    _, m_s = step(sharded, *batch)
    torch.cuda.synchronize()
    launches = bce.bce_sums.launches
    _, m_1 = local.train_step(single, batch, {}, 0.0, 1.0)
    loss_rel = abs(float(m_s["loss"]) - float(m_1["loss"])) / abs(float(m_1["loss"]))
    worst = step_criteria(torch, "[spatial] (b)", start, dict(sharded.model.named_parameters()),
                          dict(single.model.named_parameters()), dict(sharded.model.named_buffers()),
                          dict(single.model.named_buffers()))
    if loss_rel > 1e-5 or launches != 1:
        raise AssertionError(f"[spatial] (b) loss {loss_rel} apart relatively, bce_sums launches {launches}")
    seen = []
    for _ in range(PROFILE_TRIES):
        probe = step.init(variables)
        torch.cuda.synchronize()
        with card_profile() as prof:
            step(probe, *batch)
        profiled = sum(e.count for e in card_kernels(prof) if "bce_sums_kernel" in e.key)
        if profiled == 1:
            break
        seen.append(profiled)
        log(f"profile retaken: {profiled} bce_sums_kernel records in one sharded step")
    else:
        raise AssertionError(f"[spatial] (b) the profiler saw {seen} bce_sums kernels in one step, want 1")

    def step_ms(fn, state, n=5):
        fn(state)
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    out = {"loss": float(m_s["loss"]), "loss_rel": loss_rel, **worst, "bce_sums_launches": launches,
           "bce_sums_profiled": profiled,
           "sharded_step_ms": step_ms(lambda st: step(st, *batch), sharded),
           "single_step_ms": step_ms(lambda st: local.train_step(st, batch, {}, 0.0, 1.0), single)}
    log(f"[spatial] (b) one step at S={SPATIAL_SHARDS} against the single-device step: {json.dumps(out)} [{card}]")
    return out


def spatial_round_run(torch, cfg, card: str) -> dict:
    """Phase 20 (c), the main path: ``build_spatial_federated_round`` over
    2 clients x 2 bands, 1 epoch x 2 steps of 2 images at 512 x 256, 2
    rounds through the driver, counted (2 x 2 x 2 = 8 ``bce_sums``
    launches); each round's global against the ``(2, 1)`` round's on the
    same data within Adam's bound (below); (c2) the same comparison at
    ``TestSpatialFederatedRound``'s shapes within its atol 1e-4 (BN-fed
    biases 5e-3); the global served ``fused_int8``."""
    import numpy as np

    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import build_federated_round, build_spatial_federated_round, make_mesh
    from fedcrack_tpu_torch.parallel import run_mesh_federation
    from fedcrack_tpu_torch.parallel.spatial import SPACE

    p = SPATIAL_ROUND
    c, steps, b = p["clients"], p["steps"], p["batch"]
    per = [tall_batch(steps * b, p["h"], p["w"], SPATIAL_SEED * 100 + i) for i in range(c)]
    images = np.stack([im.reshape(steps, b, *im.shape[1:]) for im, _ in per])
    masks = np.stack([m.reshape(steps, b, *m.shape[1:]) for _, m in per])
    active, ns = np.ones(c, np.float32), np.full(c, float(steps * b), np.float32)
    global0 = init_variables(torch.Generator().manual_seed(SPATIAL_SEED + 1), cfg)
    runs = {}
    for label, mesh, build in (
        ("spatial", make_mesh(c, p["space"], axis_names=("clients", SPACE)), build_spatial_federated_round),
        ("unsplit", make_mesh(c), build_federated_round),
    ):
        rf = build(mesh, cfg, local_epochs=1)
        globals_ = []
        torch.cuda.synchronize()
        bce.reset_launch_counts()
        t0 = time.monotonic()
        final, records = run_mesh_federation(rf, global0, lambda r: (images, masks, active, ns) if r == 0 else None,
                                             p["rounds"], mesh, on_round=lambda rec, v: globals_.append(v))
        torch.cuda.synchronize()
        runs[label] = {"final": final, "globals": globals_, "wall_s": time.monotonic() - t0,
                       "launches": bce.bce_sums.launches, "round_walls_s": [r.wall_clock_s for r in records],
                       "losses": [r.metrics["loss"] for r in records]}
        want = c * steps * p["rounds"]
        if runs[label]["launches"] != want or not all(bool(torch.isfinite(t).all()) for t in tree_leaves(final)):
            raise AssertionError(f"[spatial] (c) {label}: bce_sums launches {runs[label]['launches']} (want {want}) "
                                 "or a non-finite global")
    # Two float32 programs that sum in other orders (the bands' convs and
    # BatchNorm moments against the whole image's) drift apart over Adam
    # steps at full width: BatchNorm's fast variance and Adam's sign-like
    # first steps amplify the rounding of near-zero gradients to lr-sized
    # moves (phase 7 compares the card and the CPU over one step for the
    # same reason). So each round's global is held to what Adam allows:
    # each side moves an element at most adam_step_bound * lr a step, and
    # FedAvg is a convex combination, so after round r the two differ by at
    # most 2 * r * steps * bound * lr. How many elements leave the JAX
    # test's atol 1e-4 is logged; check (c2) holds that tolerance at the JAX
    # test's own shapes.
    lr = 1e-3
    step_bound = adam_step_bound(steps)
    diffs = []
    for r, (g, u) in enumerate(zip(runs["spatial"]["globals"], runs["unsplit"]["globals"])):
        bound = 2 * (r + 1) * steps * step_bound * lr * (1 + 1e-3)
        d = trees_within(f"round {r} (Adam bound)", g, u, atol=bound, bn_atol=bound)
        gl, ul = tree_leaves(host_tree(g)), tree_leaves(host_tree(u))
        d["beyond_1e-4"] = int(sum(int((np.abs(a - b) > 1e-4).sum()) for a, b in zip(gl, ul)))
        d["elements"] = int(sum(a.size for a in gl))
        d["adam_bound"] = bound
        diffs.append(d)
    losses = {k: [rec_m.tolist() for rec_m in v["losses"]] for k, v in runs.items()}
    jax_shapes = spatial_round_jax_shapes(torch, card)
    serve = serve_global(torch, cfg, host_tree(runs["spatial"]["final"]), card, "spatial", SPATIAL_SEED)
    out = {"launches": runs["spatial"]["launches"], "served_launches": serve["served_launches"],
           "global_diff_by_round": diffs, "client_losses_by_round": losses, "jax_test_shapes": jax_shapes,
           **{f"{k}_round_walls_s": v["round_walls_s"] for k, v in runs.items()},
           **{f"{k}_wall_s": v["wall_s"] for k, v in runs.items()}}
    log(f"[spatial] (c) {c} clients x {p['space']} bands, {p['rounds']} rounds x {steps} steps of {b} at "
        f"{p['h']} x {p['w']}: {json.dumps(out)} [{card}]")
    return out


def spatial_round_jax_shapes(torch, card: str) -> dict:
    """Phase 20 (c2): ``tests/test_parallel.py::TestSpatialFederatedRound``
    on the card: the tiny U-Net at 32 px, 4 clients x 2 bands, 2 epochs x
    2 steps of 4 images, against the (4, 1) round on the same data, within
    its atol 1e-4 (BN-fed biases 5e-3); 16 ``bce_sums`` launches a run."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import build_federated_round, build_spatial_federated_round, make_mesh
    from fedcrack_tpu_torch.parallel import stack_client_data
    from fedcrack_tpu_torch.parallel.spatial import SPACE

    p = SPATIAL_JAX_TEST
    cfg = dataclasses.replace(ModelConfig(img_size=p["img"]), **p["model"])
    c = p["clients"]
    per = [synth_crack_batch(p["steps"] * p["batch"], p["img"], seed=i) for i in range(c)]
    images, masks = stack_client_data(per, p["steps"], p["batch"])
    active, ns = np.ones(c, np.float32), np.full(c, float(p["steps"] * p["batch"]), np.float32)
    global0 = init_variables(torch.Generator().manual_seed(2), cfg)
    got = {}
    for label, mesh, build in (
        ("spatial", make_mesh(c, p["space"], axis_names=("clients", SPACE)), build_spatial_federated_round),
        ("unsplit", make_mesh(c), build_federated_round),
    ):
        bce.reset_launch_counts()
        got[label], _ = build(mesh, cfg, learning_rate=1e-3, local_epochs=p["epochs"])(global0, images, masks,
                                                                                         active, ns)
        torch.cuda.synchronize()
        if bce.bce_sums.launches != c * p["steps"] * p["epochs"]:
            raise AssertionError(f"[spatial] (c2) {label}: bce_sums launches {bce.bce_sums.launches}")
    return trees_within("(c2) at the JAX test's shapes", got["spatial"], got["unsplit"], atol=1e-4)


def c5_batch_axis_run(torch, card: str) -> dict:
    """Phase 20 (d): ``round_from_config`` on ``configs/c5_bf16_batch_dp.json``
    at its mesh shape (4, 2), 128 px, batch 16, one epoch of 2 steps: in
    float32 against the (4, 1) round within
    ``test_intra_client_batch_dp_matches_host``'s atol 5e-5 (BN-fed biases
    5e-3), then in c5's bfloat16 with finite weights; 8 ``bce_sums``
    launches a run."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import round_from_config, stack_client_data

    with open(os.path.join(HERE, "configs", "c5_bf16_batch_dp.json"), encoding="utf-8") as f:
        c5 = FedConfig.from_json(f.read())
    c5 = dataclasses.replace(c5, model=dataclasses.replace(c5.model, img_size=C5_IMG),
                             data=dataclasses.replace(c5.data, img_size=C5_IMG, batch_size=C5_BATCH), local_epochs=1)
    f32 = dataclasses.replace(c5, model=dataclasses.replace(c5.model, compute_dtype="float32"))
    n = c5.mesh_clients
    per = [synth_crack_batch(C5_STEPS * C5_BATCH, C5_IMG, seed=SPATIAL_SEED * 10 + i) for i in range(n)]
    images, masks = stack_client_data(per, C5_STEPS, C5_BATCH)
    active, ns = np.ones(n, np.float32), np.full(n, float(C5_STEPS * C5_BATCH), np.float32)
    global0 = init_variables(torch.Generator().manual_seed(SPATIAL_SEED + 2), c5.model)
    out, got = {}, {}
    for label, cfg in (("f32_4x2", f32), ("f32_4x1", dataclasses.replace(f32, mesh_batch=1)), ("bf16_4x2", c5)):
        mesh, rf = round_from_config(cfg)
        torch.cuda.synchronize()
        bce.reset_launch_counts()
        t0 = time.monotonic()
        got[label], _ = rf(global0, images, masks, active, ns)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = bce.bce_sums.launches
        if launches != n * C5_STEPS or not all(bool(torch.isfinite(t).all()) for t in tree_leaves(got[label])):
            raise AssertionError(f"[spatial] (d) {label}: bce_sums launches {launches} or a non-finite global")
        out[label] = {"mesh": mesh.shape, "wall_s": wall, "launches": launches}
    out["f32_4x2_vs_4x1"] = trees_within("c5 (4, 2) vs (4, 1)", got["f32_4x2"], got["f32_4x1"], atol=5e-5)
    out["f32_bit_equal"] = same_bits(got["f32_4x2"], got["f32_4x1"])
    log(f"[spatial] (d) c5's mesh fields, {n} clients x batch axis 2 at {C5_IMG} px batch {C5_BATCH}: "
        f"{json.dumps(out)} [{card}]")
    return out


def jax_baseline_keys(root: str = HERE) -> dict:
    """The row keys of the JAX package's ``tools/measure_baseline`` per
    ``measure_*`` function, read from its source with ``ast`` (nothing of
    it is imported); a ``**quality`` spread stands for ``_eval_quality``'s
    keys."""
    import ast

    with open(os.path.join(root, "fedcrack_tpu", "tools", "measure_baseline.py"), encoding="utf-8") as f:
        module = ast.parse(f.read())
    fns = {n.name: n for n in module.body if isinstance(n, ast.FunctionDef)}

    def returned(fn):
        return [n for n in ast.walk(fns[fn]) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1].value

    quality = {k.value for k in returned("_eval_quality").keys}
    return {name: {k.value for k in returned(name).keys if k is not None}
            | (quality if any(k is None for k in returned(name).keys) else set())
            for name in ("measure_c1", "measure_c2", "measure_mesh")}


def baseline_run(torch, card: str) -> dict:
    """Phase 20 (e): ``python -m fedcrack_tpu_torch.tools.measure_baseline``
    over c1, c2, c3 and c5 at a scaled workload on the card through
    ``CLI_SHIM``: exit 0, four rows with every key of the JAX tool's rows,
    the card's name in ``hardware.device_kind``, c5 on the (4, 2) mesh."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fedcrack_baseline_") as tmp:
        out_path = os.path.join(tmp, "baseline.json")
        proc = CliProcess("baseline", "fedcrack_tpu_torch.tools.measure_baseline", BASELINE_ARGS + ["--out", out_path],
                          tmp)
        try:
            rc = proc.wait(time.monotonic() + BASELINE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"the measure_baseline command timed out:\n{proc.text()[-4000:]}")
        if rc != 0:
            raise AssertionError(f"the measure_baseline command exited {rc}:\n{proc.text()[-4000:]}")
        with open(out_path, encoding="utf-8") as f:
            artifact = json.load(f)
        report = proc.report()
    rows = artifact["rows"]
    want = jax_baseline_keys()
    kind = torch.cuda.get_device_name(0)
    if len(rows) != 4 or artifact["hardware"]["device_kind"] != kind:
        raise AssertionError(f"measure_baseline: {len(rows)} rows, hardware {artifact['hardware']}")
    for row, fn in zip(rows, ("measure_c1", "measure_c2", "measure_mesh", "measure_mesh")):
        if set(row) != want[fn] or row["hardware"]["device_kind"] != kind:
            raise AssertionError(f"measure_baseline {row.get('config')}: keys {sorted(set(row) ^ want[fn])} differ "
                                 f"from the JAX row's, or hardware {row['hardware']}")
    if (rows[3]["workload"]["clients"], rows[3]["workload"]["batch_dp"]) != (4, 2):
        raise AssertionError(f"measure_baseline c5 workload {rows[3]['workload']}")
    out = {"command_wall_s": report["wall_s"], "start_to_first_launch_s": report["start_to_first_launch_s"],
           "bce_sums_launches": report["bce_sums_launches"], "hardware": artifact["hardware"],
           "rows": {r["config"]: {k: r.get(k) for k in ("round_wall_clock_s", "per_step_ms", "wall_clock_s",
                                                         "val_loss", "iou")} for r in rows}}
    log(f"[spatial] (e) python -m fedcrack_tpu_torch.tools.measure_baseline {' '.join(BASELINE_ARGS)}: "
        f"{json.dumps(out)} [{card}]")
    return out


def spatial_phase(torch, card: str) -> dict:
    """Phase 20, a client's step split into shards with sync-BN, at full
    width (``ModelConfig()``): the spatial predict and train step on tall
    images, the spatial round (the main path) served quantized, c5's batch
    axis, and the measure_baseline command."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.train.local import configure_backends

    t0 = time.monotonic()
    configure_backends()
    cfg = ModelConfig()
    variables = init_variables(torch.Generator().manual_seed(SPATIAL_SEED), cfg)
    b, h, w = SPATIAL_TALL
    images, masks = tall_batch(b, h, w, SPATIAL_SEED)
    predict = spatial_predict_run(torch, cfg, variables, images, card)
    step = spatial_step_run(torch, cfg, variables, images, masks, card)
    rnd = spatial_round_run(torch, cfg, card)
    c5 = c5_batch_axis_run(torch, card)
    baseline = baseline_run(torch, card)
    out = {"launches": rnd["launches"], "served_launches": rnd["served_launches"], "predict": predict,
           "step": step, "round": {k: v for k, v in rnd.items() if k not in ("launches", "served_launches")},
           "c5": c5, "baseline": baseline, "phase_s": time.monotonic() - t0}
    log(f"[phase20] {json.dumps(out)} [{card}]")
    return out


# ---- phase 21: several processes sharing the card ----

MULTIHOST_RANKS = 2
MULTIHOST_TIMEOUT_S = 300.0
MULTIHOST_SEED = 21
MULTIHOST_REPEATS = 5  # timed predicts and steps, after one warm call
COHORT_ACTIVE = (1.0, 1.0, 0.0, 1.0, 1.0, 1.0)  # six clients in groups of 4: the last group ragged
COHORT_SAMPLES = (32.0, 32.0, 32.0, 64.0, 32.0, 32.0)


def _save_flat(out: dict, prefix: str, tree) -> None:
    for path, v in _flat_tree(host_tree(tree)):
        out[prefix + "/".join(path)] = v


def _load_flat(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _exchange_ms(span, calls: int) -> dict:
    """The span's host-staged collectives per call of what ran ``calls``
    times since its last reset: ms, count and bytes."""
    return {"exchange_ms": span.stats["seconds"] * 1e3 / calls, "exchanges": span.stats["calls"] // calls,
            "exchange_bytes": span.stats["bytes"] // calls}


def multihost_worker(argv: list) -> int:
    """One rank of phase 21, run through ``CLI_SHIM`` as ``chip_smoke
    --multihost-worker RANK STORE WORK``: joins the gloo group through the
    ``file://`` STORE, then (a) phase 19's main round with this rank's two
    slots, null and int8, 2 rounds each, counted and timed (the gather
    apart), and (b) phase 20's tall images with this rank's two bands: the
    predict and one SGD(1.0) step, counted, then both timed with the
    host-staged exchanges apart; (d) the cohort round of six clients in
    groups of four, streamed and resident, this rank's two slots of every
    group. Writes ``rank<R>.npz`` (each round's global, the cohort's, the
    probabilities, the stepped weights) and ``rank<R>.json`` under WORK."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet, init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round,
        build_spatial_predict,
        build_spatial_train_step,
        global_mesh_devices,
        initialize_if_needed,
        is_coordinator,
        make_mesh,
        make_spatial_mesh,
    )
    from fedcrack_tpu_torch.parallel.multihost import WORLD
    from fedcrack_tpu_torch.train.local import configure_backends

    rank, store, work = int(argv[0]), argv[1], argv[2]
    if not torch.cuda.is_available():
        raise SystemExit("multihost worker: no CUDA device")
    configure_backends()
    t_join = time.monotonic()
    initialize_if_needed("file://" + store, MULTIHOST_RANKS, rank, timeout_s=MULTIHOST_TIMEOUT_S)
    report = {"rank": rank, "join_s": time.monotonic() - t_join, "coordinator": is_coordinator(),
              "devices": [str(d) for _, d in global_mesh_devices()]}
    out: dict = {}

    # (a) the round: this rank's block of phase 19's four slots.
    ss = slot_setup(torch)
    mesh = make_mesh(len(SLOT_ACTIVE), group=WORLD)
    mine = slice(mesh.local_range("clients").start, mesh.local_range("clients").stop)
    # The count is set to 0 before the main path (the null round) and read
    # as differences after: the shim reports the process's total at exit.
    torch.cuda.synchronize()
    bce.reset_launch_counts()
    for name, kw in (("null", {}), ("int8", {"update_codec": "int8"})):
        round_fn = build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, **kw)
        variables, walls, gathers = ss["global0"], [], []
        before = bce.bce_sums.launches
        for r in range(SLOT_ROUNDS):
            images, masks, active, ns = ss["slab_fn"](r)
            t0 = time.monotonic()
            variables, metrics = round_fn(variables, images[mine], masks[mine], active, ns)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            gathers.append(round_fn.last_gather)
            _save_flat(out, f"{name}/{r}/", variables)
            for k, v in metrics.items():
                out[f"{name}/{r}/metrics/{k}"] = v.cpu().numpy()
        report[name] = {"bce_sums_launches": bce.bce_sums.launches - before, "round_walls_s": walls,
                        "gathers": gathers}

    # (d) the cohort round: this rank's block of every group of four.
    cs = cohort_setup(torch)
    for placement in ("streamed", "resident"):
        cr = build_federated_cohort_round(mesh, cs["cfg"], local_epochs=1, data_placement=placement)
        before = bce.bce_sums.launches
        t0 = time.monotonic()
        variables, metrics = cr(cs["global0"], *cohort_data(cs, placement), cs["active"], cs["ns"])
        torch.cuda.synchronize()
        report[f"cohort_{placement}"] = {"bce_sums_launches": bce.bce_sums.launches - before,
                                         "wall_s": time.monotonic() - t0}
        _save_flat(out, f"cohort_{placement}/", variables)
        for k, v in metrics.items():
            out[f"cohort_{placement}/metrics/{k}"] = v.cpu().numpy()

    # (b) the spatial plane: this rank's block of phase 20's bands.
    cfg = ModelConfig()
    variables = init_variables(torch.Generator().manual_seed(SPATIAL_SEED), cfg)
    b, h, w = SPATIAL_TALL
    images, masks = tall_batch(b, h, w, SPATIAL_SEED)
    smesh = make_spatial_mesh(SPATIAL_SHARDS, group=WORLD)
    bands, span = smesh.local_range("space"), smesh.span
    rows = slice(bands.start * h // SPATIAL_SHARDS, bands.stop * h // SPATIAL_SHARDS)
    x = torch.from_numpy(np.ascontiguousarray(images[:, rows])).cuda()
    y = torch.from_numpy(np.ascontiguousarray(masks[:, rows])).cuda()
    model = from_flax_variables(variables, ResUNet(cfg)).eval()
    predict = build_spatial_predict(smesh, cfg)
    out["spatial/probs"] = predict(model, x).cpu().numpy()
    span.reset_stats()
    report["predict"] = {"ms": cuda_ms(torch, lambda: predict(model, x), iters=MULTIHOST_REPEATS, warmup=0),
                         **_exchange_ms(span, MULTIHOST_REPEATS)}
    step = build_spatial_train_step(smesh, cfg, optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
    state = step.init(variables)
    before = bce.bce_sums.launches
    _, m = step(state, x, y)
    torch.cuda.synchronize()
    report["step"] = {"bce_sums_launches": bce.bce_sums.launches - before, "loss": float(m["loss"])}
    # Copies: the timed steps below go on moving the model.
    for n_, p in state.model.named_parameters():
        out[f"step/param/{n_}"] = np.array(p.detach().cpu())
    for n_, buf in state.model.named_buffers():
        out[f"step/buffer/{n_}"] = np.array(buf.cpu())
    for k, v in m.items():
        out[f"step/metrics/{k}"] = v.cpu().numpy()
    span.reset_stats()
    ms = []
    for _ in range(MULTIHOST_REPEATS):
        t0 = time.perf_counter()
        step(state, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    report["step"].update({"ms": float(np.median(ms)), **_exchange_ms(span, MULTIHOST_REPEATS)})
    dist.barrier()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def cohort_setup(torch) -> dict:
    """Phase 21 (d)'s cohort: ``ModelConfig()`` at 128 px, batch 16, six
    clients of 32 uint8 samples (``active = [1, 1, 0, 1, 1, 1]``) in
    groups of the mesh's four slots, so the second group is ragged; one
    epoch of 2 steps from a seeded plan, streamed (``pool[idx]``) or
    resident (the pool and the plan)."""
    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables

    n = len(COHORT_ACTIVE)
    pool = SamplePool.stack([to_uint8_transport(*synth_crack_batch(SLOT_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                                                                   seed=MULTIHOST_SEED * 100 + c))
                             for c in range(n)])
    idx = pool.round_indices([np.random.default_rng([MULTIHOST_SEED, c]) for c in range(n)], 1, SLOT_STEPS,
                             TRAIN_BATCH)
    images, masks = pool.assemble_round_slab(idx)
    return {"cfg": ModelConfig(), "pool": pool, "idx": idx, "images": images, "masks": masks,
            "active": np.asarray(COHORT_ACTIVE, np.float32), "ns": np.asarray(COHORT_SAMPLES, np.float32),
            "global0": init_variables(torch.Generator().manual_seed(MULTIHOST_SEED), ModelConfig())}


def cohort_data(cs: dict, placement: str) -> tuple:
    """The cohort round's data arguments: the whole cohort's slabs, or its
    pool and plan."""
    if placement == "streamed":
        return cs["images"], cs["masks"]
    return (cs["pool"].images, cs["pool"].masks), cs["idx"]


def cohort_launches_per_rank(ranks: int) -> int:
    """``bce_sums`` launches of one cohort run on each of ``ranks``
    processes: every rank trains its block of every group, padding
    slots included, one epoch of ``SLOT_STEPS`` steps."""
    groups = -(-len(COHORT_ACTIVE) // len(SLOT_ACTIVE))
    return groups * (len(SLOT_ACTIVE) // ranks) * SLOT_STEPS


def _first_difference(got: dict, want: dict) -> str:
    import numpy as np

    for key in sorted(want):
        if got[key].tobytes() != want[key].tobytes():
            d = float(np.max(np.abs(got[key].astype(np.float64) - want[key].astype(np.float64))))
            return f"{key}: max |d| {d}"
    return "none"


def multihost_phase(torch, card: str, slot_plane: dict, spatial: dict) -> dict:
    """Phase 21, two processes sharing the card over gloo
    (:func:`multihost_worker`, through ``CLI_SHIM``). (a) Phase 19's main
    round with two slots per process, null and int8: every round's global
    bit-equal on both ranks and to the same round in this process, 16
    ``bce_sums`` launches per process per build. (b) Phase 20's tall
    images at S = 4, two bands per process: the predict within 1e-5 of the
    one-process S = 4 predict with no mask flip, and one SGD(1.0) step
    meeting phase 20's criteria (:func:`step_criteria`, the loss within
    rtol 1e-5) against the one-process S = 4 step, one ``bce_sums`` launch
    per process. (c) The round's global served ``fused_int8`` (15 / 8 / 6 / 0).
    (d) The cohort round, six clients in groups of four (the last ragged),
    streamed and resident, two slots of every group per process: every
    global and metric bit-equal on both ranks and to the same cohort in
    this process, the ``bce_sums`` launches per process derived before the
    run (:func:`cohort_launches_per_rank`). The walls, the gather and the
    exchanges are logged beside phases 19 and 20's."""
    import tempfile

    import numpy as np

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.fed.pytree import tree_flatten, tree_unflatten
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet, init_variables
    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round,
        build_spatial_predict,
        build_spatial_train_step,
        make_mesh,
        make_spatial_mesh,
    )

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="fedcrack_multihost_") as work:
        store = os.path.join(work, "store")
        procs = [CliProcess(f"rank{r}", "chip_smoke", ["--multihost-worker", str(r), store, work], work)
                 for r in range(MULTIHOST_RANKS)]
        run_processes(procs, time.monotonic() + MULTIHOST_TIMEOUT_S)
        shims = [p.report() for p in procs]
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(MULTIHOST_RANKS)]
        reports = []
        for r in range(MULTIHOST_RANKS):
            with open(os.path.join(work, f"rank{r}.json"), encoding="utf-8") as f:
                reports.append(json.load(f))
    workers_s = time.monotonic() - t0
    want_launches = 2 * SLOT_STEPS * SLOT_EPOCHS * SLOT_ROUNDS
    cohort_launches = cohort_launches_per_rank(MULTIHOST_RANKS)
    for rep, shim in zip(reports, shims):
        counts = (rep["null"]["bce_sums_launches"], rep["int8"]["bce_sums_launches"], rep["step"]["bce_sums_launches"],
                  rep["cohort_streamed"]["bce_sums_launches"], rep["cohort_resident"]["bce_sums_launches"])
        if counts != (want_launches, want_launches, 1, cohort_launches, cohort_launches):
            raise AssertionError(f"[multihost] rank {rep['rank']}: bce_sums launches {counts}, want "
                                 f"({want_launches}, {want_launches}, 1, {cohort_launches}, {cohort_launches})")
        if shim["bce_sums_launches"] != 2 * want_launches + 1 + MULTIHOST_REPEATS + 2 * cohort_launches:
            raise AssertionError(f"[multihost] rank {rep['rank']}: {shim['bce_sums_launches']} bce_sums launches "
                                 "in the process")
    if [rep["coordinator"] for rep in reports] != [True, False]:
        raise AssertionError(f"[multihost] coordinators {[rep['coordinator'] for rep in reports]}")

    # (a) against the same rounds in this process.
    ss = slot_setup(torch)
    mesh = make_mesh(len(SLOT_ACTIVE))
    one_process = {}
    for name, kw in (("null", {}), ("int8", {"update_codec": "int8"})):
        round_fn = build_federated_round(mesh, ss["cfg"], local_epochs=SLOT_EPOCHS, **kw)
        variables, walls = ss["global0"], []
        for r in range(SLOT_ROUNDS):
            t1 = time.monotonic()
            variables, metrics = round_fn(variables, *ss["slab_fn"](r))
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t1)
            want = {"/".join(p): v for p, v in _flat_tree(host_tree(variables))}
            for rank, got in enumerate(ranks):
                mine = _load_flat(got, f"{name}/{r}/")
                g = {k: v for k, v in mine.items() if not k.startswith("metrics/")}
                if set(g) != set(want) or any(g[k].tobytes() != want[k].tobytes() for k in want):
                    raise AssertionError(f"[multihost] {name} round {r}: rank {rank}'s global differs from the "
                                         f"one-process round's; first difference {_first_difference(g, want)}")
                for k, v in metrics.items():
                    if mine[f"metrics/{k}"].tobytes() != v.cpu().numpy().tobytes():
                        raise AssertionError(f"[multihost] {name} round {r}: rank {rank}'s metric {k} differs")
        one_process[name] = walls
    round_out = {
        "round_walls_s": {name: [rep[name]["round_walls_s"] for rep in reports] for name in ("null", "int8")},
        "gathers": {name: [rep[name]["gathers"] for rep in reports] for name in ("null", "int8")},
        "one_process_round_walls_s": one_process,
        "phase19_a_main_round_walls_s": slot_plane["round_walls_s"]["a_main"],
        "bce_sums_launches_per_process": [rep["null"]["bce_sums_launches"] for rep in reports],
    }
    log(f"[multihost] (a) phase 19's round over 2 processes x 2 slots, null and int8, 2 rounds each: every "
        f"global bit-equal on both ranks and to the one-process round; {json.dumps(round_out)} [{card}]")

    # (d) the cohort round against the same cohort in this process.
    cs = cohort_setup(torch)
    cohort_out = {"bce_sums_launches_per_rank": cohort_launches, "by_rank": [
        {k: rep[f"cohort_{k}"] for k in ("streamed", "resident")} for rep in reports], "one_process_wall_s": {}}
    for placement in ("streamed", "resident"):
        cr = build_federated_cohort_round(mesh, cs["cfg"], local_epochs=1, data_placement=placement)
        t1 = time.monotonic()
        variables, metrics = cr(cs["global0"], *cohort_data(cs, placement), cs["active"], cs["ns"])
        torch.cuda.synchronize()
        cohort_out["one_process_wall_s"][placement] = time.monotonic() - t1
        want = {"/".join(p): v for p, v in _flat_tree(host_tree(variables))}
        for rank, got in enumerate(ranks):
            mine = _load_flat(got, f"cohort_{placement}/")
            g = {k: v for k, v in mine.items() if not k.startswith("metrics/")}
            if set(g) != set(want) or any(g[k].tobytes() != want[k].tobytes() for k in want):
                raise AssertionError(f"[multihost] (d) cohort {placement}: rank {rank}'s global differs from the "
                                     f"one-process cohort round's; first difference {_first_difference(g, want)}")
            for k, v in metrics.items():
                if v.shape != (len(COHORT_ACTIVE),) or mine[f"metrics/{k}"].tobytes() != v.cpu().numpy().tobytes():
                    raise AssertionError(f"[multihost] (d) cohort {placement}: rank {rank}'s metric {k} differs")
    log(f"[multihost] (d) the cohort round, {len(COHORT_ACTIVE)} clients in groups of {len(SLOT_ACTIVE)} (the last "
        f"ragged), streamed and resident, 2 slots of every group a process: every global and metric bit-equal on "
        f"both ranks and to one process; {json.dumps(cohort_out)} [{card}]")

    # (b) against the one-process S = 4 plane.
    cfg = ModelConfig()
    variables = init_variables(torch.Generator().manual_seed(SPATIAL_SEED), cfg)
    b, h, w = SPATIAL_TALL
    images, masks = tall_batch(b, h, w, SPATIAL_SEED)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()
    model = from_flax_variables(variables, ResUNet(cfg)).eval()
    want = build_spatial_predict(make_spatial_mesh(SPATIAL_SHARDS), cfg)(model, x).cpu().numpy()
    got = np.concatenate([rk["spatial/probs"] for rk in ranks], axis=1)
    diff = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))))
    flips = int(((got > 0.5) != (want > 0.5)).sum())
    if got.shape != want.shape or not diff <= 1e-5 or flips:
        raise AssertionError(f"[multihost] (b) predict: {diff} from the one-process S=4 predict, {flips} flips, "
                             f"shape {got.shape}")
    step = build_spatial_train_step(make_spatial_mesh(SPATIAL_SHARDS), cfg,
                                    optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
    state = step.init(variables)
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    _, m_1 = step(state, x, y)
    for rank, rk in enumerate(ranks[1:], 1):
        if any(rk[k].tobytes() != ranks[0][k].tobytes() for k in ranks[0] if k.startswith("step/")):
            raise AssertionError(f"[multihost] (b) rank {rank}'s stepped weights differ from rank 0's")
    cuda = {k: torch.from_numpy(v).cuda() for k, v in ranks[0].items() if k.startswith("step/")}
    worst = step_criteria(torch, "[multihost] (b)", start,
                          {k[len("step/param/"):]: v for k, v in cuda.items() if k.startswith("step/param/")},
                          dict(state.model.named_parameters()),
                          {k[len("step/buffer/"):]: v for k, v in cuda.items() if k.startswith("step/buffer/")},
                          dict(state.model.named_buffers()))
    loss_rel = abs(float(ranks[0]["step/metrics/loss"]) - float(m_1["loss"])) / abs(float(m_1["loss"]))
    if loss_rel > 1e-5:
        raise AssertionError(f"[multihost] (b) loss {loss_rel} apart relatively")
    spatial_out = {
        "predict": {"max_prob_diff": diff, "flips": flips, "by_rank": [rep["predict"] for rep in reports],
                    "phase20_S4_ms": spatial["predict"]["S4"]["ms"],
                    "phase20_single_device_ms": spatial["predict"]["single_device_ms"]},
        "step": {"loss_rel": loss_rel, **worst, "by_rank": [rep["step"] for rep in reports],
                 "phase20_sharded_step_ms": spatial["step"]["sharded_step_ms"],
                 "phase20_single_step_ms": spatial["step"]["single_step_ms"]},
    }
    log(f"[multihost] (b) phase 20's 2 x 1024 x 256 at S=4 over 2 processes x 2 bands: {json.dumps(spatial_out)} "
        f"[{card}]")

    # (c) the two-process round's global served.
    _, treedef = tree_flatten(ss["global0"])
    final = tree_unflatten(treedef, [ranks[0][f"null/{SLOT_ROUNDS - 1}/" + "/".join(path)]
                                     for path, _ in _flat_tree(ss["global0"])])
    serve = serve_global(torch, ss["cfg"], final, card, "multihost", MULTIHOST_SEED)
    out = {"launches": sum(rep["null"]["bce_sums_launches"] for rep in reports),
           "cohort_launches": sum(rep["cohort_streamed"]["bce_sums_launches"] for rep in reports),
           "served_launches": serve["served_launches"], "round": round_out, "spatial": spatial_out,
           "cohort": cohort_out,
           "workers": [{"wall_s": s["wall_s"], "start_to_first_launch_s": s["start_to_first_launch_s"],
                        "bce_sums_launches": s["bce_sums_launches"], "join_s": rep["join_s"]}
                       for s, rep in zip(shims, reports)],
           "workers_s": workers_s, "phase_s": time.monotonic() - t0}
    log(f"[phase21] {json.dumps(out)} [{card}]")
    return out


# ---- phase 22: configs/c6_s2d_layout.json's layouts on the card ----

C6_SEED = 22
C6_SAMPLES = 32  # synthetic samples a client: two steps of 16 an epoch
C6_CUTS = {"train_samples": 256, "local_epochs": 1, "max_rounds": 2}
C6_BUCKETS = (128, 256)
C6_FORWARD = (2, 128)  # tests/test_model.py's layout tests: batch 2 at 128 px


def c6_setup(torch) -> dict:
    """Phase 22's federation: ``configs/c6_s2d_layout.json`` through
    ``FedConfig.from_json`` and the same config cut by ``C6_CUTS`` (widths,
    layouts, dtype, batch and slots are c6's); 8 clients of 32 seeded
    synthetic uint8 samples at its 128 px as a reference pool and as a
    ``SamplePool(layout="s2d")``, each round's plan drawn from seeded
    generators (2 steps of 16 a client), one seeded global."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.data.pipeline import SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.models.resunet import init_variables

    with open(os.path.join(HERE, "configs", "c6_s2d_layout.json"), encoding="utf-8") as f:
        c6 = FedConfig.from_json(f.read())
    cfg = dataclasses.replace(c6, local_epochs=C6_CUTS["local_epochs"], max_rounds=C6_CUTS["max_rounds"],
                              data=dataclasses.replace(c6.data, train_samples=C6_CUTS["train_samples"]))
    n, batch, size = cfg.mesh_clients, cfg.data.batch_size, cfg.model.img_size
    if n * C6_SAMPLES != cfg.data.train_samples:
        raise AssertionError(f"[c6] {n} clients x {C6_SAMPLES} samples is not train_samples {cfg.data.train_samples}")
    pools = [to_uint8_transport(*synth_crack_batch(C6_SAMPLES, size, seed=C6_SEED * 100 + c)) for c in range(n)]
    ref_pool, s2d_pool = SamplePool.stack(pools), SamplePool.stack(pools, layout="s2d")
    active, ns = np.ones(n, np.float32), np.full(n, float(C6_SAMPLES), np.float32)
    steps = C6_SAMPLES // batch

    def plan(r):
        return s2d_pool.round_indices([np.random.default_rng([C6_SEED, r, c]) for c in range(n)],
                                      cfg.local_epochs, steps, batch)

    return {"c6": c6, "cfg": cfg, "ref_pool": ref_pool, "s2d_pool": s2d_pool, "active": active, "ns": ns,
            "steps": steps, "plan": plan, "launches": n * steps * cfg.local_epochs * cfg.max_rounds,
            "global0": init_variables(torch.Generator().manual_seed(C6_SEED), cfg.model)}


def c6_run(torch, cs: dict, label: str, cfg, data_fn, **kwargs) -> dict:
    """One counted run of ``cfg.max_rounds`` rounds of ``round_from_config(cfg)``
    through ``run_mesh_federation``: exactly ``cs["launches"]`` ``bce_sums``
    launches, finite globals and ``[C]`` metrics."""
    import numpy as np

    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import round_from_config, run_mesh_federation

    mesh, round_fn = round_from_config(cfg)
    globals_ = []
    torch.cuda.synchronize()
    bce.reset_launch_counts()
    t0 = time.monotonic()
    final, records = run_mesh_federation(round_fn, cs["global0"], data_fn, cfg.max_rounds, mesh,
                                         data_placement=cfg.data_placement,
                                         on_round=lambda rec, v: globals_.append(v), **kwargs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = bce.bce_sums.launches
    if launches != cs["launches"]:
        raise AssertionError(f"[c6] {label}: bce_sums launches {launches}, want {cs['launches']}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(final)):
        raise AssertionError(f"[c6] {label}: non-finite global")
    if not all(np.isfinite(v).all() and v.shape == (cfg.mesh_clients,) for r in records for v in r.metrics.values()):
        raise AssertionError(f"[c6] {label}: metrics not finite [C] vectors")
    return {"final": final, "globals": globals_, "records": records, "wall_s": wall, "launches": launches,
            "round_walls_s": [r.wall_clock_s for r in records]}


def ulp_distance(a, b) -> float:
    """The largest ``|a - b|`` over the float32 spacing at the larger
    magnitude of the two, elementwise."""
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale))


def c6_layout_rounds(torch, cs: dict, card: str) -> dict:
    """Phase 22 (a) and (b). (a) The main path, c6's round three ways:
    images packed on the device (reference-layout slabs), pre-packed on
    the host by ``space_to_depth_images``, and resident from the
    ``SamplePool(layout="s2d")``; every global and metric bit-equal,
    ``cs["launches"]`` launches each. (b) The same rounds with the
    reference layouts: bit-equal, or every parameter within Adam's
    per-step bound (two sides each moving an element at most
    ``adam_step_bound * lr`` a step, FedAvg convex), the statistics finite;
    which held and the largest differences logged."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.data.pipeline import space_to_depth_images
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    cfg = cs["cfg"]

    def device_packed(r):
        return (*cs["ref_pool"].assemble_round_slab(cs["plan"](r)), cs["active"], cs["ns"])

    def host_packed(r):
        images, masks, active, ns = device_packed(r)
        return space_to_depth_images(images), masks, active, ns

    runs = {"a_device_packed": c6_run(torch, cs, "device_packed", cfg, device_packed)}
    runs["a_host_packed"] = c6_run(torch, cs, "host_packed", cfg, host_packed)
    runs["a_resident_s2d_pool"] = c6_run(
        torch, cs, "resident_s2d_pool", dataclasses.replace(cfg, data_placement="resident"),
        lambda r: (cs["plan"](r), cs["active"], cs["ns"]), sample_pool=cs["s2d_pool"])
    main = runs["a_device_packed"]
    for label in ("a_host_packed", "a_resident_s2d_pool"):
        if not same_bits(runs[label]["final"], main["final"]):
            raise AssertionError(f"[c6] (a) {label}: the global differs from the device-packed run's")
        for rg, rw in zip(runs[label]["records"], main["records"]):
            if any(rg.metrics[k].tobytes() != rw.metrics[k].tobytes() for k in rw.metrics):
                raise AssertionError(f"[c6] (a) {label}: round {rw.round_idx} metrics differ")
    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, stem_layout="reference",
                                                                 res_layout="reference"))
    runs["b_reference_layout"] = c6_run(torch, cs, "reference_layout", ref_cfg, device_packed)
    lr, steps = cfg.learning_rate, cs["steps"] * cfg.local_epochs
    step_bound = adam_step_bound(steps)
    rounds = []
    for r, (g, w) in enumerate(zip(main["globals"], runs["b_reference_layout"]["globals"])):
        entry = {"bit_equal": same_bits(g, w)}
        if not entry["bit_equal"]:
            bound = 2 * (r + 1) * steps * step_bound * lr * (1 + 1e-3)
            entry.update(trees_within(f"(b) round {r} against the reference layout (Adam bound)",
                                      {"params": g["params"]}, {"params": w["params"]}, atol=bound, bn_atol=bound))
            gs, ws = tree_leaves(host_tree(g["batch_stats"])), tree_leaves(host_tree(w["batch_stats"]))
            if not all(np.isfinite(x).all() for x in gs):
                raise AssertionError(f"[c6] (b) round {r}: non-finite statistics")
            entry["batch_stats_max_diff"] = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(gs, ws))
            gl, wl = tree_leaves(host_tree(g["params"])), tree_leaves(host_tree(w["params"]))
            entry["params_beyond_1e-4"] = int(sum(int((np.abs(a - b) > 1e-4).sum()) for a, b in zip(gl, wl)))
            entry["adam_bound"] = bound
        rounds.append(entry)
    out = {"launches": main["launches"], "launches_by_run": {k: v["launches"] for k, v in runs.items()},
           "round_walls_s": {k: v["round_walls_s"] for k, v in runs.items()},
           "run_walls_s": {k: v["wall_s"] for k, v in runs.items()},
           "images_per_s": cs["launches"] * cfg.data.batch_size / main["wall_s"],
           "against_reference_layout": rounds}
    log(f"[c6] (a) c6's round, {cfg.mesh_clients} slots x {cfg.max_rounds} rounds x {steps} steps of "
        f"{cfg.data.batch_size} at {cfg.model.img_size} px, {cfg.model.compute_dtype}, stem {cfg.model.stem_layout}, "
        f"residuals {cfg.model.res_layout}: packed on the device, on the host and resident from the s2d pool, "
        f"bit-equal; (b) against the reference layouts: "
        f"{'bit-equal' if all(e['bit_equal'] for e in rounds) else 'within Adam per-step bound'}; "
        f"{json.dumps(out)} [{card}]")
    return {**out, "final": main["final"]}


def c6_forwards(torch, cs: dict, card: str) -> dict:
    """Phase 22 (e) and the forward checks at the JAX layout tests' shapes
    (float32 ``ModelConfig()`` widths, 2 x 128 x 128) on the seeded
    global: packed and unpacked input to each space-to-depth stem
    ``torch.equal`` (eval and train mode); ``s2d`` + ``packed`` against
    the reference layout bit-equal or within the JAX tests' atol and rtol
    1e-4 (logged which); ``s2d_full`` within atol and rtol 1e-4; c6's
    bfloat16 forward against bfloat16 reference layouts logged."""
    import dataclasses

    import numpy as np

    from fedcrack_tpu_torch.models import space_to_depth
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    n, size = C6_FORWARD
    x = torch.from_numpy(np.random.default_rng(C6_SEED).uniform(0, 1, (n, size, size, 3)).astype(np.float32)).cuda()
    f32 = dataclasses.replace(cs["cfg"].model, compute_dtype="float32", img_size=size)
    out = {}

    def forward(cfg, inp, train):
        model = from_flax_variables(cs["global0"], ResUNet(cfg))
        model.train(train)
        with torch.no_grad():
            return model(inp).cpu().numpy()

    for mode in ("eval", "train"):
        train = mode == "train"
        ref = forward(dataclasses.replace(f32, stem_layout="reference", res_layout="reference"), x, train)
        for stem, res in (("s2d", "packed"), ("s2d_full", "packed"), ("s2d", "reference")):
            cfg = dataclasses.replace(f32, stem_layout=stem, res_layout=res)
            unpacked = forward(cfg, x, train)
            packed = forward(cfg, space_to_depth(x), train)
            if packed.tobytes() != unpacked.tobytes():
                raise AssertionError(f"[c6] {stem}+{res} {mode}: packed input differs from unpacked input")
            d = float(np.max(np.abs(unpacked.astype(np.float64) - ref)))
            entry = {"bit_equal": unpacked.tobytes() == ref.tobytes(), "max_abs": d,
                     "max_ulps": ulp_distance(unpacked, ref)}
            if not entry["bit_equal"]:
                np.testing.assert_allclose(unpacked, ref, rtol=1e-4, atol=1e-4,
                                           err_msg=f"[c6] {stem}+{res} {mode} against the reference layout")
            out[f"{stem}+{res}/{mode}"] = entry
    bf16 = dataclasses.replace(f32, compute_dtype="bfloat16")
    got = forward(bf16, x, False)
    want = forward(dataclasses.replace(bf16, stem_layout="reference", res_layout="reference"), x, False)
    out["bf16_s2d+packed/eval"] = {"bit_equal": got.tobytes() == want.tobytes(),
                                   "max_abs": float(np.max(np.abs(got.astype(np.float64) - want)))}
    log(f"[c6] (e) forwards at {n} x {size} x {size}, packed input torch.equal to unpacked for every stem, each "
        f"layout against the reference layout: {json.dumps(out)} [{card}]")
    return out


def c6_serve(torch, cs: dict, weights, card: str) -> dict:
    """Phase 22 (c), (d) and (f). (c) The c6 global through
    ``InferenceEngine`` on the reference plane, float32 and int8
    (``quantize_variables``) at buckets 128 and 256, ``max_batch`` 8,
    against a reference-layout engine on the same weights: the canary IoU
    and PSI of int8 against float32 on each side's probe batches held by
    ``check_flip_bound``; images/s per engine, payload and bucket. (d)
    ``fused_int8`` and ``fp8`` refuse c6's layouts with the JAX message.
    (f) Where ``h5py`` is installed, the global exported by
    ``tools.h5_export``, imported by ``tools.h5_import`` byte-equal, and
    served once bit-equal to the original; else logged as not run."""
    import dataclasses
    import tempfile

    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.serve import quant as quant_mod
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    model = cs["cfg"].model
    ref_model = dataclasses.replace(model, stem_layout="reference", res_layout="reference")
    sc = ServeConfig(bucket_sizes=C6_BUCKETS, max_batch=BATCH, quant="int8", kernel_plane="reference")
    engines = {"c6": InferenceEngine(model, sc), "reference_layout": InferenceEngine(ref_model, sc)}
    q = quant_mod.quantize_variables(weights)
    probes, numbers, timing, payloads = {}, {}, {}, {}
    for name, engine in engines.items():
        payloads[name] = {"f32": engine.prepare(weights), "int8": engine.prepare(q)}
        probes[name] = probe_probs(engine, payloads[name])
        numbers[name] = verdict_numbers(probes[name], "f32", "int8")
        timing[name] = {f"{kind}/{size}": time_batches(engine, payload, size)
                        for kind, payload in payloads[name].items() for size in C6_BUCKETS}
    flip = check_flip_bound("[c6] (c) c6 against the reference layout", probes["reference_layout"], probes["c6"],
                            numbers["reference_layout"], numbers["c6"], "f32", "int8")
    bit_equal = all(probes["c6"][size][1][k].tobytes() == probes["reference_layout"][size][1][k].tobytes()
                    for size in C6_BUCKETS for k in ("f32", "int8"))
    refused = {}
    for plane in ("fused_int8", "fp8"):
        want = (f"kernel_plane={plane!r} supports only the reference parameter layouts (kernels/forward.py); got "
                f"stem_layout={model.stem_layout!r} res_layout={model.res_layout!r}")
        try:
            InferenceEngine(model, ServeConfig(quant="int8", kernel_plane=plane))
        except ValueError as e:
            if str(e) != want:
                raise AssertionError(f"[c6] (d) {plane}: refused with {e!r}, want {want!r}") from e
            refused[plane] = str(e)
        else:
            raise AssertionError(f"[c6] (d) {plane} accepted c6's layouts")
    h5 = {"ran": False}
    if importlib.util.find_spec("h5py") is None:
        log(f"[c6] (f) h5py is not installed on this machine: the h5 round trip did not run [{card}]")
    else:
        from fedcrack_tpu_torch.tools.h5_export import export_resunet_h5
        from fedcrack_tpu_torch.tools.h5_import import import_resunet_h5

        with tempfile.TemporaryDirectory(prefix="fedcrack_h5_") as tmp:
            path = os.path.join(tmp, "crack_segmentation.h5")
            t0 = time.monotonic()
            export_resunet_h5(weights, path, model)
            back = import_resunet_h5(path, model)
            h5 = {"ran": True, "bytes": os.path.getsize(path), "round_trip_s": time.monotonic() - t0}
        if not same_bits(back, weights):
            raise AssertionError("[c6] (f) the h5 round trip changed the global")
        batch = probes["c6"][C6_BUCKETS[0]][0]
        served = engines["c6"].predict_bucket(engines["c6"].prepare(back), batch)
        if served.tobytes() != probes["c6"][C6_BUCKETS[0]][1]["f32"].tobytes():
            raise AssertionError("[c6] (f) the re-imported global serves other probabilities")
        h5["leaves"] = len(tree_leaves(back))
    out = {"verdicts": {k: {"iou": v["iou"], "psi": v["psi"]} for k, v in numbers.items()}, "flip_bound": flip,
           "bit_equal_to_reference_layout": bit_equal, "timing": timing, "refused": sorted(refused), "h5": h5}
    log(f"[c6] (c) the c6 global served on the reference plane at buckets {list(C6_BUCKETS)}, max_batch {BATCH}, "
        f"f32 and int8, held to the reference-layout engine by the flip bound; (d) fused_int8 and fp8 refused; "
        f"(f) h5 {'round trip byte-equal and served' if h5['ran'] else 'not run'}: {json.dumps(out)} [{card}]")
    return out


def c6_phase(torch, card: str) -> dict:
    """Phase 22: ``configs/c6_s2d_layout.json`` (8 slots, bfloat16, ``s2d``
    stem, ``packed`` residuals, ``ModelConfig()`` widths at 128 px, batch
    16) through ``parallel.round_from_config`` on the card, cut as
    ``C6_CUTS`` says (logged): (a) the round three ways, bit-equal, 32
    ``bce_sums`` launches a run; (b) against the reference layouts; (c)
    served on the reference plane; (d) the fused planes' refusal; (e)
    ``s2d_full`` and the forwards at the JAX tests' shapes; (f) the h5
    round trip where ``h5py`` is installed."""
    import dataclasses

    t0 = time.monotonic()
    cs = c6_setup(torch)
    c6, cfg = cs["c6"], cs["cfg"]
    cuts = {"clients": [c6.mesh_clients, cfg.mesh_clients], "samples_a_client": [None, C6_SAMPLES],
            "train_samples": [c6.data.train_samples, cfg.data.train_samples],
            "local_epochs": [c6.local_epochs, cfg.local_epochs], "max_rounds": [c6.max_rounds, cfg.max_rounds]}
    log(f"[c6] configs/c6_s2d_layout.json cut for the smoke (c6's value, the phase's): {json.dumps(cuts)}; "
        f"model {json.dumps(dataclasses.asdict(cfg.model))} [{card}]")
    rounds = c6_layout_rounds(torch, cs, card)
    t_forward = time.monotonic()
    forwards = c6_forwards(torch, cs, card)
    t_serve = time.monotonic()
    serve = c6_serve(torch, cs, host_tree(rounds.pop("final")), card)
    out = {"launches": rounds["launches"], "rounds": rounds, "forwards": forwards, "serve": serve,
           "split_s": {"rounds": t_forward - t0, "forwards": t_serve - t_forward, "serve": time.monotonic() - t_serve},
           "phase_s": time.monotonic() - t0}
    log(f"[phase22] {json.dumps(out)} [{card}]")
    return out


# ---- phase 23: the concurrent soak and fedlint ----

SOAK_SEED = 0
SOAK_JAX_SHAPE_S = 8.0
SOAK_FULL_WIDTH_S = 20.0
SOAK_CLI_S = 5.0
SOAK_CLI_TIMEOUT_S = 180.0
FEDLINT_TIMEOUT_S = 180.0
# The JAX soak's RSS slack, chosen for a model of a few kilobytes.
SOAK_RSS_SLACK = 256 * 1024 * 1024
# Host copies of the weight tree (or its blob) the soak can hold at one
# instant, by holder, at buffer_k 2 and max_staleness 8 (9 retained
# versions): the full-width slack is SOAK_RSS_SLACK plus their sum times
# the tree's bytes.
SOAK_LIVE_TREES = {
    "root: the retained broadcasts (9 blobs) and their decoded memo (9 trees)": 18,
    "root: the statefile snapshot (9 bases, the global, 2 buffered) as msgpack parts and joined bytes": 24,
    "manager: the statefile it reads (12 blobs) and the decoded global": 13,
    "the killed root's state, referenced until the soak returns (9 bases, the global, 2 buffered)": 12,
    "edge: its retained bases (9 blobs) and their decoded trees (9)": 18,
    "3 clients: pulled blob, decoded tree, perturbed tree, upload blob, top-k residual, its base": 18,
    "EF twin: base tree and blob, trained, decoded, codec residual and base, 5 float64 leaf lists (2 each)": 16,
}


def soak_rss_slack(tree_bytes: int) -> int:
    return SOAK_RSS_SLACK + sum(SOAK_LIVE_TREES.values()) * tree_bytes


def check_soak(artifact: dict, label: str) -> None:
    """tests/test_telemetry.py's ``_assert_soak_clean`` without its
    recompile arm (the port's audit has none), plus a swap and the
    kill -> restart."""
    audit, wd, tr = artifact["audit"], artifact["watchdog"], artifact["tracing"]
    spans = artifact["spans"]["by_name"]
    problems = []
    if not audit["clean"]:
        problems.append("audit not clean")
    for arm in ("zero_torn_versions", "serve_healthy", "ef_mass_conserved", "statefile_restore_bit_identical",
                "watermarks_steady", "watchdog_clean"):
        if not audit[arm]:
            problems.append(arm)
    if audit["torn_versions"] != 0 or "recompiles_since_warmup" in audit:
        problems.append("torn versions or a recompile arm")
    if not (artifact["scrape"]["all_planes_covered"] and artifact["scrape"]["mid_soak_families"] > 0):
        problems.append(f"scrape {artifact['scrape']}")
    if not (artifact["serve"]["completed"] > 0 and artifact["serve"]["failed"] == 0):
        problems.append("serve completed/failed")
    if not (artifact["federation"]["flushes"] > 0 and artifact["spans"]["total"] > 0):
        problems.append("no flush or no span")
    problems += [f"no {n} span" for n in ("serve.batch", "fed.flush", "driver.round", "client.train")
                 if not spans.get(n)]
    if not (wd["clean"] and wd["all_rules_evaluated"] and wd["breaches"] == [] and wd["evaluations"] > 1):
        problems.append("watchdog")
    if not (tr["complete"] and {"client", "fed", "serve"} <= set(tr["planes_crossed"])
            and tr["trace"].startswith("fedtr-v") and {"fed.flush", "serve.swap", "serve.batch"} <= set(tr["stages"])
            and {"client.push", "edge.flush_partial"} & set(tr["stages"])):
        problems.append("tracing")
    if not (artifact["serve"]["swaps"] > 0 and artifact["federation"]["kill_restart"]["killed"]):
        problems.append("no swap or no kill")
    if problems:
        raise AssertionError(f"{label}: {problems}: " + json.dumps(
            {k: artifact[k] for k in ("audit", "watchdog", "tracing", "serve", "federation")}, default=str)[:6000])


@contextlib.contextmanager
def served_devices(torch):
    """Record where every engine forward ran: the engine's device, its
    weights' device, the calling thread and its current CUDA device."""
    import threading

    from fedcrack_tpu_torch.serve import engine as serve_engine

    seen = {"batches": 0, "engine": set(), "weights": set(), "threads": set(), "current_device": set()}
    lock = threading.Lock()
    forward = serve_engine.InferenceEngine._forward_batch

    def probe(self, variables, images_u8):
        weights = ({p.device.type for p in variables.parameters()} if isinstance(variables, torch.nn.Module)
                   else {type(variables).__name__})
        with lock:
            seen["batches"] += 1
            seen["engine"].add(str(self.device))
            seen["weights"] |= weights
            seen["threads"].add(threading.current_thread().name)
            seen["current_device"].add(torch.cuda.current_device())
        return forward(self, variables, images_u8)

    serve_engine.InferenceEngine._forward_batch = probe
    try:
        yield seen
    finally:
        serve_engine.InferenceEngine._forward_batch = forward


def kernel_launches() -> dict:
    from fedcrack_tpu_torch.kernels import dequant
    from fedcrack_tpu_torch.ops import bce

    return {"bce_sums": bce.bce_sums.launches,
            **{n: getattr(dequant, n).launches for n in DEQUANT_KERNELS}}


def wire_bytes() -> dict:
    from fedcrack_tpu_torch.obs.promexp import parse_prometheus_text
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    parsed = parse_prometheus_text(REGISTRY.exposition())
    return {d: _counter_sum(parsed, "fed_wire_bytes_total", {"direction": d}) for d in ("up", "down")}


def soak_summary(artifact: dict, seen: dict, wall_s: float) -> dict:
    lat, marks = artifact["serve"]["latency_ms"], artifact["audit"]["watermarks"]
    return {
        "wall_s": wall_s, "traffic_wall_s": artifact["traffic_wall_s"],
        "completed": artifact["serve"]["completed"], "failed": artifact["serve"]["failed"],
        "req_per_s": artifact["serve"]["completed"] / artifact["traffic_wall_s"],
        "p50_ms": lat["p50"], "p99_ms": lat["p99"], "deadline_missed": artifact["serve"]["deadline_missed"],
        "flushes": artifact["federation"]["flushes"], "swaps": artifact["serve"]["swaps"],
        "versions_seen": len(artifact["serve"]["versions_seen"]),
        "client_restarts": artifact["federation"]["client_restarts"],
        "restart_s": artifact["federation"]["kill_restart"].get("restart_s"),
        "edge_flushes": artifact["edge"]["flushes"], "ef_checks": artifact["audit"]["ef"]["checks"],
        "planes_covered": artifact["scrape"]["planes_covered"], "spans": artifact["spans"]["total"],
        "rss_mark": marks["mark"]["rss"], "rss_delta": marks["deltas"]["rss"],
        "rss_watermark": marks["watermark"]["rss"], "device_mark": marks["mark"]["device"],
        "device_delta": marks["deltas"]["device"], "device_watermark": marks["watermark"]["device"],
        "batches_seen": seen["batches"], "threads": sorted(seen["threads"]),
    }


def soak_run(torch, card: str, label: str, **kwargs) -> dict:
    """One ``run_soak`` on the card: the audit clean, every engine forward
    on CUDA (engine, weights, the calling thread's device 0), and no kernel
    launched (the soak serves the reference plane)."""
    from fedcrack_tpu_torch.tools.soak import run_soak

    launches, wire = kernel_launches(), wire_bytes()
    t0 = time.monotonic()
    with served_devices(torch) as seen:
        artifact = run_soak(seed=SOAK_SEED, device="cuda", **kwargs)
    wall_s = time.monotonic() - t0
    check_soak(artifact, label)
    if not (seen["batches"] > 0 and seen["engine"] == {"cuda"} and seen["weights"] == {"cuda"}
            and seen["current_device"] == {0}):
        raise AssertionError(f"{label}: forwards off the card: {seen}")
    if kernel_launches() != launches:
        raise AssertionError(f"{label}: the soak launched kernels: {launches} -> {kernel_launches()}")
    after = wire_bytes()
    out = soak_summary(artifact, seen, wall_s)
    out["root_wire_bytes"] = {d: after[d] - wire[d] for d in after}
    log(f"[soak {label}] {json.dumps(out)} [{card}]")
    return out


def soak_cli_run(card: str) -> dict:
    """(c) ``python -m fedcrack_tpu_torch.tools.soak --duration 5 --out F``
    on the card through ``CLI_SHIM``: exit 0, a clean artifact, no kernel
    launched."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fedcrack_soak_") as tmp:
        out_path = os.path.join(tmp, "soak.json")
        proc = CliProcess("soak", "fedcrack_tpu_torch.tools.soak",
                          ["--duration", str(SOAK_CLI_S), "--out", out_path], tmp)
        try:
            rc = proc.wait(time.monotonic() + SOAK_CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"the soak command timed out:\n{proc.text()[-4000:]}")
        if rc != 0:
            raise AssertionError(f"the soak command exited {rc}:\n{proc.text()[-4000:]}")
        with open(out_path, encoding="utf-8") as f:
            artifact = json.load(f)
        report = proc.report()
    check_soak(artifact, "cli")
    if report["bce_sums_launches"] or any(report["dequant_launches"].values()):
        raise AssertionError(f"the soak command launched kernels: {report}")
    out = {"command_wall_s": report["wall_s"], "traffic_wall_s": artifact["traffic_wall_s"],
           "completed": artifact["serve"]["completed"], "flushes": artifact["federation"]["flushes"],
           "swaps": artifact["serve"]["swaps"], "p50_ms": artifact["serve"]["latency_ms"]["p50"],
           "p99_ms": artifact["serve"]["latency_ms"]["p99"]}
    log(f"[soak cli] python -m fedcrack_tpu_torch.tools.soak: exit 0, audit clean; {json.dumps(out)} [{card}]")
    return out


def fedlint_run(card: str) -> dict:
    """(d) ``python -m fedcrack_tpu_torch.tools.fedlint fedcrack_tpu_torch
    --baseline fedlint_torch_baseline.json``: exit 0, no finding, and its
    lock graph equal to the committed one in nodes and cycles."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="fedcrack_lint_") as tmp:
        findings_path, graph_path = os.path.join(tmp, "findings.json"), os.path.join(tmp, "graph.json")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "fedcrack_tpu_torch.tools.fedlint", "fedcrack_tpu_torch",
             "--baseline", "fedlint_torch_baseline.json", "--no-cache", "--json", findings_path,
             "--lock-graph", graph_path], cwd=HERE, capture_output=True, text=True, timeout=FEDLINT_TIMEOUT_S)
        wall_s = time.monotonic() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fedlint exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
        with open(findings_path, encoding="utf-8") as f:
            findings = json.load(f)["findings"]
        with open(graph_path, encoding="utf-8") as f:
            graph = json.load(f)
    with open(os.path.join(HERE, "fedcrack_tpu_torch", "analysis", "serve_lock_graph.json"), encoding="utf-8") as f:
        committed = json.load(f)
    if findings or graph["cycles"] or graph["cycles"] != committed["cycles"] or \
            [n["node_id"] for n in graph["nodes"]] != [n["node_id"] for n in committed["nodes"]]:
        raise AssertionError(f"fedlint: findings {findings}; graph {graph} against {committed}")
    out = {"wall_s": wall_s, "findings": len(findings), "locks": len(graph["nodes"]), "edges": len(graph["edges"]),
           "cycles": len(graph["cycles"])}
    log(f"[fedlint] python -m fedcrack_tpu_torch.tools.fedlint: exit 0, clean; {json.dumps(out)} [{card}]")
    return out


def soak_lint_phase(torch, card: str) -> dict:
    """Phase 23: (a) the soak at the JAX soak's shape on the card, (b) at
    ``ModelConfig()``'s widths with the derived RSS slack, (c) the soak
    command, (d) fedlint over the port."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.models.resunet import init_variables

    t0 = time.monotonic()
    before = kernel_launches()
    jax_shape = soak_run(torch, card, "jax-shape", duration_s=SOAK_JAX_SHAPE_S)
    full = ModelConfig(img_size=32)
    template = init_variables(torch.Generator().manual_seed(SOAK_SEED), full)
    tree_bytes = sum(int(leaf.nbytes) for leaf in tree_leaves(template))
    slack = soak_rss_slack(tree_bytes)
    log(f"[soak full-width] tree {tree_bytes} B, blob {len(tree_to_bytes(template))} B; RSS slack {slack} B = "
        f"{SOAK_RSS_SLACK} + {sum(SOAK_LIVE_TREES.values())} trees: {json.dumps(SOAK_LIVE_TREES)}")
    del template
    full_width = soak_run(torch, card, "full-width", duration_s=SOAK_FULL_WIDTH_S, model_config=full,
                          rss_slack_bytes=slack)
    full_width.update(tree_bytes=tree_bytes, rss_slack=slack)
    cli = soak_cli_run(card)
    lint = fedlint_run(card)
    after = kernel_launches()
    # In this process; the soak command's own counts are held at 0 above.
    launches = {k: after[k] - before[k] for k in after}
    out = {"jax_shape": jax_shape, "full_width": full_width, "cli": cli, "fedlint": lint,
           "launches": launches, "phase_s": time.monotonic() - t0}
    log(f"[phase23] {json.dumps(out)} [{card}]")
    return out


# Phase 24: the JAX FLOPs model's counts at three configs, which the port's
# must equal exactly; the profiled round and the A/B, each cut from its
# tool's defaults in steps and rounds only (the A/B keeps its sizes).
FLOPS_WANT = {"forward, ModelConfig(), batch 2": 2_144_993_280.0,
              "train step, ModelConfig(), batch 16": 51_479_838_720.0,
              "train step, 256 px, batch 32": 411_838_709_760.0}
PROFILE_STEPS, PROFILE_ROUNDS = 8, 2
PROFILE_ARGS = ["--img", "256", "--dtype", "bfloat16", "--steps", str(PROFILE_STEPS), "--batch", "16",
                "--rounds", str(PROFILE_ROUNDS), "--top", "1000"]
AB_STEPS, AB_REPS, AB_FIT, AB_SIZES = 8, 3, 4, (128, 256)
AB_ARGS = ["--sizes", ",".join(map(str, AB_SIZES)), "--steps", str(AB_STEPS), "--batch", "16", "--reps",
           str(AB_REPS), "--fit-factor", str(AB_FIT), "--dtype", "bfloat16"]


def flops_counts() -> dict:
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.obs.flops import resunet_forward_flops, train_step_flops

    return dict(zip(FLOPS_WANT, (resunet_forward_flops(ModelConfig(), 2), train_step_flops(ModelConfig(), 16),
                                 train_step_flops(ModelConfig(img_size=256), 32))))


def check_profile_artifact(art: dict) -> list:
    """(b)'s checks of a ``tools.profile_step`` artifact, but the
    ``bce_sums_kernel`` records' count (the caller's, since a window may
    lose records)."""
    stats, measured = art["kernel_stats"], art["measured"]
    if stats is None:
        return ["kernel_stats is None: the window held no CUDA kernel"]
    problems = []
    total = sum(c["fraction"] for c in stats["by_category"].values())
    if abs(total - 1.0) > 0.02:
        problems.append(f"category fractions sum to {total}")
    if not measured["profiled_device_s_per_round"] <= measured["round_wall_s_median"]:
        problems.append(f"device {measured['profiled_device_s_per_round']} s a round past the wall "
                        f"{measured['round_wall_s_median']} s")
    if not (measured["naive_mfu"] is not None and 0.0 < measured["naive_mfu"] <= 1.0):
        problems.append(f"naive_mfu {measured['naive_mfu']}")
    return problems


def flops_profile_ab_phase(torch, card: str) -> dict:
    """Phase 24: (a) the FLOPs model and the card's peak, (b)
    ``tools.profile_step`` at 256 px bf16 (its lead-opened window retaken
    once if it lost ``bce_sums`` records), (c) ``tools.ab_bce``'s two arms:
    ``bce_sums`` launches exactly the cuda arm's steps, and the arms' first
    step agrees; all in this process, through each tool's ``main``."""
    import tempfile

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import as_model_batch
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.obs.flops import device_peak_flops
    from fedcrack_tpu_torch.obs.metrics import lead_kept
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.tools import ab_bce, profile_step
    from fedcrack_tpu_torch.train.local import create_train_state

    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    # ---- (a) ----
    counts = flops_counts()
    if counts != FLOPS_WANT:
        raise AssertionError(f"FLOPs model {counts} != the JAX package's {FLOPS_WANT}")
    peak = device_peak_flops(dev)
    if peak is None:
        raise AssertionError(f"no bf16 peak for {torch.cuda.get_device_name(dev)!r}")
    log(f"[flops] {json.dumps(counts)}; bf16 dense peak {peak / 1e12:.1f} TFLOP/s for "
        f"{torch.cuda.get_device_name(dev)} [{card}]")

    with tempfile.TemporaryDirectory(prefix="fedcrack_phase24_") as tmp:
        # ---- (b) the profiled round ----
        want = PROFILE_STEPS * PROFILE_ROUNDS
        out = os.path.join(tmp, "profile.json")
        for attempt in range(2):
            bce.reset_launch_counts()
            t_b = time.monotonic()
            if profile_step.main([*PROFILE_ARGS, "--trace-dir", os.path.join(tmp, "trace"), "--out", out]) != 0:
                raise AssertionError("profile_step.main failed")
            wall_b = time.monotonic() - t_b
            prof_launched = bce.bce_sums.launches
            with open(out, encoding="utf-8") as f:
                prof = json.load(f)
            problems = check_profile_artifact(prof)
            if problems:
                raise AssertionError(f"profile_step: {problems}: {json.dumps(prof)[:4000]}")
            records = prof["kernel_stats"]["bce_sums_records"]
            if records["expected"] != want:
                raise AssertionError(f"profile_step expects {records['expected']} bce_sums_kernel records, want {want}")
            if prof_launched != PROFILE_STEPS * (2 + PROFILE_ROUNDS):
                raise AssertionError(f"profile_step: {prof_launched} bce_sums launches, want "
                                     f"{PROFILE_STEPS * (2 + PROFILE_ROUNDS)}")
            if records["observed"] == want:
                break
            log(f"profile retaken: {records['observed']} bce_sums_kernel records (want {want}); {lead_kept()}")
        else:
            raise AssertionError(f"profile_step: the bce_sums_kernel records read {records['observed']} twice, "
                                 f"want {want}")
        cats = {k: (v["fraction"], round(v["self_time_us"] / PROFILE_ROUNDS / 1e3, 4), v["occurrences"])
                for k, v in prof["kernel_stats"]["by_category"].items()}
        log(f"[profile] 256 px bf16 batch 16, {PROFILE_STEPS} steps x {PROFILE_ROUNDS} rounds: "
            f"{json.dumps(prof['measured'])}; by category (fraction, ms a round, kernels): {json.dumps(cats)}; "
            f"{wall_b:.2f} s [{card}]")
        ops = prof["kernel_stats"]["top_ops"]
        for op in ops[:8] + [op for op in ops[8:] if op["category"] == "other"]:
            log(f"[profile] {op['self_time_us'] / PROFILE_ROUNDS / 1e3:8.4f} ms/round {op['occurrences']:5d} "
                f"{op['category']:12s} {op['name'][:90]}")

        # ---- (c) the A/B ----
        cuda_steps = (2 + AB_REPS) * (1 + AB_FIT) * AB_STEPS * len(AB_SIZES)
        out = os.path.join(tmp, "ab.json")
        bce.reset_launch_counts()
        t_c = time.monotonic()
        if ab_bce.main([*AB_ARGS, "--out", out]) != 0:
            raise AssertionError("ab_bce.main failed")
        wall_c = time.monotonic() - t_c
        launched = bce.bce_sums.launches
        with open(out, encoding="utf-8") as f:
            ab = json.load(f)
        # The cuda arm launches one kernel a step; a launch from the plain
        # arm would push the count past its steps.
        if launched != cuda_steps:
            raise AssertionError(f"ab_bce: {launched} bce_sums launches, want the cuda arm's {cuda_steps} "
                                 "steps and none from the plain arm")
        for key, point in ab["points"].items():
            for impl in ab_bce.IMPLS:
                p = point["impls"][impl]
                if not (p["round_s_short"] > 0 and p["round_s_long"] > 0 and "per_step_ms" in p):
                    raise AssertionError(f"ab_bce {key} {impl}: {p}")

    # The arms' first step: the same logits and mask through each arm's
    # metrics (phase 6's tolerance, count lanes exact).
    img = AB_SIZES[0]
    config = ModelConfig(img_size=img, compute_dtype="bfloat16")
    imgs, msks = synth_crack_batch(AB_STEPS * 16, img, seed=0)
    state = create_train_state(torch.Generator().manual_seed(0), config, device=dev)
    x, y = as_model_batch(torch.from_numpy(imgs[:16]).to(dev), torch.from_numpy(msks[:16]).to(dev))
    state.model.train()
    with torch.no_grad():
        logits = state.model(x)
    sums = {"cuda": bce.bce_sums(logits, y), "plain": bce._bce_sums_plain(logits, y)}
    metrics = {impl: ab_bce.metrics_fn(impl, dev)(logits, y, pos_weight=1.0) for impl in ab_bce.IMPLS}
    torch.cuda.synchronize()
    if not torch.equal(sums["cuda"][1:4], sums["plain"][1:4]):
        raise AssertionError(f"ab_bce first step: count lanes {sums['cuda'].tolist()} vs {sums['plain'].tolist()}")
    err = (sums["cuda"] - sums["plain"]).abs()
    if not bool((err <= 1e-3 + 1e-5 * sums["plain"].abs()).all()):
        raise AssertionError(f"ab_bce first step: sums {sums['cuda'].tolist()} vs {sums['plain'].tolist()}")
    first = {impl: {k: float(v) for k, v in m.items()} for impl, m in metrics.items()}
    for k, v in first["plain"].items():
        if not abs(first["cuda"][k] - v) <= 1e-3 + 1e-5 * abs(v):
            raise AssertionError(f"ab_bce first step: {k} {first['cuda'][k]} vs plain {v}")
    summary = {key: {"per_step_ms": {i: point["impls"][i]["per_step_ms"] for i in ab_bce.IMPLS},
                     "mfu": {i: point["impls"][i]["mfu"] for i in ab_bce.IMPLS},
                     "speedup_first_over_second": point.get("speedup_first_over_second")}
               for key, point in ab["points"].items()}
    log(f"[ab_bce] {json.dumps(summary)}; {launched} bce_sums launches (the cuda arm's steps); first step "
        f"{json.dumps(first['cuda'])} against plain {json.dumps(first['plain'])}; {wall_c:.2f} s [{card}]")
    result = {"flops": counts, "peak_flops": peak, "profile": prof, "ab": ab, "first_step": first,
              "launches": {"profile_step": prof_launched, "ab_bce": launched}, "phase_s": time.monotonic() - t0}
    log(f"[phase24] {json.dumps({k: result[k] for k in ('flops', 'peak_flops', 'launches', 'phase_s')})} [{card}]")
    return result


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


def profile_steps(torch, step, card: str, flops: float, n: int = 3) -> None:
    """Where one train step's time goes: CUDA kernel time by name, the
    device's idle share of the host-clock window (torch.profiler), and the
    MFU of ``flops`` a step over the device busy time."""
    from fedcrack_tpu_torch.obs.flops import mfu
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile

    step()
    torch.cuda.synchronize()
    with card_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = card_kernels(prof)
    if not kernels:
        log("profile: the profiler saw no CUDA kernels; device time not measured")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile: {n} train steps in {wall_us / n / 1e3:.3f} ms each on the host clock, device busy "
        f"{busy_us / n / 1e3:.3f} ms each, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(e.count for e in kernels) // n} kernel launches per step, MFU {mfu(busy_us / n / 1e6, flops, 0):.5f} "
        f"of device busy [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile: {e.self_device_time_total / n / 1e3:8.4f} ms/step "
            f"{e.count // n:4d} calls/step  {e.key[:110]}")


# Phase 25: the benchmark cell's round shape (c3: 8 clients x 2 steps x
# batch 16 at 256 px), float32, two rounds a run.
GRAPH_CLIENTS, GRAPH_STEPS, GRAPH_ROUNDS, GRAPH_SIZE = 8, 2, 2, 256
GRAPH_SEED = 25
GRAPH_TIMED = 4  # rounds a side timed in turns, after the checked runs
GRAPH_LEFT_BYTES = 64 << 20  # what released rounds may leave allocated (library and bce_sums workspaces)


def _graph_counts() -> dict:
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    fam = REGISTRY.get("train_step_graph_total")
    return {p: (0.0 if fam is None else fam.labels(path=p).value) for p in ("eager", "capture", "replay")}


def _same_bits(torch, a, b) -> bool:
    a, b = a.detach().contiguous(), b.detach().contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def step_graph_phase(torch, card: str) -> dict:
    """Phase 25, the train step's CUDA graph in the slot plane, at the
    benchmark cell's round shape: from one start, the graphed round
    (``round_from_config``'s path) and the eager one (``forward`` set, the
    same arithmetic) over the same two rounds, bit for bit (each slot's
    weights and BatchNorm statistics, every step's Adam moments, the
    globals and metrics), ``bce_sums`` launches equal to the steps on
    both; a third graphed round under ``torch.cuda.set_sync_debug_mode``
    with no synchronizing call between ``round_fn``'s entry and its return
    (two synchronizing copies as the control); one graphed round profiled,
    a ``bce_sums_kernel`` record for every step; the round walls of both,
    in turns; once released, the rounds' memory freed, the graph's pool
    with it. Logged: the counter's paths, the walls, the peak memory."""
    import gc
    import warnings

    import numpy as np
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.obs.metrics import card_kernels, card_profile
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import make_mesh, stack_client_data
    from fedcrack_tpu_torch.parallel.driver import stage_round_data
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _build_round

    t_phase = time.monotonic()
    cfg = ModelConfig(img_size=GRAPH_SIZE)
    mesh = make_mesh(GRAPH_CLIENTS)
    device = mesh.device
    start = tree_map(lambda a: torch.as_tensor(a).to(device),
                     init_variables(torch.Generator().manual_seed(GRAPH_SEED), cfg))
    staged = []
    for r in range(GRAPH_ROUNDS + 1):
        per = [to_uint8_transport(*synth_crack_batch(GRAPH_STEPS * TRAIN_BATCH, img_size=GRAPH_SIZE,
                                                     seed=GRAPH_SEED * 1000 + 100 * r + c))
               for c in range(GRAPH_CLIENTS)]
        staged.append(stage_round_data(*stack_client_data(per, GRAPH_STEPS, TRAIN_BATCH), mesh))
    active = np.ones(GRAPH_CLIENTS, np.float32)
    n_samples = np.full(GRAPH_CLIENTS, float(GRAPH_STEPS * TRAIN_BATCH), np.float32)
    steps = GRAPH_CLIENTS * GRAPH_STEPS * GRAPH_ROUNDS
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    graph_fn = _build_round(mesh, cfg, 1e-3, 1, 0.0)
    eager_fn = _build_round(mesh, cfg, 1e-3, 1, 0.0, forward=lambda m, x: m(x))

    def run(round_fn) -> dict:
        moments, slots = [], []

        def keep(opt, args, kwargs):
            params = [p for g in opt.param_groups for p in g["params"]]
            moments.append(torch.cat([t.reshape(-1) for p in params
                                      for t in (opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])]))

        handle = register_optimizer_step_post_hook(keep)
        round_fn.slot_hook = lambda c, v: slots.append(tree_leaves(v))
        before, launches = _graph_counts(), bce.bce_sums.launches
        variables, metrics = start, []
        try:
            for r in range(GRAPH_ROUNDS):
                variables, m = round_fn(variables, *staged[r], active, n_samples)
                metrics.append(m)
            torch.cuda.synchronize()
        finally:
            handle.remove()
            round_fn.slot_hook = None
        after = _graph_counts()
        return {"variables": variables, "metrics": metrics, "moments": moments, "slots": slots,
                "launches": bce.bce_sums.launches - launches, "paths": {k: after[k] - before[k] for k in after}}

    graphed = run(graph_fn)
    eager = run(eager_fn)
    for name, launched in (("graphed", graphed["launches"]), ("eager", eager["launches"])):
        if launched != steps:
            raise AssertionError(f"[graph] the {name} rounds counted {launched} bce_sums launches, "
                                 f"not their {steps} steps")
    if graphed["paths"] != {"eager": 1.0, "capture": 1.0, "replay": float(steps - 2)}:
        raise AssertionError(f"[graph] the graphed rounds took the paths {graphed['paths']}")
    if eager["paths"] != {"eager": float(steps), "capture": 0.0, "replay": 0.0}:
        raise AssertionError(f"[graph] the eager rounds took the paths {eager['paths']}")
    if len(graphed["moments"]) != steps or len(eager["moments"]) != steps:
        raise AssertionError(f"[graph] {len(graphed['moments'])} / {len(eager['moments'])} Adam steps, not {steps}")
    pairs = [("global", a, b) for a, b in zip(tree_leaves(graphed["variables"]), tree_leaves(eager["variables"]))]
    pairs += [(f"slot {i} leaf {j}", a, b) for i, (sa, sb) in enumerate(zip(graphed["slots"], eager["slots"]))
              for j, (a, b) in enumerate(zip(sa, sb))]
    pairs += [(f"Adam moments, step {i}", a, b) for i, (a, b) in enumerate(zip(graphed["moments"], eager["moments"]))]
    pairs += [(f"round {r} {k}", graphed["metrics"][r][k], eager["metrics"][r][k])
              for r in range(GRAPH_ROUNDS) for k in eager["metrics"][r]]
    if len(graphed["slots"]) != GRAPH_CLIENTS * GRAPH_ROUNDS or len(graphed["slots"]) != len(eager["slots"]):
        raise AssertionError(f"[graph] {len(graphed['slots'])} / {len(eager['slots'])} slots kept")
    differ = [name for name, a, b in pairs if not _same_bits(torch, a, b)]
    n_pairs = len(pairs)
    del pairs
    if differ:
        raise AssertionError(f"[graph] the graphed rounds differ from the eager ones in {len(differ)} of "
                             f"{n_pairs} tensors, first {differ[:5]}")
    log(f"[graph] graphed against eager, 2 rounds x 8 slots x 2 steps at 256 px: {n_pairs} tensors bit-equal "
        f"(globals, {len(graphed['slots'])} slots' weights and statistics, {steps} steps' Adam moments, metrics); "
        f"bce_sums launches {graphed['launches']} / {eager['launches']}; paths graphed {graphed['paths']}, "
        f"eager {eager['paths']}")
    del eager
    launches_graphed, paths_graphed = graphed["launches"], graphed["paths"]

    def caught_syncs(fn) -> list:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return [str(w.message) for w in caught if "synchroniz" in str(w.message)]

    control = caught_syncs(lambda: (torch.as_tensor(np.float32(2.0)).to(device),
                                    torch.as_tensor(np.ones(GRAPH_CLIENTS, np.float32)).to(device)))
    if len(control) < 2:
        raise AssertionError(f"[graph] sync debug mode caught {len(control)} of 2 synchronizing copies")
    out_sync = {}
    before = _graph_counts()
    syncs = caught_syncs(lambda: out_sync.update(out=graph_fn(graphed["variables"], *staged[GRAPH_ROUNDS], active,
                                                              n_samples)))
    torch.cuda.synchronize()
    sync_paths = {k: v - before[k] for k, v in _graph_counts().items()}
    if syncs:
        raise AssertionError(f"[graph] {len(syncs)} synchronizing calls inside round_fn: {syncs[:3]}")
    log(f"[graph] a graphed round under set_sync_debug_mode('warn'): 0 synchronizing calls (the control's two "
        f"copies caught {len(control)}); paths {sync_paths}")

    profiled = None
    for _ in range(PROFILE_TRIES):
        launches = bce.bce_sums.launches
        with card_profile(cpu=False) as prof:
            graph_fn(graphed["variables"], *staged[0], active, n_samples)
        launched = bce.bce_sums.launches - launches
        kernels = card_kernels(prof)
        records = sum(e.count for e in kernels if "bce_sums_kernel" in e.key)
        if records == launched == GRAPH_CLIENTS * GRAPH_STEPS:
            profiled = {"bce_sums_records": records, "kernel_records": sum(e.count for e in kernels),
                        "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3}
            break
        log(f"[graph] profiled round kept {records} bce_sums_kernel records of {launched} launches; retaking it")
    if profiled is None:
        raise AssertionError("[graph] the profiler lost bce_sums_kernel records of a graphed round in every take")
    log(f"[graph] a graphed round profiled: {profiled['bce_sums_records']} bce_sums_kernel records for "
        f"{GRAPH_CLIENTS * GRAPH_STEPS} steps, {profiled['kernel_records'] / (GRAPH_CLIENTS * GRAPH_STEPS):.1f} "
        f"kernel records a step, device busy {profiled['busy_ms']:.2f} ms a round [{card}]")

    walls = {"graphed": [], "eager": []}
    order = ["graphed", "eager", "eager", "graphed"] * (GRAPH_TIMED // 2)
    for label in order:
        fn = graph_fn if label == "graphed" else eager_fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(graphed["variables"], *staged[1], active, n_samples)
        torch.cuda.synchronize()
        walls[label].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    # Released, the rounds free their slot states and with them the graph
    # and its memory pool.
    held_graphed = torch.cuda.memory_allocated()
    del graph_fn, eager_fn, fn, graphed, out_sync
    gc.collect()
    torch.cuda.synchronize()
    held_after = torch.cuda.memory_allocated()
    if held_after > held_before + GRAPH_LEFT_BYTES:
        raise AssertionError(f"[graph] {(held_after - held_before) / 1e6:.1f} MB still held once the rounds are "
                             f"released ({held_graphed / 1e9:.2f} GB before)")
    out = {"tensors_equal": n_pairs, "launches": launches_graphed, "paths": paths_graphed,
           "sync_calls": len(syncs), "sync_control": len(control), "profiled": profiled,
           "round_ms": walls, "round_ms_median": med,
           "images_per_s": {k: GRAPH_CLIENTS * GRAPH_STEPS * TRAIN_BATCH / (v / 1e3) for k, v in med.items()},
           "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_gb": {"graphed": held_graphed / 1e9, "released": held_after / 1e9, "before": held_before / 1e9},
           "phase_s": time.monotonic() - t_phase}
    log(f"[graph] round walls in turns (ms): graphed {[round(w, 1) for w in walls['graphed']]}, eager "
        f"{[round(w, 1) for w in walls['eager']]}; {json.dumps(out)} [{card}]")
    return out


# Phase 26: SegFormer-B5 at 1024 x 1024 on the slot plane.
SEG_CLIENTS, SEG_STEPS, SEG_BATCH, SEG_SIZE, SEG_SEED = 2, 2, 2, 1024, 26


def _attention_counts() -> dict:
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    fam = REGISTRY.get("train_attention_total")
    return {} if fam is None else {key: child.value for key, child in fam._series()}


def segformer_phase(torch, card: str) -> dict:
    """Phase 26, SegFormer-B5 trained on the slot plane at 1024 x 1024
    (module docstring): an eager round and two graphed rounds from one
    start, bit for bit; the attention counter and the ``bce_sums``
    launches on every step; walls and the peak memory logged."""
    import gc

    import numpy as np

    from fedcrack_tpu_torch.configs import SegFormerConfig
    from fedcrack_tpu_torch.data.pipeline import to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.pytree import tree_leaves, tree_map
    from fedcrack_tpu_torch.models.segformer import init_variables
    from fedcrack_tpu_torch.ops import bce
    from fedcrack_tpu_torch.parallel import make_mesh, stack_client_data
    from fedcrack_tpu_torch.parallel.driver import stage_round_data
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _build_round

    t_phase = time.monotonic()
    cfg = SegFormerConfig(img_size=SEG_SIZE)
    mesh = make_mesh(SEG_CLIENTS)
    device = mesh.device
    start = tree_map(lambda a: torch.as_tensor(a).to(device),
                     init_variables(torch.Generator().manual_seed(SEG_SEED), cfg))
    per = [to_uint8_transport(*synth_crack_batch(SEG_STEPS * SEG_BATCH, img_size=SEG_SIZE,
                                                 seed=SEG_SEED * 1000 + c)) for c in range(SEG_CLIENTS)]
    staged = stage_round_data(*stack_client_data(per, SEG_STEPS, SEG_BATCH), mesh)
    active = np.ones(SEG_CLIENTS, np.float32)
    n_samples = np.full(SEG_CLIENTS, float(SEG_STEPS * SEG_BATCH), np.float32)
    steps = SEG_CLIENTS * SEG_STEPS
    want_calls = {(str(i + 1), "composed"): float(steps * d) for i, d in enumerate(cfg.depths)}
    torch.cuda.reset_peak_memory_stats()

    def run(round_fn) -> dict:
        slots = []
        round_fn.slot_hook = lambda c, v: slots.append([t.cpu() for t in tree_leaves(v)])
        before, calls, launches = _graph_counts(), _attention_counts(), bce.bce_sums.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            variables, metrics = round_fn(start, *staged, active, n_samples)
            torch.cuda.synchronize()
        finally:
            round_fn.slot_hook = None
        wall = time.perf_counter() - t0
        after, calls_after = _graph_counts(), _attention_counts()
        return {"globals": [t.cpu() for t in tree_leaves(variables)],
                "metrics": {k: v.cpu() for k, v in metrics.items()}, "slots": slots, "wall_s": wall,
                "launches": bce.bce_sums.launches - launches,
                "paths": {k: after[k] - before[k] for k in after},
                "calls": {k: v - calls.get(k, 0.0) for k, v in calls_after.items() if v - calls.get(k, 0.0)}}

    eager_fn = _build_round(mesh, cfg, 6e-5, 1, 0.0, forward=lambda m, x: m(x))
    eager = run(eager_fn)
    del eager_fn
    gc.collect()
    torch.cuda.empty_cache()
    graph_fn = _build_round(mesh, cfg, 6e-5, 1, 0.0)
    first = run(graph_fn)
    second = run(graph_fn)
    runs = {"eager": eager, "graphed": first, "replayed": second}
    for name, r in runs.items():
        if r["launches"] != steps:
            raise AssertionError(f"[segformer] the {name} round counted {r['launches']} bce_sums launches, "
                                 f"not {steps}")
        if r["calls"] != want_calls:
            raise AssertionError(f"[segformer] the {name} round counted attention calls {r['calls']}, "
                                 f"not {want_calls}")
    if eager["paths"] != {"eager": float(steps), "capture": 0.0, "replay": 0.0}:
        raise AssertionError(f"[segformer] the eager round took the paths {eager['paths']}")
    if first["paths"] != {"eager": 1.0, "capture": 1.0, "replay": float(steps - 2)}:
        raise AssertionError(f"[segformer] the graphed round took the paths {first['paths']}")
    if second["paths"] != {"eager": 0.0, "capture": 0.0, "replay": float(steps)}:
        raise AssertionError(f"[segformer] the replayed round took the paths {second['paths']}")
    n_tensors = 0
    for name in ("graphed", "replayed"):
        other = runs[name]
        pairs = [("global", a, b) for a, b in zip(eager["globals"], other["globals"])]
        pairs += [(f"slot {i} leaf {j}", a, b) for i, (sa, sb) in enumerate(zip(eager["slots"], other["slots"]))
                  for j, (a, b) in enumerate(zip(sa, sb))]
        pairs += [(f"metric {k}", eager["metrics"][k], other["metrics"][k]) for k in eager["metrics"]]
        if len(other["slots"]) != SEG_CLIENTS or len(eager["slots"]) != SEG_CLIENTS:
            raise AssertionError(f"[segformer] {len(eager['slots'])} / {len(other['slots'])} slots kept")
        differ = [label for label, a, b in pairs if not _same_bits(torch, a, b)]
        if differ:
            raise AssertionError(f"[segformer] the {name} round differs from the eager one in {len(differ)} of "
                                 f"{len(pairs)} tensors, first {differ[:5]}")
        n_tensors = len(pairs)
    loss = [float(v) for v in eager["metrics"]["loss"]]
    if not all(np.isfinite(loss)):
        raise AssertionError(f"[segformer] non-finite client losses {loss}")
    out = {"tensors_equal": n_tensors, "steps": steps, "losses": loss,
           "paths": {k: r["paths"] for k, r in runs.items()},
           "attention_calls": {"/".join(k): v for k, v in first["calls"].items()},
           "round_s": {k: r["wall_s"] for k, r in runs.items()},
           "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "phase_s": time.monotonic() - t_phase}
    del graph_fn, runs, eager, first, second
    gc.collect()
    log(f"[segformer] B5 at {SEG_SIZE} px, {SEG_CLIENTS} slots x {SEG_STEPS} steps x batch {SEG_BATCH}: eager, "
        f"graphed and replayed rounds bit-equal in {out['tensors_equal']} tensors each; {json.dumps(out)} [{card}]")
    return out


def step_graph_only(phase: str = "step_graph") -> int:
    """Phases 1, 2 (``bce_sums.cu`` alone) and 25 (``step_graph``) or 26
    (``segformer``), in one process."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only", file=sys.stderr)
        return 2
    for m in REFERENCE_STACK:
        if m not in PORT_NEEDS:
            sys.modules.setdefault(m, None)
    from fedcrack_tpu_torch.kernels import build
    from fedcrack_tpu_torch.ops import bce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"card: {card}")
    build.build_all([bce.LIBRARY])
    if phase == "segformer":
        out = segformer_phase(torch, card)
        log("phase 26 SegFormer-B5 on the slot plane at 1024 px: ok")
    else:
        out = step_graph_phase(torch, card)
        log("phase 25 the train step's CUDA graph in the slot plane: ok")
    print(json.dumps({phase: out}), flush=True)
    print(card, flush=True)
    return 0


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
    from fedcrack_tpu_torch.kernels import build, dequant
    from fedcrack_tpu_torch.obs.metrics import lead_kept
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
    libs = build.build_all([*dequant.LIBRARIES, bce.LIBRARY])
    log(f"phase 2 build: {time.monotonic() - t0:.2f} s "
        f"({', '.join(os.path.relpath(lib, HERE) for lib in libs)})")
    for lib in libs:
        with open(f"{lib}.log", encoding="utf-8") as f:
            log(f.read())
    for lib, kernel in zip(libs, ("dequant_matmul_kernel", "dequant_conv3x3_kernel", "dequant_dwconv3x3_kernel")):
        with open(f"{lib}.log", encoding="utf-8") as f:
            for line in ptxas_lines(f.read(), kernel):
                log(f"ptxas {line}")

    log(f"profiler: {lead_kept()} at {time.monotonic() - t_start:.1f} s [{card}]")
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
    cli = cli_phase(torch, card, train, grpc_run)
    log("phase 13 the command lines at full width, one process per client, and the centralized trainer: ok")
    serve_cli = serve_cli_phase(torch, card)
    log("phase 14 the serve command line at full width: Predict, StreamPredict, hot swap and autoscaler: ok")
    shadow = shadow_cli_phase(torch, card)
    log("phase 15 progressive delivery under load_gen: a promote, a rollback and quantify --pred-dir: ok")
    privacy = privacy_ckpt_phase(torch, card)
    log("phase 16 the privacy plane (DP, secagg with a dropout) and a checkpoint resume served quantized: ok")
    watched = chaos_bf16_watch_phase(torch, card)
    log("phase 17 the chaos plane, bf16 training and serving, and the watch layer: ok")
    tree = tree_drill_phase(torch, card)
    log("phase 18 the aggregation tree (in process, over gRPC with a killed edge, served) and the chaos drills: ok")
    slot_plane = slots_phase(torch, card)
    log("phase 19 several clients per round on one card (staging, segmented, resident, cohort, codecs, DP under "
        "chaos), served, and the refscale command: ok")
    spatial = spatial_phase(torch, card)
    log("phase 20 a client's step split into shards with sync-BN: spatial predict and step on tall images, the "
        "spatial round served, c5's batch axis, and the measure_baseline command: ok")
    multihost = multihost_phase(torch, card, slot_plane, spatial)
    log("phase 21 two processes sharing the card over gloo: the round's clients and the spatial step's bands split "
        "across them, the global served, the cohort round's groups split across them: ok")
    c6 = c6_phase(torch, card)
    log("phase 22 configs/c6_s2d_layout.json on the card: the s2d and packed layouts through the slot plane three "
        "ways, against the reference layouts, served, the fused planes' refusal, s2d_full, the h5 bridge: ok")
    soak = soak_lint_phase(torch, card)
    log("phase 23 the concurrent soak at the JAX soak's shape and at full width, the soak command, and fedlint over "
        "the port: ok")
    flops_ab = flops_profile_ab_phase(torch, card)
    log("phase 24 the FLOPs model and the card's peak, a profiled round at 256 px bf16 (tools.profile_step) and the "
        "bce_sums A/B inside the train step (tools.ab_bce): ok")
    step_graph = step_graph_phase(torch, card)
    log("phase 25 the train step's CUDA graph in the slot plane: ok")
    segformer_phase(torch, card)
    log("phase 26 SegFormer-B5 on the slot plane at 1024 px: ok")

    kernels = []
    replaces = {"dequant_matmul": "fedcrack_tpu/kernels/dequant.py:88",
                "dequant_conv3x3": ("fedcrack_tpu/kernels/dequant.py:88 "
                                    "(with fedcrack_tpu/kernels/forward.py:76, the JAX _conv3x3)"),
                "dequant_dwconv3x3": ("fedcrack_tpu/kernels/dequant.py:175 (its _dequant_kernel, in the prologue; "
                                      "with fedcrack_tpu/kernels/forward.py:88, the JAX _sepconv's depthwise conv)"),
                "dequant_codes": "fedcrack_tpu/kernels/dequant.py:175"}
    sources = {"dequant_conv3x3": "dequant_conv.cu", "dequant_dwconv3x3": "dequant_dw.cu"}
    for flavor, served in (("int8", int8), ("e4m3", fp8)):
        for name in DEQUANT_KERNELS:
            row = rows[f"{name}[{flavor}]"]
            kernels.append({
                "name": f"{name}[{flavor}]",
                "route": "cuda",
                "source": "fedcrack_tpu_torch/kernels/csrc/" + sources.get(name, "dequant.cu"),
                "replaces": replaces[name],
                "launches": served["launches"][name],
                **({"launches_phase12": swap["served_launches"][name],
                    "launches_phase14": serve_cli["launches"][name],
                    "launches_phase15": shadow["launches"][name],
                    "launches_phase16": privacy["served_launches"][name],
                    "launches_phase17": watched["served_launches"][name],
                    "launches_phase18": tree["served_launches"][name],
                    "launches_phase19": slot_plane["served_launches"][name],
                    "launches_phase20": spatial["served_launches"][name],
                    "launches_phase21": multihost["served_launches"][name],
                    "launches_phase23": soak["launches"][name]} if flavor == "int8" else {}),
                # dequant_codes left the forward's path: its work runs in
                # dequant_dwconv3x3's prologue; phase 3 launches it alone.
                **({"on_main_path": False} if name == "dequant_codes" else {}),
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "event_ms": row["event_ms"],
                "library_event_ms": row["library_event_ms"],
                **({"library_relu_ms": row["library_relu_ms"]} if name == "dequant_dwconv3x3" else {}),
                **({"launch_floor_us": bce_row["launch_floor_us"]} if name == "dequant_codes" else {}),
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
        "launches_phase13": cli["launches"],
        "launches_phase16": privacy["launches"],
        "launches_phase17": watched["launches"],
        "launches_phase18": tree["launches"],
        "launches_phase19": slot_plane["launches"],
        "launches_phase20": spatial["launches"],
        "launches_phase21": multihost["launches"],
        "launches_phase21_cohort": multihost["cohort_launches"],
        "launches_phase22": c6["launches"],
        "launches_phase23": soak["launches"]["bce_sums"],
        "launches_phase24": flops_ab["launches"]["ab_bce"],
        "launches_phase24_profile": flops_ab["launches"]["profile_step"],
        "launches_phase25": step_graph["launches"],
        **bce_row,
    })
    log(f"profiler: {lead_kept()} at {time.monotonic() - t_start:.1f} s [{card}]")
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serve_tick_sweep(ticks: list) -> int:
    """Phase 14 alone, once per autoscaler tick in ``ticks``, in one
    process and on one card, so the ticks compare within one call."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only", file=sys.stderr)
        return 2
    for m in REFERENCE_STACK:
        if m not in PORT_NEEDS:
            sys.modules.setdefault(m, None)
    from fedcrack_tpu_torch.kernels import build, dequant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build.build_all(list(dequant.LIBRARIES))
    for tick in ticks:
        t0 = time.monotonic()
        out = serve_cli_phase(torch, card, scale_interval_s=tick)
        print("TICK " + json.dumps({
            "scale_interval_s": tick, "phase_s": time.monotonic() - t0,
            "in_process": [(f["tiles_computed"], f["ms"]) for f in out["in_process_frames"]],
            "served": [(f["frame"], f["version"], f["tiles_computed"], f["server_ms"], f["client_ms"])
                       for f in out["stream_frames"]],
            "autoscaler": out["autoscaler"], "latency_ms": out["latency_ms"]}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"] and len(sys.argv) == 5:
        sys.exit(multihost_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-ticks"] and len(sys.argv) == 3:
        sys.exit(serve_tick_sweep([float(t) for t in sys.argv[2].split(",")]))
    if sys.argv[1:] == ["--step-graph"]:
        sys.exit(step_graph_only())
    if sys.argv[1:] == ["--segformer"]:
        sys.exit(step_graph_only("segformer"))
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--serve-ticks T1,T2,... | --step-graph | --segformer]")
    sys.exit(main())
