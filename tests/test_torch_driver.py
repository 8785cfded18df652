"""The port's slot driver (``fedcrack_tpu_torch.parallel.driver``), its
data plane (``SamplePool``, ``split_epoch_slab``, ``shuffled_epoch_data``),
``MeshChaos`` and ``tools.refscale_federation`` on the CPU.

Each test mirrors a JAX driver test (``tests/test_driver.py``,
``tests/test_segmented.py``, ``tests/test_resident.py``,
``tests/test_cohort.py``, ``tests/test_chaos.py``): overlapped staging,
segment streaming, round overlap, resident plans, the HBM guard's fallback,
chaos replay and checkpoint resume each equal the plain run bit for bit.
The JAX mesh programs fail on the installed JAX, so the JAX side of these
tests is its host data plane: the sample plans, slabs and shuffles, held
byte-equal.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny steps: one intra-op thread each keeps a
    worker of a parallel test run from contending with the others for
    every core (the results are compared at the same setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TINY_KW = dict(img_size=16, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
STEPS, BATCH, N_CLIENTS, ROUNDS = 2, 4, 2, 3


def _cfg():
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**TINY_KW)


def _mesh(c=N_CLIENTS):
    from fedcrack_tpu_torch.parallel import make_mesh

    return make_mesh(c, 1, device="cpu")


def _init_vars():
    from fedcrack_tpu_torch.models.resunet import init_variables

    return init_variables(torch.Generator().manual_seed(0), _cfg())


def _fresh_data_fn(seed0=0, n_clients=N_CLIENTS):
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import stack_client_data

    def data_fn(r):
        per = [synth_crack_batch(STEPS * BATCH, img_size=16, seed=seed0 + 10 * r + i) for i in range(n_clients)]
        images, masks = stack_client_data(per, STEPS, BATCH)
        return images, masks, np.ones(n_clients, np.float32), np.full(n_clients, float(STEPS * BATCH), np.float32)

    return data_fn


def _leaves(tree):
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in tree_leaves(tree)]


def _assert_trees_equal(got, want):
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.tobytes() == w.tobytes()


def _assert_records_equal(rec_a, rec_b):
    for ra, rb in zip(rec_a, rec_b):
        for k in ra.metrics:
            assert ra.metrics[k].tobytes() == rb.metrics[k].tobytes(), k


@pytest.fixture(scope="module")
def round_fn():
    from fedcrack_tpu_torch.parallel import build_federated_round

    return build_federated_round(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=1)


# ---- tests/test_driver.py ----


def test_overlap_matches_sequential(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    v_o, rec_o = run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), ROUNDS, _mesh(), overlap_staging=True)
    v_s, rec_s = run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), ROUNDS, _mesh(), overlap_staging=False)
    _assert_trees_equal(v_o, v_s)
    _assert_records_equal(rec_o, rec_s)
    assert [r.overlapped for r in rec_o] == [True, True, False]
    assert all(not r.overlapped for r in rec_s)
    assert rec_o[0].staging_s > 0.0
    assert all(r.staging_s == 0.0 for r in rec_o[1:])
    assert all(r.staging_s > 0.0 for r in rec_s)


def test_none_data_reuses_buffers(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    fixed = _fresh_data_fn()(0)
    v_reuse, rec_reuse = run_mesh_federation(round_fn, _init_vars(), lambda r: fixed if r == 0 else None, ROUNDS,
                                             _mesh())
    v_reship, _ = run_mesh_federation(round_fn, _init_vars(), lambda r: fixed, ROUNDS, _mesh())
    _assert_trees_equal(v_reuse, v_reship)
    assert rec_reuse[0].staged_bytes > 0
    assert all(r.staged_bytes == 0 for r in rec_reuse[1:])
    assert all(not r.overlapped for r in rec_reuse)


def test_on_round_hook_sees_every_round(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    seen = []
    final, records = run_mesh_federation(
        round_fn, _init_vars(), _fresh_data_fn(), ROUNDS, _mesh(),
        on_round=lambda rec, v: seen.append((rec.round_idx, float(rec.metrics["loss"][0]), v)))
    assert [s[0] for s in seen] == list(range(ROUNDS)) and len(records) == ROUNDS
    assert all(np.isfinite(s[1]) for s in seen)
    _assert_trees_equal(seen[-1][2], final)
    assert any(a.tobytes() != b.tobytes() for a, b in zip(_leaves(seen[0][2]), _leaves(seen[1][2])))


def test_cohort_change_between_rounds(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    base = _fresh_data_fn()

    def data_fn(r):
        images, masks, active, ns = base(r)
        if r >= 1:
            active = active.copy()
            active[1] = 0.0
        return images, masks, active, ns

    v, records = run_mesh_federation(round_fn, _init_vars(), data_fn, 2, _mesh())
    assert list(records[1].metrics["active"]) == [1.0, 0.0]
    assert all(np.isfinite(x).all() for x in _leaves(v))


def test_first_round_data_required_and_sentry_refused(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    with pytest.raises(ValueError, match="first round has no data"):
        run_mesh_federation(round_fn, _init_vars(), lambda r: None, 1, _mesh())
    with pytest.raises(ValueError, match="n_rounds"):
        run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 0, _mesh())
    with pytest.raises(ValueError, match="recompile"):
        run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 1, _mesh(), recompile_sentry=object())


def test_shuffled_epoch_data_byte_equal_to_jax():
    from fedcrack_tpu.parallel import shuffled_epoch_data as jax_shuffle
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import shuffled_epoch_data

    pool_i, pool_m = synth_crack_batch(10, img_size=16, seed=0)
    rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        got = shuffled_epoch_data(pool_i, pool_m, 2, 4, rng_a)
        want = jax_shuffle(pool_i, pool_m, 2, 4, rng_b)
        assert got[0].shape == (1, 2, 4, 16, 16, 3) and got[1].shape == (1, 2, 4, 16, 16, 1)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    with pytest.raises(ValueError, match="pool has"):
        shuffled_epoch_data(pool_i, pool_m, 4, 4, rng_a)


# ---- tests/test_segmented.py:182-326 ----


@pytest.fixture(scope="module")
def seg_round():
    from fedcrack_tpu_torch.parallel import build_federated_round_segments

    return build_federated_round_segments(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=2, segments=2)


@pytest.fixture(scope="module")
def mono2():
    from fedcrack_tpu_torch.parallel import build_federated_round, run_mesh_federation

    mono = build_federated_round(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=2)
    return run_mesh_federation(mono, _init_vars(), _fresh_data_fn(100), 3, _mesh())


def test_driver_segmented_streaming_matches_monolithic(seg_round, mono2):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    v_stream, rec = run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(100), 3, _mesh())
    _assert_trees_equal(v_stream, mono2[0])
    _assert_records_equal(rec, mono2[1])
    for r in rec:
        assert len(r.segments) >= 2
        assert all("dispatch_s" in e for e in r.segments if e["segment"] != "drain")
    assert sum(e.get("staged_bytes", 0) for e in rec[0].segments) == rec[1].staged_bytes > 0
    slab = rec[0].staged_bytes
    assert all(0 < r.max_live_staged_bytes <= 2 * slab for r in rec)
    assert rec[0].max_live_staged_bytes == 2 * slab


@pytest.mark.parametrize("mode", ["sequential", "round_grain"])
def test_driver_segmented_staging_modes(seg_round, mono2, mode):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    kw = {"overlap_staging": False} if mode == "sequential" else {"segment_overlap": False}
    v, rec = run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(100), 3, _mesh(), **kw)
    _assert_trees_equal(v, mono2[0])
    if mode == "sequential":
        assert all(r.staging_s > 0.0 for r in rec)


def test_driver_round_overlap_bit_identical(seg_round):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    def reuse():
        fresh = _fresh_data_fn(100)
        return lambda r: None if r == 2 else fresh(r)

    v_plain, rec_plain = run_mesh_federation(seg_round, _init_vars(), reuse(), 3, _mesh())
    v_pipe, rec_pipe = run_mesh_federation(seg_round, _init_vars(), reuse(), 3, _mesh(), round_overlap=True)
    _assert_trees_equal(v_pipe, v_plain)
    _assert_records_equal(rec_pipe, rec_plain)
    assert [e["segment"] for e in rec_pipe[1].segments if e.get("pipelined")] == [0]
    assert [e["segment"] for e in rec_pipe[2].segments if e.get("pipelined")] == [0]
    assert not any(e.get("pipelined") for e in rec_pipe[0].segments)


def test_round_overlap_contract_errors(round_fn, seg_round):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    with pytest.raises(ValueError, match="SegmentedRound"):
        run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 2, _mesh(), round_overlap=True)
    with pytest.raises(ValueError, match="overlap_staging"):
        run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(), 2, _mesh(), round_overlap=True,
                            overlap_staging=False)
    with pytest.raises(ValueError, match="max_round_retries"):
        run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(), 2, _mesh(), round_overlap=True,
                            max_round_retries=1)


def test_driver_checkpoint_kill_and_resume(tmp_path, seg_round):
    from fedcrack_tpu_torch.ckpt.manager import FedCheckpointer
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    v_straight, rec_straight = run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(100), 3, _mesh())
    run_mesh_federation(seg_round, _init_vars(), _fresh_data_fn(100), 2, _mesh(),
                        checkpointer=FedCheckpointer(tmp_path / "ck"))
    ck = FedCheckpointer(tmp_path / "ck")
    ckpt = ck.restore()
    assert ckpt is not None and ckpt.current_round == 2 and len(ckpt.history) == 2
    v_resumed, rec_resumed = run_mesh_federation(seg_round, ckpt.variables, _fresh_data_fn(100), 3, _mesh(),
                                                 checkpointer=ck, start_round=ckpt.current_round,
                                                 history=ckpt.history)
    _assert_trees_equal(v_resumed, v_straight)
    assert [r.round_idx for r in rec_resumed] == [2]
    _assert_records_equal(rec_resumed, rec_straight[2:])
    final = ck.restore()
    assert final.current_round == 3 and [h["round"] for h in final.history] == [1, 2, 3]


# ---- tests/test_resident.py:139-290 ----

R_EPOCHS, R_ROUNDS = 4, 2
POOL_N = STEPS * BATCH + 3
ACTIVE = np.ones(N_CLIENTS, np.float32)
N_SAMP = np.full(N_CLIENTS, float(STEPS * BATCH), np.float32)


@pytest.fixture(scope="module")
def pool():
    from fedcrack_tpu_torch.data.pipeline import SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    return SamplePool.stack([to_uint8_transport(*synth_crack_batch(POOL_N, 16, seed=c)) for c in range(N_CLIENTS)])


def _idx_data_fn(pool):
    rngs = [np.random.default_rng(7 + c) for c in range(N_CLIENTS)]
    return lambda r: (pool.round_indices(rngs, R_EPOCHS, STEPS, BATCH), ACTIVE, N_SAMP)


def _slab_data_fn(pool):
    rngs = [np.random.default_rng(7 + c) for c in range(N_CLIENTS)]

    def data_fn(r):
        images, masks = pool.assemble_round_slab(pool.round_indices(rngs, R_EPOCHS, STEPS, BATCH))
        return images, masks, ACTIVE, N_SAMP

    return data_fn


@pytest.fixture(scope="module")
def streamed_round():
    from fedcrack_tpu_torch.parallel import build_federated_round

    return build_federated_round(_mesh(), _cfg(), local_epochs=R_EPOCHS)


@pytest.fixture(scope="module")
def resident_round():
    from fedcrack_tpu_torch.parallel import build_federated_round

    return build_federated_round(_mesh(), _cfg(), local_epochs=R_EPOCHS, data_placement="resident")


@pytest.fixture(scope="module")
def streamed_result(pool, streamed_round):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    return run_mesh_federation(streamed_round, _init_vars(), _slab_data_fn(pool), R_ROUNDS, _mesh())


@pytest.fixture(scope="module")
def resident_result(pool, resident_round):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    return run_mesh_federation(resident_round, _init_vars(), _idx_data_fn(pool), R_ROUNDS, _mesh(),
                               data_placement="resident", sample_pool=pool)


def test_resident_trajectory_bit_identical(streamed_result, resident_result):
    _assert_trees_equal(resident_result[0], streamed_result[0])
    _assert_records_equal(resident_result[1], streamed_result[1])


def test_resident_staged_bytes_are_indices_only(pool, streamed_result, resident_result):
    rec_s, rec_r = streamed_result[1], resident_result[1]
    assert rec_s[0].staged_bytes > 0
    assert all(r.data_placement == "resident" for r in rec_r)
    assert all(r.data_placement == "streamed" for r in rec_s)
    idx_bytes = rec_r[1].staged_bytes
    assert idx_bytes == N_CLIENTS * R_EPOCHS * STEPS * BATCH * 4
    assert rec_r[0].staged_bytes == pool.nbytes + idx_bytes
    assert all(r.staged_bytes == idx_bytes for r in rec_r[1:])
    assert idx_bytes * (16 ** 2 * 4) == rec_s[0].staged_bytes * (4 * R_EPOCHS)
    for r in rec_r:
        assert pool.nbytes <= r.max_live_staged_bytes <= pool.nbytes + 2 * idx_bytes


def test_resident_segmented_trajectory_bit_identical(pool, streamed_result):
    from fedcrack_tpu_torch.parallel import build_federated_round_segments, run_mesh_federation

    seg = build_federated_round_segments(_mesh(), _cfg(), local_epochs=R_EPOCHS, segments=R_EPOCHS,
                                         data_placement="resident")
    v, rec = run_mesh_federation(seg, _init_vars(), _idx_data_fn(pool), R_ROUNDS, _mesh(),
                                 data_placement="resident", sample_pool=pool)
    _assert_trees_equal(v, streamed_result[0])
    _assert_records_equal(rec, streamed_result[1])
    assert all(len(r.segments) == R_EPOCHS for r in rec)
    assert all(r.staged_bytes == N_CLIENTS * R_EPOCHS * STEPS * BATCH * 4 for r in rec[1:])


def test_resident_chaos_replay_bit_identical(pool, resident_round, resident_result):
    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    plan = FaultPlan([Fault(MESH_DEVICE_FAIL, round=1)])
    v, records = run_mesh_federation(resident_round, _init_vars(), _idx_data_fn(pool), R_ROUNDS, _mesh(),
                                     data_placement="resident", sample_pool=pool, max_round_retries=1,
                                     fault_injector=MeshChaos(plan))
    _assert_trees_equal(v, resident_result[0])
    assert records[1].retries == 1 and "InjectedDeviceFailure" in records[1].faults[0]
    assert not plan.pending
    assert records[1].staging_s > 0.0


def test_resident_hbm_guard_falls_back_to_streamed(pool, streamed_round, resident_round, streamed_result):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    v, rec = run_mesh_federation(resident_round, _init_vars(), _idx_data_fn(pool), R_ROUNDS, _mesh(),
                                 data_placement="resident", sample_pool=pool, streamed_round_fn=streamed_round,
                                 resident_limit_bytes=16)
    _assert_trees_equal(v, streamed_result[0])
    assert all(r.data_placement == "streamed" for r in rec)
    assert rec[0].staged_bytes > pool.nbytes // 2
    with pytest.raises(RuntimeError, match="does not fit"):
        run_mesh_federation(resident_round, _init_vars(), _idx_data_fn(pool), 1, _mesh(),
                            data_placement="resident", sample_pool=pool, resident_limit_bytes=16)
    with pytest.raises(ValueError, match="resident"):
        run_mesh_federation(resident_round, _init_vars(), _idx_data_fn(pool), 1, _mesh())


def test_resident_pool_fits_guard():
    """The JAX guard charges each chip its clients' share; on one card every
    slot's pool is on that card, so the whole pool is charged to it."""
    from fedcrack_tpu_torch.parallel import resident_pool_fits

    fits, info = resident_pool_fits(1024, _mesh(), limit_bytes=10_000)
    assert fits and info["reason"] == "fits"
    fits, info = resident_pool_fits(1024 * N_CLIENTS, _mesh(), limit_bytes=1024)
    assert not fits and "exceeds" in info["reason"] and info["per_device_bytes"] == 1024 * N_CLIENTS
    os.environ["FEDCRACK_RESIDENT_HBM_LIMIT_BYTES"] = "64"
    try:
        fits, info = resident_pool_fits(10_000, _mesh())
        assert not fits and info["limit_bytes"] == 64
    finally:
        del os.environ["FEDCRACK_RESIDENT_HBM_LIMIT_BYTES"]
    fits, info = resident_pool_fits(10 ** 15, _mesh())
    assert fits and info["limit_bytes"] is None


# ---- tests/test_cohort.py:142-276 ----


@pytest.fixture(scope="module")
def cohort_setup():
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round, build_federated_round

    data = _fresh_data_fn(0, n_clients=4)(0)
    data = data[:3] + (np.array([8.0, 16.0, 8.0, 24.0], np.float32),)
    oracle = build_federated_round(_mesh(4), _cfg(), local_epochs=2)(_init_vars(), *data)
    cr = build_federated_cohort_round(_mesh(2), _cfg(), local_epochs=2, segments=2)
    return data, oracle, cr


def test_cohort_driver_per_group_staging(cohort_setup):
    from fedcrack_tpu_torch.parallel import run_cohort_federation

    data, (want_v, want_m), cr = cohort_setup
    v, records = run_cohort_federation(cr, _init_vars(), lambda r: data, 1, _mesh(2))
    _assert_trees_equal(v, want_v)
    for k in records[0].metrics:
        assert records[0].metrics[k].tobytes() == want_m[k].numpy().tobytes(), k
    rec = records[0]
    assert len(rec.segments) == 2 and all(e["staged_bytes"] > 0 for e in rec.segments)
    group_bytes = rec.segments[0]["staged_bytes"]
    assert rec.staged_bytes == sum(e["staged_bytes"] for e in rec.segments)
    assert rec.max_live_staged_bytes == 2 * group_bytes


def test_cohort_driver_round_overlap_bit_identical(cohort_setup):
    from fedcrack_tpu_torch.parallel import run_cohort_federation

    data, _, cr = cohort_setup
    v_plain, rec_plain = run_cohort_federation(cr, _init_vars(), lambda r: data, 2, _mesh(2))
    v_pipe, rec_pipe = run_cohort_federation(cr, _init_vars(), lambda r: data, 2, _mesh(2), round_overlap=True)
    _assert_trees_equal(v_pipe, v_plain)
    _assert_records_equal(rec_pipe, rec_plain)
    assert [e["group"] for e in rec_pipe[1].segments if e.get("pipelined")] == [0]
    assert not any(e.get("pipelined") for e in rec_pipe[0].segments)
    assert rec_pipe[1].staged_bytes == rec_plain[1].staged_bytes


def test_cohort_driver_resident_and_contract_mismatches(cohort_setup):
    from fedcrack_tpu_torch.data.pipeline import SamplePool
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round, run_cohort_federation

    (images, masks, active, ns), (want_v, _), cr = cohort_setup
    pool = SamplePool(images.reshape(4, STEPS * BATCH, *images.shape[3:]),
                      masks.reshape(4, STEPS * BATCH, *masks.shape[3:]))
    idx = np.broadcast_to(np.arange(STEPS * BATCH, dtype=np.int32).reshape(1, 1, STEPS, BATCH), (4, 2, STEPS, BATCH))
    resident = build_federated_cohort_round(_mesh(2), _cfg(), local_epochs=2, segments=2, data_placement="resident")
    v, records = run_cohort_federation(resident, _init_vars(), lambda r: (idx, active, ns), 1, _mesh(2),
                                       sample_pool=pool)
    _assert_trees_equal(v, want_v)
    assert records[0].data_placement == "resident" and all(e["staged_bytes"] > 0 for e in records[0].segments)
    with pytest.raises(ValueError, match="streamed"):
        run_cohort_federation(cr, _init_vars(), lambda r: None, 1, _mesh(2), sample_pool=pool)
    with pytest.raises(ValueError, match="positive"):
        run_cohort_federation(cr, _init_vars(), lambda r: None, 0, _mesh(2))


# ---- tests/test_chaos.py:698-778 ----


@pytest.fixture(scope="module")
def clean_two_rounds(round_fn):
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    return run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 2, _mesh())[0]


def test_mesh_kill_and_replay_bit_identical(round_fn, clean_two_rounds):
    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, MESH_NONFINITE, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    plan = FaultPlan([Fault(MESH_DEVICE_FAIL, round=0), Fault(MESH_NONFINITE, round=1)])
    v, records = run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 2, _mesh(), max_round_retries=2,
                                     fault_injector=MeshChaos(plan))
    _assert_trees_equal(v, clean_two_rounds)
    assert [r.retries for r in records] == [1, 1]
    assert "InjectedDeviceFailure" in records[0].faults[0]
    assert "NonFiniteRound" in records[1].faults[0]
    assert not plan.pending


def test_mesh_checkpointer_backed_replay(tmp_path, round_fn, clean_two_rounds):
    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.ckpt.manager import FedCheckpointer
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    ck = FedCheckpointer(tmp_path / "ckpt")
    v, records = run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 2, _mesh(), checkpointer=ck,
                                     max_round_retries=1, fault_injector=MeshChaos(FaultPlan([
                                         Fault(MESH_DEVICE_FAIL, round=1)])))
    assert ck.latest_version() == 2
    _assert_trees_equal(v, clean_two_rounds)
    assert records[1].retries == 1


def test_mesh_retries_exhausted_aborts_cleanly(round_fn):
    from fedcrack_tpu_torch.chaos import MESH_DEVICE_FAIL, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.inject import InjectedDeviceFailure
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.parallel import run_mesh_federation

    plan = FaultPlan([Fault(MESH_DEVICE_FAIL, round=0), Fault(MESH_DEVICE_FAIL, round=0)])
    with pytest.raises(InjectedDeviceFailure):
        run_mesh_federation(round_fn, _init_vars(), _fresh_data_fn(), 1, _mesh(), max_round_retries=1,
                            fault_injector=MeshChaos(plan))


def test_codec_state_replay_restores_the_int8_seed():
    """A replayed int8 round draws the same stochastic rounding as an
    unfaulted one: the driver restores ``codec_state`` with the weights."""
    from fedcrack_tpu_torch.chaos import MESH_NONFINITE, FaultPlan, MeshChaos
    from fedcrack_tpu_torch.chaos.plan import Fault
    from fedcrack_tpu_torch.parallel import build_federated_round, run_mesh_federation

    def build():
        return build_federated_round(_mesh(), _cfg(), update_codec="int8")

    v_clean, _ = run_mesh_federation(build(), _init_vars(), _fresh_data_fn(), 2, _mesh())
    rf = build()
    v, records = run_mesh_federation(rf, _init_vars(), _fresh_data_fn(), 2, _mesh(), max_round_retries=1,
                                     fault_injector=MeshChaos(FaultPlan([Fault(MESH_NONFINITE, round=0)])))
    _assert_trees_equal(v, v_clean)
    assert records[0].retries == 1 and rf.codec_state()["calls"] == 2


# ---- SamplePool and split_epoch_slab, byte-equal to JAX's ----


def _pools(layout="reference"):
    from fedcrack_tpu.data.pipeline import SamplePool as JaxPool
    from fedcrack_tpu.data.pipeline import to_uint8_transport
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.data.pipeline import SamplePool

    client_pools = [to_uint8_transport(*synth_crack_batch(10, 16, seed=c)) for c in range(2)]
    return SamplePool.stack(client_pools), JaxPool.stack(client_pools), client_pools


def test_sample_pool_plans_and_slabs_byte_equal_to_jax():
    pool, jpool, client_pools = _pools()
    assert (pool.n_clients, pool.n_samples, pool.nbytes) == (jpool.n_clients, jpool.n_samples, jpool.nbytes)
    rngs = [np.random.default_rng(c) for c in range(2)]
    jrngs = [np.random.default_rng(c) for c in range(2)]
    for epochs in (1, 3, 2):
        idx = pool.round_indices(rngs, epochs=epochs, steps=2, batch_size=4)
        jidx = jpool.round_indices(jrngs, epochs=epochs, steps=2, batch_size=4)
        assert idx.dtype == np.int32 and idx.shape == (2, epochs, 2, 4)
        assert idx.tobytes() == jidx.tobytes()
        got, want = pool.assemble_round_slab(idx), jpool.assemble_round_slab(jidx)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(got[0][1], client_pools[1][0][idx[1, 0]])
    with pytest.raises(ValueError, match="pool has"):
        pool.round_indices(rngs, epochs=1, steps=4, batch_size=4)
    with pytest.raises(ValueError, match="rngs"):
        pool.round_indices(rngs[:1], epochs=1, steps=1, batch_size=1)
    varying = idx.copy()
    varying[0, 1, 0, 0] = (varying[0, 1, 0, 0] + 1) % 10
    with pytest.raises(ValueError, match="epochs axis"):
        pool.assemble_round_slab(varying)
    from fedcrack_tpu_torch.data.pipeline import SamplePool

    with pytest.raises(ValueError, match="disagree"):
        SamplePool(pool.images, pool.masks[:, :5])
    with pytest.raises(ValueError, match="layout"):
        SamplePool(pool.images, pool.masks, layout="bogus")
    with pytest.raises(ValueError, match="pool size"):
        SamplePool.stack([client_pools[0], (client_pools[1][0][:5], client_pools[1][1][:5])])


def test_sample_pool_append_evict_byte_equal_to_jax():
    """Growth and eviction (``tests/test_resident.py:442-540``) through both
    packages' pools, call for call: the arrays, the counts, the kept
    counts and the plans drawn afterwards are byte-equal."""
    from fedcrack_tpu.data.pipeline import SamplePool as JaxPool
    from fedcrack_tpu_torch.data.pipeline import SamplePool

    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(2, 6, 8, 8, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, size=(2, 6, 8, 8, 1), dtype=np.uint8)
    pool, jpool = SamplePool(images.copy(), masks.copy()), JaxPool(images.copy(), masks.copy())
    fresh_i = rng.integers(0, 255, size=(2, 8, 8, 3), dtype=np.uint8)
    fresh_m = rng.integers(0, 2, size=(2, 8, 8, 1), dtype=np.uint8)
    calls = [("append", 0, np.stack([fresh_i[0], images[0, 1], fresh_i[0]]),
              np.stack([fresh_m[0], masks[0, 1], fresh_m[0]])),
             ("evict", 1, [0, 2]), ("append", 1, images[1, 0:1], masks[1, 0:1]), ("evict", 0, [5, 6]),
             ("append", 0, fresh_i[:1], fresh_m[:1])]
    for call in calls:
        got = getattr(pool, call[0])(*call[1:])
        want = getattr(jpool, call[0])(*call[1:])
        assert got == want, call[0]
        assert pool.counts().tolist() == jpool.counts().tolist()
        assert pool.images.tobytes() == jpool.images.tobytes() and pool.masks.tobytes() == jpool.masks.tobytes()
    idx = pool.round_indices([np.random.default_rng(3), np.random.default_rng(4)], 2, 2, 2)
    jidx = jpool.round_indices([np.random.default_rng(3), np.random.default_rng(4)], 2, 2, 2)
    assert idx.tobytes() == jidx.tobytes()
    with pytest.raises(ValueError, match="valid range"):
        pool.evict(1, [9])
    with pytest.raises(ValueError, match="sample shape"):
        pool.append(0, np.zeros((1, 4, 4, 3), np.uint8), np.zeros((1, 8, 8, 1), np.uint8))


def test_sample_pool_s2d_refuses_and_stage_is_a_copy():
    """``layout="s2d"`` now runs: the pool stores its images packed by
    ``space_to_depth_images`` (uint8 kept), the masks as they were; staging
    is a copy of the host twin in either layout."""
    from fedcrack_tpu_torch.data.pipeline import SamplePool, space_to_depth_images

    pool, _, client_pools = _pools()
    packed = SamplePool.stack(client_pools, layout="s2d")
    assert packed.layout == "s2d" and packed.images.dtype == np.uint8
    assert packed.images.shape == pool.images.shape[:2] + (8, 8, 12)
    assert packed.images.tobytes() == space_to_depth_images(pool.images).tobytes()
    assert packed.masks.tobytes() == pool.masks.tobytes()
    for p in (pool, packed):
        si, sm = p.stage(_mesh())
        assert si.dtype == torch.uint8
        assert si.numpy().tobytes() == p.images.tobytes() and sm.numpy().tobytes() == p.masks.tobytes()
        si[0, 0, 0, 0, 0] ^= 1
        assert si.numpy().tobytes() != p.images.tobytes()  # the host twin is untouched


def test_sample_pool_s2d_byte_equal_to_jax():
    """``SamplePool(layout="s2d")`` against JAX's, call for call: the
    packed arrays after ``stack``, ``append`` (reference-layout samples
    in, packed on the way) and ``evict``, the plans, and the slabs, which
    equal the packing of the reference pool's slabs."""
    from fedcrack_tpu.data.pipeline import SamplePool as JaxPool
    from fedcrack_tpu_torch.data.pipeline import SamplePool, space_to_depth_images

    ref, _, client_pools = _pools()
    pool, jpool = SamplePool.stack(client_pools, layout="s2d"), JaxPool.stack(client_pools, layout="s2d")
    assert pool.images.tobytes() == jpool.images.tobytes() and pool.nbytes == jpool.nbytes
    rng = np.random.default_rng(5)
    fresh_i = rng.integers(0, 255, size=(2, 16, 16, 3), dtype=np.uint8)
    fresh_m = rng.integers(0, 2, size=(2, 16, 16, 1), dtype=np.uint8)
    for call in (("append", 0, fresh_i, fresh_m), ("evict", 1, [3]), ("append", 1, fresh_i[:1], fresh_m[:1])):
        assert getattr(pool, call[0])(*call[1:]) == getattr(jpool, call[0])(*call[1:]), call[0]
        getattr(ref, call[0])(*call[1:])
        assert pool.counts().tolist() == jpool.counts().tolist()
        assert pool.images.tobytes() == jpool.images.tobytes() and pool.masks.tobytes() == jpool.masks.tobytes()
    assert pool.images.tobytes() == space_to_depth_images(ref.images).tobytes()
    idx = pool.round_indices([np.random.default_rng(c) for c in range(2)], 1, 2, 4)
    jidx = jpool.round_indices([np.random.default_rng(c) for c in range(2)], 1, 2, 4)
    assert idx.tobytes() == jidx.tobytes()
    got, want = pool.assemble_round_slab(idx), jpool.assemble_round_slab(jidx)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    assert got[0].tobytes() == space_to_depth_images(ref.assemble_round_slab(idx)[0]).tobytes()
    with pytest.raises(ValueError, match="sample shape"):
        pool.append(0, np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 16, 16, 1), np.uint8))


# ---- configs/c6_s2d_layout.json's layouts through the driver ----


def _c6_model(**layouts):
    """c6's ModelConfig (bfloat16, ``s2d`` stem, ``packed`` residuals) at
    TINY_KW's widths; ``layouts`` overrides its layout fields."""
    import dataclasses

    from fedcrack_tpu_torch.configs import FedConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "c6_s2d_layout.json"), encoding="utf-8") as f:
        c6 = FedConfig.from_json(f.read())
    assert (c6.model.stem_layout, c6.model.res_layout, c6.model.compute_dtype) == ("s2d", "packed", "bfloat16")
    return dataclasses.replace(c6.model, **TINY_KW, **layouts)


@pytest.fixture(scope="module")
def c6_runs():
    """Three rounds of the c6 model through ``run_mesh_federation``: the
    streamed reference-layout slabs (the oracle), the streamed slabs of an
    s2d pool (pre-packed), the resident s2d pool, and the same rounds with
    the reference layouts."""
    from fedcrack_tpu_torch.data.pipeline import SamplePool, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import build_federated_round, run_mesh_federation

    pools = [to_uint8_transport(*synth_crack_batch(POOL_N, 16, seed=c)) for c in range(N_CLIENTS)]
    ref_pool, s2d_pool = SamplePool.stack(pools), SamplePool.stack(pools, layout="s2d")
    c6 = _c6_model()
    out = {}
    for name, cfg, pool in (("oracle", c6, ref_pool), ("packed_staging", c6, s2d_pool),
                            ("reference_layout", _c6_model(stem_layout="reference", res_layout="reference"),
                             ref_pool)):
        rf = build_federated_round(_mesh(), cfg, local_epochs=R_EPOCHS)
        out[name] = run_mesh_federation(rf, _init_vars(), _slab_data_fn(pool), R_ROUNDS, _mesh())
    resident = build_federated_round(_mesh(), c6, local_epochs=R_EPOCHS, data_placement="resident")
    out["resident_s2d_pool"] = run_mesh_federation(resident, _init_vars(), _idx_data_fn(s2d_pool), R_ROUNDS,
                                                   _mesh(), data_placement="resident", sample_pool=s2d_pool)
    return out


@pytest.mark.parametrize("run", ["packed_staging", "resident_s2d_pool", "reference_layout"])
def test_c6_layout_rounds_bit_equal_across_stagings(c6_runs, run):
    """Packed on the device, pre-packed on the host, or gathered from the
    s2d pool: the same bits (and records) as the oracle; the reference
    layouts give them too, on oneDNN (tests/test_torch_layouts.py)."""
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    want_v, want_r = c6_runs["oracle"]
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(want_v))
    got_v, got_r = c6_runs[run]
    _assert_trees_equal(got_v, want_v)
    for a, b in zip(got_r, want_r):
        for k in b.metrics:
            assert a.metrics[k].tobytes() == b.metrics[k].tobytes(), (run, k)


def test_split_epoch_slab_byte_equal_to_jax():
    from fedcrack_tpu.data.pipeline import split_epoch_slab as jax_split
    from fedcrack_tpu_torch.data.pipeline import split_epoch_slab

    images = np.arange(2 * 7 * 3 * 2, dtype=np.uint8).reshape(2, 7, 3, 2)
    masks = np.arange(2 * 7 * 3 * 1, dtype=np.uint8).reshape(2, 7, 3, 1)
    for n in (1, 3, 99):
        got, want = split_epoch_slab(images, masks, n), jax_split(images, masks, n)
        assert [c.shape for c in got[0]] == [c.shape for c in want[0]]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got[0] + got[1], want[0] + want[1]))
    ic, _ = split_epoch_slab(images, masks, 3)
    assert [c.shape[1] for c in ic] == [3, 2, 2] and ic[0].base is not None
    with pytest.raises(ValueError, match="n_chunks"):
        split_epoch_slab(images, masks, 0)
    with pytest.raises(ValueError, match="disagree"):
        split_epoch_slab(images, masks[:, :3], 2)


# ---- tools.refscale_federation ----


def test_refscale_federation_main_writes_the_jax_keys(tmp_path):
    from fedcrack_tpu_torch.tools import refscale_federation as rs

    out = tmp_path / "smoke.json"
    assert rs.main(["--clients", "2", "--rounds", "2", "--epochs", "1", "--samples", "64", "--img", "32",
                    "--eval-samples", "16", "--out", str(out)], device="cpu") == 0
    import json

    artifact = json.loads(out.read_text())
    # The JAX tool runs the JAX mesh program, which the installed JAX cannot
    # run, so its keys are read from its source (chip_smoke.py's helper,
    # which phase 19 applies to the same command on the card).
    chip_smoke.check_refscale_artifact(artifact, chip_smoke.jax_refscale_keys())
    assert len(artifact["rounds"]) == 2
    assert all([f["client"] for f in rnd["fits"]] == [0, 1] for rnd in artifact["rounds"])
    assert artifact["rounds"][0]["eval_stage_s"] > 0 and artifact["rounds"][1]["eval_stage_s"] == 0
    assert artifact["workload"]["clients"] == 2 and artifact["hardware"]["platform"] == "cpu"


def test_refscale_federation_resident_segments_and_resume(tmp_path):
    """``--data-placement resident`` and ``--segments`` give the streamed
    monolithic trajectory; a checkpointed session resumed at round 2
    equals an uninterrupted one."""
    import json

    from fedcrack_tpu_torch.tools import refscale_federation as rs

    base = ["--clients", "2", "--epochs", "2", "--samples", "32", "--img", "32", "--eval-samples", "16",
            "--dtype", "float32"]

    def run(name, *extra, rounds=2):
        out = tmp_path / f"{name}.json"
        rs.main(base + ["--rounds", str(rounds), "--out", str(out), *extra], device="cpu")
        return json.loads(out.read_text())

    plain = run("plain")
    for other in (run("resident", "--data-placement", "resident"), run("seg", "--segments", "2")):
        assert [r["eval"] for r in other["rounds"]] == [r["eval"] for r in plain["rounds"]]
    run("first", "--ckpt-dir", str(tmp_path / "ck"), rounds=1)
    resumed = run("resumed", "--ckpt-dir", str(tmp_path / "ck"), "--resume")
    assert resumed["resumed_from"] == 1
    assert resumed["rounds"][1]["eval"] == plain["rounds"][1]["eval"]
