"""The port's spans inside the federated round and the train step
(``obs/spans.py``'s in-memory sink, absolute bounds and inferred parents;
``parallel/driver.py``, ``parallel/fedavg_mesh.py``, ``train/local.py`` and
``data/pipeline.py``), on the CPU at a tiny width.

A round driven by ``run_mesh_federation`` opens ``driver.round`` at its
dispatch and closes it at its barrier; inside it each client slot is a
``mesh.slot`` holding its ``mesh.slot_init``, three ``train.*`` spans a
step and its ``mesh.fold``, then ``mesh.finish``, the next round's
``driver.stage`` and ``driver.barrier``. Spans change no result: a round
driven with no recorder installed gives the same global, bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

TINY = dict(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
STEPS, BATCH, N_CLIENTS, ROUNDS = 2, 2, 2, 2
TRAIN = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_recorder_left():
    from fedcrack_tpu_torch.obs import spans

    spans.uninstall()
    yield
    spans.uninstall()


def _cfg():
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**TINY)


def _mesh():
    from fedcrack_tpu_torch.parallel import make_mesh

    return make_mesh(N_CLIENTS, 1, device="cpu")


def _init_vars():
    from fedcrack_tpu_torch.models.resunet import init_variables

    return init_variables(torch.Generator().manual_seed(0), _cfg())


def _data_fn(r):
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import stack_client_data

    per = [synth_crack_batch(STEPS * BATCH, img_size=32, seed=10 * r + i) for i in range(N_CLIENTS)]
    images, masks = stack_client_data(per, STEPS, BATCH)
    return images, masks, np.ones(N_CLIENTS, np.float32), np.full(N_CLIENTS, float(STEPS * BATCH), np.float32)


def _leaf_bytes(tree):
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    return [t.detach().cpu().numpy().tobytes() for t in tree_leaves(tree)]


def _spanned(run):
    """``run()`` under an in-memory recorder: its result and the records."""
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    try:
        out = run()
    finally:
        spans.uninstall()
    return out, rec.records


def _children(records, parent):
    return [r for r in records if r["parent"] == parent["span"]]


def _named(records, name):
    return [r for r in records if r["name"] == name]


@pytest.fixture(scope="module")
def mesh_run():
    """Two overlapped rounds driven once under a recorder and once with
    none: ``(records, spanned_result, plain_result)``."""
    from fedcrack_tpu_torch.obs import spans
    from fedcrack_tpu_torch.parallel import build_federated_round, run_mesh_federation

    round_fn = build_federated_round(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=1)

    def run():
        return run_mesh_federation(round_fn, _init_vars(), _data_fn, ROUNDS, _mesh(), overlap_staging=True)

    spans.uninstall()
    plain = run()
    spanned, records = _spanned(run)
    return records, spanned, plain


def test_one_round_span_per_round_holding_its_slots(mesh_run):
    records, (_, recs), _ = mesh_run
    rounds = _named(records, "driver.round")
    assert [r["round"] for r in rounds] == list(range(ROUNDS))
    assert all(r["parent"] is None for r in rounds)
    for rnd in rounds:
        kids = _children(records, rnd)
        slots = _named(kids, "mesh.slot")
        assert [s["client"] for s in slots] == list(range(N_CLIENTS))
        assert all(s["steps"] == STEPS for s in slots)
        for slot in slots:
            inner = _children(records, slot)
            assert [s["name"] for s in inner] == ["mesh.slot_init"] + list(TRAIN) * STEPS + ["mesh.fold"]
            assert [s["step"] for s in _named(inner, "train.forward")] == list(range(STEPS))
            assert _named(inner, "mesh.slot_init")[0]["leaves"] == _named(inner, "mesh.fold")[0]["leaves"] > 0
        assert len(_named(kids, "mesh.finish")) == 1
        assert len(_named(kids, "driver.barrier")) == 1
        stages = _named(kids, "driver.stage")
        if rnd["round"] + 1 < ROUNDS:
            assert [s["round"] for s in stages] == [rnd["round"] + 1]
            assert stages[0]["bytes"] == sum(a.nbytes for a in _data_fn(rnd["round"] + 1)[:2])
        else:
            assert stages == []
    assert len(recs) == ROUNDS


def test_round_span_attributes_match_the_record(mesh_run):
    records, (_, recs), _ = mesh_run
    for rnd, rec in zip(_named(records, "driver.round"), recs):
        assert abs(rnd["dur_s"] - rec.wall_clock_s) < 1e-3
        assert rnd["wall_s"] == round(rec.wall_clock_s, 6)
        assert rnd["staging_s"] == round(rec.staging_s, 6)
        assert rnd["staged_bytes"] == rec.staged_bytes
        assert rnd["retries"] == rec.retries == 0
        assert rnd["data_placement"] == rec.data_placement == "streamed"
        assert rnd["trace"] == f"round-{rec.round_idx}"


def test_first_staging_is_its_own_span_with_its_copies(mesh_run):
    records, _, _ = mesh_run
    first = [s for s in _named(records, "driver.stage") if s["parent"] is None]
    assert [s["round"] for s in first] == [0]
    assert first[0]["end_ns"] <= _named(records, "driver.round")[0]["start_ns"]
    for stage in _named(records, "driver.stage"):
        copies = _named(_children(records, stage), "data.copy")
        assert len(copies) == 2 and sum(c["bytes"] for c in copies) == stage["bytes"]


def test_children_lie_inside_their_parents(mesh_run):
    records, _, _ = mesh_run
    by_id = {r["span"]: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        assert abs(r["dur_s"] - (r["end_ns"] - r["start_ns"]) * 1e-9) <= 1e-6
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"], (r["name"], p["name"])
    expected_parent = {"mesh.slot_init": "mesh.slot", "mesh.fold": "mesh.slot", "mesh.slot": "driver.round",
                       "mesh.finish": "driver.round", "driver.barrier": "driver.round", "data.copy": "driver.stage"}
    expected_parent.update({name: "mesh.slot" for name in TRAIN})
    for r in records:
        if r["name"] in expected_parent:
            assert by_id[r["parent"]]["name"] == expected_parent[r["name"]], r["name"]


def test_spans_change_no_result(mesh_run):
    _, (spanned_vars, spanned_recs), (plain_vars, plain_recs) = mesh_run
    assert _leaf_bytes(spanned_vars) == _leaf_bytes(plain_vars)
    for a, b in zip(spanned_recs, plain_recs):
        for k in a.metrics:
            assert a.metrics[k].tobytes() == b.metrics[k].tobytes(), k


def test_nothing_recorded_without_a_recorder():
    from fedcrack_tpu_torch.obs import flight, spans

    assert spans.current() is None and flight.current() is None
    with spans.span("mesh.slot", client=0) as handle:
        assert handle is None
    assert spans.current() is None


def test_segmented_and_cohort_rounds_are_spanned():
    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round_segments,
        run_cohort_federation,
        run_mesh_federation,
    )

    seg = build_federated_round_segments(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=2, segments=2)
    (_, recs), records = _spanned(lambda: run_mesh_federation(seg, _init_vars(), _data_fn, ROUNDS, _mesh()))
    rounds = _named(records, "driver.round")
    assert len(rounds) == len(recs) == ROUNDS
    by_id = {r["span"]: r for r in records}
    for name, per_round in (("mesh.slot", 2 * N_CLIENTS), ("mesh.slot_init", N_CLIENTS), ("mesh.fold", 1),
                            ("mesh.finish", 1)):
        got = _named(records, name)
        assert len(got) == per_round * ROUNDS, name
        for r in got:
            while by_id[r["parent"]]["name"] != "driver.round":
                r = by_id[r["parent"]]
    assert len(_named(records, "train.forward")) == ROUNDS * N_CLIENTS * 2 * STEPS

    cohort = build_federated_cohort_round(_mesh(), _cfg(), learning_rate=1e-3, local_epochs=1)

    def cohort_data(r):
        images, masks, active, n = _data_fn(r)
        return (np.concatenate([images, images]), np.concatenate([masks, masks]), np.concatenate([active, active]),
                np.concatenate([n, n]))

    (_, recs), records = _spanned(lambda: run_cohort_federation(cohort, _init_vars(), cohort_data, ROUNDS, _mesh()))
    rounds = _named(records, "driver.round")
    assert [r["round"] for r in rounds] == list(range(ROUNDS))
    for rnd, rec in zip(rounds, recs):
        kids = _children(records, rnd)
        assert len(_named(kids, "driver.stage")) == 2
        assert sum(s["bytes"] for s in _named(kids, "driver.stage")) == rec.staged_bytes == rnd["staged_bytes"]
        assert len(_named(kids, "mesh.finish")) == len(_named(kids, "driver.barrier")) == 1
        assert abs(rnd["dur_s"] - rec.wall_clock_s) < 1e-3


# ---- the recorder ----


def test_memory_sink_keeps_records_with_absolute_bounds():
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    with spans.span("driver.round", trace="round-0", round=0) as outer:
        outer.set(wall_s=0.5)
        with spans.span("mesh.slot", client=1):
            pass
    spans.uninstall()
    inner, outer_rec = rec.records
    assert (outer_rec["name"], outer_rec["trace"], outer_rec["round"], outer_rec["wall_s"]) == (
        "driver.round", "round-0", 0, 0.5)
    assert inner["parent"] == outer_rec["span"] and outer_rec["parent"] is None
    assert outer_rec["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer_rec["end_ns"]
    assert set(outer_rec) >= {"name", "trace", "span", "parent", "t", "dur_s", "start_ns", "end_ns", "ts"}
    with spans.span("mesh.slot"):
        pass
    assert len(rec.records) == 2


def test_explicit_parent_wins_and_siblings_share_a_parent():
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    with spans.span("driver.round") as outer:
        with spans.span("mesh.slot"):
            with spans.span("client.push", parent=outer.span_id):
                pass
        with spans.span("mesh.finish"):
            pass
    spans.uninstall()
    by_name = {r["name"]: r for r in rec.records}
    assert by_name["client.push"]["parent"] == outer.span_id
    assert by_name["mesh.slot"]["parent"] == by_name["mesh.finish"]["parent"] == outer.span_id


def test_an_exception_closes_the_span_and_pops_it():
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    with pytest.raises(RuntimeError):
        with spans.span("driver.round"):
            raise RuntimeError("round failed")
    with spans.span("driver.stage"):
        pass
    spans.uninstall()
    assert [(r["name"], r["parent"]) for r in rec.records] == [("driver.round", None), ("driver.stage", None)]


def test_parents_are_per_thread():
    from fedcrack_tpu_torch.obs import spans

    rec = spans.install()
    started, release = threading.Event(), threading.Event()

    def other():
        with spans.span("serve.batch"):
            started.set()
            release.wait(5)

    t = threading.Thread(target=other)
    t.start()
    started.wait(5)
    with spans.span("driver.round"):
        with spans.span("mesh.slot"):
            pass
    release.set()
    t.join(5)
    spans.uninstall()
    by_name = {r["name"]: r for r in rec.records}
    assert by_name["serve.batch"]["parent"] is None and by_name["driver.round"]["parent"] is None
    assert by_name["mesh.slot"]["parent"] == by_name["driver.round"]["span"]


def test_file_sink_writes_the_new_fields(tmp_path):
    from fedcrack_tpu_torch.obs import spans

    path = tmp_path / "spans.jsonl"
    spans.install(str(path))
    with spans.span("driver.round"):
        with spans.span("driver.barrier"):
            pass
    spans.uninstall()
    barrier, rnd = spans.read_spans(str(path))
    assert barrier["parent"] == rnd["span"]
    assert isinstance(rnd["start_ns"], int) and rnd["end_ns"] >= barrier["end_ns"]
    assert spans.current() is None
