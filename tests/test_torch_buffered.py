"""The port's FedBuff (fed/buffered.py, rounds.transition under
``mode="buffered"``) held against the JAX package's on the CPU.

Every pure scenario of tests/test_buffered.py (the tests that drive
``rounds.transition`` or ``fed.buffered`` directly) runs through both
packages' ``transition`` with the same events, the same clock and the same
upload bytes. After every event these are held exactly equal: the reply's
status, title, config map and blob bytes; the state's phase, clocks,
round, version, cohort, pulled versions, buffer (blob bytes included),
retained bases, rejected map and history; the global and broadcast bytes;
the ledger; and the statefile bytes of the two states (``ckpt``). Bytes
and bits are exact: no tolerance anywhere in this file.
"""

import dataclasses

import numpy as np
import pytest

from fedcrack_tpu.ckpt import statefile as JS
from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import buffered as JB
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu_torch.ckpt import statefile as TS
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import buffered as TB
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed import serialization as tser

pytestmark = pytest.mark.torch_port

STATE_FIELDS = ("phase", "enroll_opened_at", "cohort", "current_round", "model_version",
                "round_started_at", "failed_rounds", "departed", "rejected", "wire_bytes", "codecs",
                "pulled", "buffer", "base_blobs", "history", "ledger", "global_blob", "wire_blob")


def _vars(value: float):
    return {"params": {"w": np.full((4, 4), value, np.float32)}}


def _cfg(**kw):
    """tests/test_buffered.py's configuration."""
    base = dict(max_rounds=3, cohort_size=3, registration_window_s=3600.0, mode="buffered",
                buffer_k=3, staleness_alpha=0.0, max_staleness=4)
    base.update(kw)
    return base


class Pair:
    """Both packages' servers, fed the same events under one clock."""

    def __init__(self, variables=None, **cfg):
        variables = _vars(0.0) if variables is None else variables
        self.j = JR.initial_state(JaxFedConfig(**cfg), variables)
        self.t = TR.initial_state(FedConfig(**cfg), variables)
        self.now = 0.0
        self.check()

    def send(self, kind, *args, **kw):
        self.now += 1e-3
        kw.setdefault("now", self.now)
        self.j, jr = JR.transition(self.j, getattr(JR, kind)(*args, **kw))
        self.t, tr = TR.transition(self.t, getattr(TR, kind)(*args, **kw))
        what = f"{kind}{args}{kw}"
        assert (tr.status, tr.title, dict(tr.config), tr.blob) == (jr.status, jr.title, dict(jr.config), jr.blob), what
        self.check()
        return tr

    def check(self):
        for name in STATE_FIELDS:
            assert getattr(self.t, name) == getattr(self.j, name), name
        assert (self.t.server_opt_state is None) == (self.j.server_opt_state is None)
        assert TS.server_state_to_bytes(self.t) == JS.server_state_to_bytes(self.j)

    def enroll(self, names):
        for c in names:
            assert self.send("Ready", c).status == JR.SW

    def pull(self, c):
        rep = self.send("PullWeights", c)
        assert rep.status == "OK"
        return rep

    def push(self, c, value, ns, rnd=1, blob=None):
        blob = jser.tree_to_bytes(_vars(value)) if blob is None else blob
        return self.send("TrainDone", c, round=rnd, blob=blob, num_samples=ns)


def test_staleness_weight_closed_form_matches_jax():
    for s in range(10):
        for alpha in (0.0, 0.25, 0.5, 1.0, 2.0, 3.7):
            assert TB.staleness_weight(s, alpha) == JB.staleness_weight(s, alpha)
    assert TB.staleness_weight(1, 1.0) == 0.5
    for bad in ((-1, 0.5), (1, -0.1)):
        with pytest.raises(ValueError):
            JB.staleness_weight(*bad)
        with pytest.raises(ValueError):
            TB.staleness_weight(*bad)


@pytest.mark.parametrize("kw", [dict(mode="later"), dict(buffer_k=0), dict(staleness_alpha=-1.0),
                                dict(max_staleness=-1)])
def test_buffered_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxFedConfig(**kw)
    with pytest.raises(ValueError):
        FedConfig(**kw)


def test_buffered_knobs_round_trip_json_and_boot():
    cfg = FedConfig(**_cfg(buffer_k=5, staleness_alpha=0.25, max_staleness=7))
    back = FedConfig.from_json(cfg.to_json())
    assert (back.mode, back.buffer_k, back.staleness_alpha, back.max_staleness) == ("buffered", 5, 0.25, 7)
    assert JaxFedConfig.from_json(cfg.to_json()) == JaxFedConfig(**_cfg(buffer_k=5, staleness_alpha=0.25,
                                                                          max_staleness=7))
    p = Pair(**_cfg(buffer_k=5))
    assert p.t.base_blobs == {0: p.t.global_blob}
    assert p.send("Ready", "a").config["mode"] == "buffered"


def test_flush_matches_sorted_fold_oracle():
    from fedcrack_tpu_torch.fed.algorithms import fedavg

    p = Pair(**_cfg(buffer_k=3, staleness_alpha=1.0))
    p.enroll("abc")
    for c in "abc":
        p.pull(c)
    assert p.push("a", 1.0, 10).status == JR.RESP_ACY
    assert p.push("b", 3.0, 30).status == JR.RESP_ACY
    entries = sorted(p.t.buffer, key=lambda e: (e["cname"], e["seq"]))
    assert p.push("c", 6.0, 20).status == JR.RESP_ARY
    entries += [{"blob": tser.tree_to_bytes(_vars(6.0)), "ns": 20, "weight": 1.0}]
    oracle = fedavg([tser.tree_from_bytes(e["blob"]) for e in entries], [e["ns"] * e["weight"] for e in entries])
    assert tser.tree_from_bytes(p.t.global_blob)["params"]["w"].tobytes() == oracle["params"]["w"].tobytes()
    assert (p.t.history[-1]["buffer_fill"], p.t.history[-1]["global_version"]) == (3, 1)


@pytest.mark.parametrize("order", ["abc", "cba", "bca"])
def test_arrival_order_independent_flush(order):
    values, samples = {"a": 1.0, "b": 3.0, "c": 6.0}, {"a": 10, "b": 30, "c": 20}
    globals_ = []
    for arrival in (order, "abc"):
        p = Pair(**_cfg(buffer_k=3))
        p.enroll("abc")
        for c in arrival:
            p.pull(c)
        for c in arrival:
            p.push(c, values[c], samples[c])
        assert p.t.model_version == 1
        globals_.append(p.t.global_blob)
    assert globals_[0] == globals_[1]


def test_alpha0_k_equals_n_degenerates_to_sync_bitexact():
    """Sync FedAvg and buffered K = N, alpha = 0, through FedAdam: the two
    packages agree byte for byte in each mode, and each package's modes
    agree with each other."""
    values, samples = {"a": 1.0, "b": 3.0}, {"a": 10, "b": 30}

    def drive(mode):
        kw = dict(max_rounds=3, cohort_size=2, registration_window_s=3600.0, server_optimizer="fedadam",
                  server_lr=0.1)
        if mode == "buffered":
            kw.update(mode="buffered", buffer_k=2, staleness_alpha=0.0)
        p = Pair(**kw)
        p.enroll("ab")
        for rnd in range(1, 4):
            for c in "ab":
                p.pull(c)
            for c in "ab":
                p.push(c, values[c] + rnd, samples[c], rnd=rnd)
        return p

    sync, buf = drive("sync"), drive("buffered")
    assert sync.t.global_blob == buf.t.global_blob == sync.j.global_blob
    assert sync.t.model_version == buf.t.model_version == 3
    assert buf.t.phase == TR.PHASE_FINISHED


def test_stale_update_weighted_by_decay():
    p = Pair(**_cfg(buffer_k=1, staleness_alpha=1.0, max_rounds=5))
    p.enroll("abc")
    p.pull("a")
    p.pull("b")
    assert p.push("a", 2.0, 10).status == JR.RESP_ARY and p.t.model_version == 1
    assert p.push("b", 4.0, 10).status == JR.RESP_ARY and p.t.model_version == 2
    entry = p.t.history[-1]
    assert (entry["staleness"], entry["weights"], entry["mix"]) == ([1], [0.5], 0.5)
    np.testing.assert_array_equal(tser.tree_from_bytes(p.t.global_blob)["params"]["w"], np.full((4, 4), 3.0))
    summary = TB.async_summary(p.t.history)
    assert summary == JB.async_summary(p.j.history)
    assert (summary["accepted_updates"], summary["global_versions"], summary["staleness"]["max"]) == (2, 2, 1.0)


def test_mixed_staleness_flush_weighted_mean():
    p = Pair(**_cfg(buffer_k=2, staleness_alpha=1.0, max_rounds=5))
    p.enroll("abc")
    for c in "abc":
        p.pull(c)
    p.push("a", 1.0, 10)
    assert p.push("b", 3.0, 30).status == JR.RESP_ARY
    p.pull("a")
    assert p.push("c", 6.0, 20).status == JR.RESP_ACY
    assert p.push("a", 2.0, 10).status == JR.RESP_ARY and p.t.model_version == 2
    entry = p.t.history[-1]
    assert entry["mix"] == 20.0 / 30.0  # (10 * 1 + 20 * 0.5) / (10 + 20)
    assert sorted(zip(entry["clients"], entry["staleness"])) == [("a", 0), ("c", 1)]


def test_too_stale_rejected_and_resynced():
    p = Pair(**_cfg(buffer_k=1, staleness_alpha=0.5, max_staleness=0, max_rounds=5))
    p.enroll("abc")
    p.pull("a")
    p.pull("b")
    p.push("a", 2.0, 10)
    rep = p.push("b", 4.0, 10)
    assert rep.status == JR.NOT_WAIT and rep.blob == p.t.broadcast_blob
    assert "too stale" in p.t.rejected["b"] and p.t.pulled["b"] == 1
    p.pull("a")
    p.push("a", 3.0, 10)
    assert "too stale" in p.t.history[-1]["rejected"]["b"]
    p.pull("b")
    assert p.push("b", 5.0, 10).status in (JR.RESP_ARY, JR.FIN)


def test_push_before_pull_resyncs():
    p = Pair(**_cfg(buffer_k=2))
    p.enroll("abc")
    assert p.push("a", 1.0, 10).status == JR.NOT_WAIT
    assert "no recorded base" in p.t.rejected["a"] and p.t.pulled["a"] == 0


def test_sanitation_rejects_poison_and_strangers_in_buffered_mode():
    p = Pair(**_cfg(buffer_k=2))
    p.enroll("abc")
    p.pull("a")
    bad = _vars(1.0)
    bad["params"]["w"][:] = np.nan
    assert p.push("a", 0.0, 10, blob=jser.tree_to_bytes(bad)).status == JR.REJECTED
    assert "a" in p.t.rejected and not p.t.buffer
    assert p.push("a", 0.0, 10, blob=b"\x00garbage").status == JR.REJECTED
    assert p.push("stranger", 1.0, 10).status == JR.REJECTED
    assert p.t.ledger["a"]["rejected"] == {"sanitation": 2}


def test_stale_framed_delta_decodes_against_retained_base():
    """int8 frames (the JAX codec's bytes, which the port's codec writes
    too) pinned to a retained past version reconstruct against it."""
    from fedcrack_tpu.compress import get_codec

    p = Pair(**_cfg(buffer_k=1, staleness_alpha=1.0, max_staleness=2, max_rounds=5, update_codec="int8"))
    p.enroll("abc")
    p.pull("a")
    base0 = p.pull("b").blob
    for v in (2.0, 3.0):
        frame = get_codec("int8", client_tag="a").encode_update(
            jser.tree_to_bytes(_vars(v)), p.j.broadcast_blob, round=1, base_version=p.j.model_version)
        assert p.push("a", 0.0, 10, blob=frame).status == JR.RESP_ARY
        p.pull("a")
    frame_b = get_codec("int8", client_tag="b").encode_update(jser.tree_to_bytes(_vars(9.0)), base0, round=1,
                                                              base_version=0)
    assert p.push("b", 0.0, 10, blob=frame_b).status == JR.RESP_ARY
    entry = p.t.history[-1]
    assert (entry["staleness"], entry["codecs"]) == ([2], ["int8"])
    # A frame pinned to a version that left the window is resynced.
    stale = get_codec("int8", client_tag="c").encode_update(jser.tree_to_bytes(_vars(1.0)), base0, round=1,
                                                            base_version=0)
    p.send("PullWeights", "c")
    assert p.push("c", 0.0, 10, blob=stale).status == JR.REJECTED  # pinned to v0, pulled v3
    assert sorted(p.t.base_blobs) == [1, 2, 3]


def test_deadline_flushes_partial_buffer():
    p = Pair(**_cfg(buffer_k=3, round_deadline_s=5.0, registration_window_s=1.0))
    p.enroll("abc")
    p.pull("a")
    assert p.push("a", 2.0, 10).status == JR.RESP_ACY and p.t.model_version == 0
    p.send("Tick", now=p.now + 10.0)
    assert p.t.model_version == 1 and p.t.history[-1]["buffer_fill"] == 1
    p.send("Tick", now=p.now + 30.0)
    assert p.t.model_version == 1


def test_quarantine_and_fedavgm_in_a_buffered_flush():
    """The ledger scores the flush, a scaled update is quarantined out of
    it, and FedAvgM steps on the kept mean."""
    p = Pair(**_cfg(buffer_k=4, staleness_alpha=0.5, quarantine_z=3.5, server_optimizer="fedavgm",
                    server_lr=0.5, cohort_size=4, max_rounds=2))
    p.enroll("abcd")
    for c in "abcd":
        p.pull(c)
    for c, v in zip("abc", (1.0, 1.1, 0.9)):
        p.push(c, v, 10)
    assert p.push("d", 1000.0, 10).status == JR.NOT_WAIT  # quarantined out of its own flush
    assert set(p.t.history[-1]["quarantined"]) == {"d"}


def test_statefile_midbuffer_resume_bit_identity():
    """A mid-buffer snapshot of either package restores in both, re-encodes
    to the same bytes, and flushes the same global as the live state."""
    p = Pair(**_cfg(buffer_k=3, staleness_alpha=1.0))
    p.enroll("abc")
    for c in "abc":
        p.pull(c)
    p.push("a", 1.0, 10)
    p.push("b", 3.0, 30)
    blob = TS.server_state_to_bytes(p.t)
    assert blob == JS.server_state_to_bytes(p.j)
    twins = [TS.server_state_from_bytes(blob, p.t.config), JS.server_state_from_bytes(blob, p.j.config)]
    assert TS.server_state_to_bytes(twins[0]) == JS.server_state_to_bytes(twins[1]) == blob
    assert len(twins[0].buffer) == 2 and twins[0].pulled["c"] == 0
    live = p.push("c", 6.0, 20)
    upload = jser.tree_to_bytes(_vars(6.0))
    for R, twin in zip((TR, JR), twins):
        twin, rep = R.transition(twin, R.TrainDone(cname="c", round=1, blob=upload, num_samples=20, now=p.now))
        assert (twin.global_blob, twin.model_version, rep.status) == (p.t.global_blob, 1, live.status)


def test_async_summary_and_reservoir_match_jax():
    from fedcrack_tpu.obs.metrics import StreamingPercentiles as JaxPercentiles
    from fedcrack_tpu_torch.obs.metrics import StreamingPercentiles

    history = ({"buffer_fill": 2, "staleness": [0, 1]}, {"buffer_fill": 3, "staleness": [0, 2, 4]}, {"round": 9})
    out = TB.async_summary(history)
    assert out == JB.async_summary(history)
    assert (out["accepted_updates"], out["global_versions"], out["mean_buffer_fill"]) == (5, 2, 2.5)
    assert (out["staleness"]["max"], out["staleness"]["p50"]) == (4.0, 1.0)
    assert TB.async_summary(()) == JB.async_summary(())
    values = np.random.default_rng(0).normal(size=500)
    res = [StreamingPercentiles(capacity=64, seed=3), JaxPercentiles(capacity=64, seed=3)]
    for v in values:
        for r in res:
            r.add(v)
    assert res[0].summary() == res[1].summary() and res[0]._values == res[1]._values
    for q in (0.0, 12.5, 50.0, 99.0, 100.0):
        assert res[0].percentile(q) == res[1].percentile(q)
    with pytest.raises(ValueError):
        res[0].percentile(101.0)
    with pytest.raises(ValueError):
        StreamingPercentiles(capacity=0)


def test_fold_buffer_matches_jax_and_ignores_arrival_order():
    entries = [{"cname": c, "seq": q, "blob": jser.tree_to_bytes(_vars(v)), "ns": n, "staleness": s,
                "weight": TB.staleness_weight(s, 0.5), "base_version": 0, "wire_len": 0, "codec": "null"}
               for c, q, v, n, s in (("b", 0, 3.0, 30, 1), ("a", 1, 2.5, 10, 0), ("a", 0, 1.0, 10, 2))]
    template = _vars(0.0)
    got = TB.fold_buffer(tuple(entries), template)
    want = JB.fold_buffer(tuple(entries), template)
    assert got[0]["params"]["w"].tobytes() == np.asarray(want[0]["params"]["w"]).tobytes()
    assert [(e["cname"], e["seq"]) for e in got[1]] == [("a", 0), ("a", 1), ("b", 0)]
    assert got[2:4] == want[2:4]
    reversed_ = TB.fold_buffer(tuple(reversed(entries)), template)
    assert reversed_[0]["params"]["w"].tobytes() == got[0]["params"]["w"].tobytes()
    with pytest.raises(RuntimeError):
        TB.fold_buffer((), template)


def test_buffer_entry_wire_rows_match_jax():
    entry = {"cname": "a", "seq": 2, "blob": b"\x01\x02", "ns": 7, "staleness": 1, "weight": 0.5,
             "base_version": 3, "wire_len": 99, "codec": "int8"}
    row = TB.buffer_entry_to_wire(entry)
    assert row == JB.buffer_entry_to_wire(entry)
    assert TB.buffer_entry_from_wire(row) == JB.buffer_entry_from_wire(row) == entry


def test_server_state_buffered_fields_default_empty():
    st = TR.initial_state(FedConfig(), _vars(0.0))
    assert (st.pulled, st.buffer, st.base_blobs) == ({}, (), {})
    assert dataclasses.replace(st, buffer=({"x": 1},)).buffer == ({"x": 1},)
