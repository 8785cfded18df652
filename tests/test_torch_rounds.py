"""The port's sync round machine (fed/rounds.py) held against the JAX
package's ``fedcrack_tpu.fed.rounds`` on the CPU.

One parametrised test runs every event script of tests/test_fed.py's
round-machine tests (plus robust-fold, quarantine, FedOpt and bf16-wire
sessions) through both ``transition``s with the same events and the same
upload bytes, and after every event holds equal: the reply's status,
title and config map; the state's phase, clocks, round, version, cohort,
departed, received, rejected, logs and history (the history's quarantine
scores to 1e-6 relative; it holds no global floats); the ledger's counters
(its geometry to 1e-5). Globals and reply blobs are decoded and held to 1
float32 ulp for FedAvg (the port's fold against the JAX package's native
FMA kernel, tests/test_torch_fed.py), bitwise for the robust folds, and to
1 ulp after FedOpt steps (measured bitwise, tests/test_torch_aggregation.py); a
bfloat16 wire copy of globals 1 float32 ulp apart may round to
neighbouring bfloat16 values, so it is held to 1 bfloat16 ulp.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest

import chip_smoke
from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed import serialization as tser
from torch_port_helpers import TINY_KW, jax_variables

pytestmark = pytest.mark.torch_port

CFG = dict(max_rounds=2, cohort_size=2, registration_window_s=10.0)
STATE_FIELDS = ("phase", "enroll_opened_at", "cohort", "current_round", "model_version",
                "round_started_at", "logs", "failed_rounds", "departed", "rejected",
                "wire_bytes", "codecs", "secagg_seeds", "secagg_roster", "privacy_steps")
LEDGER_GEOMETRY = ("norms", "cosines", "anomaly")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
        "bias": rng.normal(size=(4,)).astype(np.float32),
    }


def _fedopt_vars(value):
    return {
        "params": {"w": np.full(3, value, np.float32)},
        "batch_stats": {"bn": {"mean": np.full(3, value, np.float32)}},
    }


def _leaves(blob):
    return jax.tree_util.tree_leaves(jser.tree_from_bytes(blob))


def _assert_close(got, want, maxulp, what):
    """Two decoded leaves: bitwise for ``maxulp == 0``; else float32 within
    ``maxulp`` ulps and bfloat16 within 1 bf16 ulp."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if maxulp == 0:
        assert got.tobytes() == want.tobytes(), what
    elif want.dtype.name == "bfloat16":
        g = got.view(np.uint16).astype(np.int32)
        w = want.view(np.uint16).astype(np.int32)
        assert np.abs(g - w).max(initial=0) <= 1, what
    else:
        try:
            np.testing.assert_array_max_ulp(got, want, maxulp=maxulp)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None


class Pair:
    """Both packages' servers, fed the same events."""

    def __init__(self, tree, maxulp=1, **cfg):
        self.maxulp = maxulp
        self.cfg = {**CFG, **cfg}
        self.j = JR.initial_state(JaxFedConfig(**self.cfg), tree)
        self.t = TR.initial_state(FedConfig(**self.cfg), tree)
        self.check_state()

    def send(self, kind, *args, **kw):
        self.j, jr = JR.transition(self.j, getattr(JR, kind)(*args, **kw))
        self.t, tr = TR.transition(self.t, getattr(TR, kind)(*args, **kw))
        what = f"{kind}{args}{kw}"
        assert (tr.status, tr.title, dict(tr.config)) == (jr.status, jr.title, dict(jr.config)), what
        assert (tr.blob is None) == (jr.blob is None), what
        if jr.blob is not None:
            self.check_blob(tr.blob, jr.blob, what)
        self.check_state()
        return jr

    def check_blob(self, got, want, what):
        if got == want:
            return
        assert self.maxulp > 0, f"{what}: blobs differ"
        g, w = _leaves(got), _leaves(want)
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            _assert_close(a, b, self.maxulp, what)

    def check_state(self):
        for name in STATE_FIELDS:
            assert getattr(self.t, name) == getattr(self.j, name), name
        assert {k: v[1] for k, v in self.t.received.items()} == {k: v[1] for k, v in self.j.received.items()}
        for k in self.j.received:
            assert self.t.received[k][0] == self.j.received[k][0], k
        assert len(self.t.history) == len(self.j.history)
        for got, want in zip(self.t.history, self.j.history):
            assert {k: v for k, v in got.items() if k != "quarantined"} == \
                   {k: v for k, v in want.items() if k != "quarantined"}
            assert set(got["quarantined"]) == set(want["quarantined"])
            for name, score in dict(want["quarantined"]).items():  # a list under secagg
                assert got["quarantined"][name] == pytest.approx(score, rel=1e-6)
        assert set(self.t.ledger) == set(self.j.ledger)
        for name, want in self.j.ledger.items():
            got = self.t.ledger[name]
            assert {k: v for k, v in got.items() if k not in LEDGER_GEOMETRY} == \
                   {k: v for k, v in want.items() if k not in LEDGER_GEOMETRY}, name
            for k in LEDGER_GEOMETRY:
                assert got[k] == pytest.approx(want[k], abs=1e-5), (name, k)
        assert (self.t.server_opt_state is None) == (self.j.server_opt_state is None)
        assert self.t.broadcast_blob is not None
        self.check_blob(self.t.global_blob, self.j.global_blob, "global")
        self.check_blob(self.t.broadcast_blob, self.j.broadcast_blob, "broadcast")

    def replace(self, **kw):
        self.j, self.t = self.j._replace(**kw), self.t._replace(**kw)
        self.check_state()

    def drop_log(self, cname, title):
        self.j, self.t = JR.drop_log(self.j, cname, title), TR.drop_log(self.t, cname, title)
        self.check_state()

    # the tests/test_fed.py helpers, on both servers
    def enroll_two(self, t0=0.0):
        assert self.send("Ready", "a", now=t0).status == JR.SW
        assert self.send("Ready", "b", now=t0 + 1).status == JR.SW

    def done(self, cname, rnd, seed, now, ns=8, cast=None, tree=None):
        blob = jser.tree_to_bytes(_tree(seed) if tree is None else tree, cast_dtype=cast)
        return self.send("TrainDone", cname, round=rnd, blob=blob, num_samples=ns, now=now)


SCRIPTS = {}


def script(fn):
    SCRIPTS[fn.__name__] = fn
    return fn


@script
def full_session_two_clients_two_rounds():
    p = Pair(_tree(42))
    p.enroll_two()
    assert p.done("a", 1, seed=1, now=2.0).status == JR.RESP_ACY
    assert p.done("b", 1, seed=2, now=3.0).status == JR.RESP_ARY
    p.done("a", 2, seed=3, now=4.0)
    assert p.done("b", 2, seed=4, now=5.0).status == JR.FIN
    p.send("Ready", "a", now=6.0)
    p.done("a", 3, seed=5, now=6.5)
    p.send("VersionPoll", "b", model_version=1, round=2, now=7.0)


@script
def weighted_aggregation_by_sample_count():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0, ns=30)
    p.done("b", 1, seed=2, now=3.0, ns=10)


@script
def late_client_gets_ctw():
    p = Pair(_tree(42))
    p.enroll_two()
    assert p.send("Ready", "late", now=12.0).status == JR.CTW


@script
def stale_round_rejected_not_crash():
    p = Pair(_tree(42))
    p.enroll_two()
    assert p.done("a", 99, seed=1, now=2.0).status == JR.REJECTED
    p.done("stranger", 1, seed=1, now=2.0)
    p.done("a", 1, seed=1, now=2.5)
    p.done("b", 1, seed=2, now=3.0)
    p.done("a", 1, seed=1, now=3.5)  # stale: re-synced NOT_WAIT
    p.done("stranger", 2, seed=1, now=4.0)


@script
def version_poll_wait_then_not_wait():
    p = Pair(_tree(42))
    p.enroll_two()
    assert p.send("VersionPoll", "a", model_version=0, round=1, now=2.0).status == JR.WAIT
    p.done("a", 1, seed=1, now=2.5)
    p.done("b", 1, seed=2, now=3.0)
    assert p.send("VersionPoll", "a", model_version=0, round=1, now=3.5).status == JR.NOT_WAIT


@script
def pull_weights_returns_current_global():
    p = Pair(_tree(42))
    p.enroll_two()
    p.send("PullWeights", "a", now=2.0)
    p.send("TrainingNotice", "a", now=2.0)
    p.done("a", 1, seed=1, now=2.0)
    p.done("b", 1, seed=2, now=3.0)
    p.send("PullWeights", "a", now=4.0)


@script
def deadline_shrinks_cohort():
    p = Pair(_tree(42), round_deadline_s=30.0, max_rounds=3)
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    p.send("Tick", now=50.0)
    assert p.t.cohort == frozenset({"a"})
    p.send("PullWeights", "a", now=51.0)


@script
def log_chunks_accumulate():
    p = Pair(_tree(42))
    p.enroll_two()
    p.send("LogChunk", "a", "events.tb", b"abc", now=2.0, offset=0)
    p.send("LogChunk", "a", "events.tb", b"def", now=2.1, offset=3)
    assert p.t.logs["a/events.tb"] == b"abcdef"


@script
def log_chunk_offsets_idempotent_and_gap_rejected():
    p = Pair({"params": {"w": np.zeros(2, np.float32)}}, cohort_size=1)
    p.send("Ready", "c", now=0.0)
    p.send("LogChunk", cname="c", title="t", data=b"abcd", now=0.0, offset=0)
    p.send("LogChunk", cname="c", title="t", data=b"efgh", now=0.0, offset=4)
    p.send("LogChunk", cname="c", title="t", data=b"efgh", now=0.0, offset=4)
    p.send("LogChunk", cname="c", title="t", data=b"zz", now=0.0, offset=100)
    p.send("LogChunk", cname="c", title="t", data=b"new", now=0.0, offset=0)
    p.drop_log("c", "t")
    p.drop_log("c", "t")


@script
def silent_cohort_deadline_reopens_enrollment():
    p = Pair(_tree(42), round_deadline_s=5.0)
    p.enroll_two()
    p.send("Tick", now=100.0)
    assert p.t.phase == TR.PHASE_ENROLL and p.t.failed_rounds == 1
    p.enroll_two(t0=101.0)
    p.done("a", 1, seed=1, now=102.0)
    assert p.done("b", 1, seed=2, now=103.0).status == JR.RESP_ARY


@script
def silent_cohort_member_can_rejoin_fresh_cohort():
    p = Pair(_tree(42), round_deadline_s=5.0, cohort_size=1)
    p.send("Ready", "a", now=0.0)
    p.send("Tick", now=100.0)
    p.send("Ready", "c", now=101.0)
    assert p.send("Ready", "a", now=102.0).status == JR.SW


@script
def cohort_member_rejoins_after_crash():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    assert p.send("Ready", "b", now=3.0).status == JR.SW
    assert p.send("Ready", "stranger", now=3.5).status == JR.CTW
    assert p.done("b", 1, seed=2, now=4.0).status == JR.RESP_ARY


@script
def rejoin_after_reporting_drops_stale_report():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("b", 1, seed=9, now=2.0)
    p.send("Ready", "b", now=3.0)
    assert p.done("a", 1, seed=1, now=4.0).status == JR.RESP_ACY
    assert p.done("b", 1, seed=2, now=5.0).status == JR.RESP_ARY


@script
def log_chunk_from_non_cohort_rejected():
    p = Pair(_tree(42))
    p.send("LogChunk", "early", "t", b"x", now=0.0)
    p.enroll_two()
    assert p.send("LogChunk", "stranger", "t", b"x", now=2.0).status == JR.REJECTED


@script
def departed_member_readmitted_after_deadline_shrink():
    p = Pair(_tree(42), round_deadline_s=5.0, max_rounds=3)
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    p.send("Tick", now=20.0)
    assert p.t.departed == frozenset({"b"})
    assert p.send("Ready", "b", now=21.0).status == JR.SW
    p.done("a", 2, seed=3, now=22.0)
    assert p.done("b", 2, seed=4, now=23.0).status == JR.RESP_ARY


@script
def log_sink_cap_zero_means_uncapped():
    p = Pair(_tree(42), log_max_mb_per_upload=0, log_max_mb_total=0)
    p.enroll_two()
    assert p.send("LogChunk", "a", "t", b"x" * (2 * 1024 * 1024), now=2.0).status == "OK"


@script
def log_sink_caps_enforced():
    p = Pair(_tree(42), log_max_mb_per_upload=1, log_max_mb_total=2)
    p.enroll_two()
    mib = 1024 * 1024
    p.send("LogChunk", "a", "big", b"x" * mib, now=2.0)
    assert p.send("LogChunk", "a", "big", b"y", now=2.1, offset=mib).status == JR.REJECTED
    p.send("LogChunk", "b", "big", b"x" * mib, now=2.2)
    assert p.send("LogChunk", "a", "more", b"z" * mib, now=2.3).status == JR.REJECTED


def _fedopt_session(uploads, maxulp=1, **kw):
    p = Pair(_fedopt_vars(0.0), maxulp=maxulp, cohort_size=1, max_rounds=3, registration_window_s=1.0, **kw)
    p.send("Ready", cname="a", now=0.0)
    p.send("Tick", now=2.0)
    for rnd, up in enumerate(uploads, start=1):
        p.done("a", rnd, seed=None, now=float(rnd), ns=4, tree=_fedopt_vars(up))
    assert p.t.phase == TR.PHASE_FINISHED or len(uploads) < 3


@script
def fedopt_avg_default_is_plain_fedavg():
    _fedopt_session([5.0, 7.0])


@script
def fedopt_momentum_zero_lr_one_recovers_fedavg():
    _fedopt_session([5.0, 7.0], server_optimizer="momentum", server_lr=1.0, server_momentum=0.0)


@script
def fedopt_fedavgm_closed_form():
    _fedopt_session([5.0, 5.0, 2.0], server_optimizer="fedavgm", server_lr=1.0, server_momentum=0.9)


@script
def fedopt_fedadam():
    _fedopt_session([5.0, 5.0, 4.0], server_optimizer="fedadam", server_lr=0.1)


@script
def fedopt_fedyogi():
    _fedopt_session([5.0, 3.0, 6.0], server_optimizer="fedyogi", server_lr=0.1)


@script
def fedopt_fedadam_two_clients_random_trees():
    p = Pair(_tree(42), server_optimizer="adam", server_lr=0.05, max_rounds=3)
    p.enroll_two()
    for rnd in (1, 2, 3):
        p.done("a", rnd, seed=10 + rnd, now=2.0 * rnd, ns=8)
        p.done("b", rnd, seed=20 + rnd, now=2.0 * rnd + 1, ns=24)


@script
def bf16_broadcast_is_half_size_and_handshake_advertises():
    p = Pair(_tree(42), wire_dtype="bfloat16")
    assert 0 < len(p.t.broadcast_blob) < 0.75 * len(p.t.global_blob)
    assert p.send("Ready", "a", now=0.0).config["wire_dtype"] == "bfloat16"


@script
def bf16_round_math_stays_f32_and_broadcast_matches_average():
    p = Pair(_tree(42), wire_dtype="bfloat16")
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0, cast="bfloat16")
    p.done("b", 1, seed=2, now=3.0, cast="bfloat16")
    p.done("a", 2, seed=3, now=4.0, cast="bfloat16")
    p.done("b", 2, seed=4, now=5.0)


@script
def quorum_default_full_barrier_unchanged():
    p = Pair(_tree(42))
    p.enroll_two()
    assert p.done("a", 1, seed=1, now=2.0).status == JR.RESP_ACY
    assert p.done("b", 1, seed=2, now=3.0).status == JR.RESP_ARY


@script
def quorum_closes_early_and_history_records_it():
    p = Pair(_tree(42), cohort_size=4, quorum_fraction=0.5, max_rounds=3)
    for i, c in enumerate("abcd"):
        p.send("Ready", c, now=float(i))
    p.done("a", 1, seed=1, now=5.0)
    assert p.done("b", 1, seed=2, now=6.0).status == JR.RESP_ARY


@script
def quorum_straggler_resynced_logged_never_averaged():
    p = Pair(_tree(42), cohort_size=2, quorum_fraction=0.5, max_rounds=3)
    p.enroll_two()
    assert p.done("a", 1, seed=1, now=2.0).status == JR.RESP_ARY
    assert p.done("b", 1, seed=2, now=3.0).status == JR.NOT_WAIT
    p.done("b", 2, seed=3, now=4.0)


@script
def quorum_future_round_still_rejected():
    p = Pair(_tree(42), quorum_fraction=0.5)
    p.enroll_two()
    assert p.done("a", 7, seed=1, now=2.0).status == JR.REJECTED


@script
def quorum_deadline_still_backstops_below_quorum():
    p = Pair(_tree(42), cohort_size=3, quorum_fraction=2.0 / 3.0, round_deadline_s=10.0, max_rounds=3)
    for i, c in enumerate("abc"):
        p.send("Ready", c, now=float(i))
    p.done("a", 1, seed=1, now=3.0)
    p.send("Tick", now=50.0)
    assert p.t.departed == frozenset({"b", "c"})


def _poisoned(seed, **leaves):
    bad = _tree(seed)
    bad.update(leaves)
    return bad


@script
def sanitation_nan_update_rejected_and_logged():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=None, now=2.0, tree=_poisoned(1, bias=np.array([np.nan, 1.0, 2.0, 3.0], np.float32)))
    assert "non-finite" in p.t.rejected["a"]


@script
def sanitation_shape_mismatch_rejected():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=None, now=2.0, tree=_poisoned(1, bias=_tree(1)["bias"].reshape(2, 2)))


@script
def sanitation_truncated_and_garbage_rejected():
    p = Pair(_tree(42))
    p.enroll_two()
    good = jser.tree_to_bytes(_tree(1))
    for blob in (good[: len(good) // 2], b"\x00\xff garbage"):
        assert p.send("TrainDone", "a", round=1, blob=blob, num_samples=8, now=2.0).status == JR.REJECTED


@script
def sanitation_negative_sample_count_rejected():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0, ns=-4)


@script
def sanitation_rejection_lands_in_history_and_round_still_completes():
    p = Pair(_tree(42))
    p.enroll_two()
    p.done("a", 1, seed=None, now=2.0, tree=_poisoned(1, bias=np.full(4, np.inf, np.float32)))
    p.done("a", 1, seed=1, now=3.0)
    assert p.done("b", 1, seed=2, now=4.0).status == JR.RESP_ARY
    assert "non-finite" in p.t.history[0]["rejected"]["a"]


@script
def sanitation_bf16_wire_passes():
    p = Pair(_tree(42), wire_dtype="bfloat16")
    p.enroll_two()
    assert p.done("a", 1, seed=1, now=2.0, cast="bfloat16").status == JR.RESP_ACY


@script
def sanitation_can_be_disabled():
    p = Pair(_tree(42), sanitize_updates=False)
    p.enroll_two()
    p.done("a", 1, seed=None, now=2.0, tree=_poisoned(1, bias=np.full(4, np.nan, np.float32)))


@script
def deadline_fires_exactly_at_boundary():
    p = Pair(_tree(42), round_deadline_s=30.0, max_rounds=3, registration_window_s=10.0)
    p.send("Ready", "a", now=0.0)
    p.send("Ready", "b", now=0.0)
    p.done("a", 1, seed=1, now=1.0)
    p.send("Tick", now=30.0)
    assert p.t.current_round == 2
    q = Pair(_tree(42), round_deadline_s=30.0, max_rounds=3, registration_window_s=10.0)
    q.send("Ready", "a", now=0.0)
    q.send("Tick", now=10.0)
    assert q.t.phase == TR.PHASE_RUNNING


@script
def restored_enroll_state_rearms_window():
    p = Pair(_tree(42), cohort_size=3, registration_window_s=10.0)
    p.send("Ready", "a", now=0.0)
    p.replace(enroll_opened_at=None, round_started_at=None)
    p.send("Tick", now=500.0)
    p.send("Tick", now=510.0)
    assert p.t.phase == TR.PHASE_RUNNING


@script
def restored_running_state_rearms_deadline():
    p = Pair(_tree(42), round_deadline_s=10.0, max_rounds=3)
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    p.replace(round_started_at=None, enroll_opened_at=None)
    p.send("Tick", now=1000.0)
    p.send("Tick", now=1010.0)
    assert p.t.current_round == 2


def _robust_session(maxulp, **cfg):
    """Five clients, the last one's update scaled x1000, two rounds."""
    p = Pair(_tree(42), maxulp=maxulp, cohort_size=5, max_rounds=2, **cfg)
    names = "abcde"
    for i, c in enumerate(names):
        p.send("Ready", c, now=float(i))
    for rnd in (1, 2):
        for i, c in enumerate(names):
            tree = _tree(100 * rnd + i)
            if c == "e":
                tree = jax.tree_util.tree_map(lambda v: (v * 1000).astype(np.float32), tree)
            p.done(c, rnd, seed=None, now=10.0 * rnd + i, ns=8 * (i + 1), tree=tree)
    return p


@script
def robust_trimmed_mean():
    _robust_session(0, aggregation="trimmed_mean", trim_fraction=0.2)


@script
def robust_median():
    _robust_session(0, aggregation="median")


@script
def robust_krum():
    _robust_session(0, aggregation="krum", byzantine_f=1)


@script
def robust_multi_krum():
    _robust_session(1, aggregation="multi_krum", byzantine_f=1)


@script
def quarantine_excludes_the_scaled_update():
    p = _robust_session(1, quarantine_z=3.5)
    assert set(p.t.history[0]["quarantined"]) == {"e"}


@script
def quarantine_with_trimmed_mean_and_bf16_wire():
    _robust_session(1, quarantine_z=3.5, aggregation="trimmed_mean", trim_fraction=0.2, wire_dtype="bfloat16")


def _random_event(rng, current_round, now):
    """tests/test_fed.py's TestTransitionProperties event generator."""
    c = rng.choice(["a", "b", "c", "d"])
    kind = rng.randrange(7)
    if kind == 0:
        return ("Ready", (c,), dict(now=now))
    if kind == 1:
        return ("PullWeights", (c,), dict(now=now))
    if kind == 2:
        return ("TrainingNotice", (c,), dict(now=now))
    if kind == 3:
        return ("LogChunk", (c, "t", b"x" * rng.randrange(1, 64)), dict(now=now))
    if kind == 4:
        return ("VersionPoll", (c,), dict(model_version=rng.randrange(4), round=rng.randrange(1, 5), now=now))
    if kind == 5:
        return ("Tick", (), dict(now=now))
    rnd = current_round if rng.random() < 0.7 else rng.randrange(1, 6)
    if rng.random() < 0.25:
        blob = b"garbage" if rng.random() < 0.5 else jser.tree_to_bytes({"bias": np.full(4, np.nan, np.float32)})
    else:
        blob = jser.tree_to_bytes(_tree(rng.randrange(100)))
    return ("TrainDone", (c,), dict(round=rnd, blob=blob, num_samples=rng.choice([0, 4, 8]), now=now))


def _random_interleaving(seed):
    rng = random.Random(seed)
    p = Pair(_tree(42), max_rounds=3, cohort_size=rng.choice([2, 3]), registration_window_s=5.0,
             round_deadline_s=10.0, quorum_fraction=rng.choice([1.0, 0.5, 2.0 / 3.0]))
    now = 0.0
    for _ in range(150):
        now += rng.uniform(0.0, 2.0)
        kind, args, kw = _random_event(rng, p.j.current_round, now)
        p.send(kind, *args, **kw)
    for _ in range(2 * p.cfg["max_rounds"] + 4):
        if p.t.phase != TR.PHASE_RUNNING:
            break
        now += p.cfg["round_deadline_s"] + 1.0
        p.send("Tick", now=now)


for _seed in range(8):
    SCRIPTS[f"random_interleaving_{_seed}"] = (lambda s: lambda: _random_interleaving(s))(_seed)


def _robust_round_at_small_width(seed=0):
    """chip_smoke.py phase 8's script (``drive_federation`` with
    ``robust_round_config()``) at small width through one package; each
    client's fit returns a seeded perturbation of the pulled global,
    encoded with the round's wire cast."""

    def run(R, ser, config):
        global0 = jax_variables(TINY_KW, seed=seed)
        rng = np.random.default_rng(seed)
        deltas = {f"client_{i}": jax.tree_util.tree_map(
            lambda v: rng.normal(0, 0.05, v.shape).astype(np.float32), global0) for i in range(3)}

        def fit(name, blob, rnd, hparams):
            tree = ser.tree_from_bytes(blob, template=global0)
            new = jax.tree_util.tree_map(lambda a, d: (a + d).astype(np.float32), tree, deltas[name])
            cast = "bfloat16" if hparams["wire_dtype"] == "bfloat16" else None
            return ser.tree_to_bytes(new, cast_dtype=cast), 32

        names = sorted(deltas)
        out = chip_smoke.drive_federation(R, ser, config, global0, fit, names, poison=(names[2],))
        chip_smoke.check_robust_round(R, out, names)
        return out

    return run


@script
def chip_smoke_phase8_robust_round_small_width():
    port_cfg = chip_smoke.robust_round_config()
    jax_cfg = JaxFedConfig.from_json(port_cfg.to_json())
    run = _robust_round_at_small_width()
    got = run(TR, tser, port_cfg)
    want = run(JR, jser, jax_cfg)
    assert got["statuses"] == want["statuses"]
    assert got["state"].history == want["state"].history
    assert got["state"].departed == want["state"].departed
    g, w = _leaves(got["state"].global_blob), _leaves(want["state"].global_blob)
    for a, b in zip(g, w):
        _assert_close(a, b, 1, "global")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    for a, b in zip(_leaves(got["rounds"][0]["blob"]), _leaves(want["rounds"][0]["blob"])):
        _assert_close(a, b, 1, "broadcast")


def _codecs(name, cname, **kw):
    """The JAX package's codec and the port's, for one client."""
    from fedcrack_tpu.compress.codecs import get_codec as jax_codec
    from fedcrack_tpu_torch.compress.codecs import get_codec as port_codec

    return jax_codec(name, client_tag=cname, **kw), port_codec(name, client_tag=cname, **kw)


def _framed(p, codecs, cname, rnd, seed, now, ns=8, cast=None, base_version=None):
    """Each package's codec encodes the client's fit against the round
    base its own server broadcasts; the frames must be byte-equal, and the
    one frame goes to both servers."""
    up = jser.tree_to_bytes(_tree(seed), cast_dtype=cast)
    version = p.j.model_version if base_version is None else base_version
    frame = codecs[0].encode_update(up, p.j.broadcast_blob, round=rnd, base_version=version)
    assert codecs[1].encode_update(up, p.t.broadcast_blob, round=rnd, base_version=version) == frame
    return p.send("TrainDone", cname, round=rnd, blob=frame, num_samples=ns, now=now)


def _framed_session(codec_a, codec_b, maxulp=0, **cfg):
    p = Pair(_tree(42), maxulp=maxulp, max_rounds=3, **cfg)
    p.enroll_two()
    ca, cb = _codecs(codec_a, "a", topk_fraction=0.25), _codecs(codec_b, "b", topk_fraction=0.25)
    for rnd in (1, 2, 3):
        assert _framed(p, ca, "a", rnd, seed=10 + rnd, now=2.0 * rnd).status == JR.RESP_ACY
        _framed(p, cb, "b", rnd, seed=20 + rnd, now=2.0 * rnd + 1, ns=24)
    assert [h["codecs"] for h in p.t.history] == [{"a": codec_a, "b": codec_b}] * 3
    assert p.t.phase == TR.PHASE_FINISHED
    return p


for _a, _b in (("int8", "int8"), ("topk_delta", "topk_delta"), ("null", "int8"), ("int8", "topk_delta")):
    SCRIPTS[f"framed_rounds_{_a}_{_b}"] = (lambda a, b: lambda: _framed_session(a, b))(_a, _b)


@script
def framed_rounds_on_a_bf16_wire():
    _framed_session("int8", "topk_delta", maxulp=1, wire_dtype="bfloat16")


@script
def framed_upload_under_null_codec_and_sanitation_off():
    # The server decodes a frame whatever it advertises, and validates it
    # with sanitation off.
    p = Pair(_tree(42), sanitize_updates=False)
    p.enroll_two()
    _framed(p, _codecs("int8", "a"), "a", 1, seed=1, now=2.0)
    p.done("b", 1, seed=2, now=3.0)
    assert p.t.history[0]["codecs"] == {"a": "int8", "b": "null"}


@script
def framed_rejections_give_jax_reasons():
    import zlib

    from fedcrack_tpu.compress import frames as jframes

    p = Pair(_tree(42))
    p.enroll_two()
    codecs = _codecs("int8", "a")
    up = jser.tree_to_bytes(_tree(1))
    good = codecs[0].encode_update(up, p.j.broadcast_blob, round=1, base_version=0)
    flipped = bytearray(good)
    flipped[len(good) // 2] ^= 0x10
    stale = codecs[0].encode_update(up, p.j.broadcast_blob, round=1, base_version=7)
    lying = jframes.encode_frame("int8", 1, 0, [{"shape": [3, 3], "enc": "int8", "scales": b"\0" * 4,
                                                  "bucket": 16384}, {"shape": [4], "enc": "int8"}], b"")
    bomb = jframes.encode_frame("topk", 1, 0, [{"shape": [4], "enc": "topk", "k": 0},
                                              {"shape": [3, 4], "enc": "topk", "k": 0}],
                                zlib.compress(b"\0" * 10**6), compress=False)
    nan = jframes.encode_frame("int8", 1, 0, [{"shape": [4], "enc": "int8", "bucket": 4,
                                               "scales": np.float32([np.nan]).tobytes()},
                                              {"shape": [3, 4], "enc": "int8", "bucket": 16384,
                                               "scales": np.float32([1.0]).tobytes()}], bytes(16))
    for i, frame in enumerate((bytes(flipped), stale, lying, bomb, nan)):
        reply = p.send("TrainDone", "a", round=1, blob=frame, num_samples=8, now=2.0 + i)
        assert reply.status == JR.REJECTED
    assert p.t.ledger["a"]["rejected"] == {"sanitation": 5}
    assert p.send("TrainDone", "a", round=1, blob=good, num_samples=-1, now=8.0).status == JR.REJECTED
    assert "negative sample count" in p.t.rejected["a"]
    _framed(p, codecs, "a", 1, seed=1, now=9.0)
    assert p.done("b", 1, seed=2, now=10.0).status == JR.RESP_ARY


@script
def event_fields_secagg_seed_and_trace_ctx_are_carried():
    p = Pair(_tree(42))
    p.send("Ready", "a", now=0.0, secagg_seed=123)
    assert p.t.secagg_seeds == p.j.secagg_seeds == {}  # kept only under config.secagg
    p.send("Ready", "b", now=1.0, secagg_seed=None)
    # Under secagg the seed is stored as the JAX package stores it,
    # re-enrolls included (the secagg rounds are in test_torch_privacy.py).
    p.j = p.j._replace(config=JaxFedConfig(**CFG, secagg=True))
    p.t = p.t._replace(config=FedConfig(**CFG, secagg=True))
    p.send("Ready", "a", now=1.5, secagg_seed=7)
    p.send("Ready", "b", now=1.6)
    assert p.t.secagg_seeds == p.j.secagg_seeds == {"a": 7}
    p.j = p.j._replace(config=JaxFedConfig(**CFG))
    p.t = p.t._replace(config=FedConfig(**CFG))
    blob = jser.tree_to_bytes(_tree(1))
    p.send("TrainDone", "a", round=1, blob=blob, num_samples=8, now=2.0, trace_ctx="fedtr-v0#push:a:r1")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_event_script_matches_jax(name):
    SCRIPTS[name]()


@pytest.mark.parametrize("codec", ["int8", "topk_delta"])
def test_update_codec_configurations_boot_and_advertise_the_codec(codec):
    kw = dict(CFG, update_codec=codec, topk_fraction=0.05)
    p = Pair(_tree(42), **{k: v for k, v in kw.items() if k not in CFG})
    reply = p.send("Ready", "a", now=0.0)
    assert (reply.config["update_codec"], reply.config["topk_fraction"]) == (codec, 0.05)


@pytest.mark.parametrize("kw", [dict(secagg=True, aggregation="krum"), dict(quorum_fraction=0.0),
                                dict(wire_dtype="float16"), dict(trim_fraction=0.5), dict(cohort_seed=-1)])
def test_configurations_refused_by_both_packages(kw):
    with pytest.raises(ValueError):
        JaxFedConfig(**kw)
    with pytest.raises(ValueError):
        FedConfig(**kw)


def test_frame_upload_is_decoded_validated_and_averaged_as_in_jax():
    """A compressed frame is decoded against the broadcast, validated and
    averaged: the stored blob is the JAX package's reconstruction byte for
    byte, and the history counts the frame's wire bytes and codec."""
    from fedcrack_tpu.compress.codecs import get_codec

    p = Pair(_tree(42), maxulp=0)
    p.enroll_two()
    up = jser.tree_to_bytes(_tree(1))
    frame = get_codec("int8").encode_update(up, p.j.broadcast_blob, round=1, base_version=0)
    assert frame[:4] == b"FCWF"
    assert p.send("TrainDone", "a", round=1, blob=frame, num_samples=8, now=2.0).status == JR.RESP_ACY
    stored = p.t.received["a"][0]
    assert stored != frame and stored[:4] != b"FCWF"
    p.done("b", 1, seed=2, now=3.0)
    (entry,) = p.t.history
    assert entry["codecs"] == {"a": "int8", "b": "null"}
    assert entry["bytes_received"] == len(frame) + len(jser.tree_to_bytes(_tree(2)))
    assert entry["decoded_bytes_received"] == len(stored) + len(jser.tree_to_bytes(_tree(2)))
    off = TR.initial_state(FedConfig(**CFG, sanitize_updates=False), _tree(42))
    got = TR.decode_and_validate_update(frame, 8, template=off.template, base_fn=lambda: _tree(42),
                                        base_version=0, sanitize=False)
    assert got[1:4] == (len(frame), "int8", None) and got[0] == stored


def test_initial_state_takes_tensor_trees_and_quorum_target_matches():
    import torch

    tree = _tree(42)
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert TR.initial_state(FedConfig(**CFG), as_tensors).global_blob == \
        JR.initial_state(JaxFedConfig(**CFG), tree).global_blob
    for q in (1.0, 0.5, 2.0 / 3.0, 0.6, 0.01):
        for n in range(0, 12):
            assert TR.quorum_target(q, n) == JR.quorum_target(q, n)


def test_server_state_fields_are_the_sync_subset_of_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(TR.ServerState)]
    assert port == [(f.name, f.default) for f in dataclasses.fields(JR.ServerState)]
    for event in ("Ready", "PullWeights", "TrainingNotice", "LogChunk", "TrainDone", "VersionPoll", "Tick"):
        fields = [(f.name, f.default) for f in dataclasses.fields(getattr(TR, event))]
        assert fields == [(f.name, f.default) for f in dataclasses.fields(getattr(JR, event))], event
