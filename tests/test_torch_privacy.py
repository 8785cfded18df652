"""The port's privacy plane (fedcrack_tpu_torch/privacy/ and the privacy
arms of fed/rounds.py and fed/buffered.py) held against the JAX package's
``fedcrack_tpu.privacy`` on the CPU.

- The accountant: the same operations in the same order, so every RDP
  vector and epsilon is the same Python float (``==``), besides the JAX
  tests' own pins (the Abadi-regime value 2.0868, the q = 1 closed form,
  monotonicity, the wire round trip).
- ``dp_update_host``: the privatized tree byte-equal to the JAX package's
  over a grid of seeds, names, rounds, clip norms and sigma = 0; tensor
  and bfloat16 leaves too.
- secagg: seeds, pair masks and fixed-point codes equal; every member's
  ``mask_update`` blob byte-equal for cohorts of 2 to 5; ``unmask_sum``
  on every survivor subset of those cohorts equal to the JAX package's
  and to the survivors' plaintext weighted fixed-point sum; the gate's
  reason strings equal on every way a blob can fail.
- The round scripts of tests/test_privacy.py that need no mesh, through
  both ``transition``s with tests/test_torch_rounds.py's ``Pair`` (reply,
  state, history, privacy maps and global checked after every event):
  roster freeze and the notice's roster, a secagg round, a dropout round,
  the rejects, the DP charge, budget exhaustion and the buffered flush.
  tests/test_torch_statefile.py replays them holding the statefile bytes.

Exact throughout: no tolerance in this file.
"""

import itertools
import json
import math

import jax
import numpy as np
import pytest
import torch

import test_torch_rounds as rounds_tests
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu.privacy import accountant as JA
from fedcrack_tpu.privacy import dpsgd as JD
from fedcrack_tpu.privacy import secagg as JS
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed.serialization import packb
from fedcrack_tpu_torch.privacy import accountant as TA
from fedcrack_tpu_torch.privacy import dpsgd as TD
from fedcrack_tpu_torch.privacy import secagg as TS

pytestmark = pytest.mark.torch_port

Pair = rounds_tests.Pair


# ---- the accountant ----

def test_accountant_epsilon_regression_pin():
    eps = TA.compute_epsilon(0.01, 1.1, 1000, 1e-5)
    assert eps == JA.compute_epsilon(0.01, 1.1, 1000, 1e-5)
    assert eps == pytest.approx(2.0867961135743176, rel=1e-9)


def test_accountant_full_batch_closed_form():
    sigma, steps, delta = 1.1, 1000, 1e-5
    expected = min(steps * a / (2.0 * sigma * sigma) + math.log(1.0 / delta) / (a - 1.0)
                   for a in TA.DEFAULT_ORDERS)
    eps = TA.compute_epsilon(1.0, sigma, steps, delta)
    assert eps == JA.compute_epsilon(1.0, sigma, steps, delta)
    assert eps == pytest.approx(expected, rel=1e-12)
    assert eps == pytest.approx(837.9592064567056, rel=1e-9)


def test_accountant_monotone_and_zero():
    eps = [TA.compute_epsilon(0.01, 1.1, t, 1e-5) for t in (0, 1, 10, 100, 1000)]
    assert eps == [JA.compute_epsilon(0.01, 1.1, t, 1e-5) for t in (0, 1, 10, 100, 1000)]
    assert eps[0] == 0.0 and all(a < b for a, b in zip(eps, eps[1:]))
    assert TA.compute_epsilon(0.01, 2.0, 100, 1e-5) < TA.compute_epsilon(0.01, 1.1, 100, 1e-5)


@pytest.mark.parametrize("q,sigma,steps,delta", [
    (0.01, 1.1, 1, 1e-5), (0.01, 0.5, 40, 1e-6), (0.25, 1.1, 7, 1e-5), (0.999, 3.0, 3, 1e-3),
    (0.0, 1.1, 5, 1e-5), (1.0, 0.8, 12, 1e-5),
])
def test_rdp_vectors_and_epsilons_are_the_same_floats(q, sigma, steps, delta):
    rdp = TA.rdp_subsampled_gaussian(q, sigma, steps)
    assert rdp == JA.rdp_subsampled_gaussian(q, sigma, steps)
    assert TA.rdp_to_epsilon(rdp, TA.DEFAULT_ORDERS, delta) == JA.rdp_to_epsilon(rdp, JA.DEFAULT_ORDERS, delta)
    assert TA.DEFAULT_ORDERS == JA.DEFAULT_ORDERS


def test_accountant_class_tracks_per_client_and_round_trips_wire():
    port, ref = (A.PrivacyAccountant(noise_multiplier=1.1, sample_rate=0.01, delta=1e-5) for A in (TA, JA))
    for acct in (port, ref):
        acct.record(["a", "b"], steps=3)
        acct.record(["a"], steps=2)
    assert port.epsilon_of("a") > port.epsilon_of("b") > 0.0
    assert port.epsilon_of("a") == TA.compute_epsilon(0.01, 1.1, 5, 1e-5)
    assert (port.epsilons(), port.max_epsilon(), port.summary(), port.to_wire()) == \
           (ref.epsilons(), ref.max_epsilon(), ref.summary(), ref.to_wire())
    twin = TA.PrivacyAccountant(noise_multiplier=1.1, sample_rate=0.01, delta=1e-5)
    twin.load_wire(ref.to_wire())
    assert twin.epsilons() == port.epsilons()
    for bad in (dict(noise_multiplier=1.1, sample_rate=0.01, delta=0.0),):
        for A in (TA, JA):
            with pytest.raises(ValueError):
                A.PrivacyAccountant(**bad)


# ---- update-level DP on the host ----

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"params": {"conv": {"kernel": (scale * rng.normal(size=(3, 3, 2, 4))).astype(np.float32),
                                "bias": (scale * rng.normal(size=(4,))).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": (scale * rng.normal(size=(4,))).astype(np.float32)}}}


def _leaf_bytes(tree):
    out = []
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.int16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        out.append((np.asarray(leaf).shape, np.asarray(leaf).tobytes()))
    return out


@pytest.mark.parametrize("clip", [0.01, 1.0, 100.0])
@pytest.mark.parametrize("sigma", [0.0, 1.1])
def test_dp_update_host_is_byte_equal_to_jax(clip, sigma):
    """A grid of seeds, names and rounds at each clip norm and sigma (the
    trained tree's delta has norm ~6: the small clip scales it, the large
    one passes it through)."""
    base, trained = _tree(1), _tree(2)
    for dp_seed, cname, rnd in itertools.product((0, 7, 2**40), ("a", "client_1"), (1, 3)):
        kw = dict(clip_norm=clip, noise_multiplier=sigma, dp_seed=dp_seed, cname=cname, round_idx=rnd)
        got, want = TD.dp_update_host(trained, base, **kw), JD.dp_update_host(trained, base, **kw)
        assert _leaf_bytes(got) == _leaf_bytes(want), kw
        assert TD._host_seed(dp_seed, cname, rnd) == JD._host_seed(dp_seed, cname, rnd)


def test_dp_update_host_takes_tensor_and_bfloat16_leaves():
    """Leaves decoded by ``tree_from_bytes`` are numpy arrays, or CPU
    bfloat16 tensors for a bfloat16 wire: each comes back in its own leaf
    type and dtype with the JAX package's bits."""
    import ml_dtypes

    base, trained = _tree(3), _tree(4)
    kw = dict(clip_norm=0.5, noise_multiplier=1.1, dp_seed=5, cname="c", round_idx=2)
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, trained)
    got = TD.dp_update_host(as_tensors, base, **kw)
    assert all(isinstance(x, torch.Tensor) for x in jax.tree_util.tree_leaves(got))
    assert _leaf_bytes(got) == _leaf_bytes(JD.dp_update_host(trained, base, **kw))
    bf_t = jax.tree_util.tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), trained)
    bf_b = jax.tree_util.tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), base)
    got = TD.dp_update_host(bf_t, bf_b, **kw)
    want = JD.dp_update_host(*(jax.tree_util.tree_map(lambda x: x.float().numpy().astype(ml_dtypes.bfloat16), t)
                               for t in (bf_t, bf_b)), **kw)
    assert [x.dtype for x in jax.tree_util.tree_leaves(got)] == [torch.bfloat16] * 3
    assert [x.view(torch.int16).numpy().tobytes() for x in jax.tree_util.tree_leaves(got)] == \
           [np.asarray(x).view(np.int16).tobytes() for x in jax.tree_util.tree_leaves(want)]


def test_dp_clip_closed_form_and_leaf_mismatch():
    base = {"params": {"w": np.zeros(4, np.float32)}}
    out = TD.dp_update_host({"params": {"w": np.float32([10.0, 0, 0, 0])}}, base, clip_norm=1.0,
                            noise_multiplier=0.0, dp_seed=7, cname="a", round_idx=1)
    np.testing.assert_array_equal(out["params"]["w"], np.float32([1.0, 0, 0, 0]))
    for D in (TD, JD):
        with pytest.raises(ValueError, match="trained/base leaf mismatch: 2 vs 1"):
            D.dp_update_host({"a": np.zeros(2, np.float32), "b": np.zeros(1, np.float32)}, base, clip_norm=1.0,
                             noise_multiplier=0.0, dp_seed=0, cname="a", round_idx=1)


# ---- secure aggregation ----

def _cohort(n):
    return [f"c{i}" for i in range(n)]


def test_seeds_rosters_and_pair_masks_equal_jax():
    names = ["a", "b", "worker-17", "edge/0"]
    assert [TS.client_seed(n) for n in names] == [JS.client_seed(n) for n in names]
    assert all(0 <= TS.client_seed(n) < 2**63 for n in names)
    assert TS.client_seed("a", nonce=3) == JS.client_seed("a", nonce=3)
    roster = {n: TS.client_seed(n) for n in names}
    for rnd in (1, 2, 17):
        assert TS.round_roster(roster, rnd) == JS.round_roster(roster, rnd)
    assert TS.round_roster(roster, 1) != TS.round_roster(roster, 2)
    assert TS.pair_seed("a", 1, "b", 2) == TS.pair_seed("b", 2, "a", 1) == JS.pair_seed("a", 1, "b", 2)
    shapes = [(5,), (2, 3), ()]
    for got, want in zip(TS.pair_mask(99, shapes), JS.pair_mask(99, shapes)):
        assert got.dtype == np.uint64 and got.tobytes() == want.tobytes() and got.shape == want.shape


def test_fixed_point_codes_equal_jax_and_round_trip():
    tree = _tree(5)
    for bits in (8, 24, 52):
        enc = TS.fixed_point_encode(tree, bits)
        assert [a.tobytes() for a in enc] == [a.tobytes() for a in JS.fixed_point_encode(tree, bits)]
        dec = TS.fixed_point_decode(enc, 3, bits, tree)
        assert _leaf_bytes(dec) == _leaf_bytes(JS.fixed_point_decode(enc, 3, bits, tree))
    # Tensor leaves encode as their numpy values do.
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert [a.tobytes() for a in TS.fixed_point_encode(as_tensors)] == \
           [a.tobytes() for a in JS.fixed_point_encode(tree)]


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_mask_update_blobs_byte_equal_jax(n):
    names = _cohort(n)
    roster = TS.round_roster({c: TS.client_seed(c) for c in names}, 4)
    for i, name in enumerate(names):
        tree = _tree(10 + i)
        blob = TS.mask_update(tree, cname=name, n_samples=5 + i, roster=roster)
        assert blob == JS.mask_update(tree, cname=name, n_samples=5 + i, roster=roster)
        assert TS.is_masked_blob(blob) and not TS.is_masked_blob(jser.tree_to_bytes(tree))
        got, want = TS.decode_masked(blob), JS.decode_masked(blob)
        assert (got["bits"], got["n"], got["cohort"]) == (want["bits"], want["n"], want["cohort"])
        assert [a.tobytes() for a in got["leaves"]] == [np.asarray(a).tobytes() for a in want["leaves"]]
    for S in (TS, JS):
        with pytest.raises(ValueError, match="not in the masking roster"):
            S.mask_update(_tree(0), cname="stranger", n_samples=1, roster=roster)
        with pytest.raises(ValueError, match="n_samples must be positive"):
            S.mask_update(_tree(0), cname=names[0], n_samples=0, roster=roster)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_unmask_sum_on_every_dropout_subset(n):
    """Every non-empty survivor subset of an n-member cohort: the port's
    unmasked sum equals the JAX package's and the survivors' plaintext
    weighted fixed-point sum, and the mean decodes identically."""
    names = _cohort(n)
    roster = TS.round_roster({c: TS.client_seed(c) for c in names}, 2)
    trees = {c: _tree(20 + i) for i, c in enumerate(names)}
    samples = {c: 3 + 2 * i for i, c in enumerate(names)}
    docs = {c: TS.decode_masked(TS.mask_update(trees[c], cname=c, n_samples=samples[c], roster=roster))
            for c in names}
    for k in range(1, n + 1):
        for survivors in itertools.combinations(names, k):
            uploads = {c: docs[c] for c in survivors}
            total, total_samples, dropped = TS.unmask_sum(uploads, roster)
            j_total, j_samples, j_dropped = JS.unmask_sum(uploads, roster)
            assert (total_samples, dropped) == (j_samples, j_dropped) == \
                   (sum(samples[c] for c in survivors), sorted(set(names) - set(survivors)))
            plain = TS.weighted_fixed_sum([trees[c] for c in survivors], [samples[c] for c in survivors])
            assert [a.tobytes() for a in total] == [a.tobytes() for a in j_total] == [a.tobytes() for a in plain]
            mean = TS.unmasked_mean(total, total_samples, trees[names[0]])
            assert _leaf_bytes(mean) == _leaf_bytes(JS.unmasked_mean(j_total, j_samples, trees[names[0]]))
    for S in (TS, JS):
        with pytest.raises(ValueError, match="zero uploads"):
            S.unmask_sum({}, roster)
        with pytest.raises(ValueError, match="outside the roster"):
            S.unmask_sum({"stranger": docs[names[0]]}, roster)
        with pytest.raises(ValueError, match="total_samples must be positive"):
            S.unmasked_mean([], 0, {})


def _gate_cases():
    tree = {"w": np.zeros(4, np.float32), "b": np.zeros((2, 2), np.float32)}
    roster = TS.round_roster({"a": 1, "b": 2}, 1)
    good = TS.mask_update(tree, cname="a", n_samples=3, roster=roster)
    doc = TS.decode_masked(good)

    def masked(**over):
        return TS.SECAGG_MAGIC + packb({**doc, **over})

    return tree, roster, {
        "good": (good, 24, roster),
        "plaintext": (jser.tree_to_bytes(tree), 24, roster),
        "undecodable": (TS.SECAGG_MAGIC + b"\xc1garbage", 24, roster),
        "truncated": (good[:-3], 24, roster),
        "missing_fields": (TS.SECAGG_MAGIC + packb({"bits": 24}), 24, roster),
        "bits": (good, 16, roster),
        "roster": (good, 24, {"a": 1, "c": 9}),
        "leaf_count": (masked(leaves=doc["leaves"][:1]), 24, roster),
        "dtype": (masked(leaves=[doc["leaves"][0].astype(np.int64), doc["leaves"][1]]), 24, roster),
        "shape": (masked(leaves=[doc["leaves"][0].reshape(4), doc["leaves"][1]]), 24, roster),
        "bfloat16": (masked(leaves=[doc["leaves"][0], torch.zeros(4, dtype=torch.bfloat16)]), 24, roster),
    }


@pytest.mark.parametrize("case", ["good", "plaintext", "undecodable", "truncated", "missing_fields", "bits", "roster",
                                  "leaf_count", "dtype", "shape", "bfloat16"])
def test_validate_masked_reasons_equal_jax(case):
    tree, _, cases = _gate_cases()
    blob, bits, cohort = cases[case]
    got = TS.validate_masked(blob, tree, bits=bits, cohort=cohort)
    assert got == JS.validate_masked(blob, tree, bits=bits, cohort=cohort)
    assert (got is None) == (case == "good")


# ---- the round scripts, through both transitions ----

PRIVACY_SCRIPTS = {}


def script(fn):
    PRIVACY_SCRIPTS[fn.__name__] = fn
    return fn


SECAGG = dict(cohort_size=3, max_rounds=1, registration_window_s=1.0, secagg=True, quarantine_z=0.0,
              update_codec="null", aggregation="fedavg", mode="sync")
TMPL = {"w": np.zeros(6, np.float32)}


def _enroll(p, names, with_seeds=True):
    for n in names:
        p.send("Ready", n, now=0.0, secagg_seed=JS.client_seed(n) if with_seeds else None)
    p.send("Tick", now=p.cfg["registration_window_s"] + 1.0)


def _masked(p, name, tree, ns, bits=None):
    roster = JS.round_roster(p.j.secagg_roster, p.j.current_round)
    return JS.mask_update(tree, cname=name, n_samples=ns, roster=roster, bits=bits or p.j.config.secagg_bits)


def _check_privacy(p):
    assert TR.privacy_summary(p.t) == JR.privacy_summary(p.j)
    if p.j.config.dp_noise_multiplier > 0:
        assert TR._epsilons_for(p.t.config, p.t.privacy_steps) == JR._epsilons_for(p.j.config, p.j.privacy_steps)


@script
def secagg_roster_freezes_at_running_and_notice_distributes_it():
    p = Pair(TMPL, **SECAGG)
    p.send("TrainingNotice", "a", now=0.0)  # before enrollment closes: no roster
    _enroll(p, ["a", "b", "c"])
    assert p.t.phase == TR.PHASE_RUNNING and p.t.secagg_roster["a"] == JS.client_seed("a")
    reply = p.send("TrainingNotice", "a", now=2.0)
    assert json.loads(reply.config["__secagg_roster"]) == dict(p.t.secagg_roster)
    p.send("TrainingNotice", "stranger", now=2.0)
    q = Pair(TMPL, **SECAGG)
    _enroll(q, ["a", "b", "c"], with_seeds=False)
    assert dict(q.t.secagg_roster) == dict(p.t.secagg_roster)
    _check_privacy(p)


@script
def secagg_round_closes_to_exact_fixed_point_mean():
    p = Pair(TMPL, **SECAGG)
    _enroll(p, ["a", "b", "c"])
    trees = {n: {"w": np.full(6, v, np.float32)} for n, v in (("a", 1.0), ("b", 3.0), ("c", 5.0))}
    ns = {"a": 10, "b": 30, "c": 20}
    for name in ("a", "b", "c"):
        p.send("TrainDone", name, round=1, blob=_masked(p, name, trees[name], ns[name]), num_samples=ns[name],
               now=2.0)
    assert p.t.phase == TR.PHASE_FINISHED and p.t.history[-1]["secagg"]["recovered"] == []
    want = TS.fixed_point_decode(TS.weighted_fixed_sum([trees[n] for n in "abc"], [10, 30, 20]), 60, 24, TMPL)
    assert p.t.global_blob == p.j.global_blob == jser.tree_to_bytes(want)
    _check_privacy(p)


@script
def secagg_dropout_round_recovers_and_matches_survivor_mean():
    p = Pair(TMPL, **SECAGG, quorum_fraction=0.67, round_deadline_s=5.0)
    _enroll(p, ["a", "b", "c"])
    rng = np.random.default_rng(3)
    trees = {n: {"w": rng.normal(size=6).astype(np.float32)} for n in ("a", "b")}
    for name in ("a", "b"):
        p.send("TrainDone", name, round=1, blob=_masked(p, name, trees[name], 10), num_samples=10, now=2.0)
    assert p.t.phase == TR.PHASE_RUNNING
    p.send("Tick", now=100.0)
    assert p.t.phase == TR.PHASE_FINISHED
    assert p.t.history[-1]["secagg"] == {"maskers": ["a", "b"], "recovered": ["c"], "bits": 24}
    want = TS.fixed_point_decode(TS.weighted_fixed_sum([trees["a"], trees["b"]], [10, 10]), 20, 24, TMPL)
    assert p.t.global_blob == jser.tree_to_bytes(want)


@script
def secagg_rejects_plaintext_wrong_bits_wrong_count_and_stale_roster():
    p = Pair(TMPL, **{**SECAGG, "max_rounds": 2})
    _enroll(p, ["a", "b", "c"])
    tree = {"w": np.ones(6, np.float32)}
    assert p.send("TrainDone", "a", round=1, blob=jser.tree_to_bytes(tree), num_samples=10,
                  now=2.0).status == JR.REJECTED
    assert p.send("TrainDone", "b", round=1, blob=_masked(p, "b", tree, 10, bits=16), num_samples=10,
                  now=2.0).status == JR.REJECTED
    assert p.send("TrainDone", "c", round=1, blob=_masked(p, "c", tree, 10), num_samples=25,
                  now=2.0).status == JR.REJECTED
    stale = JS.mask_update(tree, cname="a", n_samples=10, roster=JS.round_roster({"a": 1, "b": 2}, 1))
    assert p.send("TrainDone", "a", round=1, blob=stale, num_samples=10, now=2.5).status == JR.REJECTED
    for name in ("a", "b", "c"):
        p.send("TrainDone", name, round=1, blob=_masked(p, name, tree, 10), num_samples=10, now=3.0)
    assert set(p.t.history[-1]["rejected"]) == {"a", "b", "c"}
    # Round 2 masks against the same roster with the round mixed in; a
    # round-1 mask replayed in round 2 unmasks to garbage, so it must differ.
    assert _masked(p, "a", tree, 10) != JS.mask_update(
        tree, cname="a", n_samples=10, roster=JS.round_roster(p.j.secagg_roster, 1))


DP = dict(cohort_size=2, max_rounds=3, registration_window_s=1.0, dp_clip_norm=1.0, dp_noise_multiplier=1.1,
          dp_sample_rate=0.01, dp_steps_per_round=4, dp_delta=1e-5)


def _dp_round(p, now):
    rnd = p.j.current_round
    for n in sorted(p.j.cohort):
        p.send("TrainDone", n, round=rnd, blob=jser.tree_to_bytes({"w": np.full(6, 0.5, np.float32)}),
               num_samples=10, now=now)


@script
def dp_epsilon_charged_into_history_and_summary():
    p = Pair(TMPL, **DP)
    _enroll(p, ["a", "b"], with_seeds=False)
    _dp_round(p, 2.0)
    assert dict(p.t.privacy_steps) == {"a": 4, "b": 4}
    assert p.t.history[-1]["epsilon"]["a"] == round(TA.compute_epsilon(0.01, 1.1, 4, 1e-5), 6)
    _dp_round(p, 3.0)
    assert dict(p.t.privacy_steps) == {"a": 8, "b": 8} and "epsilon_budget_exhausted" not in p.t.history[-1]
    _check_privacy(p)


@script
def dp_budget_exhaustion_finishes_loudly():
    eps1, eps2 = (TA.compute_epsilon(0.01, 1.1, t, 1e-5) for t in (4, 8))
    p = Pair(TMPL, **DP, dp_epsilon_budget=(eps1 + eps2) / 2.0)
    _enroll(p, ["a", "b"], with_seeds=False)
    _dp_round(p, 2.0)
    assert p.t.phase == TR.PHASE_RUNNING
    _dp_round(p, 3.0)
    assert p.t.phase == TR.PHASE_FINISHED and p.t.history[-1]["epsilon_budget_exhausted"] is True
    p.send("VersionPoll", "a", model_version=1, round=2, now=4.0)
    _check_privacy(p)


@script
def dp_steps_default_to_local_epochs_and_secagg_with_dp():
    p = Pair(TMPL, **{**SECAGG, "cohort_size": 2, "dp_clip_norm": 1.0, "dp_noise_multiplier": 0.9,
                      "local_epochs": 3})
    _enroll(p, ["a", "b"])
    for name in ("a", "b"):
        p.send("TrainDone", name, round=1, blob=_masked(p, name, {"w": np.full(6, 0.25, np.float32)}, 4),
               num_samples=4, now=2.0)
    assert dict(p.t.privacy_steps) == {"a": 3, "b": 3} and "secagg" in p.t.history[-1]
    _check_privacy(p)


def _buffered_script(budget):
    def run():
        p = Pair(TMPL, mode="buffered", buffer_k=2, cohort_size=2, max_rounds=5, registration_window_s=1.0,
                 dp_clip_norm=1.0, dp_noise_multiplier=1.1, dp_sample_rate=0.01, dp_steps_per_round=3,
                 dp_delta=1e-5, dp_epsilon_budget=budget)
        _enroll(p, ["a", "b"], with_seeds=False)
        for n in ("a", "b"):
            p.send("PullWeights", n, now=1.5)
        blob = jser.tree_to_bytes({"w": np.full(6, 0.5, np.float32)})
        for n in ("a", "b"):
            p.send("TrainDone", n, round=1, blob=blob, num_samples=10, now=2.0)
        assert dict(p.t.privacy_steps) == {"a": 3, "b": 3}
        assert p.t.history[-1]["epsilon"]["a"] == round(TA.compute_epsilon(0.01, 1.1, 3, 1e-5), 6)
        assert (p.t.phase == TR.PHASE_FINISHED) == (budget > 0)
        if budget > 0:
            assert p.t.history[-1]["epsilon_budget_exhausted"] is True
        _check_privacy(p)

    return run


PRIVACY_SCRIPTS["buffered_flush_charges_epsilon"] = _buffered_script(0.0)
PRIVACY_SCRIPTS["buffered_flush_exhausts_a_tight_budget"] = _buffered_script(0.5)


@pytest.mark.parametrize("name", sorted(PRIVACY_SCRIPTS))
def test_privacy_script_matches_jax(name):
    PRIVACY_SCRIPTS[name]()
