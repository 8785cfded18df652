"""The port's server-side math held against the JAX package on the CPU:
the robust folds (fed/aggregation.py), the health ledger
(health/ledger.py), seeded cohort sampling and FedOpt (fed/algorithms.py).

Tolerances: trimmed mean, median and Krum run the JAX package's numpy
expressions and agree bitwise (Krum selects the same client); Multi-Krum
means through FedAvg, within 1 float32 ulp (tests/test_torch_fed.py);
ledger norms, cosines and scores are rounded to 6 places on both sides and
held to 1e-6. FedOpt: the same float32 expressions in numpy against the
JAX package's XLA ones; measured bitwise equal over three steps on the
CPU for every variant, and held to 1 float32 ulp per element and 1e-6 of
each leaf's largest value (XLA may contract ``a*x + b*y`` into a fused
multiply-add on another host, which numpy rounds twice).
"""

import jax
import numpy as np
import pytest

from torch_port_helpers import TINY_KW, flat_tree, jax_variables

pytestmark = pytest.mark.torch_port


def _cohort(n, seed, poisoned=()):
    """n client trees around one global: small seeded perturbations, with
    the ``poisoned`` indices scaled by 1000 (a finite, shape-correct
    attack that only robust folds keep out)."""
    rng = np.random.default_rng(seed)
    base = jax_variables(TINY_KW, seed=seed)
    trees = []
    for i in range(n):
        scale = 1000.0 if i in poisoned else 1.0
        trees.append(jax.tree_util.tree_map(
            lambda v: (v + scale * rng.normal(0, 1e-2, v.shape)).astype(np.float32), base))
    return base, trees


def _triples(trees, weights=None):
    weights = weights or [8 * (i + 1) for i in range(len(trees))]
    return [(f"client_{i}", w, t) for i, (w, t) in enumerate(zip(weights, trees))]


def _assert_bitwise(got, want):
    g, w = dict(flat_tree(got)), dict(flat_tree(want))
    assert set(g) == set(w)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert g[path].tobytes() == w[path].tobytes(), path


@pytest.mark.parametrize(
    "kind,n,param",
    [("trimmed_mean", 3, 0.34), ("trimmed_mean", 5, 0.2), ("trimmed_mean", 4, 0.0),
     ("trimmed_mean", 7, 0.45), ("median", 3, None), ("median", 4, None),
     ("coordinate_median", 6, None), ("krum", 3, 1), ("krum", 5, 1), ("krum", 6, 2),
     ("krum", 1, 1)],
)
def test_robust_folds_bitwise_equal_to_jax(kind, n, param):
    from fedcrack_tpu.fed import aggregation as jagg
    from fedcrack_tpu_torch.fed import aggregation as tagg

    _, trees = _cohort(n, seed=n, poisoned=(n - 1,) if n > 2 else ())
    kw = {"aggregation": kind}
    if kind == "trimmed_mean":
        kw["trim_fraction"] = param
    if kind == "krum":
        kw["byzantine_f"] = param
    cfg = type("Cfg", (), kw)()
    want = jagg.fold(jagg.from_config(cfg), _triples(trees))
    got = tagg.fold(tagg.from_config(cfg), _triples(trees))
    assert repr(tagg.from_config(cfg)) == repr(jagg.from_config(cfg))
    _assert_bitwise(got, want)
    if kind == "krum":
        chosen = [i for i, t in enumerate(trees) if all(
            a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(flat_tree(got), flat_tree(t)))]
        assert len(chosen) == 1 and chosen[0] != n - 1 or n == 1


@pytest.mark.parametrize("n,f", [(4, 1), (5, 2), (6, 1)])
def test_multi_krum_within_an_ulp_and_same_selection(n, f):
    from fedcrack_tpu.fed import aggregation as jagg
    from fedcrack_tpu_torch.fed import aggregation as tagg

    _, trees = _cohort(n, seed=10 + n, poisoned=(0,))
    jk, tk = jagg.Krum(f, multi=True), tagg.Krum(f, multi=True)
    vecs = [np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(t)])
            for t in trees]
    assert tk._scores(vecs) == jk._scores(vecs)
    want = jagg.fold(jk, _triples(trees))
    got = tagg.fold(tk, _triples(trees))
    g, w = dict(flat_tree(got)), dict(flat_tree(want))
    for path in w:
        np.testing.assert_array_max_ulp(g[path], np.asarray(w[path]), maxulp=1)


def test_krum_ties_break_on_name_then_index_in_both():
    from fedcrack_tpu.fed import aggregation as jagg
    from fedcrack_tpu_torch.fed import aggregation as tagg

    same = {"w": np.ones(3, np.float32)}
    other = {"w": np.full(3, 2.0, np.float32)}
    triples = [("b", 1, same), ("a", 1, {"w": np.ones(3, np.float32)}), ("c", 1, other)]
    want = jagg.fold(jagg.Krum(0), triples)
    got = tagg.fold(tagg.Krum(0), triples)
    assert got is triples[1][2] and want is triples[1][2]


def test_factory_and_refusals_match_jax():
    from fedcrack_tpu.fed import aggregation as jagg
    from fedcrack_tpu_torch.fed import aggregation as tagg

    assert tagg.AGGREGATIONS == jagg.AGGREGATIONS
    for kind in tagg.AGGREGATIONS:
        cfg = type("Cfg", (), {"aggregation": kind})()
        assert repr(tagg.from_config(cfg)) == repr(jagg.from_config(cfg))
    assert repr(tagg.from_config(object())) == "FedAvg('fedavg')"
    for mod in (tagg, jagg):
        with pytest.raises(ValueError, match="unknown aggregation"):
            mod.from_config(type("Cfg", (), {"aggregation": "mean_of_medians"})())
        with pytest.raises(ValueError, match="trim_fraction"):
            mod.TrimmedMean(0.5)
        with pytest.raises(ValueError, match="byzantine_f"):
            mod.Krum(-1)
        for algebra in (mod.TrimmedMean(), mod.CoordinateMedian(), mod.Krum()):
            with pytest.raises(ValueError, match="zero updates"):
                mod.fold(algebra, [])


@pytest.mark.parametrize("n,poisoned", [(3, (2,)), (5, (1,)), (4, ()), (2, (0,)), (1, ())])
def test_observe_flush_and_quarantine_match_jax(n, poisoned):
    from fedcrack_tpu.fed import aggregation as jagg
    from fedcrack_tpu.health import ledger as jl
    from fedcrack_tpu_torch.fed import aggregation as tagg
    from fedcrack_tpu_torch.health import ledger as tl

    base, trees = _cohort(n, seed=20 + n, poisoned=poisoned)
    names = [f"c{i}" for i in range(n)]
    items = list(zip(names, trees))
    start = {"c0": jl.new_record()}
    start["c0"]["cosines"] = [0.5] * 8
    want_ledger, want = jl.observe_flush(start, items, base)
    got_ledger, got = tl.observe_flush(start, items, base)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6)
        assert got_ledger[name]["cosines"] == pytest.approx(want_ledger[name]["cosines"], abs=1e-6)
        assert got_ledger[name]["flags"] == want_ledger[name]["flags"]
    for g, w in zip(tl.cohort_geometry(items, base), jl.cohort_geometry(items, base)):
        assert g[0] == w[0] and g[1:] == pytest.approx(w[1:], abs=1e-6)
    for name, tree in items:
        assert tl.update_norm(tree, base) == pytest.approx(jl.update_norm(tree, base), abs=1e-6)
    for z in (0.0, 1.0, 3.5, 1e9):
        assert tagg.quarantine_set(got, names, z) == jagg.quarantine_set(want, names, z)
    if poisoned and n >= 3:
        assert tagg.quarantine_set(got, names, 3.5) == {f"c{poisoned[0]}": got[f"c{poisoned[0]}"]}


def test_ledger_offers_and_robust_z_match_jax():
    from fedcrack_tpu.health import ledger as jl
    from fedcrack_tpu_torch.health import ledger as tl

    assert tl.new_record() == jl.new_record()
    assert (tl.LEDGER_WINDOW, tl.ANOMALY_ALERT, tl.SCORE_CAP) == (jl.LEDGER_WINDOW, jl.ANOMALY_ALERT, jl.SCORE_CAP)
    script = [
        ("a", dict(outcome="accepted", num_samples=8, wire_len=100, round=1, norm=0.1234567)),
        ("a", dict(outcome="rejected", reason_class="sanitation", round=2)),
        ("b", dict(outcome="resync", num_samples=4, round=1, staleness=2)),
        ("b", dict(outcome="rejected", reason_class="made_up", round=3)),
    ] + [("a", dict(outcome="accepted", num_samples=-1, round=r, norm=float(r))) for r in range(10)]
    got, want = {}, {}
    for name, kw in script:
        got = tl.record_offer(got, name, **kw)
        want = jl.record_offer(want, name, **kw)
    got, want = tl.record_quarantine(got, "b"), jl.record_quarantine(want, "b")
    assert got == want
    with pytest.raises(ValueError, match="outcome"):
        tl.record_offer({}, "a", outcome="lost")
    for values in ([], [1.0], [1.0, 1.0, 1.0], [0.1, 0.11, 0.09, 50.0], [-3.0, 2.0, 1e9]):
        assert tl.robust_z(values) == jl.robust_z(values)


@pytest.mark.parametrize(
    "n,k,rnd,seed", [(500, 64, 17, 42), (10, 10, 5, 0), (200, 33, 0, 7), (1000, 1, 3, 99)]
)
def test_sample_cohort_matches_jax_exactly(n, k, rnd, seed):
    from fedcrack_tpu.fed.algorithms import sample_cohort as jax_sample
    from fedcrack_tpu_torch.fed.algorithms import sample_cohort

    got = sample_cohort(n, k, rnd, seed=seed)
    want = jax_sample(n, k, rnd, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sample_cohort_refuses_what_jax_refuses():
    from fedcrack_tpu_torch.fed.algorithms import sample_cohort

    with pytest.raises(ValueError, match="n_clients"):
        sample_cohort(0, 1, 0)
    with pytest.raises(ValueError, match="cohort_size"):
        sample_cohort(10, 0, 0)
    with pytest.raises(ValueError, match="cohort_size"):
        sample_cohort(10, 11, 0)


@pytest.mark.parametrize(
    "kind,lr,momentum",
    [("momentum", 1.0, 0.9), ("fedavgm", 0.7, 0.0), ("fedadam", 0.01, 0.9), ("adam", 0.1, 0.9),
     ("fedyogi", 0.01, 0.9), ("yogi", 0.1, 0.9)],
)
def test_server_optimizers_three_steps_match_jax(kind, lr, momentum):
    from fedcrack_tpu.fed import algorithms as ja
    from fedcrack_tpu_torch.fed import algorithms as ta

    rng = np.random.default_rng(30)
    params = jax_variables(TINY_KW, seed=30)["params"]
    jtx = ja.make_server_optimizer(kind, lr, momentum)
    ttx = ta.make_server_optimizer(kind, lr, momentum)
    jp, tp = params, params
    jstate, tstate = jtx.init(params), ttx.init(params)
    for step in range(3):
        avg = jax.tree_util.tree_map(
            lambda v: (v + rng.normal(0, 0.05 * (step + 1), v.shape)).astype(np.float32), params)
        jp, jstate = ja.apply_server_opt(jp, avg, jtx, jstate)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        tp, tstate = ta.apply_server_opt(tp, avg, ttx, tstate)
        g, w = dict(flat_tree(tp)), dict(flat_tree(jp))
        for path in w:
            assert g[path].dtype == np.float32
            np.testing.assert_allclose(g[path], w[path], rtol=0, atol=1e-6 * np.abs(w[path]).max(),
                                       err_msg=f"{kind} step {step} {path}")
            np.testing.assert_array_max_ulp(g[path], w[path], maxulp=1)
    # the state is a tuple of float32 numpy trees of the params' structure
    assert all(isinstance(x, dict) for x in tstate)


def test_server_optimizer_kinds_and_refusal_match_jax():
    from fedcrack_tpu.fed import algorithms as ja
    from fedcrack_tpu_torch.fed import algorithms as ta

    for kind in ("", "avg", "fedavg", "none"):
        assert ta.make_server_optimizer(kind) is None and ja.make_server_optimizer(kind) is None
    for mod in (ta, ja):
        with pytest.raises(ValueError, match="unknown server optimizer"):
            mod.make_server_optimizer("adagrad")
