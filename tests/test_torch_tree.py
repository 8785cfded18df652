"""The port's hierarchical aggregation tree (``fed/tree.py``) held against
the JAX package's on the CPU.

The edge scenarios of tests/test_cohort.py, tests/test_buffered.py and
tests/test_aggregation.py run through :class:`EdgePair`, which makes every
call on both packages' ``EdgeAggregator`` with the same arguments and,
after each call, holds exactly equal: the call's return (partial blobs
and frames byte for byte), the edge's round, base, leaves, received and
rejected maps, buffer and retained bases, ledger, peak and wire counts,
and the two statefiles' bytes. Each package also restores the other's
statefile and writes it back unchanged.

``run_tree_federation`` runs on both packages with the same leaves. The
cohorts are equal. The final globals are compared by ``global_sha256``
where the JAX package's compiled host FedAvg (``fedcrack_tpu.native``)
is built, because the port rounds ``acc + w * x`` once as that build
does; where it is not, the JAX package falls back to numpy, and the
globals are held within one float32 ulp, as tests/test_torch_fed.py
holds the fold.
"""

import os

import numpy as np
import pytest

import fedcrack_tpu.native as jax_native
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import tree as JT
from fedcrack_tpu.fed.serialization import tree_from_bytes as j_from
from fedcrack_tpu.fed.serialization import tree_to_bytes as j_to
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed import tree as TT
from fedcrack_tpu_torch.fed.algorithms import fedavg, sample_cohort
from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes

pytestmark = pytest.mark.torch_port

EDGE_FIELDS = ("edge_id", "round", "base_version", "base_blob", "leaves", "received", "rejected", "wire_bytes",
               "mode", "buffer_k", "staleness_alpha", "max_staleness", "buffer", "bases", "ledger",
               "peak_resident_blobs", "bytes_in", "bytes_up", "last_partial_ctx")


def _vars(value: float):
    return {"params": {"w": np.full((4, 4), value, np.float32)}}


def _template():
    return tree_from_bytes(tree_to_bytes(_vars(0.0)))


def _blob(value: float) -> bytes:
    return tree_to_bytes(_vars(value))


def _tree(seed: int):
    """tests/test_aggregation.py's tree."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)},
        "batch_stats": {"m": rng.normal(size=(2,)).astype(np.float32)},
    }


def _make_update(to_bytes, from_bytes):
    """tests/test_cohort.py's seeded leaf, through one package's blob codec."""
    def make(idx, r, base_blob, base_version):
        rng = np.random.default_rng([11, idx, r])
        base = from_bytes(base_blob)
        tree = {"params": {"w": np.asarray(base["params"]["w"], np.float32)
                           + rng.standard_normal((4, 4)).astype(np.float32) * 0.01}}
        return to_bytes(tree), int(rng.integers(1, 50))

    return make


PORT_UPDATE = _make_update(tree_to_bytes, tree_from_bytes)
JAX_UPDATE = _make_update(j_to, j_from)


def _run_both(**kwargs):
    port = TT.run_tree_federation(_vars(0.0), PORT_UPDATE, **kwargs)
    jax = JT.run_tree_federation(_vars(0.0), JAX_UPDATE, **kwargs)
    return port, jax


def _assert_globals_match(port, jax):
    """The rounding rule of the module docstring."""
    assert port.cohorts == jax.cohorts
    if jax_native.AVAILABLE:
        assert port.global_sha256 == jax.global_sha256
    else:
        got = tree_from_bytes(port.state.global_blob)["params"]["w"]
        want = np.asarray(j_from(jax.state.global_blob)["params"]["w"])
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _numbers(res):
    return (res.n_clients, res.cohort_size, res.n_edges, res.rounds, res.root_peak_blobs, res.edge_peak_blobs,
            res.max_leaf_fan_in, res.leaf_updates, res.leaf_rejections, res.bytes_at_root, res.bytes_flat_equiv)


def _root_history(state):
    keys = ("round", "clients", "samples", "rejected", "codecs", "bytes_received", "decoded_bytes_received")
    return [{k: h.get(k) for k in keys} for h in state.history]


class EdgePair:
    """One ``EdgeAggregator`` of each package, driven call for call."""

    def __init__(self, tmp_path, edge_id, template, **kw):
        self.paths = {}
        if tmp_path is not None:
            self.paths = {"jax": str(tmp_path / "jax.msgpack"), "port": str(tmp_path / "port.msgpack")}
            kw_j, kw_t = dict(kw, state_path=self.paths["jax"]), dict(kw, state_path=self.paths["port"])
        else:
            kw_j = kw_t = kw
        self.j = JT.EdgeAggregator(edge_id, template, **kw_j)
        self.t = TT.EdgeAggregator(edge_id, template, **kw_t)
        self.events = 0

    def call(self, method, *args, **kw):
        got_j = getattr(self.j, method)(*args, **kw)
        got_t = getattr(self.t, method)(*args, **kw)
        assert got_t == got_j, (method, got_t, got_j)
        self.check()
        return got_t

    def check(self):
        self.events += 1
        for field in EDGE_FIELDS:
            assert getattr(self.t, field) == getattr(self.j, field), field
        if self.paths:
            assert os.path.exists(self.paths["port"]) == os.path.exists(self.paths["jax"])
            if os.path.exists(self.paths["port"]):
                with open(self.paths["port"], "rb") as f, open(self.paths["jax"], "rb") as g:
                    assert f.read() == g.read(), f"edge statefile bytes differ after event {self.events}"

    def restore_crossed(self, template, **kw):
        """Each package restores the other's statefile; both must come back
        equal to the live edges and re-persist the same bytes."""
        with open(self.paths["port"], "rb") as f:
            snapshot = f.read()
        restored = {"port": TT.EdgeAggregator.restore(self.paths["jax"], template, **kw),
                    "jax": JT.EdgeAggregator.restore(self.paths["port"], template, **kw)}
        for name, edge in restored.items():
            assert edge is not None, name
            for field in ("edge_id", "round", "base_version", "base_blob", "leaves", "received", "rejected",
                          "wire_bytes", "mode", "buffer_k", "staleness_alpha", "max_staleness", "buffer", "bases",
                          "ledger"):
                assert getattr(edge, field) == getattr(self.t, field), (name, field)
            # A restored edge's peak is what the file holds.
            assert edge.peak_resident_blobs == max(len(edge.received), len(edge.buffer))
            edge._persist()  # over the other package's file
            with open(edge.state_path, "rb") as f:
                assert f.read() == snapshot, name
        return restored


# ---- run_tree_federation (tests/test_cohort.py) ----


def test_tree_1024_clients_closes_at_fan_in_memory():
    """The cohort-scale smoke at tests/test_cohort.py's arguments, on both
    packages: same cohorts, same numbers, same global; reproducible from
    the seed, and a different seed is a different trajectory."""
    kwargs = dict(n_clients=4096, cohort_size=1024, n_rounds=2, n_edges=32, cohort_seed=5)
    res, jax = _run_both(**kwargs)
    assert res.state.phase == TR.PHASE_FINISHED and jax.state.phase == JR.PHASE_FINISHED
    assert res.root_peak_blobs <= res.n_edges == 32
    assert res.edge_peak_blobs <= res.max_leaf_fan_in == 32
    assert res.leaf_updates == 2048 and res.leaf_rejections == 0
    assert res.bytes_at_root < res.bytes_flat_equiv / 8
    assert _numbers(res) == _numbers(jax)
    assert _root_history(res.state) == _root_history(jax.state)
    _assert_globals_match(res, jax)
    res2 = TT.run_tree_federation(_vars(0.0), PORT_UPDATE, **kwargs)
    assert res.global_sha256 == res2.global_sha256 and res.cohorts == res2.cohorts
    res3 = TT.run_tree_federation(_vars(0.0), PORT_UPDATE, **{**kwargs, "cohort_seed": 6})
    assert res3.global_sha256 != res.global_sha256


def test_tree_matches_flat_fedavg():
    """One tree round is the flat sample-weighted FedAvg of the same
    leaves to float re-association (tests/test_cohort.py's atol), and the
    JAX tree's global by the rounding rule."""
    kwargs = dict(n_clients=256, cohort_size=64, n_rounds=1, n_edges=8, cohort_seed=3)
    res, jax = _run_both(**kwargs)
    cohort = sample_cohort(256, 64, 0, 3)
    base_blob = _blob(0.0)
    trees, counts = [], []
    for i in cohort:
        blob, ns = PORT_UPDATE(int(i), 0, base_blob, 0)
        trees.append(tree_from_bytes(blob))
        counts.append(ns)
    flat = fedavg(trees, counts)
    got = tree_from_bytes(res.state.global_blob)["params"]["w"]
    np.testing.assert_allclose(got, np.asarray(flat["params"]["w"]), rtol=0, atol=1e-6)
    _assert_globals_match(res, jax)


@pytest.mark.parametrize("codec", ["int8", "topk_delta"])
def test_tree_with_compressed_edge_hop(codec):
    """The edge-to-root hop re-encoded: the root records the codec per
    edge and accounts wire bytes apart from the decoded ones, with no
    rejection; the frames and the global are the JAX tree's."""
    kwargs = dict(n_clients=64, cohort_size=16, n_rounds=2, n_edges=4, cohort_seed=1, update_codec=codec,
                  topk_fraction=0.5)
    res, jax = _run_both(**kwargs)
    assert res.state.phase == TR.PHASE_FINISHED
    for entry in res.state.history:
        assert set(entry["codecs"].values()) == {codec}
        assert entry["bytes_received"] != entry["decoded_bytes_received"]
        assert entry["rejected"] == {}
    assert _numbers(res) == _numbers(jax)
    assert _root_history(res.state) == _root_history(jax.state)
    _assert_globals_match(res, jax)
    if codec == "int8":
        dense = TT.run_tree_federation(_vars(0.0), PORT_UPDATE, **{**kwargs, "update_codec": "null"})
        a = tree_from_bytes(res.state.global_blob)["params"]["w"]
        b = tree_from_bytes(dense.state.global_blob)["params"]["w"]
        np.testing.assert_allclose(a, b, atol=0.05)


def test_tree_statefiles_per_tier(tmp_path):
    """``state_dir`` writes one statefile per edge, byte-equal to the JAX
    tree's; each package restores the other's."""
    kwargs = dict(n_clients=32, cohort_size=8, n_rounds=1, n_edges=2, cohort_seed=2)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    res = TT.run_tree_federation(_vars(0.0), PORT_UPDATE, state_dir=str(tmp_path / "port"), **kwargs)
    jax = JT.run_tree_federation(_vars(0.0), JAX_UPDATE, state_dir=str(tmp_path / "jax"), **kwargs)
    assert res.state.phase == TR.PHASE_FINISHED
    _assert_globals_match(res, jax)
    for e in range(2):
        paths = {p: str(tmp_path / p / f"edge-{e}.msgpack") for p in ("port", "jax")}
        with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
            assert f.read() == g.read()
        for package, path in ((TT, paths["jax"]), (JT, paths["port"])):
            restored = package.EdgeAggregator.restore(path, _template())
            assert restored is not None and restored.edge_id == f"edge-{e}"


def test_tree_rejects_fewer_leaves_than_edges():
    for package in (TT, JT):
        with pytest.raises(ValueError, match="cohort_size"):
            package.run_tree_federation(_vars(0.0), PORT_UPDATE, n_clients=8, cohort_size=2, n_rounds=1, n_edges=4)


def test_partition_cohort_matches_jax():
    cohort = sample_cohort(4096, 1024, 0, 1)
    for n_edges in (1, 3, 8, 32, 2000):
        got, want = TT.partition_cohort(cohort, n_edges), JT.partition_cohort(cohort, n_edges)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for package in (TT, JT):
        with pytest.raises(ValueError, match="n_edges"):
            package.partition_cohort(cohort, 0)
        with pytest.raises(ValueError, match="empty cohort"):
            package.partition_cohort([], 2)


# ---- the sync edge (tests/test_cohort.py) ----


def test_edge_sanitizes_every_leaf_update(tmp_path):
    """A NaN update, a wrong-shape tree, a truncated blob and an outsider
    are refused at the edge with the JAX package's reasons; the partial is
    the weighted mean of the clean leaves only, byte-equal to JAX's."""
    pair = EdgePair(tmp_path, "edge-0", _template(), quorum_fraction=0.5)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b", "nan", "shape", "trunc"])
    assert pair.call("offer", "a", _blob(1.0), 10)[0]
    ok, reason = pair.call("offer", "nan", tree_to_bytes({"params": {"w": np.full((4, 4), np.nan, np.float32)}}), 10)
    assert not ok and "non-finite" in reason
    ok, reason = pair.call("offer", "shape", tree_to_bytes({"params": {"w": np.zeros((2, 2), np.float32)}}), 10)
    assert not ok and "shape" in reason
    blob = _blob(9.0)
    ok, reason = pair.call("offer", "trunc", blob[: len(blob) // 2], 10)
    assert not ok and "undecodable" in reason
    ok, reason = pair.call("offer", "outsider", _blob(5.0), 10)
    assert not ok and "not in this edge's shard" in reason
    assert pair.call("offer", "b", _blob(3.0), 30)[0]
    ok, reason = pair.call("offer", "b", _blob(3.0), 30)
    assert not ok and "duplicate" in reason
    assert not pair.call("quorum_met")
    assert sorted(pair.t.rejected) == ["nan", "shape", "trunc"]
    partial, total = pair.call("partial")
    np.testing.assert_allclose(tree_from_bytes(partial)["params"]["w"], (10 * 1.0 + 30 * 3.0) / 40, atol=1e-6)
    assert total == 40
    pair.call("end_round")
    pair.restore_crossed(_template(), quorum_fraction=0.5)


def test_edge_quorum_is_k_of_n():
    pair = EdgePair(None, "e", _template(), quorum_fraction=0.5)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b", "c", "d"])
    assert pair.t.quorum == pair.j.quorum == 2
    assert not pair.call("quorum_met")
    pair.call("offer", "a", _blob(1.0), 1)
    assert not pair.call("quorum_met")
    pair.call("offer", "b", _blob(2.0), 1)
    assert pair.call("quorum_met")


def test_edge_statefile_kill_restart_resumes_round(tmp_path):
    """A killed edge resumes the same round from its statefile, and the
    completed partial is exactly the unkilled edge's; each package resumes
    from the other's file. Missing and corrupt files give None."""
    pair = EdgePair(tmp_path, "edge-7", _template())
    base = _blob(0.0)
    pair.call("begin_round", 3, base, 2, ["a", "b", "c"])
    pair.call("offer", "a", _blob(1.0), 10)
    pair.call("offer", "b", _blob(2.0), 10)
    restored = pair.restore_crossed(_template())
    want = None
    for edge in (restored["port"], restored["jax"], pair.t):
        assert edge.round == 3 and edge.base_version == 2 and sorted(edge.received) == ["a", "b"]
        assert edge.leaves == frozenset({"a", "b", "c"})
        edge.offer("c", _blob(6.0), 20)
        got = edge.partial()
        assert want is None or got == want
        want = got
    clean = TT.EdgeAggregator("edge-7", _template())
    clean.begin_round(3, base, 2, ["a", "b", "c"])
    for name, value, ns in (("a", 1.0, 10), ("b", 2.0, 10), ("c", 6.0, 20)):
        clean.offer(name, _blob(value), ns)
    assert clean.partial() == want
    for package in (TT, JT):
        assert package.EdgeAggregator.restore(str(tmp_path / "nope"), _template()) is None
    with open(pair.paths["port"], "wb") as f:
        f.write(b"garbage")
    assert TT.EdgeAggregator.restore(pair.paths["port"], _template()) is None


def test_edge_codec_instance_survives_rounds(tmp_path):
    """The top-k codec lives for the edge's lifetime, so its residual
    carries into the next round's frame, byte-equal to JAX's."""
    pair = EdgePair(tmp_path, "e", _template(), update_codec="topk_delta", topk_fraction=0.5)
    base = _blob(0.0)
    pair.call("begin_round", 1, base, 0, ["a"])
    pair.call("offer", "a", tree_to_bytes({"params": {"w": np.arange(16, dtype=np.float32).reshape(4, 4)}}), 10)
    pair.call("partial")
    first = pair.t._codec
    assert first is not None
    pair.call("end_round")
    pair.call("begin_round", 2, base, 0, ["a"])
    pair.call("offer", "a", _blob(2.0), 10)
    pair.call("partial")
    assert pair.t._codec is first


# ---- the buffered edge (tests/test_buffered.py) ----


def test_edge_buffered_flush_weighted_mean(tmp_path):
    pair = EdgePair(tmp_path, "edge-0", _template(), mode="buffered", buffer_k=2, staleness_alpha=1.0,
                    max_staleness=2)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b", "c"])
    ok, _ = pair.call("offer_buffered", "a", _blob(1.0), 10, 0)
    assert ok and not pair.call("buffer_ready")
    pair.call("advance_base", 2, _blob(0.5), 1)
    ok, _ = pair.call("offer_buffered", "b", _blob(3.0), 30, 0)
    assert ok and pair.call("buffer_ready")
    blob, total, info = pair.call("flush_partial")
    want = (10 * 1.0 * 1.0 + 30 * 0.5 * 3.0) / (10 * 1.0 + 30 * 0.5)
    np.testing.assert_allclose(tree_from_bytes(blob)["params"]["w"], want, atol=1e-6)
    assert total == 25 and info["staleness"] == [0, 1] and not pair.t.buffer
    pair.restore_crossed(_template())


def test_edge_buffered_rejects_too_stale_and_unretained(tmp_path):
    pair = EdgePair(tmp_path, "edge-0", _template(), mode="buffered", buffer_k=2, staleness_alpha=0.5,
                    max_staleness=0)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b"])
    pair.call("advance_base", 2, _blob(1.0), 1)
    ok, reason = pair.call("offer_buffered", "a", _blob(2.0), 10, 0)
    assert not ok and "too stale" in reason
    assert "a" in pair.t.rejected and not pair.t.buffer
    ok, reason = pair.call("offer_buffered", "b", _blob(2.0), 10, 5)
    assert not ok and "future" in reason
    # Within the window but no longer kept: max_staleness 1, base 0 pruned.
    pair2 = EdgePair(None, "edge-1", _template(), mode="buffered", max_staleness=1)
    pair2.call("begin_round", 1, _blob(0.0), 3, ["a"])
    ok, reason = pair2.call("offer_buffered", "a", _blob(2.0), 10, 2)
    assert not ok and "no longer retained" in reason
    ok, reason = pair2.call("offer_buffered", "outsider", _blob(2.0), 10, 3)
    assert not ok and "not in this edge's shard" in reason
    sync = EdgePair(None, "edge-2", _template())
    assert sync.call("offer_buffered", "a", _blob(2.0), 10, 0) == (False, "edge is not in buffered mode")
    for package in (TT, JT):
        edge = package.EdgeAggregator("e", _template())
        with pytest.raises(RuntimeError, match="buffered-mode"):
            edge.advance_base(1, _blob(0.0), 0)
        with pytest.raises(RuntimeError, match="buffered-mode"):
            edge.flush_partial()


def test_edge_buffered_statefile_resume(tmp_path):
    """The buffered knobs restore from the file, not the arguments, and
    the resumed edge (either package's, from either file) flushes the
    same partial as the unkilled one."""
    pair = EdgePair(tmp_path, "edge-0", _template(), mode="buffered", buffer_k=2, staleness_alpha=1.0,
                    max_staleness=2)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b", "c"])
    assert pair.call("offer_buffered", "a", _blob(1.0), 10, 0)[0]
    restored = pair.restore_crossed(_template())
    for edge in restored.values():
        assert edge.mode == "buffered" and edge.buffer_k == 2
        assert edge.staleness_alpha == 1.0 and edge.max_staleness == 2
        assert [e["cname"] for e in edge.buffer] == ["a"] and sorted(edge.bases) == [0]
    want = None
    for edge in (pair.t, pair.j, restored["port"], restored["jax"]):
        assert edge.offer_buffered("b", _blob(3.0), 30, 0)[0]
        blob, total, _ = edge.flush_partial()
        assert want is None or (blob, total) == want
        want = (blob, total)


@pytest.mark.parametrize("codec", ["null", "int8", "topk_delta"])
def test_buffered_edge_statefile_bytes_after_every_event(tmp_path, codec):
    """A longer buffered script (two bases advanced past, a sanitation
    refusal, two flushes, a codec on the hop up): the statefiles stay
    byte-equal after every event and the flushed frames are JAX's."""
    pair = EdgePair(tmp_path, "edge-3", _template(), mode="buffered", buffer_k=2, staleness_alpha=0.5,
                    max_staleness=1, update_codec=codec, topk_fraction=0.25)
    pair.call("begin_round", 1, _blob(0.0), 0, ["a", "b", "c"])
    pair.call("offer_buffered", "a", _blob(1.0), 10, 0)
    pair.call("offer_buffered", "b", tree_to_bytes({"params": {"w": np.full((4, 4), np.inf, np.float32)}}), 10, 0)
    pair.call("advance_base", 2, _blob(0.25), 1)
    pair.call("offer_buffered", "c", _blob(2.0), 7, 0)
    pair.call("flush_partial")
    pair.call("advance_base", 3, _blob(0.5), 2)
    pair.call("offer_buffered", "a", _blob(1.5), 4, 1)
    pair.call("offer_buffered", "a", _blob(1.75), 5, 2)
    pair.call("offer_buffered", "b", _blob(1.75), 5, 0)
    pair.call("flush_partial")
    pair.restore_crossed(_template(), update_codec=codec, topk_fraction=0.25)


# ---- the algebra pins (tests/test_aggregation.py) ----


def test_null_pin_edge_partial_bitwise(tmp_path):
    pair = EdgePair(tmp_path, "e0", _tree(0))
    pair.call("begin_round", 1, tree_to_bytes(_tree(0)), 0, ["a", "b"])
    for c, seed, ns in (("b", 2, 30), ("a", 1, 10)):
        pair.call("offer", c, tree_to_bytes(_tree(seed)), ns)
    blob, total = pair.call("partial")
    want = fedavg([_tree(1), _tree(2)], [10, 30])
    got = tree_from_bytes(blob, template=_tree(0))
    np.testing.assert_array_equal(got["params"]["w"], want["params"]["w"])
    assert total == 40


@pytest.mark.parametrize("name", ["trimmed_mean", "median", "krum", "multi_krum"])
def test_edge_refuses_robust_combines(name):
    with pytest.raises(ValueError, match="edge tier only supports") as got:
        TT.EdgeAggregator("e0", _tree(0), aggregation=name)
    with pytest.raises(ValueError, match="edge tier only supports") as want:
        JT.EdgeAggregator("e0", _tree(0), aggregation=name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(quorum_fraction=0.0), dict(update_codec="zstd"), dict(mode="async"),
                                dict(buffer_k=0), dict(staleness_alpha=-1.0), dict(max_staleness=-1)])
def test_edge_argument_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        TT.EdgeAggregator("e", _template(), **kw)
    with pytest.raises(ValueError) as want:
        JT.EdgeAggregator("e", _template(), **kw)
    assert str(got.value) == str(want.value)
