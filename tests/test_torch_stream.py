"""The port's frame-coherent video serving (``serve/stream.py``) held
against its own ``predict_tiled`` and against the JAX package's sessions on
the CPU, at the JAX stream tests' tiny model (buckets 16 and 32).

- Byte identity: every frame's probabilities equal the port's
  ``predict_tiled`` of the pinned snapshot bit for bit, over seeded motion
  sequences (motion 0, 0.1, 0.5 and 1.0, from the JAX package's
  ``make_frame_sequence``), across a hot swap landing mid-sequence, a
  reset, a disabled cache, an LRU bound and an undersized frame; the
  misses pack into as few batches as they fill.
- Accounting: per frame, ``tiles_total``, ``tiles_computed``,
  ``cache_hits``, ``full_rerun`` and ``evicted`` equal the JAX package's
  session on the same frames (exact); its probabilities agree within the
  1e-4 of tests/test_torch_serve.py.
- ``CrackTracker`` gives the JAX tracker's tracks on the same masks, and
  ``tracks_to_json`` its bytes; the manager's session caps and its
  ``serve_stream_*`` families.
"""

import json

import numpy as np
import pytest

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKETS = (16, 32)
FRAME = 64
PROB_TOL = 1e-4


def _serve_kw(**over):
    kw = dict(bucket_sizes=BUCKETS, max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def stack():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    var0, var1 = jax_variables(TINY_KW, seed=0), jax_variables(TINY_KW, seed=1)
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw()), device="cpu")
    return {
        "engine": engine,
        "w": (engine.prepare(var0), engine.prepare(var1)),
        "jax_engine": JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw())),
        "var": (var0, var1),
    }


class _Static:
    def __init__(self, version, variables):
        self._snap = (version, variables)

    def snapshot(self):
        return self._snap


class _SwapAfter:
    """v0 for the first ``at`` snapshots, v1 after: the swap lands while
    frame ``at - 1`` computes."""

    def __init__(self, w0, w1, at):
        self.w, self.at, self.calls = (w0, w1), at, 0

    def snapshot(self):
        self.calls += 1
        v = 0 if self.calls <= self.at else 1
        return v, self.w[v]


def _frames(n, motion, seed=0, size=FRAME):
    from fedcrack_tpu.tools.load_gen import make_frame_sequence

    return make_frame_sequence(n, size, motion, seed=seed)


ACCOUNTING = ("frame_index", "model_version", "tiles_total", "tiles_computed", "cache_hits", "full_rerun", "evicted")


def _run_both(stack, frames, *, weights=None, jax_weights=None, reset_at=None, **session_kw):
    """Each frame through a port and a JAX session; checks byte identity
    against the port's predict_tiled and returns the port's results."""
    from fedcrack_tpu.serve.stream import StreamSession as JaxSession
    from fedcrack_tpu_torch.serve.stream import StreamSession

    engine = stack["engine"]
    h, w = frames[0].shape[:2]
    weights = weights or _Static(0, stack["w"][0])
    jax_weights = jax_weights or _Static(0, stack["var"][0])
    port = StreamSession(engine, weights, height=h, width=w, **session_kw)
    ref = JaxSession(stack["jax_engine"], jax_weights, height=h, width=w, **session_kw)
    out = []
    for i, frame in enumerate(frames):
        if i == reset_at:
            port.reset()
            ref.reset()
            assert port.cache_len() == 0
        got, want = port.process_frame(frame), ref.process_frame(frame)
        pinned = stack["w"][got.model_version]
        assert got.probs.tobytes() == engine.predict_tiled(pinned, frame).tobytes(), f"frame {i}"
        assert [getattr(got, k) for k in ACCOUNTING] == [getattr(want, k) for k in ACCOUNTING], f"frame {i}"
        np.testing.assert_allclose(got.probs, np.asarray(want.probs), rtol=0, atol=PROB_TOL)
        assert port.totals == ref.totals
        out.append(got)
    return out


@pytest.mark.parametrize("motion", [0.0, 0.1, 0.5, 1.0])
def test_motion_sweep_byte_identity_and_jax_accounting(stack, motion):
    results = _run_both(stack, _frames(6, motion, seed=int(motion * 10), size=2 * FRAME))
    assert results[0].full_rerun and results[0].cache_hits == 0
    steady = results[1:]
    if motion == 0.0:
        assert all(r.tiles_computed == 0 for r in steady)
    if motion == 1.0:
        assert all(r.tiles_computed == r.tiles_total for r in steady)
    if 0.0 < motion < 1.0:
        assert 0 < sum(r.tiles_computed for r in steady) < sum(r.tiles_total for r in steady)


def test_misses_pack_into_as_few_batches_as_they_fill(stack, monkeypatch):
    # One changed tile in each of predict_tiled's batches: the misses run
    # in ceil(misses / max_batch) calls, as the JAX session packs them.
    from fedcrack_tpu_torch.serve.stream import StreamSession

    engine = stack["engine"]
    first = _frames(1, 0.0, seed=7, size=2 * FRAME)[0]
    spans = StreamSession(engine, _Static(0, stack["w"][0]), height=2 * FRAME, width=2 * FRAME)._spans
    changed = list(range(0, len(spans), engine.max_batch))
    assert len(changed) > 2
    tile = 32
    cover = np.zeros(first.shape[:2], np.int32)
    for y, x, _ in spans:
        cover[y : y + tile, x : x + tile] += 1
    second = first.copy()
    for i in changed:  # a pixel of this tile that no other tile covers
        y, x, _ = spans[i]
        dy, dx = np.argwhere(cover[y : y + tile, x : x + tile] == 1)[0]
        second[y + dy, x + dx] ^= 0xFF
    calls = []
    bucket = type(engine).predict_bucket

    def counted(self, variables, images_u8):
        calls.append(len(images_u8))
        return bucket(self, variables, images_u8)

    monkeypatch.setattr(type(engine), "predict_bucket", counted)
    results = _run_both(stack, [first, second])
    assert results[1].tiles_computed == len(changed)
    full = -(-len(spans) // engine.max_batch)  # the first frame, then each frame's predict_tiled check
    miss_calls = calls[2 * full : -full]
    assert miss_calls == [engine.max_batch] * (len(changed) // engine.max_batch) + (
        [len(changed) % engine.max_batch] if len(changed) % engine.max_batch else [])


def test_frame_straddling_hot_swap(stack):
    at = 3
    results = _run_both(
        stack, _frames(6, 0.1, seed=42),
        weights=_SwapAfter(*stack["w"], at), jax_weights=_SwapAfter(*stack["var"], at),
    )
    assert [r.model_version for r in results] == [0] * at + [1] * (6 - at)
    assert results[at].full_rerun and results[at].cache_hits == 0 and results[at].evicted > 0


@pytest.mark.parametrize("case", ["static", "reset", "cache_off", "lru", "undersized", "smoothed"])
def test_session_paths_stay_byte_identical(stack, case):
    if case == "static":
        results = _run_both(stack, _frames(1, 0.0)[:1] * 4)
        assert [r.tiles_computed for r in results[1:]] == [0, 0, 0]
    elif case == "reset":
        results = _run_both(stack, _frames(1, 0.0, seed=5)[:1] * 3, reset_at=2)
        assert [r.full_rerun for r in results] == [True, False, True]
    elif case == "cache_off":
        results = _run_both(stack, _frames(3, 0.0, seed=6), cache_tiles=0)
        assert all(r.full_rerun and r.tiles_computed == r.tiles_total for r in results)
    elif case == "lru":
        results = _run_both(stack, _frames(4, 0.5, seed=7), cache_tiles=3)
        assert sum(r.evicted for r in results) > 0
    elif case == "undersized":
        rng = np.random.default_rng(8)
        frames = [rng.integers(0, 256, (24, 20, 3), dtype=np.uint8) for _ in range(2)]
        results = _run_both(stack, frames)
        assert results[0].probs.shape == (24, 20, 1)
    else:
        results = _run_both(stack, _frames(3, 0.1, seed=9), smooth_alpha=0.7)
        assert all(r.smoothed is not None and r.smoothed.shape == r.probs.shape for r in results)


def test_session_input_validation(stack):
    from fedcrack_tpu_torch.serve.stream import StreamSession

    session = StreamSession(stack["engine"], _Static(0, stack["w"][0]), height=FRAME, width=FRAME)
    with pytest.raises(ValueError, match="frame shape"):
        session.process_frame(np.zeros((32, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="channels"):
        session.process_frame(np.zeros((FRAME, FRAME, 1), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        session.process_frame(np.zeros((FRAME, FRAME, 3), np.float32))
    with pytest.raises(ValueError, match="smooth_alpha"):
        StreamSession(stack["engine"], _Static(0, None), height=8, width=8, smooth_alpha=1.0)
    # chaos= (once refused) runs: mirror of tests/test_serve_stream.py::
    # test_chaos_stream_reset_fires_once_and_keeps_bytes, the reset frame
    # a full re-run byte-equal to predict_tiled, the same in both packages.
    from fedcrack_tpu.chaos.inject import StreamChaos as JaxStreamChaos
    from fedcrack_tpu.chaos.plan import Fault as JaxFault
    from fedcrack_tpu.chaos.plan import FaultPlan as JaxFaultPlan
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from fedcrack_tpu.serve.stream import StreamSession as JaxSession
    from fedcrack_tpu.serve.stream import StreamSessionManager as JaxManager
    from fedcrack_tpu_torch.chaos import SERVE_STREAM_RESET, Fault, FaultPlan, StreamChaos
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager

    frame = _frames(1, 0.0, seed=12)[0]
    registry = MetricsRegistry()
    manager = StreamSessionManager(stack["engine"], _Static(0, stack["w"][0]), registry=registry,
                                   chaos=None)
    manager.chaos = StreamChaos(FaultPlan([Fault(kind=SERVE_STREAM_RESET, round=2)]), manager=manager)
    opened = manager.open("cam", height=FRAME, width=FRAME)
    assert opened.chaos is manager.chaos
    results = [opened.process_frame(frame) for _ in range(4)]
    jreg = JaxRegistry()
    jmanager = JaxManager(stack["jax_engine"], _Static(0, stack["var"][0]), registry=jreg)
    jmanager.chaos = JaxStreamChaos(JaxFaultPlan([JaxFault(kind=SERVE_STREAM_RESET, round=2)]), manager=jmanager)
    jsession = JaxSession(stack["jax_engine"], _Static(0, stack["var"][0]), height=FRAME, width=FRAME,
                          chaos=jmanager.chaos)
    jresults = [jsession.process_frame(frame) for _ in range(4)]
    assert [r.full_rerun for r in results] == [r.full_rerun for r in jresults] == [True, False, True, False]
    assert len(manager.chaos.plan.triggered) == 1 and opened.totals["resets"] == 1
    assert sum(registry.values()["serve_stream_resets_total"].values()) == 1
    tiled = stack["engine"].predict_tiled(stack["w"][0], frame).tobytes()
    assert all(r.probs.tobytes() == tiled for r in results)


def _blob_mask(size, cx, cy, r):
    yy, xx = np.mgrid[0:size, 0:size]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).astype(np.uint8) * 255


def test_tracker_matches_jax_on_the_same_masks(stack):
    from fedcrack_tpu.serve.stream import CrackTracker as JaxTracker
    from fedcrack_tpu.serve.stream import tracks_to_json as jax_json
    from fedcrack_tpu_torch.serve.stream import CrackTracker, tracks_to_json

    masks = [_blob_mask(64, 20 + 2 * t, 20, 5 + t) for t in range(4)]
    masks += [np.maximum(masks[-1], _blob_mask(64, 48, 48, 4)), np.zeros((64, 64), np.uint8),
              np.zeros((64, 64), np.uint8), _blob_mask(64, 50, 46, 4), _blob_mask(64, 50, 46, 4)[..., None]]
    # And the masks of a tracked port session over a moving sequence.
    from fedcrack_tpu_torch.serve.stream import StreamSession

    session = StreamSession(stack["engine"], _Static(0, stack["w"][0]), height=FRAME, width=FRAME, track=True)
    for frame in _frames(4, 0.2, seed=11):
        result = session.process_frame(frame)
        assert isinstance(result.tracks, list)
        masks.append((result.probs[..., 0] > 0.5).astype(np.uint8) * 255)
    for dist, ttl in ((8.0, 2), (5.0, 5), (30.0, 1)):
        port, ref = CrackTracker(match_dist=dist, miss_ttl=ttl), JaxTracker(match_dist=dist, miss_ttl=ttl)
        for t, mask in enumerate(masks):
            got, want = port.update(mask, t), ref.update(mask, t)
            assert got == want, (dist, ttl, t)
            assert tracks_to_json(got) == jax_json(want)
    assert json.loads(tracks_to_json(got)) == json.loads(jax_json(want))
    with pytest.raises(ValueError, match="match_dist"):
        CrackTracker(match_dist=0.0)
    with pytest.raises(ValueError, match="miss_ttl"):
        CrackTracker(match_dist=1.0, miss_ttl=0)


def test_manager_caps_and_metrics(stack):
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager

    registry = MetricsRegistry()
    manager = StreamSessionManager(stack["engine"], _Static(0, stack["w"][0]), max_sessions=2, registry=registry)
    session = manager.open("a", height=FRAME, width=FRAME)
    manager.open("b", height=FRAME, width=FRAME)
    with pytest.raises(ValueError, match="already open"):
        manager.open("a", height=FRAME, width=FRAME)
    with pytest.raises(ValueError, match="bound"):
        manager.open("c", height=FRAME, width=FRAME)
    assert manager.open_sessions() == 2
    assert manager.close("b") is not None and manager.close("b") is None
    assert manager.get("a") is session
    for frame in _frames(2, 0.0, seed=13):
        manager.record(session.process_frame(frame))
    stats = manager.stats()
    assert stats["tiles_total"] == 18 and stats["cache_hits"] == 9 and stats["tiles_computed"] == 9
    assert stats["hit_ratio"] == 0.5 and stats["effective_speedup"] == 2.0
    values = registry.values()
    assert values["serve_stream_cache_hit_ratio"][()] == 0.5
    assert values["serve_stream_effective_speedup_ratio"][()] == 2.0
    expo = registry.exposition()
    for name in ("serve_stream_sessions_total", "serve_stream_frames_total", "serve_stream_cache_hits_total",
                 "serve_stream_cache_misses_total", "serve_stream_cache_evictions_total",
                 "serve_stream_full_rerun_total", "serve_stream_resets_total", "serve_stream_frame_seconds",
                 "serve_stream_cache_hit_ratio", "serve_stream_effective_speedup_ratio"):
        assert name in expo, name
