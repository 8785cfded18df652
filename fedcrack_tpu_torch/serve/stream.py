"""Frame-coherent video serving: a per-stream tile cache and crack tracking.

The counterpart of ``fedcrack_tpu.serve.stream``. A :class:`StreamSession`
turns the engine's tile plan into a per-stream cache of per-tile sigmoid
probabilities keyed on **(model_version, tile content hash)**: a new frame
re-runs only the tiles whose bytes changed, then re-blends the whole frame
with ``InferenceEngine.predict_tiled``'s ramp weights and float32
accumulation order.

**A cached frame is byte-identical to stateless ``predict_tiled``.** As
in the JAX package, this rests on one tile's probabilities not depending
on which lane of a batch it occupies, nor on the tiles beside it
(``predict_bucket`` pads every batch to ``max_batch`` lanes, so the shapes
never change). The misses are packed into as few batches as they fill,
and the blend replays ``predict_tiled``'s float32 order. On the H100 the
fused int8 forward is lane-invariant bitwise; ``chip_smoke.py`` phase 14
requires it before it drives a stream.

Hot-swap safety: the model version is in the cache key, so a swap can
never serve a stale tile; each frame pins ONE weights snapshot, and
entries from older versions are purged the first frame after the swap.
``reset()`` drops the cache; the next frame is a full re-run.

On top of the mask stream, :class:`CrackTracker` gives contours stable ids
across frames by greedy centroid matching (OpenCV contours, imported where
they are measured), and an optional EMA smooths the probability field for
the tracker without touching the raw mask. ``chaos=`` attaches a
``chaos.StreamChaos`` hook, called at the top of each frame before its
snapshot is pinned (a planned reset drops the cache there).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from collections import OrderedDict
from typing import Any

import numpy as np

from fedcrack_tpu_torch.analysis.sanitizers import make_lock
from fedcrack_tpu_torch.obs.registry import REGISTRY
from fedcrack_tpu_torch.serve.engine import _ramp_weights, tile_plan


def tile_digest(tile_u8: np.ndarray) -> bytes:
    """Content hash of one uint8 tile (the cache key's second half):
    sha256 over the raw bytes."""
    return hashlib.sha256(np.ascontiguousarray(tile_u8).tobytes()).digest()


@dataclasses.dataclass
class FrameResult:
    """One processed frame: the byte-identical probability field plus the
    cache accounting."""

    probs: np.ndarray            # [H, W, 1] float32, predict_tiled-identical
    model_version: int
    frame_index: int
    tiles_total: int
    tiles_computed: int          # cache misses computed on the device
    cache_hits: int
    evicted: int
    full_rerun: bool             # zero hits: first frame, reset or no cache
    latency_ms: float
    tracks: list[dict] = dataclasses.field(default_factory=list)
    smoothed: np.ndarray | None = None  # EMA probs (never the raw contract)

    def mask_bytes(self, threshold: float = 0.5) -> bytes:
        return ((self.probs[..., 0] > threshold).astype(np.uint8) * 255).tobytes()


class CrackTracker:
    """Stable per-crack ids and growth over a mask stream.

    Greedy nearest-centroid matching within ``match_dist`` pixels, closest
    pairs first, ties by (track id, contour index). Unmatched contours open
    new tracks; a track unseen for ``miss_ttl`` frames retires.
    """

    def __init__(self, match_dist: float, miss_ttl: int = 5):
        if match_dist <= 0:
            raise ValueError(f"match_dist must be > 0, got {match_dist}")
        if miss_ttl < 1:
            raise ValueError(f"miss_ttl must be >= 1, got {miss_ttl}")
        self.match_dist = float(match_dist)
        self.miss_ttl = int(miss_ttl)
        self._next_id = 1
        # id -> {centroid, first_frame, last_frame, first_area, last_area,
        #        max_area, last_perimeter, frames_seen, missed}
        self.tracks: dict[int, dict] = {}

    @staticmethod
    def _contours(mask: np.ndarray, threshold: int = 127) -> list[dict]:
        import cv2

        mask = np.asarray(mask)
        if mask.ndim == 3:
            mask = mask[..., 0]
        if mask.dtype != np.uint8:
            mask = (np.clip(mask, 0.0, 1.0) * 255).astype(np.uint8)
        _, binary = cv2.threshold(mask, threshold, 255, cv2.THRESH_BINARY)
        found, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        out = []
        for c in found:
            m = cv2.moments(c)
            if m["m00"] > 0:
                cx, cy = m["m10"] / m["m00"], m["m01"] / m["m00"]
            else:  # a degenerate (line-thin) contour: the mean of its points
                pts = c.reshape(-1, 2)
                cx, cy = float(pts[:, 0].mean()), float(pts[:, 1].mean())
            out.append({
                "centroid": (float(cx), float(cy)),
                "area_px": float(cv2.contourArea(c)),
                "perimeter_px": float(cv2.arcLength(c, True)),
            })
        return out

    def update(self, mask: np.ndarray, frame_index: int) -> list[dict]:
        """Advance the tracker one frame; returns the live track records
        (JSON-safe) after matching this frame's contours."""
        contours = self._contours(mask)
        live = [tid for tid, t in self.tracks.items() if t["missed"] < self.miss_ttl]
        pairs = []
        for tid in live:
            tc = self.tracks[tid]["centroid"]
            for ci, c in enumerate(contours):
                d = float(np.hypot(tc[0] - c["centroid"][0], tc[1] - c["centroid"][1]))
                if d <= self.match_dist:
                    pairs.append((d, tid, ci))
        pairs.sort()
        matched_t: set[int] = set()
        matched_c: set[int] = set()
        for _, tid, ci in pairs:
            if tid in matched_t or ci in matched_c:
                continue
            matched_t.add(tid)
            matched_c.add(ci)
            t = self.tracks[tid]
            c = contours[ci]
            t["centroid"] = c["centroid"]
            t["last_frame"] = frame_index
            t["last_area"] = c["area_px"]
            t["max_area"] = max(t["max_area"], c["area_px"])
            t["last_perimeter"] = c["perimeter_px"]
            t["frames_seen"] += 1
            t["missed"] = 0
        for tid in live:
            if tid not in matched_t:
                self.tracks[tid]["missed"] += 1
        for ci, c in enumerate(contours):
            if ci in matched_c:
                continue
            self.tracks[self._next_id] = {
                "centroid": c["centroid"],
                "first_frame": frame_index,
                "last_frame": frame_index,
                "first_area": c["area_px"],
                "last_area": c["area_px"],
                "max_area": c["area_px"],
                "last_perimeter": c["perimeter_px"],
                "frames_seen": 1,
                "missed": 0,
            }
            self._next_id += 1
        return self.snapshot()

    def snapshot(self) -> list[dict]:
        """JSON-safe live-track records, sorted by id."""
        out = []
        for tid in sorted(self.tracks):
            t = self.tracks[tid]
            if t["missed"] >= self.miss_ttl:
                continue
            out.append({
                "id": tid,
                "centroid": [round(t["centroid"][0], 2), round(t["centroid"][1], 2)],
                "first_frame": t["first_frame"],
                "last_frame": t["last_frame"],
                "frames_seen": t["frames_seen"],
                "area_px": t["last_area"],
                "area_growth_px": round(t["last_area"] - t["first_area"], 2),
                "max_area_px": t["max_area"],
                "perimeter_px": t["last_perimeter"],
            })
        return out


class StreamSession:
    """One video stream's serving state: the (model_version, tile hash)
    cache, the frame counter, the optional tracker and EMA.

    Not thread-safe per session by design: a gRPC stream processes its
    frames in order on one handler. ``weights`` is anything with
    ``snapshot() -> (version, weights)``; each frame pins one snapshot.
    """

    def __init__(
        self,
        engine: Any,
        weights: Any,
        *,
        height: int,
        width: int,
        cache_tiles: int | None = None,
        track: bool = False,
        smooth_alpha: float = 0.0,
        threshold: float = 0.5,
        track_match_dist: float | None = None,
        chaos: Any = None,
        stream_id: str = "",
    ):
        if height < 1 or width < 1:
            raise ValueError(f"bad frame dimensions {height}x{width}")
        if not 0.0 <= smooth_alpha < 1.0:
            raise ValueError(f"smooth_alpha must be in [0, 1), got {smooth_alpha}")
        self.engine = engine
        self.weights = weights
        self.height = int(height)
        self.width = int(width)
        self.threshold = threshold if 0.0 < threshold < 1.0 else 0.5
        cfg = engine.serve_config
        self.cache_tiles = cfg.stream_cache_tiles if cache_tiles is None else int(cache_tiles)
        self.smooth_alpha = float(smooth_alpha)
        self.stream_id = stream_id
        self.chaos = chaos
        self.frame_index = 0
        # (version, sha256 digest) -> [tile, tile, 1] float32 probs.
        self._cache: OrderedDict[tuple[int, bytes], np.ndarray] = OrderedDict()
        self._ema: np.ndarray | None = None
        self.tracker: CrackTracker | None = None
        if track:
            dist = (
                track_match_dist
                if track_match_dist is not None
                else cfg.stream_track_match_frac * float(np.hypot(height, width))
            )
            self.tracker = CrackTracker(match_dist=dist)
        self.totals = {
            "frames": 0,
            "tiles_total": 0,
            "tiles_computed": 0,
            "cache_hits": 0,
            "evictions": 0,
            "full_reruns": 0,
            "resets": 0,
        }
        # The decomposition is a fixed function of (H, W, tile, overlap).
        tile = max(cfg.bucket_sizes)
        overlap = cfg.tile_overlap
        self._tile = tile
        self._ph, self._pw = max(height, tile), max(width, tile)
        ys = tile_plan(self._ph, tile, overlap)
        xs = tile_plan(self._pw, tile, overlap)
        self._spans: list[tuple[int, int, np.ndarray]] = []
        for yi, y in enumerate(ys):
            for xi, x in enumerate(xs):
                wy = _ramp_weights(tile, overlap, yi > 0, yi + 1 < len(ys))
                wx = _ramp_weights(tile, overlap, xi > 0, xi + 1 < len(xs))
                self._spans.append((y, x, np.outer(wy, wx)[..., None]))

    # ---- cache plumbing ----

    def reset(self) -> None:
        """Drop every cached tile: the next frame is a full re-run, and
        since the cache only holds byte-exact tiles, a reset changes
        latency, never bytes."""
        self._cache.clear()
        self.totals["resets"] += 1

    def cache_len(self) -> int:
        return len(self._cache)

    def _purge_versions(self, keep_version: int) -> int:
        """Evict entries of any model version but the pinned one (they are
        unreachable already; this returns their memory)."""
        dead = [k for k in self._cache if k[0] != keep_version]
        for k in dead:
            del self._cache[k]
        return len(dead)

    def _cache_put(self, key: tuple[int, bytes], probs: np.ndarray) -> int:
        """LRU insert; returns how many entries were evicted for the bound."""
        evicted = 0
        if self.cache_tiles <= 0:
            return 0
        self._cache[key] = probs
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_tiles:
            self._cache.popitem(last=False)
            evicted += 1
        return evicted

    # ---- the frame path ----

    def process_frame(self, image_u8: np.ndarray) -> FrameResult:
        """Serve one ``[H, W, 3]`` uint8 frame. ``result.probs`` equals
        ``engine.predict_tiled(weights, image_u8)`` of the pinned snapshot,
        bit for bit, whatever mix of cached and computed tiles made it."""
        t0 = time.monotonic()
        h, w, c = image_u8.shape
        if (h, w) != (self.height, self.width):
            raise ValueError(f"frame shape {h}x{w} != session {self.height}x{self.width}")
        if c != 3:
            raise ValueError(f"channels must be 3 (RGB), got {c}")
        if image_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 frame, got {image_u8.dtype}")
        frame_index = self.frame_index
        self.frame_index += 1

        # A planned mid-stream reset drops the cache before the frame is
        # served: this frame must be a clean full re-run.
        if self.chaos is not None:
            self.chaos.on_frame(self.stream_id, frame_index, self)

        # ONE snapshot per frame: a swap landing meanwhile cannot tear it.
        version, variables = self.weights.snapshot()
        evicted = self._purge_versions(version)

        padded = image_u8
        if (self._ph, self._pw) != (h, w):
            padded = np.zeros((self._ph, self._pw, 3), np.uint8)
            padded[:h, :w] = image_u8

        tile = self._tile
        tiles = [padded[y : y + tile, x : x + tile] for y, x, _ in self._spans]
        probs_of: list[np.ndarray | None] = [None] * len(self._spans)
        misses: list[int] = []
        keys: list[tuple[int, bytes]] = []
        for i, t in enumerate(tiles):
            key = (version, tile_digest(t))
            keys.append(key)
            if self.cache_tiles > 0:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    probs_of[i] = hit
                    continue
            misses.append(i)
        cache_hits = len(self._spans) - len(misses)

        # Batch ONLY the misses, max_batch at a time: a tile's
        # probabilities do not depend on its lane or its neighbours.
        max_batch = self.engine.max_batch
        for start in range(0, len(misses), max_batch):
            idxs = misses[start : start + max_batch]
            out = self.engine.predict_bucket(variables, np.stack([tiles[i] for i in idxs]))
            for j, i in enumerate(idxs):
                p = np.ascontiguousarray(out[j])  # own copy, not a view of the batch
                probs_of[i] = p
                evicted += self._cache_put(keys[i], p)

        # Blend in schedule order: predict_tiled's float32 ops, in its order.
        acc = np.zeros((self._ph, self._pw, 1), np.float32)
        wacc = np.zeros((self._ph, self._pw, 1), np.float32)
        for i, (y, x, wgt) in enumerate(self._spans):
            acc[y : y + tile, x : x + tile] += probs_of[i] * wgt
            wacc[y : y + tile, x : x + tile] += wgt
        probs = (acc / wacc)[:h, :w]

        full_rerun = cache_hits == 0
        self.totals["frames"] += 1
        self.totals["tiles_total"] += len(self._spans)
        self.totals["tiles_computed"] += len(misses)
        self.totals["cache_hits"] += cache_hits
        self.totals["evictions"] += evicted
        if full_rerun:
            self.totals["full_reruns"] += 1

        smoothed = None
        if self.smooth_alpha > 0.0:
            # A separate output: the raw probs and mask stay stateless-exact.
            if self._ema is None:
                self._ema = probs.copy()
            else:
                a = np.float32(self.smooth_alpha)
                self._ema = a * self._ema + (np.float32(1.0) - a) * probs
            smoothed = self._ema

        tracks: list[dict] = []
        if self.tracker is not None:
            basis = smoothed if smoothed is not None else probs
            mask = ((basis[..., 0] > self.threshold).astype(np.uint8)) * 255
            tracks = self.tracker.update(mask, frame_index)

        return FrameResult(
            probs=probs,
            model_version=version,
            frame_index=frame_index,
            tiles_total=len(self._spans),
            tiles_computed=len(misses),
            cache_hits=cache_hits,
            evicted=evicted,
            full_rerun=full_rerun,
            latency_ms=(time.monotonic() - t0) * 1e3,
            tracks=tracks,
            smoothed=smoothed,
        )


class StreamSessionManager:
    """Owns every open :class:`StreamSession` and the ``serve_stream_*``
    registry families; the gRPC front door opens, feeds and closes sessions
    through it. The sessions map and the aggregate counters share one lock."""

    def __init__(
        self,
        engine: Any,
        weights: Any,
        *,
        max_sessions: int | None = None,
        chaos: Any = None,
        registry: Any = None,
    ):
        self.engine = engine
        self.weights = weights
        self.chaos = chaos
        cfg = engine.serve_config
        self.max_sessions = cfg.stream_max_sessions if max_sessions is None else int(max_sessions)
        self._lock = make_lock("serve.stream.manager")
        self._sessions: dict[str, StreamSession] = {}
        reg = registry if registry is not None else REGISTRY
        self._m_sessions = reg.counter(
            "serve_stream_sessions_total", "video sessions opened on the serve plane"
        )
        self._m_frames = reg.counter(
            "serve_stream_frames_total", "video frames served across all sessions"
        )
        self._m_hits = reg.counter(
            "serve_stream_cache_hits_total",
            "per-tile cache hits (tile bytes unchanged under the pinned "
            "model version; the device never ran them)",
        )
        self._m_misses = reg.counter(
            "serve_stream_cache_misses_total", "per-tile cache misses computed on the device"
        )
        self._m_evict = reg.counter(
            "serve_stream_cache_evictions_total",
            "tile cache entries evicted (LRU bound or version purge)",
        )
        self._m_rerun = reg.counter(
            "serve_stream_full_rerun_total",
            "frames served with zero cache hits (first frame, reset, or "
            "full-motion escape hatch)",
        )
        self._m_resets = reg.counter(
            "serve_stream_resets_total", "mid-stream session resets"
        )
        self._m_frame_s = reg.histogram("serve_stream_frame_seconds", "per-frame serve latency")
        self._m_hit_ratio = reg.gauge(
            "serve_stream_cache_hit_ratio",
            "lifetime tile-cache hit ratio across sessions (hits / tiles)",
        )
        self._m_speedup = reg.gauge(
            "serve_stream_effective_speedup_ratio",
            "effective throughput multiplier vs stateless tiling "
            "(tiles_total / tiles_computed)",
        )
        self._agg = {"tiles_total": 0, "tiles_computed": 0, "cache_hits": 0}
        self._m_hit_ratio.set_function(self._hit_ratio)
        self._m_speedup.set_function(self._speedup)

    def _hit_ratio(self) -> float:
        with self._lock:
            t = self._agg["tiles_total"]
            return (self._agg["cache_hits"] / t) if t else 0.0

    def _speedup(self) -> float:
        with self._lock:
            c = self._agg["tiles_computed"]
            t = self._agg["tiles_total"]
            return (t / c) if c else 1.0

    def open(
        self,
        stream_id: str,
        *,
        height: int,
        width: int,
        track: bool = False,
        smooth_alpha: float = 0.0,
        threshold: float = 0.5,
    ) -> StreamSession:
        session = StreamSession(
            self.engine,
            self.weights,
            height=height,
            width=width,
            track=track,
            smooth_alpha=smooth_alpha,
            threshold=threshold,
            chaos=self.chaos,
            stream_id=stream_id,
        )
        with self._lock:
            if stream_id in self._sessions:
                raise ValueError(f"stream {stream_id!r} is already open")
            if len(self._sessions) >= self.max_sessions:
                raise ValueError(f"open sessions exceed the bound ({self.max_sessions})")
            self._sessions[stream_id] = session
        self._m_sessions.inc()
        return session

    def get(self, stream_id: str) -> StreamSession | None:
        with self._lock:
            return self._sessions.get(stream_id)

    def close(self, stream_id: str) -> StreamSession | None:
        with self._lock:
            return self._sessions.pop(stream_id, None)

    def open_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def record(self, result: FrameResult) -> None:
        """Fold one frame's accounting into the registry (the front door
        calls it after each served frame)."""
        self._m_frames.inc()
        self._m_hits.inc(result.cache_hits)
        self._m_misses.inc(result.tiles_computed)
        self._m_evict.inc(result.evicted)
        if result.full_rerun:
            self._m_rerun.inc()
        self._m_frame_s.observe(result.latency_ms / 1e3)
        with self._lock:
            self._agg["tiles_total"] += result.tiles_total
            self._agg["tiles_computed"] += result.tiles_computed
            self._agg["cache_hits"] += result.cache_hits

    def record_reset(self) -> None:
        self._m_resets.inc()

    def stats(self) -> dict:
        with self._lock:
            agg = dict(self._agg)
            n_open = len(self._sessions)
        t, c = agg["tiles_total"], agg["tiles_computed"]
        return {
            "open_sessions": n_open,
            **agg,
            "hit_ratio": (agg["cache_hits"] / t) if t else 0.0,
            "effective_speedup": (t / c) if c else 1.0,
        }


def tracks_to_json(tracks: list[dict]) -> str:
    """Wire form of a track snapshot (``StreamResponse.tracks_json``)."""
    return json.dumps(tracks, sort_keys=True)
