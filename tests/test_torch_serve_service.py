"""The port's gRPC front door (``serve/service.py``) on 127.0.0.1, held
against the JAX package's server on the CPU with the same weights.

- ``Predict``: the same request stream (exact buckets, a padded and a
  tiled image, multi-chunk CRC32C framing, a bad channel count, a wrong
  CRC, a short image, a mid-request bad chunk) goes to a port server (its
  fleet behind the router) and a JAX server, from a client on the JAX
  package's ``transport_pb2`` stubs and from one on the port's codec.
  Statuses, titles (word for word), ids, sizes and versions are equal;
  every mask is byte-equal to the port engine in process, and equal to
  the JAX server's outside a 1e-4 band around the threshold.
- The assembly caps reject with the JAX titles; a queue bound answers
  ``RESOURCE_EXHAUSTED`` and never drops an admitted request.
- ``StreamPredict``: open, frames, close and the rejections, with the JAX
  server's responses; each frame's mask equal to ``Predict`` of the same
  image.
"""

import json
import threading
import time

import grpc
import numpy as np
import pytest

from fedcrack_tpu.transport import transport_pb2 as pb
from fedcrack_tpu_torch.native import crc32c
from fedcrack_tpu_torch.transport import wire as W
from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKETS = (16, 32)
BAND = 1e-4
TIMEOUT_S = 60


def _serve_kw(**over):
    kw = dict(bucket_sizes=BUCKETS, max_batch=4, max_delay_ms=5.0, tile_overlap=4)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def servers():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve import MicroBatcher as JaxBatcher
    from fedcrack_tpu.serve import ModelVersionManager as JaxManager
    from fedcrack_tpu.serve import ServeServer as JaxServer
    from fedcrack_tpu.serve import ServeServerThread as JaxThread
    from fedcrack_tpu.serve import ServeService as JaxService
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu.serve.stream import StreamSessionManager as JaxStreams
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeServerThread, ServeService
    from fedcrack_tpu_torch.serve.stream import StreamSessionManager

    var0 = jax_variables(TINY_KW, seed=0)
    engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw(replicas=2)), device="cpu")
    fleet = ServeFleet(port_config(TINY_KW), engine.serve_config, var0, shared_engine=engine, warmup=False)
    service = ServeService(engine, fleet.router, fleet.manager,
                           stream_manager=StreamSessionManager(engine, fleet.manager, max_sessions=4))
    jengine = JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw()))
    jmgr = JaxManager(jengine, var0)
    jbatcher = JaxBatcher(jengine, jmgr)
    jservice = JaxService(jengine, jbatcher, jmgr, stream_manager=JaxStreams(jengine, jmgr, max_sessions=4))
    with ServeServerThread(ServeServer(service, port=0)) as port_thread, \
            JaxThread(JaxServer(jservice, port=0)) as jax_thread:
        yield {"port": port_thread.port, "jax": jax_thread.port, "service": service, "jservice": jservice,
               "engine": engine, "weights": fleet.manager.snapshot()[1]}
    fleet.close()
    jbatcher.close()


def _call(port, path, requests, codec):
    """One bidi call; ``codec`` "jax" sends transport_pb2 messages,
    "port" the port's dataclasses. Returns the responses."""
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        grpc.channel_ready_future(channel).result(timeout=TIMEOUT_S)
        if codec == "jax":
            kind = pb.PredictRequest if path.endswith("Predict") and "Stream" not in path else pb.StreamRequest
            resp = pb.PredictResponse if kind is pb.PredictRequest else pb.StreamResponse
            stub = channel.stream_stream(path, request_serializer=kind.SerializeToString,
                                         response_deserializer=resp.FromString)
        else:
            resp = W.PredictResponse if "Stream" not in path else W.StreamResponse
            stub = channel.stream_stream(path, request_serializer=lambda m: m.encode(),
                                         response_deserializer=resp.decode)
        return list(stub(iter(requests), timeout=TIMEOUT_S))
    finally:
        channel.close()


def _chunks(codec, rid, image, n_chunks=1, crc=True, bad_crc_at=None, **over):
    cls = pb.PredictRequest if codec == "jax" else W.PredictRequest
    blob = image.tobytes()
    step = -(-len(blob) // n_chunks)
    out = []
    for k, off in enumerate(range(0, len(blob), step)):
        piece = blob[off:off + step]
        kw = dict(request_id=rid, height=image.shape[0], width=image.shape[1], channels=3, image=piece,
                  offset=off, last=off + step >= len(blob))
        if crc:
            kw["crc32c"] = 0xBAD0BAD0 if k == bad_crc_at else crc32c(piece)
        kw.update(over)
        out.append(cls(**kw))
    return out


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


IMAGES = {1: (16, 16), 2: (32, 32), 3: (20, 12), 4: (70, 45), 9: (32, 32)}


def _predict_stream(codec):
    reqs = []
    for rid, (h, w) in IMAGES.items():
        reqs += _chunks(codec, rid, _img(h, w, rid), n_chunks=3 if rid == 4 else 1, threshold=0.4 if rid == 9 else 0.0)
    bad = _img(16, 16, 5)
    reqs += _chunks(codec, 5, bad, channels=4)                     # wrong channel count
    reqs += _chunks(codec, 6, bad, bad_crc_at=0)                   # wrong CRC
    reqs += _chunks(codec, 7, bad)[:1]
    reqs[-1] = type(reqs[-1])(request_id=7, height=16, width=16, channels=3, image=bad.tobytes()[:100],
                              offset=0, last=True)                 # short image
    reqs += _chunks(codec, 8, bad, n_chunks=3, bad_crc_at=1)      # dead mid-request, one answer
    reqs += _chunks(codec, 10, _img(16, 16, 10), crc=False)       # no CRC at all
    return reqs


def _fields(r):
    return (r.request_id, r.status, r.title, r.height, r.width, r.model_version)


def _mask(r):
    return np.frombuffer(r.mask, np.uint8).reshape(r.height, r.width)


def test_predict_matches_jax_server_from_both_codecs(servers):
    port_jax = _call(servers["port"], "/fedcrack.ServePlane/Predict", _predict_stream("jax"), "jax")
    port_port = _call(servers["port"], "/fedcrack.ServePlane/Predict", _predict_stream("port"), "port")
    jax_jax = _call(servers["jax"], "/fedcrack.ServePlane/Predict", _predict_stream("jax"), "jax")
    jax_port = _call(servers["jax"], "/fedcrack.ServePlane/Predict", _predict_stream("port"), "port")
    assert [r.request_id for r in jax_jax] == [1, 2, 3, 4, 9, 5, 6, 7, 8, 10]
    for got in (port_jax, port_port, jax_port):
        assert [_fields(r) for r in got] == [_fields(r) for r in jax_jax]
    by_id = {r.request_id: r for r in port_port}
    assert [by_id[i].status for i in (5, 6, 7, 8)] == ["REJECTED"] * 4
    assert by_id[5].title == "channels must be 3 (RGB), got 4"
    assert by_id[6].title.startswith("image chunk checksum mismatch at offset 0: computed 0x")
    assert by_id[7].title == "image bytes 100 != 16x16x3"
    engine, weights = servers["engine"], servers["weights"]
    for rid in (1, 2, 3, 4, 9, 10):
        h, w = IMAGES.get(rid, (16, 16))
        probs = engine.predict_image(weights, _img(h, w, rid))[..., 0]
        threshold = 0.4 if rid == 9 else 0.5
        want = (probs > threshold).astype(np.uint8) * 255
        for got in (port_jax, port_port):
            r = next(r for r in got if r.request_id == rid)
            assert r.status == "OK" and np.array_equal(_mask(r), want), rid
        ref = _mask(next(r for r in jax_jax if r.request_id == rid))
        far = np.abs(probs - threshold) > BAND
        assert np.array_equal(_mask(by_id[rid])[far], ref[far]), rid
    assert servers["service"].tiled_served >= 2


def test_assembly_caps_reject_with_the_jax_titles(servers, monkeypatch):
    from fedcrack_tpu.serve import service as JS
    from fedcrack_tpu_torch.serve import service as TS

    for mod in (JS, TS):
        monkeypatch.setattr(mod, "MAX_PENDING_REQUESTS", 2)
        monkeypatch.setattr(mod, "MAX_PENDING_BYTES", 2000)
    img = _img(32, 32, 3)
    reqs = (_chunks("jax", 1, img, n_chunks=4)[:1] + _chunks("jax", 2, img, n_chunks=4)[:1]
            + _chunks("jax", 3, _img(16, 16, 4), n_chunks=8)[:1]      # a third open entry
            + _chunks("jax", 1, img, n_chunks=4)[1:2])                # past the byte cap
    got = _call(servers["port"], "/fedcrack.ServePlane/Predict", reqs, "jax")
    want = _call(servers["jax"], "/fedcrack.ServePlane/Predict", reqs, "jax")
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [r.title for r in got] == ["per-stream open request entries exceed the assembly cap",
                                      "per-stream pending image bytes exceed the assembly cap"]


def test_queue_bound_answers_resource_exhausted():
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.fleet import ServeFleet
    from fedcrack_tpu_torch.serve.service import ServeServer, ServeServerThread, ServeService

    class SlowBatches(InferenceEngine):
        def predict_bucket(self, variables, images_u8):
            time.sleep(0.2)
            return super().predict_bucket(variables, images_u8)

    cfg = ServeConfig(**_serve_kw(queue_bound=1))
    engine = SlowBatches(port_config(TINY_KW), cfg, device="cpu")
    fleet = ServeFleet(port_config(TINY_KW), cfg, jax_variables(TINY_KW, seed=0), shared_engine=engine,
                       warmup=False)
    service = ServeService(engine, fleet.router, fleet.manager)
    responses, errors = [], []
    try:
        with ServeServerThread(ServeServer(service, port=0)) as thread:
            def client(k):
                try:
                    reqs = [m for i in range(3) for m in _chunks("port", 10 * k + i, _img(16, 16, i))]
                    responses.extend(_call(thread.port, "/fedcrack.ServePlane/Predict", reqs, "port"))
                except Exception as e:  # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT_S)
    finally:
        fleet.close()
    assert not errors and len(responses) == 18
    shed = [r for r in responses if r.status == "RESOURCE_EXHAUSTED"]
    assert shed and all(r.title.startswith("load shed (queue_bound): ") for r in shed)
    assert all(r.status == "OK" for r in responses if r.status != "RESOURCE_EXHAUSTED")
    assert service.shed == len(shed) and service.rejected == 0
    stats = fleet.stats()["router"]
    assert stats["shed"] == {"queue_bound": len(shed)}
    assert sum(s["completed"] for s in stats["per_replica"].values()) == 18 - len(shed)


def _stream_requests(codec, frames):
    if codec == "jax":
        def req(sid, kind, **kw):
            m = pb.StreamRequest(stream_id=sid)
            getattr(m, kind).SetInParent()
            for k, v in kw.items():
                setattr(getattr(m, kind), k, v)
            return m
    else:
        cls = {"open": W.StreamOpen, "frame": W.StreamFrame, "close": W.StreamClose}

        def req(sid, kind, **kw):
            return W.StreamRequest(sid, cls[kind](**kw))
    h, w = frames[0].shape[:2]
    out = [req("cam", "open", height=h, width=w, channels=3, track=True),
           req("cam", "open", height=h, width=w, channels=3),              # already open
           req("bad", "open", height=h, width=w, channels=4),              # channels
           req("nope", "frame", frame_id=1, image=b"x", last=True)]        # not open
    for fid, frame in enumerate(frames, start=1):
        blob = frame.tobytes()
        half = len(blob) // 2
        out += [req("cam", "frame", frame_id=fid, image=blob[:half], offset=0, crc32c=crc32c(blob[:half])),
                req("cam", "frame", frame_id=fid, image=blob[half:], offset=half, last=True)]
    out += [req("cam", "frame", frame_id=99, image=b"abc", last=True, crc32c=1),  # wrong CRC
            req("cam", "frame", frame_id=98, image=b"abc", last=True),            # short frame
            req("cam", "close"), req("cam", "close"),                             # closed, then not open
            (pb.StreamRequest(stream_id="e") if codec == "jax" else W.StreamRequest("e"))]
    return out


def _stream_fields(r):
    return (r.frame_id, r.status, r.title, r.height, r.width, r.model_version, r.tiles_total,
            r.tiles_computed, r.cache_hits, r.full_rerun)


def test_stream_predict_matches_jax_server(servers):
    from fedcrack_tpu.tools.load_gen import make_frame_sequence

    frames = make_frame_sequence(4, 64, 0.25, seed=3)
    frames.insert(2, frames[1])  # a repeated frame computes no tile
    got = _call(servers["port"], "/fedcrack.ServePlane/StreamPredict", _stream_requests("port", frames), "port")
    jgot = _call(servers["port"], "/fedcrack.ServePlane/StreamPredict", _stream_requests("jax", frames), "jax")
    want = _call(servers["jax"], "/fedcrack.ServePlane/StreamPredict", _stream_requests("jax", frames), "jax")
    assert [_stream_fields(r) for r in got] == [_stream_fields(r) for r in jgot] == [
        _stream_fields(r) for r in want]
    statuses = [r.status for r in got]
    assert statuses == ["OK", "REJECTED", "REJECTED", "REJECTED"] + ["OK"] * 5 + ["REJECTED"] * 2 + [
        "OK", "REJECTED", "REJECTED"]
    assert got[4].full_rerun and got[6].tiles_computed == 0 and 0 < got[5].tiles_computed < got[5].tiles_total
    assert got[-1].title == "empty StreamRequest" and got[-3].title == "CLOSED"
    # Each frame's mask equals Predict of the same image at the same version.
    predicts = _call(servers["port"], "/fedcrack.ServePlane/Predict",
                     [m for i, f in enumerate(frames) for m in _chunks("port", i, f)], "port")
    for frame_resp, pred in zip(got[4:9], predicts):
        assert frame_resp.model_version == pred.model_version
        assert frame_resp.mask == pred.mask
        assert isinstance(json.loads(frame_resp.tracks_json), list)
    assert servers["service"].stream_manager.open_sessions() == 0
