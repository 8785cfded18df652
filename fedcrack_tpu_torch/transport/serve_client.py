"""A client of the serving plane's gRPC front door.

The channel to a ``fedcrack.ServePlane`` server and its two bidi-streaming
stub callables, bound by hand on the port's wire codec
(``transport/wire.py``) as the server binds them (``serve/service.py``).
It keeps ``grpc`` inside the transport: ``tools/load_gen.py`` drives the
front door through it and imports no ``grpc`` of its own.

    channel = serve_channel("127.0.0.1:8890")
    predict = predict_stub(channel)        # iterator of PredictRequest in,
    answers = predict(iter(requests))      # iterator of PredictResponse out
"""

from __future__ import annotations

import grpc

from fedcrack_tpu_torch.serve.service import OK, PREDICT_PATH, REJECTED, SHED, STREAM_PATH
from fedcrack_tpu_torch.transport import wire
from fedcrack_tpu_torch.transport.service import channel_options

# The answer statuses are re-exported: a client reads them from here.
__all__ = ["OK", "REJECTED", "SHED", "predict_stub", "serve_channel", "stream_stub"]


def serve_channel(target: str, max_message_mb: int = 64, ready_timeout_s: float = 30.0) -> grpc.Channel:
    """An insecure channel to ``target`` (``host:port``), ready or raising
    ``grpc.FutureTimeoutError`` after ``ready_timeout_s``."""
    channel = grpc.insecure_channel(target, options=channel_options(max_message_mb))
    try:
        grpc.channel_ready_future(channel).result(timeout=ready_timeout_s)
    except BaseException:
        channel.close()
        raise
    return channel


def predict_stub(channel: grpc.Channel):
    """The ``Predict`` call: ``stub(iter(PredictRequest)) -> iter(PredictResponse)``."""
    return channel.stream_stream(
        PREDICT_PATH, request_serializer=wire.PredictRequest.encode,
        response_deserializer=wire.PredictResponse.decode,
    )


def stream_stub(channel: grpc.Channel):
    """The ``StreamPredict`` call: ``stub(iter(StreamRequest)) -> iter(StreamResponse)``."""
    return channel.stream_stream(
        STREAM_PATH, request_serializer=wire.StreamRequest.encode,
        response_deserializer=wire.StreamResponse.decode,
    )
