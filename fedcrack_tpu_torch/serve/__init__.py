"""The serving plane: engine, batcher, quant gate, version manager, the
fleet with its router and autoscaler, video stream sessions, and the gRPC
front door (``serve/service.py``, the one module here that imports grpc;
``python -m fedcrack_tpu_torch.serve``)."""
