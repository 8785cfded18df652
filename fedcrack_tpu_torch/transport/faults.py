"""The injected transport failure of the chaos plane.

:class:`InjectedRpcError` subclasses ``grpc.RpcError``, so it lives under
``transport/``, the one part of the port that imports ``grpc``;
``fedcrack_tpu_torch.chaos`` reaches it lazily and imports without grpc.
"""

from __future__ import annotations

import grpc


class InjectedRpcError(grpc.RpcError):
    """A synthetic transient transport failure. It carries UNAVAILABLE, the
    code real gRPC raises for a flapping network, so the client's
    retryable / non-retryable split treats it exactly like the real thing."""

    def __init__(self, message: str = "injected network flap"):
        super().__init__(message)
        self._message = message

    def code(self) -> grpc.StatusCode:
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return self._message
