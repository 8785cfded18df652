"""Deterministic fault injection (the counterpart of ``fedcrack_tpu.chaos``).

:mod:`plan` is the pure, seeded fault schedule; :mod:`inject` adapts it to
the transport client (``FedClient(chaos=ClientChaos(plan))``), the serving
batcher and fleet (``chaos=ServeChaos(plan)``) and the video sessions
(``chaos=StreamChaos(plan)``). Nothing here runs unless a plan is attached.
The package imports without grpc: :class:`InjectedRpcError`, a
``grpc.RpcError``, lives in ``transport/faults.py`` and is loaded on first
access.
"""

from fedcrack_tpu_torch.chaos.inject import (
    ClientChaos,
    InjectedCrash,
    InjectedDeviceFailure,
    MeshChaos,
    ServeChaos,
    StreamChaos,
)
from fedcrack_tpu_torch.chaos.plan import (
    ALL_KINDS,
    CLIENT_KINDS,
    CORRUPT_COMPRESSED_FRAME,
    CORRUPT_PAYLOAD,
    CRASH_AFTER_UPLOAD,
    CRASH_BEFORE_UPLOAD,
    CRASH_DURING_UPLOAD,
    EDGE_AGGREGATOR_CRASH,
    FLEET_KINDS,
    MESH_DEVICE_FAIL,
    MESH_KINDS,
    MESH_NONFINITE,
    NAN_UPDATE,
    NETWORK_FLAP,
    REPLICA_CRASH_DURING_SCALE,
    SCALED_UPDATE,
    SECAGG_DROPOUT,
    SERVE_DEVICE_LOSS,
    SERVE_KINDS,
    SERVE_REPLICA_CRASH,
    SERVE_STREAM_RESET,
    SERVE_SWAP_MIDFLIGHT,
    SHADOW_REPLICA_CRASH,
    STALE_REPLAY,
    STORM_KINDS,
    STRAGGLER_DELAY,
    STRAGGLER_STORM,
    STREAM_KINDS,
    TREE_KINDS,
    TRUNCATE_PAYLOAD,
    Fault,
    FaultPlan,
)


def __getattr__(name: str):
    if name == "InjectedRpcError":
        from fedcrack_tpu_torch.transport.faults import InjectedRpcError

        return InjectedRpcError
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ALL_KINDS",
    "CLIENT_KINDS",
    "CORRUPT_COMPRESSED_FRAME",
    "CORRUPT_PAYLOAD",
    "CRASH_AFTER_UPLOAD",
    "CRASH_BEFORE_UPLOAD",
    "CRASH_DURING_UPLOAD",
    "ClientChaos",
    "EDGE_AGGREGATOR_CRASH",
    "FLEET_KINDS",
    "Fault",
    "FaultPlan",
    "InjectedCrash",
    "InjectedDeviceFailure",
    "InjectedRpcError",
    "MESH_DEVICE_FAIL",
    "MESH_KINDS",
    "MESH_NONFINITE",
    "MeshChaos",
    "NAN_UPDATE",
    "NETWORK_FLAP",
    "REPLICA_CRASH_DURING_SCALE",
    "SCALED_UPDATE",
    "SECAGG_DROPOUT",
    "SERVE_DEVICE_LOSS",
    "SERVE_KINDS",
    "SERVE_REPLICA_CRASH",
    "SERVE_STREAM_RESET",
    "SERVE_SWAP_MIDFLIGHT",
    "SHADOW_REPLICA_CRASH",
    "STALE_REPLAY",
    "STORM_KINDS",
    "STRAGGLER_DELAY",
    "STRAGGLER_STORM",
    "STREAM_KINDS",
    "ServeChaos",
    "StreamChaos",
    "TREE_KINDS",
    "TRUNCATE_PAYLOAD",
]
