"""FedAvg over gRPC (the counterpart of ``fedcrack_tpu.transport``): the
hand-written protobuf codec, the server and the client. The package's
top level does not import this one, so the rest of the port imports
without ``grpc``."""

from fedcrack_tpu_torch.transport.client import FedClient  # noqa: F401
from fedcrack_tpu_torch.transport.service import FedServer  # noqa: F401
