"""Federation: the msgpack weight blob, the aggregation algebra, FedOpt,
the round state machine and FedBuff's buffered aggregation (the
counterpart of ``fedcrack_tpu.fed``)."""

from fedcrack_tpu_torch.fed.algorithms import (  # noqa: F401
    fedavg,
    fedprox_penalty,
    sample_cohort,
)
from fedcrack_tpu_torch.fed.serialization import (  # noqa: F401
    tree_from_bytes,
    tree_to_bytes,
    validate_update,
)
from fedcrack_tpu_torch.fed.rounds import (  # noqa: F401
    ServerState,
    decode_and_validate_update,
    initial_state,
    quorum_target,
    transition,
)
