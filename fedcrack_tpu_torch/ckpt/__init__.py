"""Durable server state (the counterpart of ``fedcrack_tpu.ckpt``): the
round checkpointer (``manager.py``, one step per model version, restored
at boot) and the mid-round statefile (``statefile.py``, a snapshot on
every change, which wins at an equal model version)."""

from fedcrack_tpu_torch.ckpt.manager import (  # noqa: F401
    FedCheckpoint,
    FedCheckpointer,
    restore_server_state,
    save_server_state,
)
from fedcrack_tpu_torch.ckpt.statefile import (  # noqa: F401
    STATE_FORMAT,
    load_state_file,
    save_state_file,
    server_state_from_bytes,
    server_state_to_bytes,
)
