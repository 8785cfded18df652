"""Durable server state (the counterpart of ``fedcrack_tpu.ckpt``): the
mid-round statefile. The orbax round-boundary checkpointer
(``ckpt/manager.py``) is not ported yet."""

from fedcrack_tpu_torch.ckpt.statefile import (  # noqa: F401
    STATE_FORMAT,
    load_state_file,
    save_state_file,
    server_state_from_bytes,
    server_state_to_bytes,
)
