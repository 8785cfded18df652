"""The privacy plane (the counterpart of ``fedcrack_tpu.privacy``): what
the federation may learn about an honest client.

- :mod:`~fedcrack_tpu_torch.privacy.accountant`: the RDP accountant that
  turns (noise multiplier, sampling rate, steps) into a cumulative
  per-client epsilon(delta), recorded in the round history and kept in
  the statefile.
- :mod:`~fedcrack_tpu_torch.privacy.dpsgd`: update-level DP on the host
  (clip the round's delta, add one seeded Gaussian draw), which the
  client command line applies before upload, and the per-step DP-SGD
  transform the slot plane applies to each step's gradients.
- :mod:`~fedcrack_tpu_torch.privacy.secagg`: pairwise-mask secure
  aggregation over the gRPC rounds, exact modular cancellation in numpy
  ``uint64`` and dropout recovery from the enroll seeds.

Secure aggregation composes only with the plain FedAvg fold: masked
updates are opaque to the health ledger, so the config refuses robust
combines and quarantine with it.
"""

from fedcrack_tpu_torch.privacy.accountant import (  # noqa: F401
    DEFAULT_ORDERS,
    PrivacyAccountant,
    compute_epsilon,
    rdp_subsampled_gaussian,
    rdp_to_epsilon,
)
from fedcrack_tpu_torch.privacy.secagg import (  # noqa: F401
    SECAGG_MAGIC,
    client_seed,
    decode_masked,
    fixed_point_encode,
    is_masked_blob,
    mask_update,
    pair_mask,
    round_roster,
    unmask_sum,
    unmasked_mean,
    validate_masked,
)
