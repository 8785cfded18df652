"""Federation health: the per-client update ledger and its anomaly
scores (the counterpart of ``fedcrack_tpu.health``; the canary and drift
monitors are not ported yet)."""

from fedcrack_tpu_torch.health.ledger import (  # noqa: F401
    ANOMALY_ALERT,
    LEDGER_WINDOW,
    cohort_geometry,
    ledger_from_wire,
    ledger_to_wire,
    new_record,
    observe_flush,
    record_offer,
    record_quarantine,
    robust_z,
    update_norm,
)
