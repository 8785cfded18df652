"""Federation health: the per-client update ledger and its anomaly scores
(``health/ledger.py``), the canary evaluator that probes every installed
version (``health/canary.py``) and the serve-side drift monitor
(``health/drift.py``); the counterpart of ``fedcrack_tpu.health``."""

from fedcrack_tpu_torch.health.ledger import (  # noqa: F401
    ANOMALY_ALERT,
    LEDGER_WINDOW,
    cohort_geometry,
    conservation,
    export_anomaly_metrics,
    ledger_from_wire,
    ledger_to_wire,
    new_record,
    observe_flush,
    read_ledger_jsonl,
    record_offer,
    record_quarantine,
    robust_z,
    update_norm,
    write_ledger_jsonl,
)
