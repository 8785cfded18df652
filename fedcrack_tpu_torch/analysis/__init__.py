"""The lock factory the telemetry uses (the counterpart of ``make_lock`` in
``fedcrack_tpu.analysis.sanitizers``)."""
