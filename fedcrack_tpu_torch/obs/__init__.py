"""Observability the transport uses (the counterpart of part of
``fedcrack_tpu.obs``): the metric registry, trace spans and the flight
recorder."""
