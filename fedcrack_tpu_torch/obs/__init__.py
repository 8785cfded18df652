"""Observability the transport uses (the counterpart of part of
``fedcrack_tpu.obs``): the metric registry, trace spans, the flight
recorder and the streaming percentiles of FedBuff's summary."""
