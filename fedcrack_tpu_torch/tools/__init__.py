"""Command-line tools of the port: crack quantification
(``tools/quantify.py``), the serving plane's load generator
(``tools/load_gen.py``) and the joined health report
(``tools/health_report.py``); the counterparts of the JAX package's tools
of the same names."""

from fedcrack_tpu_torch.tools.quantify import CrackStats, quantify_mask  # noqa: F401
