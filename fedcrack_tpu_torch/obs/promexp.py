"""Prometheus ``/metrics`` exposition over a stdlib HTTP server thread
(the counterpart of ``fedcrack_tpu.obs.promexp``).

``MetricsExporter(registry)`` binds a ``ThreadingHTTPServer`` (port 0 =
ephemeral, like every other harness-facing port in the repo), serves the
registry's text-format v0.0.4 exposition at ``GET /metrics`` (anything else
is 404; ``/healthz`` answers a small JSON liveness body — registry family
count, uptime, spans-installed flag, git describe when available — so a
load balancer can tell "up" from "warm"), and shuts down cleanly. No
third-party client library: the registry writes the text format
(``registry.exposition()``), :func:`parse_prometheus_text` reads it back,
and the stdlib server is one daemon thread. :func:`scrape` is HTTP GET
plus the parse.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from fedcrack_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

log = logging.getLogger("fedcrack.obs.promexp")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
HEALTH_CONTENT_TYPE = "application/json; charset=utf-8"

_GIT_DESCRIBE: list[str | None] = []  # lazy one-shot cache ([] = not asked yet)


def git_describe() -> str | None:
    """``git describe --always --dirty`` of the installed tree, cached
    after the first call; None outside a git checkout (deployed wheels) —
    the /healthz body then simply omits a build id."""
    if not _GIT_DESCRIBE:
        describe: str | None = None
        try:
            import subprocess

            out = subprocess.run(
                ["git", "describe", "--always", "--dirty"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True,
                timeout=5,
            )
            if out.returncode == 0:
                describe = out.stdout.decode("utf-8", "replace").strip() or None
        except Exception:
            describe = None
        _GIT_DESCRIBE.append(describe)
    return _GIT_DESCRIBE[0]


class MetricsExporter:
    """One daemon-threaded HTTP endpoint over one registry."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.registry = registry if registry is not None else REGISTRY
        self._host = host
        self._port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.bound_port: int | None = None

    def start(self) -> int:
        """Bind and serve; returns the bound port (ephemeral when port=0)."""
        if self._httpd is not None:
            assert self.bound_port is not None
            return self.bound_port
        registry = self.registry
        t_started = time.monotonic()
        # Resolved ONCE at start, off the request path: a liveness probe
        # must never block on a subprocess (git can hang on a network
        # filesystem for longer than a load balancer's timeout).
        git_id = git_describe()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.exposition().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    # A JSON body, so a load balancer can tell "up" from
                    # "warm": families > 0 means the planes have
                    # instrumented, spans_installed that traces are kept.
                    from fedcrack_tpu_torch.obs import spans as _spans

                    payload = {
                        "status": "ok",
                        "families": len(registry.families()),
                        "uptime_seconds": round(
                            time.monotonic() - t_started, 3
                        ),
                        "spans_installed": _spans.current() is not None,
                        "git": git_id,
                    }
                    body = (
                        json.dumps(payload, sort_keys=True) + "\n"
                    ).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", HEALTH_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404, "only /metrics and /healthz live here")

            def log_message(self, fmt: str, *args: Any) -> None:
                log.debug("metrics-http %s", fmt % args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self.bound_port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
        )
        self._thread.start()
        return self.bound_port

    @property
    def url(self) -> str:
        if self.bound_port is None:
            raise RuntimeError("exporter not started")
        return f"http://{self._host}:{self.bound_port}/metrics"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsExporter":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def start_exporter(
    port: int, registry: MetricsRegistry | None = None, host: str = "127.0.0.1"
) -> MetricsExporter | None:
    """The server's ``--metrics-port``: 0/None disables (returns None);
    ``-1`` binds an ephemeral port (read ``exporter.bound_port``); a
    positive port binds it."""
    if not port:
        return None
    port = int(port)
    exporter = MetricsExporter(
        registry, host=host, port=0 if port < 0 else port
    )
    bound = exporter.start()
    log.info("serving /metrics on http://%s:%d/metrics", host, bound)
    return exporter


def _unescape_help(text: str) -> str:
    """Decode ``\\\\`` and ``\\n`` in ONE left-to-right pass — sequential
    ``str.replace`` calls mis-decode a literal backslash followed by 'n'
    (``\\\\n`` would first match as ``\\n``)."""
    out: list[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_number(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def _parse_labels(body: str) -> tuple[tuple[str, str], ...]:
    """``a="x",b="y"`` -> (("a","x"), ("b","y")) with escape handling."""
    pairs: list[tuple[str, str]] = []
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value near {body[eq:]!r}")
        j = eq + 2
        out: list[str] = []
        while True:
            ch = body[j]
            if ch == "\\":
                nxt = body[j + 1]
                out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                j += 2
            elif ch == '"':
                j += 1
                break
            else:
                out.append(ch)
                j += 1
        pairs.append((name, "".join(out)))
        i = j
        while i < len(body) and body[i] in ", ":
            i += 1
    return tuple(pairs)


def parse_prometheus_text(text: str) -> dict:
    """Parse text-format v0.0.4 into
    ``{metric: {"type": ..., "help": ..., "samples": {labels_tuple: value}}}``
    where ``labels_tuple`` is the sorted ``(name, value)`` pair tuple and
    histogram series appear under their ``_bucket``/``_sum``/``_count``
    sample names (grouped back onto the base metric). Raises ``ValueError``
    on any line it cannot account for."""
    metrics: dict[str, dict] = {}
    types: dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            metrics.setdefault(
                name, {"type": None, "help": "", "samples": {}}
            )["help"] = _unescape_help(help_text)
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            metrics.setdefault(name, {"type": None, "help": "", "samples": {}})
            metrics[name]["type"] = kind.strip()
            types[name] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        try:
            if "{" in line:
                name = line[: line.index("{")]
                body = line[line.index("{") + 1 : line.rindex("}")]
                value_txt = line[line.rindex("}") + 1 :].strip().split()[0]
                labels = tuple(sorted(_parse_labels(body)))
            else:
                name, value_txt = line.split()[:2]
                labels = ()
            value = _parse_number(value_txt)
        except (ValueError, IndexError) as e:
            raise ValueError(f"unparseable exposition line {lineno}: {raw!r}") from e
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)] if name.endswith(suffix) else None
            if stem is not None and types.get(stem) == "histogram":
                base = stem
                labels = tuple(sorted(labels + (("__sample__", suffix),)))
                break
        metrics.setdefault(base, {"type": None, "help": "", "samples": {}})
        metrics[base]["samples"][labels] = value
    return metrics


def sample_value(
    parsed: dict, name: str, labels: dict[str, str] | None = None
) -> float | None:
    """One sample out of a :func:`parse_prometheus_text` result; None when
    the metric or label set is absent."""
    fam = parsed.get(name)
    if fam is None:
        return None
    key = tuple(sorted((labels or {}).items()))
    return fam["samples"].get(key)


def scrape(url: str, timeout_s: float = 5.0) -> dict:
    """HTTP GET of ``url`` and :func:`parse_prometheus_text` of the body."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        body = resp.read().decode("utf-8")
    return parse_prometheus_text(body)
