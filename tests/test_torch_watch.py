"""The port's watch layer held against the JAX package's on the CPU:
``obs/sentries`` (the leak sentry), ``obs/flight``'s crash hooks (a dump
on a thread's unhandled exception and on SIGUSR2) and ``obs/watchdog``
(the statistics, consecutive breaches, the breach dump and the rule
files). Mirrors tests/test_telemetry.py's tests of the same names; the
watchdog's reports are compared with the JAX watchdog's on the same
registry, and ``default_rules()`` with the JAX package's and
``configs/slo_default.json``, field for field.
"""

import dataclasses
import json
import os
import threading
import time

import pytest

from fedcrack_tpu_torch.obs import sentries
from fedcrack_tpu_torch.obs.promexp import parse_prometheus_text, sample_value
from fedcrack_tpu_torch.obs.registry import MetricsRegistry

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- leak sentries ----


def test_leak_sentry_steady_and_tripping(monkeypatch):
    reg = MetricsRegistry()
    fake = {"rss": 1000}
    monkeypatch.setattr(sentries, "rss_bytes", lambda: fake["rss"])
    monkeypatch.setattr(sentries, "device_memory_bytes", lambda: 0)
    sentry = sentries.LeakSentry(registry=reg, rss_slack_bytes=500)
    sentry.mark()
    fake["rss"] = 1400  # inside the slack
    sentry.assert_steady()
    assert sentry.steady()
    fake["rss"] = 1600  # past the slack: a leak
    with pytest.raises(sentries.LeakError, match="RSS grew 600"):
        sentry.assert_steady()
    parsed = parse_prometheus_text(reg.exposition())
    assert sample_value(parsed, "process_resident_bytes") == 1600
    assert sample_value(parsed, "process_resident_watermark_bytes") == 1600
    summary = sentry.summary()
    assert summary["steady"] is False and summary["deltas"]["rss"] == 600


def test_leak_sentry_device_half_trips_on_growth(monkeypatch):
    reg = MetricsRegistry()
    dev = {"b": 10}
    monkeypatch.setattr(sentries, "rss_bytes", lambda: 1)
    monkeypatch.setattr(sentries, "device_memory_bytes", lambda: dev["b"])
    sentry = sentries.LeakSentry(registry=reg, device_slack_bytes=100)
    sentry.mark()
    dev["b"] = 500
    with pytest.raises(sentries.LeakError, match="device memory grew 490"):
        sentry.assert_steady()
    dev["b"] = 20  # a spike that drained back is no leak; the watermark keeps it
    sentry.assert_steady()
    assert sentry.watermarks()["device"] == 500
    parsed = parse_prometheus_text(reg.exposition())
    assert sample_value(parsed, "device_memory_watermark_bytes") == 500


def test_leak_sentry_real_process_watermarks():
    import torch

    sentry = sentries.LeakSentry(registry=MetricsRegistry())
    reading = sentry.sample()
    assert reading["rss"] > 0
    assert sentry.watermarks()["rss"] >= reading["rss"] > 0
    # torch.cuda.memory_allocated where there is CUDA; 0 where there is
    # none, as the JAX package reads 0 on a backend without memory stats.
    if not torch.cuda.is_available():
        assert reading["device"] == 0 == sentries.device_memory_bytes()
    with pytest.raises(RuntimeError, match="before mark"):
        sentries.LeakSentry(registry=MetricsRegistry()).deltas()


# ---- the flight recorder's crash hooks ----


def test_flight_ring_bounded_and_spans_feed_it(tmp_path):
    from fedcrack_tpu_torch.obs import flight
    from fedcrack_tpu_torch.obs import spans as tracing

    ring = flight.install(path=str(tmp_path / "flight.json"), capacity=8)
    try:
        for i in range(20):
            flight.note("x", i=i)
        events = ring.snapshot()
        assert len(events) == 8 and [e["i"] for e in events] == list(range(12, 20))
        assert tracing.current() is None
        with tracing.span("fed.flush", trace="fedtr-v1", ctx="fedtr-v1#flush:v2"):
            pass
        last = ring.snapshot()[-1]
        assert last["kind"] == "span" and last["name"] == "fed.flush" and last["ctx"] == "fedtr-v1#flush:v2"
        payload = json.loads(open(flight.dump("unit test")).read())
        assert payload["reason"] == "unit test" and payload["events_seen"] == 21
        assert "metrics_exposition" in payload
    finally:
        flight.uninstall()
    assert flight.current() is None
    flight.note("after", x=1)
    assert flight.dump("after") is None


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_flight_dump_on_thread_crash_and_sigusr2(tmp_path):
    """An unhandled exception in a thread and SIGUSR2 both write the ring
    to disk; the hooks are chained, and ``uninstall`` restores them."""
    import signal
    import sys

    from fedcrack_tpu_torch.obs import flight

    before = (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR2))
    path = str(tmp_path / "flight.json")
    flight.install(path=path, capacity=64)
    try:
        assert threading.excepthook is not before[1]
        flight.note("before_crash", detail="context the post-mortem needs")

        def boom():
            raise RuntimeError("injected thread death")

        t = threading.Thread(target=boom, name="doomed")
        t.start()
        t.join()
        payload = json.loads(open(path).read())
        assert "injected thread death" in payload["reason"] and "doomed" in payload["reason"]
        assert any(e["kind"] == "before_crash" for e in payload["events"])
        os.remove(path)
        os.kill(os.getpid(), signal.SIGUSR2)
        for _ in range(100):
            if os.path.exists(path):
                break
            time.sleep(0.01)
        assert json.loads(open(path).read())["reason"] == "SIGUSR2"
    finally:
        flight.uninstall()
    assert (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGUSR2)) == before
    # hooks=False arms the ring only.
    flight.install(path=path, hooks=False)
    try:
        assert threading.excepthook is before[1]
    finally:
        flight.uninstall()


# ---- the SLO watchdog ----


def _watchdog_registry(cls):
    reg = cls()
    reg.counter("fed_updates_total", "u", labels=("result",)).labels(result="accepted").inc(10)
    h = reg.histogram("serve_request_seconds", "lat", buckets=(0.1, 1.0, 10.0))
    for v in [0.05] * 90 + [0.5] * 9 + [5.0]:
        h.observe(v)
    reg.gauge("serve_recompiles_total", "r").set(0)
    return reg


def _rules(wdm):
    return [
        wdm.SloRule(name="v", metric="fed_updates_total", labels={"result": "accepted"}, op=">=", threshold=10),
        wdm.SloRule(name="p95", metric="serve_request_seconds", stat="p95", op="<=", threshold=1.0),
        wdm.SloRule(name="p50", metric="serve_request_seconds", stat="p50", op="<=", threshold=0.1),
        wdm.SloRule(name="p99", metric="serve_request_seconds", stat="p99", op="<=", threshold=1.0),
        wdm.SloRule(name="n", metric="serve_request_seconds", stat="count", op="==", threshold=100),
        wdm.SloRule(name="s", metric="serve_request_seconds", stat="sum", op="<=", threshold=100),
        wdm.SloRule(name="rate", metric="fed_updates_total", labels={"result": "accepted"}, stat="rate",
                    op=">=", threshold=1.0, min_elapsed_s=0.01),
        wdm.SloRule(name="absent", metric="no_such_total", op="==", threshold=0),
    ]


def test_watchdog_stats_value_quantile_and_rate():
    """Each statistic against the JAX watchdog on the same registry
    contents: the same values (rates aside, which read two clocks), the
    same verdicts, the same audit."""
    from fedcrack_tpu.obs import registry as jax_registry
    from fedcrack_tpu.obs import watchdog as jwdm
    from fedcrack_tpu_torch.obs import watchdog as wdm

    reg, jreg = _watchdog_registry(MetricsRegistry), _watchdog_registry(jax_registry.MetricsRegistry)
    wd, jwd = wdm.Watchdog(_rules(wdm), registry=reg), jwdm.Watchdog(_rules(jwdm), registry=jreg)
    r1 = {r["rule"]: r for r in wd.evaluate()["results"]}
    j1 = {r["rule"]: r for r in jwd.evaluate()["results"]}
    assert r1 == j1
    assert r1["v"]["value"] == 10 and r1["v"]["ok"]
    assert 0.1 < r1["p95"]["value"] <= 1.0 and r1["p95"]["ok"]
    assert r1["p50"]["value"] <= 0.1 and r1["n"]["value"] == 100
    assert r1["rate"]["value"] is None and r1["absent"]["value"] is None and r1["absent"]["breach"] is False
    time.sleep(0.02)
    for r in (reg, jreg):
        r.counter("fed_updates_total", labels=("result",)).labels(result="accepted").inc(5)
    r2 = {r["rule"]: r for r in wd.evaluate()["results"]}
    j2 = {r["rule"]: r for r in jwd.evaluate()["results"]}
    assert r2["rate"]["value"] > 0 and r2["rate"]["ok"] and j2["rate"]["ok"]
    assert {k: v for k, v in r2.items() if k != "rate"} == {k: v for k, v in j2.items() if k != "rate"}
    audit = wd.audit()
    assert audit == jwd.audit()
    assert audit["breaches"] == [] and audit["evaluations"] == 2
    assert audit["never_determinate"] == ["absent"] and not audit["clean"]


def test_watchdog_consecutive_rides_out_blips():
    from fedcrack_tpu_torch.obs import watchdog as wdm

    reg = MetricsRegistry()
    g = reg.gauge("fed_buffer_fill_ratio", "fill")
    wd = wdm.Watchdog([wdm.SloRule(name="floor", metric="fed_buffer_fill_ratio", op=">=", threshold=1.0,
                                   consecutive=3)], registry=reg)

    def one(value):
        g.set(value)
        return wd.evaluate()["breaches"]

    assert [bool(one(v)) for v in (0.0, 0.0, 2.0, 0.0, 0.0, 0.0)] == [False] * 5 + [True]
    audit = wd.audit()
    assert len(audit["breaches"]) == 1 and not audit["clean"]
    with pytest.raises(ValueError, match="consecutive"):
        wdm.SloRule(name="x", metric="y_total", op="==", threshold=0, consecutive=0)


def test_watchdog_breach_dumps_flight_and_audits_dirty(tmp_path):
    from fedcrack_tpu_torch.obs import flight
    from fedcrack_tpu_torch.obs import watchdog as wdm

    reg = _watchdog_registry(MetricsRegistry)
    rules = [wdm.SloRule(name="impossible", metric="fed_updates_total", labels={"result": "accepted"}, op=">=",
                         threshold=1e12, on_missing="breach")]
    path = str(tmp_path / "flight.json")
    flight.install(path=path)
    try:
        wd = wdm.Watchdog(rules, registry=reg)
        assert wd.enforce()["breaches"][0]["rule"] == "impossible"
        payload = json.loads(open(path).read())
        assert payload["reason"] == "watchdog breach: impossible"
        assert any(e["kind"] == "watchdog.eval" for e in payload["events"])
        wd.enforce()  # a second breach does not dump again
        audit = wd.audit()
        assert not audit["clean"] and len(audit["breaches"]) == 2
    finally:
        flight.uninstall()
    assert wdm.BREACH_EXIT == 3


def test_watchdog_rule_files_parse_and_default_config_matches(tmp_path):
    """``configs/slo_default.json`` is the built-in rule set, which is the
    JAX package's, field for field; malformed rule files fail loudly."""
    from fedcrack_tpu.obs import watchdog as jwdm
    from fedcrack_tpu_torch.obs import watchdog as wdm

    loaded = wdm.load_rules(os.path.join(ROOT, "configs", "slo_default.json"))
    assert loaded == wdm.default_rules()
    assert [dataclasses.asdict(r) for r in wdm.default_rules()] == [dataclasses.asdict(r)
                                                                     for r in jwdm.default_rules()]
    smoke = wdm.load_rules(os.path.join(ROOT, "configs", "slo_breach_smoke.json"))
    assert smoke[0].on_missing == "breach" and smoke[0].threshold >= 1e12
    bad = tmp_path / "bad.json"
    for payload, match in (({"rules": []}, "non-empty"), ({"rules": [1]}, "not an object"),
                           ({"rules": [{"name": "a", "metric": "m", "op": "<=", "threshold": 1, "x": 2}]},
                            "unknown keys")):
        bad.write_text(json.dumps(payload))
        with pytest.raises(ValueError, match=match):
            wdm.load_rules(str(bad))
    with pytest.raises(ValueError, match="unknown op"):
        wdm.SloRule(name="x", metric="y_total", op="~", threshold=1)
    with pytest.raises(ValueError, match="unknown stat"):
        wdm.SloRule(name="x", metric="y_total", op="<=", threshold=1, stat="p42")
    with pytest.raises(ValueError, match="duplicate"):
        wdm.Watchdog([wdm.SloRule(name="a", metric="x_total", op="==", threshold=0)] * 2)


def test_watchdog_main_exit_codes(tmp_path, capsys):
    from fedcrack_tpu_torch.obs import watchdog as wdm
    from fedcrack_tpu_torch.obs.promexp import MetricsExporter

    reg = _watchdog_registry(MetricsRegistry)
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps({"rules": [
        {"name": "p95", "metric": "serve_request_seconds", "stat": "p95", "op": "<=", "threshold": 5.0}]}))
    with MetricsExporter(registry=reg, port=0) as exporter:
        assert wdm.main(["--url", exporter.url, "--rules", str(clean), "--count", "1"]) == 0
        audit = json.loads(capsys.readouterr().out)
        assert audit["clean"] and audit["rules"] == ["p95"]
        smoke = os.path.join(ROOT, "configs", "slo_breach_smoke.json")
        assert wdm.main(["--url", exporter.url, "--rules", smoke, "--count", "1",
                         "--flight-dump", str(tmp_path / "dump.json")]) == wdm.BREACH_EXIT
    from fedcrack_tpu_torch.obs import flight

    flight.uninstall()
    out = capsys.readouterr().out
    assert out.startswith("BREACH ") and json.loads((tmp_path / "dump.json").read_text())["reason"].startswith(
        "watchdog breach")
