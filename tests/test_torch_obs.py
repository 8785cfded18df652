"""The port's telemetry (obs/metrics.py, obs/tb.py, obs/promexp.py and the
``local_fit`` record of train/federated.py) held against the JAX package.

The same records and values go through both packages' writers: JSONL
records equal apart from their time fields, TensorBoard files byte-equal
at a fixed wall time, the Prometheus parser equal on the same text (and
through a real HTTP scrape of the port's exporter), and one federated
round of ``make_train_fn`` on each side with equal ``local_fit`` records
(metrics within the rtol 1e-4 of tests/test_torch_train.py) and equal
histogram tags.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, jax_variables

pytestmark = pytest.mark.torch_port

WALL = 1_700_000_000.25


def _records(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _fields():
    """Records covering every branch of the JSON coercion."""
    return [
        ("round", dict(round=1, loss=0.25, n=np.int64(7), acc=np.float32(0.5), ok=True, none=None)),
        ("round", dict(round=2, nested={"a": [1, np.float64(2.5)], 3: "x"}, tup=(1, 2), nan=float("nan"),
                       npnan=np.float32("nan"), inf=np.float64("inf"), obj={1, 2})),
        ("epoch", dict(epoch=0, train_loss=1.5, val_iou=np.float32(0.125), flag=False)),
        ("session", dict(enrolled=True, rounds_completed=2, name="client_0")),
    ]


def test_metrics_logger_records_equal_to_jax(tmp_path, monkeypatch):
    """JSONL records equal but for ``t``/``ts``; the TensorBoard tee byte-equal."""
    import time

    from fedcrack_tpu.obs.metrics import MetricsLogger as JaxLogger
    from fedcrack_tpu.obs.metrics import read_metrics as jax_read
    from fedcrack_tpu_torch.obs.metrics import MetricsLogger, read_metrics

    monkeypatch.setattr(time, "time", lambda: WALL)
    echoed = []
    paths = {}
    for name, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        paths[name] = (tmp_path / f"{name}.jsonl", tmp_path / f"tb_{name}")
        with cls(paths[name][0], echo=echoed.append if name == "port" else None, tb_dir=paths[name][1]) as log:
            for kind, fields in _fields():
                log.log(kind, **fields)
            assert log.tb_enabled
    got, want = _records(paths["port"][0]), _records(paths["jax"][0])
    assert len(got) == len(want) == 4 and len(echoed) == 4
    for g, w in zip(got, want):
        assert g.pop("t") >= 0 and w.pop("t") >= 0
        assert g.pop("ts") == w.pop("ts") == WALL
        assert json.dumps(g, sort_keys=True) == json.dumps(w, sort_keys=True)
    assert read_metrics(paths["port"][0], kind="round") == [r for r in _records(paths["port"][0])
                                                             if r["kind"] == "round"]
    assert [r["kind"] for r in jax_read(paths["port"][0])] == ["round", "round", "epoch", "session"]
    (g_file,), (w_file,) = (list(paths[n][1].iterdir()) for n in ("port", "jax"))
    assert g_file.read_bytes() == w_file.read_bytes()


def test_tb_event_files_byte_equal_to_jax(tmp_path, monkeypatch):
    import time

    from fedcrack_tpu.obs import tb as jtb
    from fedcrack_tpu_torch.obs import tb as ttb

    monkeypatch.setattr(time, "time", lambda: WALL)
    rng = np.random.default_rng(0)
    values = [rng.normal(size=(3, 3, 4, 8)).astype(np.float32), np.full(5, 2.0, np.float32),
              np.array([np.nan, np.inf, 1.0, -3.0]), np.zeros(0, np.float32), torch.arange(10.0)]
    files = {}
    for name, mod in (("jax", jtb), ("port", ttb)):
        with mod.SummaryWriter(tmp_path / name) as w:
            w.add_scalar("round/loss", 0.5, step=1)
            w.add_scalar("round/iou", np.float32(0.25), step=2, wall_time=WALL + 1)
            for i, v in enumerate(values):
                w.add_histogram(f"weights/leaf{i}", v if name == "port" or not torch.is_tensor(v) else v.numpy(),
                                step=i, bins=7 if i == 0 else 30)
        files[name] = w.path
    data = {k: open(p, "rb").read() for k, p in files.items()}
    assert data["port"] == data["jax"]
    assert ttb.read_scalars(files["port"]) == jtb.read_scalars(files["jax"]) == [
        ("round/loss", 0.5, 1), ("round/iou", 0.25, 2)]
    assert ttb.read_histograms(files["port"]) == jtb.read_histograms(files["jax"])
    corrupt = bytearray(data["port"])
    corrupt[-3] ^= 0xFF
    (tmp_path / "corrupt").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_histograms(tmp_path / "corrupt")


def _exposition():
    from fedcrack_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("fed_uploads_total", "accepted uploads", ("client",)).labels(client='a"b\\c').inc(3)
    reg.counter("fed_uploads_total", "accepted uploads", ("client",)).labels(client="z\nq").inc()
    reg.gauge("fed_round_ratio", "a help with \\ and\nnewline").set(-0.5)
    h = reg.histogram("fed_flush_seconds", "flush wall", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def test_parse_prometheus_text_equal_to_jax_and_scraped_over_http():
    from fedcrack_tpu.obs.promexp import parse_prometheus_text as jax_parse
    from fedcrack_tpu.obs.promexp import sample_value as jax_sample
    from fedcrack_tpu_torch.obs import promexp

    reg = _exposition()
    text = reg.exposition()
    extra = "# a comment\nplain_total 4\nspecial_inf +Inf\nspecial_ninf -Inf\n"
    got, want = promexp.parse_prometheus_text(text + extra), jax_parse(text + extra)
    assert got == want
    assert promexp.sample_value(got, "fed_uploads_total", {"client": 'a"b\\c'}) == 3.0
    assert jax_sample(want, "fed_round_ratio") == promexp.sample_value(got, "fed_round_ratio") == -0.5
    assert promexp.sample_value(got, "absent_total") is None
    with pytest.raises(ValueError, match="unparseable"):
        promexp.parse_prometheus_text("bad{label=unquoted} 1\n")

    assert promexp.start_exporter(0, reg) is None
    exporter = promexp.start_exporter(-1, reg)
    try:
        assert exporter.bound_port > 0 and exporter.start() == exporter.bound_port
        assert promexp.scrape(exporter.url) == promexp.parse_prometheus_text(text)
        base = exporter.url[: -len("/metrics")]
        with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["families"] == 3
        assert set(health) == {"status", "families", "uptime_seconds", "spans_installed", "git"}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/other", timeout=5)
    finally:
        exporter.stop()
    with pytest.raises(RuntimeError):
        promexp.MetricsExporter(reg).url  # never started


def test_stopwatch_and_profiler_trace(tmp_path):
    from fedcrack_tpu_torch.obs.metrics import profiler_trace, stopwatch

    with profiler_trace(None), stopwatch() as w:
        torch.ones(8).sum()
    assert w["seconds"] > 0
    with profiler_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = [p for p in (tmp_path / "prof").iterdir() if p.name.endswith(".pt.trace.json")]
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_local_fit_record_and_histogram_tags_match_jax(tmp_path):
    """One round of each package's ``make_train_fn`` from the same blob and
    batches, each with a ``MetricsLogger`` teeing into TensorBoard."""
    from fedcrack_tpu.configs import DataConfig as JaxDataConfig
    from fedcrack_tpu.configs import FedConfig as JaxFedConfig
    from fedcrack_tpu.configs import ModelConfig as JaxModelConfig
    from fedcrack_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    from fedcrack_tpu.fed.serialization import tree_to_bytes
    from fedcrack_tpu.obs import MetricsLogger as JaxLogger
    from fedcrack_tpu.obs.tb import read_histograms as jax_histograms
    from fedcrack_tpu.train.federated import make_train_fn as jax_make_train_fn
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig, ModelConfig
    from fedcrack_tpu_torch.data.pipeline import ArrayDataset, to_uint8_transport
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.obs import MetricsLogger
    from fedcrack_tpu_torch.obs.tb import read_histograms
    from fedcrack_tpu_torch.train.federated import make_train_fn

    imgs, msks = to_uint8_transport(*synth_crack_batch(6, 32, seed=4))
    blob = tree_to_bytes(jax_variables(TINY_KW, seed=3))
    hparams = {"local_epochs": 1, "fedprox_mu": 0.01}
    runs = {}
    for name, fed, model, data, ds, make, logger in (
        ("jax", JaxFedConfig, JaxModelConfig, JaxDataConfig, JaxArrayDataset, jax_make_train_fn, JaxLogger),
        ("port", FedConfig, ModelConfig, DataConfig, ArrayDataset, make_train_fn, MetricsLogger),
    ):
        cfg = fed(model=model(**TINY_KW), data=data(img_size=32, batch_size=2), local_epochs=1)
        log = logger(tmp_path / f"{name}.jsonl", tb_dir=tmp_path / f"tb_{name}")
        kw = {"device": "cpu"} if name == "port" else {}
        train_fn, _ = make(cfg, ds(imgs, msks, batch_size=2, seed=1), 2, seed=0, metrics_logger=log, **kw)
        out, n_samples, metrics = train_fn(blob, 3, hparams)
        log.close()
        (tb_file,) = (tmp_path / f"tb_{name}").iterdir()
        runs[name] = (_records(tmp_path / f"{name}.jsonl"), tb_file, n_samples, metrics)
    (got,), (want,) = runs["port"][0], runs["jax"][0]
    assert set(got) == set(want)
    for k in ("kind", "round", "num_samples", "bytes_in", "bytes_out"):
        assert got[k] == want[k], k
    assert (got["kind"], got["round"], got["num_samples"], got["bytes_in"]) == ("local_fit", 3, 6, len(blob))
    for k in ("loss", "pixel_acc", "iou", "iou_inter", "iou_union"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        assert runs["port"][3][k] == got[k]
    assert got["wall_clock_s"] > 0 and runs["port"][2] == runs["jax"][2] == 6
    g_hist, w_hist = read_histograms(runs["port"][1]), jax_histograms(runs["jax"][1])
    assert [(t, s) for t, _, s in g_hist] == [(t, s) for t, _, s in w_hist]
    tags = [t for t, _, _ in g_hist]
    assert tags[0].startswith("weights/") and any(t.startswith("round_update/") for t in tags)
    assert len(tags) == 2 * sum(1 for t in tags if t.startswith("weights/"))
    assert [g["num"] for _, g, _ in g_hist] == [w["num"] for _, w, _ in w_hist]


def test_gauge_dec_and_registry_get_match_jax():
    """``Gauge.dec``, ``MetricFamily.dec`` and ``MetricsRegistry.get``: the
    same sequence of calls on both packages' registries gives the same
    exposition text, and ``get`` finds a family or gives None."""
    from fedcrack_tpu.obs.registry import MetricsRegistry as JaxRegistry

    from fedcrack_tpu_torch.obs.registry import MetricsRegistry

    texts = []
    for cls in (MetricsRegistry, JaxRegistry):
        reg = cls()
        solo = reg.gauge("inflight_requests_total", "requests in flight")
        solo.inc(3)
        solo.dec()
        solo.dec(0.5)
        lanes = reg.gauge("lanes_busy_replicas", "busy lanes by replica", labels=("replica",))
        lanes.labels(replica="0").inc(4)
        lanes.labels(replica="0").dec(2)
        lanes.labels(replica="1").dec()
        reg.counter("served_total", "served").inc(2)
        assert reg.get("inflight_requests_total") is solo and reg.get("lanes_busy_replicas") is lanes
        assert reg.get("no_such_family") is None
        assert solo.value == 1.5 and lanes.labels(replica="1").value == -1.0
        with pytest.raises(AttributeError):
            reg.get("served_total").dec()  # a counter only goes up
        texts.append(reg.exposition())
    assert texts[0] == texts[1]
