"""The port's fedlint engine held against the JAX package's on the CPU.

- **parity**: every snippet of tests/test_analysis.py for the thirteen
  rule packs that are not about JAX idioms goes through both engines at
  the same relative path, and the findings of those packs must be equal
  as ``(rule, severity, line, col, message)``; DET002's advice names
  ``torch.Generator`` in the port, so there only the message may differ.
  The port's torch global-RNG cases of DET002 are snippets of its own;
- **engine**: suppressions, ``disable-file``, ``disable=all``, the
  baseline round trip with edit invalidation, the version check and the
  result cache behave alike in both engines, and ``all_rules()`` gives the
  same ids in the same order;
- **retargeted packs**: KERN001 over ``KernelLibrary(...)`` /
  ``<library>.launch(...)`` sites without a ``_plain`` twin, TRACE001 over
  host ops inside ``torch.compile`` / ``torch.jit`` / ``torch.func``
  transforms and CUDA graph captures;
- **the gate**: zero non-baselined findings over ``fedcrack_tpu_torch/``
  with ``fedlint_torch_baseline.json``, each rule clean over the tree on
  its own, and the committed lock graph current and acyclic;
- **the CLI**: ``python -m fedcrack_tpu_torch.tools.fedlint`` as the JAX
  package's tests drive its own.
"""

import json
import os
import re

import pytest

from fedcrack_tpu.analysis import engine as jax_engine
from fedcrack_tpu.analysis.rules import all_rules as jax_all_rules
from fedcrack_tpu_torch.analysis import engine as torch_engine
from fedcrack_tpu_torch.analysis.engine import LintEngine, ModuleSource, Severity, load_baseline
from fedcrack_tpu_torch.analysis.rules import all_rules, rules_by_id

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fedcrack_tpu_torch")
LOCK_GRAPH = os.path.join(PACKAGE, "analysis", "serve_lock_graph.json")
BASELINE = os.path.join(ROOT, "fedlint_torch_baseline.json")

# The packs ported rule for rule (KERN001 and TRACE001 are retargeted).
PARITY_RULES = (
    "DET001", "DET002", "DET003", "DET004", "DUR001", "TRANS001", "TRANS002", "COMP001",
    "ASYNC001", "OBS001", "OBS002", "HEALTH001", "AGG001", "LOCK001", "DEAD001", "DEAD002",
    "SERVE001", "FLEET001", "PRIV001",
)
FX = "fedcrack_tpu_torch/fed/fixture.py"


def _rel(sub):
    return f"fedcrack_tpu_torch/{sub}"


# (rule the case is about, source, path, whether that rule fires): the
# snippets of tests/test_analysis.py, in its order.
CASES = [
    ("DET001", "import time\ndeadline = time.time() + 5.0\n", FX, True),
    ("DET001", "import time\ndeadline = time.monotonic() + 5.0\n", FX, False),
    ("DET001", "import datetime\nts = datetime.datetime.now()\n", FX, True),
    ("DET002", "import random\nx = random.random()\n", FX, True),
    ("DET002", "import numpy as np\nx = np.random.uniform()\n", FX, True),
    ("DET002", "import random\nrng = random.Random(7)\nx = rng.random()\n", FX, False),
    ("DET002", "import numpy as np\nrng = np.random.default_rng(7)\nx = rng.uniform()\n", FX, False),
    ("DET003", "import os\nnames = os.listdir(d)\n", FX, True),
    ("DET003", "import glob\nnames = glob.glob(p)\n", FX, True),
    ("DET003", "import os\nnames = sorted(os.listdir(d))\n", FX, False),
    ("DET004", "s = set(names)\nout = []\nfor n in s:\n    out.append(n)\n", FX, True),
    ("DET004", "s = set(names)\nout = []\nfor n in sorted(s):\n    out.append(n)\n", FX, False),
    ("DET004", "s = set(names)\nout = []\nfor n in s:\n    out.append(n)\n", _rel("tools/fixture.py"), False),
    ("DET004", "import msgpack\nblob = msgpack.packb([v for k, v in d.items()])\n", FX, True),
    ("DET004", "import msgpack\nblob = msgpack.packb([v for k, v in sorted(d.items())])\n", FX, False),
    ("DET004", "for k, v in d.items():\n    log(k, v)\n", FX, False),
    ("DET004", "def f1(xs):\n    s = set(xs)\n    return sorted(s)\ndef f2(items):\n"
               "    s = [i * 2 for i in items]\n    out = []\n    for n in s:\n        out.append(n)\n"
               "    return out\n", FX, False),
    ("DET004", "def f(xs):\n    s = set(xs)\n    return [n for n in s]\n", FX, True),
    ("DUR001", 'with open(path, "wb") as f:\n    f.write(data)\n', _rel("ckpt/fixture.py"), True),
    ("DUR001", 'with open(path, "rb") as f:\n    data = f.read()\n', _rel("ckpt/fixture.py"), False),
    ("DUR001", 'with open(report, "w") as f:\n    f.write(text)\n', _rel("tools/fx.py"), False),
    ("DUR001", 'with open(out, "wb") as f:\n    f.write(tree_to_bytes(variables))\n', _rel("tools/fx.py"), True),
    ("TRANS001", "import grpc\ndef call(stub):\n    for attempt in range(5):\n        try:\n"
                 "            return stub.Do()\n        except grpc.RpcError:\n            continue\n",
     _rel("transport/fx.py"), True),
    ("TRANS001", "import grpc\ndef call(stub):\n    for attempt in range(5):\n        try:\n"
                 "            return stub.Do()\n        except grpc.RpcError as e:\n"
                 "            if e.code() in NON_RETRYABLE_CODES:\n                raise\n            continue\n",
     _rel("transport/fx.py"), False),
    ("TRANS001", "import grpc\ndef call(stub):\n    try:\n        return stub.Do()\n"
                 "    except grpc.RpcError:\n        return None\n", _rel("transport/fx.py"), False),
    ("TRANS002", "import grpc\ncode = grpc.StatusCode.UNAVAILIBLE\n", _rel("tools/fx.py"), True),
    ("TRANS002", "import grpc\ncode = grpc.StatusCode.UNAVAILABLE\n", _rel("tools/fx.py"), False),
    ("COMP001", "from fedcrack_tpu_torch.compress import decode_update\ndef take(blob, state):\n"
                "    tree, frame = decode_update(blob, state.template, base)\n    return aggregate(tree)\n",
     _rel("fed/fx.py"), True),
    ("COMP001", "from fedcrack_tpu_torch.compress import decode_update\n"
                "from fedcrack_tpu_torch.fed.serialization import validate_update\ndef take(blob, state):\n"
                "    tree, frame = decode_update(blob, state.template, base)\n"
                "    problem = validate_update(to_bytes(tree), state.template)\n"
                "    return None if problem else aggregate(tree)\n", _rel("fed/fx.py"), False),
    ("COMP001", "def decode_update(blob, template, base):\n    frame = decode_frame(blob)\n"
                "    return rebuild(frame, template, base)\n", _rel("compress/fx.py"), False),
    ("COMP001", "from fedcrack_tpu_torch.compress import decode_update\ndef take(blob, state):\n"
                "    tree, frame = decode_update(blob, state.template, base)\n    return aggregate(tree)\n",
     _rel("tools/fx.py"), False),
    ("ASYNC001", "def flush_buffer(buf):\n    return [v for k, v in buf.items()]\n", FX, True),
    ("ASYNC001", "def staleness_prune(versions):\n    keep = set(versions)\n    out = []\n"
                 "    for v in keep:\n        out.append(v)\n    return out\n", FX, True),
    ("ASYNC001", "def flush_buffer(buf):\n    return [v for k, v in sorted(buf.items())]\n", FX, False),
    ("ASYNC001", "def flush_buffer(entries):\n    return [e for e in entries]\n", FX, False),
    ("ASYNC001", "def summarize(d):\n    return [v for v in d.values()]\n", FX, False),
    ("ASYNC001", "def flush_buffer(buf):\n    return [v for k, v in buf.items()]\n", _rel("serve/fx.py"), False),
    ("OBS001", "from fedcrack_tpu_torch.obs.registry import REGISTRY\n"
               "REGISTRY.counter('fed_updates_total', 'updates').inc()\n"
               "REGISTRY.histogram('serve_request_seconds', 'latency')\n"
               "REGISTRY.gauge('fed_buffer_fill_ratio', 'fill')\n", FX, False),
    ("OBS001", "from fedcrack_tpu_torch.obs.registry import REGISTRY\n"
               "REGISTRY.counter(f'updates_{plane}_total', 'per-plane').inc()\n", FX, True),
    ("OBS001", "registry.counter('updates_count', 'x')\n", FX, True),
    ("OBS001", "registry.gauge('FedUpdates_total', 'x')\n", FX, True),
    ("OBS001", "reg.histogram(name=make_name(), help='x')\n", FX, True),
    ("OBS001", "reg.histogram(name='fed_flush_seconds', help='x')\n", FX, False),
    ("OBS001", "collections.Counter('abc')\n", FX, False),
    ("OBS001", "stats.counter('whatever')\n", FX, False),
    ("OBS002", "from fedcrack_tpu_torch.obs import spans as tracing\n"
               "with tracing.span('client.push', trace='fedtr-v0'):\n    pass\n"
               "with tracing.span('edge.flush_partial', links=[]):\n    pass\n"
               "with tracing.span(name='serve.batch'):\n    pass\n", FX, False),
    ("OBS002", "from fedcrack_tpu_torch.obs import spans as tracing\n"
               "with tracing.span(f'serve.{verb}'):\n    pass\n", FX, True),
    ("OBS002", "tracing.span(span_name)\n", FX, True),
    ("OBS002", "tracing.span('push')\n", FX, True),
    ("OBS002", "spans.span('Client.Push')\n", FX, True),
    ("OBS002", "tracing.span('fed.')\n", FX, True),
    ("OBS002", "rec.span('anything goes')\n", FX, False),
    ("OBS002", "soup.span('html')\n", FX, False),
    ("HEALTH001", "from fedcrack_tpu_torch.obs.registry import REGISTRY\n"
                  "REGISTRY.counter('fed_updates_total', 'per-client updates',\n"
                  "                 labels=('client',)).labels(client=cname).inc()\n", FX, True),
    ("HEALTH001", "reg.gauge('fed_norm_ratio', 'x', labels=('cname',))\n", FX, True),
    ("HEALTH001", "registry.histogram('fed_lag_seconds', 'x', labels=['round', 'client_id'])\n", FX, True),
    ("HEALTH001", "from fedcrack_tpu_torch.obs.registry import REGISTRY\n"
                  "REGISTRY.counter('fed_updates_total', 'x', labels=('result',))\n"
                  "REGISTRY.gauge('serve_drift_psi_ratio', 'x', labels=('bucket', 'signal'))\n", FX, False),
    ("HEALTH001", "reg.gauge('fed_client_anomaly_score_ratio', 'x', labels=('client',))\n",
     _rel("health/ledger.py"), False),
    ("HEALTH001", "reg.gauge('fed_client_anomaly_score_ratio', 'x', labels=('client',))\n",
     _rel("fed/rounds.py"), True),
    ("HEALTH001", "stats.counter('x_total', labels=('client',))\n", FX, False),
    ("AGG001", "from fedcrack_tpu_torch.fed.algorithms import fedavg\navg = fedavg(trees, weights)\n", FX, True),
    ("AGG001", "from fedcrack_tpu_torch.fed import rounds as R\navg = R.fedavg(trees, w)\n", FX, True),
    ("AGG001", "from fedcrack_tpu_torch.fed.algorithms import fedavg\navg = fedavg(trees, weights)\n",
     _rel("parallel/fixture.py"), True),
    ("AGG001", "from fedcrack_tpu_torch.fed.algorithms import fedavg\navg = fedavg(trees, weights)\n",
     _rel("fed/aggregation.py"), False),
    ("AGG001", "from fedcrack_tpu_torch.fed.algorithms import fedavg\navg = fedavg(trees, weights)\n",
     _rel("fed/algorithms.py"), False),
    ("AGG001", "from fedcrack_tpu_torch.fed.algorithms import fedavg\navg = fedavg(trees, weights)\n",
     _rel("tools/fixture.py"), False),
    ("AGG001", "from fedcrack_tpu_torch.fed import aggregation as _aggregation\n"
               "avg = _aggregation.fold(_aggregation.FedAvg(), triples)\n", FX, False),
    ("DEAD001", "import os\nx = 1\n", FX, True),
    ("DEAD001", "import os\nx = os.getpid()\n", FX, False),
    ("DEAD001", "from fedcrack_tpu_torch import configs\n", _rel("__init__.py"), False),
    ("DEAD001", "from a import b as b\n", FX, False),
    ("DEAD001", "from a import b\n__all__ = ['b']\n", FX, False),
    ("DEAD002", "def f():\n    return 1\n    x = 2\n", FX, True),
    ("DEAD002", "if False:\n    x = 1\n", FX, True),
    ("DEAD002", "def f():\n    if c:\n        return 1\n    return 2\n", FX, False),
    ("SERVE001", "def f(self, h, w):\n    return self._cache[(h, w)]\n", _rel("serve/fixture.py"), True),
    ("SERVE001", "def f(self, digest):\n    return self._cache.get(digest)\n", _rel("serve/fixture.py"), True),
    ("SERVE001", "def f(self, digest):\n    key = (digest, 0)\n    return tile_cache.get(key)\n",
     _rel("serve/fixture.py"), True),
    ("SERVE001", "def f(self, digest):\n    return self._cache[(self._version, digest)]\n",
     _rel("serve/fixture.py"), False),
    ("SERVE001", "def f(self, version, digest):\n    key = (version, digest)\n    return self._cache.get(key)\n",
     _rel("serve/fixture.py"), False),
    ("SERVE001", "def f(self, digest, probs):\n    self._cache[digest] = probs\n    del self._cache[digest]\n",
     _rel("serve/fixture.py"), False),
    ("SERVE001", "def f(self, digest):\n    return self._index.get(digest)\n", _rel("serve/fixture.py"), False),
    ("SERVE001", "def f(cache, k):\n    return cache[k]\n", _rel("serve/fx.py"), True),
    ("SERVE001", "def f(cache, k):\n    return cache[k]\n", _rel("fed/fx.py"), False),
    ("PRIV001", "import numpy as np\ng = np.random.default_rng()\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import numpy as np\nbg = np.random.Philox()\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import random\nr = random.Random()\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import os\nseed = os.urandom(16)\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import secrets\nseed = secrets.randbits(64)\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import uuid\nseed = uuid.uuid4().int\n", _rel("privacy/fixture.py"), True),
    ("PRIV001", "import numpy as np\ngen = np.random.Generator(np.random.Philox(key=int(seed)))\n"
                "g2 = np.random.default_rng(42)\nss = np.random.SeedSequence(1234)\n",
     _rel("privacy/fixture.py"), False),
    ("PRIV001", "import os\nseed = os.urandom(16)\n", _rel("fed/rounds.py"), False),
    ("FLEET001", "def grow(self):\n    self.router.replicas.append(object())\n", _rel("serve/router.py"), True),
    ("FLEET001", "def shrink(self):\n    del self.router.replicas[1]\n", _rel("serve/front.py"), True),
    ("FLEET001", "def swap(self, r):\n    self.router.replicas[0] = r\n", _rel("serve/router.py"), True),
    ("FLEET001", "def tick(self):\n    self.fleet.remove_replica(2)\n", _rel("serve/shadow.py"), True),
    ("FLEET001", "def tick(self):\n    self.fleet.remove_replica(2)\n", _rel("serve/fleet.py"), False),
    ("FLEET001", "def tick(self):\n    self.fleet.remove_replica(2)\n", _rel("serve/autoscaler.py"), False),
    ("FLEET001", "def __init__(self, replicas):\n    self.replicas = list(replicas)\n", _rel("serve/router.py"), False),
    ("FLEET001", "def crash(fleet):\n    fleet.router.kill_replica(1)\n", _rel("tools/chaos_drill.py"), False),
    # The suppression snippets: each engine reads the same comments.
    ("DET001", "import time\nts = time.time()  # fedlint: disable=DET001 -- record ts\n", FX, False),
    ("DET001", "import time\n# fedlint: disable=DET001 -- record ts\nts = time.time()\n", FX, False),
    ("DET001", "import time\nts = time.time()  # fedlint: disable=DET002\n", FX, True),
    ("DET001", "import time\n# fedlint: disable=DET001\nx = 1\nts = time.time()\n", FX, True),
    ("DET001", "# fedlint: disable-file=DET001\nimport time\na = time.time()\nb = time.time()\n", FX, False),
    ("DET001", "import time\nts = time.time()  # fedlint: disable=all\n", FX, False),
]


def _key(f, with_message=True):
    return (f.rule, f.severity.name, f.line, f.col) + ((f.message,) if with_message else ())


def _parity_findings(engine_mod, rules, src, path):
    findings = engine_mod.LintEngine(rules=rules).lint_source(src, path=path)
    return [f for f in findings if f.rule in PARITY_RULES]


@pytest.mark.parametrize("rule,src,path,fires", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_packs_agree_with_jax_on_its_snippets(rule, src, path, fires):
    got = _parity_findings(torch_engine, all_rules(), src, path)
    want = _parity_findings(jax_engine, jax_all_rules(), src, path)
    assert (rule in [f.rule for f in got]) == fires
    assert [_key(f, f.rule != "DET002") for f in got] == [_key(f, f.rule != "DET002") for f in want]
    if fires:
        assert all(f.source_line == w.source_line and f.fingerprint() == w.fingerprint()
                   for f, w in zip(got, want))


# ---- the lock-order pack (project scope) ----

CYCLE_SRC = """\
import threading

class S:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def fwd(self):
        with self.a:
            with self.b:
                pass

    def rev(self):
        with self.b:
            with self.a:
                pass
"""

ORDERED_SRC = CYCLE_SRC.replace(
    "        with self.b:\n            with self.a:\n                pass\n",
    "        with self.a:\n            with self.b:\n                pass\n",
)

CALL_CYCLE_SRC = """\
import threading

class S:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def takes_b(self):
        with self.b:
            pass

    def takes_a(self):
        with self.a:
            pass

    def fwd(self):
        with self.a:
            self.takes_b()

    def rev(self):
        with self.b:
            self.takes_a()
"""


@pytest.mark.parametrize("src,fires", [(CYCLE_SRC, True), (ORDERED_SRC, False), (CALL_CYCLE_SRC, True)],
                         ids=["nested", "ordered", "call-mediated"])
def test_lock001_and_lock_graph_agree_with_jax(src, fires):
    from fedcrack_tpu.analysis.rules.locks import build_lock_graph as jax_graph
    from fedcrack_tpu_torch.analysis.rules.locks import build_lock_graph

    path = "fedcrack_tpu_torch/serve/fx.py"
    got = LintEngine(rules=all_rules()).lint_modules([ModuleSource(path, src)])
    want = jax_engine.LintEngine(rules=jax_all_rules()).lint_modules([jax_engine.ModuleSource(path, src)])
    got = [f for f in got if f.rule in PARITY_RULES]
    assert ("LOCK001" in [f.rule for f in got]) == fires
    assert [_key(f) for f in got] == [_key(f) for f in want if f.rule in PARITY_RULES]
    assert build_lock_graph([ModuleSource(path, src)]).to_json() == \
        jax_graph([jax_engine.ModuleSource(path, src)]).to_json()
    if src is CYCLE_SRC:
        payload = build_lock_graph([ModuleSource(path, src)]).to_json()
        assert {n["node_id"] for n in payload["nodes"]} == {f"{path}::S.a", f"{path}::S.b"}
        assert len(payload["edges"]) == 2
        assert payload["cycles"] == [[f"{path}::S.a", f"{path}::S.b"]]


# ---- DET002 on torch's global generator (the port's own snippets) ----


@pytest.mark.parametrize("src,fires", [
    ("import torch\nx = torch.randn(3)\n", True),
    ("import torch\nx = torch.rand(2, 2)\n", True),
    ("import torch\nx = torch.randint(0, 5, (3,))\n", True),
    ("import torch\nx = torch.randperm(8)\n", True),
    ("import torch\nx = torch.normal(0.0, 1.0, (3,))\n", True),
    ("import torch\ng = torch.Generator().manual_seed(7)\nx = torch.randn(3, generator=g)\n", False),
    ("import torch\nx = torch.randperm(8, generator=torch.Generator().manual_seed(1))\n", False),
    ("import torch\nx = torch.zeros(3)\n", False),
    ("import torch\nx = torch.nn.init.normal_(w)\n", False),
], ids=["randn", "rand", "randint", "randperm", "normal", "seeded", "seeded-inline", "zeros", "nn-init"])
def test_det002_flags_torch_global_rng_draws(src, fires):
    findings = [f for f in LintEngine(rules=all_rules()).lint_source(src, path=FX) if f.rule == "DET002"]
    assert bool(findings) == fires
    if fires:
        assert findings[0].severity is Severity.ERROR
        assert "generator=torch.Generator().manual_seed(seed)" in findings[0].message
    # The JAX rule knows no torch draws: these snippets are the port's own.
    assert "DET002" not in [f.rule for f in jax_engine.LintEngine(rules=jax_all_rules()).lint_source(src, path=FX)]


def test_det002_messages_match_jax_outside_torch():
    src = "import random\nimport numpy as np\nx = random.random()\ny = np.random.uniform()\n"
    got = LintEngine(rules=all_rules()).lint_source(src, path=FX)
    want = jax_engine.LintEngine(rules=jax_all_rules()).lint_source(src, path=FX)
    assert [_key(f) for f in got if f.rule == "DET002"] == [_key(f) for f in want if f.rule == "DET002"]
    assert "torch.Generator" in rules_by_id()["DET002"].description


# ---- the engine ----


def test_all_rules_same_ids_same_order():
    ids = [r.id for r in all_rules()]
    assert ids == [r.id for r in jax_all_rules()]
    assert len(ids) == len(set(ids)) == 21
    jax_by_id = {r.id: r for r in jax_all_rules()}
    for r in all_rules():
        assert r.severity.name == jax_by_id[r.id].severity.name, r.id
        if r.id not in ("KERN001",):
            assert r.paths == jax_by_id[r.id].paths, r.id
    assert rules_by_id()["KERN001"].paths == ("/fedcrack_tpu_torch/",)
    assert torch_engine.ENGINE_VERSION == jax_engine.ENGINE_VERSION


@pytest.mark.parametrize("mod", [torch_engine, jax_engine], ids=["torch", "jax"])
def test_baseline_round_trip_and_edit_invalidation(mod, tmp_path):
    rules = all_rules() if mod is torch_engine else jax_all_rules()

    def lint(src):
        return mod.LintEngine(rules=rules).lint_source(src, path=FX)

    src = "import time\ndeadline = time.time() + 5\n"
    findings = lint(src)
    assert [f.rule for f in findings] == ["DET001"]
    payload = mod.make_baseline(findings)
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps(payload))
    loaded = mod.load_baseline(str(bl))
    assert mod.apply_baseline(findings, loaded) == []
    assert mod.apply_baseline(lint("import time\nx = 1\ny = 2\ndeadline = time.time() + 5\n"), loaded) == []
    assert [f.rule for f in mod.apply_baseline(lint("import time\ndeadline = time.time() + 60\n"), loaded)] == [
        "DET001"]
    assert len(mod.apply_baseline(lint(src + "deadline = time.time() + 5\n"), loaded)) == 1


def test_baselines_cross_load_between_engines(tmp_path):
    """One reader takes both packages' baselines: the same version and the
    same fingerprints."""
    src = "import time\ndeadline = time.time() + 5\nimport os\nnames = os.listdir(d)\n"
    got = LintEngine(rules=all_rules()).lint_source(src, path=FX)
    want = jax_engine.LintEngine(rules=jax_all_rules()).lint_source(src, path=FX)
    assert torch_engine.make_baseline(got) == jax_engine.make_baseline(want)
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps(torch_engine.make_baseline(got)))
    assert jax_engine.apply_baseline(want, jax_engine.load_baseline(str(bl))) == []
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 999, "entries": {}}))
    for mod in (torch_engine, jax_engine):
        with pytest.raises(ValueError, match="unknown baseline version"):
            mod.load_baseline(str(bad))
    assert load_baseline(os.path.join(ROOT, "fedlint_baseline.json"))["version"] == 1


@pytest.mark.parametrize("mod", [torch_engine, jax_engine], ids=["torch", "jax"])
def test_result_cache_round_trip(mod, tmp_path):
    rules = all_rules() if mod is torch_engine else jax_all_rules()
    fx = tmp_path / "fx.py"
    fx.write_text("import time\ndeadline = time.time() + 5\n")
    cache = tmp_path / "cache"
    cold = mod.LintEngine(rules=rules, cache_dir=str(cache)).lint_paths([str(fx)], rel_to=str(tmp_path))
    assert (cache / "cache.json").exists()
    warm = mod.LintEngine(rules=rules, cache_dir=str(cache)).lint_paths([str(fx)], rel_to=str(tmp_path))
    assert [f.to_json() for f in warm] == [f.to_json() for f in cold]
    assert [f.rule for f in warm] == ["DET001"]
    key = json.loads((cache / "cache.json").read_text())["key"]
    assert key.startswith("v1:") and "KERN001" in key


def test_default_excludes_skip_build_and_generated(tmp_path):
    (tmp_path / "_build").mkdir()
    (tmp_path / "_build" / "gen.py").write_text("import os\n")
    (tmp_path / "x_pb2.py").write_text("import os\n")
    (tmp_path / "ok.py").write_text("x = 1\n")
    files = LintEngine.iter_python_files(str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["ok.py"]
    assert "_build" in torch_engine.DEFAULT_EXCLUDES and "_pb2.py" in torch_engine.DEFAULT_EXCLUDES


# ---- KERN001, retargeted to KernelLibrary / launch sites ----

KERNEL_PATH = "fedcrack_tpu_torch/kernels/fx.py"


@pytest.mark.parametrize("src,n_findings", [
    ("from fedcrack_tpu_torch.kernels.build import KernelLibrary\nLIB = KernelLibrary('x', {})\n"
     "def wrapper(x):\n    LIB.launch('fc_x', x.device, x.data_ptr())\n", 2),
    ("from fedcrack_tpu_torch.kernels import build\nLIB = build.KernelLibrary('x', {})\n", 1),
    ("def a(x):\n    LIB.launch('fc_a', x.device)\ndef b(x):\n    LIB.launch('fc_b', x.device)\n", 2),
    ("LIB = KernelLibrary('x', {})\ndef _x_plain(x):\n    return x * 2\n"
     "def wrapper(x):\n    if x.is_cuda:\n        LIB.launch('fc_x', x.device)\n    return _x_plain(x)\n", 0),
    ('"""mentions LIBRARY.launch(...) and KernelLibrary(...) in prose only."""\n'
     "launcher = LIB.launch\nkind = KernelLibrary\n", 0),
    ("from jax.experimental import pallas as pl\ndef launch(x):\n"
     "    return pl.pallas_call(_kernel, out_shape=o)(x)\n", 0),
], ids=["construct-and-launch", "attribute-construct", "two-sites", "plain-twin", "non-calls", "pallas"])
def test_kern001_torch_idiom(src, n_findings):
    findings = [f for f in LintEngine(rules=all_rules()).lint_source(src, path=KERNEL_PATH) if f.rule == "KERN001"]
    assert len(findings) == n_findings
    assert all(f.severity is Severity.ERROR and "_plain" in f.message for f in findings)
    # Scoped to the port's package.
    assert not [f for f in LintEngine(rules=all_rules()).lint_source(src, path="tools/fx.py") if f.rule == "KERN001"]


def _launch_sites(src):
    import ast

    from fedcrack_tpu_torch.analysis.rules.kernel_plane import _is_kernel_launch

    return sorted(n.lineno for n in ast.walk(ast.parse(src)) if _is_kernel_launch(n))


@pytest.mark.parametrize("rel,twins", [
    ("ops/bce.py", ("_bce_sums_plain",)),
    ("kernels/dequant.py", ("_dequant_matmul_plain", "_dequant_conv3x3_plain", "_dequant_dwconv3x3_plain",
                            "_dequant_codes_plain")),
], ids=["bce", "dequant"])
def test_kern001_guards_each_wrapper_by_its_plain_twin(rel, twins):
    """The four routes' wrappers launch in ops/bce.py and
    kernels/dequant.py: each is guarded by its _plain twin, and with the
    twins renamed away the rule fires once per launch site."""
    path = f"fedcrack_tpu_torch/{rel}"
    src = open(os.path.join(ROOT, path), encoding="utf-8").read()
    sites = _launch_sites(src)
    assert sites and all(f"def {t}(" in src for t in twins)
    engine = LintEngine(rules=[rules_by_id()["KERN001"]])
    assert engine.lint_source(src, path=path) == []
    stripped = src
    for t in twins:
        stripped = re.sub(rf"\b{t}\b", t.replace("_plain", "_eager"), stripped)
    got = engine.lint_source(stripped, path=path)
    assert sorted(f.line for f in got) == sites
    assert len(got) == {"ops/bce.py": 2, "kernels/dequant.py": 7}[rel]


# ---- TRACE001, retargeted to torch's transforms and CUDA graphs ----

TRACE_PATH = "fedcrack_tpu_torch/parallel/fx.py"


@pytest.mark.parametrize("src,n_findings", [
    ("import torch\n@torch.compile\ndef step(x):\n    print(x)\n    return x * 2\n", 1),
    ("import torch\n@torch.compile(mode='max-autotune')\ndef step(x):\n    return x.sum().item()\n", 1),
    ("import torch\n@torch.jit.script\ndef step(x):\n    return float(x.sum())\n", 1),
    ("import torch\nfrom functools import partial\n@partial(torch.compile, dynamic=False)\n"
     "def step(x):\n    return x.cpu()\n", 1),
    ("import torch\nimport numpy as np\ndef body(x):\n    return np.sum(x.numpy())\n"
     "def run(xs):\n    return torch.func.vmap(body)(xs)\n", 2),
    ("from torch.func import grad\ndef loss(w):\n    return w.sum().tolist()\ng = grad(loss)\n", 1),
    ("import torch\ndef outer(x):\n    def inner(y):\n        return y.item()\n    return inner(x)\n"
     "fn = torch.compile(outer)\n", 1),
    ("import torch\ndef capture(g, x):\n    with torch.cuda.graph(g):\n        y = x * 2\n        print(y)\n"
     "    return y.cpu()\n", 1),
    ("import torch\ndef cb(x):\n    return x.item()\nf = torch.cuda.make_graphed_callables(cb, (x,))\n", 1),
    ("def driver(x):\n    print(x)\n    return x.item()\n", 0),
    ("import torch\ndef run(model, state, x):\n    out = torch.func.functional_call(model, state, (x,))\n"
     "    return out.cpu().numpy()\n", 0),
    ("import re\ndef f(s):\n    return re.compile(s)\ndef g(x):\n    return x.item()\n", 0),
    ("import torch\n@torch.compile\ndef step(x):\n    return int(3) + x\n", 0),
], ids=["compile-print", "compile-call-item", "script-float", "partial-cpu", "vmap-numpy", "grad-tolist",
        "nested", "cuda-graph", "graphed-callables", "untraced", "functional-call", "re-compile", "const-cast"])
def test_trace001_torch_idiom(src, n_findings):
    findings = [f for f in LintEngine(rules=all_rules()).lint_source(src, path=TRACE_PATH) if f.rule == "TRACE001"]
    assert len(findings) == n_findings, findings
    assert all(f.severity is Severity.ERROR for f in findings)
    # Scope: outside parallel/ and serve/engine.py the rule stays quiet.
    assert not [f for f in LintEngine(rules=all_rules()).lint_source(src, path="fedcrack_tpu_torch/obs/fx.py")
                if f.rule == "TRACE001"]


def test_trace001_quiet_on_jax_idioms_it_no_longer_matches():
    src = "import jax\n@jax.jit\ndef step(x):\n    print(x)\n    return x * 2\n"
    assert "TRACE001" not in [f.rule for f in LintEngine(rules=all_rules()).lint_source(src, path=TRACE_PATH)]
    assert "TRACE001" in [f.rule for f in jax_engine.LintEngine(rules=jax_all_rules()).lint_source(src, path=TRACE_PATH)]


# ---- the gate over the port's tree ----


@pytest.fixture(scope="module")
def port_modules():
    return LintEngine().load_modules([PACKAGE], rel_to=ROOT)


def test_gate_zero_findings_over_fedcrack_tpu_torch():
    """The CI contract: every rule over the real tree with the committed
    baseline reports nothing, and the baseline is empty."""
    baseline = load_baseline(BASELINE)
    assert baseline == {"version": 1, "entries": {}}
    findings = LintEngine(rules=all_rules()).lint_paths([PACKAGE], rel_to=ROOT, baseline=baseline)
    assert findings == [], "non-baselined fedlint findings:\n" + "\n".join(str(f) for f in findings)


@pytest.mark.parametrize("rule_id", [r.id for r in all_rules()])
def test_each_rule_clean_over_the_port_tree(rule_id, port_modules):
    assert LintEngine(rules=[rules_by_id()[rule_id]]).lint_modules(port_modules) == []


def test_port_keeps_jax_suppressions_line_for_line():
    """The JAX tree's suppressions have their counterparts in the port
    (the JAX recompile- and hot-swap record lines have none in the port),
    with the same rule and reason."""

    def suppressions(root):
        out = []
        for dirpath, _, files in os.walk(root):
            for name in sorted(files):
                if not name.endswith(".py") or "analysis" in dirpath:
                    continue
                for line in open(os.path.join(dirpath, name), encoding="utf-8"):
                    m = re.search(r"# fedlint: disable=(\S+) -- (.*)$", line)
                    if m:
                        out.append((os.path.relpath(os.path.join(dirpath, name), root), m.group(1), m.group(2)))
        return sorted(out)

    jax_side = [s for s in suppressions(os.path.join(ROOT, "fedcrack_tpu")) if s[0] != os.path.join("serve", "hot_swap.py")]
    assert suppressions(PACKAGE) == jax_side
    assert len(jax_side) == 9


def test_committed_lock_graph_is_current_and_acyclic(port_modules):
    from fedcrack_tpu_torch.analysis.rules.locks import build_lock_graph

    with open(LOCK_GRAPH, encoding="utf-8") as f:
        artifact = json.load(f)
    lock_rule = rules_by_id()["LOCK001"]
    live = build_lock_graph([m for m in port_modules if lock_rule.applies_to(m.path)]).to_json()
    assert artifact["cycles"] == [] and live["cycles"] == []
    assert {n["node_id"] for n in artifact["nodes"]} == {n["node_id"] for n in live["nodes"]}
    serve_locks = {n["node_id"] for n in live["nodes"] if "/serve/" in n["node_id"]}
    jax_set = {
        "serve/batcher.py::MicroBatcher._lock",
        "serve/hot_swap.py::ModelVersionManager._lock",
        "serve/service.py::ServeService._lock",
        "serve/fleet.py::FleetVersionManager._lock",
        "serve/router.py::FleetRouter._lock",
        "serve/router.py::RollingPercentiles._lock",
        "serve/stream.py::StreamSessionManager._lock",
        "serve/autoscaler.py::FleetAutoscaler._lock",
        "serve/shadow.py::ShadowMirror._lock",
        "serve/shadow.py::ShadowController._lock",
    }
    # The port's one extra serve lock: the engine's count of quantized
    # forwards, taken by the batcher's worker and the probe threads alike
    # (a leaf: nothing is acquired under it).
    extras = {"serve/engine.py::InferenceEngine._count_lock"}
    assert serve_locks == {f"fedcrack_tpu_torch/{n}" for n in jax_set | extras}
    held_under = {e["src"] for e in live["edges"]}
    assert not {f"fedcrack_tpu_torch/{n}" for n in extras} & held_under


# ---- the CLI ----


def test_cli_list_rules_and_unknown_rule(capsys):
    from fedcrack_tpu_torch.tools.fedlint import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in all_rules():
        assert r.id in out
    assert main(["--rules", "NOPE999"]) == 2
    assert main(["--no-cache", os.path.join(ROOT, "no_such_dir")]) == 2


def test_cli_findings_exit_code_json_and_baseline_cycle(tmp_path, capsys):
    from fedcrack_tpu_torch.tools.fedlint import main

    bad = tmp_path / "fx.py"
    bad.write_text("import time\ndeadline = time.time() + 5\n")
    out_json = tmp_path / "findings.json"
    assert main(["--no-baseline", "--no-cache", "--json", str(out_json), str(bad)]) == 1
    payload = json.loads(out_json.read_text())
    assert [f["rule"] for f in payload["findings"]] == ["DET001"]
    assert payload["findings"][0]["fingerprint"]
    bl = tmp_path / "bl.json"
    assert main(["--no-cache", "--write-baseline", str(bl), str(bad)]) == 0
    assert main(["--no-cache", "--baseline", str(bl), str(bad)]) == 0
    capsys.readouterr()
    assert main(["--no-baseline", "--no-cache", "--json", "-", str(bad)]) == 1
    captured = capsys.readouterr()
    assert [f["rule"] for f in json.loads(captured.out)["findings"]] == ["DET001"]
    assert "DET001" in captured.err and "finding(s)" in captured.err
    bad_bl = tmp_path / "v999.json"
    bad_bl.write_text(json.dumps({"version": 999, "entries": {}}))
    assert main(["--no-cache", "--baseline", str(bad_bl), str(bad)]) == 2


def test_cli_default_target_and_lock_graph_emission(tmp_path, capsys):
    from fedcrack_tpu_torch.tools.fedlint import DEFAULT_BASELINE, main, repo_root

    assert repo_root() == ROOT and DEFAULT_BASELINE == "fedlint_torch_baseline.json"
    out = tmp_path / "graph.json"
    assert main(["--no-cache", "--lock-graph", str(out)]) == 0
    assert "fedlint: clean" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert set(payload) == {"nodes", "edges", "cycles"}
    with open(LOCK_GRAPH, encoding="utf-8") as f:
        committed = json.load(f)
    # Nodes and edges carry source lines: compare the locks and who is
    # held under whom.
    assert [n["node_id"] for n in payload["nodes"]] == [n["node_id"] for n in committed["nodes"]]
    assert payload["cycles"] == committed["cycles"] == []
    assert [(e["src"], e["dst"]) for e in payload["edges"]] == [(e["src"], e["dst"]) for e in committed["edges"]]


def test_cli_result_cache_round_trip(tmp_path, capsys):
    from fedcrack_tpu_torch.tools.fedlint import main

    bad = tmp_path / "fx.py"
    bad.write_text("import time\ndeadline = time.time() + 5\n")
    cache = tmp_path / "cache"
    argv = ["--no-baseline", "--cache-dir", str(cache), str(bad)]
    assert main(argv) == 1
    assert (cache / "cache.json").exists()
    assert main(argv) == 1
    assert "DET001" in capsys.readouterr().out
