"""The port's chaos drills (``tools/chaos_drill.py``) held against the JAX
package's on the CPU.

Each of the eleven ported drills runs on the port (``device="cpu"`` for
the serving drills) and on the JAX package, in this process. Their
artifacts must be equal but for these fields:

- timings: every key ending in ``_s`` or ``_ms``, and the straggler
  storm's rates (``updates_per_sec``, ``versions_per_min``), which divide
  by a wall clock;
- counts that depend on thread scheduling, not on the drill's logic:
  how many queued requests the router rerouted at the kill
  (``rerouted``), how much the buffered storm arm ingested within its
  window (``accepted_updates``, ``global_versions``, ``staleness``), and
  how much the shadow lane and production answered before the lane died
  (``shadow_completed``, ``shadow_failures``,
  ``production_answered_during_shadow``; the numbers inside
  ``shadow_reasons``, whose rules are compared);
- IoUs (``reference_iou``, ``poisoned_iou``, ``canary_iou``): the port
  seeds its tiny model with its own ``init_variables``, not
  ``jax.random.key(0)``, so the IoUs differ while their verdicts
  (``iou_cliff``, ``fedavg_cliffed``, ``robust_arms_hold``, the breached
  rules) must be equal;
- ``recompiles_since_warmup``, -1 in the port: the eager port has no
  recompile sentry, and -1 is what the JAX drill reports where its
  sentry is unsupported.

Every boolean verdict must be true in both. ``run_dp_replay_drill`` (a
DP-SGD round of the slot plane killed and retried) runs on the port only:
the JAX drill runs the JAX mesh program, which the installed JAX cannot
run. Its retried federation must equal the unkilled one bit for bit, and
``main`` writes every key of the JAX package's artifact.
"""

import json
import re

import pytest

import fedcrack_tpu.tools.chaos_drill as J
import fedcrack_tpu_torch.tools.chaos_drill as P

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]

SERVING = ("replica_crash", "elastic_fleet", "stream_reset", "scaled_update", "robust_aggregation")
HOST = ("kill_restart", "corrupt_frame", "edge_crash", "straggler_storm", "buffered_kill", "secagg_dropout")
RATES = ("updates_per_sec", "versions_per_min")
SCHEDULED = {
    "replica_crash": ("rerouted",),
    "elastic_fleet": ("shadow_completed", "shadow_failures", "production_answered_during_shadow"),
}
# Only the storm's buffered arm: the sync arm's counts follow from the
# schedule alone.
STORM_WINDOW = ("accepted_updates", "global_versions", "staleness")
IOUS = ("reference_iou", "poisoned_iou", "canary_iou")


def _comparable(node, drill: str):
    """``node`` without the fields the module docstring lists."""
    if isinstance(node, dict):
        out = {}
        for key, value in node.items():
            if key.endswith(("_s", "_ms")) or key in RATES or key in IOUS or key == "recompiles_since_warmup":
                continue
            if key in SCHEDULED.get(drill, ()):
                continue
            if key == "shadow_reasons":
                value = [re.sub(r"[0-9][0-9.]*", "N", r) for r in value]
            out[key] = _comparable(value, drill)
        return out
    if isinstance(node, list):
        return [_comparable(v, drill) for v in node]
    return node


def _verdicts(node, path=()):
    """Every boolean leaf of an artifact, by path."""
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _verdicts(value, path + (key,))
    elif isinstance(node, bool):
        yield path, node


def _compare(out, drill: str):
    got = _comparable(out, drill)
    if drill == "straggler_storm":
        got["buffered"] = {k: v for k, v in got["buffered"].items() if k not in STORM_WINDOW}
    return got


@pytest.mark.parametrize("drill", HOST + SERVING)
def test_drill_agrees_with_jax(drill):
    kwargs = {"device": "cpu"} if drill in SERVING else {}
    got = getattr(P, f"run_{drill}_drill")(**kwargs)
    want = getattr(J, f"run_{drill}_drill")()
    json.dumps(got)  # the artifact is JSON
    assert _compare(got, drill) == _compare(want, drill)
    for path, value in _verdicts(got):
        assert value, (drill, path)
    for path, value in _verdicts(want):
        assert value, ("jax", drill, path)
    if drill == "scaled_update":
        assert got["canary"]["recompiles_since_warmup"] == -1
        assert got["canary"]["reference_iou"] >= 0.5 > got["canary"]["poisoned_iou"]
    if drill == "replica_crash":
        assert got["rerouted"] > 0 and got["reroute_failed"] == 0
    if drill == "elastic_fleet":
        assert got["shadow_completed"] < 64 and got["production_answered_during_shadow"] > 0


def test_dp_replay_drill_replays_bit_identically():
    """The port's drill, with the JAX drill's fields: the fault fired once,
    round 0 was retried once, and the retried federation equals the
    unkilled one bit for bit."""
    got = P.run_dp_replay_drill("cpu")
    assert set(got) == {"fault_fired", "retries_round_0", "replay_bit_identical", "rounds", "drill_s"}
    assert got["fault_fired"] is True and got["replay_bit_identical"] is True
    assert got["retries_round_0"] == 1 and got["rounds"] == 2


def _jax_artifact_keys(tmp_path, monkeypatch) -> set:
    """The keys the JAX package's ``main`` writes, its drills stubbed."""
    for name in dir(J):
        if name.startswith("run_") and name.endswith("_drill"):
            monkeypatch.setattr(J, name, lambda *a, **k: {})
    out = tmp_path / "jax.json"
    assert J.main(["--out", str(out)]) == 0
    return set(json.loads(out.read_text()))


def test_main_writes_every_key_of_the_jax_artifact(tmp_path, monkeypatch, capsys):
    out = tmp_path / "sub" / "drill.json"
    assert P.main(["--out", str(out), "--rounds", "2"], device="cpu") == 0
    artifact = json.loads(out.read_text())
    assert artifact["generated_by"] == "fedcrack_tpu_torch.tools.chaos_drill"
    assert artifact["dp_replay"]["replay_bit_identical"] is True
    assert artifact["dp_replay"]["retries_round_0"] == 1
    assert artifact["kill_restart"]["rounds"] == 2
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == artifact["kill_restart"]
    for path, value in _verdicts(artifact):
        assert value, path
    assert set(artifact) == _jax_artifact_keys(tmp_path, monkeypatch)


def test_main_fails_when_a_drill_raises_and_dumps_the_flight_ring(tmp_path, monkeypatch):
    for name in dir(P):
        if name.startswith("run_") and name.endswith("_drill"):
            monkeypatch.setattr(P, name, lambda *a, **k: {})

    def broken(**kwargs):
        raise RuntimeError("drill broke")

    monkeypatch.setattr(P, "run_buffered_kill_drill", broken)
    out = tmp_path / "drill.json"
    with pytest.raises(RuntimeError, match="drill broke"):
        P.main(["--out", str(out)], device="cpu")
    assert not out.exists()
    assert json.loads((tmp_path / "drill.json.flight.json").read_text())["reason"] == "chaos drill failed"
