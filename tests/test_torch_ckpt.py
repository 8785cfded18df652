"""The port's round checkpointer (fedcrack_tpu_torch/ckpt/manager.py) held
against the JAX package's orbax ``FedCheckpointer`` on the CPU.

The two write different formats (the port's msgpack and JSON steps,
orbax's), so nothing here compares bytes on disk: each package saves the
same script into its own directory and what each restores is held equal.
Round, version, history (``==``), the capped logs, the weights (bitwise),
the FedOpt moments (bitwise) and the ``ServerState`` that
``restore_server_state`` rebuilds, field by field, the buffered
``base_blobs`` re-key included, then both restored machines finish the
federation through tests/test_torch_rounds.py's ``Pair``. The privacy
maps are not in a step in either package. ``FedServer(checkpointer=)``
resumes like the JAX server, the statefile winning at an equal version.
"""

import asyncio
import dataclasses
import os

import jax
import numpy as np
import pytest

import test_torch_rounds as rounds_tests
from fedcrack_tpu import ckpt as JC
from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu_torch import ckpt as TC
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.fed import serialization as tser
from torch_port_helpers import TINY_KW, jax_variables

pytestmark = pytest.mark.torch_port

Pair = rounds_tests.Pair


def _bytes(tree):
    return [(np.asarray(x).shape, np.asarray(x).dtype.str, np.asarray(x).tobytes())
            for x in jax.tree_util.tree_leaves(tree)]


def _restore_both(tmp_path, save, template=None, **kw):
    """``save(ckptr, C)`` through each package's checkpointer into its own
    directory; returns both restored checkpoints."""
    out = []
    for C, name in ((JC, "jax"), (TC, "port")):
        with C.FedCheckpointer(tmp_path / name, **kw) as ckptr:
            save(ckptr, C)
            out.append((ckptr.restore(template), ckptr.latest_version()))
    return out


def _assert_same_checkpoint(got, want):
    assert (got.current_round, got.model_version) == (want.current_round, want.model_version)
    assert got.history == want.history
    assert dict(got.logs) == dict(want.logs)
    assert _bytes(got.variables) == _bytes(want.variables)


def test_save_restore_round_trip_matches_jax(tmp_path):
    variables = jax_variables(TINY_KW, seed=1)
    history = ({"round": 1, "clients": ["a", "b"], "samples": [4, 8], "wall_clock_s": 0.25, "rejected": {},
                "quarantined": {"b": 3.5}, "epsilon": {"a": 0.123456}},)

    def save(ckptr, C):
        ckptr.save(C.FedCheckpoint(current_round=2, model_version=1, variables=variables, history=history))

    (want, jv), (got, tv) = _restore_both(tmp_path, save, template=variables)
    assert jv == tv == 1
    _assert_same_checkpoint(got, want)
    assert got.history == history
    assert sorted(os.listdir(tmp_path / "port" / "1")) == ["meta.json", "variables.msgpack"]


def test_restore_without_template_gives_host_arrays(tmp_path):
    variables = jax_variables(TINY_KW, seed=2)
    (want, _), (got, _) = _restore_both(tmp_path, lambda c, C: c.save(C.FedCheckpoint(1, 0, variables)))
    assert all(isinstance(x, np.ndarray) for x in jax.tree_util.tree_leaves(got.variables))
    assert _bytes(got.variables) == _bytes(want.variables) == _bytes(variables)


@pytest.mark.parametrize("cap", [None, 1024 * 1024], ids=["uncapped", "capped"])
def test_logs_ride_along_with_the_same_cap(tmp_path, cap):
    """Over the cap the largest buffers go first, in both packages."""
    variables = {"w": np.zeros(3, np.float32)}
    logs = {"a/big.bin": bytes(range(256)) * (4 * 4096), "a/metrics.jsonl": b"metrics\n" * 100,
            "b/mid.bin": b"m" * 700_000}
    kw = {} if cap is None else {"max_log_bytes": cap}
    (want, _), (got, _) = _restore_both(tmp_path, lambda c, C: c.save(C.FedCheckpoint(1, 1, variables, logs=logs)),
                                        **kw)
    _assert_same_checkpoint(got, want)
    assert set(got.logs) == ({"a/metrics.jsonl", "b/mid.bin"} if cap else set(logs))
    assert os.path.getsize(tmp_path / "port" / "1" / "meta.json") < 64 * 1024


def test_empty_dir_latest_version_wins_and_old_steps_are_pruned(tmp_path):
    tree = {"w": np.arange(3, dtype=np.float32)}
    for C, name in ((JC, "jax"), (TC, "port")):
        with C.FedCheckpointer(tmp_path / name) as ckptr:
            assert ckptr.restore() is None and ckptr.latest_version() is None
    (want, jv), (got, tv) = _restore_both(
        tmp_path / "steps",
        lambda c, C: [c.save(C.FedCheckpoint(v + 1, v, {"w": tree["w"] + v})) for v in range(1, 6)],
        max_to_keep=2,
    )
    assert jv == tv == 5
    _assert_same_checkpoint(got, want)
    assert sorted(os.listdir(tmp_path / "steps" / "port")) == ["4", "5"]


def _assert_same_server_state(got, want):
    for name in ("phase", "current_round", "model_version", "history", "logs", "cohort", "received",
                 "secagg_seeds", "secagg_roster", "privacy_steps", "failed_rounds"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.global_blob == want.global_blob
    assert got.broadcast_blob == want.broadcast_blob
    assert got.base_blobs == want.base_blobs
    assert _bytes(got.template) == _bytes(want.template)
    assert (got.server_opt_state is None) == (want.server_opt_state is None)


def _jax_moments(state, optimizer):
    opt = state.server_opt_state
    if opt is None:
        return []
    return _bytes(opt[0].trace) if optimizer in ("momentum", "fedavgm") else _bytes(opt)


@pytest.mark.parametrize("kw", [
    {}, dict(server_optimizer="fedavgm", server_lr=0.5), dict(server_optimizer="fedadam", server_lr=0.5),
    dict(wire_dtype="bfloat16"), dict(mode="buffered", buffer_k=2), dict(max_rounds=1),
    dict(dp_clip_norm=1.0, dp_noise_multiplier=1.1),
], ids=["fedavg", "fedavgm", "fedadam", "bf16_wire", "buffered", "past_max_rounds", "dp"])
def test_restore_server_state_matches_jax_and_resumes(tmp_path, kw):
    """One round in both packages, saved and restored by each: the rebuilt
    states agree field by field, and the resumed machines finish the next
    round equal. A state past ``max_rounds`` restores FINISHED; the DP
    steps are not in a step, so the resumed accountant starts from zero
    in both."""
    tree = rounds_tests._fedopt_vars(0.0)
    p = Pair(tree, **{k: v for k, v in kw.items() if k != "max_rounds"}, max_rounds=3)
    if kw.get("mode") == "buffered":
        p.send("Ready", "a", now=0.0)
        p.send("Ready", "b", now=0.1)
        for name in ("a", "b"):
            p.send("PullWeights", name, now=0.5)
        for name, v in (("a", 1.0), ("b", 3.0)):
            p.done(name, 1, seed=0, now=1.0, tree=rounds_tests._fedopt_vars(v))
    else:
        p.enroll_two()
        p.done("a", 1, seed=0, now=2.0, tree=rounds_tests._fedopt_vars(1.0))
        p.done("b", 1, seed=0, now=3.0, tree=rounds_tests._fedopt_vars(3.0))
    assert p.t.model_version == 1
    cfg = {**p.cfg, **({"max_rounds": kw["max_rounds"]} if "max_rounds" in kw else {})}
    with JC.FedCheckpointer(tmp_path / "jax") as jck, TC.FedCheckpointer(tmp_path / "port") as tck:
        JC.save_server_state(jck, p.j)
        TC.save_server_state(tck, p.t)
        want = JC.restore_server_state(jck, JaxFedConfig(**cfg), template=tree)
        got = TC.restore_server_state(tck, FedConfig(**cfg), template=tree)
    _assert_same_server_state(got, want)
    assert got.phase == (TR.PHASE_FINISHED if "max_rounds" in kw else TR.PHASE_ENROLL)
    assert _bytes(got.server_opt_state or []) == _jax_moments(want, p.cfg.get("server_optimizer"))
    assert got.privacy_steps == {} and (p.t.privacy_steps != {}) == ("dp_noise_multiplier" in kw)
    if "max_rounds" in kw:
        return
    q = Pair(tree, **cfg)
    q.j, q.t = want, got
    q.check_state()
    if kw.get("mode") == "buffered":
        q.send("Ready", "a", now=10.0)
        q.send("Ready", "b", now=10.1)
        for name in ("a", "b"):
            q.send("PullWeights", name, now=10.5)
        for name, v in (("a", 2.0), ("b", 5.0)):
            q.done(name, 2, seed=0, now=11.0, tree=rounds_tests._fedopt_vars(v))
    else:
        q.enroll_two(t0=10.0)
        q.done("a", 2, seed=0, now=12.0, tree=rounds_tests._fedopt_vars(2.0))
        q.done("b", 2, seed=0, now=13.0, tree=rounds_tests._fedopt_vars(5.0))
    assert q.t.model_version == 2


def test_privacy_maps_are_not_in_a_checkpoint_in_either_package(tmp_path):
    """A secagg and DP federation one round in: ``restore_server_state``
    brings back neither the seeds, the roster nor the accountant's steps
    in either package, so a restart from the checkpoint alone resets the
    DP spend that only the statefile keeps."""
    import test_torch_privacy as privacy_tests

    p = Pair(privacy_tests.TMPL, **{**privacy_tests.SECAGG, "cohort_size": 2, "max_rounds": 3,
                                    "dp_clip_norm": 1.0, "dp_noise_multiplier": 1.1})
    privacy_tests._enroll(p, ["a", "b"])
    for name in ("a", "b"):
        p.send("TrainDone", name, round=1, blob=privacy_tests._masked(p, name, {"w": np.ones(6, np.float32)}, 4),
               num_samples=4, now=2.0)
    assert p.t.privacy_steps and p.t.secagg_roster and p.t.secagg_seeds
    with JC.FedCheckpointer(tmp_path / "jax") as jck, TC.FedCheckpointer(tmp_path / "port") as tck:
        JC.save_server_state(jck, p.j)
        TC.save_server_state(tck, p.t)
        want = JC.restore_server_state(jck, p.j.config, template=privacy_tests.TMPL)
        got = TC.restore_server_state(tck, p.t.config, template=privacy_tests.TMPL)
    _assert_same_server_state(got, want)
    assert (got.privacy_steps, got.secagg_seeds, got.secagg_roster) == ({}, {}, {})
    assert TR.privacy_summary(got) == JR.privacy_summary(want)
    assert got.history[-1]["epsilon"] == p.t.history[-1]["epsilon"]


def test_moments_of_another_optimizer_restart_from_zero(tmp_path, caplog):
    p = Pair(rounds_tests._fedopt_vars(0.0), server_optimizer="fedavgm", server_lr=0.5)
    p.enroll_two()
    p.done("a", 1, seed=0, now=2.0, tree=rounds_tests._fedopt_vars(1.0))
    p.done("b", 1, seed=0, now=3.0, tree=rounds_tests._fedopt_vars(3.0))
    with TC.FedCheckpointer(tmp_path) as ck:
        TC.save_server_state(ck, p.t)
        got = TC.restore_server_state(ck, FedConfig(**{**p.cfg, "server_optimizer": "fedadam"}))
        assert ck.restore_opt_state(([], [])) is None
    assert got.server_opt_state is None and "restarts from zero moments" in caplog.text


def _drive_server(server, blob, partial=False, R=TR):
    async def run():
        await server._apply(R.Ready(cname="a", now=0.0))
        await server._apply(R.Ready(cname="b", now=0.1))
        await server._apply(R.LogChunk(cname="a", title="tb", data=b"ev1", now=0.5))
        rnd = server.state.current_round
        await server._apply(R.TrainDone(cname="a", round=rnd, blob=blob, num_samples=4, now=1.0))
        await server._apply(R.TrainDone(cname="b", round=rnd, blob=blob, num_samples=4, now=1.1))
        if partial:
            await server._apply(R.TrainDone(cname="a", round=rnd + 1, blob=blob, num_samples=4, now=2.0))
        if server._bg_tasks:
            await asyncio.gather(*tuple(server._bg_tasks))

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fedserver_checkpoints_and_resumes_like_jax(tmp_path, pkg):
    """A server of either package runs a round into the directory; the
    port's ``FedServer`` over the port's checkpoints and the JAX server over
    its own resume to the same state."""
    from fedcrack_tpu.transport.service import FedServer as JaxFedServer
    from fedcrack_tpu_torch.transport.service import FedServer

    variables = jax_variables(TINY_KW, seed=3)
    blob = jser.tree_to_bytes(variables)
    kw = dict(max_rounds=3, cohort_size=2, registration_window_s=100.0)
    C, Server, Cfg, R = (TC, FedServer, FedConfig, TR) if pkg == "port" else (JC, JaxFedServer, JaxFedConfig, JR)
    with C.FedCheckpointer(tmp_path / "ckpt") as ckptr:
        first = Server(Cfg(**kw), variables, checkpointer=ckptr)
        _drive_server(first, blob, R=R)
        assert first.state.model_version == 1 and ckptr.latest_version() == 1
        second = Server(Cfg(**kw), variables, checkpointer=ckptr)
    assert (second.state.current_round, second.state.model_version, second.state.phase) == (2, 1, TR.PHASE_ENROLL)
    assert second.state.logs == {"a/tb": b"ev1"} and second.state.global_blob == first.state.global_blob
    if pkg == "port":
        assert [c["model_version"] for c in first.checkpoints] == [1]


def test_fedserver_statefile_beats_checkpoint_at_the_same_version(tmp_path):
    from fedcrack_tpu_torch.ckpt import save_state_file
    from fedcrack_tpu_torch.transport.service import FedServer

    variables = {"params": {"w": np.zeros(3, np.float32)}}
    cfg = FedConfig(cohort_size=2, max_rounds=3, registration_window_s=100.0,
                    state_path=str(tmp_path / "state.msgpack"))
    with TC.FedCheckpointer(tmp_path / "ckpt") as ckptr:
        _drive_server(FedServer(cfg, variables, checkpointer=ckptr), tser.tree_to_bytes(variables), partial=True)
        assert ckptr.latest_version() == 1
        second = FedServer(cfg, variables, checkpointer=ckptr)
        assert (second.state.phase, second.state.current_round, set(second.state.received)) == \
               (TR.PHASE_RUNNING, 2, {"a"})
        save_state_file(cfg.state_path, TR.initial_state(cfg, variables))  # a stale statefile
        third = FedServer(cfg, variables, checkpointer=ckptr)
        assert (third.state.model_version, third.state.phase) == (1, TR.PHASE_ENROLL)


def test_save_is_atomic_per_step(tmp_path, monkeypatch):
    """A save that fails midway leaves the previous step the latest, whole."""
    from fedcrack_tpu_torch.ckpt import manager

    with TC.FedCheckpointer(tmp_path) as ck:
        ck.save(TC.FedCheckpoint(2, 1, {"w": np.ones(2, np.float32)}))
        real = manager.atomic_write_bytes

        def fail_on_meta(path, data):
            if path.endswith("meta.json"):
                raise OSError("disk full")
            real(path, data)

        monkeypatch.setattr(manager, "atomic_write_bytes", fail_on_meta)
        with pytest.raises(OSError):
            ck.save(TC.FedCheckpoint(3, 2, {"w": np.zeros(2, np.float32)}))
        assert ck.latest_version() == 1
        restored = ck.restore()
    assert restored.model_version == 1 and restored.variables["w"].tolist() == [1.0, 1.0]
    assert [f.name for f in dataclasses.fields(TC.FedCheckpoint)] == [f.name for f in dataclasses.fields(JC.FedCheckpoint)]
