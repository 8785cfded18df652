"""The port's statefile (fedcrack_tpu_torch/ckpt/statefile.py) and the
ledger's wire rows held against the JAX package's on the CPU.

- Byte equality: after every event of every sync script of
  tests/test_torch_rounds.py (tests/test_fed.py's round-machine scripts,
  robust folds, quarantine, FedOpt with FedAvgM, FedAdam and FedYogi
  moments, bf16 wire, frames), the JAX state carried over to the port's
  ``ServerState`` serializes to the JAX package's statefile bytes. The
  buffered states of tests/test_torch_buffered.py are held the same way
  there, after every event.
- Cross-loading: each package restores the other's bytes of the same
  event and writes them back unchanged.
- FedOpt moments of another optimizer restart from zero in both; a
  corrupt, truncated or unknown-format file gives None in both; a
  snapshot older than the buffered fields seeds the retained window in
  both; a round past ``max_rounds`` restores FINISHED.

Bytes are exact; no tolerance in this file.
"""

import dataclasses
import logging

import jax
import msgpack
import numpy as np
import pytest

import test_torch_rounds as rounds_tests
from fedcrack_tpu.ckpt import statefile as JS
from fedcrack_tpu.configs import FedConfig as JaxFedConfig
from fedcrack_tpu.fed import rounds as JR
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu.health import ledger as JL
from fedcrack_tpu_torch.ckpt import statefile as TS
from fedcrack_tpu_torch.configs import FedConfig
from fedcrack_tpu_torch.fed import rounds as TR
from fedcrack_tpu_torch.health import ledger as TL

pytestmark = pytest.mark.torch_port

MOMENTUM = ("momentum", "fedavgm")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_config(config):
    return FedConfig.from_json(config.to_json())


def transplant(j):
    """The JAX ``ServerState`` ``j`` as the port's: every field the port
    has, the optax moments as the port's tuple."""
    opt = j.server_opt_state
    if opt is not None:
        opt = (_numpy(opt[0].trace),) if j.config.server_optimizer in MOMENTUM else tuple(map(_numpy, opt))
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(TR.ServerState)}
    return TR.ServerState(**{**fields, "config": port_config(j.config), "server_opt_state": opt})


def _unsecured(config):
    return dataclasses.replace(config, secagg=False)


def check_statefiles(jstate, tstate):
    """The JAX state's bytes from both packages; each package's bytes
    restored by the other and written back unchanged."""
    want = JS.server_state_to_bytes(jstate)
    assert TS.server_state_to_bytes(transplant(jstate)) == want
    own = TS.server_state_to_bytes(tstate)
    jcfg, tcfg = _unsecured(jstate.config), _unsecured(tstate.config)
    assert JS.server_state_to_bytes(JS.server_state_from_bytes(own, jcfg)) == own
    assert TS.server_state_to_bytes(TS.server_state_from_bytes(want, tcfg)) == want
    return len(want)


# Every script that drives both packages through rounds_tests.Pair (the one
# that does not is held at its end below).
PHASE8 = "chip_smoke_phase8_robust_round_small_width"


@pytest.mark.parametrize("name", sorted(set(rounds_tests.SCRIPTS) - {PHASE8}))
def test_statefile_bytes_equal_jax_after_every_event(name, monkeypatch):
    check_state = rounds_tests.Pair.check_state
    checked = []

    def check_with_statefile(self):
        check_state(self)
        checked.append(check_statefiles(self.j, self.t))

    monkeypatch.setattr(rounds_tests.Pair, "check_state", check_with_statefile)
    rounds_tests.SCRIPTS[name]()
    assert checked


def test_statefile_of_chip_smoke_phase8_round_at_small_width():
    """The robust round's end state (bf16 wire, trimmed mean, FedAdam
    moments, a rejection, the deadline's shrink) in both packages."""
    port_cfg = rounds_tests.chip_smoke.robust_round_config()
    run = rounds_tests._robust_round_at_small_width()
    got = run(TR, rounds_tests.tser, port_cfg)["state"]
    want = run(JR, jser, JaxFedConfig.from_json(port_cfg.to_json()))["state"]
    assert want.server_opt_state is not None and want.history[-1]["rejected"]
    check_statefiles(want, got)


def _fedopt_state(optimizer):
    """A JAX state one round into a FedOpt federation."""
    p = rounds_tests.Pair(rounds_tests._fedopt_vars(0.0), server_optimizer=optimizer, server_lr=0.5)
    p.enroll_two()
    p.done("a", 1, seed=0, now=2.0, tree=rounds_tests._fedopt_vars(1.0))
    p.done("b", 1, seed=0, now=3.0, tree=rounds_tests._fedopt_vars(3.0))
    assert p.j.server_opt_state is not None and p.t.server_opt_state is not None
    return p


@pytest.mark.parametrize("optimizer", ["fedavgm", "fedadam", "fedyogi"])
def test_fedopt_moments_cross_load_in_both_directions(optimizer):
    p = _fedopt_state(optimizer)
    jblob, tblob = JS.server_state_to_bytes(p.j), TS.server_state_to_bytes(p.t)
    # flax's state-dict view of the optax state, over params {"w": ...}
    raw = jser.tree_from_bytes(msgpack.unpackb(jblob)["opt_state"])
    if optimizer == "fedavgm":
        assert set(raw) == {"0", "1"} and set(raw["0"]) == {"trace"} and raw["1"] == {}
        assert set(raw["0"]["trace"]) == {"w"}
    else:
        assert set(raw) == {"0", "1"} and set(raw["0"]) == set(raw["1"]) == {"w"}
    port_from_jax = TS.server_state_from_bytes(jblob, p.t.config)
    jax_from_port = JS.server_state_from_bytes(tblob, p.j.config)
    for got, want in zip(port_from_jax.server_opt_state, transplant(p.j).server_opt_state):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert JS.server_state_to_bytes(jax_from_port) == tblob
    assert TS.server_state_to_bytes(port_from_jax) == jblob


@pytest.mark.parametrize("written,restored", [("fedavgm", "fedadam"), ("fedadam", "fedavgm"),
                                              ("fedyogi", "fedavgm"), ("fedadam", "avg")])
def test_moments_of_another_optimizer_restart_from_zero_in_both(written, restored, caplog):
    blob = JS.server_state_to_bytes(_fedopt_state(written).j)
    kw = dict(rounds_tests.CFG, server_optimizer=restored, server_lr=0.5)
    with caplog.at_level(logging.WARNING):
        got = (TS.server_state_from_bytes(blob, FedConfig(**kw)),
               JS.server_state_from_bytes(blob, JaxFedConfig(**kw)))
    assert got[0].server_opt_state is None and got[1].server_opt_state is None
    if restored != "avg":
        assert sum("restarting moments from zero" in r.getMessage() for r in caplog.records) == 2


@pytest.mark.parametrize("blob", [b"", b"\x00garbage not msgpack", b"\x81\xa6format\x02", b"\x93\x01\x02\x03",
                                  "truncated"])
def test_corrupt_or_foreign_file_loads_as_none_in_both(tmp_path, blob):
    if blob == "truncated":
        blob = JS.server_state_to_bytes(_fedopt_state("fedadam").j)[:-7]
    path = tmp_path / "state.msgpack"
    path.write_bytes(blob)
    assert TS.load_state_file(str(path), FedConfig(**rounds_tests.CFG)) is None
    assert JS.load_state_file(str(path), JaxFedConfig(**rounds_tests.CFG)) is None
    assert TS.load_state_file(str(tmp_path / "missing"), FedConfig()) is None


def test_files_written_by_either_package_load_in_the_other(tmp_path):
    p = _fedopt_state("fedadam")
    for save, load, state, cfg in ((TS.save_state_file, JS.load_state_file, p.t, p.j.config),
                                   (JS.save_state_file, TS.load_state_file, p.j, p.t.config)):
        path = str(tmp_path / f"{save.__module__}.msgpack")
        written = save(path, state)
        if save is TS.save_state_file:
            assert written == len(open(path, "rb").read())
        restored = load(path, cfg)
        assert restored is not None and restored.model_version == 1 and restored.phase == JR.PHASE_RUNNING
        assert open(path, "rb").read() == (JS if load is JS.load_state_file else TS).server_state_to_bytes(restored)


def test_snapshot_before_the_buffered_fields_seeds_the_window_in_both():
    p = rounds_tests.Pair(rounds_tests._tree(42))
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    p.done("b", 1, seed=2, now=3.0)
    payload = msgpack.unpackb(JS.server_state_to_bytes(p.j))
    for key in ("buffer", "pulled", "base_blobs", "ledger", "secagg_seeds", "secagg_roster", "privacy_steps"):
        del payload[key]
    old = msgpack.packb(payload, use_bin_type=True)
    kw = dict(rounds_tests.CFG, mode="buffered", buffer_k=2)
    got = TS.server_state_from_bytes(old, FedConfig(**kw))
    want = JS.server_state_from_bytes(old, JaxFedConfig(**kw))
    assert got.base_blobs == want.base_blobs == {1: p.j.global_blob}
    assert (got.buffer, got.pulled, got.ledger) == (want.buffer, want.pulled, want.ledger) == ((), {}, {})
    assert TS.server_state_to_bytes(got) == JS.server_state_to_bytes(want)
    sync = TS.server_state_from_bytes(old, FedConfig(**rounds_tests.CFG))
    assert sync.base_blobs == {}


def test_round_past_max_rounds_restores_finished():
    p = rounds_tests.Pair(rounds_tests._tree(42))
    p.enroll_two()
    p.done("a", 1, seed=1, now=2.0)
    p.done("b", 1, seed=2, now=3.0)
    blob = TS.server_state_to_bytes(p.t)
    kw = dict(rounds_tests.CFG, max_rounds=1)
    got = TS.server_state_from_bytes(blob, FedConfig(**kw))
    assert got.phase == JS.server_state_from_bytes(blob, JaxFedConfig(**kw)).phase == TR.PHASE_FINISHED
    assert (got.enroll_opened_at, got.round_started_at) == (None, None)


def test_history_values_encode_as_msgpack_writes_them():
    """A tuple is an array and a numpy float64 a float64, as the msgpack
    package's packer has them; a numpy float32 is refused alike."""
    p = rounds_tests.Pair(rounds_tests._tree(42))
    entry = {"round": 1, "pair": ("a", 2), "f64": np.float64(0.1), "nested": {"z": [1.5, None, True]}}
    j = p.j._replace(history=(entry,))
    assert TS.server_state_to_bytes(transplant(j)) == JS.server_state_to_bytes(j)
    bad = j._replace(history=({"f32": np.float32(0.5)},))
    with pytest.raises(TypeError):
        JS.server_state_to_bytes(bad)
    with pytest.raises(TypeError):
        TS.server_state_to_bytes(transplant(bad))


def test_ledger_wire_rows_match_jax():
    ledger = {
        "b": {**TL.new_record(), "offers": 3, "accepted": 2, "rejected": {"stale": 1, "other": 2},
              "norms": [0.5, 1.25], "cosines": [0.9], "anomaly": 4.5, "flags": 1, "quarantined": 2},
        "a": TL.new_record(),
    }
    rows = TL.ledger_to_wire(ledger)
    assert rows == JL.ledger_to_wire(ledger) and [r[0] for r in rows] == ["a", "b"]
    assert TL.ledger_from_wire(rows) == JL.ledger_from_wire(rows) == {k: ledger[k] for k in ("a", "b")}
    short = [row[:13] for row in rows]  # rows written before the quarantine counter
    assert TL.ledger_from_wire(short) == JL.ledger_from_wire(short)
    assert TL.ledger_from_wire(None) == JL.ledger_from_wire(None) == {}
