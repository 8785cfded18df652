"""The port's concurrent mini-soak held against the JAX package's on the CPU.

``tools/soak.py`` runs every plane at once (a buffered federation over
gRPC with chaos, an edge shard, the serve plane hot-swapping off the live
statefile, a driver leg, the EF twin) and closes with an invariant audit.
Its arrival order is chaos-driven, so two runs count differently: the two
packages are held to each other by the audit's invariants and by the
artifact's structure, and by the deterministic parts byte for byte:

- ``_perturb_tree`` is byte-equal to the JAX soak's on the same template
  and generator;
- ``_ef_conservation_leg`` conserves and drains in both packages;
- both packages' ``run_soak(duration_s=3.0, seed=0)`` (the port's on the
  CPU) audit clean under tests/test_telemetry.py's ``_assert_soak_clean``
  (the port without its recompile arm), and their artifacts have the same
  keys at every level but the audit's ``recompiles_since_warmup``;
- the command line writes a clean artifact, and a breaching
  ``--slo-rules`` file exits ``BREACH_EXIT`` in both packages.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BREACH_RULES = os.path.join(ROOT, "configs", "slo_breach_smoke.json")


def _jax_template(seed=0):
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.models.resunet import init_variables

    cfg = ModelConfig(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
    return jax.tree_util.tree_map(np.asarray, init_variables(jax.random.key(seed), cfg))


def _port_template(seed=0):
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.tools.soak import SOAK_MODEL

    return init_variables(torch.Generator().manual_seed(seed), ModelConfig(**SOAK_MODEL))


# ---- the deterministic parts ----


@pytest.mark.parametrize("origin,seed,scale", [
    ("jax", 0, 1e-3), ("jax", 3, 1e-2), ("port", 0, 1e-3), ("port", 5, 1e-2),
], ids=["jax-template", "jax-template-ef-scale", "port-template", "port-template-ef-scale"])
def test_perturb_tree_byte_equal_to_jax(origin, seed, scale):
    from fedcrack_tpu.fed.serialization import tree_to_bytes as jax_bytes
    from fedcrack_tpu.tools.soak import _perturb_tree as jax_perturb
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.fed.serialization import tree_to_bytes
    from fedcrack_tpu_torch.tools.soak import _perturb_tree

    template = _jax_template(seed) if origin == "jax" else _port_template(seed)
    # Two draws from one generator each: the generator state carries over.
    got_rng, want_rng = np.random.default_rng((seed, 1)), np.random.default_rng((seed, 1))
    for _ in range(2):
        got = _perturb_tree(template, got_rng, scale=scale)
        want = jax_perturb(template, want_rng, scale=scale)
        assert tree_to_bytes(got) == jax_bytes(want)
        assert all(a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes()
                   for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert any(not np.array_equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(template)))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_ef_conservation_leg_conserves_and_drains(package):
    if package == "jax":
        from fedcrack_tpu.tools.soak import _ef_conservation_leg

        template = _jax_template()
    else:
        from fedcrack_tpu_torch.tools.soak import _ef_conservation_leg

        template = _port_template()
    stop = threading.Event()
    out: dict = {}
    t = threading.Thread(target=_ef_conservation_leg, args=(template, stop, out, 0))
    t.start()
    time.sleep(0.5)
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert out["violations"] == 0 and out["drained"] and out["checks"] > 0, out
    assert out["drain_end_mass"] <= out["drain_start_mass"]


# ---- the soak itself, both packages ----


def _assert_soak_clean(artifact: dict, port: bool):
    """tests/test_telemetry.py's ``_assert_soak_clean``; the port's audit
    has no recompile arm."""
    audit = artifact["audit"]
    assert audit["clean"], json.dumps({"audit": audit, "watchdog": artifact["watchdog"]}, indent=1,
                                      sort_keys=True, default=str)
    assert audit["zero_torn_versions"] and audit["torn_versions"] == 0
    assert audit["serve_healthy"]
    assert audit["ef_mass_conserved"]
    assert audit["statefile_restore_bit_identical"]
    assert audit["watermarks_steady"]
    if port:
        assert "recompiles_since_warmup" not in audit
    else:
        assert audit["recompiles_since_warmup"] == 0
    scrape_block = artifact["scrape"]
    assert scrape_block["all_planes_covered"], scrape_block["planes_covered"]
    assert scrape_block["mid_soak_families"] > 0
    assert artifact["serve"]["completed"] > 0
    assert artifact["serve"]["failed"] == 0
    assert artifact["federation"]["flushes"] > 0
    assert artifact["spans"]["total"] > 0
    for name in ("serve.batch", "fed.flush", "driver.round", "client.train"):
        assert artifact["spans"]["by_name"].get(name, 0) > 0, name
    wd = artifact["watchdog"]
    assert wd["clean"] and wd["all_rules_evaluated"], wd
    assert wd["breaches"] == [] and wd["evaluations"] > 1
    assert audit["watchdog_clean"]
    tr = artifact["tracing"]
    assert tr["complete"], tr
    assert {"client", "fed", "serve"} <= set(tr["planes_crossed"])
    assert tr["trace"].startswith("fedtr-v")
    for stage in ("fed.flush", "serve.swap", "serve.batch"):
        assert stage in tr["stages"], (stage, tr)
    assert {"client.push", "edge.flush_partial"} & set(tr["stages"]), tr
    assert artifact["federation"]["kill_restart"]["killed"]
    assert artifact["serve"]["swaps"] > 0


@pytest.fixture(scope="module")
def soaks():
    from fedcrack_tpu.tools.soak import run_soak as jax_run_soak
    from fedcrack_tpu_torch.tools.soak import run_soak

    return {"port": run_soak(duration_s=3.0, seed=0, device="cpu"), "jax": jax_run_soak(duration_s=3.0, seed=0)}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_soak_short_wall_clean_audit(soaks, package):
    _assert_soak_clean(soaks[package], port=package == "port")


def _key_paths(node, prefix=()):
    """Every dict key path of an artifact, leaves' values left out; the
    keys of a few value-keyed maps (span names, psi buckets) are data, not
    structure."""
    out = set()
    if isinstance(node, dict):
        for k, v in node.items():
            out.add(prefix + (k,))
            if prefix + (k,) not in DATA_KEYED:
                out |= _key_paths(v, prefix + (k,))
    return out


DATA_KEYED = {("spans", "by_name"), ("health", "drift_psi"), ("driver",)}
# The port's spans inside the round and the train step, which the JAX
# package does not open (the soak's stub round opens the driver's).
ROUND_LAYER_SPANS = {"driver.stage", "driver.barrier", "data.pin", "data.copy", "mesh.slot", "mesh.slot_init",
                     "mesh.fold", "mesh.finish", "train.forward", "train.backward", "train.optimizer"}


def test_soak_artifacts_same_structure(soaks):
    port, jax_ = soaks["port"], soaks["jax"]
    assert set(port) == set(jax_)
    diff = _key_paths(jax_) ^ _key_paths(port)
    assert diff == {("audit", "recompiles_since_warmup")}, sorted(diff)
    assert set(port["audit"]) == set(jax_["audit"]) - {"recompiles_since_warmup"}
    assert port["scrape"]["planes_covered"] == jax_["scrape"]["planes_covered"]
    assert port["config"] == jax_["config"]
    assert port["paths"] == jax_["paths"] == {}
    # The driver legs both ran their three stub rounds.
    assert port["driver"]["rounds"] == jax_["driver"]["rounds"] == 3
    # The same span catalog crossed the same planes.
    core = {"client.push", "client.train", "driver.round", "fed.flush", "serve.batch", "serve.swap"}
    assert core <= set(port["spans"]["by_name"]) and core <= set(jax_["spans"]["by_name"])
    assert set(port["spans"]["by_name"]) <= set(jax_["spans"]["by_name"]) | {
        "client.enroll", "client.pull", "edge.flush_partial", "health.canary"} | ROUND_LAYER_SPANS
    assert {"driver.stage", "driver.barrier"} <= set(port["spans"]["by_name"])


def test_soak_protocol_invariants_hold_in_both(soaks):
    """What must hold however the chaos ordered the run: the storm fired,
    every flush made a version, the edge took its leaves, the ledger
    counted every verdict, every served version was published, a canary
    ran per installed version, and the EF twin checked."""
    for name, a in soaks.items():
        fed = a["federation"]
        assert a["storm_fired"], name
        assert fed["global_versions"] == fed["flushes"] > 0, name
        assert fed["accepted_updates_scraped"] > 0, name
        assert a["edge"]["accepted"] > 0, name
        assert a["audit"]["unpublished_served_versions"] == [], name
        assert set(a["serve"]["versions_seen"]) <= {0} | set(range(1, fed["global_versions"] + 1)), name
        assert a["audit"]["ledger_conserved"] and a["health"]["ledger_clients"] >= 3, name
        assert a["audit"]["ef"]["checks"] > 0 and a["audit"]["ef"]["violations"] == 0, name
        assert a["health"]["canary"]["evals"] == a["serve"]["swaps"] + 1, name
        assert a["audit"]["hung_threads"] == [], name


def test_soak_defaults_to_cuda_and_its_rules():
    import torch

    from fedcrack_tpu.obs.watchdog import default_rules as jax_rules
    from fedcrack_tpu_torch.tools import soak

    assert [r.name for r in soak.soak_rules()] == [r.name for r in jax_rules() if r.name != "zero_serve_recompiles"]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        soak.run_soak(duration_s=0.1)


# ---- the command line ----


def test_cli_device_cpu_out_exits_zero(tmp_path, capsys):
    from fedcrack_tpu_torch.tools.soak import main

    out = tmp_path / "sub" / "soak.json"
    workdir = tmp_path / "work"
    assert main(["--duration", "2", "--device", "cpu", "--out", str(out), "--workdir", str(workdir)]) == 0
    artifact = json.loads(out.read_text())
    assert artifact["audit"]["clean"]
    assert artifact["config"]["duration_s"] == 2.0
    for key in ("metrics_dump", "spans", "statefile", "stitched_trace", "ledger", "canary", "drift"):
        assert os.path.exists(artifact["paths"][key]), key
    # The flight ring dumps only on a breach or a failed audit.
    assert not os.path.exists(artifact["paths"]["flight"])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed and json.loads(printed.split("\n", 1)[1])["clean"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_cli_breaching_rules_exit_breach(package, tmp_path):
    if package == "port":
        from fedcrack_tpu_torch.obs.watchdog import BREACH_EXIT
        from fedcrack_tpu_torch.tools.soak import main

        argv = ["--device", "cpu"]
    else:
        from fedcrack_tpu.obs.watchdog import BREACH_EXIT
        from fedcrack_tpu.tools.soak import main

        argv = []
    out = tmp_path / "soak.json"
    rc = main(argv + ["--duration", "1.5", "--no-kill", "--slo-rules", BREACH_RULES, "--out", str(out)])
    assert rc == BREACH_EXIT == 3
    artifact = json.loads(out.read_text())
    assert artifact["watchdog"]["breaches"] and not artifact["audit"]["watchdog_clean"]
    assert not artifact["audit"]["clean"]
    assert artifact["config"]["kill_restart"] is False


@pytest.mark.slow
def test_mini_soak_sixty_seconds():
    """A minute: long enough for hundreds of flushes and dozens of swaps;
    the same audit must stay clean."""
    from fedcrack_tpu_torch.tools.soak import run_soak

    artifact = run_soak(duration_s=60.0, seed=0, device="cpu")
    _assert_soak_clean(artifact, port=True)
    assert artifact["serve"]["swaps"] >= 5
    assert artifact["federation"]["global_versions"] >= 20
