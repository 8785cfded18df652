"""The port's multi-process plane (``fedcrack_tpu_torch.parallel.multihost``)
on the CPU: the counterparts of ``tests/test_multihost.py``.

The single-process tests drive ``initialize_if_needed``'s resolution and
error branches with a monkeypatched ``torch.distributed``, as the JAX
tests fake ``jax.distributed``. The two-process tests are the real thing:
two OS processes join one ``gloo`` process group through a ``file://``
store under the test's temp directory (no port to race for between test
workers), each with one intra-op thread, and run many cases in one launch:

- the ``(4, 2)`` round over two processes, two clients each, for the
  null, int8, DP-SGD and top-k builds over 2 rounds: every round's global
  bit-equal on both ranks and to the port's one-process round, and the
  null build's first round within ``tests/test_parallel.py::
  _assert_trees_match``'s tolerances of JAX's ``_host_round`` (the JAX
  package's own two-process test is slow, and fails on the installed JAX);
- the cohort round, six clients in groups of four (the last ragged),
  streamed and resident, each rank staging its two slots of every group:
  the global and metrics bit-equal on both ranks and to one process;
- the spatial plane at S = 4, two bands per rank: the halo rows at the
  rank boundary (two distinct images) and their cotangents bit-equal to
  the one-process halo's; the predict and one SGD step against the
  one-process spatial plane at ``tests/test_torch_spatial.py``'s
  tolerances, the new weights bit-equal on both ranks.

A peer that never joins makes the bring-up raise within its timeout.
Every worker is waited on with a timeout and killed in a ``finally``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KW = dict(img_size=16, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
SPATIAL_KW = dict(TINY_KW, img_size=64)
SPATIAL_ROUND_KW = dict(TINY_KW, img_size=32)
STEPS, BATCH, ROUNDS = 2, 4, 2
ACTIVE = np.array([1, 1, 1, 0], np.float32)
N_SAMPLES = np.array([8, 8, 16, 8], np.float32)
SHARDS = 4
# The cohort round across processes: six clients in groups of the mesh's
# four slots, so the second group is ragged (two padding slots, both on
# rank 1).
COHORT_ACTIVE = np.array([1, 1, 0, 1, 1, 1], np.float32)
COHORT_N = np.array([8, 16, 8, 8, 24, 8], np.float32)
# The round builds the workers run, by name: build_federated_round's
# keyword arguments.
BUILDS = {
    "null": {},
    "int8": {"update_codec": "int8"},
    "dp": {"dp_clip_norm": 1.0, "dp_noise_multiplier": 1.1, "dp_seed": 42},
    "topk": {"update_codec": "topk_delta", "topk_fraction": 0.1},
}
WORKER_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The one-process references run at the workers' thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- single process: the resolution order, with torch.distributed faked ----


@pytest.fixture
def not_initialized(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


def test_explicit_args_must_be_complete(not_initialized):
    from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed

    with pytest.raises(ValueError, match="together"):
        initialize_if_needed("10.0.0.1:9999")
    with pytest.raises(ValueError, match="together"):
        initialize_if_needed("10.0.0.1:9999", num_processes=4)
    with pytest.raises(ValueError, match="together"):
        initialize_if_needed("10.0.0.1:9999", num_processes=4, process_id=-1)
    with pytest.raises(ValueError, match="together"):
        initialize_if_needed(num_processes=4, process_id=0)


def test_env_var_resolution(not_initialized, monkeypatch):
    import torch.distributed as dist

    from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed

    calls = {}
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9999")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert initialize_if_needed(timeout_s=7.0) is True
    timeout = calls.pop("timeout")
    assert timeout.total_seconds() == 7.0
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:9999", "world_size": 4, "rank": 2}


def test_env_var_incomplete_raises(not_initialized, monkeypatch):
    from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9999")
    with pytest.raises(ValueError, match="together"):
        initialize_if_needed()


def test_no_cluster_means_single_host(not_initialized, monkeypatch):
    import torch.distributed as dist

    from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed

    def boom(*a, **kw):
        raise AssertionError("no process group without arguments or environment")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert initialize_if_needed() is False


def test_already_initialized_short_circuits(monkeypatch):
    import torch.distributed as dist

    from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed

    monkeypatch.setattr(dist, "is_initialized", lambda: True)

    def boom(*a, **kw):
        raise AssertionError("init_process_group must not be called again")

    monkeypatch.setattr(dist, "init_process_group", boom)
    # Even incomplete arguments: an up group answers before they are read.
    assert initialize_if_needed("10.0.0.1:9999") is True


def test_helpers_single_process():
    from fedcrack_tpu_torch.parallel import make_mesh
    from fedcrack_tpu_torch.parallel.multihost import WORLD, global_mesh_devices, is_coordinator

    assert is_coordinator()
    assert global_mesh_devices("cpu") == [(0, torch.device("cpu"))]
    # A mesh that spans processes needs a process group: no silent fallback.
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(4, 2, device="cpu", group=WORLD)


# ---- two processes over gloo ----

_WORKER = r"""
import os, sys
for name in ("jax", "jaxlib", "flax", "optax", "fedcrack_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)
rank, store, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.parallel import (build_federated_cohort_round, build_federated_round,
    build_federated_round_segments, build_spatial_federated_round, build_spatial_predict, build_spatial_train_step, global_mesh_devices,
    initialize_if_needed, is_coordinator, make_mesh, make_spatial_mesh, run_mesh_federation)
from fedcrack_tpu_torch.parallel.multihost import WORLD
from fedcrack_tpu_torch.parallel.spatial import fold_shards, halo_exchange

def unflat(z, prefix):
    out = {{}}
    for key in z.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = z[key]
    return out

def flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/", out)
        else:
            out[prefix + k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out

assert initialize_if_needed("file://" + store, 2, rank, timeout_s=120.0)
assert initialize_if_needed()  # an up group short-circuits
assert is_coordinator() == (rank == 0)
assert global_mesh_devices("cpu") == [(0, torch.device("cpu")), (1, torch.device("cpu"))]
z = np.load(os.path.join(work, "inputs.npz"))
out = {{}}

# The (4, 2) round, two clients per rank, every build over 2 rounds.
tiny = ModelConfig(**{tiny!r})
builds = {builds!r}
mine = slice(2 * rank, 2 * rank + 2)
images, masks = z["images"][mine], z["masks"][mine]
active, n_samples = z["active"], z["n_samples"]
mesh = make_mesh(4, 2, device="cpu", group=WORLD)
assert list(mesh.local_range("clients")) == [2 * rank, 2 * rank + 1]
for name, kw in builds.items():
    round_fn = build_federated_round(mesh, tiny, learning_rate=1e-3, local_epochs=1, **kw)
    variables = unflat(z, "global/")
    for r in range({rounds}):
        variables, metrics = round_fn(variables, images, masks, active, n_samples)
        flat(variables, f"{{name}}/{{r}}/", out)
        for k, v in metrics.items():
            out[f"{{name}}/{{r}}/metrics/{{k}}"] = v.numpy()
    out[f"{{name}}/gather_bytes"] = np.asarray(round_fn.last_gather["bytes"])
# Resident: this rank's pools and a plan that gathers the streamed slabs.
res = build_federated_round(mesh, tiny, learning_rate=1e-3, local_epochs=1, data_placement="resident")
pool = (images.reshape(2, -1, *images.shape[3:]), masks.reshape(2, -1, *masks.shape[3:]))
plan = np.arange(images.shape[1] * images.shape[2]).reshape(1, 1, images.shape[1], images.shape[2]).repeat(2, 0)
res_vars, _ = res(unflat(z, "global/"), pool, plan, active, n_samples)
flat(res_vars, "resident/", out)
seg = build_federated_round_segments(mesh, tiny, learning_rate=1e-3, local_epochs=2, segments=2)
seg_vars, _ = seg(unflat(z, "global/"), images, masks, active, n_samples)
flat(seg_vars, "segmented/", out)
# The cohort round: the whole cohort's data in, each rank staging its
# block (two slots) of every group of four, the ragged last group's
# padding included; streamed and resident.
c_imgs, c_msks = z["cohort_images"], z["cohort_masks"]
for placement in ("streamed", "resident"):
    cr = build_federated_cohort_round(mesh, tiny, learning_rate=1e-3, local_epochs=2, segments=2,
                                      data_placement=placement)
    assert cr.block == slice(2 * rank, 2 * rank + 2)
    if placement == "streamed":
        data = (c_imgs, c_msks)
    else:
        n = c_imgs.shape[1] * c_imgs.shape[2]
        plan = np.broadcast_to(np.arange(n, dtype=np.int32).reshape(1, 1, *c_imgs.shape[1:3]),
                               (c_imgs.shape[0], 2, *c_imgs.shape[1:3]))
        data = ((c_imgs.reshape(c_imgs.shape[0], n, *c_imgs.shape[3:]),
                 c_msks.reshape(c_msks.shape[0], n, *c_msks.shape[3:])), plan)
    cv, cm = cr(unflat(z, "global/"), *data, z["cohort_active"], z["cohort_n"])
    flat(cv, f"cohort_{{placement}}/", out)
    for k, v in cm.items():
        out[f"cohort_{{placement}}/metrics/{{k}}"] = v.numpy()
try:
    run_mesh_federation(round_fn, unflat(z, "global/"), lambda r: None, 1, mesh)
except ValueError as e:
    assert "drives its own loop" in str(e), e
else:
    raise AssertionError("run_mesh_federation ran a mesh that spans processes")

# The spatial round on a (clients, space) mesh: its clients across the
# processes, each client's bands in one.
sr_mesh = make_mesh(2, 2, device="cpu", axis_names=("clients", "space"), group=WORLD)
sr = build_spatial_federated_round(sr_mesh, ModelConfig(**{sr_cfg!r}), learning_rate=1e-3, local_epochs=1)
sr_vars, _ = sr(unflat(z, "sr_global/"), z["sr_images"][rank:rank + 1], z["sr_masks"][rank:rank + 1],
                np.ones(2, np.float32), np.array([4.0, 8.0], np.float32))
flat(sr_vars, "spatial_round/", out)

# The halo across the rank boundary, forward and backward.
x = torch.from_numpy(z["halo_x"][:, 4 * rank:4 * rank + 4].copy()).requires_grad_(True)
got = halo_exchange(fold_shards(x, 2), 2, up=1, down=1, fill=-1.5, span=mesh.span)
got.backward(torch.from_numpy(z["halo_g"][4 * rank:4 * rank + 4].copy()))
out["halo/out"], out["halo/grad"] = got.detach().numpy(), x.grad.numpy()

# The spatial plane at S = 4, two bands per rank.
cfg = ModelConfig(**{spatial!r})
smesh = make_spatial_mesh({shards}, 1, device="cpu", group=WORLD)
rows = slice(32 * rank, 32 * rank + 32)
s_images, s_masks = (np.ascontiguousarray(z[k][:, rows]) for k in ("s_images", "s_masks"))
svars = unflat(z, "s_global/")
out["spatial/probs"] = build_spatial_predict(smesh, cfg)(svars, s_images).numpy()
step = build_spatial_train_step(smesh, cfg, optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
state = step.init(svars)
smesh.span.reset_stats()
state, m = step(state, torch.from_numpy(s_images), torch.from_numpy(s_masks))
flat(state.variables, "spatial/step/", out)
for k, v in m.items():
    out[f"spatial/metrics/{{k}}"] = v.numpy()
out["spatial/exchange_calls"] = np.asarray(smesh.span.stats["calls"])
np.savez(os.path.join(work, f"rank{{rank}}.npz"), **out)
print(f"OK rank={{rank}}", flush=True)
"""


def _launch_two_workers(script_text: str, work, timeout: float, extra=()) -> list[str]:
    """Run the script as ranks 0 and 1 (argv: rank, store path, work dir,
    ``extra``); return their outputs. Waits with a timeout and kills any
    worker still running, so a hung peer fails the test instead of the
    suite."""
    script = work / "worker.py"
    script.write_text(script_text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), str(work / "store"), str(work), *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def _flat(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], path + (k,))
        else:
            v = tree[k]
            yield "/".join(path + (k,)), (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))


def _jax_inputs():
    """Four clients' tiny round data and JAX's initial variables (the
    round's), and the spatial plane's two distinct 64 x 64 images."""
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu.parallel import stack_client_data
    from fedcrack_tpu.train.local import create_train_state

    per_client = [synth_crack_batch(STEPS * BATCH, img_size=16, seed=c) for c in range(4)]
    images, masks = stack_client_data(per_client, STEPS, BATCH)
    state = create_train_state(jax.random.key(0), ModelConfig(**TINY_KW))
    variables = jax.tree_util.tree_map(np.asarray, state.variables)
    return images, masks, variables


def _cohort_data():
    """Six clients' tiny round data (``[6, STEPS, BATCH, 16, 16, ch]``)."""
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu.parallel import stack_client_data

    return stack_client_data([synth_crack_batch(STEPS * BATCH, img_size=16, seed=40 + c)
                              for c in range(len(COHORT_ACTIVE))], STEPS, BATCH)


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """One launch of the two workers; returns the inputs and each rank's
    outputs."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import init_variables

    work = tmp_path_factory.mktemp("multihost")
    images, masks, variables = _jax_inputs()
    rng = np.random.default_rng(16)
    s_images = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    s_masks = (rng.uniform(size=(2, 64, 64, 1)) > 0.7).astype(np.float32)
    s_vars = init_variables(torch.Generator().manual_seed(16), ModelConfig(**SPATIAL_KW))
    sr_images = rng.uniform(size=(2, 2, 2, 32, 32, 3)).astype(np.float32)  # [C, steps, B, H, W, 3]
    sr_masks = (rng.uniform(size=(2, 2, 2, 32, 32, 1)) > 0.7).astype(np.float32)
    sr_vars = init_variables(torch.Generator().manual_seed(17), ModelConfig(**SPATIAL_ROUND_KW))
    halo_x = (np.arange(2 * 8 * 3 * 2, dtype=np.float32).reshape(2, 8, 3, 2) + 1.0)
    halo_g = rng.integers(-8, 9, size=(8, 2, 4, 3)).astype(np.float32)  # the fold of 2 images x 4 bands
    c_images, c_masks = _cohort_data()
    inputs = {"images": images, "masks": masks, "active": ACTIVE, "n_samples": N_SAMPLES,
              "cohort_images": c_images, "cohort_masks": c_masks, "cohort_active": COHORT_ACTIVE,
              "cohort_n": COHORT_N,
              "s_images": s_images, "s_masks": s_masks, "halo_x": halo_x, "halo_g": halo_g,
              "sr_images": sr_images, "sr_masks": sr_masks,
              **{f"global/{k}": v for k, v in _flat(variables)}, **{f"s_global/{k}": v for k, v in _flat(s_vars)},
              **{f"sr_global/{k}": v for k, v in _flat(sr_vars)}}
    np.savez(work / "inputs.npz", **inputs)
    script = _WORKER.format(root=ROOT, tiny=TINY_KW, builds=BUILDS, rounds=ROUNDS, spatial=SPATIAL_KW,
                            shards=SHARDS, sr_cfg=SPATIAL_ROUND_KW)
    outs = _launch_two_workers(script, work, WORKER_TIMEOUT_S)
    assert all(f"OK rank={r}" in o for r, o in zip(range(2), outs)), outs
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return {"inputs": inputs, "variables": variables, "s_vars": s_vars, "sr_vars": sr_vars, "ranks": ranks}


def _tree_of(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix) and "/metrics/" not in k}


def _one_process_rounds(run, name):
    """The same build's 2 rounds on the port's one-process (4, 2) mesh."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_federated_round, make_mesh

    inp = run["inputs"]
    round_fn = build_federated_round(make_mesh(4, 2, device="cpu"), ModelConfig(**TINY_KW), learning_rate=1e-3,
                                     local_epochs=1, **BUILDS[name])
    variables, out = run["variables"], []
    for _ in range(ROUNDS):
        variables, metrics = round_fn(variables, inp["images"], inp["masks"], ACTIVE, N_SAMPLES)
        out.append((dict(_flat(variables)), {k: v.numpy() for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("name", list(BUILDS))
def test_two_process_round_bit_equal_to_one_process(two_process_run, name):
    """Each round's global is the same bits on both ranks and in one
    process; so are the global ``[C]`` metrics every rank returns."""
    r0, r1 = two_process_run["ranks"]
    for r, (want, want_metrics) in enumerate(_one_process_rounds(two_process_run, name)):
        g0, g1 = _tree_of(r0, f"{name}/{r}/"), _tree_of(r1, f"{name}/{r}/")
        assert set(g0) == set(g1) == set(want)
        for key in want:
            assert g0[key].tobytes() == g1[key].tobytes(), (name, r, key, "rank 0 vs rank 1")
            assert g0[key].tobytes() == want[key].tobytes(), (name, r, key, "two processes vs one")
        for k, v in want_metrics.items():
            assert v.shape == (4,)
            for rank in (r0, r1):
                assert rank[f"{name}/{r}/metrics/{k}"].tobytes() == v.tobytes(), (name, r, k)
    # Each rank gathered both ranks' two slot updates of every leaf.
    n = sum(v.size for v in _tree_of(r0, f"{name}/0/").values())
    assert int(r0[f"{name}/gather_bytes"]) >= 2 * 2 * n * 4


def test_two_process_round_matches_jax_host_round(two_process_run):
    """The null build's first round against JAX's ``_host_round`` at
    ``_assert_trees_match``'s tolerances (2e-5; 5e-3 on the BatchNorm-fed
    conv biases)."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.fed.algorithms import fedavg
    from fedcrack_tpu.train.local import create_train_state, train_step

    inp = two_process_run["inputs"]
    variables = two_process_run["variables"]
    trained, weights = [], []
    for c in range(4):
        state = create_train_state(jax.random.key(0), ModelConfig(**TINY_KW), 1e-3).replace_variables(variables)
        for s in range(STEPS):
            batch = (jnp.asarray(inp["images"][c, s]), jnp.asarray(inp["masks"][c, s]))
            state, _ = train_step(state, batch, variables["params"], jnp.float32(0.0), jnp.float32(1.0))
        if ACTIVE[c]:
            trained.append(state.variables)
            weights.append(N_SAMPLES[c])
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, fedavg(trained, weights))))
    got = _tree_of(two_process_run["ranks"][0], "null/0/")
    assert set(got) == set(want)
    for key, w in want.items():
        shadowed = key.endswith("/bias") and any(s in key for s in ("stem_conv", "_sep", "_convT"))
        np.testing.assert_allclose(got[key], w, atol=5e-3 if shadowed else 2e-5, err_msg=key)


def test_two_process_resident_round_bit_equal(two_process_run):
    """The resident round across processes, each rank's pools and a plan
    that gathers the streamed slabs, gives the streamed round's first
    global bit for bit (the one-process contract, across processes)."""
    want = _one_process_rounds(two_process_run, "null")[0][0]
    for rank in two_process_run["ranks"]:
        got = _tree_of(rank, "resident/")
        for key in want:
            assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("placement", ["streamed", "resident"])
def test_two_process_cohort_round_bit_equal(two_process_run, placement):
    """``build_federated_cohort_round`` on the ``(4, 2)`` mesh over two
    processes: six clients in groups of four (the last ragged, its two
    padding slots on rank 1), two epochs in two segments. Every rank's
    global and ``[6]`` metrics are the one-process cohort round's bits,
    which are the monolithic round's over the six."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round, build_federated_round, make_mesh

    inp = two_process_run["inputs"]
    cr = build_federated_cohort_round(make_mesh(4, 2, device="cpu"), ModelConfig(**TINY_KW), learning_rate=1e-3,
                                      local_epochs=2, segments=2)
    assert cr.n_groups(6) == 2 and cr.block == slice(0, 4)
    args = (inp["cohort_images"], inp["cohort_masks"], COHORT_ACTIVE, COHORT_N)
    want, want_m = cr(two_process_run["variables"], *args)
    mono, mono_m = build_federated_round(make_mesh(6, 2, device="cpu"), ModelConfig(**TINY_KW), learning_rate=1e-3,
                                         local_epochs=2)(two_process_run["variables"], *args)
    for key, w in _flat(want):
        assert dict(_flat(mono))[key].tobytes() == w.tobytes(), key
    for rank in two_process_run["ranks"]:
        got = _tree_of(rank, f"cohort_{placement}/")
        assert set(got) == {k for k, _ in _flat(want)}
        for key, w in _flat(want):
            assert got[key].tobytes() == w.tobytes(), (placement, key)
        for k, v in want_m.items():
            assert v.shape == (6,) and mono_m[k].numpy().tobytes() == v.numpy().tobytes(), k
            assert rank[f"cohort_{placement}/metrics/{k}"].tobytes() == v.numpy().tobytes(), (placement, k)


def test_two_process_segmented_round_bit_equal(two_process_run):
    """The segmented round (2 epochs in 2 segments) across processes
    against the same round in one process."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_federated_round_segments, make_mesh

    inp = two_process_run["inputs"]
    seg = build_federated_round_segments(make_mesh(4, 2, device="cpu"), ModelConfig(**TINY_KW), learning_rate=1e-3,
                                         local_epochs=2, segments=2)
    want, _ = seg(two_process_run["variables"], inp["images"], inp["masks"], ACTIVE, N_SAMPLES)
    for rank in two_process_run["ranks"]:
        got = _tree_of(rank, "segmented/")
        for key, w in _flat(want):
            assert got[key].tobytes() == w.tobytes(), key


def test_two_process_spatial_round_bit_equal(two_process_run):
    """``build_spatial_federated_round`` on a ``(clients, space)`` mesh of
    (2, 2) whose clients span the processes: the global bit-equal on both
    ranks and to the same round in one process."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_spatial_federated_round, make_mesh

    inp = two_process_run["inputs"]
    sr = build_spatial_federated_round(make_mesh(2, 2, device="cpu", axis_names=("clients", "space")),
                                       ModelConfig(**SPATIAL_ROUND_KW), learning_rate=1e-3, local_epochs=1)
    want, _ = sr(two_process_run["sr_vars"], inp["sr_images"], inp["sr_masks"], np.ones(2, np.float32),
                 np.array([4.0, 8.0], np.float32))
    for rank in two_process_run["ranks"]:
        got = _tree_of(rank, "spatial_round/")
        for key, w in _flat(want):
            assert got[key].tobytes() == w.tobytes(), key


def test_two_process_halo_rows_and_cotangents(two_process_run):
    """Each rank's two bands of two distinct images get the rows the
    one-process halo gives them, the rank boundary's from the other rank,
    and their gradients are the one-process gradient's rows, bit for bit
    (integer cotangents keep every sum exact)."""
    from fedcrack_tpu_torch.parallel.spatial import fold_shards, halo_exchange

    inp = two_process_run["inputs"]
    x = torch.from_numpy(inp["halo_x"].copy()).requires_grad_(True)
    want = halo_exchange(fold_shards(x, SHARDS), SHARDS, up=1, down=1, fill=-1.5)
    g = torch.from_numpy(inp["halo_g"])
    # The fold is shard-major: rank r's bands 2r, 2r+1 are fold rows 4r..4r+3.
    want.backward(g)
    for rank, out in enumerate(two_process_run["ranks"]):
        rows = slice(4 * rank, 4 * rank + 4)
        assert out["halo/out"].tobytes() == want.detach().numpy()[rows].tobytes(), rank
        assert out["halo/grad"].tobytes() == x.grad.numpy()[:, 4 * rank:4 * rank + 4].tobytes(), rank
    # The boundary itself: rank 1's first band starts with image 1's row 3.
    assert (two_process_run["ranks"][1]["halo/out"][1, :, 0] == inp["halo_x"][1, 3].T).all()


def test_two_process_spatial_predict(two_process_run):
    """Each rank's rows of the probabilities against the one-process S = 4
    predict, at rtol/atol 1e-5."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_spatial_predict, make_spatial_mesh

    inp = two_process_run["inputs"]
    want = build_spatial_predict(make_spatial_mesh(SHARDS, device="cpu"), ModelConfig(**SPATIAL_KW))(
        two_process_run["s_vars"], inp["s_images"]).numpy()
    got = np.concatenate([r["spatial/probs"] for r in two_process_run["ranks"]], axis=1)
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_two_process_spatial_step(two_process_run):
    """One SGD(1.0) step across processes against the one-process S = 4
    step: per leaf ||d|| <= 5e-3 ||ref|| + 1e-5 on the gradients, the
    running statistics within rtol 1e-4 / atol 1e-6, the loss within rtol
    1e-5; the new weights and statistics bit-equal on both ranks."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.parallel import build_spatial_train_step, make_spatial_mesh

    inp = two_process_run["inputs"]
    step = build_spatial_train_step(make_spatial_mesh(SHARDS, device="cpu"), ModelConfig(**SPATIAL_KW),
                                    optimizer=lambda p, lr: torch.optim.SGD(p, lr=1.0))
    state = step.init(two_process_run["s_vars"])
    state, metrics = step(state, torch.from_numpy(inp["s_images"]), torch.from_numpy(inp["s_masks"]))
    want = dict(_flat(state.variables))
    start = dict(_flat(two_process_run["s_vars"]))
    r0, r1 = two_process_run["ranks"]
    got, other = _tree_of(r0, "spatial/step/"), _tree_of(r1, "spatial/step/")
    for key in want:
        assert got[key].tobytes() == other[key].tobytes(), key
        if key.startswith("params/"):
            g = start[key].astype(np.float64) - got[key].astype(np.float64)
            ref = start[key].astype(np.float64) - want[key].astype(np.float64)
            assert np.linalg.norm(g - ref) <= 5e-3 * np.linalg.norm(ref) + 1e-5, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(r0["spatial/metrics/loss"]), float(metrics["loss"]), rtol=1e-5, atol=1e-6)
    for k in ("iou_inter", "iou_union"):
        assert float(r0[f"spatial/metrics/{k}"]) == float(metrics[k]), k
    assert int(r0["spatial/exchange_calls"]) > 0


_LONELY = r"""
import sys, time
sys.path.insert(0, {root!r})
from fedcrack_tpu_torch.parallel.multihost import initialize_if_needed
t0 = time.monotonic()
try:
    initialize_if_needed("file://" + sys.argv[1], 2, 0, timeout_s=2.0)
except RuntimeError as e:
    print(f"RAISED after {{time.monotonic() - t0:.1f}} s: {{type(e).__name__}}", flush=True)
    sys.exit(0)
print("JOINED", flush=True)
sys.exit(1)
"""


def test_peer_that_never_joins_raises_within_timeout(tmp_path):
    """Rank 0 of 2 alone: the bring-up raises after its 2 s timeout
    instead of waiting forever."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _LONELY.format(root=ROOT), str(tmp_path / "store")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "RAISED" in out, out
    assert float(out.split("after ")[1].split(" s")[0]) < 30.0, out
