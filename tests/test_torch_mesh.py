"""The port's slot plane (``fedcrack_tpu_torch.parallel.fedavg_mesh``,
``compress.mesh``, the per-step DP transform, the fake-quant twin) held
against the JAX package on the CPU.

The JAX mesh round itself cannot be the reference here: the installed JAX
fails its own mesh tests (a scan-vma ``TypeError`` inside ``shard_map``).
The JAX mesh tests hold their round against the host path instead
(``tests/test_parallel.py::_host_round``: per-client jitted
``train.local.train_step`` plus ``fed.algorithms.fedavg``), which runs on
the CPU, so the port's round is held against that host path with
``tests/test_parallel.py::_assert_trees_match``'s tolerances (2e-5, and
5e-3 on the conv biases a BatchNorm cancels, whose true gradient is 0 and
whose Adam step is rounding noise at full learning-rate size). Inside the
port, every bit-identity contract the JAX package pins holds bit for bit:
segmented, chunked, resident and grouped rounds against the monolithic
round, ragged padding, and the null builds of the codec, lowp and DP
twins. The int8 and DP noise is held by its statistics and its replay.
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny steps: one intra-op thread each keeps a
    worker of a parallel test run from contending with the others for
    every core (the results are compared at the same setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TINY_KW = dict(img_size=16, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
STEPS, BATCH = 2, 4
LR = 1e-3


def _cfg():
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**TINY_KW)


def _mesh(c):
    from fedcrack_tpu_torch.parallel import make_mesh

    return make_mesh(c, 1, device="cpu")


def _client_data(n_clients, seed0=0):
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu.parallel import stack_client_data

    per_client = [synth_crack_batch(STEPS * BATCH, img_size=16, seed=seed0 + i) for i in range(n_clients)]
    return stack_client_data(per_client, STEPS, BATCH)


def _jax_variables(seed):
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.train.local import create_train_state

    v = create_train_state(jax.random.key(seed), ModelConfig(**TINY_KW)).variables
    return jax.tree_util.tree_map(np.asarray, v)


_JAX_TEMPLATE = {}


def _jax_host_round(variables, images, masks, active, n_samples, epochs=1, pos_weight=1.0, mu=0.0, kw=None):
    """``tests/test_parallel.py::_host_round``: sequential jitted steps and
    the host fedavg (with the FedProx mu passed to each step). Each client
    starts, as there, from a fresh state: the global weights, Adam's zero
    moments and step 0; the states share one template's optimizer and
    apply function, so ``train_step`` compiles once, not per client."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.fed.algorithms import fedavg
    from fedcrack_tpu.train.local import create_train_state, train_step

    kw = kw or TINY_KW
    key = repr(sorted(kw.items()))
    if key not in _JAX_TEMPLATE:
        _JAX_TEMPLATE[key] = create_train_state(jax.random.key(0), ModelConfig(**kw), LR)
    tmpl = _JAX_TEMPLATE[key]
    trained, weights = [], []
    for c in range(images.shape[0]):
        state = tmpl.replace(step=jnp.zeros((), jnp.int32), opt_state=tmpl.tx.init(variables["params"]))
        state = state.replace_variables(variables)
        for _ in range(epochs):
            for s in range(images.shape[1]):
                batch = (jnp.asarray(images[c, s]), jnp.asarray(masks[c, s]))
                state, _ = train_step(state, batch, variables["params"], jnp.float32(mu), jnp.float32(pos_weight))
        if active[c]:
            trained.append(state.variables)
            weights.append(n_samples[c])
    return jax.tree_util.tree_map(np.asarray, fedavg(trained, weights))


def _flat(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], path + (k,))
        else:
            v = tree[k]
            yield path + (k,), (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))


def _assert_trees_match(got, want, atol=2e-5):
    """``tests/test_parallel.py::_assert_trees_match``: tight, except the
    biases of ``stem_conv``, the separable convs and the decoder convs,
    which feed a BatchNorm."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for path in w:
        key = "/".join(path)
        shadowed = path[-1] == "bias" and any(s in key for s in ("stem_conv", "_sep", "_convT"))
        np.testing.assert_allclose(g[path], w[path], atol=5e-3 if shadowed else atol, err_msg=key)


def _assert_bytes_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for path in w:
        assert g[path].tobytes() == w[path].tobytes(), "/".join(path)


def _metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].detach().cpu().numpy().tobytes() == want[k].detach().cpu().numpy().tobytes(), k


# ---- the round against the JAX host path ----

HOST_CASES = {
    "full_cohort": dict(active=[1, 1, 1, 1], n=[8, 8, 16, 16]),
    "masked_cohort": dict(active=[1, 0, 1, 1], n=[8, 8, 8, 8]),
    "fedprox": dict(active=[1, 1, 1, 1], n=[8, 8, 8, 8], mu=10.0),
    "pos_weight": dict(active=[1, 1, 1, 1], n=[8, 8, 8, 8], pos_weight=5.0),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_round_matches_jax_host_round(case):
    """The port's round on the CPU against the JAX host path: full cohort,
    a masked cohort (dropped clients out of the average, the divisor
    shrunk), FedProx and pos_weight."""
    from fedcrack_tpu_torch.parallel import build_federated_round

    kw = HOST_CASES[case]
    images, masks = _client_data(4)
    variables = _jax_variables(7)
    active = np.asarray(kw["active"], np.float32)
    n_samples = np.asarray(kw["n"], np.float32)
    round_fn = build_federated_round(_mesh(4), _cfg(), learning_rate=LR, fedprox_mu=kw.get("mu", 0.0),
                                     pos_weight=kw.get("pos_weight", 1.0))
    got, metrics = round_fn(variables, images, masks, active, n_samples)
    want = _jax_host_round(variables, images, masks, active, n_samples, pos_weight=kw.get("pos_weight", 1.0),
                           mu=kw.get("mu", 0.0))
    _assert_trees_match(got, want)
    assert metrics["loss"].shape == (4,)
    assert torch.isfinite(metrics["loss"]).all()
    assert metrics["active"].tolist() == active.tolist()


def test_fedprox_and_pos_weight_change_the_result():
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(2)
    variables = _jax_variables(5)
    ones, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    plain = build_federated_round(_mesh(2), _cfg())(variables, images, masks, ones, ns)[0]
    for kw in (dict(fedprox_mu=10.0), dict(pos_weight=5.0)):
        other = build_federated_round(_mesh(2), _cfg(), **kw)(variables, images, masks, ones, ns)[0]
        diffs = [np.abs(a - b).max() for (_, a), (_, b) in zip(_flat(plain["params"]), _flat(other["params"]))]
        assert max(diffs) > 1e-7, kw


def test_all_dropped_cohort_raises_and_in_round_guard(monkeypatch):
    """An all-dropped cohort raises where the mask is on the host; with
    the host check out of the way, the in-round guard returns the incoming
    global unchanged, never an all-zero average."""
    import fedcrack_tpu_torch.parallel.fedavg_mesh as fm
    from fedcrack_tpu_torch.parallel import build_federated_round, mesh_fedavg

    images, masks = _client_data(2)
    variables = _jax_variables(2)
    round_fn = build_federated_round(_mesh(2), _cfg())
    zeros, ns = np.zeros(2, np.float32), np.full(2, 8.0, np.float32)
    with pytest.raises(ValueError, match="non-positive"):
        round_fn(variables, images, masks, zeros, ns)
    with pytest.raises(ValueError, match="non-positive"):
        mesh_fedavg({"k": np.ones((3, 2), np.float32)}, active=[0.0, 0.0, 0.0])
    monkeypatch.setattr(fm, "_host_view", lambda x: None)
    new_vars, _ = round_fn(variables, images, masks, zeros, ns)
    _assert_bytes_equal(new_vars, variables)


def test_remat_round_matches_plain():
    """Recomputation changes the memory schedule, not the math."""
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(2)
    variables = _jax_variables(9)
    ones, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    v_plain, m_plain = build_federated_round(_mesh(2), _cfg())(variables, images, masks, ones, ns)
    v_remat, m_remat = build_federated_round(_mesh(2), _cfg(), remat=True)(variables, images, masks, ones, ns)
    np.testing.assert_allclose(m_plain["loss"].numpy(), m_remat["loss"].numpy(), rtol=1e-6)
    _assert_trees_match(v_remat, v_plain)


def test_non_positive_mesh_axes_raise():
    from fedcrack_tpu_torch.parallel import build_federated_round, build_spatial_federated_round, make_mesh

    for shape in ((0, 1), (2, 0), (-1, 2)):
        with pytest.raises(ValueError, match="positive"):
            make_mesh(*shape, device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        make_mesh(2, 2, device="cpu", axis_names=("clients", "clients"))
    # Each builder names the axes it needs, as the JAX package's does.
    with pytest.raises(ValueError, match="missing"):
        build_spatial_federated_round(_mesh(2), _cfg())
    with pytest.raises(ValueError, match="missing"):
        build_federated_round(make_mesh(2, 2, device="cpu", axis_names=("clients", "space")), _cfg())


# ---- the batch axis (tests/test_parallel.py:140-158) ----


def _mesh2(c, inner, axis="batch"):
    from fedcrack_tpu_torch.parallel import make_mesh

    return make_mesh(c, inner, device="cpu", axis_names=("clients", axis))


def test_batch_axis_round_matches_jax_and_the_unsplit_round():
    """4 clients x a 2-way batch axis, 2 local epochs, as
    ``test_intra_client_batch_dp_matches_host``: the JAX host path within
    its atol 5e-5 (the JAX ``(4, 2)`` round itself fails on this
    container's JAX, module docstring, and that test holds it to the same
    host path), and the port's ``(4, 1)`` round bit for bit (on one card
    the two halves folded in order are the batch)."""
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(4)
    variables = _jax_variables(1)
    active, ns = np.ones(4, np.float32), np.full(4, 8.0, np.float32)
    mesh = _mesh2(4, 2)
    assert mesh.shape == {"clients": 4, "batch": 2}
    got, metrics = build_federated_round(mesh, _cfg(), learning_rate=LR, local_epochs=2)(
        variables, images, masks, active, ns)
    unsplit, m1 = build_federated_round(_mesh(4), _cfg(), learning_rate=LR, local_epochs=2)(
        variables, images, masks, active, ns)
    _assert_bytes_equal(got, unsplit)
    _metrics_equal(metrics, m1)
    _assert_trees_match(got, _jax_host_round(variables, images, masks, active, ns, epochs=2), atol=5e-5)
    assert metrics["loss"].shape == (4,)


@pytest.mark.parametrize("form", ["monolithic", "segmented", "cohort", "resident"])
def test_step_batch_must_divide_the_batch_axis(form):
    """A per-step batch of 4 over a 3-way batch axis is refused before any
    step runs, in every round form."""
    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round,
        build_federated_round_segments,
    )

    variables = _jax_variables(0)
    act, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    mesh = _mesh2(2, 3)
    if form == "resident":
        pool, idx = _pool_and_plan(2, 1)
        rf = build_federated_round(mesh, _cfg(), data_placement="resident")
        with pytest.raises(ValueError, match="does not divide"):
            rf(variables, (pool.images, pool.masks), idx, act, ns)
        return
    images, masks = _client_data(2)
    rf = {"monolithic": lambda: build_federated_round(mesh, _cfg()),
          "segmented": lambda: build_federated_round_segments(mesh, _cfg()),
          "cohort": lambda: build_federated_cohort_round(mesh, _cfg())}[form]()
    with pytest.raises(ValueError, match="does not divide"):
        rf(variables, images, masks, act, ns)


BATCH_AXIS_FORMS = {
    "segmented": dict(segments=2),
    "cohort": dict(cohort=True),
    "fedprox": dict(fedprox_mu=10.0),
    "remat": dict(remat=True),
    "dp": dict(dp_clip_norm=1.0, dp_noise_multiplier=1.1, dp_seed=3),
    "int8": dict(update_codec="int8"),
}


def _batch_form(form, mesh):
    from fedcrack_tpu_torch.parallel import (
        build_federated_cohort_round,
        build_federated_round,
        build_federated_round_segments,
    )

    kw = dict(BATCH_AXIS_FORMS[form])
    if kw.pop("cohort", False):
        return build_federated_cohort_round(mesh, _cfg(), local_epochs=2, **kw)
    if "segments" in kw:
        return build_federated_round_segments(mesh, _cfg(), local_epochs=2, **kw)
    return build_federated_round(mesh, _cfg(), local_epochs=2, **kw)


@pytest.mark.parametrize("form", sorted(BATCH_AXIS_FORMS))
def test_batch_axis_in_every_round_form_equals_the_unsplit_round(form):
    """The ``(C, 2)`` round equals the ``(C, 1)`` round bit for bit in the
    segmented and cohort forms and under FedProx, remat, DP-SGD and a
    codec. (The JAX package's segmented and cohort rounds fail on this
    container's JAX, so the port is held against its own ``(C, 1)`` form,
    which the host-round tests hold against JAX.)"""
    images, masks = _client_data(2)
    variables = _jax_variables(4)
    act, ns = np.ones(2, np.float32), np.array([8.0, 16.0], np.float32)
    got = _batch_form(form, _mesh2(2, 2))(variables, images, masks, act, ns)
    want = _batch_form(form, _mesh(2))(variables, images, masks, act, ns)
    _assert_bytes_equal(got[0], want[0])
    _metrics_equal(got[1], want[1])


def test_batch_axis_resident_round_equals_the_unsplit_round():
    from fedcrack_tpu_torch.parallel import build_federated_round

    pool, idx = _pool_and_plan(2, 2)
    variables = _jax_variables(0)
    act, ns = np.ones(2, np.float32), np.array([8.0, 16.0], np.float32)
    got = build_federated_round(_mesh2(2, 4), _cfg(), local_epochs=2, data_placement="resident")(
        variables, (pool.images, pool.masks), idx, act, ns)
    want = build_federated_round(_mesh(2), _cfg(), local_epochs=2, data_placement="resident")(
        variables, (pool.images, pool.masks), idx, act, ns)
    _assert_bytes_equal(got[0], want[0])
    _metrics_equal(got[1], want[1])


# ---- the spatial round (tests/test_parallel.py:273-303, :370-381, :420-475) ----

TINY32_KW = dict(img_size=32, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))


def _cfg32():
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**TINY32_KW)


@pytest.fixture(scope="module")
def spatial_setup():
    import jax

    from fedcrack_tpu.configs import ModelConfig
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu.parallel import stack_client_data
    from fedcrack_tpu.train.local import create_train_state

    per_client = [synth_crack_batch(STEPS * BATCH, img_size=32, seed=i) for i in range(4)]
    images, masks = stack_client_data(per_client, STEPS, BATCH)
    variables = jax.tree_util.tree_map(np.asarray,
                                       create_train_state(jax.random.key(2), ModelConfig(**TINY32_KW)).variables)
    return images, masks, variables, np.ones(4, np.float32), np.full(4, 8.0, np.float32)


def test_spatial_round_matches_jax_and_the_unsplit_round(spatial_setup):
    """4 clients x 2 bands of height, 2 local epochs: the JAX host path
    ``TestSpatialFederatedRound`` holds JAX's spatial round to (that round
    itself fails on this container's JAX, module docstring), and the
    port's ``(4, 1)`` round on the same data, each within that test's atol
    1e-4 (the BN-fed biases 5e-3)."""
    from fedcrack_tpu_torch.parallel import build_federated_round, build_spatial_federated_round

    images, masks, variables, active, ns = spatial_setup
    got, metrics = build_spatial_federated_round(_mesh2(4, 2, "space"), _cfg32(), learning_rate=LR, local_epochs=2)(
        variables, images, masks, active, ns)
    unsplit, _ = build_federated_round(_mesh(4), _cfg32(), learning_rate=LR, local_epochs=2)(
        variables, images, masks, active, ns)
    _assert_trees_match(got, unsplit, atol=1e-4)
    want = _jax_host_round(variables, images, masks, active, ns, epochs=2, kw=TINY32_KW)
    _assert_trees_match(got, want, atol=1e-4)
    assert metrics["loss"].shape == (4,) and torch.isfinite(metrics["loss"]).all()


def test_remat_spatial_round_matches_plain(spatial_setup):
    from fedcrack_tpu_torch.parallel import build_spatial_federated_round

    images, masks, variables, active, ns = spatial_setup
    mesh = _mesh2(4, 2, "space")
    v_plain, m_plain = build_spatial_federated_round(mesh, _cfg32())(variables, images, masks, active, ns)
    v_remat, m_remat = build_spatial_federated_round(mesh, _cfg32(), remat=True)(variables, images, masks, active, ns)
    np.testing.assert_allclose(m_plain["loss"].numpy(), m_remat["loss"].numpy(), rtol=1e-6)
    _assert_trees_match(v_remat, v_plain)


def test_spatial_round_rejects_transformed_layouts():
    import dataclasses

    from fedcrack_tpu_torch.parallel import build_spatial_federated_round

    with pytest.raises(ValueError, match="reference layout"):
        build_spatial_federated_round(_mesh2(4, 2, "space"), dataclasses.replace(_cfg(), stem_layout="s2d"))


def test_spatial_round_rejects_misaligned_height():
    from fedcrack_tpu_torch.parallel import build_spatial_federated_round

    round_fn = build_spatial_federated_round(_mesh2(2, 4, "space"), _cfg())  # needs H % 64 == 0
    images, masks = _client_data(2)  # H = 16
    with pytest.raises(ValueError, match="multiple of 16"):
        round_fn(_jax_variables(0), images, masks, np.ones(2, np.float32), np.full(2, 8.0, np.float32))


# ---- mesh_fedavg and stack_client_data (tests/test_parallel.py:382-418) ----


def test_mesh_fedavg_matches_numpy_mean():
    from fedcrack_tpu_torch.parallel import mesh_fedavg

    rng = np.random.default_rng(0)
    stacked = {"a": rng.normal(size=(4, 3, 2)).astype(np.float32), "b": {"c": rng.normal(size=(4, 5)).astype(np.float32)}}
    got = mesh_fedavg(stacked)
    np.testing.assert_allclose(got["a"].numpy(), stacked["a"].mean(0), rtol=1e-6)
    np.testing.assert_allclose(got["b"]["c"].numpy(), stacked["b"]["c"].mean(0), rtol=1e-6)


def test_mesh_fedavg_matches_jax_and_host_fedavg_weighted():
    from fedcrack_tpu.fed.algorithms import fedavg as jax_fedavg
    from fedcrack_tpu.parallel import mesh_fedavg as jax_mesh_fedavg
    from fedcrack_tpu_torch.parallel import mesh_fedavg

    rng = np.random.default_rng(1)
    trees = [{"w": rng.normal(size=(3, 2)).astype(np.float32)} for _ in range(3)]
    stacked = {"w": np.stack([t["w"] for t in trees])}
    w = [1.0, 2.0, 5.0]
    got = mesh_fedavg(stacked, weights=w)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(jax_fedavg(trees, w)["w"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(jax_mesh_fedavg(stacked, weights=w)["w"]),
                               rtol=1e-6, atol=1e-7)


def test_mesh_fedavg_active_mask():
    from fedcrack_tpu_torch.parallel import mesh_fedavg

    stacked = {"w": np.stack([np.full((2,), v, np.float32) for v in (1.0, 100.0, 3.0)])}
    got = mesh_fedavg(stacked, active=[1.0, 0.0, 1.0])
    np.testing.assert_allclose(got["w"].numpy(), [2.0, 2.0])


def test_stack_client_data_byte_equal_to_jax():
    from fedcrack_tpu.parallel import stack_client_data as jax_stack
    from fedcrack_tpu_torch.parallel import stack_client_data

    rng = np.random.default_rng(3)
    per = [(rng.integers(0, 255, (n, 4, 4, 3), dtype=np.uint8), rng.integers(0, 2, (n, 4, 4, 1), dtype=np.uint8))
           for n in (3, 8, 11)]
    got, want = stack_client_data(per, 2, 4), jax_stack(per, 2, 4)
    assert got[0].shape == (3, 2, 4, 4, 4, 3)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    with pytest.raises(ValueError, match="zero samples"):
        stack_client_data([(per[0][0][:0], per[0][1][:0])], 1, 1)


# ---- the ordered fold ----


def test_ordered_fold_stacked_equals_slot_by_slot_and_pads_clean():
    """One expression tree however the fold is split: stacked, one slot at
    a time, or in groups continuing the carry; a zero-weight pad adds
    nothing, bit for bit."""
    from fedcrack_tpu_torch.fed.aggregation import mesh_finish_cohort_mean, mesh_ordered_fold, mesh_zero_sums

    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.normal(size=(4, 7, 3)).astype(np.float32))
    w = torch.tensor([8.0, 0.0, 16.0, 24.0])
    tree = {"a": xs}
    whole = mesh_ordered_fold(tree, w, mesh_zero_sums({"a": xs[0]}))
    carry = mesh_zero_sums({"a": xs[0]})
    for i in range(4):
        carry = mesh_ordered_fold({"a": xs[i]}, w[i], carry)
    padded = mesh_ordered_fold({"a": torch.cat([xs, torch.zeros(1, 7, 3)])}, torch.cat([w, torch.zeros(1)]),
                               mesh_zero_sums({"a": xs[0]}))
    for other in (carry, padded):
        assert torch.equal(other[0]["a"], whole[0]["a"]) and torch.equal(other[1], whole[1])
    mean = mesh_finish_cohort_mean(whole[0], whole[1], {"a": xs[0]})["a"]
    want = ((((0 + 8.0 * xs[0]) + 0.0 * xs[1]) + 16.0 * xs[2]) + 24.0 * xs[3]) / 48.0
    assert torch.equal(mean, want)
    guard = mesh_finish_cohort_mean(whole[0], torch.zeros(()), {"a": xs[1]})["a"]
    assert torch.equal(guard, xs[1])


# ---- the codec twins (tests/test_compress.py:963, :1006) ----


def test_int8_twin_scales_bounds_and_replay():
    """int8's parity is distributional: the scales are JAX's (within 2
    ulp: a float32 sum of squares, each reduction in its own order) and
    the host codec's, every code within [-127, 127], every value within
    one scale of its input, zero stays zero, the mean error is near zero
    over many draws, and one seed gives the same bits twice."""
    import jax
    import jax.numpy as jnp

    from fedcrack_tpu.compress.mesh import int8_roundtrip as jax_int8
    from fedcrack_tpu_torch.compress.codecs import qsgd_scales
    from fedcrack_tpu_torch.compress.mesh import int8_bucket_scales, int8_roundtrip

    rng = np.random.default_rng(3)
    x = (0.01 * rng.standard_t(3, size=(257,))).astype(np.float32)
    bucket = 64
    segs = torch.nn.functional.pad(torch.from_numpy(x), (0, 5 * bucket - x.size)).reshape(5, bucket)
    scales = int8_bucket_scales(segs).numpy()
    np.testing.assert_array_max_ulp(scales, qsgd_scales(x, bucket), maxulp=2)
    per_entry = np.repeat(scales, bucket)[: x.size]
    jax_got = np.asarray(jax_int8({"x": jnp.asarray(x)}, jax.random.PRNGKey(0), bucket=bucket)["x"])
    assert np.all(np.abs(jax_got - x) <= per_entry * (1 + 1e-6) + 1e-12)
    got = int8_roundtrip({"x": torch.from_numpy(x)}, (0, 1), bucket=bucket)["x"].numpy()
    assert np.all(np.abs(got - x) <= per_entry * (1 + 1e-6) + 1e-12)
    codes = np.round(got / per_entry)
    assert np.all(np.abs(codes) <= 127) and np.allclose(codes * per_entry, got, rtol=1e-6, atol=1e-12)
    again = int8_roundtrip({"x": torch.from_numpy(x)}, (0, 1), bucket=bucket)["x"].numpy()
    assert again.tobytes() == got.tobytes()
    other = int8_roundtrip({"x": torch.from_numpy(x)}, (0, 2), bucket=bucket)["x"].numpy()
    assert other.tobytes() != got.tobytes()
    assert not int8_roundtrip({"x": torch.zeros(16)}, (1,), bucket=8)["x"].any()
    # Unbiased: over 400 draws the mean error per entry is within 4 sigma
    # of 0, sigma = scale / (2 sqrt(400)) (a rounding error is bounded by
    # one scale, so its standard deviation is at most scale / 2).
    draws = np.stack([int8_roundtrip({"x": torch.from_numpy(x)}, (7, d), bucket=bucket)["x"].numpy()
                      for d in range(400)])
    err = draws.mean(0) - x
    assert np.all(np.abs(err) <= 4 * per_entry / (2 * math.sqrt(400)) + 1e-9)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_twin_keep_set_equals_host_codec_and_jax(ties):
    """The keep set is the host codec's stable argsort and ``lax.top_k``'s,
    ties to the lowest index; the residual is the rest."""
    import jax.numpy as jnp

    from fedcrack_tpu.compress.mesh import topk_roundtrip as jax_topk
    from fedcrack_tpu.compress.mesh import zero_residual_like as jax_zero
    from fedcrack_tpu_torch.compress.codecs import leaf_k, topk_select
    from fedcrack_tpu_torch.compress.mesh import topk_roundtrip, zero_residual_like

    rng = np.random.default_rng(3)
    x = (0.01 * rng.standard_t(3, size=(257,))).astype(np.float32)
    if ties:
        x = np.round(x * 200).astype(np.float32) / 200  # many equal magnitudes
        x[::7] = -x[::7]
    k = leaf_k(x.size, 0.05)
    want = np.zeros_like(x)
    idx = topk_select(x, k)
    want[idx] = x[idx]
    tree = {"x": torch.from_numpy(x)}
    kept, res = topk_roundtrip(tree, zero_residual_like(tree), 0.05)
    assert kept["x"].numpy().tobytes() == want.tobytes()
    eff = x + np.zeros_like(x)  # delta + the zero residual: -0.0 becomes +0.0
    assert res["x"].numpy().tobytes() == (eff - want).tobytes()
    jt = {"x": jnp.asarray(x)}
    jkept, _ = jax_topk(jt, jax_zero(jt), 0.05)
    assert np.asarray(jkept["x"]).tobytes() == want.tobytes()


def test_topk_twin_keep_set_equals_host_codec_on_a_round_delta():
    """The round's top-k twin keeps, per leaf, what the host
    ``TopKDeltaCodec`` sends for the same delta."""
    from fedcrack_tpu_torch.compress.codecs import TopKDeltaCodec, leaf_k, topk_select
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(1)
    variables = _jax_variables(1)
    slots = {}
    rf = build_federated_round(_mesh(1), _cfg(), update_codec="topk_delta", topk_fraction=0.05)
    rf.slot_hook = lambda c, v: slots.__setitem__(c, v)
    got, _ = rf(variables, images, masks, np.ones(1, np.float32), np.full(1, 8.0, np.float32))
    trained = {k: slots[0][k] for k in ("params", "batch_stats")}
    for (path, t), (_, b), (_, g) in zip(_flat(trained), _flat(variables), _flat(got)):
        delta = (t.astype(np.float32) - b.astype(np.float32)).ravel()
        keep = topk_select(delta, leaf_k(delta.size, 0.05))
        moved = np.flatnonzero(g.ravel() != b.ravel())
        assert set(moved.tolist()) <= set(keep.tolist()), path
    assert TopKDeltaCodec(0.05).fraction == 0.05
    assert len(tree_leaves(rf.ef_state())) == len(tree_leaves(trained))


def test_codec_twins_trajectory_and_bytes_counter():
    """Null is bit-identical to a codec-free build; int8 and top-k run 3
    rounds with finite weights; top-k keeps per-slot residuals with a
    working reset; bytes_per_round prices the codecs in order."""
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.parallel import build_federated_round, run_mesh_federation, stack_client_data

    per = [synth_crack_batch(STEPS * BATCH, img_size=16, seed=i) for i in range(2)]
    images, masks = stack_client_data(per, STEPS, BATCH)
    active, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    init = _jax_variables(0)
    runs = {}
    for codec in (None, "null", "int8", "topk_delta"):
        rf = build_federated_round(_mesh(2), _cfg(), update_codec=codec, topk_fraction=0.05)
        v, recs = run_mesh_federation(rf, init, lambda r: (images, masks, active, ns) if r == 0 else None, 3,
                                      _mesh(2))
        runs[codec] = (v, recs, rf)
    _assert_bytes_equal(runs["null"][0], runs[None][0])
    for codec in ("int8", "topk_delta"):
        assert all(torch.isfinite(t).all() for t in tree_leaves(runs[codec][0]))
    rf = runs["topk_delta"][2]
    ef = rf.ef_state()
    assert all(t.shape[0] == 2 for t in tree_leaves(ef)) and any(t.abs().sum() > 0 for t in tree_leaves(ef))
    rf.reset_ef()
    assert rf.ef_state() is None and rf.codec_state()["calls"] == 0
    b = {c: runs[c][1][0].bytes_per_round for c in ("null", "int8", "topk_delta")}
    assert b["null"] > b["int8"] > b["topk_delta"] > 0


# ---- the lowp twin ----


def test_fake_quant_forward_equals_quantized_weights_and_passes_gradient():
    """The fake-quant forward value is ``quantize_variables``' dequantized
    weights exactly; the gradient reaches the float32 masters unchanged."""
    from fedcrack_tpu.kernels.dequant import fake_quant_params as jax_fq
    from fedcrack_tpu_torch.kernels.dequant import fake_quant_leaf, fake_quant_params
    from fedcrack_tpu_torch.serve.quant import dequantize_variables, quantize_variables

    variables = _jax_variables(4)
    rng = np.random.default_rng(0)
    params = {k: v for k, v in variables["params"].items()}
    params["head"] = {"kernel": (rng.normal(size=(1, 1, 4, 1)) * 0.3).astype(np.float32),
                      "bias": np.zeros((1,), np.float32)}
    want = dequantize_variables(quantize_variables({"params": params}).tree)["params"]
    got = fake_quant_params({k: _tensor_tree(v) for k, v in params.items()})
    jgot = jax_fq(params)
    for (path, g), (_, w), (_, j) in zip(_flat(got), _flat(want), _flat(jgot)):
        assert g.tobytes() == np.asarray(w, np.float32).tobytes(), path
        assert g.tobytes() == np.asarray(j).tobytes(), path
    w = torch.from_numpy(params["stem_conv"]["kernel"].copy()).requires_grad_()
    torch.sum(fake_quant_leaf(w) ** 2).backward()
    assert torch.equal(w.grad, 2 * fake_quant_leaf(w).detach())
    oihw = w.detach().permute(3, 2, 0, 1)
    assert torch.equal(fake_quant_leaf(oihw, channel_axis=0).permute(2, 3, 1, 0), fake_quant_leaf(w.detach()))


def _tensor_tree(node):
    if isinstance(node, dict):
        return {k: _tensor_tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node))


def test_lowp_twin_validation_trajectory_and_null_build():
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.parallel import build_federated_round

    with pytest.raises(ValueError, match="lowp"):
        build_federated_round(_mesh(1), _cfg(), lowp="int4")
    images, masks = _client_data(2)
    variables = _jax_variables(0)
    ones, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    plain = build_federated_round(_mesh(2), _cfg())
    null = build_federated_round(_mesh(2), _cfg(), lowp="null")
    fq = build_federated_round(_mesh(2), _cfg(), lowp="fake_quant_int8")
    assert null.lowp == "null" and fq.lowp == "fake_quant_int8"
    v_plain, m_plain = plain(variables, images, masks, ones, ns)
    v_null, _ = null(variables, images, masks, ones, ns)
    v_fq, m_fq = fq(variables, images, masks, ones, ns)
    _assert_bytes_equal(v_null, v_plain)
    assert all(torch.isfinite(t).all() for t in tree_leaves(v_fq))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(v_fq), tree_leaves(v_plain)))
    np.testing.assert_allclose(m_fq["loss"].numpy(), m_plain["loss"].numpy(), rtol=0.05)


# ---- the DP-SGD twin ----


def test_dp_clip_matches_jax_within_an_ulp_of_the_factor():
    import jax.numpy as jnp

    from fedcrack_tpu.privacy.dpsgd import clip_by_global_norm as jax_clip
    from fedcrack_tpu_torch.privacy.dpsgd import clip_by_global_norm, global_l2_norm

    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(33, 7)).astype(np.float32), "b": {"c": rng.normal(size=(100,)).astype(np.float32)}}
    for clip in (0.5, 3.0, 1e6):
        got, factor = clip_by_global_norm(_tensor_tree(tree), clip)
        want, jfactor = jax_clip({k: _jnp_tree(v, jnp) for k, v in tree.items()}, clip)
        np.testing.assert_array_max_ulp(np.float32(factor), np.float32(jfactor), maxulp=1)
        for (path, g), (_, w) in zip(_flat(got), _flat(want)):
            np.testing.assert_array_max_ulp(g, np.asarray(w), maxulp=2)
    norm = float(global_l2_norm(_tensor_tree(tree)))
    assert norm == pytest.approx(math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64))) for x in
                                                   (tree["a"], tree["b"]["c"]))), rel=1e-6)


def _jnp_tree(node, jnp):
    if isinstance(node, dict):
        return {k: _jnp_tree(v, jnp) for k, v in node.items()}
    return jnp.asarray(node)


def test_dp_noise_statistics_and_replay():
    """The noise is held by its statistics: per leaf, over n draws, the
    sample mean lies within 5 standard errors (sigma / sqrt(n)) of 0 and
    the sample standard deviation within 5 of its standard errors
    (about sigma / sqrt(2n)) of sigma = noise_multiplier * clip, as JAX's
    ``jax.random.normal`` noise is N(0, sigma^2) by construction. One
    (dp_seed, round, client, step) chain draws the same bits twice; any
    change in the chain draws others."""
    from fedcrack_tpu_torch.privacy.dpsgd import add_gaussian_noise, dp_grad_transform, dp_step_key

    sigma = 1.1 * 0.5
    tree = {"a": torch.zeros(2000), "b": torch.zeros(30, 40)}
    for leaf in ("a", "b"):
        draws = add_gaussian_noise(tree, dp_step_key(42, 0, 1, 2), sigma)[leaf].reshape(-1).double()
        n = draws.numel()
        assert abs(float(draws.mean())) <= 5 * sigma / math.sqrt(n)
        assert abs(float(draws.std()) - sigma) <= 5 * sigma / math.sqrt(2 * n)
    key = dp_step_key(42, 0, 1, 2)
    assert key == dp_step_key(42, 0, 1, 2) and 0 <= key < 2 ** 63
    assert len({dp_step_key(*c) for c in [(42, 0, 1, 2), (43, 0, 1, 2), (42, 1, 1, 2), (42, 0, 0, 2),
                                          (42, 0, 1, 3)]}) == 5
    g = {"a": torch.ones(10) * 3.0}
    one, two = dp_grad_transform(g, key, 1.0, 1.1), dp_grad_transform(g, key, 1.0, 1.1)
    assert torch.equal(one["a"], two["a"])
    clipped_only = dp_grad_transform(g, key, 1.0, 0.0)["a"]
    assert float(torch.linalg.vector_norm(clipped_only)) == pytest.approx(1.0, rel=1e-6)


def test_dp_round_replays_bit_for_bit_and_differs_from_off():
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(2)
    variables = _jax_variables(3)
    ones, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)

    def dp_round():
        return build_federated_round(_mesh(2), _cfg(), dp_clip_norm=1.0, dp_noise_multiplier=1.1, dp_seed=42)

    a, b = dp_round(), dp_round()
    assert a.dp == "dpsgd"
    va, _ = a(variables, images, masks, ones, ns)
    vb, _ = b(variables, images, masks, ones, ns)
    _assert_bytes_equal(va, vb)
    assert a.codec_state()["calls"] == 1
    v_next, _ = a(variables, images, masks, ones, ns)  # the next dispatch's seed
    assert any(x.tobytes() != y.tobytes() for (_, x), (_, y) in zip(_flat(v_next), _flat(va)))
    v_off, _ = build_federated_round(_mesh(2), _cfg())(variables, images, masks, ones, ns)
    assert any(x.tobytes() != y.tobytes() for (_, x), (_, y) in zip(_flat(v_off), _flat(va)))
    with pytest.raises(ValueError, match="dp_clip_norm"):
        build_federated_round(_mesh(1), _cfg(), dp_noise_multiplier=1.0)
    with pytest.raises(ValueError, match="dp_clip_norm"):
        build_federated_round(_mesh(1), _cfg(), dp_clip_norm=-1.0)


def test_null_build_runs_no_twin_code(monkeypatch):
    """With codec, lowp and DP off the round runs none of their code
    (``tests/test_privacy.py:574``'s pin): each twin's entry points raise
    if called, and the round still runs, equal to a knob-free build."""
    import fedcrack_tpu_torch.compress.mesh as cm
    import fedcrack_tpu_torch.kernels.dequant as dq
    import fedcrack_tpu_torch.parallel.fedavg_mesh as fm
    import fedcrack_tpu_torch.privacy.dpsgd as dps
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(1)
    variables = _jax_variables(0)
    ones, ns = np.ones(1, np.float32), np.full(1, 8.0, np.float32)
    want, _ = build_federated_round(_mesh(1), _cfg())(variables, images, masks, ones, ns)

    def boom(*a, **k):
        raise AssertionError("a twin ran in the null build")

    for mod, names in ((cm, ("int8_roundtrip", "topk_roundtrip", "zero_residual_like")),
                       (fm, ("int8_roundtrip", "topk_roundtrip", "zero_residual_like")),
                       (dq, ("fake_quant_leaf", "fake_quant_params")),
                       (dps, ("dp_grad_transform", "dp_step_key", "clip_by_global_norm", "add_gaussian_noise"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    rf = build_federated_round(_mesh(1), _cfg(), update_codec="null", lowp="null", dp_clip_norm=0.0,
                               dp_noise_multiplier=0.0, dp_seed=99)
    assert (rf.update_codec, rf.lowp, rf.dp) == ("null", "null", "null")
    got, _ = rf(variables, images, masks, ones, ns)
    _assert_bytes_equal(got, want)
    assert rf.codec_state() == {"ef": None, "calls": 0}


# ---- segmented, chunked, resident and grouped rounds: bit for bit ----

SEG_EPOCHS = 10


@pytest.fixture(scope="module")
def seg_setup():
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(2)
    data = (images, masks, np.ones(2, np.float32), np.full(2, 8.0, np.float32))
    variables = _jax_variables(0)
    mono = build_federated_round(_mesh(2), _cfg(), local_epochs=SEG_EPOCHS)(variables, *data)
    return data, variables, mono


@pytest.mark.parametrize("segments", [1, 2, 10])
def test_segmented_round_bit_identical(seg_setup, segments):
    from fedcrack_tpu_torch.parallel import SegmentedRound, build_federated_round_segments

    data, variables, (want_v, want_m) = seg_setup
    seg = build_federated_round_segments(_mesh(2), _cfg(), local_epochs=SEG_EPOCHS, segments=segments)
    assert isinstance(seg, SegmentedRound)
    assert (seg.n_segments, seg.segment_epochs) == (segments, SEG_EPOCHS // segments)
    got_v, got_m = seg(variables, *data)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)


def test_segmented_round_chunked_data_bit_identical(seg_setup):
    from fedcrack_tpu_torch.data.pipeline import split_epoch_slab
    from fedcrack_tpu_torch.parallel import build_federated_round_segments

    (images, masks, active, ns), variables, (want_v, want_m) = seg_setup
    ic, mc = split_epoch_slab(images, masks, 2)
    assert len(ic) == 2 and sum(c.shape[1] for c in ic) == STEPS
    seg = build_federated_round_segments(_mesh(2), _cfg(), local_epochs=SEG_EPOCHS, segments=2)
    got_v, got_m = seg(variables, ic, mc, active, ns)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)


def test_segments_must_divide_epochs():
    from fedcrack_tpu_torch.parallel import build_federated_round_segments

    with pytest.raises(ValueError, match="divis"):
        build_federated_round_segments(_mesh(2), _cfg(), local_epochs=10, segments=3)


def _pool_and_plan(c, epochs, seed=0):
    from fedcrack_tpu.data.pipeline import to_uint8_transport
    from fedcrack_tpu.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.data.pipeline import SamplePool

    pool = SamplePool.stack([to_uint8_transport(*synth_crack_batch(STEPS * BATCH + 3, 16, seed=seed + i))
                             for i in range(c)])
    idx = pool.round_indices([np.random.default_rng(7 + i) for i in range(c)], epochs, STEPS, BATCH)
    return pool, idx


def test_resident_round_bit_identical_to_streamed_over_pool_idx():
    """The round gathering from a device pool equals the streamed round
    over the host-assembled ``pool[idx]``; the segmented resident round
    too; a plan outside the pool is refused."""
    from fedcrack_tpu_torch.parallel import build_federated_round, build_federated_round_segments

    pool, idx = _pool_and_plan(2, 2)
    variables = _jax_variables(0)
    act, ns = np.ones(2, np.float32), np.array([8.0, 16.0], np.float32)
    images, masks = pool.assemble_round_slab(idx)
    want_v, want_m = build_federated_round(_mesh(2), _cfg(), local_epochs=2)(variables, images, masks, act, ns)
    resident = build_federated_round(_mesh(2), _cfg(), local_epochs=2, data_placement="resident")
    got_v, got_m = resident(variables, pool.stage(_mesh(2)), idx, act, ns)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)
    seg = build_federated_round_segments(_mesh(2), _cfg(), local_epochs=2, segments=2, data_placement="resident")
    seg_v, seg_m = seg(variables, (pool.images, pool.masks), idx, act, ns)
    _assert_bytes_equal(seg_v, want_v)
    _metrics_equal(seg_m, want_m)
    bad = idx.copy()
    bad[0, 0, 0, 0] = pool.n_samples
    with pytest.raises(ValueError, match="outside"):
        resident(variables, (pool.images, pool.masks), bad, act, ns)
    with pytest.raises(ValueError, match="data_placement"):
        build_federated_round(_mesh(2), _cfg(), data_placement="hbm")


COHORT_C = 4


@pytest.fixture(scope="module")
def cohort_setup():
    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(COHORT_C)
    data = (images, masks, np.ones(COHORT_C, np.float32), np.array([8.0, 16.0, 8.0, 24.0], np.float32))
    variables = _jax_variables(0)
    oracle = build_federated_round(_mesh(COHORT_C), _cfg(), local_epochs=2)(variables, *data)
    return data, variables, oracle


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_grouped_round_bit_identical(cohort_setup, n_groups):
    from fedcrack_tpu_torch.parallel import CohortRound, build_federated_cohort_round

    data, variables, (want_v, want_m) = cohort_setup
    cr = build_federated_cohort_round(_mesh(COHORT_C // n_groups), _cfg(), local_epochs=2, segments=2)
    assert isinstance(cr, CohortRound) and cr.n_groups(COHORT_C) == n_groups
    got_v, got_m = cr(variables, *data)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)


def test_grouped_round_pads_ragged_cohort():
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round, build_federated_round

    images, masks = _client_data(3, seed0=10)
    active, ns = np.ones(3, np.float32), np.array([8.0, 16.0, 24.0], np.float32)
    variables = _jax_variables(0)
    want_v, want_m = build_federated_round(_mesh(3), _cfg(), local_epochs=2)(variables, images, masks, active, ns)
    cr = build_federated_cohort_round(_mesh(2), _cfg(), local_epochs=2, segments=1)
    assert cr.n_groups(3) == 2
    got_v, got_m = cr(variables, images, masks, active, ns)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)
    assert got_m["loss"].shape == (3,)


def test_cohort_round_resident_pool_matches_streamed(cohort_setup):
    from fedcrack_tpu_torch.data.pipeline import SamplePool
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round

    (images, masks, active, ns), variables, _ = cohort_setup
    pool = SamplePool(images.reshape(COHORT_C, STEPS * BATCH, *images.shape[3:]),
                      masks.reshape(COHORT_C, STEPS * BATCH, *masks.shape[3:]))
    idx = np.broadcast_to(np.arange(STEPS * BATCH, dtype=np.int32).reshape(1, 1, STEPS, BATCH),
                          (COHORT_C, 2, STEPS, BATCH))
    streamed = build_federated_cohort_round(_mesh(2), _cfg(), local_epochs=2, segments=1)
    want_v, want_m = streamed(variables, images, masks, active, ns)
    resident = build_federated_cohort_round(_mesh(2), _cfg(), local_epochs=2, segments=1,
                                            data_placement="resident")
    got_v, got_m = resident(variables, (pool.images, pool.masks), idx, active, ns)
    _assert_bytes_equal(got_v, want_v)
    _metrics_equal(got_m, want_m)


def test_round_from_config_drives_the_slot_plane():
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig
    from fedcrack_tpu_torch.parallel import SegmentedRound, round_from_config

    data = DataConfig(img_size=16)
    mesh, rf = round_from_config(FedConfig(model=_cfg(), data=data, mesh_clients=3, local_epochs=2), device="cpu")
    assert mesh.shape == {"clients": 3, "batch": 1} and not isinstance(rf, SegmentedRound)
    mesh, seg = round_from_config(FedConfig(model=_cfg(), data=data, mesh_clients=2, local_epochs=4, segments=2,
                                            data_placement="resident"), device="cpu")
    assert isinstance(seg, SegmentedRound) and seg.n_segments == 2 and seg.data_placement == "resident"
    mesh, rf = round_from_config(FedConfig(model=_cfg(), data=data, mesh_batch=2), device="cpu")
    assert mesh.shape == {"clients": 8, "batch": 2} and not isinstance(rf, SegmentedRound)


def test_round_from_config_runs_c5s_mesh_fields():
    """``configs/c5_bf16_batch_dp.json``'s mesh fields (4 clients x a 2-way
    batch axis, bfloat16 compute) at a tiny width: the round runs, its
    global finite, and equals the ``(4, 1)`` round of the same config bit
    for bit."""
    import dataclasses
    import os

    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.parallel import round_from_config

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                        "c5_bf16_batch_dp.json")
    with open(path, encoding="utf-8") as f:
        c5 = FedConfig.from_json(f.read())
    assert (c5.mesh_clients, c5.mesh_batch, c5.model.compute_dtype) == (4, 2, "bfloat16")
    tiny = dataclasses.replace(c5, model=dataclasses.replace(c5.model, **TINY_KW),
                               data=dataclasses.replace(c5.data, img_size=16, batch_size=BATCH), local_epochs=1)
    mesh, rf = round_from_config(tiny, device="cpu")
    assert mesh.shape == {"clients": 4, "batch": 2}
    images, masks = _client_data(4)
    variables = _jax_variables(0)
    act, ns = np.ones(4, np.float32), np.full(4, 8.0, np.float32)
    got, metrics = rf(variables, images, masks, act, ns)
    assert all(torch.isfinite(t).all() for t in tree_leaves(got)) and torch.isfinite(metrics["loss"]).all()
    _, unsplit = round_from_config(dataclasses.replace(tiny, mesh_batch=1), device="cpu")
    _assert_bytes_equal(got, unsplit(variables, images, masks, act, ns)[0])


# ---- the s2d and packed layouts (configs/c6_s2d_layout.json) ----

LAYOUT_PAIRS = [("s2d", "reference"), ("s2d", "packed"), ("s2d_full", "packed")]


@pytest.mark.parametrize("stem,res", LAYOUT_PAIRS, ids=[f"{a}+{b}" for a, b in LAYOUT_PAIRS])
def test_layout_round_matches_jax_host_round(stem, res):
    """The float32 round with a transformed layout, its images staged
    pre-packed (``space_to_depth_images``), against JAX's ``_host_round``
    of the same layout on the unpacked images, at
    ``tests/test_parallel.py``'s tolerances."""
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.data.pipeline import space_to_depth_images
    from fedcrack_tpu_torch.parallel import build_federated_round

    kw = dict(TINY_KW, stem_layout=stem, res_layout=res)
    images, masks = _client_data(4)
    variables = _jax_variables(0)
    active, ns = np.ones(4, np.float32), np.array([8.0, 8.0, 16.0, 16.0], np.float32)
    rf = build_federated_round(_mesh(4), ModelConfig(**kw), local_epochs=1)
    got, _ = rf(variables, space_to_depth_images(images), masks, active, ns)
    _assert_trees_match(got, _jax_host_round(variables, images, masks, active, ns, kw=kw))


def _c6_tiny():
    """``configs/c6_s2d_layout.json`` (8 slots, bfloat16, ``s2d`` +
    ``packed``) with its model cut to TINY_KW's widths and one local
    epoch."""
    import dataclasses
    import os

    from fedcrack_tpu_torch.configs import FedConfig

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                        "c6_s2d_layout.json")
    with open(path, encoding="utf-8") as f:
        c6 = FedConfig.from_json(f.read())
    return dataclasses.replace(c6, model=dataclasses.replace(c6.model, **TINY_KW),
                               data=dataclasses.replace(c6.data, img_size=16, batch_size=BATCH), local_epochs=1)


@pytest.fixture(scope="module")
def c6_setup():
    from fedcrack_tpu_torch.parallel import round_from_config

    c6 = _c6_tiny()
    mesh, rf = round_from_config(c6, device="cpu")
    assert mesh.shape == {"clients": 8, "batch": 1}
    assert (rf.data_placement, c6.model.stem_layout, c6.model.res_layout) == ("streamed", "s2d", "packed")
    images, masks = _client_data(8, seed0=30)
    active = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    ns = np.array([8, 16, 8, 8, 24, 8, 16, 8], np.float32)
    variables = _jax_variables(0)
    return c6, (images, masks, active, ns), variables, rf(variables, images, masks, active, ns)


C6_FORMS = ["packed_staging", "resident_s2d_pool", "segmented", "cohort_ragged", "reference_layout"]


@pytest.mark.parametrize("form", C6_FORMS)
def test_c6_round_forms_bit_equal(c6_setup, form):
    """c6's round through ``round_from_config`` on unpacked slabs, against
    the same round with the slabs pre-packed, from a resident
    ``SamplePool(layout="s2d")``, segmented, as a cohort in ragged groups
    of 3, and with the reference layouts (bit-equal on oneDNN,
    tests/test_torch_layouts.py): every global and metric the same bits."""
    import dataclasses

    from fedcrack_tpu_torch.data.pipeline import SamplePool, space_to_depth_images
    from fedcrack_tpu_torch.parallel import build_federated_cohort_round, round_from_config

    c6, (images, masks, active, ns), variables, (want_v, want_m) = c6_setup
    if form == "packed_staging":
        got = round_from_config(c6, device="cpu")[1](variables, space_to_depth_images(images), masks, active, ns)
    elif form == "resident_s2d_pool":
        pool = SamplePool(images.reshape(8, STEPS * BATCH, *images.shape[3:]),
                          masks.reshape(8, STEPS * BATCH, *masks.shape[3:]), layout="s2d")
        idx = np.broadcast_to(np.arange(STEPS * BATCH, dtype=np.int32).reshape(1, 1, STEPS, BATCH),
                              (8, 1, STEPS, BATCH))
        _, rf = round_from_config(dataclasses.replace(c6, data_placement="resident"), device="cpu")
        got = rf(variables, pool.stage(_mesh(8)), idx, active, ns)
    elif form == "segmented":
        _, rf = round_from_config(dataclasses.replace(c6, segments=1), device="cpu")
        got = rf(variables, images, masks, active, ns)
    elif form == "cohort_ragged":
        cr = build_federated_cohort_round(_mesh(3), c6.model, local_epochs=1)
        assert cr.n_groups(8) == 3
        got = cr(variables, space_to_depth_images(images), masks, active, ns)
    else:
        ref = dataclasses.replace(c6, model=dataclasses.replace(c6.model, stem_layout="reference",
                                                                res_layout="reference"))
        got = round_from_config(ref, device="cpu")[1](variables, images, masks, active, ns)
    _assert_bytes_equal(got[0], want_v)
    _metrics_equal(got[1], want_m)


def test_layout_rounds_take_packed_channels_only_under_a_stem_layout():
    """4C channels are the packed staging under a space-to-depth stem and
    refused under the reference stem (JAX's message); the spatial round
    still refuses the layouts."""
    import dataclasses

    from fedcrack_tpu_torch.parallel import build_federated_round

    images, masks = _client_data(2)
    packed = np.concatenate([images] * 4, axis=-1)
    variables = _jax_variables(0)
    act, ns = np.ones(2, np.float32), np.full(2, 8.0, np.float32)
    with pytest.raises(ValueError, match=r"accepts \(3,\)"):
        build_federated_round(_mesh(2), _cfg())(variables, packed, masks, act, ns)
    s2d = build_federated_round(_mesh(2), dataclasses.replace(_cfg(), stem_layout="s2d"))
    with pytest.raises(ValueError, match=r"accepts \(3, 12\)"):
        s2d(variables, np.concatenate([images] * 2, axis=-1), masks, act, ns)


@pytest.mark.parametrize("segments", [0, 2])
@pytest.mark.parametrize("field", [{"dp_clip_norm": 1.0, "dp_noise_multiplier": 1.1}, {"update_codec": "int8"},
                                   {"update_codec": "topk_delta"}, {"secagg": True}])
def test_round_from_config_refuses_the_client_plane_knobs(segments, field):
    """A config asking for update-level DP, a wire codec or secure
    aggregation is refused, monolithic or segmented: never a round that
    quietly drops them."""
    from fedcrack_tpu_torch.configs import DataConfig, FedConfig
    from fedcrack_tpu_torch.parallel import round_from_config

    cfg = FedConfig(model=_cfg(), data=DataConfig(img_size=16), mesh_clients=2, local_epochs=2, segments=segments,
                    **field)
    with pytest.raises(ValueError, match=next(iter(field))):
        round_from_config(cfg, device="cpu")
