"""The train step's graph path (``train/local.py``: ``StepGraphs``) and the
fold's host weights (``fed/aggregation.py::mesh_ordered_fold``), on the
CPU at a tiny width.

A fake stands in for ``CudaGraphs``: its capture runs the step's body once
and keeps the outputs, and its replay runs the body again and copies the
results into those outputs, as a CUDA graph writes its static outputs.
With it the bookkeeping runs here: a key's first step eager, its second
captured, the later ones replayed; the gradients pointed at the graph's;
the metrics copied out; the ``bce_sums`` launches counted once a step.
Every step with a hook, FedProx, or no backend (the CPU) stays eager. The
fold takes a weight on the host as a Python float, with the same bits as
the old 0-d float32 tensor.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

TINY = dict(img_size=16, stem_features=4, encoder_features=(8,), decoder_features=(8, 4))
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_recorder_left():
    from fedcrack_tpu_torch.obs import spans

    spans.uninstall()
    yield
    spans.uninstall()


class FakeGraph:
    """A replay runs the body again (its Python calls counted as none) and
    writes the results into the outputs kept at capture."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs
        self.replays = 0

    def replay(self):
        from fedcrack_tpu_torch.ops import bce

        launches = bce.bce_sums.launches
        metrics, grads = self.body()
        bce.bce_sums.launches = launches
        kept_metrics, kept_grads = self.outputs
        with torch.no_grad():
            for k, v in metrics.items():
                kept_metrics[k].copy_(v)
            for kept, g in zip(kept_grads, grads):
                if kept is not None:
                    kept.copy_(g)
        self.replays += 1


class FakeGraphs:
    """``CudaGraphs``' interface on the CPU. ``capturing`` is true while a
    capture runs the body."""

    capturing = False

    def __init__(self):
        self.warm_ups = 0
        self.graphs = []

    def warm_up(self, fn):
        self.warm_ups += 1
        return fn()

    def capture(self, fn):
        FakeGraphs.capturing = True
        try:
            out = fn()
        finally:
            FakeGraphs.capturing = False
        graph = FakeGraph(fn, out)
        self.graphs.append(graph)
        return graph, out


def _cfg():
    from fedcrack_tpu_torch.configs import ModelConfig

    return ModelConfig(**TINY)


def _state(graphed: bool):
    from fedcrack_tpu_torch.train.local import StepGraphs, create_train_state

    state = create_train_state(torch.Generator().manual_seed(0), _cfg(), device="cpu")
    if graphed:
        state.graphs = StepGraphs(FakeGraphs())
    return state


def _batch(seed: int, size: int = 16, dtype=np.uint8):
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch

    images, masks = synth_crack_batch(BATCH, img_size=size, seed=seed)
    if dtype == np.uint8:
        from fedcrack_tpu_torch.data.pipeline import to_uint8_transport

        images, masks = to_uint8_transport(images, masks)
    return torch.as_tensor(images), torch.as_tensor(masks)


def _eager(m, x):
    return m(x)


def _counts():
    from fedcrack_tpu_torch.obs.registry import REGISTRY

    fam = REGISTRY.get("train_step_graph_total")
    return {path: fam.labels(path=path).value for path in ("eager", "capture", "replay")}


def _delta(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after}


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def _state_bits(state) -> list[bytes]:
    model, opt = state.model, state.optimizer
    out = [_bits(t) for t in model.state_dict().values()]
    for p in model.parameters():
        st = opt.state[p]
        out += [_bits(st["exp_avg"]), _bits(st["exp_avg_sq"]), _bits(st["step"])]
    return out


def _steps(state, batches, forward=None, pos_weight=1.0):
    from fedcrack_tpu_torch.train.local import train_step

    return [train_step(state, b, {}, 0.0, pos_weight, forward=forward)[1] for b in batches]


def test_first_step_eager_second_captures_later_replay():
    from fedcrack_tpu_torch.obs import spans

    state = _state(graphed=True)
    before = _counts()
    rec = spans.install()
    try:
        _steps(state, [_batch(s) for s in range(5)])
    finally:
        spans.uninstall()
    fake = state.graphs.backend
    assert fake.warm_ups == 1 and len(fake.graphs) == 1 and fake.graphs[0].replays == 3
    forwards = [r for r in rec.records if r["name"] == "train.forward"]
    assert [r["graph"] for r in forwards] == ["eager", "capture", "replay", "replay", "replay"]
    assert [r["step"] for r in forwards] == list(range(5))
    assert [r["name"] for r in rec.records].count("train.backward") == 5
    assert _delta(before) == {"eager": 1, "capture": 1, "replay": 3}


@pytest.mark.parametrize("change", ["shape", "image_dtype", "mask_dtype", "pos_weight", "moved_weights"])
def test_a_changed_key_starts_again(change):
    from fedcrack_tpu_torch.obs import spans

    state = _state(graphed=True)
    _steps(state, [_batch(0), _batch(1), _batch(2)])
    images, masks = _batch(3)
    pos_weight = 1.0
    if change == "shape":
        images, masks = _batch(3, size=32)
    elif change == "image_dtype":
        images = images.to(torch.float32) / 255.0
    elif change == "mask_dtype":
        masks = masks.to(torch.float32)
    elif change == "pos_weight":
        pos_weight = 2.0
    else:
        first = next(state.model.parameters())
        first.data = first.detach().clone()
    rec = spans.install()
    try:
        _steps(state, [(images, masks)] * 3, pos_weight=pos_weight)
        _steps(state, [_batch(4)] if change != "moved_weights" else [])
    finally:
        spans.uninstall()
    paths = [r["graph"] for r in rec.records if r["name"] == "train.forward"]
    assert paths[:3] == ["eager", "capture", "replay"]
    if change != "moved_weights":
        # The first key's graph still replays.
        assert paths[3:] == ["replay"]
    assert len(state.graphs.backend.graphs) == 2


def test_graph_steps_bitwise_equal_eager_steps():
    graphed, eager = _state(graphed=True), _state(graphed=False)
    batches = [_batch(s) for s in range(5)]
    got = _steps(graphed, batches)
    want = _steps(eager, batches, forward=_eager)
    assert _state_bits(graphed) == _state_bits(eager)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert all(_bits(g[k]) == _bits(w[k]) for k in g)


def test_gradients_pointed_back_after_a_caller_drops_them():
    graphed, eager = _state(graphed=True), _state(graphed=False)
    batches = [_batch(s) for s in range(5)]
    for i, b in enumerate(batches):
        _steps(graphed, [b])
        _steps(eager, [b], forward=_eager)
        graphed.optimizer.zero_grad(set_to_none=True)
        if i >= 1:
            kept = graphed.graphs._steps
            (entry,) = kept.values()
            assert all(p.grad is None for p in graphed.model.parameters())
            assert entry.grads is not None
    _steps(graphed, [_batch(9)])
    _steps(eager, [_batch(9)], forward=_eager)
    (entry,) = graphed.graphs._steps.values()
    assert all(p.grad is g for p, g in zip(graphed.model.parameters(), entry.grads))
    assert _state_bits(graphed) == _state_bits(eager)


def test_each_steps_metrics_are_its_own_tensors():
    state = _state(graphed=True)
    batches = [_batch(s) for s in range(4)]
    got = _steps(state, batches)
    held = [{k: _bits(v) for k, v in m.items()} for m in got]
    later = _steps(state, [_batch(7)])
    for a, b in zip(got[1:], got[2:] + later):
        assert all(a[k].data_ptr() != b[k].data_ptr() for k in a)
    assert [{k: _bits(v) for k, v in m.items()} for m in got] == held
    assert len({_bits(m["loss"]) for m in got}) > 1


def test_bce_launches_count_once_a_step(monkeypatch):
    """On the card each launch counts as it runs, and one recorded into a
    capture counts at each run of its graph; here the plain sums stand in
    for the kernel and count the same way, the fake's capture stands in for
    a stream's, and the fake's replay makes no call, as a graph's does
    not."""
    from fedcrack_tpu_torch.ops import bce

    plain = bce._bce_sums_plain

    def counted(x, y):
        bce._count_launch()
        return plain(x, y)

    monkeypatch.setattr(bce, "_bce_sums_plain", counted)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: FakeGraphs.capturing)
    state = _state(graphed=True)
    start = bce.bce_sums.launches
    seen = []
    for s in range(5):
        _steps(state, [_batch(s)])
        seen.append(bce.bce_sums.launches - start)
    assert seen == [1, 2, 3, 4, 5]
    (entry,) = state.graphs._steps.values()
    assert entry.launches == 1


def test_graphs_freed_with_their_state():
    state = _state(graphed=True)
    _steps(state, [_batch(s) for s in range(3)])
    graphs = weakref.ref(state.graphs)
    graph = weakref.ref(state.graphs.backend.graphs[0])
    del state
    gc.collect()
    assert graphs() is None and graph() is None


def test_no_backend_on_the_cpu():
    from fedcrack_tpu_torch.train.local import _step_graphs

    state = _state(graphed=False)
    before = _counts()
    _steps(state, [_batch(s) for s in range(3)])
    assert state.graphs is None and _step_graphs(state) is None
    assert _delta(before) == {"eager": 3, "capture": 0, "replay": 0}


def _slot_fit(kind: str):
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _SlotFit

    kw = dict(remat=kind == "remat", lowp="fake_quant_int8" if kind == "lowp" else None,
              dp={"clip": 1.0, "sigma": 0.5, "seed": 3} if kind == "dp" else None)
    if kind == "spatial_forward":
        kw["forward"] = _eager
    return _SlotFit(_cfg(), 1e-3, 0.1 if kind == "fedprox" else 0.0, 1.0, device=torch.device("cpu"), **kw)


def _global_of(fit):
    """A global tree (copies, on the host) of the slot plane's first
    worker's drawn weights."""
    from fedcrack_tpu_torch.fed.pytree import tree_map
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _model_variables

    return tree_map(lambda t: t.detach().clone(), _model_variables(fit.worker(0).model))


@pytest.mark.parametrize("kind", ["dp", "remat", "lowp", "fedprox", "spatial_forward", "metrics_fn", "cpu"])
def test_hooked_steps_stay_eager(kind):
    """DP-SGD, recomputation, fake-quant, FedProx with mu != 0, the spatial
    plane's forward and metrics, and a state with no backend (the CPU) run
    the eager step even where a graph backend is installed."""
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _anchor
    from fedcrack_tpu_torch.train.local import StepGraphs, train_step

    before = _counts()
    fake = FakeGraphs()
    if kind in ("metrics_fn", "cpu"):
        state = _state(graphed=kind != "cpu")
        if kind == "metrics_fn":
            state.graphs = StepGraphs(fake)
        for s in range(3):
            train_step(state, _batch(s), {}, 0.0, 1.0,
                       metrics_fn=fused_segmentation_metrics if kind == "metrics_fn" else None)
    else:
        fit = _slot_fit(kind)
        gvars = _global_of(fit)
        slot = fit.init(0, gvars)
        slot.state.graphs = StepGraphs(fake)
        anchor = _anchor(gvars, slot.state.model)
        after = fit._after_backward(slot, 0, 0)
        for s in range(3):
            fit._step(slot, _batch(s), anchor, after)
    assert fake.warm_ups == 0 and fake.graphs == []
    assert _delta(before) == {"eager": 3, "capture": 0, "replay": 0}


def test_plain_slot_steps_take_the_graph():
    """The slot plane's step with no twin on takes the graph path: its
    first step warms, its second captures."""
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _anchor
    from fedcrack_tpu_torch.train.local import StepGraphs

    fit = _slot_fit("plain")
    gvars = _global_of(fit)
    slot = fit.init(0, gvars)
    slot.state.graphs = StepGraphs(FakeGraphs())
    anchor = _anchor(gvars, slot.state.model)
    before = _counts()
    for s in range(3):
        fit._step(slot, _batch(s), anchor, fit._after_backward(slot, 0, None))
    assert _delta(before) == {"eager": 1, "capture": 1, "replay": 1}


def _round_inputs(n_clients: int, steps: int, rounds: int):
    from fedcrack_tpu_torch.data.synthetic import synth_crack_batch
    from fedcrack_tpu_torch.parallel import stack_client_data

    out = []
    for r in range(rounds):
        per = [synth_crack_batch(steps * BATCH, img_size=16, seed=100 * r + i) for i in range(n_clients)]
        images, masks = stack_client_data(per, steps, BATCH)
        out.append((images, masks))
    return out


def test_graphed_round_bitwise_equals_eager_round(monkeypatch):
    """Two rounds of three slots through the slot plane, the steps on the
    fake graphs against the same rounds with ``forward`` set (eager): the
    globals and metrics bit for bit, with one warm-up and one capture in
    all, since every slot reuses one state."""
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.parallel import make_mesh
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _build_round
    from fedcrack_tpu_torch.train import local

    fakes = []

    def fake_graphs(state):
        if state.graphs is None:
            fakes.append(FakeGraphs())
            state.graphs = local.StepGraphs(fakes[-1])
        return state.graphs

    mesh = make_mesh(3, 1, device="cpu")
    start = init_variables(torch.Generator().manual_seed(0), _cfg())
    inputs = _round_inputs(3, 2, 2)
    active, n = np.array([1, 0, 1], np.float32), np.array([4, 4, 3], np.float32)

    def run(round_fn):
        variables, metrics = start, []
        for images, masks in inputs:
            variables, m = round_fn(variables, images, masks, active, n)
            metrics.append(m)
        return variables, metrics

    eager_vars, eager_metrics = run(_build_round(mesh, _cfg(), 1e-3, 1, 0.0, forward=_eager))
    before = _counts()
    monkeypatch.setattr(local, "_step_graphs", fake_graphs)
    graph_vars, graph_metrics = run(_build_round(mesh, _cfg(), 1e-3, 1, 0.0))
    assert _delta(before) == {"eager": 1, "capture": 1, "replay": 10}
    assert len(fakes) == 1 and fakes[0].warm_ups == 1
    from fedcrack_tpu_torch.fed.pytree import tree_leaves

    assert [_bits(t) for t in tree_leaves(graph_vars)] == [_bits(t) for t in tree_leaves(eager_vars)]
    for g, w in zip(graph_metrics, eager_metrics):
        assert all(_bits(g[k]) == _bits(w[k]) for k in w)


def _old_fold(tree, weight, init):
    """The fold as it was: the weight a 0-d float32 tensor copied to the
    carry's device."""
    from fedcrack_tpu_torch.fed.pytree import tree_map

    num, den = init
    w = torch.as_tensor(weight, dtype=torch.float32).to(den.device)
    if w.ndim == 0:
        return tree_map(lambda a, x: a + w * x.to(torch.float32), num, tree), den + w
    for i in range(w.shape[0]):
        wi = w[i]
        num = tree_map(lambda a, x: a + wi * x[i].to(torch.float32), num, tree)
        den = den + wi
    return num, den


def _fold_values():
    """Leaves whose products with the weights below land on rounding ties
    (1 + 2^-23 times 1.5 is 1.5 + 1.5 ulp), sit at the ends of float32's
    range, or are -0.0, infinities and NaN."""
    one_up = np.nextafter(np.float32(1.0), np.float32(2.0))
    special = np.array([one_up, 1.5, -0.0, 0.0, 3.4e38, 1e-45, -1e-38, np.inf, -np.inf, np.nan], np.float32)
    rng = np.random.default_rng(5)
    return [np.concatenate([special, rng.standard_normal(54) * 10.0 ** rng.integers(-6, 6, 54)])
            .astype(np.float32).reshape(8, 8) for _ in range(4)]


WEIGHTS = {
    "zero": [0.0, 0.0, 0.0, 0.0],
    "one": [1.0, 1.0, 1.0, 1.0],
    "non_integer": [0.1, 1.0 / 3.0, 2.5, 1e-3],
    "ties": [1.5, 1.5, 3.0, 0.75],
    "mixed": [0.0, 16.0, 0.5, 1.0 + 2.0 ** -23],
}


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("form", ["float", "numpy", "cpu_tensor", "vector"])
def test_fold_host_weight_bit_equal_old_fold(weights, form):
    from fedcrack_tpu_torch.fed.aggregation import mesh_ordered_fold, mesh_zero_sums

    xs = [torch.from_numpy(x) for x in _fold_values()]
    ws = np.asarray(WEIGHTS[weights], np.float32)
    got = want = mesh_zero_sums({"a": xs[0], "b": xs[0][:3]})
    if form == "vector":
        tree = {"a": torch.stack(xs), "b": torch.stack([x[:3] for x in xs])}
        got = mesh_ordered_fold(tree, torch.from_numpy(ws), got)
        want = _old_fold(tree, torch.from_numpy(ws), want)
    else:
        for x, w in zip(xs, ws):
            weight = {"float": float(w), "numpy": w, "cpu_tensor": torch.tensor(w)}[form]
            tree = {"a": x, "b": x[:3]}
            got = mesh_ordered_fold(tree, weight, got)
            want = _old_fold(tree, torch.tensor(w), want)
    for g, w in zip((got[0]["a"], got[0]["b"], got[1]), (want[0]["a"], want[0]["b"], want[1])):
        assert g.dtype == torch.float32
        assert _bits(g) == _bits(w)


@pytest.mark.parametrize("active, n", [(1.0, 32.0), (0.0, 32.0), (1.0, 3.0), (1.0, 16_777_217.0), (0.5, 0.1)])
def test_fold_slot_weight_is_the_float32_product(active, n):
    from fedcrack_tpu_torch.fed.aggregation import mesh_zero_sums
    from fedcrack_tpu_torch.parallel.fedavg_mesh import _fold_slot

    x = torch.from_numpy(_fold_values()[0])
    got = _fold_slot({"a": x}, np.float32(active), np.float32(n), mesh_zero_sums({"a": x}))
    w = torch.tensor(np.float32(active) * np.float32(n), dtype=torch.float32)
    want = _old_fold({"a": x}, w, mesh_zero_sums({"a": x}))
    assert _bits(got[0]["a"]) == _bits(want[0]["a"]) and _bits(got[1]) == _bits(want[1])


def test_captured_launches_are_the_capturing_threads(monkeypatch):
    """A launch recorded into a capture is kept for the thread that
    captures, so another thread's launches during the capture count as
    they run and stay out of the graph's count."""
    import threading

    from fedcrack_tpu_torch.ops import bce

    flag = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: getattr(flag, "on", False))
    start = bce.bce_sums.launches
    took = {}

    def capturing():
        flag.on = True
        bce._count_launch()
        took["capturing"] = bce.take_captured_launches()

    def eager():
        bce._count_launch()
        bce._count_launch()
        took["eager"] = bce.take_captured_launches()

    threads = [threading.Thread(target=capturing), threading.Thread(target=eager)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert took == {"capturing": 1, "eager": 0}
    assert bce.bce_sums.launches - start == 2


def _shared_backend(monkeypatch) -> list:
    """``fedavg_mesh.graph_backend`` replaced by one that makes a fake a
    call and keeps them."""
    from fedcrack_tpu_torch.parallel import fedavg_mesh

    made: list = []

    def backend(device):
        made.append(FakeGraphs())
        return made[-1]

    monkeypatch.setattr(fedavg_mesh, "graph_backend", backend)
    return made


def test_slot_states_share_one_graph_backend(monkeypatch):
    """The segmented round keeps a state a slot; their step graphs share
    the round's one capture backend (on the card one memory pool, since
    the slots replay in turn on one stream), each state with its own
    graphs: a warm-up and a capture a state, through the one backend."""
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.parallel import make_mesh
    from fedcrack_tpu_torch.parallel.fedavg_mesh import build_federated_round_segments

    made = _shared_backend(monkeypatch)
    seg = build_federated_round_segments(make_mesh(3, 1, device="cpu"), _cfg(), local_epochs=1)
    images, masks = _round_inputs(3, 2, 1)[0]
    seg(init_variables(torch.Generator().manual_seed(0), _cfg()), images, masks, np.ones(3, np.float32),
        np.full(3, 4.0, np.float32))
    workers = seg.fit._workers
    assert len(made) == 1 and len(workers) == 3
    assert all(w.graphs.backend is made[0] for w in workers)
    assert len({id(w.graphs) for w in workers}) == 3
    assert made[0].warm_ups == 3 and len(made[0].graphs) == 3


def test_a_state_outside_the_plane_keeps_a_backend_of_its_own(monkeypatch):
    """``train_step`` gives a state with no graphs a backend of its own
    (``graph_backend``): ``local_fit``'s client state on the card."""
    from fedcrack_tpu_torch.train import local

    made = []
    monkeypatch.setattr(local, "graph_backend", lambda device: made.append(FakeGraphs()) or made[-1])
    states = [_state(graphed=False) for _ in range(2)]
    for state in states:
        monkeypatch.setattr(type(state), "device", property(lambda self: torch.device("cuda")))
        local._step_graphs(state)
    assert len(made) == 2 and [s.graphs.backend for s in states] == made


@pytest.mark.parametrize("form", ["segmented", "cohort"])
def test_shared_backend_rounds_bitwise_equal_eager_rounds(monkeypatch, form):
    """The U-Net's segmented round (a state a slot) and cohort round (five
    clients in groups of three) over two rounds, every slot's steps on the
    round's one shared fake backend, against the same rounds eager (no
    backend on the CPU): the globals and metrics bit for bit."""
    from fedcrack_tpu_torch.fed.pytree import tree_leaves
    from fedcrack_tpu_torch.models.resunet import init_variables
    from fedcrack_tpu_torch.parallel import make_mesh
    from fedcrack_tpu_torch.parallel.fedavg_mesh import build_federated_cohort_round, build_federated_round_segments

    clients = 3 if form == "segmented" else 5
    build = build_federated_round_segments if form == "segmented" else build_federated_cohort_round
    start = init_variables(torch.Generator().manual_seed(0), _cfg())
    inputs = _round_inputs(clients, 2, 2)
    active = np.array([1, 0, 1, 1, 1][:clients], np.float32)
    n = np.array([4, 4, 3, 4, 2][:clients], np.float32)

    def run():
        round_fn = build(make_mesh(3, 1, device="cpu"), _cfg(), local_epochs=1)
        variables, metrics = start, []
        for images, masks in inputs:
            variables, m = round_fn(variables, images, masks, active, n)
            metrics.append(m)
        return variables, metrics

    eager_vars, eager_metrics = run()
    before = _counts()
    made = _shared_backend(monkeypatch)
    graph_vars, graph_metrics = run()
    assert len(made) == 1 and made[0].warm_ups == 3 and len(made[0].graphs) == 3
    steps = 2 * 2 * (3 if form == "segmented" else 6)
    assert _delta(before) == {"eager": 3, "capture": 3, "replay": steps - 6}
    assert [_bits(t) for t in tree_leaves(graph_vars)] == [_bits(t) for t in tree_leaves(eager_vars)]
    for g, w in zip(graph_metrics, eager_metrics):
        assert all(_bits(g[k]) == _bits(w[k]) for k in w)
