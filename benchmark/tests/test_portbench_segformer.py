"""The SegFormer cell's pieces on the CPU: the reference's block against a
hand-written one, its query blocks, the seeded weights, and the cell run
whole at a small size through the harness, with the TF32 control and the
planted round faults failing its check."""

import json
import math
import os
import time

import pytest
import torch

from benchmark import faults, harness
from conftest import checkout, read, write

CELL = "segb5-fed8-1024"
SMALL = {"img_size": 64, "embed_dims": [16, 32, 40, 64], "depths": [1, 1, 2, 1], "decoder_dim": 32}


def _hand_block(x, p, h, w, heads):
    """One block written out op by op: LayerNorm from its moments, a loop
    over heads with an explicit softmax, the spatial reduction as a sum
    over the patches, the depthwise conv as a sum over nine shifted grids,
    GELU from ``erf``."""
    def ln(t, q, eps):
        mean = t.mean(-1, keepdim=True)
        var = ((t - mean) ** 2).mean(-1, keepdim=True)
        return (t - mean) / torch.sqrt(var + eps) * q["scale"] + q["bias"]

    def lin(t, q):
        return t @ q["kernel"] + q["bias"]

    b, n, c = x.shape
    d = c // heads
    a = p["attn"]
    y = ln(x, p["norm1"], 1e-6)
    q = lin(y, a["q"])
    sr = a["sr"]["kernel"].shape[0]
    grid = y.reshape(b, h, w, c)
    reduced = torch.zeros(b, h // sr, w // sr, c)
    for i in range(sr):
        for j in range(sr):
            reduced = reduced + grid[:, i::sr, j::sr, :] @ a["sr"]["kernel"][i, j]
    reduced = ln(reduced.reshape(b, -1, c) + a["sr"]["bias"], a["norm"], 1e-5)
    kv = lin(reduced, a["kv"])
    k, v = kv[..., :c], kv[..., c:]
    heads_out = []
    for hd in range(heads):
        sl = slice(hd * d, (hd + 1) * d)
        scores = (q[..., sl] @ k[..., sl].transpose(1, 2)) * d ** -0.5
        e = torch.exp(scores - scores.max(-1, keepdim=True).values)
        heads_out.append((e / e.sum(-1, keepdim=True)) @ v[..., sl])
    x = x + lin(torch.cat(heads_out, -1), a["proj"])
    m = p["mlp"]
    hid = lin(ln(x, p["norm2"], 1e-6), m["fc1"]).reshape(b, h, w, -1)
    padded = torch.nn.functional.pad(hid, (0, 0, 1, 1, 1, 1))
    conv = m["dwconv"]["bias"].expand_as(hid).clone()
    for i in range(3):
        for j in range(3):
            conv = conv + padded[:, i:i + h, j:j + w, :] * m["dwconv"]["kernel"][i, j, 0]
    conv = conv.reshape(b, n, -1)
    gelu = 0.5 * conv * (1.0 + torch.erf(conv / math.sqrt(2.0)))
    return x + lin(gelu, m["fc2"])


def _small_tree(seed=11):
    from benchmark.inputs.segformer_weights import draw_variables

    model = {"embed_dims": [8, 16, 24, 32], "depths": [1, 1, 1, 1], "sr_ratios": [2, 2, 2, 1], "mlp_ratio": 4,
             "decoder_dim": 8, "in_channels": 3, "num_classes": 1}
    return draw_variables(seed, model, "cpu")


def test_reference_block_matches_a_hand_written_block():
    from benchmark.reference import segformer

    p = _small_tree()["params"]["block1_0"]
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(0))
    got = segformer.block(x, p, 4, 4, 2)
    want = _hand_block(x, p, 4, 4, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_query_blocks_change_nothing():
    from benchmark.reference import segformer

    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 3, 40, 8, generator=g) for _ in range(3))
    whole = segformer.attention(q, k, v, 8 ** -0.5, False, query_block=40)
    torch.testing.assert_close(segformer.attention(q, k, v, 8 ** -0.5, False, query_block=7), whole,
                               rtol=0, atol=1e-6)


def test_weights_are_seeded_and_spread():
    from benchmark.inputs.segformer_weights import draw_variables, leaf_specs
    from benchmark.reference.fed import _leaves

    cfg = read(os.path.join(harness.ROOT, "benchmark", "configs", "segformer-b5-f32-fed8.json"))["fed"]["model"]
    model = {**cfg, **SMALL}
    a, b = draw_variables(2**31 + 9, model, "cpu"), draw_variables(2**31 + 9, model, "cpu")
    c = draw_variables(2**31 + 10, model, "cpu")
    la, lb, lc = _leaves(a), _leaves(b), _leaves(c)
    assert [p for p, _ in la] == [p for p, _, _ in leaf_specs(model)]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lc))
    kinds = {p: k for p, _, k in leaf_specs(model)}
    for path, v in la:
        if kinds[path] == "dense":
            assert abs(float(v.std()) - 0.02) < 0.004, path
        if kinds[path] in ("ln_scale", "bn_scale", "bn_var"):
            assert 0.75 <= float(v.min()) and float(v.max()) <= 1.25


@pytest.fixture
def small_cell(tmp_path):
    """The cell at a size the CPU runs in seconds: the small topology, two
    clients, a pool of 16. Limits for this size from its own readings (the
    program's and the TF32 control's at seed 2**31 + 77: loss_gap 4.3e-8
    and 1.6e-5, grad1_gap 8.3e-6 and 1.0e-1, change2_gap 4.4e-5 and
    8.0e-2)."""
    root = checkout(tmp_path)
    b = root / "benchmark"
    c = read(b / "configs" / "segformer-b5-f32-fed8.json")
    c["fed"]["model"].update(SMALL)
    c["fed"]["data"].update(img_size=64)
    c["fed"]["mesh_clients"] = 2
    write(b / "configs" / "segformer-b5-f32-fed8.json", c)
    write(b / "traffic" / "rounds-1024-s2.json", {"driver": "rounds_segformer", "pool": 16, "steps": 2,
                                                  "check_rounds": 2, "profile_rounds": 1})
    write(b / "limits" / f"{CELL}.json", {"loss_gap": 5e-5, "grad1_gap": 1e-3, "change2_gap": 5e-3})
    return str(root)


def test_cell_runs_correct_and_the_control_fails(small_cell):
    result, checks, controls = harness.run_cell(small_cell, CELL, 2**31 + 77, 0.5, False, torch.device("cpu"),
                                                time.perf_counter(), control=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {"train_images_per_s", "setup_s"}
    assert [c.name for c in checks] == ["loss_gap", "grad1_gap", "change2_gap"]
    assert not all(c.ok for c in controls), [(c.name, c.value) for c in controls]
    json.dumps(result)


@pytest.mark.parametrize("fault", ["round_half_batch", "round_half_clients"])
def test_round_faults_fail_the_check(small_cell, fault):
    with faults.TRAINING[fault]():
        result, checks, _ = harness.run_cell(small_cell, CELL, 5, 0.3, False, torch.device("cpu"),
                                             time.perf_counter())
    assert not result["correct"], [(c.name, c.value) for c in checks]
