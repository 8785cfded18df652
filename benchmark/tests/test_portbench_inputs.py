"""The generators: seeded, repeatable, and the frozen copies equal to the
port's originals."""

import pytest
import torch

from benchmark.inputs import arrivals, images, weights
from benchmark.reference import resunet
from fedcrack_tpu_torch.serve import quant
from fedcrack_tpu_torch.tools import load_gen

WIDTHS = dict(stem_features=8, encoder_features=[16, 16, 16], decoder_features=[16, 16, 16, 8], in_channels=3,
              num_classes=1)
BIG_SEED = 2**31 + 977


def _leaves(tree):
    return [t for _, t in sorted((p, v) for p, v in _flat(tree))]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        yield from (_flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])


def test_weights_repeat_and_differ_by_seed():
    a = weights.draw_variables(BIG_SEED, WIDTHS, "cpu")
    b = weights.draw_variables(BIG_SEED, WIDTHS, "cpu")
    c = weights.draw_variables(BIG_SEED + 1, WIDTHS, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(c)))
    specs = resunet.leaf_specs(8, (16, 16, 16), (16, 16, 16, 8))
    assert [tuple(resunet.get(a, p).shape) for p, _, _ in specs] == [s for _, s, _ in specs]
    assert all(float(resunet.get(a, p).min()) > 0 for p, _, k in specs if k == "bn_var")


def test_snap_makes_the_port_quantizer_exact():
    snapped = weights.snap_to_int8_grid(weights.draw_variables(5, WIDTHS, "cpu"))
    again = quant.dequantize_variables(quant.quantize_for_plane(snapped, "fused_int8").tree)
    for (p, x), (q, y) in zip(sorted(_flat(snapped)), sorted(_flat(again))):
        assert p == q
        torch.testing.assert_close(torch.as_tensor(y), x, rtol=2e-7, atol=0)


def test_snap_matches_the_port_quantizer():
    raw = weights.draw_variables(6, WIDTHS, "cpu")
    ours = weights.snap_to_int8_grid(raw)
    port = quant.dequantize_variables(quant.quantize_for_plane(raw, "fused_int8").tree)
    for (p, x), (_, y) in zip(sorted(_flat(ours)), sorted(_flat(port))):
        torch.testing.assert_close(torch.as_tensor(y), x, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h,w", [(48, 64), (64, 48), (32, 32)])
def test_images_repeat_and_hold_cracks(h, w):
    a, am = images.crack_images(6, h, w, BIG_SEED, "cpu")
    b, bm = images.crack_images(6, h, w, BIG_SEED, "cpu")
    c, _ = images.crack_images(6, h, w, BIG_SEED + 1, "cpu")
    assert torch.equal(a, b) and torch.equal(am, bm) and not torch.equal(a, c)
    assert a.shape == (6, h, w, 3) and a.dtype == torch.uint8 and am.shape == (6, h, w, 1)
    assert set(am.unique().tolist()) <= {0, 1} and int(am.sum()) > 0
    crack = am[..., 0].bool()
    assert float(a[..., 0][crack].float().mean()) < float(a[..., 0][~crack].float().mean())


@pytest.mark.parametrize("profile", ["const", "ramp", "diurnal"])
def test_arrivals_equal_the_port_generator(profile):
    ours = arrivals.arrival_schedule(profile, 97, 40.0, seed=BIG_SEED)
    assert ours == load_gen.arrival_schedule(profile, 97, 40.0, seed=BIG_SEED)
    assert ours == arrivals.arrival_schedule(profile, 97, 40.0, seed=BIG_SEED)
