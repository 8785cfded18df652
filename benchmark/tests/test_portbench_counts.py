"""The frozen FLOP and byte counts against the port's FLOPs model."""

import pytest

from benchmark.counts import flops, layers
from fedcrack_tpu_torch.configs import ModelConfig
from fedcrack_tpu_torch.obs import flops as port_flops

WIDTHS = [
    dict(stem_features=32, encoder_features=(64, 128, 256), decoder_features=(256, 128, 64, 32)),
    dict(stem_features=8, encoder_features=(16, 16, 16), decoder_features=(16, 16, 16, 8)),
    dict(stem_features=16, encoder_features=(32, 64), decoder_features=(64, 32, 16)),
]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("size,batch", [(128, 1), (256, 16), (256, 32), (64, 3)])
def test_counts_equal_the_port_model(w, size, batch):
    cfg = ModelConfig(img_size=size, **w)
    widths = dict(w, in_channels=3, num_classes=1)
    assert flops.resunet_forward_flops(widths, size, batch) == port_flops.resunet_forward_flops(cfg, batch)
    assert flops.train_step_flops(widths, size, batch) == port_flops.train_step_flops(cfg, batch)


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_kernel_launches_cover_the_forward(lanes):
    """The GEMMs, the 3x3 convs and the depthwise convs add up to the
    forward's FLOPs, in the forward's 15 / 8 / 6 launches."""
    widths = dict(WIDTHS[0], in_channels=3, num_classes=1)
    work = layers.launches(widths, 256, lanes)
    assert len(work["dequant_matmul"]) == 15 and len(work["dequant_conv3x3"]) == 8
    s, c, depthwise = 128, 32, 0.0
    for f in widths["encoder_features"]:
        depthwise += 2.0 * s * s * 9 * (c + f)
        s //= 2
        c = f
    total = sum(fl for fl, _ in work["dequant_matmul"] + work["dequant_conv3x3"]) + depthwise * lanes
    assert total == flops.resunet_forward_flops(widths, 256, lanes)


def test_least_time_takes_the_larger_roof():
    assert layers.least_seconds([(flops.PEAK_FLOPS, 0.0)]) == 1.0
    assert layers.least_seconds([(0.0, flops.PEAK_BYTES_PER_S), (flops.PEAK_FLOPS * 2, 1.0)]) == 3.0
