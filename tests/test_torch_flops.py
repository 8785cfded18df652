"""The port's FLOPs model and MFU (``fedcrack_tpu_torch/obs/flops.py``)
held against the JAX package's ``obs/flops.py`` and against torch's own
FLOP counter, on the CPU.

- ``resunet_forward_flops`` and ``train_step_flops`` equal the JAX
  package's exactly (``==``) over image sizes, widths, batches and every
  layout pair JAX's ``test_flops_are_canonical_across_layouts`` uses.
- On the port's eval forward, ``torch.utils.flop_counter.FlopCounterMode``
  counts exactly the analytic model's FLOPs (the JAX test holds its model
  to XLA's cost analysis within 0.75-1.25).
- The counter's reading of a train step's backward is pinned with its
  reason, and the JAX package's multiplier of 3.0 is kept.
- The peak table, its override and ``mfu``.
"""

import pytest
import torch

from torch_port_helpers import TINY_KW

pytestmark = pytest.mark.torch_port

LAYOUTS = [("reference", "reference"), ("s2d", "reference"), ("s2d_full", "reference"),
           ("reference", "packed"), ("s2d", "packed")]
WIDTHS = {"full": {}, "narrow": {k: v for k, v in TINY_KW.items() if k != "img_size"}}


def _configs(img, widths, stem, res):
    from fedcrack_tpu.configs import ModelConfig as JaxConfig

    from fedcrack_tpu_torch.configs import ModelConfig

    kw = dict(img_size=img, stem_layout=stem, res_layout=res, **WIDTHS[widths])
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("stem,res", LAYOUTS)
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("img", [32, 128, 256])
def test_flops_equal_the_jax_model(img, widths, stem, res):
    from fedcrack_tpu.obs import flops as jf

    from fedcrack_tpu_torch.obs import flops as tf

    jax_cfg, port_cfg = _configs(img, widths, stem, res)
    for batch in (1, 4, 16):
        assert tf.resunet_forward_flops(port_cfg, batch) == jf.resunet_forward_flops(jax_cfg, batch)
        assert tf.train_step_flops(port_cfg, batch) == jf.train_step_flops(jax_cfg, batch)
    # Canonical across layouts: every pair is charged the reference's.
    ref = _configs(img, widths, "reference", "reference")[1]
    assert tf.train_step_flops(port_cfg, 4) == tf.train_step_flops(ref, 4)


def test_the_numbers_the_card_reproduces():
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.obs import resunet_forward_flops, train_step_flops

    assert resunet_forward_flops(ModelConfig(), 2) == 2_144_993_280
    assert train_step_flops(ModelConfig(), 16) == 51_479_838_720
    assert train_step_flops(ModelConfig(img_size=256), 32) == 411_838_709_760


def _model(batch=2):
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import ResUNet

    cfg = ModelConfig()
    model = ResUNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand((batch, cfg.img_size, cfg.img_size, 3), generator=torch.Generator().manual_seed(1))
    return cfg, model, x


def test_forward_flops_equal_torchs_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from fedcrack_tpu_torch.obs.flops import resunet_forward_flops

    cfg, model, x = _model()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    assert {str(k) for k in counter.get_flop_counts()["Global"]} == {"aten.convolution"}
    assert counter.get_total_flops() == resunet_forward_flops(cfg, 2)


def test_torchs_backward_count_is_explained_and_not_adopted():
    """The counter reads a train step's backward as 3.04x the forward, not
    the 2x behind the multiplier of 3.0. The gap is the counter's, not the
    step's: it charges each weight gradient as a dense conv, ignoring
    ``groups``, so a depthwise 3x3's weight gradient over ``ch`` channels is
    counted ``ch`` times; and the stem's input gradient, which the step
    never computes (the images need none), is not counted. Both explain the
    reading to the FLOP. The executed backward is 2x the forward less the
    stem's input gradient, so the JAX package's 3.0 stays."""
    from torch.utils.flop_counter import FlopCounterMode

    from fedcrack_tpu_torch.obs.flops import TRAIN_STEP_FLOPS_MULTIPLIER, resunet_forward_flops

    cfg, model, x = _model()
    model.train()
    with FlopCounterMode(display=False) as counter:
        model(x).sum().backward()
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    fwd = resunet_forward_flops(cfg, 2)
    assert counts["aten.convolution"] == fwd
    s, c, overcount = cfg.img_size // 2, cfg.stem_features, 0.0
    for f in cfg.encoder_features:
        for ch in (c, f):
            overcount += 2.0 * s * s * ch * 9 * 2 * (ch - 1)  # depthwise wgrad, batch 2
        s //= 2
        c = f
    stem_dgrad = 2.0 * (cfg.img_size // 2) ** 2 * cfg.stem_features * 9 * cfg.in_channels * 2
    assert counts["aten.convolution_backward"] == 2 * fwd + overcount - stem_dgrad
    assert counts["aten.convolution_backward"] / fwd == pytest.approx(3.04, abs=0.005)
    assert TRAIN_STEP_FLOPS_MULTIPLIER == 3.0


def test_flops_scale_with_resolution_and_batch():
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.obs.flops import resunet_forward_flops

    f128 = resunet_forward_flops(ModelConfig(img_size=128))
    f256 = resunet_forward_flops(ModelConfig(img_size=256))
    # Fully convolutional: 4x the pixels is 4x the FLOPs, exactly.
    assert f256 == pytest.approx(4.0 * f128)
    assert resunet_forward_flops(ModelConfig(), batch_size=16) == pytest.approx(16.0 * f128)


def test_train_step_is_forward_times_multiplier():
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.obs.flops import TRAIN_STEP_FLOPS_MULTIPLIER, resunet_forward_flops, train_step_flops

    cfg = ModelConfig(img_size=32)
    assert train_step_flops(cfg, 8) == pytest.approx(TRAIN_STEP_FLOPS_MULTIPLIER * resunet_forward_flops(cfg, 8))


def test_peak_flops_env_override_and_the_cpu(monkeypatch):
    from fedcrack_tpu_torch.obs.flops import device_peak_flops, mfu

    cpu = torch.device("cpu")
    monkeypatch.setenv("FEDCRACK_PEAK_TFLOPS", "197")
    assert device_peak_flops(cpu) == pytest.approx(197e12)
    assert mfu(step_time_s=0.010, flops_per_step=197e12 * 0.010 * 0.5, device=cpu) == pytest.approx(0.5)
    monkeypatch.delenv("FEDCRACK_PEAK_TFLOPS")
    # A CPU has no bf16 tensor-core peak here: MFU is None, not a guess.
    assert device_peak_flops(cpu) is None
    assert device_peak_flops("cpu") is None
    assert mfu(0.010, 1e9, cpu) is None


@pytest.mark.parametrize("name,tflops", [
    ("NVIDIA H100 80GB HBM3", 989.4),
    ("NVIDIA H100 PCIe", 756.5),
    ("NVIDIA H100 NVL", 835.5),
    ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA GeForce RTX 4090", None),
])
def test_peak_flops_by_card_name(monkeypatch, name, tflops):
    from fedcrack_tpu_torch.obs.flops import device_peak_flops, mfu

    monkeypatch.delenv("FEDCRACK_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    got = device_peak_flops(torch.device("cuda", 0))
    if tflops is None:
        assert got is None and mfu(0.01, 1e12, "cuda") is None
    else:
        assert got == pytest.approx(tflops * 1e12)
        assert mfu(0.01, tflops * 1e12 * 0.01 * 0.25, "cuda:0") == pytest.approx(0.25)


def test_peak_flops_of_the_default_device_raises_without_cuda(monkeypatch):
    from fedcrack_tpu_torch.obs.flops import device_peak_flops

    monkeypatch.delenv("FEDCRACK_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_peak_flops()
