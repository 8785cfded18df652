"""The quant gate at the full width of ``ModelConfig()``, on the port's seeded
init weights, held against the JAX package's gate on the same weights.

Glorot-random weights at full width are chaotic: the rounding of the
weights to int8 or e4m3 codes flips a large share of the probe-mask
pixels, and the gate refuses them. This file shows that the refusal belongs
to the weights and not to the port: on the same weights the JAX package's
gate reads the same per-bucket IoU, and the port's reference program gives
the JAX package's logits at full width.

As a test it runs one small bucket (64, probe batch 2). Run as a script it
runs the serving configuration (buckets 128 and 256, probe batch 4, the
weights of ``init_variables`` seed 0 that ``chip_smoke.py`` draws) for the
int8 and e4m3 planes and prints both packages' gate results, one JSON
object per plane:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_gate_fullwidth.py

The JAX side runs its fused plane with ``FEDCRACK_KERNEL_IMPL=reference``
(the jnp product that its Pallas kernel is tested against); interpret mode
would take many minutes at these shapes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


def _stacks(plane: str, buckets: tuple[int, ...], probe_batch: int):
    from fedcrack_tpu.configs import ModelConfig as JaxModelConfig
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    kw = dict(bucket_sizes=buckets, max_batch=probe_batch, quant="int8",
              kernel_plane=plane, quant_probe_batch=probe_batch)
    jax_engine = JaxEngine(JaxModelConfig(), JaxServeConfig(**kw))
    engine = InferenceEngine(ModelConfig(), ServeConfig(**kw), device="cpu")
    return jax_engine, engine


def gate_both(variables: dict, plane: str, buckets: tuple[int, ...], probe_batch: int):
    """(JAX gate, port gate) on the same host weights and plane."""
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu_torch.serve import quant as tq

    jax_engine, engine = _stacks(plane, buckets, probe_batch)
    jax_gate = jq.quant_gate(
        jax_engine,
        jax_engine.prepare(variables),
        jax_engine.prepare_quantized(jq.quantize_for_plane(variables, plane)),
    )
    gate = tq.quant_gate(
        engine,
        engine.prepare(variables),
        engine.prepare_quantized(tq.quantize_for_plane(variables, plane)),
    )
    return jax_gate, gate


def _port_init_variables(seed: int = 0) -> dict:
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.resunet import init_variables

    return init_variables(torch.Generator().manual_seed(seed), ModelConfig())


@pytest.fixture(scope="module")
def full_width_variables():
    return _port_init_variables(0)


def test_reference_logits_match_flax_at_full_width(full_width_variables):
    """The port's ResUNet at ModelConfig() widths against flax's
    ``apply(train=False)`` on the same weights. Tolerance: 1e-4 of the
    largest logit (absolute), since random full-width logits run to
    hundreds and the two packages sum each conv in different orders."""
    from fedcrack_tpu.configs import ModelConfig as JaxModelConfig
    from fedcrack_tpu.models.resunet import ResUNet as FlaxResUNet
    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.models.convert import from_flax_variables
    from fedcrack_tpu_torch.models.resunet import ResUNet

    x = np.random.default_rng(21).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(
        FlaxResUNet(config=JaxModelConfig()).apply(full_width_variables, x, train=False)
    )
    model = from_flax_variables(full_width_variables, ResUNet(ModelConfig(), device="cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 1)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("plane", ["fused_int8", "fp8"])
def test_gate_matches_jax_at_full_width(full_width_variables, monkeypatch, plane):
    """Same verdict, and per-bucket IoU within 0.01, from both packages' gates
    on the same raw weights (the masks are compared after a sigmoid and a
    0.5 threshold, so pixels with a near-zero logit may fall either way)."""
    from fedcrack_tpu import jaxcompat

    if plane == "fp8" and not jaxcompat.fp8_supported():
        pytest.skip("this jax build has no fp8 dtypes")
    monkeypatch.setenv("FEDCRACK_KERNEL_IMPL", "reference")
    jax_gate, gate = gate_both(full_width_variables, plane, (64,), 2)
    assert gate.passed == jax_gate.passed
    assert set(gate.per_bucket) == set(jax_gate.per_bucket) == {64}
    assert abs(gate.per_bucket[64] - jax_gate.per_bucket[64]) <= 0.01, (
        gate.to_json(), jax_gate.to_json())


def main() -> int:
    os.environ.setdefault("FEDCRACK_KERNEL_IMPL", "reference")
    variables = _port_init_variables(0)
    for plane in ("fused_int8", "fp8"):
        jax_gate, gate = gate_both(variables, plane, (128, 256), 4)
        print(json.dumps({"plane": plane, "jax": jax_gate.to_json(), "port": gate.to_json()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
