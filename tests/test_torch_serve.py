"""The port's serving path (fedcrack_tpu_torch/serve/) held against the JAX
package's on the same weights, all on the CPU.

- Engine vs JAX InferenceEngine: ``predict_bucket``, ``predict_image``
  padded and tiled, probabilities within 1e-4 (the logits agree to 1e-4,
  see test_torch_model.py, and the sigmoid only shrinks the difference);
  tiled output byte-identical across two runs.
- The quant gate passes on ``fused_int8``; a garbage quantized build
  (all-zero codes) is refused by ``prepare_gated_payload`` and the version
  manager then serves the reference program bit-exactly.
- ``MicroBatcher.submit`` answers equal ``predict_bucket`` bitwise.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, jax_config, jax_variables, port_config

pytestmark = pytest.mark.torch_port

BUCKET = 32


def _serve_kw(**over):
    kw = dict(bucket_sizes=(BUCKET,), max_batch=4, max_delay_ms=10.0, tile_overlap=4)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def stack():
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    variables = jax_variables(TINY_KW, seed=0)
    jax_engine = JaxEngine(jax_config(TINY_KW), JaxServeConfig(**_serve_kw()))
    engine = InferenceEngine(
        port_config(TINY_KW),
        ServeConfig(**_serve_kw(quant="int8", kernel_plane="fused_int8")),
        device="cpu",
    )
    return variables, jax_engine, jax_engine.prepare(variables), engine, engine.prepare(variables)


def _images(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_predict_bucket_and_image_match_jax(stack):
    _, jax_engine, jax_weights, engine, weights = stack
    batch = _images(3, BUCKET, BUCKET, 0)
    want = jax_engine.predict_bucket(jax_weights, batch)
    got = engine.predict_bucket(weights, batch)
    assert got.shape == want.shape == (3, BUCKET, BUCKET, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    img = _images(1, 21, 30, 1)[0]  # padded into the 32 bucket, cropped back
    got = engine.predict_image(weights, img)
    assert got.shape == (21, 30, 1)
    np.testing.assert_allclose(got, jax_engine.predict_image(jax_weights, img), rtol=0, atol=1e-4)


def test_predict_tiled_matches_jax_and_is_byte_deterministic(stack):
    from fedcrack_tpu.serve.engine import _ramp_weights as jax_ramp
    from fedcrack_tpu.serve.engine import tile_plan as jax_tile_plan
    from fedcrack_tpu_torch.serve.engine import _ramp_weights, tile_plan

    _, jax_engine, jax_weights, engine, weights = stack
    img = _images(1, 70, 45, 2)[0]
    assert engine.bucket_for(70, 45) is None and engine.n_tiles(70, 45) == jax_engine.n_tiles(70, 45)
    got = engine.predict_image(weights, img)
    again = engine.predict_tiled(weights, img)
    assert got.shape == (70, 45, 1) and got.tobytes() == again.tobytes()
    np.testing.assert_allclose(got, jax_engine.predict_tiled(jax_weights, img), rtol=0, atol=1e-4)
    for extent, tile, overlap in ((70, 32, 4), (32, 32, 4), (100, 32, 0), (33, 32, 31)):
        assert tile_plan(extent, tile, overlap) == jax_tile_plan(extent, tile, overlap)
    for flags in ((False, False), (True, False), (False, True), (True, True)):
        np.testing.assert_array_equal(_ramp_weights(32, 4, *flags), jax_ramp(32, 4, *flags))
    with pytest.raises(ValueError):
        tile_plan(10, 32, 4)


def test_fused_int8_plane_matches_jax_and_gate_passes(stack):
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.serve import quant as tq

    variables, _, _, engine, weights = stack
    jax_engine = JaxEngine(
        jax_config(TINY_KW), JaxServeConfig(**_serve_kw(quant="int8", kernel_plane="fused_int8"))
    )
    batch = tq.probe_images(BUCKET, 4, 0)
    want = jax_engine.predict_bucket(
        jax_engine.prepare_quantized(jq.quantize_variables(variables)), batch
    )
    payload = engine.prepare_quantized(tq.quantize_variables(variables))
    got = engine.predict_bucket(payload, batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    gate = tq.quant_gate(engine, weights, payload)
    assert gate.passed and set(gate.per_bucket) == {BUCKET}, gate.to_json()


def _garbage(quantized):
    from fedcrack_tpu_torch.serve import quant as tq

    def zero(node):
        if tq._is_qleaf(node):
            return {k: (torch.zeros_like(v) if k != tq.SKEY else v) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: zero(v) for k, v in node.items()}
        return node

    return tq.QuantizedVariables(zero(quantized.tree))


@pytest.mark.parametrize("plane", ["fused_int8", "fp8"])
def test_garbage_build_refused_and_reference_served_exactly(stack, monkeypatch, plane):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve import fleet, quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    variables = stack[0]
    engine = InferenceEngine(
        port_config(TINY_KW), ServeConfig(**_serve_kw(quant="int8", kernel_plane=plane)),
        device="cpu",
    )
    real = tq.quantize_for_plane
    monkeypatch.setattr(tq, "quantize_for_plane", lambda v, p: _garbage(real(v, p)))
    payload, gate = fleet.prepare_gated_payload(engine, variables, engine.serve_config)
    assert gate is not None and not gate.passed
    assert not isinstance(payload, tq.QuantizedVariables)

    manager = ModelVersionManager(engine, variables)
    assert manager.install(1, variables)
    assert manager.last_quant_gate["passed"] is False and manager.last_swap["quantized"] is False
    version, served = manager.snapshot()
    batch = _images(2, BUCKET, BUCKET, 3)
    want = engine.predict_bucket(engine.prepare(variables), batch)
    assert version == 1
    np.testing.assert_array_equal(engine.predict_bucket(served, batch), want)


def test_manager_installs_quantized_only_when_newer(stack):
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.hot_swap import ModelVersionManager

    variables, _, _, engine, _ = stack
    manager = ModelVersionManager(engine, variables, initial_version=3)
    assert not manager.install(3, variables) and not manager.install(2, variables)
    assert manager.install(4, variables)
    version, payload = manager.snapshot()
    assert version == manager.version == 4 and isinstance(payload, tq.QuantizedVariables)
    assert manager.last_quant_gate["passed"] and manager.last_swap["quantized"]


def test_batcher_answers_equal_predict_bucket(stack):
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

    variables, _, _, engine, _ = stack
    payload = engine.prepare_quantized(tq.quantize_variables(variables))
    images = _images(6, BUCKET, BUCKET, 4)
    with MicroBatcher(engine, StaticWeights(payload, version=7)) as batcher:
        futures = [batcher.submit(img) for img in images]
        results = [f.result(timeout=60) for f in futures]
        with pytest.raises(ValueError):
            batcher.submit(images[0][:16])
        stats = batcher.stats()
    for i, res in enumerate(results):
        assert res.model_version == 7 and not res.deadline_missed
        np.testing.assert_array_equal(res.probs, engine.predict_bucket(payload, images[i : i + 1])[0])
    assert stats["completed"] == stats["submitted"] == 6 and stats["failed"] == 0
    assert stats["per_bucket"] == {str(BUCKET): 6} and stats["versions_served"] == {"7": 6}
    assert stats["latency_ms"]["count"] == 6
    with pytest.raises(RuntimeError):
        batcher.submit(images[0])


def test_batcher_deadline_accounting_and_failure(stack):
    from fedcrack_tpu_torch.serve.batcher import MicroBatcher, StaticWeights

    _, _, _, engine, weights = stack
    with MicroBatcher(engine, StaticWeights(weights)) as batcher:
        res = batcher.submit(_images(1, BUCKET, BUCKET, 5)[0], deadline_ms=1e-6).result(timeout=60)
        assert res.deadline_missed  # served all the same
        assert batcher.stats()["deadline_missed"] == 1
    with MicroBatcher(engine, StaticWeights("not weights")) as batcher:
        fut = batcher.submit(_images(1, BUCKET, BUCKET, 6)[0])
        with pytest.raises(TypeError):
            fut.result(timeout=60)
        stats = batcher.stats()
    assert stats["failed"] == 1 and stats["batch_retries"] == 3


def test_engine_validates_inputs(stack):
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    variables, _, _, engine, weights = stack
    with pytest.raises(ValueError):
        engine.predict_bucket(weights, _images(5, BUCKET, BUCKET, 0))  # > max_batch
    with pytest.raises(ValueError):
        engine.predict_bucket(weights, _images(1, 16, 16, 0))  # not a bucket
    with pytest.raises(ValueError):
        engine.predict_bucket(weights, _images(1, BUCKET, BUCKET, 0).astype(np.float32))
    with pytest.raises(TypeError):
        engine.prepare_quantized(variables)
    plain = InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw()), device="cpu")
    with pytest.raises(ValueError):
        plain.prepare_quantized(tq.quantize_variables(variables))
    # bfloat16 serving builds (tests/test_torch_bf16.py holds it against
    # JAX); bfloat16 parameters are refused.
    bf16 = InferenceEngine(port_config(TINY_KW), ServeConfig(**_serve_kw(compute_dtype="bfloat16")),
                           device="cpu")
    assert bf16.bucket_model_config.compute_dtype == "bfloat16"
    with pytest.raises(ValueError):
        InferenceEngine(port_config(dict(TINY_KW, param_dtype="bfloat16")), ServeConfig(**_serve_kw()),
                        device="cpu")


# ---- the layouts (configs/c6_s2d_layout.json's s2d + packed) ----

C6_LAYOUTS = dict(TINY_KW, stem_layout="s2d", res_layout="packed")


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_layout_engine_matches_jax_and_the_reference_layout(quant):
    """An engine on the c6 layouts, float32 and int8 through the reference
    plane (``dequantize_variables``), against the JAX engine on the same
    layouts and weights (1e-4), and bit-equal to the port's
    reference-layout engine on oneDNN (tests/test_torch_layouts.py)."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve import quant as jq
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve import quant as tq
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    variables = jax_variables(TINY_KW, seed=4)
    kw = _serve_kw(quant=quant)
    jax_engine = JaxEngine(jax_config(C6_LAYOUTS), JaxServeConfig(**kw))
    engine = InferenceEngine(port_config(C6_LAYOUTS), ServeConfig(**kw), device="cpu")
    ref_engine = InferenceEngine(port_config(TINY_KW), ServeConfig(**kw), device="cpu")
    batch = _images(3, BUCKET, BUCKET, 5)
    if quant == "int8":
        want = jax_engine.predict_bucket(jax_engine.prepare_quantized(jq.quantize_variables(variables)), batch)
        q = tq.quantize_variables(variables)
        got = engine.predict_bucket(engine.prepare_quantized(q), batch)
        same = ref_engine.predict_bucket(ref_engine.prepare_quantized(q), batch)
    else:
        want = jax_engine.predict_bucket(jax_engine.prepare(variables), batch)
        got = engine.predict_bucket(engine.prepare(variables), batch)
        same = ref_engine.predict_bucket(ref_engine.prepare(variables), batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.tobytes() == same.tobytes()


@pytest.mark.parametrize("plane", ["fused_int8", "fp8"])
def test_fused_planes_refuse_the_layouts_at_construction(plane):
    """``fused_int8`` and ``fp8`` with a non-reference layout raise at
    construction with the JAX engine's message (which the JAX
    ``fused_int8`` engine raises too); without quantization there is no
    fused program, and nothing is refused."""
    from fedcrack_tpu.configs import ServeConfig as JaxServeConfig
    from fedcrack_tpu.serve.engine import InferenceEngine as JaxEngine
    from fedcrack_tpu_torch.configs import ServeConfig
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    kw = _serve_kw(quant="int8", kernel_plane=plane)
    with pytest.raises(ValueError) as got:
        InferenceEngine(port_config(C6_LAYOUTS), ServeConfig(**kw), device="cpu")
    assert str(got.value) == (f"kernel_plane={plane!r} supports only the reference parameter layouts "
                              "(kernels/forward.py); got stem_layout='s2d' res_layout='packed'")
    if plane == "fused_int8":
        with pytest.raises(ValueError) as want:
            JaxEngine(jax_config(C6_LAYOUTS), JaxServeConfig(**kw))
        assert str(got.value) == str(want.value)
    for stem, res in (("s2d", "reference"), ("reference", "packed")):
        with pytest.raises(ValueError, match="reference parameter layouts"):
            InferenceEngine(port_config(dict(TINY_KW, stem_layout=stem, res_layout=res)), ServeConfig(**kw),
                            device="cpu")
    InferenceEngine(port_config(C6_LAYOUTS), ServeConfig(**_serve_kw()), device="cpu")
