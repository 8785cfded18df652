"""``tools/profile_step.py`` and ``tools/ab_bce.py`` of the port on the CPU,
held to the JAX tools' flags and artifact schemas.

- ``profile_step.main(..., "--device", "cpu")`` writes the JAX artifact's
  keys, with ``hlo_stats`` as ``kernel_stats`` and ``xplane_files`` as
  ``trace_files``; the CPU window holds no CUDA kernel, so
  ``kernel_stats`` is None, as the JAX tool's is on a CPU trace. The JAX
  keys are read from its source with ``ast`` (running the JAX tool takes
  minutes of compiles).
- The category aggregation, a pure function, over synthetic kernel
  records with the names the card's profiler gives.
- ``ab_bce``: the JAX harness smoke's schema with the plain arm; the cuda
  arm refuses the CPU with ``ValueError``; no environment variable moves.
- Both tools' parsers carry the JAX tools' flags and defaults.
"""

import ast
import json
import os

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_profile_keys() -> tuple[set, set]:
    """The JAX profile_step artifact's top-level and ``measured`` keys."""
    with open(os.path.join(ROOT, "fedcrack_tpu", "tools", "profile_step.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_profile")
    out = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    measured = next(v for k, v in zip(out.keys, out.values) if k.value == "measured")
    extra = {n.targets[0].slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Subscript) and isinstance(n.targets[0].value, ast.Subscript)}
    return _dict_keys(out), _dict_keys(measured) | extra


def _environ_after_torch_imports() -> dict:
    """``os.environ`` once torch's lazy imports have run: the first
    ``torch.optim.Adam`` imports ``torch._dynamo``, which sets
    ``TORCHINDUCTOR_CACHE_DIR`` once per process, whoever builds the
    optimizer. Taken after that, a change is the tool's own."""
    import torch

    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    return dict(os.environ)


def _parser_actions(parser):
    return {a.dest: (a.default, a.type) for a in parser._actions if a.dest != "help"}


def _jax_parser(module: str):
    """The JAX tool's flags, from the ``p.add_argument`` calls in ``main``."""
    with open(os.path.join(ROOT, "fedcrack_tpu", "tools", f"{module}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for call in ast.walk(fn):
        if isinstance(call, ast.Call) and getattr(call.func, "attr", None) == "add_argument":
            name = call.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in call.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            flags[name] = (default, kw["type"].id if "type" in kw else None)
    return flags


@pytest.mark.parametrize("module,port", [("profile_step", "profile_step"), ("ab_pallas_bce", "ab_bce")])
def test_parsers_carry_the_jax_flags_and_defaults(module, port):
    import importlib

    tool = importlib.import_module(f"fedcrack_tpu_torch.tools.{port}")
    got = _parser_actions(tool.build_parser())
    want = _jax_parser(module)
    if port == "ab_bce":
        # The arms are named after the port's routes, the kernel first.
        assert want.pop("impls") == ("pallas,jnp", None) and got.pop("impls") == ("cuda,plain", None)
    assert got.pop("device") == (None, None)
    assert {k: (d, t.__name__ if t else None) for k, (d, t) in got.items()} == want


def test_profile_step_on_the_cpu(tmp_path):
    from fedcrack_tpu.configs import ModelConfig as JaxConfig
    from fedcrack_tpu.obs.flops import train_step_flops

    from fedcrack_tpu_torch.tools import profile_step

    out = tmp_path / "prof.json"
    trace_dir = tmp_path / "trace"
    argv = ["--img", "32", "--steps", "2", "--batch", "2", "--rounds", "1", "--dtype", "float32",
            "--device", "cpu", "--trace-dir", str(trace_dir), "--out", str(out)]
    assert profile_step.main(argv) == 0
    art = json.loads(out.read_text())
    top, measured = _jax_profile_keys()
    renamed = (top - {"hlo_stats", "xplane_files"}) | {"kernel_stats", "trace_files"}
    assert set(art) == renamed
    # profiled_device_s_per_round needs device kernels; the CPU has none.
    assert set(art["measured"]) == measured - {"profiled_device_s_per_round"}
    assert art["measured"]["round_wall_s_median"] > 0
    assert art["trace_files"] and all(os.path.getsize(p) > 0 for p in art["trace_files"])
    assert all(os.path.dirname(p) == str(trace_dir) for p in art["trace_files"])
    assert art["kernel_stats"] is None and art["measured"]["naive_mfu"] is None
    assert art["measured"]["flops_per_step"] == train_step_flops(JaxConfig(img_size=32), 2)
    assert art["hardware"]["platform"] == "cpu"
    assert art["workload"] == {"img_size": 32, "dtype": "float32", "steps": 2, "batch": 2, "profiled_rounds": 1}


def test_kernel_stats_by_category():
    from fedcrack_tpu_torch.obs.metrics import LEAD_KERNEL
    from fedcrack_tpu_torch.tools.profile_step import aggregate_kernel_stats, kernel_category

    records = [
        ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32", 900.0, 40),
        ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_nhwckrsc_nchw", 700.0, 40),
        ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>", 50.0, 20),
        ("void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_kernel<float>", 120.0, 8),
        ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)"
         "::TensorListMetadata<4>, at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float, 4, 4, 0>>",
         200.0, 30),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float>>>",
         150.0, 60),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", 300.0, 900),
        ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
         "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>>", 80.0, 100),
        ("Memcpy DtoH (Device -> Pinned)", 2.0, 1),
        ("void max_pool_forward_nhwc<float, float>", 30.0, 8),
        ("bce_sums_kernel(float const*, float const*, float*, int*, float*, long long)", 3.5, 16),
        ("ampere_sgemm_32x32_sliced1x4_nn", 10.0, 4),
        ("nvjet_tst_512x64_64x2_2x1_v_ssched_bz_coopB_NNN", 5.0, 2),
        ("some_kernel_nobody_names", 1.0, 1),
    ]
    stats = aggregate_kernel_stats(records, top_n=5)
    cats = stats["by_category"]
    assert abs(sum(c["fraction"] for c in cats.values()) - 1.0) < 0.02
    assert stats["total_self_time_us"] == pytest.approx(sum(us for _, us, _ in records), abs=0.1)
    assert cats["port_kernels"] == {"self_time_us": 3.5, "occurrences": 16, "fraction": round(3.5 / 2551.5, 4)}
    assert cats["convolution"]["occurrences"] == 88 and cats["copy_memset"]["occurrences"] == 121
    assert cats["optimizer"]["occurrences"] == 30 and cats["reduction"]["occurrences"] == 60
    assert cats["pooling"]["occurrences"] == 8 and cats["gemm"]["occurrences"] == 6
    assert cats["elementwise"]["occurrences"] == 900 and cats["other"]["occurrences"] == 1
    assert list(cats) == sorted(cats, key=lambda k: -cats[k]["self_time_us"])
    assert [op["self_time_us"] for op in stats["top_ops"]] == [900.0, 700.0, 300.0, 200.0, 150.0]
    assert {"name", "category", "self_time_us", "occurrences", "self_time_percent"} == set(stats["top_ops"][0])
    # The window's lead kernels never reach the records (obs.metrics.card_kernels
    # leaves them out); were one named, it would be "other", not a category.
    assert kernel_category(f"void at::cuda::{LEAD_KERNEL}(long)") == "other"
    assert aggregate_kernel_stats([], 5) is None


def test_card_kernels_leave_out_the_lead_and_user_annotations():
    from torch.autograd import DeviceType

    from fedcrack_tpu_torch.obs.metrics import LEAD_KERNEL, card_kernels

    class Row:
        def __init__(self, key, device_type, is_user_annotation=False):
            self.key, self.device_type, self.is_user_annotation = key, device_type, is_user_annotation

    class Prof:
        def key_averages(self):
            return [Row(f"void at::cuda::{LEAD_KERNEL}(long)", DeviceType.CUDA), Row("bce_sums_kernel", DeviceType.CUDA),
                    Row("aten::add", DeviceType.CPU), Row("Optimizer.step#Adam.step", DeviceType.CUDA, True)]

    assert [r.key for r in card_kernels(Prof())] == ["bce_sums_kernel"]


def test_ab_bce_plain_arm_on_the_cpu(tmp_path):
    from fedcrack_tpu_torch.tools import ab_bce

    before = _environ_after_torch_imports()
    out = tmp_path / "ab.json"
    argv = ["--impls", "plain", "--sizes", "32", "--steps", "2", "--batch", "2", "--reps", "1", "--fit-factor", "2",
            "--dtype", "float32", "--device", "cpu", "--out", str(out)]
    assert ab_bce.main(argv) == 0
    art = json.loads(out.read_text())
    assert set(art) == {"generated_by", "hardware", "workload", "points"}
    point = art["points"]["float32_32"]
    pts = point["impls"]
    assert all(isinstance(v, dict) for v in pts.values())
    assert set(pts["plain"]) == {"round_s_short", "round_s_long", "per_step_ms", "mfu"}
    assert pts["plain"]["round_s_short"] > 0 and pts["plain"]["round_s_long"] > 0
    assert pts["plain"]["mfu"] is None  # no peak for a CPU
    assert "speedup_first_over_second" not in point  # one arm
    assert art["workload"]["impls"] == ["plain"] and art["workload"]["fit_factor"] == 2
    assert dict(os.environ) == before


def test_ab_bce_cuda_arm_refuses_the_cpu(tmp_path):
    from fedcrack_tpu_torch.tools import ab_bce

    before = _environ_after_torch_imports()
    argv = ["--impls", "cuda,plain", "--sizes", "32", "--steps", "2", "--batch", "2", "--device", "cpu",
            "--out", str(tmp_path / "ab.json")]
    with pytest.raises(ValueError, match="CUDA device"):
        ab_bce.main(argv)
    with pytest.raises(ValueError, match="unknown impl"):
        ab_bce.main(["--impls", "jnp", "--device", "cpu", "--out", str(tmp_path / "ab.json")])
    assert not (tmp_path / "ab.json").exists()
    assert dict(os.environ) == before


def test_the_arms_agree_on_a_step():
    """The two arms' metrics functions on the same logits and mask (the
    cuda arm's ``fused_segmentation_metrics`` takes the plain version on a
    CPU tensor, so here the same sums go through two gradient paths:
    ``BceSums``'s analytic backward and autograd through the plain
    version): equal metrics, and gradients that agree to float32 rounding
    (Adam's first step would turn a rounding-level difference of a
    BatchNorm-fed bias's zero gradient into one of up to the learning rate,
    so the weights after the step are not compared)."""
    import numpy as np
    import torch

    from fedcrack_tpu_torch.configs import ModelConfig
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics
    from fedcrack_tpu_torch.tools.ab_bce import plain_segmentation_metrics
    from fedcrack_tpu_torch.train.local import create_train_state, snapshot_params, train_step
    from torch_port_helpers import TINY_KW

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(0, 1, (2, 32, 32, 1)) > 0.8).astype(np.float32))
    runs = []
    for fn in (fused_segmentation_metrics, plain_segmentation_metrics):
        state = create_train_state(torch.Generator().manual_seed(0), ModelConfig(**TINY_KW), device="cpu")
        grads = {}

        def keep(model, grads=grads):
            grads.update({k: p.grad.detach().clone() for k, p in model.named_parameters()})

        _, metrics = train_step(state, (images, masks), snapshot_params(state), pos_weight=3.0,
                                after_backward=keep, metrics_fn=fn)
        runs.append(({k: float(v) for k, v in metrics.items()}, grads))
    (m_a, g_a), (m_b, g_b) = runs
    assert m_a == m_b
    scale = max(float(g.abs().max()) for g in g_a.values())
    for k in g_a:
        torch.testing.assert_close(g_a[k], g_b[k], rtol=1e-4, atol=1e-6 * scale, msg=k)
