"""The port's fused BCE statistics (fedcrack_tpu_torch/ops/bce.py) and
losses (ops/losses.py) held against the JAX package.

On the CPU the port's ``bce_sums`` takes its plain PyTorch version; the
JAX side runs both its Pallas kernel in the interpreter (``"interpret"``,
as its own tests run it) and its XLA reference (``"jnp"``). The CUDA
kernel is held against the plain version on the card by chip_smoke.py.

Tolerances are the JAX package's own (tests/test_pallas_bce.py): the BCE
lanes within rtol 1e-5, atol 1e-3 (float32 sums of up to 1e5 terms taken
in different orders); the count lanes exact; the metrics dict rtol/atol
1e-5; gradients rtol 1e-5 with atol 1e-6 (logits) and 1e-4 (labels).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

SIZES = [1, 100, 128, 32768, 32769, 100_000]


def _data(n, seed=0, shape=None):
    rng = np.random.RandomState(seed)
    shape = shape or (n,)
    logits = rng.normal(0, 2, shape).astype(np.float32)
    masks = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    return logits, masks


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("n", SIZES)
def test_bce_sums_plain_matches_jax(n, impl):
    from fedcrack_tpu.ops.pallas_bce import bce_sums as jax_bce_sums
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x, y = _data(n, seed=n % 97)
    want = np.asarray(jax_bce_sums(x, y, impl))
    got = bce_sums(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5,)
    got = got.numpy()
    np.testing.assert_array_equal(got[1:4], want[1:4])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("pos_weight", [None, 4.0], ids=["plain", "pw4"])
def test_fused_metrics_match_jax(pos_weight):
    from fedcrack_tpu.ops.pallas_bce import fused_segmentation_metrics as jax_fused
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics

    x, y = _data(0, seed=3, shape=(2, 32, 32, 1))
    want = jax_fused(x, y, impl="interpret", pos_weight=pos_weight)
    got = fused_segmentation_metrics(torch.from_numpy(x), torch.from_numpy(y), pos_weight=pos_weight)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{key} pw={pos_weight}")


@pytest.mark.parametrize("pos_weight", [None, 4.0], ids=["plain", "pw4"])
def test_losses_module_matches_jax(pos_weight):
    import optax

    from fedcrack_tpu.ops import losses as jl
    from fedcrack_tpu_torch.ops import losses as tl

    x, y = _data(0, seed=5, shape=(2, 16, 16, 1))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = jl.segmentation_metrics(x, y, pos_weight=pos_weight)
    got = tl.segmentation_metrics(xt, yt, pos_weight=pos_weight)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(tl.sigmoid_bce_per_pixel(xt, yt).numpy(),
                               np.asarray(optax.sigmoid_binary_cross_entropy(x, y)), rtol=1e-6, atol=1e-6)
    assert float(tl.binary_iou(xt, yt)) == pytest.approx(float(jl.binary_iou(x, y)), rel=1e-6)
    # An empty union (no crack predicted, none present) scores 1.0.
    neg = -np.abs(x)
    zero = np.zeros_like(y)
    assert float(tl.binary_iou(torch.from_numpy(neg), torch.from_numpy(zero))) == 1.0
    assert float(jl.binary_iou(neg, zero)) == 1.0


def _jax_and_port_grads(loss_jax, loss_port, x, y, wrt):
    import jax

    argnum = 0 if wrt == "logits" else 1
    want = np.asarray(jax.grad(loss_jax, argnums=argnum)(x, y))
    xt = torch.from_numpy(x).requires_grad_(wrt == "logits")
    yt = torch.from_numpy(y).requires_grad_(wrt == "labels")
    loss_port(xt, yt).backward()
    return (xt.grad if wrt == "logits" else yt.grad).numpy(), want


@pytest.mark.parametrize("lane", [0, 4], ids=["bce", "pos_bce"])
def test_logit_gradient_matches_jax(lane):
    from fedcrack_tpu.ops.pallas_bce import bce_sums as jax_bce_sums
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x, y = _data(4096, seed=11)
    got, want = _jax_and_port_grads(
        lambda a, b: jax_bce_sums(a, b, "interpret")[lane] / a.size,
        lambda a, b: bce_sums(a, b)[lane] / a.numel(), x, y, "logits")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lane", [0, 4], ids=["bce", "pos_bce"])
def test_label_gradient_matches_jax(lane):
    from fedcrack_tpu.ops.pallas_bce import bce_sums as jax_bce_sums
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x, y = _data(512, seed=5)
    got, want = _jax_and_port_grads(
        lambda a, b: jax_bce_sums(a, b, "interpret")[lane],
        lambda a, b: bce_sums(a, b)[lane], x, y, "labels")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_count_lanes_carry_no_gradient():
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x, y = _data(256, seed=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    bce_sums(xt, torch.from_numpy(y))[1:4].sum().backward()
    assert not xt.grad.any()


def test_pos_weight_gradient_matches_jax():
    import jax.numpy as jnp

    from fedcrack_tpu.ops.pallas_bce import fused_segmentation_metrics as jax_fused
    from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics

    x, y = _data(2048, seed=29)
    got, want = _jax_and_port_grads(
        lambda a, b: jax_fused(a, b, impl="interpret", pos_weight=jnp.float32(5.0))["loss"],
        lambda a, b: fused_segmentation_metrics(a, b, pos_weight=5.0)["loss"], x, y, "logits")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bfloat16_inputs_accumulate_in_f32():
    """Both sides cast the bf16 inputs to float32 before summing, so the
    port's bf16 sums sit within the float32 parity bound of the JAX
    kernel's; the gradient comes back in the input's dtype."""
    import jax.numpy as jnp

    from fedcrack_tpu.ops.pallas_bce import bce_sums as jax_bce_sums
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x, y = _data(8192, seed=7)
    want = np.asarray(jax_bce_sums(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), "interpret"))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got = bce_sums(xt, torch.from_numpy(y).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy()[1:4], want[1:4])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-3)
    got[0].backward()
    assert xt.grad.dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    from fedcrack_tpu_torch.ops import bce

    bce.reset_launch_counts()
    x, y = _data(1000, seed=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(bce.bce_sums(xt, yt).numpy(), bce._bce_sums_plain(xt, yt).numpy())
    bce.fused_segmentation_metrics(xt.requires_grad_(True), yt, pos_weight=2.0)["loss"].backward()
    assert bce.bce_sums.launches == 0


def test_wrapper_validates():
    from fedcrack_tpu_torch.ops.bce import bce_sums

    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        bce_sums(x, torch.zeros(4, 7))  # shapes differ
    with pytest.raises(ValueError):
        bce_sums(torch.zeros(8, 4).t(), x)  # not contiguous
    with pytest.raises(ValueError):
        bce_sums(x, torch.zeros(4, 8, device="meta"))  # devices differ
    with pytest.raises(ValueError):
        bce_sums(torch.zeros(4, 8, device="meta"), torch.zeros(4, 8, device="meta"))
    with pytest.raises(TypeError):
        bce_sums(torch.zeros(4, 8, dtype=torch.complex64), x)
    # Masks of another dtype are cast, as the JAX wrapper casts them.
    y = (torch.arange(32).reshape(4, 8) % 3 == 0)
    np.testing.assert_array_equal(bce_sums(x, y.to(torch.uint8)).numpy(), bce_sums(x, y.float()).numpy())


def test_workspace_is_one_per_stream_under_threads():
    """Threads that ask at once for a stream's workspace all get the same
    one (the check-then-create runs under a lock), a row for each block
    of the kernel's largest grid, with its ticket at 0."""
    import re
    import sys
    import threading
    from pathlib import Path

    from fedcrack_tpu_torch.ops import bce

    source = Path(bce.LIBRARY.source).read_text()
    assert int(re.search(r"MAX_GRID = (\d+);", source).group(1)) == bce.MAX_GRID
    # The only atomic is the unsigned-int ticket: no float atomics in the sums.
    assert re.findall(r"atomic_ref<([\w ]+),", source) == ["unsigned int"]
    assert not re.findall(r"\batomic(Add|Sub|Exch|Min|Max|CAS)\w*\(", source)

    device, stream = torch.device("cpu"), 0x5EED
    got, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(bce._workspace(device, stream)))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
        workspace = bce._workspaces.pop((device.index, stream), None)
    assert not any(t.is_alive() for t in threads) and len(got) == 16
    assert all(ws is workspace for ws in got)
    partials, ticket = workspace
    assert partials.shape == (bce.MAX_GRID, bce.LANES) and partials.dtype == torch.int32
    assert ticket.dtype == torch.int32 and ticket.tolist() == [0]
