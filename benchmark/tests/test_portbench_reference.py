"""The plain reference against the port's CPU path at a small size."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.inputs import images, weights
from benchmark.reference import fed, resunet, tiles
from fedcrack_tpu_torch.configs import ModelConfig, ServeConfig
from fedcrack_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from fedcrack_tpu_torch.models.resunet import ResUNet
from fedcrack_tpu_torch.ops.bce import fused_segmentation_metrics
from fedcrack_tpu_torch.serve.engine import InferenceEngine
from fedcrack_tpu_torch.serve.quant import quantize_for_plane
from fedcrack_tpu_torch.train.local import TrainState, make_optimizer, train_step

SMALL = dict(stem_features=8, encoder_features=(16, 16, 16), decoder_features=(16, 16, 16, 8))
WIDTHS = dict(SMALL, in_channels=3, num_classes=1)


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def port_model(variables, size):
    return from_flax_variables(numpy_tree(variables), ResUNet(ModelConfig(img_size=size, **SMALL), device="cpu"))


def worst_change_gap(start, port, ref, first_grad):
    """The worst leaf's gap between the norms of the port's and the
    reference's change from ``start``, against the larger of the
    reference's norm of that leaf and of the median leaf, over every
    running statistic and the parameters whose first gradient is not
    nought to rounding (a conv bias before a batch-statistics BatchNorm
    moves under Adam by round-off alone): the cells' own measure."""
    grads = {p: float(g.norm()) for p, g in first_grad.items()}
    floor = 1e-3 * float(np.median(list(grads.values())))
    gaps = {}
    for path, t in fed._leaves(ref):
        if path[0] == "batch_stats" or grads[path[1:]] >= floor:
            s = resunet.get(start, path)
            gaps[path] = (float((torch.as_tensor(resunet.get(port, path)) - s).norm()), float((t - s).norm()))
    median = float(np.median([r for _, r in gaps.values()]))
    return max(abs(p - r) / max(r, median) for p, r in gaps.values())


@pytest.fixture
def batch():
    imgs, masks = images.crack_images(4, 32, 32, 11, "cpu")
    return imgs.float() / 255.0, masks.float()


def test_eval_forward_equals_the_port(batch):
    v = weights.draw_variables(3, WIDTHS, "cpu")
    x, _ = batch
    with torch.no_grad():
        ours, _ = resunet.forward(v, x)
        theirs = port_model(v, 32)(x)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_train_forward_and_loss_equal_the_port(batch):
    v = weights.draw_variables(4, WIDTHS, "cpu")
    x, y = batch
    model = port_model(v, 32)
    model.train()
    theirs = model(x)
    ours, stats = resunet.forward(v, x, train=True)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)
    loss = F.binary_cross_entropy_with_logits(ours, y)
    torch.testing.assert_close(loss, fused_segmentation_metrics(theirs, y, pos_weight=1.0)["loss"], rtol=1e-5,
                               atol=0)
    new = to_flax_variables(model)["batch_stats"]
    for name, s in stats.items():
        torch.testing.assert_close(s["mean"], torch.as_tensor(new[name]["mean"]), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s["var"], torch.as_tensor(new[name]["var"]), rtol=1e-4, atol=1e-5)


def test_two_adam_steps_equal_the_port():
    v = weights.draw_variables(5, WIDTHS, "cpu")
    imgs, masks = images.crack_images(8, 32, 32, 12, "cpu")
    imgs, masks = imgs.view(2, 4, 32, 32, 3), masks.view(2, 4, 32, 32, 1)
    model = port_model(v, 32)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3), 1e-3)
    anchor = {k: p.detach().clone() for k, p in model.named_parameters()}
    port_losses = [float(train_step(state, (imgs[s], masks[s]), anchor, 0.0, 1.0)[1]["loss"]) for s in range(2)]
    out, losses, grad = fed.client_fit(v, imgs, masks, 1e-3)
    np.testing.assert_allclose(losses, port_losses, rtol=1e-5)
    assert worst_change_gap(v, to_flax_variables(model), out, grad) < 1e-3


def test_tiled_photo_equals_the_port_reference_plane():
    v = weights.draw_variables(6, WIDTHS, "cpu")
    engine = InferenceEngine(ModelConfig(**SMALL), ServeConfig(bucket_sizes=(32,), tile_overlap=8, max_batch=4),
                             device="cpu")
    photo, _ = images.crack_images(1, 48, 80, 13, "cpu")
    theirs = engine.predict_image(engine.prepare(numpy_tree(v)), photo[0].numpy())
    ours = tiles.photo_probabilities(v, photo[0], 32, 8)
    assert tiles.tile_count(48, 80, 32, 8) == engine.n_tiles(48, 80)
    torch.testing.assert_close(ours, torch.from_numpy(theirs), rtol=1e-5, atol=1e-6)


def test_snapped_weights_through_the_fused_plane():
    v = weights.snap_to_int8_grid(weights.draw_variables(7, WIDTHS, "cpu"))
    engine = InferenceEngine(ModelConfig(**SMALL), ServeConfig(bucket_sizes=(32,), tile_overlap=8, max_batch=4, quant="int8",
                                                                kernel_plane="fused_int8"), device="cpu")
    payload = engine.prepare_quantized(quantize_for_plane(v, "fused_int8"))
    imgs, _ = images.crack_images(3, 32, 32, 14, "cpu")
    theirs = engine.predict_bucket(payload, imgs.numpy())
    torch.testing.assert_close(resunet.probabilities(v, imgs), torch.from_numpy(theirs), rtol=0, atol=1e-6)


def test_round_equals_the_port_round():
    from fedcrack_tpu_torch.parallel.fedavg_mesh import build_federated_round
    from fedcrack_tpu_torch.parallel.slots import make_mesh

    v = weights.draw_variables(8, WIDTHS, "cpu")
    imgs, masks = images.crack_images(16, 32, 32, 15, "cpu")
    imgs, masks = imgs.view(2, 2, 4, 32, 32, 3), masks.view(2, 2, 4, 32, 32, 1)
    n = np.array([8.0, 8.0], np.float32)
    mesh = make_mesh(2, 1, device="cpu")
    round_fn = build_federated_round(mesh, ModelConfig(img_size=32, **SMALL), learning_rate=1e-3)
    theirs, metrics = round_fn(numpy_tree(v), imgs.numpy(), masks.numpy(), np.ones(2, np.float32), n)
    ours, losses, grad = fed.fedavg_round(v, imgs, masks, n, 1e-3)
    np.testing.assert_allclose(np.mean(losses, axis=1), metrics["loss"].numpy(), rtol=1e-5)
    assert worst_change_gap(v, theirs, ours, grad[0]) < 1e-3


def test_tf32_rounding():
    x = torch.randn(10_000) * 100
    r = resunet.round_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(resunet.round_tf32(r), r)
