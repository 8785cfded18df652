"""One federated-averaging round in plain float32 PyTorch.

Every client starts from the round's global weights with a fresh Adam
(Keras defaults: lr as given, betas 0.9 / 0.999, eps 1e-7 outside the
square root), takes its steps on batches of (image, mask) pairs with the
mean sigmoid binary cross-entropy over the pixels as the loss and
BatchNorm on batch moments, and the new global is the mean of the
clients' parameters and running statistics weighted by their sample
counts (FedAvg).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import resunet


def _leaves(tree: dict, prefix=()) -> list:
    out = []
    for k, v in tree.items():
        out += _leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _tree(pairs) -> dict:
    out: dict = {}
    for path, v in pairs:
        resunet.set_leaf(out, path, v)
    return out


def client_fit(variables: dict, images_u8: torch.Tensor, masks_u8: torch.Tensor, lr: float, *,
               tf32: bool = False) -> tuple[dict, list[float], dict]:
    """``images_u8`` ``[steps, B, H, W, 3]``, ``masks_u8`` ``[steps, B, H,
    W, 1]``. Returns the client's variables, each step's loss and its
    first step's gradient by leaf path."""
    params = [(p, v.detach().clone().requires_grad_(True)) for p, v in _leaves(variables["params"])]
    stats = {k: v for k, v in variables["batch_stats"].items()}
    opt = torch.optim.Adam([v for _, v in params], lr=lr, betas=(0.9, 0.999), eps=1e-7, foreach=False)
    losses, first_grad = [], None
    for s in range(images_u8.shape[0]):
        x = images_u8[s].to(torch.float32) / 255.0
        y = masks_u8[s].to(torch.float32)
        logits, stats = resunet.forward({"params": _tree(params), "batch_stats": stats}, x, train=True, tf32=tf32)
        loss = F.binary_cross_entropy_with_logits(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first_grad is None:
            first_grad = {p: v.grad.detach().clone() for p, v in params}
        opt.step()
        losses.append(float(loss.detach()))
    out = {"params": _tree((p, v.detach()) for p, v in params), "batch_stats": stats}
    return out, losses, first_grad


def fedavg_round(variables: dict, images_u8: torch.Tensor, masks_u8: torch.Tensor, n_samples, lr: float, *,
                 tf32: bool = False) -> tuple[dict, list[list[float]], list[dict]]:
    """``images_u8`` ``[C, steps, B, H, W, 3]``. Returns the new global,
    each client's step losses and each client's first gradient."""
    total = float(sum(n_samples))
    acc = None
    losses, first = [], []
    for c in range(images_u8.shape[0]):
        fitted, client_losses, grad = client_fit(variables, images_u8[c], masks_u8[c], lr, tf32=tf32)
        losses.append(client_losses)
        first.append(grad)
        leaves = _leaves(fitted)
        w = float(n_samples[c]) / total
        acc = [(p, w * v) for p, v in leaves] if acc is None else [(p, a + w * v) for (p, a), (_, v) in
                                                                   zip(acc, leaves)]
    return _tree(acc), losses, first
