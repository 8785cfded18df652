"""Faults planted in the timed path, for showing that the correctness
check catches them (``benchmark/tests`` and ``benchmark.calibrate``).

Each is a context manager that patches one entry of the port and restores
it: the serving faults wrap ``InferenceEngine.predict_bucket``, the
training faults wrap the round that ``round_from_config`` builds.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _bucket_fault(change):
    from fedcrack_tpu_torch.serve.engine import InferenceEngine

    def make(original):
        def predict_bucket(self, variables, images):
            return change(self, original(self, variables, images))

        return predict_bucket

    return _patched(InferenceEngine, "predict_bucket", make)


def unchanged_answers():
    """Every batch answered from its output buffer as allocated, never
    written (zeros): a step that returns its state unchanged."""
    import numpy as np

    return _bucket_fault(lambda engine, probs: np.zeros_like(probs))


def half_batch():
    """The lanes past half of the batch left out (zeros)."""
    def change(engine, probs):
        out = probs.copy()
        out[engine.max_batch // 2:] = 0.0
        return out

    return _bucket_fault(change)


def swapped_answer():
    """An answer altered where it is produced: the first two lanes'
    probabilities exchanged."""
    def change(engine, probs):
        if probs.shape[0] < 2:
            return probs
        out = probs.copy()
        out[[0, 1]] = probs[[1, 0]]
        return out

    return _bucket_fault(change)


def _round_fault(wrap):
    from fedcrack_tpu_torch.parallel import fedavg_mesh

    def make(original):
        def round_from_config(cfg, device=None):
            mesh, round_fn = original(cfg, device=device)
            return mesh, wrap(round_fn)

        return round_from_config

    return _patched(fedavg_mesh, "round_from_config", make)


def round_unchanged():
    """The round returns the global it was given."""
    import torch

    def copy(tree, device):
        if isinstance(tree, dict):
            return {k: copy(v, device) for k, v in tree.items()}
        return torch.as_tensor(tree).to(device).clone()

    def wrap(round_fn):
        def faulty(variables, images, masks, active, n_samples):
            new, metrics = round_fn(variables, images, masks, active, n_samples)
            return copy(variables, metrics["loss"].device), metrics

        return faulty

    return _round_fault(wrap)


def round_half_batch():
    """Every step takes the mean over the first half of its batch."""
    def wrap(round_fn):
        def faulty(variables, images, masks, active, n_samples):
            half = images.shape[2] // 2
            return round_fn(variables, images[:, :, :half], masks[:, :, :half], active, n_samples)

        return faulty

    return _round_fault(wrap)


def round_half_clients():
    """The fold leaves out the second half of the clients: the exchange
    between the clients' slots left out."""
    import numpy as np

    def wrap(round_fn):
        def faulty(variables, images, masks, active, n_samples):
            cut = np.asarray(active, np.float32).copy()
            cut[len(cut) // 2:] = 0.0
            return round_fn(variables, images, masks, cut, n_samples)

        return faulty

    return _round_fault(wrap)


SERVING = {"unchanged_answers": unchanged_answers, "half_batch": half_batch, "swapped_answer": swapped_answer}
TRAINING = {"round_unchanged": round_unchanged, "round_half_batch": round_half_batch,
            "round_half_clients": round_half_clients}
