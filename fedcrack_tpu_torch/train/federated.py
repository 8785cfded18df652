"""One client's federated round: global weights in, local fit, weights out.

The counterpart of ``fedcrack_tpu.train.federated``. ``make_train_fn``
builds the model once; each round it decodes the round's global blob
against the train state's template, loads it, resets the optimizer (fresh
Adam moments, so bias correction restarts as with ``tx.init`` in the JAX
package, where the reference rebuilt the whole Keras model every round),
runs ``local_epochs`` of training with the received weights as the
FedProx anchor, and hands back the trained weights as a blob and the
sample count that weights this client in FedAvg.

Weights cross between client and server as the JAX package's msgpack blob
of the flax-layout ``{'params', 'batch_stats'}`` tree
(``fed.serialization``), bfloat16-cast on the way up when the server's
in-band config asks for ``wire_dtype="bfloat16"``. With
``config.profile_dir`` each round's fit runs under a ``torch.profiler``
trace; a ``metrics_logger`` gets one ``local_fit`` record per round and,
with its TensorBoard tee on, the trained weights and the round's update
(trained minus received parameters) as histograms.
"""

from __future__ import annotations

from typing import Iterable

import torch

from fedcrack_tpu_torch.configs import SLOT_PLANE_ONLY, FedConfig, SegFormerConfig
from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
from fedcrack_tpu_torch.obs.metrics import profiler_trace, stopwatch
from fedcrack_tpu_torch.train.local import (
    TrainState,
    create_train_state,
    local_fit,
    make_optimizer,
    snapshot_params,
)


def reset_optimizer(state: TrainState) -> TrainState:
    """Fresh Adam moments (and step count) for a new round's local fit."""
    state.optimizer = make_optimizer(state.model.parameters(), state.learning_rate)
    return state


def _tree_sub(a: dict, b: dict) -> dict:
    return {k: _tree_sub(v, b[k]) if isinstance(v, dict) else v - b[k] for k, v in a.items()}


def make_train_fn(
    config: FedConfig,
    dataset: Iterable,
    batch_size: int,
    seed: int = 0,
    device: torch.device | str | None = None,
    metrics_logger=None,
):
    """Returns ``train_fn(blob, round, hparams) -> (blob, n_samples,
    metrics)`` and a holder whose ``"state"`` is the latest
    :class:`TrainState`. The model lives on ``device`` (CUDA unless the
    caller names another; raises where CUDA is asked for and absent).

    ``hparams`` (the server's in-band config map) override the config's
    ``local_epochs``, ``fedprox_mu``, ``pos_weight``, ``learning_rate``
    and ``wire_dtype``."""
    if isinstance(config.model, SegFormerConfig):
        raise ValueError(SLOT_PLANE_ONLY.format(what="the client's fit"))
    state = create_train_state(
        torch.Generator().manual_seed(seed), config.model, config.learning_rate, device
    )
    template = state.variables
    holder = {"state": state}

    def train_fn(blob: bytes, rnd: int, hparams: dict | None = None) -> tuple[bytes, int, dict]:
        hparams = hparams or {}
        epochs = int(hparams.get("local_epochs", config.local_epochs))
        mu = float(hparams.get("fedprox_mu", config.fedprox_mu))
        pos_weight = float(hparams.get("pos_weight", config.pos_weight))
        wire_dtype = str(hparams.get("wire_dtype", config.wire_dtype))
        received = tree_from_bytes(blob, template=template)
        st = holder["state"].replace_variables(received)
        st.learning_rate = float(hparams.get("learning_rate", config.learning_rate))
        st = reset_optimizer(st)
        with profiler_trace(config.profile_dir or None), stopwatch() as timer:
            st, metrics = local_fit(
                st, dataset, epochs=epochs, mu=mu, anchor_params=snapshot_params(st),
                pos_weight=pos_weight,
            )
        holder["state"] = st
        n_samples = int(metrics.pop("num_steps", 0) * batch_size)
        trained = st.variables
        out_blob = tree_to_bytes(trained, cast_dtype="bfloat16" if wire_dtype == "bfloat16" else None)
        if metrics_logger is not None:
            metrics_logger.log(
                "local_fit", round=rnd, wall_clock_s=timer["seconds"], num_samples=n_samples,
                bytes_in=len(blob), bytes_out=len(out_blob), **metrics,
            )
            if metrics_logger.tb_enabled:
                metrics_logger.log_histograms(rnd, trained["params"], prefix="weights")
                update = _tree_sub(trained["params"], received["params"])
                metrics_logger.log_histograms(rnd, update, prefix="round_update")
        return out_blob, n_samples, metrics

    return train_fn, holder
