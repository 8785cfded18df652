"""Several federated clients per round on one device: the slot plane.

The counterpart of ``fedcrack_tpu.parallel``. The JAX package runs a round
as one ``shard_map`` program over ``Mesh(('clients', 'batch'))``, one
client per chip; the port runs the round's client slots on one card in
client order (``parallel.slots.make_mesh``), folds them in that order on
the device, and drives rounds with double-buffered staging
(``parallel.driver``). A client's step splits over an inner ``batch``
axis (sync-BN data parallelism) or, through the spatial plane
(``parallel.spatial``), over image height. A mesh made with ``group=``
spans several processes of a ``torch.distributed`` group
(``parallel.multihost``): a round's clients, or the spatial plane's
bands, split across them, every cross-process sum gathered and added in
client or rank order. ``parallel/mesh.py`` is not ported, by design.
"""

from fedcrack_tpu_torch.parallel.driver import (  # noqa: F401
    NonFiniteRound,
    RoundRecord,
    resident_pool_fits,
    run_cohort_federation,
    run_mesh_federation,
    shuffled_epoch_data,
    stage_round_data,
    stage_round_indices,
)
from fedcrack_tpu_torch.parallel.fedavg_mesh import (  # noqa: F401
    CohortRound,
    SegmentedRound,
    build_federated_cohort_round,
    build_federated_round,
    build_federated_round_segments,
    build_spatial_federated_round,
    mesh_fedavg,
    pad_cohort_axis,
    round_from_config,
    stack_client_data,
)
from fedcrack_tpu_torch.parallel.multihost import (  # noqa: F401
    global_mesh_devices,
    initialize_if_needed,
    is_coordinator,
)
from fedcrack_tpu_torch.parallel.slots import SlotMesh, make_mesh  # noqa: F401
from fedcrack_tpu_torch.parallel.spatial import (  # noqa: F401
    build_spatial_predict,
    build_spatial_train_step,
    halo_exchange,
    make_spatial_mesh,
    spatial_apply,
)
