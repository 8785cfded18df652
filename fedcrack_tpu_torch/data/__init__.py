"""Input data: synthetic fixtures, image-directory decoding and batching,
the uint8 transport encoding, client sharding, and the slot plane's data:
the resident ``SamplePool`` and ``split_epoch_slab`` (the counterpart of
``fedcrack_tpu.data``)."""

from fedcrack_tpu_torch.data.pipeline import (  # noqa: F401
    ArrayDataset,
    CrackDataset,
    SamplePool,
    as_model_batch,
    dataset_from_source,
    list_pairs,
    load_example,
    normalize_images,
    reference_split,
    split_epoch_slab,
    to_uint8_transport,
)
from fedcrack_tpu_torch.data.sharding import partition_iid, partition_skew  # noqa: F401
from fedcrack_tpu_torch.data.synthetic import synth_crack_batch, write_synthetic_dataset  # noqa: F401
