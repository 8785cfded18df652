"""Input data: synthetic fixtures, image-directory decoding and batching,
the uint8 transport encoding, and client sharding (the counterpart of
``fedcrack_tpu.data``; ``SamplePool`` comes with the multi-client rounds,
ROADMAP Queue 1 item 4)."""

from fedcrack_tpu_torch.data.pipeline import (  # noqa: F401
    ArrayDataset,
    CrackDataset,
    as_model_batch,
    dataset_from_source,
    list_pairs,
    load_example,
    normalize_images,
    reference_split,
)
from fedcrack_tpu_torch.data.sharding import partition_iid, partition_skew  # noqa: F401
from fedcrack_tpu_torch.data.synthetic import synth_crack_batch, write_synthetic_dataset  # noqa: F401
