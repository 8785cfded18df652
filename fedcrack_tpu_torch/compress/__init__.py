"""Compressed update transport (the counterpart of
``fedcrack_tpu.compress``, host side): the client codecs and the
CRC-checked wire frame with its server-side decode."""

from fedcrack_tpu_torch.compress.codecs import (
    CODEC_INT8,
    CODEC_NAMES,
    CODEC_NULL,
    CODEC_TOPK,
    Codec,
    DEFAULT_TOPK_FRACTION,
    Int8Codec,
    NullCodec,
    TopKDeltaCodec,
    encoded_bytes_model,
    get_codec,
)
from fedcrack_tpu_torch.compress.frames import (
    FRAME_OVERHEAD_BYTES,
    Frame,
    decode_frame,
    decode_update,
    encode_frame,
    is_frame,
)

__all__ = [
    "CODEC_INT8",
    "CODEC_NAMES",
    "CODEC_NULL",
    "CODEC_TOPK",
    "Codec",
    "DEFAULT_TOPK_FRACTION",
    "FRAME_OVERHEAD_BYTES",
    "Frame",
    "Int8Codec",
    "NullCodec",
    "TopKDeltaCodec",
    "decode_frame",
    "decode_update",
    "encode_frame",
    "encoded_bytes_model",
    "get_codec",
    "is_frame",
]
