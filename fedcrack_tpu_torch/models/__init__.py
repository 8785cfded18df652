"""The residual U-Net and its weight carry-over from flax."""

from fedcrack_tpu_torch.models.resunet import ResUNet, depth_to_space, space_to_depth

__all__ = ["ResUNet", "depth_to_space", "space_to_depth"]
