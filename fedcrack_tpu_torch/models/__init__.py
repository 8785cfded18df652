"""The residual U-Net and its weight carry-over from flax."""
