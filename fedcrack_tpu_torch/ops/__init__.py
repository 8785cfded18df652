"""Tensor ops shared by the model and the fused forward."""
