"""Local training: train/eval steps, the per-round fit, the round adapter."""
