"""Hand-written CUDA kernels (csrc/) and the fused forward built on them."""
