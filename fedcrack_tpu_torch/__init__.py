"""PyTorch / CUDA port of fedcrack_tpu for NVIDIA Hopper (H100).

The JAX package ``fedcrack_tpu`` stays the reference; this package mirrors
its layout (``configs``, ``data``, ``ops``, ``models``, ``kernels``,
``serve``, ``train``, ``fed``, ``health``, ``compress``, ``transport``,
``obs``, ``native``) and imports neither JAX nor anything of
``fedcrack_tpu``. Entry points run on ``torch.device("cuda")`` unless
given another device. This module imports nothing, so the port imports
without ``grpc``, which only ``transport`` needs.
"""
