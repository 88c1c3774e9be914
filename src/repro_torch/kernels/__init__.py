"""CUDA kernels for Hopper (``csrc/``) with their plain PyTorch versions."""
