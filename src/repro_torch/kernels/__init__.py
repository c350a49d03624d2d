"""The port's kernels: hand-written CUDA for sm_90a (``csrc/``), each with a
plain PyTorch version beside it, dispatched through ``registry.py``."""
