"""Kernels: hand-written CUDA (csrc/) with plain PyTorch versions beside them."""
