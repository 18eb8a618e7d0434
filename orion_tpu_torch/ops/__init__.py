"""Attention ops in plain PyTorch and their hand-written CUDA kernels."""
