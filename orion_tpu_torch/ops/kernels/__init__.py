"""Wrappers, builds and plain versions of the CUDA kernels in ``csrc/``."""
