"""Attention ops in plain PyTorch and their hand-written CUDA kernels.

``causal_dot_product`` is the public op (``ops/dispatch.py``), as
``orion_tpu.ops.causal_dot_product`` is in the JAX package. The submodules
keep their names: ``from orion_tpu_torch.ops import linear_attention`` is
the module, not a function re-exported over it.
"""

from orion_tpu_torch.ops.dispatch import causal_dot_product

__all__ = ["causal_dot_product"]
