"""orion_tpu_torch: the PyTorch/CUDA port of ``orion_tpu``.

A package of its own beside the JAX package, which stays the reference: the
same model configs and parameter layout, held against the JAX functions on
the CPU by ``tests/test_torch_*.py``, with the TPU's Pallas kernels rewritten
by hand for Hopper (``csrc/``). It imports torch, numpy and the standard
library, and nothing of JAX or of ``orion_tpu``.

Ported so far, for the all-linear-attention models: the generate path
(``python -m orion_tpu_torch.generate``), with prefill through the fused
linear-attention kernel ``csrc/causal_dot_norm.cu``; and the training path
(``python -m orion_tpu_torch.train``), with every linear layer's backward
through the two kernels of ``csrc/causal_dot_bwd.cu``.
"""
