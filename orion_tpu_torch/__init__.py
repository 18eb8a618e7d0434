"""orion_tpu_torch: the PyTorch/CUDA port of ``orion_tpu``.

A package of its own beside the JAX package, which stays the reference: the
same model configs and parameter layout, held against the JAX functions on
the CPU by ``tests/test_torch_*.py``, with the TPU's Pallas kernels rewritten
by hand for Hopper (``csrc/``). It imports torch, numpy and the standard
library, and nothing of JAX or of ``orion_tpu``.

Ported so far, for the linear-attention, hybrid and mixture-of-experts
models: the generate path (``python -m orion_tpu_torch.generate``), with
prefill through the attention kernels (``csrc/causal_dot_norm.cu``,
``csrc/flash_attention.cu``) and a dropless MoE's experts through
``csrc/gmm.cu``, and int8 / int4 quantized serving (``--quant``; the int4
decode products through ``csrc/q4_matmul.cu``); and the training path
(``python -m orion_tpu_torch.train``), with the attention and expert
backward kernels, AdamW, Lion and Adafactor (``adafactor_fused``: the three
passes of ``csrc/adafactor.cu``); checkpoints that ``generate`` and
``evaluate`` load (``--ckpt-dir``; ``export_jax_checkpoint.py`` converts the
JAX package's), the BPE tokenizer and ``prepare_data``; and the public op
``ops.causal_dot_product``, forward and backward on the raw kernels of
``csrc/causal_dot_norm.cu`` and ``csrc/causal_dot_bwd.cu``.
"""
