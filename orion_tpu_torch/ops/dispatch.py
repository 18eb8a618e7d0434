"""Backend choice for the port's kernel-backed ops.

``resolve`` makes the one choice between a CUDA kernel and its plain
PyTorch version, for linear attention (``ops/linear_attention.py``),
softmax attention (``ops/softmax_attention.py``), the dropless MoE
layer's grouped matmul (``models/moe.py``, ``ops/kernels/gmm.py``), the int4
layers' dequant-matmul (``quant.py``) and the fused Adafactor passes
(``ops/kernels/adafactor.py``) alike. ``"auto"`` takes the
kernel for CUDA tensors and the plain version for CPU tensors, ``"torch"``
the plain version anywhere, ``"cuda"`` the kernel (which raises for CPU
tensors). The JAX package's chunk and block defaults
(``orion_tpu/ops/dispatch.py``, ``attn_block_q`` / ``attn_block_k``) were
tuned for the TPU's matrix unit and are not copied: a kernel's chunk or
tile is a constant of its source, and the plain chunked form takes
``DEFAULT_CHUNK`` unless the caller names one.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.models.configs import BACKENDS

# Plain chunked form's default chunk: equal to the CUDA kernel's own chunk
# (csrc/causal_dot_norm.cu), so the two walk the sequence the same way.
DEFAULT_CHUNK = 64


def resolve(backend: str, device: torch.device) -> str:
    """``"torch"`` (plain version) or ``"cuda"`` (kernel) for tensors on
    ``device``, from a backend name (``"auto" | "torch" | "cuda"``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "torch" if device.type == "cpu" else "cuda"
    return backend


def resolve_chunk(chunk: Optional[int]) -> int:
    """The plain chunked form's chunk: ``chunk`` or ``DEFAULT_CHUNK``."""
    if chunk is None:
        return DEFAULT_CHUNK
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return chunk


__all__ = ["DEFAULT_CHUNK", "resolve", "resolve_chunk"]
