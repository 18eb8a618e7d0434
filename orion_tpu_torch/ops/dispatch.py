"""Backend choice for the port's kernel-backed ops, and the public op
``causal_dot_product``.

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


def causal_dot_product(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    backend: str = "auto",
    chunk: Optional[int] = None,
    return_state: bool = False,
    initial_state: Optional[torch.Tensor] = None,
):
    """``out[t] = sum_{s<=t} (q_t . k_s) v_s`` (+ ``q_t . S0`` for a
    carried-in ``initial_state`` [..., Dk, Dv]) on the chosen backend: the
    counterpart of ``orion_tpu/ops/dispatch.py::causal_dot_product``.

    q, k [..., T, Dk], v [..., T, Dv], any batch dims and any T. Returns out
    [..., T, Dv] in q's dtype, and with ``return_state`` also the final S =
    S0 + sum_s k_s (x) v_s [..., Dk, Dv] in fp32. Differentiable through q,
    k, v, ``initial_state`` and the returned state on either backend:
    ``"cuda"`` runs the kernels (``ops/kernels/causal_dot.py``; with grad
    enabled and an input that requires it, through ``CausalDotProductFn``,
    whose backward runs the kernels too); ``"torch"`` the plain chunked form
    (``ops/linear_attention.py``, differentiated by autograd), whose chunk
    ``chunk`` sets; ``"auto"`` picks by device (``resolve``).
    """
    from orion_tpu_torch.ops.kernels import causal_dot
    from orion_tpu_torch.ops.linear_attention import causal_dot_product_chunked

    if resolve(backend, q.device) == "torch":
        return causal_dot_product_chunked(
            q, k, v, chunk=resolve_chunk(chunk), return_state=return_state,
            initial_state=initial_state)
    batch_shape = q.shape[:-2]
    t, dk, dv = q.shape[-2], q.shape[-1], v.shape[-1]
    qf = q.reshape(-1, t, dk).contiguous()
    kf = k.reshape(-1, t, dk).contiguous()
    vf = v.reshape(-1, t, dv).contiguous()
    s0 = None
    if initial_state is not None:
        s0 = initial_state.float().reshape(-1, dk, dv).contiguous()
    if torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (qf, kf, vf, s0)
    ):
        out, sf = causal_dot.CausalDotProductFn.apply(qf, kf, vf, s0)
    else:
        out, sf = causal_dot.causal_dot_cuda(qf, kf, vf, s0)
    out = out.reshape(*batch_shape, t, dv)
    if return_state:
        return out, sf.reshape(*batch_shape, dk, dv)
    return out


__all__ = ["DEFAULT_CHUNK", "causal_dot_product", "resolve", "resolve_chunk"]
