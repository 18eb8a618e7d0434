"""Exact softmax attention: full, causal and sliding-window. The port's
counterpart of ``orion_tpu/ops/softmax_attention.py``.

- ``softmax_attention_xla`` -- the plain materializing form (the JAX
  package's XLA path, by its name there): fp32 scores with q scaled in fp32
  before the product, -1e30 masking, output in the input dtype;
- ``softmax_attention`` -- the dispatching op the model calls: the flash
  kernels (``ops/kernels/flash_attention.py``) where ``ops/dispatch.py``
  resolves the backend to ``"cuda"`` (CUDA tensors, ``backend="auto"``),
  the plain form otherwise; an explicit ``mask`` always takes the plain
  form, as in the JAX package;
- ``cached_attention`` -- one decode step's query over a KV cache, plain
  torch (plain XLA in the reference).

Conventions: q, k, v are per-head [..., T, D]; ``window=w`` means query t
attends to keys s in (t - w, t].
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.ops.dispatch import resolve

Tensor = torch.Tensor

_NEG = -1e30  # large negative instead of -inf: keeps all-masked rows NaN-free


def _build_mask(
    t_q: int, t_k: int, causal: bool, window: Optional[int], offset: int = 0, device=None,
) -> Optional[Tensor]:
    """Boolean [Tq, Tk] mask (True = attend). ``offset`` shifts query rows,
    for queries placed at the end of a longer key sequence."""
    if not causal and window is None:
        return None
    row = torch.arange(t_q, device=device)[:, None] + offset
    col = torch.arange(t_k, device=device)[None, :]
    m = torch.ones(t_q, t_k, dtype=torch.bool, device=device)
    if causal:
        m &= row >= col
    if window is not None:
        m &= (row - col) < window
    return m


def softmax_attention_xla(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, mask: Optional[Tensor] = None,
    scale: Optional[float] = None,
) -> Tensor:
    """Materializing softmax attention. ``mask``: optional boolean,
    broadcastable to [..., Tq, Tk] (True = attend), combined with the
    causal / window mask; a key-padding mask [..., Tk] is broadcast over
    queries."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    scores = qf @ k.float().transpose(-1, -2)
    m = _build_mask(q.shape[-2], k.shape[-2], causal, window, device=q.device)
    if mask is not None:
        if mask.dim() < 2 or mask.shape[-2] not in (1, q.shape[-2]):
            mask = mask[..., None, :]
        m = mask if m is None else (m & mask)
    if m is not None:
        scores = torch.where(m, scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    return (p @ v.float()).to(q.dtype)


def softmax_attention(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, mask: Optional[Tensor] = None,
    scale: Optional[float] = None, backend: str = "auto",
) -> Tensor:
    """Dispatching softmax attention: the flash kernels for the "cuda"
    backend, the plain form for "torch"; an explicit ``mask`` forces the
    plain form (the kernels cover the structural causal / window masks
    only). Differentiable on either backend."""
    if mask is None and resolve(backend, q.device) == "cuda":
        from orion_tpu_torch.ops.kernels import flash_attention as fa

        return fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                  backend="cuda")
    return softmax_attention_xla(q, k, v, causal=causal, window=window, mask=mask, scale=scale)


def cached_attention(
    q: Tensor, k_cache: Tensor, v_cache: Tensor, valid: Tensor, *,
    scale: Optional[float] = None,
) -> Tensor:
    """One query over a KV cache. q: [..., D]; caches: [..., S, D]; valid:
    boolean [..., S] marking filled slots (the growing full cache or the
    sliding-window ring, whose slot order is not time order: softmax does
    not care about the order of the keys)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    scores = (k_cache.float() @ qf[..., None])[..., 0]
    scores = torch.where(valid, scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    # p.V as a product and a sum, not a batched matmul, whose rounding of a
    # row follows the batch count (q.K's batched product keeps its rows)
    out = (p[..., :, None] * v_cache.float()).sum(dim=-2)
    return out.to(q.dtype)


__all__ = ["softmax_attention", "softmax_attention_xla", "cached_attention"]
