"""Rotary position embeddings (RoPE) for the softmax and sliding-window
layers: the port's counterpart of ``orion_tpu/ops/rotary.py``.

Linear-attention layers use learned absolute positions; the softmax and
sliding-window layers of the hybrid family rotate q and k. Pairs are
interleaved (``x[..., 0::2]``, ``x[..., 1::2]``), the rotation runs in fp32
and casts back to the input dtype.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rotary_freqs(head_dim: int, max_t: int, base: float = 10000.0, device=None) -> Tensor:
    """[max_t, head_dim // 2] fp32 angle table: outer(t, 1 / base^(2i / D))."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_t, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """The pair rotation; ``ang`` broadcasts against x's leading dims."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rotary(x: Tensor, angles: Tensor) -> Tensor:
    """Rotate pairs. x: [..., T, D]; angles: [T, D/2] (or broadcastable)."""
    return _rotate(x, angles)


def apply_rotary_at(x: Tensor, angles_table: Tensor, positions) -> Tensor:
    """Decode time: x [..., D] at integer ``positions`` (a scalar, or a
    tensor broadcastable against x's leading dims after the gather)."""
    return _rotate(x, angles_table[positions])


__all__ = ["rotary_freqs", "apply_rotary", "apply_rotary_at"]
