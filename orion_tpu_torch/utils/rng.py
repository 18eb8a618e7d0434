"""Deterministic seeding: one root seed per run, every stream derived by a
named fold -- init, dropout, data, sampling and eval never share a stream.

The port's counterpart of ``orion_tpu/utils/rng.py``: the same functions,
and ``stream`` folds in the same sha256 hash of the name. The values are
64-bit integer seeds for ``torch.Generator`` (``generator``), derived with
the splitmix64 finalizer, not threefry keys: they are deterministic within
the port and cannot match the JAX package's random numbers.
"""

from __future__ import annotations

import hashlib

import torch

_MASK = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    """splitmix64's finalizer on a 64-bit integer."""
    z = (x + _GAMMA) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def root_key(seed: int) -> int:
    return _mix(seed & _MASK)


def fold(key: int, data: int) -> int:
    """A new seed from ``key`` and an integer (``jax.random.fold_in``'s
    role)."""
    return _mix(key ^ _mix(data & _MASK))


def stream(key: int, name: str) -> int:
    """Named substream: fold in a stable hash of the name."""
    h = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    return fold(key, h)


def at_step(key: int, step: int) -> int:
    """Per-step seed."""
    return fold(key, step)


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


__all__ = ["root_key", "stream", "at_step", "fold", "generator"]
