"""Deterministic seeding: one root seed per run, every stream derived by a
named fold -- init, dropout, data, sampling and eval never share a stream.

The port's counterpart of ``orion_tpu/utils/rng.py``: the same functions,
and ``stream`` folds in the same sha256 hash of the name. The values are
64-bit integer seeds for ``torch.Generator`` (``generator``), derived with
the splitmix64 finalizer, not threefry keys: they are deterministic within
the port and cannot match the JAX package's random numbers.

On the device, a counter key is a pair of 32-bit words (an int64 tensor
[..., 2], each word in [0, 2^32)): ``key_words`` splits a seed into one,
``fold_keys`` folds integers into a batch of them, and ``counter_bits``
draws uniform 32-bit words from them through the JAX package's counter hash
(``orion_tpu.training.trainer._sr_noise_bits``: a Weyl sequence through the
murmur3 finalizer, salted by the two words). Everything is elementwise over
the leading axes, so row b of a batch depends on row b's key alone, and the
int64 arithmetic runs in 16-bit halves, so nothing overflows.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

Tensor = torch.Tensor

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


_U32 = 0xFFFFFFFF


def key_words(seed: int) -> Tuple[int, int]:
    """A 64-bit seed as two 32-bit key words, high then low (the layout of
    a threefry key made from that seed)."""
    return (seed >> 32) & _U32, seed & _U32


def _mul32(h: Tensor, c: int) -> Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant, in
    two 16-bit halves of h so that no int64 product overflows."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _fmix32(h: Tensor) -> Tensor:
    """murmur3's 32-bit finalizer on int64 words in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold_keys(keys: Tensor, data) -> Tensor:
    """keys [..., 2] with the integers ``data`` (broadcast over the leading
    axes, each taken mod 2^32) folded in -> new keys [..., 2]: the device
    counterpart of ``fold``, elementwise over the rows."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _U32
    k0 = _fmix32(keys[..., 0] ^ _fmix32(_mul32(data, 0x9E3779B9) ^ 0x7F4A7C15))
    k1 = _fmix32(((keys[..., 1] + _mul32(k0, 0x85EBCA6B)) & _U32) ^ data)
    return torch.stack([k0, k1], dim=-1)


def counter_bits(keys: Tensor, n: int) -> Tensor:
    """keys [..., 2] -> n uniform 32-bit words for each key, [..., n] (int64
    in [0, 2^32)): word i of a key is the JAX package's counter hash of i
    salted by the key's two words."""
    k0, k1 = keys[..., 0, None], keys[..., 1, None]
    h = (_mul32(torch.arange(n, dtype=torch.int64, device=keys.device), 0x9E3779B9) + k0) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B) ^ k1
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _as_i32(x):
    """32-bit words (a Python int or an int64 tensor in [0, 2^32)) as the
    int32 values with their bits."""
    if isinstance(x, int):
        return x - (1 << 32) if x >= 1 << 31 else x
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _xor_shr(h: Tensor, s: int) -> Tensor:
    """h ^ (h >>> s) in place, on int32 words (torch's >> is arithmetic, so
    the shifted-in sign bits are masked off)."""
    t = h >> s
    t &= (1 << (32 - s)) - 1
    h ^= t
    return h


def counter_below(keys: Tensor, n: int, bound: int) -> Tensor:
    """keys [..., 2] -> bool [..., n]: word i of ``counter_bits(keys, n)``
    below ``bound`` (in [0, 2^32)). The same hash on int32 words (products
    wrap mod 2^32, shifts masked, the compare offset by 2^31 to order the
    words unsigned, every step in place but the shifts): the same mask at
    a fraction of the int64 form's bytes."""
    k0, k1 = _as_i32(keys[..., 0, None]), _as_i32(keys[..., 1, None])
    h = _as_i32(_mul32(torch.arange(n, dtype=torch.int64, device=keys.device), 0x9E3779B9)) + k0
    _xor_shr(h, 16)
    h *= _as_i32(0x85EBCA6B)
    h ^= k1
    _xor_shr(h, 13)
    h *= _as_i32(0xC2B2AE35)
    _xor_shr(h, 16)
    h ^= _as_i32(1 << 31)
    return h < bound - (1 << 31)


__all__ = ["root_key", "stream", "at_step", "fold", "generator", "key_words", "fold_keys",
           "counter_bits", "counter_below"]
