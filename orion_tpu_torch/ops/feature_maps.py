"""Kernel feature maps phi(.) for linear attention, in PyTorch.

The port's counterpart of ``orion_tpu/ops/feature_maps.py``. Linear
attention replaces softmax(QK^T)V with phi(Q) (phi(K)^T V), phi mapping
head vectors to a non-negative feature space. The maps are elementwise and
run as plain torch ops, in the input's dtype (as the JAX maps do).

Provided: ``elu1`` (default), ``relu``, ``sqrelu``, ``exp`` (computed in
fp32) and ``identity``. ``favor`` (random features) and ``learnable`` are not
ported yet: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_NOT_PORTED = ("favor", "learnable")


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """A named feature map. ``fn`` maps [..., d] -> [..., d]."""

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    out_dim: Optional[int] = None  # None = same as input

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _elu1(x):
    # elu(x) + 1 = exp(x) for x<0, x+1 for x>=0: strictly positive, smooth.
    return F.elu(x) + 1.0


def _relu(x):
    return F.relu(x)


def _sqrelu(x):
    r = F.relu(x)
    return r * r


def _exp(x):
    # a fixed function (no data-dependent shift): prefill and decode must
    # apply the same phi
    return torch.exp(x.float()).to(x.dtype)


_SIMPLE = {
    "elu1": _elu1,
    "relu": _relu,
    "sqrelu": _sqrelu,
    "exp": _exp,
    "identity": lambda x: x,
}
_BUILTIN = frozenset(_SIMPLE)  # protected from re-registration


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"feature map {name!r} is not ported to orion_tpu_torch yet "
        "(ROADMAP.md queue A, item 2)"
    )


def register_feature_map(name: str, fn=None):
    """Register a custom elementwise feature map under ``name`` so a config
    can select it (``ModelConfig(feature_map=name)``). Usable directly or as
    a decorator. The map must be positive-valued (the normalizer q.z must
    stay > 0). Re-registering a built-in name raises; re-registering a
    custom name overwrites it."""

    def install(f):
        if name in _BUILTIN or name in _NOT_PORTED:
            raise ValueError(f"feature map {name!r} is built-in; pick a new name")
        _SIMPLE[name] = f
        return f

    return install if fn is None else install(fn)


def make_feature_map(name: str) -> FeatureMap:
    """Build a feature map by name (built-in or registered)."""
    if name in _NOT_PORTED:
        raise _not_ported(name)
    if name not in _SIMPLE:
        raise ValueError(f"unknown feature map {name!r}; have {sorted(_SIMPLE)}")
    return FeatureMap(name=name, fn=_SIMPLE[name])


__all__ = ["FeatureMap", "make_feature_map", "register_feature_map"]
