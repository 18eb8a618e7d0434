"""Kernel feature maps phi(.) for linear attention, in PyTorch.

The port's counterpart of ``orion_tpu/ops/feature_maps.py``. Linear
attention replaces softmax(QK^T)V with phi(Q) (phi(K)^T V), phi mapping
head vectors to a non-negative feature space. The maps are elementwise and
run as plain torch ops, in the input's dtype (as the JAX maps do).

Provided: ``elu1`` (default), ``relu``, ``sqrelu``, ``exp`` (computed in
fp32), ``identity`` and ``favor`` (FAVOR+ positive random features over an
orthogonal Gaussian projection, ``favor_features``; the model keeps its
projection as the parameter ``favor_proj`` and applies ``favor_phi``). The
``learnable`` map (a dense projection, then elu+1) has weights, so it lives
in the attention module (``models/transformer.py``), as in the JAX package;
both names stay reserved in ``register_feature_map``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_RESERVED = ("favor", "learnable")  # special-cased in the attention module


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


def _orthogonal_gaussian(rows: int, cols: int, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """[rows, cols] random matrix: stacked QR-orthogonalized Gaussian blocks,
    each row rescaled to the norm of a Gaussian vector (the FAVOR+
    construction of the JAX package's ``_orthogonal_gaussian``; torch draws
    its own numbers from ``generator``)."""
    n_blocks = -(-rows // cols)  # ceil
    blocks = []
    for _ in range(n_blocks):
        g = torch.randn(cols, cols, generator=generator, device=device)
        q, _ = torch.linalg.qr(g)
        blocks.append(q)
    w = torch.cat(blocks, dim=0)[:rows]
    norms = torch.randn(rows, cols, generator=generator, device=device).square().sum(
        dim=-1, keepdim=True).sqrt()
    return w * norms


def favor_phi(x: torch.Tensor, w: torch.Tensor, stabilizer: float = 0.0) -> torch.Tensor:
    """FAVOR+ features of x [..., d] over the projection w [m, d]: with
    x' = x / d^(1/4), ``exp(w_i . x' - |x'|^2 / 2 - stabilizer) / sqrt(m)``,
    in fp32, cast back to x's dtype. ``stabilizer`` is a fixed constant,
    never data-dependent: prefill and decode apply the same map."""
    xf = x.float() / (x.shape[-1] ** 0.25)
    proj = xf @ w.float().t()
    sq = 0.5 * (xf * xf).sum(dim=-1, keepdim=True)
    return (torch.exp(proj - sq - stabilizer) / math.sqrt(w.shape[0])).to(x.dtype)


def favor_features(dim: int, num_features: Optional[int] = None, *,
                   generator: torch.Generator, stabilizer: float = 0.0,
                   device=None) -> "FeatureMap":
    """FAVOR+ positive random features for the softmax kernel (Performer):
    E[phi(q) . phi(k)] = exp(q . k / sqrt(d)). The projection [m, d] is
    drawn from ``generator`` (m = ``num_features`` or ``dim``)."""
    w = _orthogonal_gaussian(num_features or dim, dim, generator, device)
    return FeatureMap(name="favor", fn=lambda x: favor_phi(x, w, stabilizer),
                      out_dim=w.shape[0])


_SIMPLE = {
    "elu1": _elu1,
    "relu": _relu,
    "sqrelu": _sqrelu,
    "exp": _exp,
    "identity": lambda x: x,
}
_BUILTIN = frozenset(_SIMPLE)  # protected from re-registration


def register_feature_map(name: str, fn=None):
    """Register a custom elementwise feature map under ``name`` so a config
    can select it (``ModelConfig(feature_map=name)``). Usable directly or as
    a decorator. The map must be positive-valued (the normalizer q.z must
    stay > 0). Re-registering a built-in name raises; re-registering a
    custom name overwrites it."""

    def install(f):
        # "favor" and "learnable" are special-cased in the attention module:
        # a registration under either name would be shadowed there
        if name in _BUILTIN or name in _RESERVED:
            raise ValueError(f"feature map {name!r} is built-in; pick a new name")
        _SIMPLE[name] = f
        return f

    return install if fn is None else install(fn)


def make_feature_map(name: str, *, generator: Optional[torch.Generator] = None,
                     dim: Optional[int] = None, num_features: Optional[int] = None,
                     device=None) -> FeatureMap:
    """Build a feature map by name (built-in or registered). ``favor`` needs
    ``generator`` and ``dim``; ``learnable`` has weights and is built by the
    attention module, so it is not a name here."""
    if name == "favor":
        if generator is None or dim is None:
            raise ValueError("favor feature map requires generator= and dim=")
        return favor_features(dim, num_features, generator=generator, device=device)
    if name not in _SIMPLE:
        raise ValueError(f"unknown feature map {name!r}; have {sorted(_SIMPLE)} + ['favor']")
    return FeatureMap(name=name, fn=_SIMPLE[name])


__all__ = ["FeatureMap", "make_feature_map", "register_feature_map", "favor_features",
           "favor_phi"]
