"""Fused Adafactor: the three CUDA passes' wrappers, their plain PyTorch
versions, and the update over a model's parameters.

The port's counterpart of ``orion_tpu/ops/pallas/adafactor.py``. Its
semantics are optax's ``adafactor(sched, min_dim_size_to_factor=128,
multiply_by_parameter_scale=False)`` (decay 0.8, eps 1e-30, update clipping
1.0) composed with the trainer's clip and finite guard:

    q      = (scale * g)^2 + eps              # scale folds clip + guard
    v_row  = d_t * v_row + (1 - d_t) * mean(q, axis=d0)
    v_col  = d_t * v_col + (1 - d_t) * mean(q, axis=d1)
    u      = scale * g * (v_row / mean(v_row))^-1/2 * v_col^-1/2
    u      = u / max(1, rms(u) / threshold)   # update clipping
    p      = p - lr * u                       # skipped when not finite
    d_t    = 1 - (count + 1)^-0.8

A factored 2-D fp32 matrix of at least ``_MIN_KERNEL_ELEMS`` elements takes
three passes (``_leaf_update``'s kernel form): ``adafactor_sums`` (both axes'
sums of q), ``adafactor_rms`` (the squared sum of u, for the clipping) and
``adafactor_apply`` (p += g r c, in place, unless the step is not finite);
between them the statistics' arithmetic runs on [m] + [n] vectors in plain
PyTorch on the device, so a step never waits for the host. Each pass's
``*_cuda`` wrapper (``csrc/adafactor.cu``) launches its kernels or raises and
counts its launches (``launches_sums``, ``launches_rms``, ``launches_apply``):
the sums and the squared sum are two launches a call (the tiles' partial
sums, then a small launch that adds them in a fixed order), apply is one.
The source chooses the tiling; ``tiling`` asks it, to size the scratch.
``*_torch`` is the same function in
plain PyTorch; ``adafactor_sums`` / ``_rms`` / ``_apply`` pick one of the two
by ``backend`` (``ops/dispatch.py``): the kernel for CUDA tensors, the plain
version for CPU ones. Other leaves (1-D, small, not fp32, 3-D expert stacks)
take the plain formulas, as in the JAX package.

Orientation. optax factors a matrix over its two largest axes, and over a
square one by position: axis 1 is "d0". The port stores a dense weight as
[out, in], the transpose of the flax kernel, so ``factored_dims`` takes a
``transposed`` flag (``convert.expected_params`` carries it for every leaf)
and computes the dims on the JAX orientation: every leaf's ``v_row`` /
``v_col`` then holds what optax's holds for the same leaf.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels.library import COUNT_LOCK, CSRC, load
from orion_tpu_torch.ops.kernels.library import stream as _stream

Tensor = torch.Tensor

_DECAY = 0.8
_EPS = 1e-30
_CLIP = 1.0
_MIN_FACTOR_DIM = 128
_MIN_KERNEL_ELEMS = 1 << 20  # tests lower this to send small leaves through the kernels

SOURCES = {"adafactor": CSRC / "adafactor.cu"}  # one library: rows 11, 12 and 13

launches_sums = 0  # kernel launches since import (or since a caller reset them)
launches_rms = 0
launches_apply = 0
_libs: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "adafactor": {
        "adafactor_tiling": [_I, _I, _P],
        "adafactor_sums": [_P, _P, ctypes.c_float, _P, _P, _P] + [_I] * 3 + [_P],
        "adafactor_rms": [_P] * 5 + [_I] * 3 + [_P],
        "adafactor_apply": [_P] * 5 + [_I] * 3 + [_P],
    },
}


def _library():
    if "adafactor" not in _libs:
        _libs["adafactor"] = load(SOURCES["adafactor"], _SIGNATURES["adafactor"])
    return _libs["adafactor"]


# ---------------------------------------------------------------------------
# The state and the factoring rule
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FusedAdafactorState:
    """optax's FactoredState, per parameter name: ``count`` (good steps so
    far), ``v_row`` / ``v_col`` (factored leaves; [1] otherwise) and ``v``
    (other leaves; [1] for factored ones)."""

    count: int
    v_row: Dict[str, Tensor]
    v_col: Dict[str, Tensor]
    v: Dict[str, Tensor]


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` (factored, min 128): (d1, d0) = the indices
    of the second-largest and the largest axes, or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < _MIN_FACTOR_DIM:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def factored_dims(shape, transposed: bool = False) -> Optional[Tuple[int, int]]:
    """(d1, d0) in the axes of a leaf of ``shape``; ``transposed``: the leaf
    is the transpose of the JAX package's (a 2-D dense weight), so the dims
    are optax's on the JAX shape, mapped back."""
    shape = tuple(shape)
    if not transposed:
        return _factored_dims(shape)
    if len(shape) != 2:
        raise ValueError(f"only a 2-D leaf is stored transposed; got shape {shape}")
    dims = _factored_dims(shape[::-1])
    return None if dims is None else (1 - dims[0], 1 - dims[1])


def kernel_ok(t: Tensor) -> bool:
    """The kernels' gate: a 2-D fp32 matrix of at least _MIN_KERNEL_ELEMS
    elements, in any layout. (The TPU kernels also want rows % 8 and columns
    % 128; these take ragged edges.)"""
    return t.dim() == 2 and t.dtype == torch.float32 and t.numel() >= _MIN_KERNEL_ELEMS


def init(params: Mapping[str, Tensor], dims: Mapping[str, Optional[Tuple[int, int]]]
         ) -> FusedAdafactorState:
    """Zero state with optax's shapes (``dims``: each leaf's ``factored_dims``),
    in the leaf's dtype, fp32 for a bf16-stored leaf (the JAX package inits
    the optimizer from an fp32 view of such params)."""
    v_row, v_col, v = {}, {}, {}
    for name, p in params.items():
        d = dims[name]
        sdt = torch.float32 if p.dtype == torch.bfloat16 else p.dtype
        one = torch.zeros(1, dtype=sdt, device=p.device)
        if d is not None:
            d1, d0 = d
            v_row[name] = torch.zeros(tuple(np.delete(p.shape, d0)), dtype=sdt, device=p.device)
            v_col[name] = torch.zeros(tuple(np.delete(p.shape, d1)), dtype=sdt, device=p.device)
            v[name] = one
        else:
            v_row[name], v_col[name] = one, one.clone()
            v[name] = torch.zeros_like(p, dtype=sdt)
    return FusedAdafactorState(0, v_row, v_col, v)


# ---------------------------------------------------------------------------
# The three passes
# ---------------------------------------------------------------------------


def tiling(m: int, n: int) -> Tuple[int, int, int]:
    """(column strips, row chunks, rows per chunk) of an [m, n] matrix, as
    ``csrc/adafactor.cu`` chooses them (it builds the library)."""
    out = (ctypes.c_int * 3)()
    if _library().adafactor_tiling(m, n, ctypes.addressof(out)) != 0:
        raise ValueError(f"no tiling of an empty matrix [{m}, {n}]")
    return out[0], out[1], out[2]


def _check(fn_name: str, g: Tensor, others) -> Tuple[int, int]:
    if g.dim() != 2:
        raise ValueError(f"{fn_name} takes a 2-D matrix; got {tuple(g.shape)}")
    tensors = [g, *others]
    if g.device.type != "cuda":
        raise RuntimeError(f"{fn_name} needs CUDA tensors; got {g.device} "
                           "(backend='torch' runs the plain version anywhere)")
    if any(t.device != g.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{fn_name}: every input must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    return g.shape


def _vec(n: int, *tensors) -> int:
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def adafactor_sums_cuda(g: Tensor, s2: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """Pass A on the card: q = g g s2 + eps -> (axis-0 sums [n], axis-1
    sums [m]), fp32; s2 a one-element fp32 tensor on g's device."""
    global launches_sums
    m, n = _check("adafactor_sums_cuda", g, [s2])
    if s2.numel() != 1:
        raise ValueError(f"s2 must hold one value; got shape {tuple(s2.shape)}")
    n_ct, n_rc, _ = tiling(m, n)
    rowpart = torch.empty(n_ct * m, device=g.device)
    colpart = torch.empty(n_rc * n, device=g.device)
    sums = torch.empty(n + m, device=g.device)
    with torch.cuda.device(g.device):
        err = _library().adafactor_sums(
            g.data_ptr(), s2.data_ptr(), float(eps), rowpart.data_ptr(), colpart.data_ptr(),
            sums.data_ptr(), m, n, _vec(n, g), _stream(g.device))
    if err != 0:
        raise RuntimeError(f"adafactor sums kernel failed: cudaError_t {err}")
    with COUNT_LOCK:
        launches_sums += 2  # af_sums_tile, af_sums_finalize
    return sums[:n], sums[n:]


def adafactor_sums_torch(g: Tensor, s2: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """Pass A in plain PyTorch, on any device."""
    q = g * g * s2.reshape(()) + eps
    return q.sum(0), q.sum(1)


def adafactor_rms_cuda(g: Tensor, r: Tensor, c: Tensor) -> Tensor:
    """Pass B on the card: sum((g r[i] c[j])^2) -> a 0-d fp32 tensor."""
    global launches_rms
    m, n = _check("adafactor_rms_cuda", g, [r, c])
    if tuple(r.shape) != (m,) or tuple(c.shape) != (n,):
        raise ValueError(f"want r [{m}] and c [{n}]; got {tuple(r.shape)}, {tuple(c.shape)}")
    n_ct, n_rc, _ = tiling(m, n)
    partial = torch.empty(n_ct * n_rc, device=g.device)
    out = torch.empty((), device=g.device)
    with torch.cuda.device(g.device):
        err = _library().adafactor_rms(
            g.data_ptr(), r.data_ptr(), c.data_ptr(), partial.data_ptr(), out.data_ptr(), m, n,
            _vec(n, g), _stream(g.device))
    if err != 0:
        raise RuntimeError(f"adafactor rms kernel failed: cudaError_t {err}")
    with COUNT_LOCK:
        launches_rms += 2  # af_rms_tile, af_rms_finalize
    return out


def adafactor_rms_torch(g: Tensor, r: Tensor, c: Tensor) -> Tensor:
    """Pass B in plain PyTorch, on any device."""
    u = g * r[:, None] * c[None, :]
    return (u * u).sum()


def adafactor_apply_cuda(g: Tensor, p: Tensor, r: Tensor, c: Tensor, flag: Tensor) -> Tensor:
    """Pass C on the card: p += g r[i] c[j] IN PLACE (the TPU kernel aliases
    p to its output) when ``flag`` (a one-element int32 tensor on the
    device) is nonzero; with the flag 0 the kernel writes nothing and p stays
    bitwise as it was. Returns p."""
    global launches_apply
    m, n = _check("adafactor_apply_cuda", g, [p, r, c])
    if p.shape != g.shape or tuple(r.shape) != (m,) or tuple(c.shape) != (n,):
        raise ValueError(f"want p [{m}, {n}], r [{m}], c [{n}]; got {tuple(p.shape)}, "
                         f"{tuple(r.shape)}, {tuple(c.shape)}")
    if flag.dtype != torch.int32 or flag.numel() != 1 or flag.device != g.device:
        raise TypeError("flag must be a one-element int32 tensor on g's device")
    with torch.cuda.device(g.device):
        err = _library().adafactor_apply(
            g.data_ptr(), p.data_ptr(), r.data_ptr(), c.data_ptr(), flag.data_ptr(), m, n,
            _vec(n, g, p), _stream(g.device))
    if err != 0:
        raise RuntimeError(f"adafactor apply kernel failed: cudaError_t {err}")
    with COUNT_LOCK:
        launches_apply += 1
    return p


def adafactor_apply_torch(g: Tensor, p: Tensor, r: Tensor, c: Tensor, flag: Tensor) -> Tensor:
    """Pass C in plain PyTorch, on any device, in place as the kernel."""
    new = p + g * r[:, None] * c[None, :]
    return p.copy_(torch.where(flag.reshape(()) != 0, new, p))


def adafactor_sums(g, s2, eps, backend="auto"):
    if resolve(backend, g.device) == "torch":
        return adafactor_sums_torch(g, s2, eps)
    return adafactor_sums_cuda(g, s2, eps)


def adafactor_rms(g, r, c, backend="auto"):
    if resolve(backend, g.device) == "torch":
        return adafactor_rms_torch(g, r, c)
    return adafactor_rms_cuda(g, r, c)


def adafactor_apply(g, p, r, c, flag, backend="auto"):
    if resolve(backend, g.device) == "torch":
        return adafactor_apply_torch(g, p, r, c, flag)
    return adafactor_apply_cuda(g, p, r, c, flag)


# ---------------------------------------------------------------------------
# One leaf, and the whole update
# ---------------------------------------------------------------------------


def _leaf_update(g, p, v_row, v_col, v, *, dims, decay_t, one_minus, lr, scale, finite, flag,
                 eps, clip, use_kernel, backend, store=None):
    """One parameter tensor; ``p`` is updated in place. Returns (new v_row,
    new v_col, new v): the old ones where the step is not finite (the
    selects run on the small statistics; in the kernel form the select of p
    rides in the apply kernel). ``store`` rounds the new fp32 value to p's
    dtype (default: ``.to``; a bf16-stored leaf's stochastic rounding)."""

    def keep(new, old):
        return torch.where(finite, new, old)

    if store is None:
        store = lambda t: t.to(p.dtype)  # noqa: E731

    if dims is None:  # optax's non-factored path (norm scales, small leaves)
        q = (scale * g) ** 2 + eps
        new_v = (decay_t * v + one_minus * q).to(v.dtype)
        u = scale * g * torch.rsqrt(new_v)
        if clip:
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / clip, min=1.0)
        p.copy_(torch.where(finite, store(p - lr * u), p))
        return v_row, v_col, keep(new_v, v)

    d1, d0 = dims
    if not (use_kernel and kernel_ok(g) and p.dtype == g.dtype):
        # optax's factored path, any ndim (the 3-D expert stacks too): the
        # reference the kernel form is held against
        q = (scale * g.float()) ** 2 + eps
        new_v_row = (decay_t * v_row + one_minus * q.mean(dim=d0)).to(v_row.dtype)
        new_v_col = (decay_t * v_col + one_minus * q.mean(dim=d1)).to(v_col.dtype)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = new_v_row.mean(dim=reduced_d1, keepdim=True)
        row_factor = torch.rsqrt(new_v_row / row_col_mean)
        col_factor = torch.rsqrt(new_v_col)
        u = scale * g.float() * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        if clip:
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / clip, min=1.0)
        p.copy_(torch.where(finite, store(p - lr * u), p))
        return keep(new_v_row, v_row), keep(new_v_col, v_col), v

    m, n = g.shape
    g = g.contiguous()  # read only: a strided gradient is copied (p, written in place, is not)
    sum0, sum1 = adafactor_sums(g, (scale * scale).reshape(1), eps, backend)  # [n], [m]
    # optax: v_row is the mean over axis d0, v_col over axis d1
    mean_d0 = sum1 / n if d0 == 1 else sum0 / m
    mean_d1 = sum0 / m if d1 == 0 else sum1 / n
    new_v_row = (decay_t * v_row + one_minus * mean_d0).to(p.dtype)
    new_v_col = (decay_t * v_col + one_minus * mean_d1).to(p.dtype)
    row_factor = torch.rsqrt(new_v_row / new_v_row.mean())
    col_factor = torch.rsqrt(new_v_col)
    # u[i, j] = scale g[i, j] row_factor (along d0's other axis) col_factor
    rvec, cvec = (row_factor, col_factor) if d0 == 1 else (col_factor, row_factor)
    rvec_s = (rvec * scale).contiguous()
    sum_u2 = adafactor_rms(g, rvec_s, cvec.contiguous(), backend)
    kappa = torch.full((), -lr, dtype=torch.float32, device=g.device)
    if clip:
        kappa = kappa / torch.clamp(torch.sqrt(sum_u2 / (m * n)) / clip, min=1.0)
    adafactor_apply(g, p, (rvec_s * kappa).contiguous(), cvec.contiguous(), flag, backend)
    return keep(new_v_row, v_row), keep(new_v_col, v_col), v


def decay_terms(count: int, decay_rate: float = _DECAY) -> Tuple[float, float]:
    """(d_t, 1 - d_t), each rounded to fp32 as the JAX package computes them."""
    t = np.float32(count + 1)
    decay_t = np.float32(1.0) - t ** np.float32(-decay_rate)
    return float(decay_t), float(np.float32(1.0) - decay_t)


@torch.no_grad()
def apply_updates(
    grads: Mapping[str, Tensor], params: Mapping[str, Tensor], state: FusedAdafactorState, *,
    lr: float, scale, finite, dims: Mapping[str, Optional[Tuple[int, int]]],
    decay_rate: float = _DECAY, eps: float = _EPS, clipping_threshold: Optional[float] = _CLIP,
    use_kernel: bool = True, backend: str = "auto",
    store: Optional[Mapping[str, Callable[[Tensor], Tensor]]] = None,
) -> FusedAdafactorState:
    """Update ``params`` IN PLACE and return the new state. ``scale`` folds
    the caller's gradient clip and finite guard (a float or a 0-d tensor);
    ``finite`` (a bool or a 0-d tensor) keeps params and statistics untouched
    on a bad step, and the count then does not advance. ``use_kernel``: the
    three-pass kernel form for the leaves ``kernel_ok`` takes (False: the
    plain formulas everywhere, optax's ``adafactor``); ``backend`` picks the
    passes' kernels or their plain versions (``ops/dispatch.py``). ``store``:
    per leaf, how its new fp32 value is rounded to its dtype (the plain
    formulas' leaves; the trainer's stochastic rounding of bf16 storage)."""
    dev = next(iter(params.values())).device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    finite_t = torch.as_tensor(finite, device=dev).bool()
    flag = finite_t.to(torch.int32).reshape(1)
    decay_t, one_minus = decay_terms(state.count, decay_rate)
    v_row, v_col, v = {}, {}, {}
    for name, p in params.items():
        v_row[name], v_col[name], v[name] = _leaf_update(
            grads[name], p, state.v_row[name], state.v_col[name], state.v[name],
            dims=dims[name], decay_t=decay_t, one_minus=one_minus, lr=lr, scale=scale,
            finite=finite_t, flag=flag, eps=eps, clip=clipping_threshold,
            use_kernel=use_kernel, backend=backend, store=(store or {}).get(name))
    # the good-step count: a skipped step advances neither d_t nor the lr
    count = state.count + int(bool(finite))
    return FusedAdafactorState(count, v_row, v_col, v)


__all__ = [
    "FusedAdafactorState", "factored_dims", "kernel_ok", "init", "apply_updates", "tiling",
    "decay_terms", "adafactor_sums", "adafactor_sums_cuda", "adafactor_sums_torch",
    "adafactor_rms", "adafactor_rms_cuda", "adafactor_rms_torch", "adafactor_apply",
    "adafactor_apply_cuda", "adafactor_apply_torch", "SOURCES",
]
