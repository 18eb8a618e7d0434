"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch versions,
and the autograd Function that joins forward and backward.

Three kernels, each replacing a TPU kernel of
``orion_tpu/ops/pallas/flash_attention.py``:

- ``flash_fwd_cuda`` (``csrc/flash_attention.cu``, ``flash_fwd_wgmma_kernel``
  or ``flash_fwd_kernel``) <- ``_fwd_kernel`` (``_flash_fwd_flat``): for q
  [BH, Tq, D] and k, v [BH, Tk, D]

      out[t] = softmax_s(scale q_t . k_s) v      (input dtype)
      lse[t] = log sum_s exp(scale q_t . k_s)    (fp32 [BH, Tq, 1])

  over the keys s that row t sees: s <= t when ``causal``, t - s < w for
  ``window=w`` (the TPU kernel's ``_tile_mask``); a row that sees no key
  gives out 0 and lse -1e30;
- ``flash_dq_cuda`` (``csrc/flash_attention_bwd.cu``,
  ``flash_dq_wgmma_kernel`` or ``flash_dq_kernel``) <- ``_dq_kernel``: dq;
- ``flash_dkv_cuda`` (same source, ``flash_dkv_wgmma_kernel`` or
  ``flash_dkv_kernel``) <- ``_dkv_kernel``: dk, dv.

Each kernel has two variants, chosen before the launch by
``flash_fwd_variant`` / ``flash_bwd_variant`` from dtype, head width and
alignment alone: "wgmma" (TMA into a ring of shared-memory stages, Hopper's
``wgmma`` from there, P (and dS) split into two bf16 halves for the products
the TPU kernels take in fp32) for bf16 at D 128 with 16-byte-aligned bases,
every model's shape; "simt" (fp32 FMAs on the CUDA cores) for the rest:
fp32 (the tiny models) and other head widths.

``FlashAttentionFn`` is the counterpart of the JAX package's ``_flash_lse``
custom VJP: the forward kernel, then in the backward delta = rowsum(g . out)
- dlse in fp32 torch and the two backward kernels. ``flash_attention`` and
``flash_attention_lse`` are the public entries, in the JAX layout [..., T, D]
with lse [..., T, 1].

Each ``*_cuda`` wrapper launches its kernel or raises, and counts its
launches (``launches_fwd``, ``launches_dq``, ``launches_dkv``: kernel
launches of either variant and nothing else;
``launches_{fwd,dq,dkv}_{wgmma,simt}`` by variant). A variant that fails to
build or launch raises: it never gives way to the other variant or to the
plain version. Each ``*_plain`` function is its kernel's
function in plain PyTorch on any device, materializing the fp32 scores
under the same mask. The kernel's tile is a constant of its source: the JAX
package's ``block_q`` / ``block_k`` (``cfg.attn_block_q``,
``cfg.attn_block_k``) size TPU tiles and are not taken here. ``shift`` and
``q_offset`` serve only the sequence-parallel rings, not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels.library import CSRC, check_launch, load, raise_if_grad
from orion_tpu_torch.ops.kernels.library import stream as _stream

Tensor = torch.Tensor

# one library per source; "fwd" holds row 6, "bwd" rows 7 and 8
SOURCES = {
    "fwd": CSRC / "flash_attention.cu",
    "bwd": CSRC / "flash_attention_bwd.cu",
}
D_MAX = 128  # the kernels' largest head width
_NEG = -1e30  # the masked score, as the TPU kernel's

launches_fwd = 0  # forward kernel launches since import (or since a caller reset it)
launches_fwd_wgmma = launches_fwd_simt = 0  # by variant
launches_dq = 0  # dq-pass kernel launches, either variant
launches_dkv = 0  # dk/dv-pass kernel launches, either variant
launches_dq_wgmma = launches_dq_simt = 0  # by variant
launches_dkv_wgmma = launches_dkv_simt = 0
_libs: dict = {}
# where a caller that wants gradients goes instead of the bare forward kernel
_GRAD_PATH = "flash_attention / FlashAttentionFn"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fwd": {
        "flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
        "flash_attention_fwd_wgmma": [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P],
    },
    "bwd": {
        "flash_attention_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
        "flash_attention_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
        "flash_attention_dq_wgmma": [_P] * 7 + [_I] * 3 + [_F, _I, _I, _P],
        "flash_attention_dkv_wgmma": [_P] * 8 + [_I] * 3 + [_F, _I, _I, _P],
    },
}


def _library(name: str):
    if name not in _libs:
        _libs[name] = load(SOURCES[name], _SIGNATURES[name])
    return _libs[name]


def _scale(q: Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _check(q: Tensor, k: Tensor, v: Tensor, window: Optional[int]):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[::2] != k.shape[::2]:
        raise ValueError(
            f"want q [BH, Tq, D] and k, v [BH, Tk, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if min(*q.shape, k.shape[1]) < 1:
        raise ValueError(f"empty input {tuple(q.shape)}, {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_rows(name: str, x: Tensor, bh: int, t: int):
    if x.shape != (bh, t, 1) or x.dtype != torch.float32:
        raise ValueError(f"want {name} float32 {(bh, t, 1)}; got {x.dtype} {tuple(x.shape)}")


def _mask(t_q: int, t_k: int, causal: bool, window: Optional[int], device) -> Tensor:
    """[Tq, Tk] bool: the keys each row sees (the TPU kernel's _tile_mask)."""
    rows = torch.arange(t_q, device=device)[:, None]
    cols = torch.arange(t_k, device=device)[None, :]
    m = torch.ones(t_q, t_k, dtype=torch.bool, device=device)
    if causal:
        m &= rows >= cols
    if window is not None:
        m &= (rows - cols) < window
    return m


def _args(causal: bool, window: Optional[int]) -> Tuple[int, int]:
    return int(causal), 0 if window is None else int(window)


# ---------------------------------------------------------------------------
# Row 6: the forward
# ---------------------------------------------------------------------------


WGMMA_D = 128  # the head width of the wgmma variants


def _wgmma_ok(*tensors: Tensor) -> bool:
    """bf16 at D 128 with 16-byte-aligned bases: what a TMA tensor map of
    the wgmma kernels describes."""
    return all(t.dtype == torch.bfloat16 and t.shape[-1] == WGMMA_D and t.data_ptr() % 16 == 0
               for t in tensors)


def flash_fwd_variant(q: Tensor, k: Tensor, v: Tensor) -> str:
    """The forward kernel that takes q [BH, Tq, D] and k, v [BH, Tk, D]:
    "wgmma" when all three are bf16 at D 128 with 16-byte-aligned bases,
    else "simt". From dtype, shape and alignment alone, before any launch."""
    return "wgmma" if _wgmma_ok(q, k, v) else "simt"


def flash_fwd_cuda(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel that ``flash_fwd_variant`` names on the
    current stream -> (out in the input dtype, lse [BH, Tq, 1] fp32). Raises
    on anything it does not take: an input that requires grad while grad is
    enabled (the outputs would carry none), CPU tensors, mixed devices, a
    dtype other than bf16/fp32, non-contiguous inputs, D > 128."""
    global launches_fwd, launches_fwd_wgmma, launches_fwd_simt
    raise_if_grad([q, k, v], _GRAD_PATH)
    _check(q, k, v, window)
    check_launch("flash_fwd_cuda", [q, k, v], [])
    bh, t_q, d = q.shape
    if d > D_MAX:
        raise ValueError(f"D {d} > {D_MAX}, the kernel's limit")
    out = torch.empty_like(q)
    lse = torch.empty(bh, t_q, 1, dtype=torch.float32, device=q.device)
    chosen = flash_fwd_variant(q, k, v)
    lib = _library("fwd")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        if chosen == "wgmma":
            err = lib.flash_attention_fwd_wgmma(
                *ptrs, bh, t_q, k.shape[1], _scale(q, scale), *_args(causal, window),
                _stream(q.device))
        else:
            err = lib.flash_attention_fwd(
                *ptrs, bh, t_q, k.shape[1], d, int(q.dtype == torch.bfloat16), _scale(q, scale),
                *_args(causal, window), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention forward kernel ({chosen}) failed: cudaError_t {err}")
    launches_fwd += 1
    if chosen == "wgmma":
        launches_fwd_wgmma += 1
    else:
        launches_fwd_simt += 1
    return out, lse


def flash_fwd_plain(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """The forward kernel's function in plain PyTorch, on any device: fp32
    scores scale q k^T materialized under the mask -> (out in the input
    dtype, lse [BH, Tq, 1] fp32). Differentiable by autograd."""
    _check(q, k, v, window)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask, (q.float() @ k.float().transpose(1, 2)) * _scale(q, scale), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)  # a row without keys: out 0
    out = (p @ v.float()) / safe
    return out.to(q.dtype), m + torch.log(safe)


# ---------------------------------------------------------------------------
# Rows 7 and 8: the backward passes
# ---------------------------------------------------------------------------


def _check_bwd(q, k, v, g, lse, delta, window):
    _check(q, k, v, window)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"want g like q {q.dtype} {tuple(q.shape)}; got {g.dtype} {tuple(g.shape)}")
    _check_rows("lse", lse, q.shape[0], q.shape[1])
    _check_rows("delta", delta, q.shape[0], q.shape[1])


def flash_bwd_variant(q: Tensor, k: Tensor, v: Tensor, g: Tensor) -> str:
    """The backward kernels that take q, g [BH, Tq, D] and k, v [BH, Tk, D]:
    "wgmma" when all four are bf16 at D 128 with 16-byte-aligned bases
    (what a TMA tensor map describes), else "simt". From dtype, shape and
    alignment alone, before any launch."""
    return "wgmma" if _wgmma_ok(q, k, v, g) else "simt"


def _launch_bwd(fn_name, q, k, v, g, lse, delta, outs, causal, window, scale) -> str:
    """Launch the pass ``fn_name`` in the variant ``flash_bwd_variant``
    names -> that variant."""
    raise_if_grad([q, k, v, g], _GRAD_PATH)
    _check_bwd(q, k, v, g, lse, delta, window)
    check_launch(fn_name, [q, k, v, g], [lse, delta])
    bh, t_q, d = q.shape
    if d > D_MAX:
        raise ValueError(f"D {d} > {D_MAX}, the kernel's limit")
    chosen = flash_bwd_variant(q, k, v, g)
    lib = _library("bwd")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(o.data_ptr() for o in outs))
    with torch.cuda.device(q.device):
        if chosen == "wgmma":
            err = getattr(lib, fn_name + "_wgmma")(
                *ptrs, bh, t_q, k.shape[1], _scale(q, scale), *_args(causal, window),
                _stream(q.device))
        else:
            err = getattr(lib, fn_name)(
                *ptrs, bh, t_q, k.shape[1], d, int(q.dtype == torch.bfloat16), _scale(q, scale),
                *_args(causal, window), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel ({chosen}) failed: cudaError_t {err}")
    return chosen


def flash_dq_cuda(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tensor:
    """Launch the dq-pass kernel on the current stream -> dq in q's dtype.
    g: the output's cotangent in q's dtype; lse, delta: fp32 [BH, Tq, 1].
    The kernel is ``flash_bwd_variant``'s choice. Raises on anything it does
    not take, as ``flash_fwd_cuda``."""
    global launches_dq, launches_dq_wgmma, launches_dq_simt
    dq = torch.empty_like(q)
    chosen = _launch_bwd("flash_attention_dq", q, k, v, g, lse, delta, [dq], causal, window, scale)
    launches_dq += 1
    if chosen == "wgmma":
        launches_dq_wgmma += 1
    else:
        launches_dq_simt += 1
    return dq


def flash_dkv_cuda(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch the dk/dv-pass kernel on the current stream -> (dk, dv) in the
    input dtype; arguments as ``flash_dq_cuda``."""
    global launches_dkv, launches_dkv_wgmma, launches_dkv_simt
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    chosen = _launch_bwd("flash_attention_dkv", q, k, v, g, lse, delta, [dk, dv], causal, window,
                         scale)
    launches_dkv += 1
    if chosen == "wgmma":
        launches_dkv_wgmma += 1
    else:
        launches_dkv_simt += 1
    return dk, dv


def _probs_and_ds(q, k, v, g, lse, delta, causal, window, scale):
    """P recomputed from lse and dS = P (g v^T - delta) scale, fp32 [BH, Tq, Tk]."""
    _check_bwd(q, k, v, g, lse, delta, window)
    sc = _scale(q, scale)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = (q.float() @ k.float().transpose(1, 2)) * sc
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    ds = p * (g.float() @ v.float().transpose(1, 2) - delta) * sc
    return p, ds


def flash_dq_plain(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tensor:
    """The dq-pass kernel's function in plain PyTorch, on any device:
    dq = dS k with fp32 sums, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, causal, window, scale)
    return (ds @ k.float()).to(q.dtype)


def flash_dkv_plain(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """The dk/dv-pass kernel's function in plain PyTorch, on any device:
    dk = dS^T q, dv = P^T g with fp32 sums, in the input dtype."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, causal, window, scale)
    dk = ds.transpose(1, 2) @ q.float()
    dv = p.transpose(1, 2) @ g.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The autograd Function and the public entries
# ---------------------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward on the kernels: the counterpart of
    the JAX package's ``_flash_lse`` custom VJP.

    ``apply(q, k, v, causal, window, scale)`` on flat contiguous q [BH, Tq,
    D], k, v [BH, Tk, D] -> (out, lse [BH, Tq, 1]). The forward launches the
    forward kernel and saves (q, k, v, out, lse); the backward casts the
    output's cotangent g to q's dtype, takes delta = rowsum(g . out) - dlse
    in fp32 torch (as XLA does in the reference), then launches the dq pass
    and the dk/dv pass. It calls the three ``*_cuda`` wrappers by their
    module names, so a test can stand their plain versions in for them on
    the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_fwd_cuda(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(q) if gout is None else gout.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        if dlse is not None:  # d lse / d S = P, folded into the delta column
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_dq_cuda(q, k, v, g, lse, delta, **ctx.opts)
        dk, dv = flash_dkv_cuda(q, k, v, g, lse, delta, **ctx.opts)
        return dq, dk, dv, None, None, None


def _ring_only(shift: int, q_offset: int):
    if shift or q_offset:
        raise NotImplementedError(
            "shift / q_offset serve the sequence-parallel rings, not ported to "
            "orion_tpu_torch yet (ROADMAP.md queue A, item 12 (parallelism))"
        )


def flash_attention_lse(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, shift: int = 0, q_offset: int = 0,
    scale: Optional[float] = None, backend: str = "auto",
) -> Tuple[Tensor, Tensor]:
    """Flash attention over [..., T, D] per-head tensors that also returns
    the row log-sum-exp [..., T, 1] fp32; differentiable in both outputs.
    ``backend`` (``ops/dispatch.py``): the kernels for CUDA tensors (through
    ``FlashAttentionFn`` when a gradient is wanted), the plain versions for
    CPU tensors (differentiated by autograd)."""
    _ring_only(shift, q_offset)
    batch_shape = q.shape[:-2]
    t_q, d = q.shape[-2:]
    t_k = k.shape[-2]
    qf = q.reshape(-1, t_q, d).contiguous()
    kf = k.reshape(-1, t_k, d).contiguous()
    vf = v.reshape(-1, t_k, v.shape[-1]).contiguous()
    opts = dict(causal=causal, window=window, scale=scale)
    if resolve(backend, q.device) == "torch":
        out, lse = flash_fwd_plain(qf, kf, vf, **opts)
    elif torch.is_grad_enabled() and any(x.requires_grad for x in (qf, kf, vf)):
        out, lse = FlashAttentionFn.apply(qf, kf, vf, causal, window, scale)
    else:
        out, lse = flash_fwd_cuda(qf, kf, vf, **opts)
    return out.reshape(*batch_shape, t_q, -1), lse.reshape(*batch_shape, t_q, 1)


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
    backend: str = "auto",
) -> Tensor:
    """Flash attention over [..., T, D] per-head tensors -> out [..., Tq, D].
    Differentiable; ``backend`` as ``flash_attention_lse``."""
    return flash_attention_lse(q, k, v, causal=causal, window=window, scale=scale,
                               backend=backend)[0]


__all__ = [
    "flash_fwd_cuda", "flash_fwd_plain", "flash_fwd_variant", "flash_dq_cuda", "flash_dq_plain",
    "flash_bwd_variant", "flash_dkv_cuda", "flash_dkv_plain", "FlashAttentionFn", "flash_attention",
    "flash_attention_lse", "SOURCES",
]
