"""Grouped expert matmul (gmm): the CUDA kernels' wrappers, their plain
PyTorch versions, the tile tables, and the autograd Function that joins
forward and backward.

The port's counterpart of ``orion_tpu/ops/pallas/gmm.py``, the dropless
mixture of experts' expert products. Rows of ``x`` [M, K] lie in
TILE-ALIGNED expert segments: the caller pads each expert's rows up to a
multiple of the row tile (``pad_group_sizes``), so every tile of
``tile_rows = M / n_tiles`` rows belongs to one expert, named by the tile
table ``tile_expert`` [n_tiles] int32 (``tile_expert_table``; trailing
tiles past the last segment name the last expert, and their rows are zero
padding the caller never gathers back). Two kernels, each replacing a TPU
kernel:

- ``gmm_cuda`` (``csrc/gmm.cu``, ``gmm_fwd_wgmma_kernel`` or
  ``gmm_fwd_kernel``) <- ``_fwd_kernel`` (``_gmm_call``):
  ``y[r] = x[r] @ w[te[r // tile_rows]]`` for w [E, K, N], accumulated in
  fp32 and rounded once to x's dtype; with ``transpose_w``, w [E, N, K] is
  read as ``w[e]^T`` in place (the backward's dx, where the TPU path builds
  ``swapaxes(w, 1, 2)``);
- ``gmm_dw_cuda`` (same source, ``gmm_dw_wgmma_kernel`` or
  ``gmm_dw_kernel``) <- ``_dw_kernel`` (``_dw_call``):
  ``dw[e] = sum over e's tiles of x_tile^T g_tile``, fp32 [E, D, H], zero
  for an expert without tiles.

Each has two variants, chosen before the launch by ``gmm_variant`` /
``gmm_dw_variant`` from dtype, widths and alignment alone: "wgmma" (TMA into
a ring of shared-memory stages, Hopper's ``wgmma`` from there) for bf16
operands whose widths are multiples of 8 and whose bases are 16-byte
aligned, which is what a TMA tensor map can describe and every model width
satisfies; "simt" (synchronous loads, wmma bf16 or fp32 FMAs) for the rest:
fp32 (the tiny models) and bf16 at other widths.

``GmmFn`` is the counterpart of the JAX package's ``gmm`` custom VJP: the
forward kernel on w cast to x's dtype, then in the backward the forward
kernel again against ``w^T`` for dx and the dw kernel, cast to the weight's
dtype. ``gmm`` is the public entry: the plain version for CPU tensors, the
kernels for CUDA tensors. The tile table stays on the device and the kernels
read it there, so no count reaches the host.

Each ``*_cuda`` wrapper launches its kernel or raises, and counts its
launches (``launches_fwd``, ``launches_dw``: kernel launches of either
variant and nothing else; ``launches_{fwd,dw}_{wgmma,simt}`` by variant).
``gmm_torch`` and ``gmm_dw_torch`` are the kernels' functions in plain
PyTorch on any device: one fp32 product per row tile.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels.library import (COUNT_LOCK, CSRC, check_launch, load,
                                                  raise_if_grad)
from orion_tpu_torch.ops.kernels.library import stream as _stream

Tensor = torch.Tensor

SOURCES = {"gmm": CSRC / "gmm.cu"}  # one library: rows 9 and 10
TILE_MULTIPLE = 128  # the kernels' output tile: tile_rows must be a multiple of it

launches_fwd = 0  # forward kernel launches since import (or since a caller reset it)
launches_dw = 0  # dw kernel launches
launches_fwd_wgmma = launches_fwd_simt = 0  # the same by variant
launches_dw_wgmma = launches_dw_simt = 0
_libs: dict = {}
_GRAD_PATH = "ops.kernels.gmm.gmm / GmmFn"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gmm": {
        "gmm_fwd": [_P] * 4 + [_I] * 7 + [_P],
        "gmm_dw": [_P] * 5 + [_I] * 5 + [_P],
        "gmm_fwd_wgmma": [_P] * 4 + [_I] * 6 + [_P],
        "gmm_dw_wgmma": [_P] * 5 + [_I] * 5 + [_P],
    },
}


def _library():
    if "gmm" not in _libs:
        _libs["gmm"] = load(SOURCES["gmm"], _SIGNATURES["gmm"])
    return _libs["gmm"]


# ---------------------------------------------------------------------------
# Tile tables, on the device
# ---------------------------------------------------------------------------


def pad_group_sizes(counts: Tensor, tile_rows: int) -> Tuple[Tensor, Tensor]:
    """(tile-aligned segment sizes, exclusive segment starts), int32, for
    raw per-expert row counts [E]."""
    seg = (counts + tile_rows - 1) // tile_rows * tile_rows
    starts = torch.cumsum(seg, 0) - seg
    return seg.int(), starts.int()


def tile_expert_table(group_sizes: Tensor, n_tiles: int, tile_rows: int) -> Tensor:
    """[n_tiles] int32: the expert owning each row tile, given tile-aligned
    segment sizes [E]. Non-decreasing; tiles past the last segment name the
    last expert."""
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    rows = torch.arange(n_tiles, device=group_sizes.device) * tile_rows
    owner = (rows[:, None] >= starts[None, :]).sum(1) - 1
    return owner.clamp_min(0).int()


def expert_tiles(tile_expert: Tensor, n_experts: int) -> Tuple[Tensor, Tensor]:
    """(first tile, tile count) of each expert, int32 [E], from a
    non-decreasing tile table: the row tiles the dw kernel walks for each
    expert. Elementwise ops and a cumsum, so nothing waits for the host."""
    ids = torch.arange(n_experts, device=tile_expert.device, dtype=tile_expert.dtype)
    count = (tile_expert[:, None] == ids[None, :]).sum(0)
    return (torch.cumsum(count, 0) - count).int(), count.int()


def _tiling(x: Tensor, tile_expert: Tensor) -> Tuple[int, int]:
    """(n_tiles, tile_rows) of x's rows under the table."""
    if x.dim() != 2 or tile_expert.dim() != 1:
        raise ValueError(f"want x [M, K] and tile_expert [n_tiles]; got {tuple(x.shape)}, "
                         f"{tuple(tile_expert.shape)}")
    nt = tile_expert.shape[0]
    if nt < 1 or x.shape[0] % nt:
        raise ValueError(f"{nt} tiles do not divide the {x.shape[0]} rows")
    return nt, x.shape[0] // nt


def _weight_shape(x: Tensor, w: Tensor, transpose_w: bool) -> Tuple[int, int]:
    """(E, N) of the product x @ w[e] (or x @ w[e]^T)."""
    if w.dim() != 3:
        raise ValueError(f"want w [E, K, N]; got {tuple(w.shape)}")
    e, k, n = (w.shape[0], w.shape[2], w.shape[1]) if transpose_w else w.shape
    if k != x.shape[1]:
        raise ValueError(f"x [M, {x.shape[1]}] against w{'^T' if transpose_w else ''} "
                         f"[E, {k}, {n}]")
    return e, n


def _check_table(tile_expert: Tensor, x: Tensor, tile_rows: int) -> None:
    if tile_expert.dtype != torch.int32 or tile_expert.device != x.device or not \
            tile_expert.is_contiguous():
        raise TypeError("tile_expert must be a contiguous int32 tensor on x's device")
    if tile_rows % TILE_MULTIPLE:
        raise ValueError(f"tile_rows {tile_rows} is not a multiple of {TILE_MULTIPLE}")


def _tma_takes(tensors, widths) -> bool:
    """Whether a TMA tensor map describes these operands: bf16, every width
    (a row's elements) a multiple of 8 so each row stride is a multiple of
    16 bytes, every base 16-byte aligned."""
    return (all(t.dtype == torch.bfloat16 for t in tensors) and all(n % 8 == 0 for n in widths)
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def gmm_variant(x: Tensor, w: Tensor, transpose_w: bool = False) -> str:
    """The forward kernel that takes x [M, K] @ w[e] (w [E, K, N]; with
    ``transpose_w`` w [E, N, K], read as w[e]^T): "wgmma" when x and w are
    bf16, K and N multiples of 8 and both bases 16-byte aligned, else
    "simt". From dtype, shape and alignment alone, before any launch."""
    return "wgmma" if _tma_takes([x, w], (w.shape[1], w.shape[2])) else "simt"


def gmm_dw_variant(x: Tensor, g: Tensor) -> str:
    """The dw kernel that takes x [M, D], g [M, H]: "wgmma" when both are
    bf16, D and H multiples of 8 and both bases 16-byte aligned, else
    "simt"."""
    return "wgmma" if _tma_takes([x, g], (x.shape[1], g.shape[1])) else "simt"


# ---------------------------------------------------------------------------
# Row 9: the forward (and dx)
# ---------------------------------------------------------------------------


def gmm_cuda(x: Tensor, w: Tensor, tile_expert: Tensor, transpose_w: bool = False) -> Tensor:
    """Launch the forward kernel on the current stream -> y [M, N] in x's
    dtype. x [M, K] and w [E, K, N] (``transpose_w``: [E, N, K], read as
    w[e]^T) share bf16 or fp32; tile_expert int32 [M / tile_rows] with
    tile_rows a multiple of 128. The kernel is ``gmm_variant``'s choice.
    Raises on anything it does not take: an input that requires grad while
    grad is enabled, CPU tensors, mixed devices or dtypes, non-contiguous
    inputs, other tilings."""
    global launches_fwd, launches_fwd_wgmma, launches_fwd_simt
    raise_if_grad([x, w], _GRAD_PATH)
    nt, tm = _tiling(x, tile_expert)
    e, n = _weight_shape(x, w, transpose_w)
    check_launch("gmm_cuda", [x, w], [])
    _check_table(tile_expert, x, tm)
    chosen = gmm_variant(x, w, transpose_w)
    y = torch.empty(x.shape[0], n, dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(), y.data_ptr(), x.shape[0],
            x.shape[1], n, e, tm, int(transpose_w))
    with torch.cuda.device(x.device):
        if chosen == "wgmma":
            err = _library().gmm_fwd_wgmma(*args, _stream(x.device))
        else:
            err = _library().gmm_fwd(*args, int(x.dtype == torch.bfloat16), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gmm forward kernel ({chosen}) failed: cudaError_t {err}")
    with COUNT_LOCK:
        launches_fwd += 1
        if chosen == "wgmma":
            launches_fwd_wgmma += 1
        else:
            launches_fwd_simt += 1
    return y


def gmm_torch(x: Tensor, w: Tensor, tile_expert: Tensor, transpose_w: bool = False) -> Tensor:
    """The forward kernel's function in plain PyTorch, on any device: one
    fp32 product per row tile against its expert's weight, rounded to x's
    dtype. Differentiable by autograd."""
    nt, tm = _tiling(x, tile_expert)
    _weight_shape(x, w, transpose_w)
    wf = w.float().transpose(1, 2) if transpose_w else w.float()
    xf, te = x.float(), tile_expert.long()
    # index_select, not w[te[i]]: a 0-d index would be read on the host
    tiles = [xf[i * tm:(i + 1) * tm] @ wf.index_select(0, te[i:i + 1])[0] for i in range(nt)]
    return torch.cat(tiles, 0).to(x.dtype)


# ---------------------------------------------------------------------------
# Row 10: dw
# ---------------------------------------------------------------------------


def _check_dw(x: Tensor, g: Tensor, tile_expert: Tensor, n_experts: int) -> Tuple[int, int]:
    nt, tm = _tiling(x, tile_expert)
    if g.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"want g [{x.shape[0]}, H]; got {tuple(g.shape)}")
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")
    return nt, tm


def gmm_dw_cuda(x: Tensor, g: Tensor, tile_expert: Tensor, n_experts: int) -> Tensor:
    """Launch the dw kernel on the current stream -> dw [E, D, H] fp32 for x
    [M, D] and g [M, H] (bf16 or fp32, one dtype) under a non-decreasing tile
    table. Every element is written (an expert without tiles gets 0). The
    kernel is ``gmm_dw_variant``'s choice. Raises on anything it does not
    take, as ``gmm_cuda``."""
    global launches_dw, launches_dw_wgmma, launches_dw_simt
    raise_if_grad([x, g], _GRAD_PATH)
    _, tm = _check_dw(x, g, tile_expert, n_experts)
    check_launch("gmm_dw_cuda", [x, g], [])
    _check_table(tile_expert, x, tm)
    chosen = gmm_dw_variant(x, g)
    start, count = expert_tiles(tile_expert, n_experts)
    dw = torch.empty(n_experts, x.shape[1], g.shape[1], dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), g.data_ptr(), start.data_ptr(), count.data_ptr(), dw.data_ptr())
    with torch.cuda.device(x.device):
        if chosen == "wgmma":
            err = _library().gmm_dw_wgmma(*ptrs, x.shape[0], x.shape[1], g.shape[1], n_experts,
                                          tm, _stream(x.device))
        else:
            err = _library().gmm_dw(*ptrs, x.shape[1], g.shape[1], n_experts, tm,
                                    int(x.dtype == torch.bfloat16), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gmm dw kernel ({chosen}) failed: cudaError_t {err}")
    with COUNT_LOCK:
        launches_dw += 1
        if chosen == "wgmma":
            launches_dw_wgmma += 1
        else:
            launches_dw_simt += 1
    return dw


def gmm_dw_torch(x: Tensor, g: Tensor, tile_expert: Tensor, n_experts: int) -> Tensor:
    """The dw kernel's function in plain PyTorch, on any device: each row
    tile's fp32 x_tile^T g_tile added into its expert's [D, H] block, in tile
    order; an expert without tiles stays 0."""
    nt, tm = _check_dw(x, g, tile_expert, n_experts)
    xf, gf, te = x.float(), g.float(), tile_expert.long()
    dw = torch.zeros(n_experts, x.shape[1], g.shape[1], dtype=torch.float32, device=x.device)
    for i in range(nt):
        rows = slice(i * tm, (i + 1) * tm)
        dw.index_add_(0, te[i:i + 1], (xf[rows].t() @ gf[rows])[None])
    return dw


# ---------------------------------------------------------------------------
# The autograd Function and the public entry
# ---------------------------------------------------------------------------


class GmmFn(torch.autograd.Function):
    """The grouped matmul with its backward on the kernels: the counterpart
    of the JAX package's ``gmm`` custom VJP.

    ``apply(x, w, tile_expert)``: the forward casts w to x's dtype and
    launches the forward kernel, saving x, the cast w and the table; the
    backward casts the cotangent to x's dtype and launches the forward kernel
    against w^T for dx and the dw kernel, whose fp32 result it casts to the
    weight's dtype. It calls the two ``*_cuda`` wrappers by their module
    names, so a test can stand their plain versions in for them."""

    @staticmethod
    def forward(ctx, x, w, tile_expert):
        wc = w.to(x.dtype)
        y = gmm_cuda(x, wc, tile_expert)
        ctx.save_for_backward(x, wc, tile_expert)
        ctx.w_dtype = w.dtype
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, wc, te = ctx.saved_tensors
        dyc = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm_cuda(dyc, wc, te, transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = gmm_dw_cuda(x, dyc, te, wc.shape[0]).to(ctx.w_dtype)
        return dx, dw, None


def gmm(x: Tensor, w: Tensor, tile_expert: Tensor, backend: str = "auto") -> Tensor:
    """y[r] = x[r] @ w[tile_expert[r // tile_rows]] over tile-aligned expert
    segments, in x's dtype (w is cast to it first); differentiable in x and
    w. ``backend`` (``ops/dispatch.py``): the kernels for CUDA tensors
    (through ``GmmFn`` when a gradient is wanted), the plain version for CPU
    tensors (differentiated by autograd)."""
    if resolve(backend, x.device) == "torch":
        return gmm_torch(x, w.to(x.dtype), tile_expert)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GmmFn.apply(x.contiguous(), w.contiguous(), tile_expert)
    return gmm_cuda(x.contiguous(), w.to(x.dtype).contiguous(), tile_expert)


__all__ = [
    "gmm", "gmm_cuda", "gmm_torch", "gmm_dw_cuda", "gmm_dw_torch", "GmmFn", "gmm_variant",
    "gmm_dw_variant", "pad_group_sizes", "tile_expert_table", "expert_tiles", "SOURCES",
    "TILE_MULTIPLE",
]
