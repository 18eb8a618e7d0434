"""Ring attention and the sliding-window halo: exact softmax attention over
sp-sharded sequences, the counterpart of ``orion_tpu/parallel/ring.py``.

Softmax layers cannot carry a state across shards: the keys themselves must
reach every query. Each rank holds its shard's q and passes the (k, v)
block around the ring (``ppermute_shift``), folding each block it holds
into a running online-softmax accumulator (m, l, acc).

- Contiguous ring (``striped=False``): rank i holds tokens [i T/n, (i+1)
  T/n). A block from rank j is wholly visible when j < i, the causal
  triangle when j == i, and hidden when j > i (with a window, hidden too
  when the band misses it). The JAX package skips hidden blocks with
  ``lax.cond``; here a hidden block costs no products, but its k and v are
  ``touch``-ed into the accumulator (``collectives.py``), so the block's
  shifts still get their backward on that rank (rank 0 skips every block
  but its own: the skewed case).
- Striped ring (``striped=True``, full-causal only): the tokens are dealt
  round-robin (global token g on rank g % n, local row g // n) by one
  all_to_all a tensor (``_to_striped``); every (i, j) block is then the
  near-triangle c < p, plus the diagonal c == p when j <= i: equal work on
  every rank and step. With ``kernel_blocks`` each step is one flash call
  (``flash_attention_lse``, rows 6-8 on the card) with ``shift = 0 if j <= i
  else 1`` (the strict triangle), merged by log-sum-exp (``_lse_merge``).
- Halo (``swa_halo_attention_local``): a sliding window of W reaches W - 1
  tokens back, so rank i needs only the h = ceil((W - 1) / T_loc) blocks
  before it: h shifts and h + 1 flash calls, the halo block m at
  ``q_offset = m T_loc``, merged by log-sum-exp.

A prefill on sp (``gather_kv``) hands decode the whole sequence's keys and
values: one all_gather of the rotated shards, the same on every rank.

The einsum folds of the contiguous and the XLA-striped bodies run outside
any kernel in the reference too, so they are plain torch here. Blocks are
merged in fp32. Gradients flow through every fold, the flash kernels' own
backward (with the lse's cotangent) and the collectives' written-out
backward; every rank issues the same collectives in the same order. Each
flash block takes its own cast of one fp32 copy of q, so the blocks'
gradients of q add in fp32 and are rounded to q's dtype once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels.flash_attention import flash_attention_lse
from orion_tpu_torch.parallel.collectives import _gather_cat, exchange, ppermute_shift, touch

Tensor = torch.Tensor

_NEG = -1e30


def _block_attend(q, k, v, m, l, acc, scale, mask):
    """Fold one (k, v) block into the online-softmax accumulator; ``mask``
    [Tq, Tk] bool or None. Masked pairs add exactly 0 to l and acc."""
    s = torch.einsum("...td,...sd->...ts", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("...ts,...sd->...td", p, v.float())
    return m_new, l_new, acc_new


def _lse_merge(m, l, acc, o_j, lse_j):
    """Fold one flash block result (o_j normalized within the block, lse_j)
    into the running (m, l, acc). A block whose lse is at or below the
    guard (-5e29: no key seen) adds nothing, whatever m is so far, so the
    merge does not depend on the order of the blocks."""
    m_new = torch.maximum(m, lse_j)
    alpha = torch.exp(m - m_new)
    w_j = torch.where(lse_j <= _NEG / 2, 0.0, torch.exp(lse_j - m_new))
    return m_new, l * alpha + w_j, acc * alpha + o_j.float() * w_j


def _finish(l, acc, dtype):
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe).to(dtype)


def _accumulators(q, v):
    shape = (*q.shape[:-1], 1)
    m = torch.full(shape, _NEG, dtype=torch.float32, device=q.device)
    return m, torch.zeros_like(m), torch.zeros(*q.shape[:-1], v.shape[-1], device=q.device)


def swa_halo_attention_local(
    q: Tensor, k: Tensor, v: Tensor, group, *, window: int, scale: Optional[float] = None,
    backend: str = "auto",
) -> Tensor:
    """Sliding-window causal attention over sp-sharded tokens as a halo
    exchange: q, k, v [..., T_loc, D] are this rank's shard -> its shard of
    the output. Rank i takes the previous h = min(ceil((W - 1) / T_loc), n
    - 1) blocks by h shifts and runs h + 1 flash calls: its own block
    (causal, window W), then block m (the shard of rank i - m) at
    ``q_offset = m T_loc``; merged by log-sum-exp. Exact against the global
    windowed softmax. A rank with fewer than m predecessors holds a wrapped
    block: the JAX package skips it with ``lax.cond``; here that rank makes
    no flash call for it and ``touch``-es the block into its accumulator,
    so the shifts' backward runs on every rank."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, i = dist.get_world_size(group), dist.get_rank(group)
    t_loc = q.shape[-2]
    # a query reaches back window - 1 tokens: W % T_loc == 1 (W 1 too) needs
    # one block fewer than ceil(W / T_loc)
    h = min(-(-(window - 1) // t_loc), n - 1)
    q32 = q.float()
    o, lse = flash_attention_lse(q32.to(q.dtype), k, v, causal=True, window=window, scale=scale,
                                 backend=backend)
    m_run, l, acc = _accumulators(q, v)
    m_run, l, acc = _lse_merge(m_run, l, acc, o, lse)
    k_m, v_m = k, v
    for m in range(1, h + 1):
        # after m shifts this holds the block of rank i - m
        k_m = ppermute_shift(k_m, group)
        v_m = ppermute_shift(v_m, group)
        if i >= m:
            o_m, lse_m = flash_attention_lse(q32.to(q.dtype), k_m, v_m, causal=True,
                                             window=window, q_offset=m * t_loc, scale=scale,
                                             backend=backend)
            m_run, l, acc = _lse_merge(m_run, l, acc, o_m, lse_m)
        else:  # the wrapped block of a rank with fewer than m predecessors
            l = touch(l, k_m, v_m)
    return _finish(l, acc, q.dtype)


def _to_striped(x: Tensor, group, n: int) -> Tensor:
    """Contiguous shards -> striped: local row p ends up holding global
    token p n + i. One all_to_all; not self-inverse (``_from_striped``)."""
    t_loc, d = x.shape[-2], x.shape[-1]
    x4 = x.reshape(*x.shape[:-2], t_loc // n, n, d).transpose(-3, -2)  # [..., n(dest), T/n, d]
    got = exchange([x4[..., p, :, :] for p in range(n)], group)
    return torch.stack(got, dim=-3).reshape(*x.shape[:-2], t_loc, d)


def _from_striped(x: Tensor, group, n: int) -> Tensor:
    """The inverse of ``_to_striped``: the same exchange, the inverse local
    shuffle (the chunk from rank s goes back to rows s, s + n, ...)."""
    t_loc, d = x.shape[-2], x.shape[-1]
    x4 = x.reshape(*x.shape[:-2], n, t_loc // n, d)
    got = torch.stack(exchange([x4[..., s, :, :] for s in range(n)], group), dim=-3)
    return got.transpose(-3, -2).reshape(*x.shape[:-2], t_loc, d)


def ring_attention_local(
    q: Tensor, k: Tensor, v: Tensor, group, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None, striped: bool = False,
    backend: str = "auto", kernel_blocks: Optional[bool] = None,
) -> Tensor:
    """Exact softmax attention over the whole (sharded) sequence: q, k, v
    [..., T_loc, D] are this rank's shard -> its shard of the output.
    ``window``: the sliding-window variant (query t sees keys (t - W, t]).
    ``striped``: the load-balanced layout (module docstring), full-causal
    only. ``kernel_blocks`` (striped only): each step through
    ``flash_attention_lse`` with ``shift``; None takes them when ``backend``
    resolves to the kernels (CUDA tensors), as the JAX package takes them
    with a Pallas backend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, i = dist.get_world_size(group), dist.get_rank(group)
    t_loc = q.shape[-2]
    if striped:
        # raises, not asserts: wrong numerics under -O would be silent
        if not causal or window is not None:
            raise ValueError("striped ring is the full-causal form; swa keeps the contiguous "
                             "ring (a striped window loses locality)")
        if t_loc % n != 0:
            raise ValueError(f"striped ring needs T/sp divisible by sp (T_local={t_loc}, sp={n}) "
                             "so the layout exchange tiles evenly")
        q, k, v = (_to_striped(x, group, n) for x in (q, k, v))
    if kernel_blocks is None:
        kernel_blocks = striped and resolve(backend, q.device) == "cuda"
    if kernel_blocks and not striped:
        raise ValueError("kernel_blocks are the striped ring's (the contiguous ring's body is "
                         "the einsum fold, as in the JAX package)")
    q32 = q.float() if kernel_blocks else None
    row = torch.arange(t_loc, device=q.device)[:, None]
    col = torch.arange(t_loc, device=q.device)[None, :]
    m, l, acc = _accumulators(q, v)
    k_blk, v_blk = k, v
    for step in range(n):
        if step:  # the block of rank i - step: the previous one passed on
            k_blk = ppermute_shift(k_blk, group)
            v_blk = ppermute_shift(v_blk, group)
        j = (i - step) % n  # the rank whose block this is
        if striped and kernel_blocks:
            # the strict triangle when the key stripe's phase is ahead; a
            # Python int per step, as the kernel's tile predicates want it
            o_j, lse_j = flash_attention_lse(q32.to(q.dtype), k_blk, v_blk, causal=True,
                                             shift=0 if j <= i else 1, scale=scale,
                                             backend=backend)
            m, l, acc = _lse_merge(m, l, acc, o_j, lse_j)
        elif striped:
            # my row p holds global token p n + i, the block's column c holds
            # c n + j: attend iff c < p, or c == p when j <= i
            mask = (col < row) | ((col == row) & (j <= i))
            m, l, acc = _block_attend(q, k_blk, v_blk, m, l, acc, scale, mask)
        else:
            rows, cols = i * t_loc + row, j * t_loc + col  # absolute positions
            mask = torch.ones(t_loc, t_loc, dtype=torch.bool, device=q.device)
            if causal:
                mask &= rows >= cols
            if window is not None:
                mask &= (rows - cols) < window
            # whether the block holds a visible pair, from the ranks alone
            lo_gap = (i - j) * t_loc - (t_loc - 1)  # the least row - col
            hidden = (causal and i < j) or (window is not None and lo_gap >= window)
            if hidden:
                l = touch(l, k_blk, v_blk)
            else:
                m, l, acc = _block_attend(q, k_blk, v_blk, m, l, acc, scale,
                                          mask if causal or window is not None else None)
    out = _finish(l, acc, q.dtype)
    return _from_striped(out, group, n) if striped else out


def gather_kv(k: Tensor, v: Tensor, group):
    """The prefill's cache gather: this rank's rotated keys and values [...,
    T_loc, D] -> the whole sequence's [..., sp T_loc, D], the same on every
    rank of the group. One all_gather (k and v packed along the last
    dimension), the shards concatenated in rank order, which is the global
    order of contiguous shards. The caller places them into a softmax
    layer's KV cache or builds a swa layer's ring from them. Not
    differentiable (decode only)."""
    kv = _gather_cat(torch.cat([k, v.to(k.dtype)], dim=-1), -2, group)
    return kv[..., :k.shape[-1]], kv[..., k.shape[-1]:].to(v.dtype)


__all__ = ["ring_attention_local", "swa_halo_attention_local", "gather_kv"]
