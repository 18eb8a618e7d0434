"""Sequence-parallel causal linear attention: the counterpart of
``orion_tpu/parallel/sequence.py``.

Tokens are sharded over the sp group: rank i holds the contiguous shard i
of every sequence. Linear attention carries one [Dk, Dv] state per head
across the sequence, so the cross-shard information is that state, not
the keys. Per rank i:

    1. the local pass over its shard, from a zero state;
    2. S_0 = sum_{j<i} S_j and z_0 = sum_{j<i} z_j, the exclusive prefix of
       the ranks' final states (one all_gather of [B, H, Dk, Dv]: bytes
       independent of the sequence length);
    3. the prefix applied.

Two forms, as in the JAX package:

- parts (its Pallas form): one fused pass, ``linear_attention_parts``
  (rows 1, 3 and 4 on the card), hands back the fp32 numerator, the
  denominator and the shard's (S, z); the prefix then corrects them in
  O(T D): num + q S_0, den + q . z_0, and out = num / (den + eps). The fp32
  numerator comes from the kernel, never from a bf16 output;
- two_pass (its XLA form): the shard's states by einsum, the prefix, then
  the causal dot product seeded with S_0 and the denominator from a cumsum.

The prefill (``sp_linear_attention_prefill``) also needs the whole
sequence's state for decode, the same bits on every rank: one all_gather of
the ranks' (S, z) gives each rank both its exclusive prefix and the total,
summed in rank order.

Differentiable end to end: the exclusive prefix's backward is the reverse
exclusive sum (``collectives.py``), and every rank's output depends on the
prefix (rank 0's is a masked sum of zeros), so its backward runs on every
rank. q reaches the output through the pass and through the prefix terms;
both take it from one fp32 copy, so its two gradients add in fp32 and are
rounded to q's dtype once (the JAX package adds them in q's dtype).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from orion_tpu_torch.ops.dispatch import causal_dot_product, resolve
from orion_tpu_torch.parallel.collectives import _gather_cat, exclusive_prefix_sum

Tensor = torch.Tensor


def _local_states(k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    kf, vf = k.float(), v.float()
    return torch.einsum("...td,...te->...de", kf, vf), kf.sum(dim=-2)


def _sp_linear(q: Tensor, k: Tensor, v: Tensor, prefix, *, backend: str, chunk: Optional[int],
               eps: float, form: Optional[str]):
    """The body both public forms share: the shard's pass, the prefix
    (S_0, z_0) from ``prefix(S_loc, z_loc) -> (S_0, z_0, extra)``, and the
    corrected, normalized output -> (out in q's dtype, extra)."""
    from orion_tpu_torch.ops.kernels.causal_dot import linear_attention_parts

    if form is None:
        form = "parts" if resolve(backend, q.device) == "cuda" else "two_pass"
    if form not in ("parts", "two_pass"):
        raise ValueError(f"form must be 'parts', 'two_pass' or None, got {form!r}")
    qf = q.float()
    q_in = qf.to(q.dtype)  # the pass's operand: its gradient meets the prefix's in fp32
    if form == "parts":
        num_loc, den_loc, (s_loc, z_loc) = linear_attention_parts(
            q_in, k, v, chunk=chunk, backend=backend)
        s0, z0, extra = prefix(s_loc, z_loc)
        num = num_loc + torch.einsum("...td,...de->...te", qf, s0)
        den = den_loc + torch.einsum("...td,...d->...t", qf, z0)
        return (num / (den + eps)[..., None]).to(q.dtype), extra
    s0, z0, extra = prefix(*_local_states(k, v))
    num = causal_dot_product(q_in, k, v, backend=backend, chunk=chunk, initial_state=s0)
    zcum = torch.cumsum(k.float(), dim=-2) + z0[..., None, :]
    den = torch.einsum("...td,...td->...t", qf, zcum)
    return (num.float() / (den[..., None] + eps)).to(q.dtype), extra


def sp_linear_attention_local(
    q: Tensor, k: Tensor, v: Tensor, group, *, backend: str = "auto",
    chunk: Optional[int] = None, eps: float = 1e-6, form: Optional[str] = None,
) -> Tensor:
    """Normalized causal linear attention, exact across the shards: q, k
    (feature-mapped) [..., T/sp, Dk] and v [..., T/sp, Dv] are this rank's
    shard of the sequence -> its shard of the output, in q's dtype.

    ``form``: "parts" (one fused pass and the prefix correction) or
    "two_pass" (states, prefix, seeded pass); None takes "parts" when
    ``backend`` resolves to the kernels (CUDA tensors) and "two_pass"
    otherwise, as the JAX package takes its Pallas form with a Pallas
    backend. Either form runs on either backend."""

    def prefix(s_loc, z_loc):  # differentiable: the reverse exclusive sum is its backward
        return exclusive_prefix_sum(s_loc, group), exclusive_prefix_sum(z_loc, group), None

    return _sp_linear(q, k, v, prefix, backend=backend, chunk=chunk, eps=eps, form=form)[0]


def sp_linear_attention_prefill(
    q: Tensor, k: Tensor, v: Tensor, group, *, backend: str = "auto",
    chunk: Optional[int] = None, eps: float = 1e-6, form: Optional[str] = None,
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """The prefill's form of ``sp_linear_attention_local``: (this rank's
    shard of the output, the whole sequence's (S, z)), the state the same
    bits on every rank of the group. One all_gather of the ranks' local
    (S, z) (packed into one fp32 buffer); from it each rank takes the
    exclusive prefix (S_0, z_0) for its output and the total for the decode
    state, both summed in rank order. Rows the caller zeroed in k and v (a
    right-padded prompt's pad rows) add nothing to either. Not
    differentiable (decode only); ``form`` as ``sp_linear_attention_local``
    takes it."""

    def prefix(s_loc, z_loc):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        flat = torch.cat([s_loc.float().reshape(-1), z_loc.float().reshape(-1)])
        parts = _gather_cat(flat[None], 0, group)  # [n, |S| + |z|], rank order
        total = torch.zeros_like(flat)
        before = total
        for j in range(n):
            if j == me:
                before = total
            total = total + parts[j]
        ns = s_loc.numel()

        def unpack(buf):
            return buf[:ns].view_as(s_loc), buf[ns:].view_as(z_loc)

        return (*unpack(before), unpack(total))

    return _sp_linear(q, k, v, prefix, backend=backend, chunk=chunk, eps=eps, form=form)


__all__ = ["sp_linear_attention_local", "sp_linear_attention_prefill"]
