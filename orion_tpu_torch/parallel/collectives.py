"""Cross-rank primitives of the sequence-parallel bodies: the counterpart of
``orion_tpu/parallel/collectives.py``, plus the all_to_all behind the
striped ring's layout (``ring.py``) and the reductions of the trainer.

JAX differentiates its collectives for free (the transpose of a ppermute is
the reverse ppermute, and so on). ``torch.distributed``'s collectives have
no autograd, so each differentiable one here is a ``torch.autograd.Function``
whose backward is written out:

- ``ppermute_shift``: rank i's tensor goes to rank (i + shift) % n; its
  backward is the reverse shift;
- ``exclusive_prefix_sum``: the sum of the tensors of the ranks before this
  one; its backward is the reverse exclusive (suffix) sum of the
  cotangents;
- ``exchange`` (all_to_all): chunk p of rank i goes to rank p, where it is
  chunk i; its backward is the same exchange of the cotangents, which
  inverts it;
- ``all_gather`` (the fsdp gather of a parameter shard): the ranks' tensors
  concatenated along a dimension; its backward is a reduce-scatter of the
  cotangents (``reduce_scatter``);
- ``all_reduce_mean`` (the MoE's routing statistics over the data group):
  the mean of the ranks' tensors; its backward sums the cotangents over the
  group and divides by its size;
- ``copy_to_tp`` and ``reduce_from_tp``, Megatron's conjugate pair around a
  tensor-parallel region: the first is the identity forward and sums the
  cotangents over the tp group backward (the input of the column-sharded
  products, whose ranks each see a part of its gradient); the second sums
  the ranks' partial outputs forward (after a row-sharded product) and is
  the identity backward. Their sum is ``tp_sum``: the group's tensors
  gathered and added in group-rank order in fp32, rounded once to the
  input's dtype, so every rank of the group holds the same bits.

The pipeline's hop (``parallel/pipeline.py``) is point to point and not an
autograd Function: ``send_to`` hands a stage's output (or, backward, its
input's gradient) to a neighbour of the pp group without waiting for it
(the handle is waited on once the schedule's phase ends) and ``recv_from``
blocks until the neighbour's tensor arrives. Within a phase data moves one
way only (forward: stage p to p + 1; backward: p + 1 to p), so a stage that
both receives and sends cannot wait on a stage that waits on it.

Transport: under NCCL the gather and the reduce-scatter are
``all_gather_into_tensor`` / ``reduce_scatter_tensor``. Gloo has no
reduce-scatter, so there it is an ``exchange`` of the chunks and a sum in
group-rank order, and CUDA tensors are staged through host memory. The
choice follows the group's backend, which is the mesh's ``transport``.

Trouble spot: a collective's backward must run on every rank of the group,
in the same order, or the ranks wait on each other for ever. Autograd runs
a node only when some output of the graph depends on it, so the bodies
(``sequence.py``, ``ring.py``) make every rank's output depend on every
tensor it received, even where that rank's mask keeps none of it (``touch``),
and issue every collective on every rank. The groups are the mesh's
(``mesh.py``); on a gloo group, CUDA tensors are staged through host memory
(``_to_wire`` / ``_from_wire``), the compute stays on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _size_rank(group) -> tuple:
    return dist.get_world_size(group), dist.get_rank(group)


def _staged(x: Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(x: Tensor, group) -> Tensor:
    """``x`` as the group's transport takes it: contiguous, and on the host
    for gloo."""
    return x.detach().to("cpu").contiguous() if _staged(x, group) else x.detach().contiguous()


def _exchange_raw(chunks: Sequence[Tensor], group, dests: Sequence[int],
                  srcs: Sequence[int]) -> List[Tensor]:
    """Send chunks[j] to group rank dests[j] and receive a tensor shaped as
    chunks[j] from group rank srcs[j], all at once. A pair naming this rank
    on both ends is a copy."""
    me = dist.get_rank(group)
    wires = [_to_wire(c, group) for c in chunks]
    recvs = [torch.empty_like(w) for w in wires]
    ops = []
    for w, r, dst, src in zip(wires, recvs, dests, srcs):
        if dst == me and src == me:
            r.copy_(w)
            continue
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, dst), group))
        ops.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [r.to(c.device) for r, c in zip(recvs, chunks)]


def _shift_raw(x: Tensor, group, shift: int) -> Tensor:
    n, me = _size_rank(group)
    return _exchange_raw([x], group, [(me + shift) % n], [(me - shift) % n])[0]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift_raw(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a ppermute: the cotangent goes back the other way
        return _shift_raw(g, ctx.group, -ctx.shift), None, None


def ppermute_shift(x: Tensor, group, shift: int = 1) -> Tensor:
    """Rotate shards around the ring: rank i's ``x`` goes to rank (i +
    shift) % n, and rank i receives rank (i - shift) % n's. Differentiable
    (the backward is the reverse shift)."""
    return _Shift.apply(x, group, shift)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _gather_cat(x: Tensor, dim: int, group) -> Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (``group`` None: the world). Not differentiable (``all_gather`` is)."""
    n, _ = _size_rank(group)
    if _nccl(group):
        moved = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0], *moved.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.to(x.device) for p in parts], dim)  # the strided copy on the device


def _reduce_scatter_raw(x: Tensor, dim: int, group) -> Tensor:
    """This rank's chunk along ``dim`` of the sum of the group's tensors."""
    n, _ = _size_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split into "
                         f"{n} chunks")
    if _nccl(group):
        moved = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
        return out.movedim(0, dim)
    chunks = [c.contiguous() for c in x.detach().chunk(n, dim)]
    got = _exchange_raw(chunks, group, list(range(n)), list(range(n)))
    out = got[0].clone()
    for g in got[1:]:  # the sum in group-rank order
        out += g
    return out


def _all_reduce_sum(x: Tensor, group) -> Tensor:
    out = x.detach().clone()
    all_reduce_sum_([out], group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        # rank i's shard reaches every rank's output: the sum of the
        # cotangents, this rank's chunk of it
        return _reduce_scatter_raw(g, ctx.dim, ctx.group), None, None


def all_gather(x: Tensor, group, dim: int = 0) -> Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (on
    one process: ``torch.cat(xs, dim)`` of every rank's ``x``).
    Differentiable: the backward reduce-scatters the cotangents, so each
    rank gets its chunk of their sum over the group."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: Tensor, group, dim: int = 0) -> Tensor:
    """This rank's chunk along ``dim`` of the group's summed ``x`` (on one
    process: ``sum(xs).chunk(n, dim)[rank]``). Not differentiable."""
    return _reduce_scatter_raw(x, dim, group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group) / dist.get_world_size(ctx.group), None


def all_reduce_mean(x: Tensor, group) -> Tensor:
    """The mean of the group's ``x`` on every rank (on one process:
    ``sum(xs) / n``). Differentiable: every rank's output depends on every
    rank's ``x``, so the backward sums the cotangents over the group (and
    divides by n)."""
    return _AllReduceMean.apply(x, group)


def tp_sum(x: Tensor, group) -> Tensor:
    """The sum of the group's ``x`` on every rank, bitwise the same on each:
    under NCCL one all-reduce (in fp32 for a narrower dtype); under gloo
    every rank's tensor gathered (staged through host memory for a CUDA
    tensor) and added in group-rank order in fp32. Rounded once to
    ``x.dtype``. Not differentiable (``copy_to_tp``, ``reduce_from_tp``)."""
    if _nccl(group):
        out = x.detach().to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out.to(x.dtype)
    parts = _all_gather(x, group)
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out.to(x.dtype)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each rank's column shard gives this input a part of its gradient
        return tp_sum(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return tp_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's partial output reaches the sum with weight 1
        return g, None


def copy_to_tp(x: Tensor, group) -> Tensor:
    """``x`` as it is, entering a tensor-parallel region: the backward sums
    the cotangents over the tp ``group`` (Megatron's ``f``)."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: Tensor, group) -> Tensor:
    """The sum over the tp ``group`` of the ranks' partial ``x`` (after a
    row-sharded product), leaving a tensor-parallel region; the backward is
    the identity (Megatron's ``g``)."""
    return _ReduceFromTp.apply(x, group)


def _all_gather(x: Tensor, group) -> Tensor:
    """[n, *x.shape]: every rank's ``x`` in group-rank order."""
    n, _ = _size_rank(group)
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.stack(parts).to(x.device)


class _ExclusivePrefix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        gathered = _all_gather(x, group)
        n, me = _size_rank(group)
        mask = (torch.arange(n, device=x.device) < me).to(gathered.dtype)
        return (gathered * mask.view(n, *([1] * x.dim()))).sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        # rank j's x reaches the outputs of the ranks after it: the reverse
        # exclusive (suffix) sum of their cotangents
        gathered = _all_gather(g, ctx.group)
        n, me = _size_rank(ctx.group)
        mask = (torch.arange(n, device=g.device) > me).to(gathered.dtype)
        return (gathered * mask.view(n, *([1] * g.dim()))).sum(dim=0), None


def exclusive_prefix_sum(x_local: Tensor, group) -> Tensor:
    """Sum over ranks j < mine of their ``x_local``: the cross-shard combine
    of sequence-parallel linear attention. One all_gather of the small
    per-rank tensors, then a masked sum (as the JAX package's). The backward
    is the reverse exclusive sum."""
    return _ExclusivePrefix.apply(x_local, group)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *chunks):
        ctx.group = group
        n, _ = _size_rank(group)
        return tuple(_exchange_raw(chunks, group, list(range(n)), list(range(n))))

    @staticmethod
    def backward(ctx, *grads):
        # the exchange is its own transpose: chunk p of rank i came from
        # chunk i of rank p, so its cotangent goes back there
        n, _ = _size_rank(ctx.group)
        return (None, *_exchange_raw(grads, ctx.group, list(range(n)), list(range(n))))


def exchange(chunks: Sequence[Tensor], group) -> List[Tensor]:
    """all_to_all: this rank's chunks[p] goes to rank p, and the result's
    [p] is rank p's chunk for this rank. One chunk per rank, each the same
    shape on every rank. Differentiable (the backward is the same exchange,
    which inverts it)."""
    return list(_Exchange.apply(group, *chunks))


def touch(x: Tensor, *received: Tensor) -> Tensor:
    """``x`` made to depend on ``received`` with no change to its value (x +
    0 * sum): a received tensor that a rank's mask leaves out still gets a
    (zero) cotangent, so its collective's backward runs on that rank too."""
    # one element of each, times 0: finite (a sum could overflow), and the
    # cotangent reaches the whole tensor as zeros
    zero = sum(r.reshape(-1)[:1].float().sum() for r in received) * 0.0
    return x + zero.to(x.dtype)


def all_reduce_sum_(tensors: Sequence[Tensor], group: Optional[dist.ProcessGroup] = None) -> None:
    """Sum ``tensors`` over the group in place, as one flat buffer a dtype
    (the trainer's loss sums and parameter gradients). Not differentiable."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        wire = flat.to("cpu") if _staged(flat, group) else flat
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
        if wire is not flat:
            flat.copy_(wire)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _Sent:
    """A send in flight: its work handle and the buffer it reads (the host
    copy of a CUDA tensor under gloo), kept alive until ``wait``."""

    def __init__(self, work, wire: Tensor):
        self.work, self.wire = work, wire

    def wait(self) -> None:
        self.work.wait()
        self.wire = None


def send_to(x: Tensor, group, dst: int) -> _Sent:
    """Send ``x`` to group rank ``dst`` without waiting (``isend``; a CUDA
    tensor under gloo is staged through host memory first) -> the handle
    to ``wait`` on before the schedule's phase ends."""
    wire = _to_wire(x, group)
    return _Sent(dist.isend(wire, dist.get_global_rank(group, dst), group), wire)


def recv_from(shape, dtype: torch.dtype, device, group, src: int) -> Tensor:
    """A tensor of ``shape`` and ``dtype`` from group rank ``src``, on
    ``device`` (received on the host under gloo, then copied over)."""
    dev = torch.device(device)
    on = dev if not (dev.type == "cuda" and dist.get_backend(group) == "gloo") else "cpu"
    buf = torch.empty(shape, dtype=dtype, device=on)
    dist.recv(buf, dist.get_global_rank(group, src), group)
    return buf.to(dev)


def broadcast_from(x: Tensor, group, src: int) -> Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (the others pass
    a tensor of its shape and dtype, whose values are not read): one
    broadcast, staged through host memory for a CUDA tensor under gloo. Not
    differentiable."""
    wire = _to_wire(x, group).clone()
    dist.broadcast(wire, dist.get_global_rank(group, src), group=group)
    return wire.to(x.device)


def any_rank(flag: bool, device, group: Optional[dist.ProcessGroup] = None) -> bool:
    """Is ``flag`` set on any rank of the group? One int reduced with MAX
    (on the host for gloo, on ``device`` for NCCL): the ranks of a mesh
    agree on when to stop, whichever of them saw the signal."""
    dev = torch.device(device)
    on = dev if dev.type == "cuda" and dist.get_backend(group) != "gloo" else torch.device("cpu")
    wire = torch.tensor([int(bool(flag))], dtype=torch.int32, device=on)
    dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)
    return bool(wire.item())


__all__ = ["ppermute_shift", "exclusive_prefix_sum", "exchange", "touch", "all_reduce_sum_",
           "all_gather", "reduce_scatter", "all_reduce_mean", "any_rank", "copy_to_tp",
           "reduce_from_tp", "send_to", "recv_from", "broadcast_from"]
