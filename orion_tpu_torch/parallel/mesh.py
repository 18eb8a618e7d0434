"""Process groups for the port's parallelism: the counterpart of
``orion_tpu/parallel/mesh.py``.

The JAX package lays one ``jax.sharding.Mesh`` over all chips, with axes
(dp, fsdp, tp, sp, pp, ep), and lets XLA insert the collectives. The port
runs one process a rank (``torchrun``, or any launcher that gives each
process its rank) and a mesh is a set of ``torch.distributed`` process
groups, one for each axis above 1, whose collectives the code calls itself
(``parallel/collectives.py``).

Ported: the ``dp``, ``fsdp``, ``tp``, ``sp`` and ``pp`` axes, in any
combination. ``sp`` is sequence parallelism: each rank of the group holds a
contiguous shard of every sequence's tokens (``parallel/sequence.py``,
``parallel/ring.py``). ``dp`` and ``fsdp`` are the data axes: the ranks of
the data group (dp x fsdp) hold different rows of the global batch, and
``fsdp`` also shards the parameters and the optimizer state over its group
(``parallel/sharding.py``). ``tp`` is tensor parallelism in the Megatron
layout: the ranks of a tp group share rows and tokens and each holds 1 / tp
of the heads and of the MLP's hidden dimension (``models/transformer.py``).
``pp`` is the pipeline: the ranks of a pp group share rows, tokens and tp
shards, and stage p holds blocks [p L / pp, (p + 1) L / pp) of the model
(``parallel/pipeline.py``, ``parallel/pipeline_lm.py``); the embeddings,
the final norm and the head are whole on every stage. ``dp = -1`` resolves
to the ranks the other axes leave. ep above 1 raises
``NotImplementedError`` naming ROADMAP.md's A12 step 8, which ports it.

Rank layout: the JAX mesh's device order, ``reshape(dp, fsdp, tp, sp, pp,
ep)``, so with ep = 1 rank = (((d fsdp + f) tp + t) sp + s) pp + p: the
stages of one (d, f, t, s) are neighbours. A rank's row block of a global
batch is number d fsdp + f of dp fsdp equal blocks (the JAX package's
``P(("dp", "fsdp"))``); the tp, sp and pp ranks of one (d, f) share it, and
the tp and pp ranks of one (d, f, s) share its tokens too. Every group is
created by every rank, in the same order, including the groups a rank is
not in: ``dist.new_group`` is collective over all ranks.

Transport. ``init_distributed`` picks NCCL when each local rank has a card
of its own, and gloo when local ranks share one (NCCL refuses two ranks on
one device) or the device is the CPU; under gloo the collectives stage CUDA
tensors through host memory. The compute stays on the device either way.
The choice follows the topology alone (never a caught error) and is printed
to stderr.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, item 12 "
        "(parallelism): only the dp, fsdp, tp, sp and pp axes are; A12 step 8 ports ep)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes per axis; -1 on dp = every device the other axes leave."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        """dp resolved against ``n_devices`` (the JAX package's rule)."""
        known = self.fsdp * self.tp * self.sp * self.pp * self.ep
        dp = self.dp
        if dp == -1:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices do not divide into {self}")
            dp = n_devices // known
        if dp * known > n_devices:
            raise ValueError(f"mesh {dp}x{self.fsdp}x{self.tp}x{self.sp}x{self.pp}x{self.ep} > "
                             f"{n_devices} devices")
        return MeshConfig(dp, self.fsdp, self.tp, self.sp, self.pp, self.ep)

    @property
    def shape(self):
        return (self.dp, self.fsdp, self.tp, self.sp, self.pp, self.ep)

    def check(self) -> None:
        """Raise for an axis above 1 that is not ported (ep)."""
        for name, n in zip(AXES, self.shape):
            if name == "ep" and n > 1:
                raise _not_ported(f"a device mesh with {name}={n} {self.shape}")


def row_index(n_rows: int, n_blocks: int, block: int, accum: int = 1) -> np.ndarray:
    """The global rows of row block ``block`` of ``n_blocks``: in each of
    ``accum`` contiguous micro-batches of an ``n_rows`` batch, its
    ``block``-th equal share (the JAX Trainer's micro-batch reshape, then
    ``P(("dp", "fsdp"))`` on each micro-batch)."""
    if n_rows % accum or (n_rows // accum) % n_blocks:
        raise ValueError(f"a batch of {n_rows} rows in {accum} micro-batch(es) does not split "
                         f"into {n_blocks} row blocks")
    micro, share = n_rows // accum, n_rows // accum // n_blocks
    return np.concatenate([np.arange(i * micro + block * share, i * micro + (block + 1) * share)
                           for i in range(accum)])


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process groups of a resolved ``MeshConfig`` as this rank sees
    them: its global ``rank`` of ``world``, its ``device``, the
    ``transport`` ("nccl" or "gloo") and one group for each axis above 1
    (None for an axis of one rank): ``sp_group``, ``dp_group``,
    ``fsdp_group``, ``tp_group``, ``pp_group``; ``data_group``, the dp x fsdp
    ranks of this (t, s, p) (the ranks that hold different rows);
    ``shard_group``, the dp x sp ranks of this (f, t, p) (the ranks that hold
    the same fsdp shards); ``replica_group``, the dp x fsdp x sp ranks of this
    (t, p) (the ranks that hold the same tp shards of one stage's blocks:
    with tp = pp = 1 every rank). The leaves every stage holds whole (the
    embeddings, the final norm, the head) sum their gradients over
    ``trunk_group``, the dp x fsdp x sp x pp ranks of this t, or, cut by
    fsdp, over ``trunk_shard_group``, the dp x sp x pp ranks of this (f, t);
    with pp = 1 these are ``replica_group`` and ``shard_group``."""

    cfg: MeshConfig
    rank: int
    world: int
    device: torch.device
    transport: str
    sp_group: Optional[dist.ProcessGroup]
    dp_group: Optional[dist.ProcessGroup] = None
    fsdp_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    shard_group: Optional[dist.ProcessGroup] = None
    tp_group: Optional[dist.ProcessGroup] = None
    replica_group: Optional[dist.ProcessGroup] = None
    pp_group: Optional[dist.ProcessGroup] = None
    trunk_group: Optional[dist.ProcessGroup] = None
    trunk_shard_group: Optional[dist.ProcessGroup] = None

    @property
    def coords(self) -> Tuple[int, int, int, int]:
        """(d, f, t, s): this rank's index along dp, fsdp, tp and sp (its
        stage is ``pp_rank``)."""
        c = self.cfg
        r = self.rank // c.pp
        return (r // (c.fsdp * c.tp * c.sp), r // (c.tp * c.sp) % c.fsdp, r // c.sp % c.tp,
                r % c.sp)

    @property
    def pp(self) -> int:
        return self.cfg.pp

    @property
    def pp_rank(self) -> int:
        """This rank's stage p."""
        return self.rank % self.cfg.pp

    def stage_rank(self, p: int) -> int:
        """The global rank of stage ``p`` of this rank's (d, f, t, s)."""
        return self.rank - self.pp_rank + p

    @property
    def sp(self) -> int:
        return self.cfg.sp

    @property
    def dp(self) -> int:
        return self.cfg.dp

    @property
    def fsdp(self) -> int:
        return self.cfg.fsdp

    @property
    def tp(self) -> int:
        return self.cfg.tp

    @property
    def sp_rank(self) -> int:
        return self.coords[3]

    @property
    def tp_rank(self) -> int:
        return self.coords[2]

    @property
    def dp_rank(self) -> int:
        return self.coords[0]

    @property
    def fsdp_rank(self) -> int:
        return self.coords[1]

    @property
    def n_data(self) -> int:
        """The data ranks: dp x fsdp, the row blocks of a global batch."""
        return self.cfg.dp * self.cfg.fsdp

    @property
    def data_rank(self) -> int:
        """This rank's row block: d fsdp + f."""
        d, f, _, _ = self.coords
        return d * self.cfg.fsdp + f

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous shard of ``x`` along ``dim`` (the
        sequence), which the sp axis must divide."""
        t = x.shape[dim]
        if t % self.sp:
            raise ValueError(f"sequence length {t} is not a multiple of sp={self.sp}")
        return x.narrow(dim, self.sp_rank * (t // self.sp), t // self.sp)

    def row_index(self, n_rows: int, accum: int = 1) -> np.ndarray:
        """The global rows this rank takes of an ``n_rows`` batch split into
        ``accum`` micro-batches (``row_index``)."""
        return row_index(n_rows, self.n_data, self.data_rank, accum)

    def rows(self, x: torch.Tensor, accum: int = 1) -> torch.Tensor:
        """This rank's rows of a global batch ``x`` [B, ...]: its row block
        of each of ``accum`` contiguous micro-batches."""
        if self.n_data == 1:
            return x
        return x[torch.from_numpy(self.row_index(x.shape[0], accum)).to(x.device)]


def tp_of(mesh: Optional[Mesh], width: int) -> Optional[Mesh]:
    """``mesh`` when its tp axis is above 1 and divides ``width`` (the heads,
    or an MLP's or an expert stack's hidden dimension), else None: the layer
    then runs whole on every tp rank, as ``param_shardings`` clips a spec."""
    if mesh is None or mesh.tp <= 1 or width % mesh.tp:
        return None
    return mesh


def _group(shape: Tuple[int, ...], rank: int, varying: Tuple[int, ...], transport: str):
    """The group of the ranks that differ from ``rank`` only along the axes
    ``varying`` (indices into ``shape``, the (dp, fsdp, tp, sp, pp) sizes), or None
    when it holds one rank. Every rank creates every group of the partition,
    in the same order: ``dist.new_group`` is collective over all ranks."""
    buckets: Dict[tuple, List[int]] = {}
    for r, c in enumerate(itertools.product(*(range(n) for n in shape))):
        buckets.setdefault(tuple(c[a] for a in range(len(shape)) if a not in varying),
                           []).append(r)
    if len(next(iter(buckets.values()))) == 1:
        return None
    mine = None
    for key in sorted(buckets):
        g = dist.new_group(buckets[key], backend=transport)
        if rank in buckets[key]:
            mine = g
    return mine


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"init_distributed: {name} is not set; run under torchrun or pass "
                               "rank / world_size / init_method")
        return default
    return int(value)


def transport_for(device: torch.device, local_world: int, n_cards: int) -> str:
    """NCCL when each of ``local_world`` local ranks has a card of its own
    among ``n_cards``; gloo when they share one, or on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= n_cards else "gloo"


def init_distributed(
    cfg: MeshConfig,
    *,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
) -> Mesh:
    """Join the process group and build one group for each axis above 1:
    the counterpart of ``initialize_distributed`` + ``make_mesh``.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a caller of its own passes ``init_method`` (e.g.
    ``tcp://localhost:<port>``), ``rank`` and ``world_size``. ``device``:
    ``"cpu"``, or None / ``"cuda"`` for the card (local rank r takes card r
    under NCCL, all ranks share card 0 under gloo when there are fewer
    cards than local ranks). A process group that is already up is reused
    (a process may build several meshes over it, one after another, each
    rank calling with the same ``cfg``). ep above 1 raises
    (``MeshConfig.check``)."""
    rank = _env_int("RANK") if rank is None else rank
    world = _env_int("WORLD_SIZE") if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    local_world = (_env_int("LOCAL_WORLD_SIZE", world) if local_world_size is None
                   else local_world_size)
    resolved = cfg.resolve(world)
    resolved.check()
    covered = resolved.dp * resolved.fsdp * resolved.tp * resolved.sp * resolved.pp
    if covered != world:
        raise ValueError(f"mesh {resolved.shape}: dp * fsdp * tp * sp * pp = {covered} does not "
                         f"cover the {world} ranks")
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    transport = transport_for(dev, local_world, n_cards)
    if not dist.is_initialized():
        dist.init_process_group(transport, init_method=init_method or "env://", rank=rank,
                                world_size=world)
    elif dist.get_backend() != transport:
        raise RuntimeError(f"the process group is up with {dist.get_backend()}, this topology "
                           f"wants {transport}")
    print(f"orion_tpu_torch: rank {rank} of {world} on {dev}, transport {transport} "
          f"({local_world} local rank(s), {n_cards} card(s)"
          + (": CUDA tensors staged through host memory" if transport == "gloo"
             and kind == "cuda" else "") + ")", file=sys.stderr)
    shape = (resolved.dp, resolved.fsdp, resolved.tp, resolved.sp, resolved.pp)
    groups = {name: _group(shape, rank, varying, transport)
              for name, varying in (("sp_group", (3,)), ("dp_group", (0,)), ("fsdp_group", (1,)),
                                    ("data_group", (0, 1)), ("tp_group", (2,)),
                                    ("replica_group", (0, 1, 3)), ("pp_group", (4,)))}
    # the ranks holding one fsdp shard sum its gradient (without fsdp every
    # leaf is replicated over the replica group and sums there)
    groups["shard_group"] = (_group(shape, rank, (0, 3), transport) if resolved.fsdp > 1
                             else None)
    # the leaves every stage holds: the same groups across the stages
    if resolved.pp > 1:
        groups["trunk_group"] = _group(shape, rank, (0, 1, 3, 4), transport)
        groups["trunk_shard_group"] = (_group(shape, rank, (0, 3, 4), transport)
                                       if resolved.fsdp > 1 else None)
    else:
        groups["trunk_group"] = groups["replica_group"]
        groups["trunk_shard_group"] = groups["shard_group"]
    return Mesh(resolved, rank, world, dev, transport, **groups)


__all__ = ["AXES", "MeshConfig", "Mesh", "init_distributed", "transport_for", "row_index",
           "tp_of"]
