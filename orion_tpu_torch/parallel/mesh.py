"""Process groups for the port's parallelism: the counterpart of
``orion_tpu/parallel/mesh.py``.

The JAX package lays one ``jax.sharding.Mesh`` over all chips, with axes
(dp, fsdp, tp, sp, pp, ep), and lets XLA insert the collectives. The port
runs one process a rank (``torchrun``, or any launcher that gives each
process its rank) and a mesh is a set of ``torch.distributed`` process
groups, one for each axis above 1, whose collectives the code calls itself
(``parallel/collectives.py``).

This slice ports the ``sp`` axis, sequence parallelism: each rank of the
group holds a contiguous shard of every sequence's tokens
(``parallel/sequence.py``, ``parallel/ring.py``). ``dp`` resolves to the
devices the other axes leave, which must be 1 here; every other axis above 1
(dp, fsdp, tp, pp, ep) raises ``NotImplementedError`` naming ROADMAP.md's
A12, whose later steps port them.

Transport. ``init_distributed`` picks NCCL when each local rank has a card
of its own, and gloo when local ranks share one (NCCL refuses two ranks on
one device) or the device is the CPU; under gloo the collectives stage CUDA
tensors through host memory. The compute stays on the device either way.
The choice follows the topology alone (never a caught error) and is printed
to stderr.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, item 12 "
        "(parallelism): only the sp axis is)")


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
        """Raise for an axis above 1 that is not ported (all but sp)."""
        for name, n in zip(AXES, self.shape):
            if name != "sp" and n > 1:
                raise _not_ported(f"a device mesh with {name}={n} {self.shape}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process groups of a resolved ``MeshConfig`` as this rank sees
    them: its global ``rank`` of ``world``, its ``device``, the
    ``transport`` ("nccl" or "gloo") and the group of its sp axis."""

    cfg: MeshConfig
    rank: int
    world: int
    device: torch.device
    transport: str
    sp_group: Optional[dist.ProcessGroup]

    @property
    def sp(self) -> int:
        return self.cfg.sp

    @property
    def sp_rank(self) -> int:
        return dist.get_rank(self.sp_group) if self.sp_group is not None else 0

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
    cards than local ranks). A process group that is already up is reused.
    Axes other than sp above 1 raise (``MeshConfig.check``)."""
    rank = _env_int("RANK") if rank is None else rank
    world = _env_int("WORLD_SIZE") if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    local_world = (_env_int("LOCAL_WORLD_SIZE", world) if local_world_size is None
                   else local_world_size)
    resolved = cfg.resolve(world)
    resolved.check()
    if resolved.dp * resolved.sp != world:
        raise ValueError(f"mesh {resolved.shape} does not cover the {world} ranks")
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
    sp_group = None
    if resolved.sp > 1:  # dp is 1 here, so the sp group is every rank
        sp_group = dist.new_group(list(range(world)), backend=transport)
    return Mesh(resolved, rank, world, dev, transport, sp_group)


__all__ = ["AXES", "MeshConfig", "Mesh", "init_distributed", "transport_for"]
