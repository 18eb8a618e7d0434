"""Parallelism: the counterpart of ``orion_tpu/parallel``.

The JAX package lays one ``jax.sharding.Mesh`` over the chips and lets XLA
insert the collectives; the port runs one process a rank and calls
``torch.distributed``'s collectives itself, each differentiable where a
body needs its gradient (``collectives.py``). Ported so far (ROADMAP.md
A12 steps 1-3): the mesh's process groups with the dp, fsdp and sp axes
(``mesh.py``), the fsdp sharding rules and gathers (``sharding.py``),
sequence-parallel linear attention (``sequence.py``), and ring attention
with the sliding-window halo (``ring.py``), each body taking this rank's
shard of the tokens (the JAX package's ``*_local`` forms).
"""

from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_distributed

__all__ = ["Mesh", "MeshConfig", "init_distributed"]
