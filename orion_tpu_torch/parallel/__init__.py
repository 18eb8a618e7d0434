"""Parallelism: the counterpart of ``orion_tpu/parallel``.

The JAX package lays one ``jax.sharding.Mesh`` over the chips and lets XLA
insert the collectives; the port runs one process a rank and calls
``torch.distributed``'s collectives itself, each differentiable where a
body needs its gradient (``collectives.py``). Ported so far (ROADMAP.md
A12 steps 1-7): the mesh's process groups with the dp, fsdp, tp, sp and
pp axes (``mesh.py``), the GPipe schedule over the pp group and the
pipelined LM (``pipeline.py``, ``pipeline_lm.py``; the hop between stages
is ``collectives.send_to`` / ``recv_from``), the fsdp and tp sharding rules, cuts and gathers
(``sharding.py``; tp in the Megatron layout, its two conjugate
collectives ``copy_to_tp`` / ``reduce_from_tp`` in ``collectives.py``),
sequence-parallel linear attention (``sequence.py``), and ring attention
with the sliding-window halo (``ring.py``), each body taking this rank's
shard of the tokens (the JAX package's ``*_local`` forms) and, under tp,
its heads. Every mesh takes MoE layers (their load-balance statistics over
``Mesh.replica_group``, the data x sp ranks), dropout (masks keyed by
position) and, in ``train_lra``, the LRA classifier.
"""

from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_distributed

__all__ = ["Mesh", "MeshConfig", "init_distributed"]
