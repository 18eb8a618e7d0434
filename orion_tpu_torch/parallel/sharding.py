"""Parameter sharding over the fsdp axis: the counterpart of
``orion_tpu/parallel/sharding.py``.

The JAX package annotates each parameter with a ``PartitionSpec`` over the
(dp, fsdp, tp, sp, pp, ep) mesh and lets GSPMD insert the gathers. The port
keeps a copy of its rules (``_RULES``, ``spec_for_path``: the first rule
whose pattern matches a leaf's flax path wins) and reads only their
``fsdp`` dimension, the axis this slice ports: an fsdp leaf is held by each
rank of the fsdp group as one of ``fsdp`` equal chunks along that
dimension, gathered on use (``FsdpParams``, ``collectives.all_gather``);
every other leaf is replicated. The tp, pp and ep entries of the rules are
kept for their shape and read by nothing yet (ROADMAP.md A12).

The rules name the flax layout. The port stores a dense kernel [in, out] as
its transpose [out, in] (``convert.expected_params``' ``transpose`` flag),
so its fsdp dimension is the other one; every other leaf keeps the flax
layout. A leaf whose fsdp dimension the fsdp size does not divide stays
replicated, as ``param_shardings`` clips a spec.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch

from orion_tpu_torch.parallel.collectives import _gather_cat, all_gather

Tensor = torch.Tensor
Spec = Tuple[Optional[str], ...]

# ordered (regex over 'path/to/param', spec) rules -- first match wins; a
# copy of the JAX package's (the port imports nothing of it)
_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"experts_(gate|up)(_q)?$", ("ep", "fsdp", "tp")),
    (r"experts_down(_q)?$", ("ep", "tp", "fsdp")),
    (r"router/kernel$", (None, None)),
    (r"(wq|wk|wv|gate|up|phi_proj)/kernel(_q|_p4)?$", ("fsdp", "tp")),
    (r"(wo|down)/kernel(_q|_p4)?$", ("tp", "fsdp")),
    (r"lm_head_kernel(_q)?$", ("fsdp", "tp")),
    (r"head/kernel$", ("fsdp", None)),
    (r"(embed|embedding|pos_embed)/embedding_q$", (None, None)),
    (r"(embed|embedding|pos_embed)/embedding$", (None, "fsdp")),
    (r"favor_proj$", (None, None)),
    (r"", ()),  # norms, biases, scales, cls, everything else: replicated
)


def spec_for_path(path: str) -> Spec:
    """The partition spec of the leaf at flax ``path`` (a tuple of axis
    names or None, one a dimension; () = replicated)."""
    if "blocks_stacked/" in path:
        suffix = path.split("blocks_stacked/", 1)[1]
        for pat, spec in _RULES:
            if re.search(pat, suffix):
                return ("pp", *spec)
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return ()


def fsdp_dims(cfg, fsdp: int) -> Dict[str, int]:
    """The model's fsdp leaves at an fsdp size of ``fsdp``: port state_dict
    key -> the dimension it is sharded along (in the port's layout). A leaf
    absent from the table is replicated: its rule names no fsdp dimension,
    or the fsdp size does not divide that dimension."""
    from orion_tpu_torch.convert import expected_params  # convert imports the model

    out: Dict[str, int] = {}
    if fsdp <= 1:
        return out
    for path, (key, shape, transpose) in expected_params(cfg).items():
        spec = spec_for_path(path)
        if "fsdp" not in spec:
            continue
        i = spec.index("fsdp")
        if i >= len(shape):
            continue
        dim = len(shape) - 1 - i if transpose else i  # a transposed kernel is 2-D
        if shape[dim] % fsdp == 0:
            out[key] = dim
    return out


def shard_leaf(full: Tensor, dim: int, fsdp: int, index: int) -> Tensor:
    """Chunk ``index`` of ``fsdp`` equal chunks of ``full`` along ``dim``
    (a contiguous copy)."""
    return full.chunk(fsdp, dim)[index].contiguous().clone()


def gather_leaf(shard: Tensor, dim: int, group) -> Tensor:
    """The full leaf from every rank's shard along ``dim`` over the fsdp
    ``group``; differentiable (the backward reduce-scatters the cotangent,
    each rank keeping its chunk of the summed gradient)."""
    return all_gather(shard, group, dim)


class FsdpParams:
    """One model's fsdp leaves on this rank: ``dims`` (``fsdp_dims``), the
    fsdp ``group``, its size and this rank's index in it."""

    def __init__(self, dims: Dict[str, int], group, size: int, index: int):
        self.dims, self.group, self.size, self.index = dims, group, size, index

    def full(self, name: str, p: Tensor) -> Tensor:
        """``p`` (the parameter ``name``) whole: gathered if it is an fsdp
        shard, as it is otherwise."""
        return gather_leaf(p, self.dims[name], self.group) if name in self.dims else p

    def gathered(self, module: torch.nn.Module, prefix: str) -> Dict[str, Tensor]:
        """The whole tensor of each fsdp leaf of ``module`` (whose params
        are named ``prefix + name`` in the model), by its name in
        ``module``."""
        return {n: gather_leaf(p, self.dims[prefix + n], self.group)
                for n, p in module.named_parameters() if prefix + n in self.dims}

    def call(self, module: torch.nn.Module, prefix: str, *args):
        """``module(*args)`` on its whole parameters (the fsdp ones gathered
        here, so a caller under ``checkpoint`` gathers them again in the
        backward)."""
        return torch.func.functional_call(module, self.gathered(module, prefix), args)

    def shard_module(self, model: torch.nn.Module) -> None:
        """Replace each fsdp parameter of ``model`` by this rank's shard."""
        for name, dim in self.dims.items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner)
            p = getattr(mod, attr)
            setattr(mod, attr, torch.nn.Parameter(shard_leaf(p.detach(), dim, self.size,
                                                             self.index),
                                                  requires_grad=p.requires_grad))

    def shard_state(self, state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
        """A whole state dict (a checkpoint's, a dp=1 run's) -> this rank's:
        each fsdp leaf's shard, the rest as they are."""
        return {n: shard_leaf(t, self.dims[n], self.size, self.index) if n in self.dims else t
                for n, t in state.items()}

    def gather_state(self, state: Mapping[str, Tensor], keep: bool) -> Optional[Dict[str, Tensor]]:
        """This rank's state dict -> the whole one, on the host, one leaf at a
        time (a collective over the fsdp group: every rank of it calls);
        None where ``keep`` is false (a rank that only lends its shards)."""
        out: Dict[str, Tensor] = {}
        for n, t in state.items():
            full = _gather_cat(t, self.dims[n], self.group) if n in self.dims else t
            if keep:
                out[n] = full.detach().to("cpu", copy=True)
            del full
        return out if keep else None


__all__ = ["spec_for_path", "fsdp_dims", "shard_leaf", "gather_leaf", "FsdpParams"]
