"""Parameter sharding over the fsdp and tp axes: the counterpart of
``orion_tpu/parallel/sharding.py``.

The JAX package annotates each parameter with a ``PartitionSpec`` over the
(dp, fsdp, tp, sp, pp, ep) mesh and lets GSPMD insert the gathers. The port
keeps a copy of its rules (``_RULES``, ``spec_for_path``: the first rule
whose pattern matches a leaf's flax path wins) and reads their ``fsdp`` and
``tp`` dimensions:

- tp (``tp_dims``): a tp leaf is cut into ``tp`` equal chunks along its tp
  dimension, one a rank of the tp group, for good: the Megatron layout, in
  which ``wq`` / ``wk`` / ``wv`` / ``gate`` / ``up`` (and the expert stacks'
  gate / up) are column shards and ``wo`` / ``down`` (``experts_down``) row
  shards, so each rank computes its heads and its slice of the hidden
  dimension and one sum over the group follows ``wo`` and ``down``
  (``models/transformer.py``, ``collectives.reduce_from_tp``). Two leaves
  whose rule names tp are held whole on every tp rank: ``phi_proj`` (one
  Dh -> Dh map that every head shares; its gradient is summed over the tp
  group, ``tp_whole_grads``) and the untied ``lm_head_kernel`` (the head
  reads the whole hidden state; a memory difference, not one in results);
- fsdp (``fsdp_dims``): an fsdp leaf is held by each rank of the fsdp group
  as one of ``fsdp`` equal chunks along that dimension, gathered on use
  (``FsdpParams``, ``collectives.all_gather``). Under both, the tp shard is
  what fsdp cuts: no rule names tp and fsdp on one dimension.

Every other leaf is replicated. The pp entries (the JAX pipeline's stacked
``blocks_stacked`` layout) and the ep entries of the rules are kept for
their shape and read by nothing: the port's pipeline keeps each stage's
blocks unstacked under their own names (``parallel/pipeline_lm.py``), and
ep is not ported yet (ROADMAP.md A12 step 8).

The rules name the flax layout. The port stores a dense kernel [in, out] as
its transpose [out, in] (``convert.expected_params``' ``transpose`` flag),
so its dimension is the other one; every other leaf keeps the flax layout.
A leaf whose dimension the axis size does not divide stays replicated over
that axis, as ``param_shardings`` clips a spec (an MLP then runs whole on
every tp rank); tp must divide ``n_heads``, as the reference's per-head
kernel calls need.
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


# the leaves whose rule names tp that every tp rank holds whole
TP_WHOLE = (r"phi_proj/kernel", r"lm_head_kernel")


def _axis_dims(cfg, axis: str, size: int, skip: Tuple[str, ...] = ()) -> Dict[str, int]:
    """port state_dict key -> the dimension (in the port's layout) along
    which ``axis`` of ``size`` shards the leaf, for each leaf whose rule
    names the axis at a dimension the size divides."""
    from orion_tpu_torch.convert import expected_params  # convert imports the model

    out: Dict[str, int] = {}
    if size <= 1:
        return out
    for path, (key, shape, transpose) in expected_params(cfg).items():
        spec = spec_for_path(path)
        if axis not in spec or any(re.search(pat, path) for pat in skip):
            continue
        i = spec.index(axis)
        if i >= len(shape):
            continue
        dim = len(shape) - 1 - i if transpose else i  # a transposed kernel is 2-D
        if shape[dim] % size == 0:
            out[key] = dim
    return out


def fsdp_dims(cfg, fsdp: int) -> Dict[str, int]:
    """The model's fsdp leaves at an fsdp size of ``fsdp``: port state_dict
    key -> the dimension it is sharded along (in the port's layout). A leaf
    absent from the table is replicated: its rule names no fsdp dimension,
    or the fsdp size does not divide that dimension."""
    return _axis_dims(cfg, "fsdp", fsdp)


def tp_dims(cfg, tp: int) -> Dict[str, int]:
    """The model's tp leaves at a tp size of ``tp``: port state_dict key ->
    the dimension it is cut along (in the port's layout). A leaf absent from
    the table is whole on every tp rank: its rule names no tp dimension, it
    is one of ``TP_WHOLE``, or tp does not divide that dimension (an MLP or
    an expert stack whose hidden width tp does not divide). Raises
    ``ValueError`` when tp does not divide ``n_heads``."""
    if tp > 1 and cfg.n_heads % tp:
        raise ValueError(f"tp={tp} does not divide n_heads={cfg.n_heads}: each tp rank holds "
                         "whole heads (the reference's per-head kernel calls need the same)")
    return _axis_dims(cfg, "tp", tp, TP_WHOLE)


def tp_whole_grads(cfg) -> Tuple[str, ...]:
    """The port keys of the leaves held whole on every tp rank that only the
    local heads read (``phi_proj``): each tp rank's gradient of one is its
    heads' share, summed over the tp group."""
    from orion_tpu_torch.convert import expected_params

    return tuple(key for path, (key, _, _) in expected_params(cfg).items()
                 if re.search(TP_WHOLE[0], path))


def shard_leaf(full: Tensor, dim: int, fsdp: int, index: int) -> Tensor:
    """Chunk ``index`` of ``fsdp`` equal chunks of ``full`` along ``dim``
    (a contiguous copy)."""
    return full.chunk(fsdp, dim)[index].contiguous().clone()


def gather_leaf(shard: Tensor, dim: int, group) -> Tensor:
    """The full leaf from every rank's shard along ``dim`` over the fsdp
    ``group``; differentiable (the backward reduce-scatters the cotangent,
    each rank keeping its chunk of the summed gradient)."""
    return all_gather(shard, group, dim)


class AxisParams:
    """One model's leaves sharded over one mesh axis on this rank: ``dims``
    (``fsdp_dims`` or ``tp_dims``), the axis' ``group``, its size and this
    rank's index in it."""

    def __init__(self, dims: Dict[str, int], group, size: int, index: int):
        self.dims, self.group, self.size, self.index = dims, group, size, index

    def shard_module(self, model: torch.nn.Module) -> None:
        """Replace each sharded parameter of ``model`` by this rank's shard."""
        for name, dim in self.dims.items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner)
            p = getattr(mod, attr)
            setattr(mod, attr, torch.nn.Parameter(shard_leaf(p.detach(), dim, self.size,
                                                             self.index),
                                                  requires_grad=p.requires_grad))

    def shard_state(self, state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
        """A whole state dict (a checkpoint's, a one-rank run's) -> this
        rank's: each sharded leaf's shard, the rest as they are."""
        return {n: shard_leaf(t, self.dims[n], self.size, self.index) if n in self.dims else t
                for n, t in state.items()}


def gather_whole(state: Mapping[str, Tensor], axes, keep: bool) -> Optional[Dict[str, Tensor]]:
    """This rank's state dict -> the whole one, on the host: each leaf, one
    at a time, gathered over each ``AxisParams`` of ``axes`` in turn (fsdp's,
    then tp's: fsdp cuts the tp shard) where it is sharded over it, then
    copied to the host. A collective over each axis' group; None where
    ``keep`` is false."""
    out: Dict[str, Tensor] = {}
    for n, t in state.items():
        full = t
        for ax in axes:
            if n in ax.dims:
                full = _gather_cat(full, ax.dims[n], ax.group)
        if keep:
            out[n] = full.detach().to("cpu", copy=True)
        del full
    return out if keep else None


def shard_whole(state: Mapping[str, Tensor], axes) -> Dict[str, Tensor]:
    """A whole state dict -> this rank's: cut by each ``AxisParams`` of
    ``axes`` in turn (tp's, then fsdp's)."""
    out = dict(state)
    for ax in axes:
        out = ax.shard_state(out)
    return out


class FsdpParams(AxisParams):
    """One model's fsdp leaves on this rank (``AxisParams`` of ``fsdp_dims``
    over the fsdp group), gathered whole where a block or the head reads
    them."""

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


__all__ = ["spec_for_path", "fsdp_dims", "tp_dims", "tp_whole_grads", "TP_WHOLE", "shard_leaf",
           "gather_leaf", "AxisParams", "FsdpParams", "gather_whole", "shard_whole"]
