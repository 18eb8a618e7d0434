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

A quantized model's leaves follow the same rules (their ``_q`` / ``_p4``
patterns): a column-parallel ``weight_q`` / ``weight_p4`` is cut along its
output channels with its ``_s`` scales beside it, a row-parallel one along
its input (packed) rows with its scales whole, and the int8 token table and
every other scale stay replicated (``tp_dims`` / ``fsdp_dims`` with
``quant``). The whole leaf is quantized first and then cut, the JAX order,
so a quantized state dict cuts like any other (``shard_whole``).

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

import itertools
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


def _axis_dims(cfg, axis: str, size: int, skip: Tuple[str, ...] = (),
               quant: str = "", classifier: bool = False) -> Dict[str, int]:
    """port state_dict key -> the dimension (in the port's layout) along
    which ``axis`` of ``size`` shards the leaf, for each leaf whose rule
    names the axis at a dimension the size divides; ``quant``: the leaves of
    that quantized model (``_q`` / ``_p4`` as their rules say, ``_s``
    replicated); ``classifier``: the leaves of its ``LRAClassifier``."""
    from orion_tpu_torch.convert import expected_params  # convert imports the model

    out: Dict[str, int] = {}
    if size <= 1:
        return out
    for path, (key, shape, transpose) in expected_params(cfg, quant, classifier).items():
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


def fsdp_dims(cfg, fsdp: int, quant: str = "", classifier: bool = False) -> Dict[str, int]:
    """The model's fsdp leaves at an fsdp size of ``fsdp`` (of its
    quantized form with ``quant``; of its ``LRAClassifier`` with
    ``classifier``, whose head kernel the rules cut along d): port
    state_dict key -> the dimension it is sharded along (in the port's
    layout). A leaf absent from the table is replicated: its rule names no
    fsdp dimension (the int8 token table, every ``_s`` scale, ``cls``, the
    classifier's bias), or the fsdp size does not divide that dimension."""
    return _axis_dims(cfg, "fsdp", fsdp, quant=quant, classifier=classifier)


def _out_dim(key: str, ndim: int) -> int:
    """The output-channel dimension of a quantized leaf in the port's
    layout: 0 of a dense ``weight_q`` [out, in], the last of ``weight_p4``
    [in/2, out] and of an expert stack [E, in, out]."""
    return 0 if key.endswith("weight_q") else ndim - 1


def tp_dims(cfg, tp: int, quant: str = "", classifier: bool = False) -> Dict[str, int]:
    """The model's tp leaves at a tp size of ``tp`` (of its quantized form
    with ``quant``): port state_dict key -> the dimension it is cut along
    (in the port's layout). A leaf absent from the table is whole on every
    tp rank: its rule names no tp dimension, it is one of ``TP_WHOLE``, or
    tp does not divide that dimension (an MLP or an expert stack whose
    hidden width tp does not divide; the classifier's head, whose rule names
    no tp). Raises ``ValueError`` when tp does not divide ``n_heads``.

    Quantized leaves follow their full-precision twins: a column-parallel
    ``_q`` / ``_p4`` leaf is cut along its output channels and its ``_s``
    scales with them (each rank scales its own channels); a row-parallel
    leaf (``wo``, ``down``, ``experts_down``) is cut along its input and its
    scales stay whole (each scale is the max over the whole input, so a
    rank's partial product takes the same scale). An int4 row-parallel
    ``weight_p4`` [in/2, out] is cut along its packed rows, which needs
    in / tp even: otherwise this raises, naming the leaf."""
    if tp > 1 and cfg.n_heads % tp:
        raise ValueError(f"tp={tp} does not divide n_heads={cfg.n_heads}: each tp rank holds "
                         "whole heads (the reference's per-head kernel calls need the same)")
    dims = _axis_dims(cfg, "tp", tp, TP_WHOLE, quant, classifier)
    if not quant or tp <= 1:
        return dims
    from orion_tpu_torch.convert import expected_params

    whole = _axis_dims(cfg, "tp", tp, TP_WHOLE)
    shapes = {key: shape for key, shape, _ in expected_params(cfg, quant).values()}
    for key, shape in shapes.items():
        if not key.endswith(("_q", "_p4")):
            continue
        base = key.rsplit("_", 1)[0]  # the full-precision twin's key
        if key.endswith("_p4") and base in whole and key not in dims:
            raise ValueError(f"int4 leaf {key} {tuple(shape)}: tp={tp} does not divide its "
                             f"{shape[0]} packed rows (in / tp must be even, two inputs a "
                             "byte); keep this model int8 at this tp")
        if key in dims and dims[key] == _out_dim(key, len(shape)) and base + "_s" in shapes:
            dims[base + "_s"] = len(shapes[base + "_s"]) - 1
    return dims


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
        """Replace each sharded parameter (or buffer: a quantized model's
        int8 / int4 tensors and scales) of ``model`` by this rank's shard."""
        for name, dim in self.dims.items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner)
            p = getattr(mod, attr)
            cut = shard_leaf(p.detach(), dim, self.size, self.index)
            if isinstance(p, torch.nn.Parameter):
                cut = torch.nn.Parameter(cut, requires_grad=p.requires_grad)
            setattr(mod, attr, cut)

    def shard_state(self, state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
        """A whole state dict (a checkpoint's, a one-rank run's) -> this
        rank's: each sharded leaf's shard, the rest as they are."""
        return {n: shard_leaf(t, self.dims[n], self.size, self.index) if n in self.dims else t
                for n, t in state.items()}


def whole_leaf(name: str, t: Tensor, axes) -> Tensor:
    """The leaf ``name`` whole on its device: this rank's ``t`` gathered over
    each ``AxisParams`` of ``axes`` in turn (fsdp's, then tp's) where it is
    sharded over it. A collective over each axis' group."""
    for ax in axes:
        if name in ax.dims:
            t = _gather_cat(t, ax.dims[name], ax.group)
    return t


def gather_whole(state: Mapping[str, Tensor], axes, keep: bool) -> Optional[Dict[str, Tensor]]:
    """This rank's state dict -> the whole one, on the host: each leaf, one
    at a time, gathered over each ``AxisParams`` of ``axes`` in turn (fsdp's,
    then tp's: fsdp cuts the tp shard) where it is sharded over it, then
    copied to the host. A collective over each axis' group; None where
    ``keep`` is false."""
    out: Dict[str, Tensor] = {}
    for n, t in state.items():
        full = whole_leaf(n, t, axes)
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
        """``p`` (the parameter or buffer ``name``) whole: gathered if it is
        an fsdp shard, as it is otherwise."""
        return gather_leaf(p, self.dims[name], self.group) if name in self.dims else p

    def gathered(self, module: torch.nn.Module, prefix: str) -> Dict[str, Tensor]:
        """The whole tensor of each fsdp leaf of ``module`` (whose params
        and buffers are named ``prefix + name`` in the model), by its name
        in ``module``."""
        leaves = itertools.chain(module.named_parameters(), module.named_buffers())
        return {n: gather_leaf(p, self.dims[prefix + n], self.group)
                for n, p in leaves if prefix + n in self.dims}

    def call(self, module: torch.nn.Module, prefix: str, *args, method: str = "forward"):
        """``module.<method>(*args)`` on its whole leaves (the fsdp ones
        gathered here, so a caller under ``checkpoint`` gathers them again
        in the backward; a prefill or a decode step gathers them at each
        call, as GSPMD does)."""
        whole = self.gathered(module, prefix)
        if method == "forward":
            return torch.func.functional_call(module, whole, args)
        return torch.func.functional_call(_Method(module, method),
                                          {"inner." + n: t for n, t in whole.items()}, args)


class _Method(torch.nn.Module):
    """``inner.<method>`` as a module's forward, for ``functional_call``."""

    def __init__(self, inner: torch.nn.Module, method: str):
        super().__init__()
        self.inner, self.method = inner, method

    def forward(self, *args):
        return getattr(self.inner, self.method)(*args)


__all__ = ["spec_for_path", "fsdp_dims", "tp_dims", "tp_whole_grads", "TP_WHOLE", "shard_leaf",
           "gather_leaf", "AxisParams", "FsdpParams", "gather_whole", "shard_whole", "whole_leaf"]
