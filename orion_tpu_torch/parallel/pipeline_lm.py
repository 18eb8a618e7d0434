"""The pipelined TransformerLM: the counterpart of
``orion_tpu/parallel/pipeline_lm.py`` over the port's GPipe schedule
(``parallel/pipeline.py``).

Depth is cut into stages of whole groups: ``stage_group`` is the smallest
period g of the model's (layer type, MoE) pattern (1 for the all-linear
models, 4 for ``hybrid_1b3``'s swa, swa, swa, linear), and stage p of pp
holds groups [p G / pp, (p + 1) G / pp) of the G = L / g groups
(``stage_blocks``), so pp must divide G. A stage's ``TransformerLM`` (built
with the mesh) holds only its own blocks, under their global names
(``blocks.{i}.*``); the embeddings, the final norm and the head are whole
on every stage, as the JAX package replicates them over pp.

- ``pp_lm_loss`` (the Trainer's step): stage 0 embeds each microbatch, every
  stage runs its blocks (each recomputed in the backward under
  ``cfg.remat``; the JAX package recomputes each group), the last stage
  applies the final norm and the fused head + cross entropy
  (``ops/fused_ce.py``), and the reverse schedule accumulates the
  gradients. The loss a rank returns is its share of the global mean: the
  last stage's token losses over the accumulation micro-batch's global
  token count, plus on every stage its blocks' MoE auxiliary loss,
  averaged over the microbatches (and over the data and sp ranks, whose
  shares the Trainer sums). Summed over the stages (and the data and sp
  ranks) it is the JAX package's ``pp_lm_loss``: the cross entropy plus the
  stages' summed aux averaged over the microbatches. Under pp x sp the
  load-balance term is the JAX pipeline body's, taken per sp shard (its sp
  axis is manual there: each shard's statistics over its own tokens, and
  the data ranks' under the partial-manual form) and averaged over the sp
  ranks; that differs from a pp=1 run's global term (JAX's
  ``test_moe_composes_with_pp_and_sp`` bounds it at 5e-3), while the cross
  entropy and the z-loss are linear in the shards' means and agree.
- ``pp_lm_logits`` / ``pp_lm_eval_sums``: the forward alone, the last
  stage's logits or cross-entropy sums.
- Dropout: block j of group slot s of stage p on microbatch m takes the
  seed ``fold(fold(fold(fold(seed, m), p), s), j)``, the JAX package's key
  folding (microbatch, then stage, then slot, then the group's block) on the
  port's ``utils/rng.fold``, and its masks are ``dropout_keep``'s under
  that seed at the global row of the global microbatch m (every data rank's
  share of it, in data-rank order) and the global token. The masks are the
  pipeline's own, as in the JAX package (not a pp=1 run's), and a rank's
  are its slice of a pp run's without the data and sp axes (under the
  partial-manual form, whose microbatches are the global ones).
- ``unstack_lm_params``: a JAX pipeline-layout param tree (``blocks_stacked``:
  every group's leaves stacked on a leading axis, ``{"sub_j": ...}`` a
  group, or the older layout without ``sub_0`` whose stacked elements are
  single blocks) back to the flax layout ``block_{i}``, in numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.parallel.pipeline import gpipe
from orion_tpu_torch.utils import rng as rngs

Tensor = torch.Tensor


def stage_group(cfg) -> int:
    """Smallest period g such that the block structure -- the layer type and
    MoE-or-dense MLP -- repeats with period g and g divides n_layers (the
    JAX package's rule; n_layers for an aperiodic pattern)."""
    sig = [(lt, cfg.moe_at(i)) for i, lt in enumerate(cfg.resolved_layer_types)]
    n = len(sig)
    for g in range(1, n):
        if n % g == 0 and all(sig[i] == sig[i % g] for i in range(n)):
            return g
    return n


def stage_blocks(cfg, pp: int, p: int) -> range:
    """The global indices of the blocks stage ``p`` of ``pp`` holds: whole
    groups of ``stage_group(cfg)`` blocks, G / pp of them. Raises
    ``ValueError`` unless pp divides the G groups."""
    g = stage_group(cfg)
    n_groups = cfg.n_layers // g
    if n_groups % pp:
        raise ValueError(f"pp={pp} must divide the {n_groups} stage groups (the layer pattern "
                         f"repeats with period {g} over {cfg.n_layers} layers)")
    per = cfg.n_layers // pp
    return range(p * per, (p + 1) * per)


def _stage_forward(model, m: int, h: Tensor, seed: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The stage's blocks on microbatch ``m``'s activation -> (output, their
    summed MoE auxiliary loss). Each block is recomputed in the backward
    under ``cfg.remat`` (every block: the Trainer sets ``remat_skip`` to 0
    under pp); under fsdp a block gathers its leaves inside that region."""
    from torch.utils.checkpoint import checkpoint

    from orion_tpu_torch.models.transformer import DropoutKey, _remat_context

    cfg = model.cfg
    g = stage_group(cfg)
    key = None
    if seed is not None:
        key = rngs.fold(rngs.fold(seed, m), model.pp.pp_rank)
        origin = model.dropout_origin(h.shape[0], h.shape[1])
    context_fn = _remat_context(cfg.remat_policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    aux_total = torch.zeros((), device=h.device)
    for k, (i, blk) in enumerate(model.blocks.items()):
        s = None if key is None else DropoutKey(rngs.fold(rngs.fold(key, k // g), k % g),
                                                *origin)
        fn = blk if model.fsdp is None else (
            lambda x, sd, mask, _b=blk, _i=i: model.fsdp.call(_b, f"blocks.{_i}.", x, sd, mask))
        if cfg.remat and torch.is_grad_enabled():
            h, aux = checkpoint(fn, h, s, None, use_reentrant=False, preserve_rng_state=False,
                                **kwargs)
        else:
            h, aux = fn(h, s, None)
        if aux is not None:
            aux_total = aux_total + aux
    return h, aux_total


def _micro(model, tokens: Tensor, n_micro: int) -> Tuple[Tensor, Tensor]:
    """tokens [B, T] -> (the microbatches [n_micro, B / n_micro, T], their
    positions: the sp shard's global positions on a sequence-parallel
    model)."""
    b, t = tokens.shape
    if b % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide this rank's {b} rows")
    first = model.sp.sp_rank * t if model.sp is not None else 0
    return (tokens.reshape(n_micro, b // n_micro, t),
            torch.arange(first, first + t, device=tokens.device))


def _run(model, tokens: Tensor, n_micro: int, last, backward: bool, seed=None,
         aux_weight: float = 1.0):
    """``gpipe`` of the model's stage over ``tokens`` [B, T] (this rank's
    rows and token shard) in ``n_micro`` microbatches."""
    mesh = model.pp
    micro, pos = _micro(model, tokens, n_micro)
    shape = (micro.shape[1], micro.shape[2], model.cfg.d_model)
    return gpipe(lambda m, h: _stage_forward(model, m, h, seed), n_micro, group=mesh.pp_group,
                 pp_rank=mesh.pp_rank, pp=mesh.pp, shape=shape, dtype=model.cdt,
                 device=model.device, first=lambda m: model._embed(micro[m], pos), last=last,
                 backward=backward, aux_weight=aux_weight)


def _split(model, batch: Tensor) -> Tuple[Tensor, Tensor]:
    """batch [B, T+1] -> (inputs, labels), this rank's token shard of each
    on a sequence-parallel model (shifted before sharding)."""
    x, y = batch[:, :-1], batch[:, 1:]
    if model.sp is not None:
        x, y = model.sp.shard(x), model.sp.shard(y)
    return x, y


def _token_losses(model, h: Tensor, y: Tensor) -> Tensor:
    from orion_tpu_torch.ops.fused_ce import _padded_fused_ce

    feats = model.final_norm(h)
    w, w_is_vd = model.head_weight()
    return _padded_fused_ce(feats.to(model.cdt), w if w_is_vd else w.t(), y)


def pp_lm_loss(model, batch: Tensor, n_micro: int, dropout_seed: Optional[int] = None) -> Tensor:
    """batch [B, T+1] (this rank's rows of one accumulation micro-batch, as
    ``n_micro`` consecutive microbatches) -> this rank's share of the loss
    (see the module docstring), detached, after running the schedule's
    backward: the stage's parameters hold their gradients of it."""
    x, y = _split(model, batch)
    n_data = model.n_data
    count = batch.shape[0] * n_data * (batch.shape[1] - 1)
    ys = y.reshape(n_micro, -1, y.shape[-1])

    def last(m, h):
        return _token_losses(model, h, ys[m]).sum() / count

    # the aux is the same on the data ranks of the partial-manual form (its
    # statistics are global over them) and a shard's own under sp
    n_sp = model.sp.sp if model.sp is not None else 1
    results, auxes = _run(model, x, n_micro, last, True, dropout_seed,
                          aux_weight=1.0 / (n_micro * n_data * n_sp))
    total = torch.zeros((), device=model.device)
    for r in results + auxes:
        total = total + r
    return total


def pp_lm_logits(model, tokens: Tensor, n_micro: int, return_aux: bool = False):
    """tokens [B, T] -> the logits [B, T, V] (fp32) on the last stage, None
    on the others: the forward alone through the schedule. ``return_aux``:
    also the blocks' MoE auxiliary loss summed over the stages and averaged
    over the microbatches (and the sp shards), on every stage (a sum over
    the pp group)."""
    from orion_tpu_torch.parallel.collectives import all_reduce_sum_

    with torch.no_grad():
        results, auxes = _run(model, tokens, n_micro, lambda m, h: model._head(h), False)
    logits = torch.cat(results) if results else None
    if not return_aux:
        return logits
    aux = torch.zeros((), device=model.device)
    for a in auxes:
        aux = aux + a
    aux = (aux / n_micro).reshape(1)
    if model.pp.pp_group is not None:
        all_reduce_sum_([aux], model.pp.pp_group)
    if model.sp is not None:  # each sp shard's term, averaged (the JAX pipeline's pmean)
        all_reduce_sum_([aux], model.sp.sp_group)
        aux = aux / model.sp.sp
    return logits, aux[0]


def pp_lm_eval_sums(model, batch: Tensor, n_micro: int) -> Tuple[Tensor, Tensor]:
    """batch [B, T+1] -> (sum of next-token cross entropy, token count) of
    this rank's rows and token shard on the last stage, zeros on the others
    (``evaluate.lm_eval_sums``' definition: the aux left out)."""
    x, y = _split(model, batch)
    ys = y.reshape(n_micro, -1, y.shape[-1])
    with torch.no_grad():
        results, _ = _run(model, x, n_micro, lambda m, h: _token_losses(model, h, ys[m]), False)
    s = torch.zeros((), device=model.device)
    for r in results:
        s = s + r.sum()
    c = float(y.numel()) if results else 0.0
    return s, torch.tensor(c, device=model.device)


def unstack_lm_params(tree: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """A JAX pipeline-layout param tree -> the flax layout (``block_{i}``),
    numpy leaves; a tree without ``blocks_stacked`` comes back as it is.
    Both stacked layouts: groups (``{"sub_j": ...}``, g = ``stage_group``)
    and the older one without ``sub_0`` (each stacked element one block)."""
    top = "params" in tree
    p = dict(tree["params"] if top else tree)
    if "blocks_stacked" not in p:
        return dict(tree)
    stacked = p.pop("blocks_stacked")
    g = stage_group(cfg)
    if "sub_0" not in stacked:
        g, stacked = 1, {"sub_0": stacked}

    def take(sub, k):
        if isinstance(sub, Mapping):
            return {n: take(v, k) for n, v in sub.items()}
        return np.asarray(sub)[k]

    for k in range(cfg.n_layers // g):
        for j in range(g):
            p[f"block_{k * g + j}"] = take(stacked[f"sub_{j}"], k)
    return {**tree, "params": p} if top else p


__all__ = ["stage_group", "stage_blocks", "pp_lm_loss", "pp_lm_logits", "pp_lm_eval_sums",
           "unstack_lm_params"]
