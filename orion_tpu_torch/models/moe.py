"""Mixture-of-experts MLP: the single-device forms of
``orion_tpu/models/moe.py``.

``MoEMLP`` takes the place of the dense MLP in the blocks ``cfg.moe_at``
names. Its parameters keep the JAX layout: ``router`` [E, d] (the flax
kernel [d, E], transposed, as every dense weight of the port), and the
expert stacks ``experts_gate`` / ``experts_up`` [E, d, h] and
``experts_down`` [E, h, d]. Routing is the JAX package's: fp32 router
logits and softmax, greedy top-k (``top_k_choice``) with the gates
renormalized over the k picks, and a pre-weighted auxiliary loss
(``moe_aux_weight`` x Switch's load-balance term E sum_e f_e P_e +
``moe_zloss_weight`` x the router z-loss), which ``forward(x,
with_aux=True)`` returns beside the output where flax sows it into the
``"losses"`` collection (the blocks hand it up as a tensor, so a
recomputation under ``torch.utils.checkpoint`` cannot count it twice).

Two dispatch rules, as in the JAX package:

- capacity (the default; ``_capacity``): tokens in groups of
  ``moe_group_size`` consecutive tokens of one row, each expert taking at
  most C = ceil(cf k S / E) of a group's tokens in token order
  (``top_k_routing``); dense dispatch / combine einsums, no kernel. Decode
  ([B, D] input) is one group with C = B, so it never drops;
- dropless (``moe_dropless=True``): every token reaches its k experts. Three
  forms compute the same function:

  * ``_dropless_gmm`` (the JAX ``_dropless_gmm``): rows scattered into
    tile-aligned expert segments and the expert products on the grouped
    matmul kernels (``ops/kernels/gmm.py``, 128-row tiles). Taken when the
    backend resolves to ``"cuda"`` and at least 1024 rows are routed
    (prefill and training), the JAX gate;
  * ``_dropless_dense``: each expert's FFN on the whole batch, combined by
    the routed ids and gates. Taken on the card below that (decode's few
    rows): no segment size ever reaches the host, and each row's products
    are the ones the ragged form computes;
  * ``_dropless_ragged`` (the JAX ragged_dot form): rows sorted by expert
    (``counting_sort_perm``) and one product per expert segment. Taken for
    CPU tensors; it reads the segment sizes on the host.

Quantized (``quant="int8"`` or ``"int4"``: the expert stacks are int8 in
both modes, as in the JAX package): ``experts_{gate,up,down}_q`` [E, in,
out] int8 buffers with per-(expert, output channel) fp32 scales ``_s`` [E,
out]; every product runs in the compute dtype on the int8 values and its
fp32 output is multiplied by its expert's scales, then rounded (the capacity
form's einsums, the ragged form's segments, the dense form's experts). A
quantized layer never takes the gmm kernels, as in JAX: on the card its
dropless rows take the dense form at any row count.

On a mesh whose ranks hold distinct tokens (dp x fsdp above 1: each rank
its rows of the batch; a sequence-parallel model, ``sp``: each rank its
contiguous shard of every row's tokens) the load-balance term is the JAX
package's over the global batch, E sum_e f_e P_e of the global means, which
is not the mean of the ranks' terms: f (no gradient) and P
(``collectives.all_reduce_mean``, whose backward sums the cotangents) are
averaged over ``stats_group`` before the product, in both dispatch rules.
That group is ``Mesh.replica_group`` (the data ranks times the sp ranks of
this tp and pp rank: the ranks that hold distinct tokens) for a
sequence-parallel model, and the data group otherwise; every rank holds as
many tokens, so the mean of the ranks' means is the global mean. The
z-loss stays this rank's mean, and ``training/trainer.py::lm_loss`` adds
the weighted aux over the number of ranks in the group, so the ranks'
summed gradients count it once. Under pp the pipeline body computes the
term per sp shard, as the JAX pipeline does (its sp axis is manual there):
a stage's layers then average over the data group alone, and
``parallel/pipeline_lm.py`` averages the shards' terms.

The capacity form groups the tokens of one row by ``group_size`` of the
row's length, the global T under sp (the JAX package's ``_group_size`` of
the global sequence). Its groups must then lie inside one sp shard: where
T / sp is not a multiple of the group size S and the capacity C < S can
drop tokens, ``forward`` raises ``ValueError`` (pick a ``moe_group_size``
dividing T / sp). Where C = S (the serving capacity ``generate`` sets) no
token drops, every grouping computes the same function, and a straddling
shard is grouped by gcd(S, T / sp). The dropless forms route each token on
its own, so a rank routes its shard (on the card the tile-aligned form at
``GMM_MIN_ROWS`` routed rows, rows 9-10 on the shard's rows). A decode step
routes its rows token-locally and takes no collective; its expert stacks,
bf16 or ``_q`` with their scales, are the replicated ones or, under fsdp,
gathered whole for the call.

Under tp (``mesh`` with tp above 1 dividing the hidden width ``h``; ep
stays 1) the router stays whole on every tp rank, and each rank holds its
slice of the hidden dimension: ``experts_gate`` / ``experts_up`` [E, d,
h / tp] and ``experts_down`` [E, h / tp, d]. Every dispatch form runs its
expert products on that slice (rows 9-10 on the card in the tile-aligned
form) and sums the ranks' partial expert outputs over the tp group before
the gates combine them (``_tp_in`` / ``_tp_out``: the routing weights'
gradient then is the same on every tp rank, as the router's). This departs
from the JAX package on purpose: its MoE keeps ``ragged_dot`` under tp
(its manual gmm region would gather the tp-sharded stacks whole); the port
has no such constraint, and the function is the same.

Not ported (each raises ``NotImplementedError`` naming ROADMAP.md's item):
the expert-parallel forms (``_dropless_ep``, ``_dropless_ep_gmm``, the
``ep`` layout constraint: item 12, A12 step 8).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels.gmm import gmm, pad_group_sizes, tile_expert_table
from orion_tpu_torch.parallel.collectives import all_reduce_mean, copy_to_tp, reduce_from_tp
from orion_tpu_torch.parallel.mesh import Mesh, tp_of
from orion_tpu_torch.quant import check_mode

Tensor = torch.Tensor

GMM_TILE_ROWS = 128  # the tile-aligned form's row tile (the JAX package's tm)
GMM_MIN_ROWS = 1024  # routed rows from which the tile-aligned form is taken


def top_k_choice(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """probs [..., E] fp32 -> (ids [..., k] int64, gates [..., k] fp32):
    slot s is the argmax with the slots before it masked to -1, and the
    gates are the picked probabilities renormalized to sum to 1."""
    masked, ids, gates = probs, [], []
    for _ in range(k):
        idx = masked.argmax(-1)
        onehot = F.one_hot(idx, probs.shape[-1]).float()
        gates.append((probs * onehot).sum(-1))
        masked = torch.where(onehot > 0, -1.0, masked)
        ids.append(idx)
    g = torch.stack(gates, -1)
    return torch.stack(ids, -1), g / g.sum(-1, keepdim=True).clamp_min(1e-9)


def top_k_routing(probs: Tensor, k: int, capacity: int) -> Tuple[Tensor, Tensor, Tensor]:
    """probs [..., S, E] fp32 (each leading index one group) -> (dispatch
    [..., S, E, C] bool, combine [..., S, E, C] fp32, assign [..., S, E]
    fp32). Capacity positions are assigned token-major (t0s0, t0s1, t1s0,
    ...), so whether a token is dropped depends only on earlier tokens and
    its own earlier slots; a (token, slot) at position >= C is dropped."""
    *lead, s, e = probs.shape
    ids, gates = top_k_choice(probs, k)  # [..., S, k]
    oh = F.one_hot(ids, e).float()  # [..., S, k, E]
    flat = oh.reshape(*lead, s * k, e)
    pos = torch.cumsum(flat, -2) - flat  # 0-based in-expert positions
    pos_tok = (pos * flat).sum(-1).reshape(*lead, s, k)  # fp32, exact integers
    keep = pos_tok < capacity
    disp_ke = (oh > 0) & keep[..., None]  # [..., S, k, E]
    slot_oh = pos_tok[..., None] == torch.arange(capacity, device=probs.device)  # [..., S, k, C]
    disp_ksec = disp_ke[..., None] & slot_oh[..., None, :]  # [..., S, k, E, C]
    dispatch = disp_ksec.any(-3)
    combine = (disp_ksec.float() * gates[..., None, None]).sum(-3)
    return dispatch, combine, oh.sum(-2) / k


def counting_sort_perm(flat: Tensor, n_classes: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Stable grouping of ``flat`` ([M] class ids) by counting sort: (order
    [M], rank [M], counts [n_classes]) with ``flat[order]`` sorted and rank
    order's inverse. Elementwise ops, cumsums and one scatter: nothing waits
    for the host."""
    m = flat.shape[0]
    oh = (flat[:, None] == torch.arange(n_classes, device=flat.device)).long()
    counts = oh.sum(0)
    offs = torch.cumsum(counts, 0) - counts
    within = torch.cumsum(oh, 0) - oh  # rank within the own class
    rank = ((within + offs[None, :]) * oh).sum(1)
    order = torch.empty_like(rank).scatter_(0, rank, torch.arange(m, device=flat.device))
    return order, rank, counts


def group_size(t: int, target: int) -> int:
    """Largest divisor of ``t`` not above ``target``, so groups tile a
    sequence exactly; warns when it collapses far below the target (capacity
    dropping then stops binding)."""
    if target <= 0 or t <= target:
        return t
    for s in range(min(target, t), 0, -1):
        if t % s == 0:
            if s * 4 <= min(target, t):
                warnings.warn(
                    f"moe group size degenerated to {s} (target {target}, seq len {t} has no "
                    "larger divisor <= target); capacity-based dropping is ineffective at "
                    "tiny group sizes -- pick a seq len with a divisor near moe_group_size",
                    stacklevel=3,
                )
            return s
    return t


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, {item})"
    )


class MoEMLP(nn.Module):
    """The routed-expert MLP; see the module docstring. ``cdt`` is the
    compute dtype of the expert products (the router runs in fp32).
    ``mesh``: a ``parallel.mesh.Mesh``, over whose ``stats_group`` the
    load-balance statistics are averaged and whose tp group, when tp divides
    the hidden width, splits the expert stacks' hidden dimension. ``sp``:
    the mesh when the model is sequence-parallel (this layer then sees a
    shard of each row's tokens), else None."""

    def __init__(self, cfg: ModelConfig, cdt: torch.dtype, device=None, *,
                 mesh=None, quant: str = "", sp=None):
        super().__init__()
        if mesh is not None and (not isinstance(mesh, Mesh) or mesh.cfg.ep > 1):
            # a JAX-style mesh, or an ep axis: the expert-parallel forms
            raise _not_ported("expert parallelism (the ep forms of MoEMLP)",
                              "item 12 (parallelism), A12 step 8")
        self.sp = sp.sp if sp is not None else 1
        # the ranks holding distinct tokens: under sp the replica group, the
        # data x sp ranks of this tp rank (under pp, a stage's body takes the
        # term per sp shard, as the JAX pipeline does, so the data ranks)
        self.stats_group = None
        if mesh is not None:
            self.stats_group = (mesh.replica_group if sp is not None and mesh.pp == 1
                                else mesh.data_group)
        self.quant = check_mode(quant)
        e, k, h, d = cfg.n_experts, cfg.moe_top_k, cfg.resolved_mlp_hidden, cfg.d_model
        # the stacks are built whole and cut by the model (TransformerLM)
        tp = tp_of(mesh, h)
        self.tp_group = tp.tp_group if tp is not None else None
        if not 1 <= k <= e:
            raise ValueError(f"moe_top_k={k} must be in [1, n_experts={e}]")
        if cfg.mlp not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        self.cfg = cfg
        self.cdt = cdt
        # the capacity form's factor; generate() raises it for serving
        self.capacity_factor = cfg.moe_capacity_factor
        self.router = nn.Parameter(torch.empty(e, d, device=device))
        stacks = {"experts_up": (d, h), "experts_down": (h, d)}
        if cfg.mlp == "swiglu":
            stacks = {"experts_gate": (d, h), **stacks}
        for name, (d_in, d_out) in stacks.items():
            if quant:  # int8 in both modes, with per-(expert, out-channel) scales
                self.register_buffer(name + "_q", torch.zeros(e, d_in, d_out, dtype=torch.int8,
                                                              device=device))
                self.register_buffer(name + "_s", torch.ones(e, d_out, device=device))
            else:
                setattr(self, name, nn.Parameter(torch.empty(e, d_in, d_out, device=device)))

    def forward(self, x: Tensor, with_aux: bool = False):
        """x [B, T, D] (or [B, D] for decode) -> y like x in the compute
        dtype; with ``with_aux`` also the pre-weighted auxiliary loss, an
        fp32 scalar."""
        y, aux = (self._dropless if self.cfg.moe_dropless else self._capacity)(x, with_aux)
        return (y, aux) if with_aux else y

    # -- routing -------------------------------------------------------------

    def _logits(self, x: Tensor) -> Tensor:
        return F.linear(x.float(), self.router.float())  # flax Dense(dtype=float32)

    def _weighted_aux(self, f: Tensor, p: Tensor, logits: Tensor) -> Tensor:
        cfg = self.cfg
        if self.stats_group is not None:  # the global batch's means
            f = all_reduce_mean(f.detach(), self.stats_group)
            p = all_reduce_mean(p, self.stats_group)
        aux = cfg.n_experts * (f * p).sum()
        z = (torch.logsumexp(logits, -1) ** 2).mean()
        return cfg.moe_aux_weight * aux + cfg.moe_zloss_weight * z

    def _tp_in(self, rows: Tensor) -> Tensor:
        """The expert products' input entering the tp region (the identity
        without tp)."""
        return rows if self.tp_group is None else copy_to_tp(rows, self.tp_group)

    def _tp_out(self, ys: Tensor) -> Tensor:
        """The ranks' partial expert outputs summed over the tp group, before
        the gates weigh them (the identity without tp)."""
        return ys if self.tp_group is None else reduce_from_tp(ys, self.tp_group)

    def _ffn(self, lhs: Tensor, mm: Callable[[Tensor, str], Tensor]) -> Tensor:
        """The expert FFN on ``lhs`` with ``mm(rows, stack name)`` as each of
        its products."""
        if self.cfg.mlp == "swiglu":
            mid = F.silu(mm(lhs, "experts_gate")) * mm(lhs, "experts_up")
        else:
            mid = F.gelu(mm(lhs, "experts_up"), approximate="tanh")  # jax.nn.gelu
        return mm(mid, "experts_down")

    def _stack(self, name: str) -> Tuple[Tensor, Optional[Tensor]]:
        """(the stack [E, in, out] in the compute dtype, its int8 scales [E,
        out] or None)."""
        if self.quant:
            return getattr(self, name + "_q").to(self.cdt), getattr(self, name + "_s")
        return getattr(self, name).to(self.cdt), None

    def _scaled(self, y: Tensor, s: Optional[Tensor]) -> Tensor:
        """An int8 product's fp32 output times its scales, rounded to the
        compute dtype (no scales: y as it is)."""
        return y if s is None else (y.float() * s).to(self.cdt)

    # -- capacity dispatch ---------------------------------------------------

    def _groups(self, t_loc: int) -> Tuple[int, int]:
        """(group size, capacity) for a row of ``t_loc`` tokens on this rank:
        the JAX package's groups of the global row (T = t_loc sp); see the
        module docstring for a group that straddles an sp shard."""
        cfg, k, e = self.cfg, self.cfg.moe_top_k, self.cfg.n_experts
        s = group_size(t_loc * self.sp, cfg.moe_group_size)
        cap = min(s, max(k, math.ceil(self.capacity_factor * k * s / e)))
        if t_loc % s == 0:
            return s, cap
        if cap < s:
            raise ValueError(
                f"moe capacity groups of {s} tokens (moe_group_size={cfg.moe_group_size} over "
                f"the global sequence of {t_loc * self.sp}) straddle the sp shards of {t_loc} "
                f"tokens, and a capacity of {cap} < {s} drops tokens by group: pick a "
                f"moe_group_size dividing {t_loc} (the JAX package's groups would span two "
                "ranks)")
        g = math.gcd(s, t_loc)  # no token drops at C = S: any grouping is the same function
        return g, g

    def _capacity(self, x: Tensor, with_aux: bool) -> Tuple[Tensor, Optional[Tensor]]:
        cfg, dt = self.cfg, self.cdt
        e, k, d = cfg.n_experts, cfg.moe_top_k, x.shape[-1]
        if x.dim() == 2:  # decode: one group of B tokens, never dropping
            xg, cap = x[None], x.shape[0]
        else:
            s, cap = self._groups(x.shape[-2])
            xg = x.reshape(-1, s, d)  # [G, S, D]: consecutive tokens of one row
        logits = self._logits(xg)  # [G, S, E]
        probs = torch.softmax(logits, -1)
        dispatch, combine, assign = top_k_routing(probs, k, cap)
        aux = None
        if with_aux:
            aux = self._weighted_aux(assign.mean((0, 1)), probs.mean((0, 1)), logits)
        xe = torch.einsum("gsd,gsec->gecd", xg.to(dt), dispatch.to(dt))

        def mm(a: Tensor, name: str) -> Tensor:
            w, s = self._stack(name)
            return self._scaled(torch.einsum("gecd,edh->gech", a, w),
                                None if s is None else s[None, :, None, :])

        ye = self._tp_out(self._ffn(self._tp_in(xe), mm))
        y = torch.einsum("gecd,gsec->gsd", ye, combine.to(dt))
        return y.reshape(x.shape).to(dt), aux

    # -- dropless dispatch ---------------------------------------------------

    def _dropless(self, x: Tensor, with_aux: bool) -> Tuple[Tensor, Optional[Tensor]]:
        cfg = self.cfg
        e = cfg.n_experts
        x2 = x.reshape(-1, x.shape[-1])
        logits = self._logits(x2)  # [N, E]
        probs = torch.softmax(logits, -1)
        ids, gates = top_k_choice(probs, cfg.moe_top_k)  # [N, k] each
        aux = None
        if with_aux:
            f = F.one_hot(ids, e).float().mean((0, 1))
            aux = self._weighted_aux(f, probs.mean(0), logits)
        if (resolve(cfg.backend, x.device) == "cuda" and ids.numel() >= GMM_MIN_ROWS
                and not self.quant):
            y = self._dropless_gmm(x2, ids, gates)
        elif x.is_cuda:
            y = self._dropless_dense(x2, ids, gates)
        else:
            y = self._dropless_ragged(x2, ids, gates)
        return y.reshape(x.shape), aux

    def _combine(self, ys: Tensor, gates: Tensor) -> Tensor:
        """ys [N, k, d] (each token's k expert outputs) -> [N, d], weighted
        by the gates in the compute dtype."""
        return (ys * gates[..., None].to(self.cdt)).sum(1)

    def _dropless_ragged(self, x2: Tensor, ids: Tensor, gates: Tensor) -> Tensor:
        """Rows sorted by expert, one product per expert segment (the JAX
        ragged_dot form); the segment sizes are read on the host."""
        n, k = ids.shape
        dt = self.cdt
        order, rank, counts = counting_sort_perm(ids.reshape(-1), self.cfg.n_experts)
        sizes = counts.tolist()
        xs = x2.to(dt).index_select(0, order // k)

        def segments(lhs: Tensor, name: str) -> Tensor:
            w, s = self._stack(name)
            parts = lhs.split(sizes)
            return torch.cat([self._scaled(p @ w[i], None if s is None else s[i])
                              for i, p in enumerate(parts)])

        ys = self._tp_out(self._ffn(self._tp_in(xs), segments))
        return self._combine(ys.index_select(0, rank).reshape(n, k, -1), gates)

    def _dropless_dense(self, x2: Tensor, ids: Tensor, gates: Tensor) -> Tensor:
        """Every expert's FFN on all rows, each row then taking its k routed
        experts' outputs: E times the products of the routed form, for the
        few rows of a decode step, and no host read of the routing."""
        n, dt = x2.shape[0], self.cdt
        xd = self._tp_in(x2.to(dt))

        stacks: dict = {}  # each stack cast to the compute dtype once, not once per expert

        def expert(i: int) -> Tensor:
            def mm(a: Tensor, name: str) -> Tensor:
                if name not in stacks:
                    stacks[name] = self._stack(name)
                w, s = stacks[name]
                return self._scaled(a @ w[i], None if s is None else s[i])

            return self._ffn(xd, mm)

        ye = self._tp_out(torch.stack([expert(i) for i in range(self.cfg.n_experts)]))  # [E, N, d]
        rows = torch.arange(n, device=x2.device)[:, None]
        return self._combine(ye[ids, rows], gates)

    def _dropless_gmm(self, x2: Tensor, ids: Tensor, gates: Tensor) -> Tensor:
        """Rows scattered into tile-aligned expert segments (zero padding
        rows, which give zero outputs and add nothing to dw) and the expert
        products on the grouped matmul (``ops/kernels/gmm.py``), at most
        E x 127 padding rows. The scatter positions and the tile table are
        computed on the device."""
        cfg, dt = self.cfg, self.cdt
        e, (n, k), d = cfg.n_experts, ids.shape, x2.shape[-1]
        tm = GMM_TILE_ROWS
        flat = ids.reshape(-1)
        m = flat.shape[0]
        _, rank, counts = counting_sort_perm(flat, e)
        offs_tight = torch.cumsum(counts, 0) - counts
        seg, starts = pad_group_sizes(counts, tm)
        pos = starts.long()[flat] + (rank - offs_tight[flat])  # each row's padded slot
        m2 = -(-(m + e * tm) // tm) * tm
        src = x2.to(dt).repeat_interleave(k, 0)  # row r of flat is token r // k
        xs = torch.zeros(m2, d, dtype=dt, device=x2.device).index_copy(0, pos, src)
        te = tile_expert_table(seg, m2 // tm, tm)
        ys = self._tp_out(self._ffn(self._tp_in(xs), lambda a, name: gmm(
            a, getattr(self, name), te, backend=cfg.backend)))
        return self._combine(ys.index_select(0, pos).reshape(n, k, d), gates)


__all__ = [
    "MoEMLP", "top_k_choice", "top_k_routing", "counting_sort_perm", "group_size",
    "GMM_TILE_ROWS", "GMM_MIN_ROWS",
]
