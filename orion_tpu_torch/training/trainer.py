"""Trainer: the LM train step, AdamW/Lion, warmup + cosine/linear/constant
schedules, gradient accumulation, the fused clip + finite guard, eval and
checkpoint glue.

The port's counterpart of ``orion_tpu/training/trainer.py`` on one card (or
the CPU). Mixed precision as the reference: fp32 params, activations in the
model's compute dtype, fp32 logits, loss and grads. Every layer's
attention runs its forward kernel and its two backward kernels (linear
layers: ``ops/kernels/causal_dot.py``; softmax / swa layers:
``ops/kernels/flash_attention.py``); blocks are recomputed in the backward per
``cfg.model.remat`` / ``remat_skip``; the loss goes through the fused head +
cross entropy (``ops/fused_ce.py``).

The optimizers are written out rather than taken from ``torch.optim`` so
that they follow optax's formulas and order exactly: AdamW is
``chain(scale_by_adam, add_decayed_weights(mask), scale_by_learning_rate)``
with the first moment stored in ``mu_dtype``, and the learning rate is the
schedule at the optimizer's own count, which starts at 0 (so step 0's lr is
0 under warmup). Failure detection: each step computes ``finite =
isfinite(loss) & isfinite(grad_norm)``; on a bad step the params and the
optimizer state (its count with them) stay as they were and ``nonfinite``
counts the step, so the lr is indexed by the good-step count, ``step -
nonfinite``.

Adafactor (``Adafactor``): ``optimizer="adafactor"`` is optax's adafactor
in plain PyTorch; ``"adafactor_fused"`` runs each factored fp32 matrix
through the three fused kernels (``ops/kernels/adafactor.py``), which fold
the clip-and-guard scale and the skip policy, as the JAX package's Trainer
does.

Weight decay skips 1-D params and the fixed FAVOR+ projection
(``favor_proj``, by name, as the JAX package's ``_wd_mask``; it gets no
gradient, so its update is 0). ``param_storage="bfloat16_sr"`` stores every
matrix param (ndim >= 2) in bf16 and 1-D ones in fp32 (``storage_cast``);
the optimizer state and its math stay fp32, and each bf16 leaf's new value
``p + u`` is rounded to bf16 stochastically (``sr_round_bf16``), with noise
from the JAX package's counter hash (``sr_noise_bits``) on two 32-bit key
words: the same words give JAX's rounding bitwise. The words come from the
step's seed: ``fold(fold(step_seed, 0x5157), leaf index)`` in the order of
``model.named_parameters()``, its high and low 32 bits, so a resumed run
replays the same roundings.

Sequence parallelism (``cfg.mesh.sp > 1`` with ``cfg.model.sequence_parallel``,
and a ``parallel.mesh.Mesh`` from ``init_distributed``): every rank builds
the same params from the seed and takes the same global batch; the inputs
and labels are shifted before sharding (the label of a shard's last token
is the next shard's first token), and each rank runs the model on its
token shard (``models/transformer.py``). The loss is the global token mean:
each rank's backward starts from its sum over the global count, and the
reported loss is the sum over the ranks. After the backward the parameter
gradients are summed over the sp group (one flat buffer a dtype), so every
rank clips and updates alike; logs and checkpoints are rank 0's, with a
barrier, and a checkpoint is the file an sp=1 run writes.

Data parallelism (``cfg.mesh`` with dp x fsdp above 1, in any combination
with sp): each rank takes its rows of the global batch with the JAX
package's micro-batch partition (the batch split into ``accum_steps``
contiguous micro-batches, each rank its row block of each,
``Mesh.row_index``), so ``batch_size`` and ``micro_batch`` must divide by dp
x fsdp. The loss is the global token mean (a rank's backward starts from its
sum over the global count; a MoE layer's aux over the data x sp ranks, whose
load-balance statistics it averages: ``models/moe.py``). After the
backward, the replicated leaves' gradients are summed over every rank (one
flat buffer a dtype) and the fsdp shards' -- reduce-scattered over the fsdp
group by the gather's backward -- over the ranks that hold the same shard
(dp x sp). The global norm counts each shard once (its squares summed over
the fsdp group), so every rank clips, guards and skips alike. AdamW and
Lion update each rank's shards in place, their moments sharded alike; on a
data mesh without fsdp every optimizer but ``adafactor_fused`` runs on the
replicated leaves. ``adafactor_fused`` on any mesh of more than one rank
raises the JAX Trainer's ``ValueError``; ``adafactor`` and
``bfloat16_sr`` under fsdp raise ``NotImplementedError`` (factored
statistics and the rounding counter need the whole leaf). A checkpoint is
always the file a dp=1 run writes: under fsdp the fsdp group of rank 0
gathers each leaf, one at a time, into rank 0's host memory; a load on any
mesh takes this rank's shard of each leaf.

Tensor parallelism (``cfg.mesh.tp > 1``, in any combination with dp, fsdp
and sp): the ranks of a tp group take the same rows and tokens, and each
holds its tp shard of the heads and of the MLPs' (and expert stacks')
hidden dimension (``parallel/sharding.py``'s ``tp_dims``; fsdp then cuts
the tp shard). Every tp rank computes the same loss and the same gradient
of a leaf read outside the tp region (embeddings, norms, the router, the
head), so the loss and those gradients are summed over the replica group
(the ranks at the same tp index), not the world; the tp shards' gradients
too, or over the shard group at a fixed tp index under fsdp; and
``phi_proj`` (``feature_map="learnable"``: held whole on every tp rank, read
by the local heads only) is then also summed over the tp group. The global
norm sums the squares of the tp shards over the tp group. A checkpoint is
the file a tp=1 run writes: each leaf gathered over fsdp, then over tp, into
rank 0's host memory; a load on any mesh cuts it again. ``adafactor`` and
``bfloat16_sr`` under tp raise ``NotImplementedError`` naming A12 step 9
(the whole leaf again).

Resilience, as the JAX package's Trainer: ``train(preempt=, watchdog=)``
beats the watchdog each step (disarmed around an eval and every forced
save), fires the ``train.step_boundary`` fault hook after each step's
bookkeeping, and when the PreemptionGuard's ``should_stop`` is set saves an
emergency checkpoint at that boundary, sets ``preempted_at`` and returns,
resumable from exactly that step (flight events ``train_preempt`` and
``train_nonfinite``, dumps ``train-preempt`` and ``train-nan-halt``). On a
mesh the ranks first agree: the stop flag is reduced with MAX over every
rank at each boundary (``any_rank``), since each rank's guard may see a
forwarded SIGTERM at a different step and a rank that stopped alone would
leave its peers waiting in a collective; the emergency save is then the
mesh's collective save (``_save``). ``step`` poisons one leaf to NaN when
``resilience.inject.nan_armed`` fires for it (asked only while a fault plan
is armed) and puts the pre-step params back after the skipped update. A
``torch.cuda.OutOfMemoryError`` in a step's forward or backward with
``remat_skip > 0`` warns, drops the gradients and the allocator's cached
blocks, and retries that step once with every block recomputed
(``remat_skip=0``: the same math, less memory); on a mesh it re-raises, as a
rank that retried alone would desynchronise the collectives.

Pipeline parallelism (``cfg.mesh.pp > 1``, in any combination with dp,
fsdp, tp and sp): the JAX package's GPipe over depth. Stage p's ranks hold
its blocks (``parallel/pipeline_lm.py``'s ``stage_blocks``: pp must divide
the groups of ``stage_group`` blocks) and every stage the embeddings, the
final norm and the head; the params are drawn whole, as at pp=1, then cut.
``remat_skip`` is 0 under pp (every block recomputed, as the JAX Trainer
sets it). Each accumulation micro-batch runs through the schedule in
``pp_n_micro`` GPipe microbatches (``cfg.pp_microbatches``, or 0 for the
JAX Trainer's auto rule: the largest divisor of the base no larger than
``min(base, 4 pp)``), the base being the micro-batch, over dp x fsdp under
the full-manual form. ``pp_full_manual`` (``cfg.pp_full_manual``; None: on
when the backend resolves to the card's kernels with tp = fsdp = 1, the JAX
rule with "cuda" for "pallas") picks how a rank's rows form the
microbatches: full-manual, each data rank splits its own rows and its MoE
statistics are its own (the aux averaged over the data ranks);
partial-manual, microbatch m is every data rank's share of the global
microbatch m (``Mesh.row_index`` with ``accum_steps x n_micro``) and the
MoE statistics are global over the data group. Dense models give the same
loss either way. A rank's microbatch must be whole rows: n_micro must
also divide this rank's rows of a micro-batch, and a run where the auto
rule's n_micro does not (partial-manual with dp x fsdp > 1 at a small
batch) is refused, where the JAX Trainer would split rows over the data
devices. The gradients of a stage's blocks sum over the replica group
(this stage's ranks at this tp index), those of the leaves every stage
holds over ``trunk_group`` (every stage's), the loss too; the global norm
sums each stage's blocks' squares over the pp group and counts the other
leaves once. A checkpoint is the file a pp=1 run writes: each stage's
leaves gathered over fsdp and tp, then sent to rank 0; a load keeps this
stage's blocks. ``evaluate`` runs the pipelined forward.
``optimizer="adafactor"`` and ``param_storage="bfloat16_sr"`` under pp
raise ``NotImplementedError`` naming A12 step 9: the JAX Trainer's stacked
leaves change what they compute (the block-RMS clip over a whole stacked
leaf, the bf16 cast of a stacked norm scale, the rounding counter keyed by
the stacked tree), so its pp run of either differs from its pp=1 run.
Dropout on any mesh: each block's masks are keyed by the block's seed and
the global row and token (``models/transformer.py``'s ``dropout_keep``), so
a rank draws its slice of the masks of the run without the data, sp and tp
axes; under pp the pipeline's own keys (folded per microbatch, stage and
block as the JAX package folds them) with a microbatch's global rows.

Not ported yet (it raises ``NotImplementedError`` naming ROADMAP.md's
item): the ep mesh axis (A12 step 8).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.moe import MoEMLP
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.obs import flight as _flight
from orion_tpu_torch.ops.fused_ce import fused_ce_ok, model_token_losses
from orion_tpu_torch.ops.kernels import adafactor as af
from orion_tpu_torch.parallel.collectives import all_reduce_sum_, any_rank
from orion_tpu_torch.resilience import inject as _inject
from orion_tpu_torch.parallel.mesh import MeshConfig
from orion_tpu_torch.parallel.pipeline_lm import pp_lm_eval_sums, pp_lm_loss, stage_blocks
from orion_tpu_torch.parallel.sharding import AxisParams, FsdpParams, gather_whole, tp_whole_grads
from orion_tpu_torch.utils import rng as rngs
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, {item})"
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``: the same fields and defaults."""

    model: ModelConfig = ModelConfig()
    steps: int = 1000
    batch_size: int = 8  # global
    seq_len: int = 256
    # optimizer
    optimizer: str = "adamw"  # "adamw" | "lion" | "adafactor" | "adafactor_fused"
    mu_dtype: Optional[str] = None  # e.g. "bfloat16": halve first-moment memory
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    accum_steps: int = 1
    # schedule
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    warmup_steps: int = 100
    min_lr_ratio: float = 0.1
    # parallelism
    mesh: MeshConfig = MeshConfig()
    pp_microbatches: int = 0
    pp_full_manual: Optional[bool] = None
    param_storage: str = "float32"  # "float32" | "bfloat16_sr"
    # bookkeeping
    seed: int = 0
    log_every: int = 10
    eval_every: int = 0
    eval_batches: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1000
    ckpt_keep: int = 3
    nan_policy: str = "skip"  # "skip" | "halt"
    preempt_grace: float = 10.0
    step_timeout: float = 0.0

    @property
    def micro_batch(self) -> int:
        if self.batch_size % self.accum_steps:
            raise ValueError(f"accum_steps {self.accum_steps} does not divide "
                             f"batch_size {self.batch_size}")
        return self.batch_size // self.accum_steps


# ---------------------------------------------------------------------------
# Schedules: optax's formulas, in fp32 as optax computes them
# ---------------------------------------------------------------------------

_f32 = np.float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (a constant ``init`` when ``steps <= 0``)."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return float(_f32(init - end) * frac + _f32(end))

    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    def f(count):
        c = _f32(min(count, steps))
        decay = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(steps)))
        return float(_f32(init) * (_f32(1 - alpha) * decay + _f32(alpha)))

    return f


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules over one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the optimizer's count (0 at the first update)."""
    peak, warm = cfg.lr, max(cfg.warmup_steps, 1)
    floor = cfg.lr * cfg.min_lr_ratio
    decay_steps = max(cfg.steps - warm, 1)
    if cfg.schedule == "cosine":
        alpha = 0.0 if peak == 0.0 else floor / peak
        return _join(_linear(0.0, peak, warm), _cosine(peak, decay_steps, alpha), warm)
    if cfg.schedule == "linear":
        return _join(_linear(0.0, peak, warm), _linear(peak, floor, decay_steps), warm)
    return _join(_linear(0.0, peak, warm), lambda count: peak, warm)


# ---------------------------------------------------------------------------
# Optimizers: optax's AdamW and Lion
# ---------------------------------------------------------------------------


def _times(c: float, t: Tensor) -> Tensor:
    """``c * t`` as JAX computes it: a Python scalar takes the array's dtype
    first (a bf16 moment decays by bf16(0.9) = 0.8984375), then the product
    rounds to that dtype."""
    return float(torch.tensor(c, dtype=t.dtype)) * t


def _wd_mask(name: str, p: Tensor) -> bool:
    """Decay only matrix params (ndim >= 2, the embedding tables included);
    norm scales and biases are left alone, and so is the fixed FAVOR+
    projection, which no gradient reaches (decay would shrink it to 0)."""
    return p.ndim >= 2 and "favor_proj" not in name


# ---------------------------------------------------------------------------
# bf16 parameter storage with stochastic rounding
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
key_words = rngs.key_words


def sr_noise_bits(words: Tuple[int, int], n: int, device=None) -> Tensor:
    """n uniform 32-bit words (int64 in [0, 2^32)) from the JAX package's
    counter hash: a Weyl sequence over iota through the murmur3 finalizer,
    salted by the two key words (``utils/rng.py`` ``counter_bits``)."""
    keys = torch.tensor([int(w) & _U32 for w in words], dtype=torch.int64, device=device)
    return rngs.counter_bits(keys, n)


def sr_round_bf16(x32: Tensor, words: Tuple[int, int]) -> Tensor:
    """fp32 -> bf16, rounded stochastically and without bias: E[sr(x)] = x.
    bf16 is the top half of the fp32 pattern, so 16 bits of uniform noise
    added to the pattern, then truncated, select the far neighbour with
    probability (low bits / 2^16), for either sign. A value representable in
    bf16 comes back bitwise; non-finite values pass through (noise on an inf
    pattern would make a NaN): an inf keeps its pattern, a NaN becomes the
    quiet NaN of its sign, as XLA converts it."""
    x32 = x32.float()
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _U32
    r = sr_noise_bits(words, x32.numel(), x32.device).view(x32.shape) & 0xFFFF
    top = ((bits + r) & _U32) >> 16  # [0, 2^16)
    kept = torch.where(torch.isnan(x32), ((bits >> 16) & 0x8000) | 0x7FC0, bits >> 16)
    top = torch.where(torch.isfinite(x32), top, kept)
    return (top - ((top >= 0x8000).to(torch.int64) << 16)).to(torch.int16).view(torch.bfloat16)


def leaf_words(step_seed: int, n_leaves: int):
    """The key words of each leaf's rounding at the step of ``step_seed``."""
    key = rngs.fold(step_seed, 0x5157)
    return [key_words(rngs.fold(key, i)) for i in range(n_leaves)]


@torch.no_grad()
def storage_cast(model: torch.nn.Module, param_storage: str) -> None:
    """Apply ``param_storage`` to a fresh model in place: "bfloat16_sr"
    stores its matrix (ndim >= 2) fp32 params as bf16; 1-D ones (norm
    scales, biases: a small, precision-sensitive share) stay fp32."""
    if param_storage == "float32":
        return
    if param_storage != "bfloat16_sr":
        raise ValueError(f"param_storage={param_storage!r}; expected 'float32' or 'bfloat16_sr'")
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if p.ndim >= 2 and p.dtype == torch.float32:
                setattr(mod, name, torch.nn.Parameter(p.to(torch.bfloat16),
                                                      requires_grad=p.requires_grad))


class Optimizer:
    """optax ``adamw`` / ``lion`` over named fp32 params, updating them in
    place. State: ``count`` (updates applied so far), ``mu`` (in
    ``mu_dtype``) and, for AdamW, ``nu`` (fp32)."""

    fused = False  # the trainer scales the gradients and skips bad steps itself

    def __init__(self, cfg: TrainConfig, params: Dict[str, Tensor]):
        if cfg.optimizer not in ("adamw", "lion"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.kind = cfg.optimizer
        self.sched = make_schedule(cfg)
        self.mu_dtype = {None: None, "float32": torch.float32,
                         "bfloat16": torch.bfloat16}[cfg.mu_dtype]
        self.count = 0
        # fp32 moments for a bf16-stored leaf too (the JAX package inits the
        # optimizer from an fp32 view of the params)
        self.mu = {n: torch.zeros_like(p, dtype=self.mu_dtype or torch.float32)
                   for n, p in params.items()}
        self.nu = ({n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
                   if self.kind == "adamw" else {})

    @torch.no_grad()
    def update(self, params: Dict[str, Tensor], grads: Dict[str, Tensor],
               sr_words: Optional[Dict[str, Tuple[int, int]]] = None) -> None:
        """``sr_words``: each bf16-stored leaf's key words; its new value
        ``p + u`` (fp32) is rounded stochastically with them."""
        c = self.cfg
        lr = self.sched(self.count)
        count_inc = self.count + 1
        for n, p in params.items():
            g = grads[n].float()
            mu = (1.0 - c.b1) * g + _times(c.b1, self.mu[n])
            if self.kind == "adamw":
                nu = (1.0 - c.b2) * (g * g) + c.b2 * self.nu[n]
                mu_hat = mu / (1.0 - c.b1 ** count_inc)
                nu_hat = nu / (1.0 - c.b2 ** count_inc)
                u = mu_hat / (torch.sqrt(nu_hat) + c.eps)
                self.nu[n] = nu
                self.mu[n] = mu.to(self.mu[n].dtype)
            else:  # lion: the sign of the b1-interpolation, then the b2 moment
                u = torch.sign((1.0 - c.b1) * g + _times(c.b1, self.mu[n]))
                self.mu[n] = ((1.0 - c.b2) * g + _times(c.b2, self.mu[n])).to(self.mu[n].dtype)
            if c.weight_decay and _wd_mask(n, p):
                u = u + c.weight_decay * p
            if p.dtype == torch.bfloat16:
                p.copy_(sr_round_bf16(p.float() + -lr * u, sr_words[n]))
            else:
                p.add_(-lr * u)
        self.count = count_inc

    def state_dict(self) -> Dict[str, object]:
        return {"count": torch.tensor(self.count, dtype=torch.int64),
                "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state) -> None:
        self.count = int(state["count"])
        for n, t in state["mu"].items():
            self.mu[n].copy_(t)
        for n, t in state["nu"].items():
            self.nu[n].copy_(t)


class Adafactor:
    """optax ``adafactor(sched, min_dim_size_to_factor=128,
    multiply_by_parameter_scale=False)`` over named fp32 params, updating
    them in place (``ops/kernels/adafactor.py``): decay 0.8, eps 1e-30,
    update clipping 1.0, no weight decay, the lr the schedule at the
    optimizer's own (good-step) count.

    ``"adafactor"``: the plain formulas on every leaf; the trainer scales the
    gradients and skips a bad step, as for AdamW. ``"adafactor_fused"``
    (``fused``): the factored fp32 matrices take the three kernels, into
    which the trainer's clip-and-guard ``scale`` and the finite flag fold
    (the skip policy rides in the apply kernel), on every step.

    ``transposed`` names the params stored as the transpose of the JAX
    package's leaf, so each leaf is factored over optax's axes."""

    def __init__(self, cfg: TrainConfig, params: Dict[str, Tensor],
                 transposed: Optional[Dict[str, bool]] = None):
        self.fused = cfg.optimizer == "adafactor_fused"
        self.sched = make_schedule(cfg)
        self.backend = cfg.model.backend
        transposed = transposed or {}
        self.dims = {n: af.factored_dims(p.shape, transposed.get(n, False))
                     for n, p in params.items()}
        self.state = af.init(params, self.dims)

    @property
    def count(self) -> int:
        return self.state.count

    def update(self, params: Dict[str, Tensor], grads: Dict[str, Tensor], scale=1.0,
               finite=True, sr_words: Optional[Dict[str, Tuple[int, int]]] = None) -> None:
        store = {n: functools.partial(sr_round_bf16, words=w) for n, w in (sr_words or {}).items()
                 if params[n].dtype == torch.bfloat16}
        self.state = af.apply_updates(
            grads, params, self.state, lr=self.sched(self.state.count), scale=scale,
            finite=finite, dims=self.dims, use_kernel=self.fused, backend=self.backend,
            store=store)

    def state_dict(self) -> Dict[str, object]:
        s = self.state
        return {"count": torch.tensor(s.count, dtype=torch.int64),
                "v_row": dict(s.v_row), "v_col": dict(s.v_col), "v": dict(s.v)}

    def load_state_dict(self, state) -> None:
        self.state.count = int(state["count"])
        for key in ("v_row", "v_col", "v"):
            mine = getattr(self.state, key)
            for n, t in state[key].items():
                mine[n].copy_(t)


def make_optimizer(cfg: TrainConfig, params: Dict[str, Tensor],
                   transposed: Optional[Dict[str, bool]] = None):
    """The optimizer ``cfg`` names over ``params`` (clipping is the
    trainer's, fused with its finite guard). ``transposed``: the params
    stored as the transpose of the JAX package's leaf (Adafactor factors
    them on the JAX orientation)."""
    if cfg.optimizer in ("adafactor", "adafactor_fused"):
        return Adafactor(cfg, params, transposed)
    return Optimizer(cfg, params)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def lm_loss(
    model: TransformerLM, batch: Tensor, dropout_seed: Optional[int] = None,
    fused_ce: Optional[bool] = None,
) -> Tensor:
    """batch [B, T+1] -> mean next-token cross entropy (fp32) plus the MoE
    layers' auxiliary loss (the JAX package's ``"losses"`` collection). With
    ``dropout_seed`` the blocks apply dropout (``cfg.dropout``). ``fused_ce``
    (None = ``fused_ce_ok``) computes the same loss without the [B, T, V]
    fp32 logits (``ops/fused_ce.py``). On a sequence-parallel model, or one
    on a data mesh (``batch`` then this rank's rows), it is this rank's part
    of the global mean: its sum of token losses over the global token count
    (the inputs and labels shifted before sharding), plus the aux over the
    number of ranks holding distinct tokens, data x sp (each rank's
    load-balance term is the global batch's already, its z-loss its own
    tokens' mean), so the ranks' summed gradients count it once."""
    x, y = batch[:, :-1], batch[:, 1:]
    sp = model.sp
    if sp is not None:
        x, y = sp.shard(x), sp.shard(y)
    deterministic = dropout_seed is None
    if fused_ce is None:
        fused_ce = fused_ce_ok(model)
    if fused_ce:
        losses, aux = model_token_losses(model, x, y, deterministic, dropout_seed)
    else:
        logits, aux = model(x, deterministic, dropout_seed, return_aux=True)
        losses = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), y.long(), reduction="none")
    n_data = model.n_data
    if sp is not None or n_data > 1:
        n_token = n_data * (sp.sp if sp is not None else 1)
        return losses.sum() / (batch.shape[0] * n_data * (batch.shape[1] - 1)) + aux / n_token
    return losses.mean() + aux


def param_grads(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Each param's gradient; zeros for one that no gradient reaches (the
    fixed ``favor_proj``: the JAX package's stop_gradient gives it zeros)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def global_norm(grads: Dict[str, Tensor], fsdp: Optional[FsdpParams] = None,
                tp: Optional[AxisParams] = None, pp_group=None) -> Tensor:
    """The gradients' global L2 norm, in fp32 (a bf16 leaf's too). Under
    ``fsdp`` or ``tp`` the grads of their leaves are this rank's shards: the
    squares of the fsdp shards are summed over the fsdp group, those of the
    tp shards over the tp group (both for a leaf cut by both), and the
    replicated leaves' counted once. With ``pp_group`` (a pipeline stage's)
    the squares of the stage's blocks (``blocks.*``) are summed over the
    stages; every stage holds the other leaves and counts them once."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads.values()]
    if fsdp is None and tp is None and pp_group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack([n * n for n in norms])
    dev = sq.device
    by_f = torch.tensor([fsdp is not None and name in fsdp.dims for name in grads], device=dev)
    by_t = torch.tensor([tp is not None and name in tp.dims for name in grads], device=dev)
    # [fsdp and tp, fsdp only, tp only, neither], for the stage's blocks
    # (``blocks.*``), then for the leaves every stage holds
    cuts = (by_f & by_t, by_f & ~by_t, ~by_f & by_t, ~by_f & ~by_t)
    by_s = torch.tensor([name.startswith("blocks.") for name in grads], device=dev)
    parts = torch.stack([sq[c & s].sum() for s in (by_s, ~by_s) for c in cuts])
    if fsdp is not None:
        all_reduce_sum_([parts[0:2], parts[4:6]], fsdp.group)
    if tp is not None:
        all_reduce_sum_([parts[0:1], parts[2:3], parts[4:5], parts[6:7]], tp.group)
    if pp_group is not None:
        all_reduce_sum_([parts[:4]], pp_group)
    return torch.sqrt(parts.sum())


def _i64(x: int) -> Tensor:
    """A 64-bit unsigned value as an int64 tensor (two's complement)."""
    return torch.tensor(x - (1 << 64) if x >= 1 << 63 else x, dtype=torch.int64)


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None, mesh=None):
        """Builds the model (params drawn from the seed's "init" stream) and
        the optimizer on ``device`` (default ``"cuda"``, which raises
        without CUDA). ``mesh``: the ``parallel.mesh.Mesh`` of
        ``init_distributed``, which a ``cfg.mesh`` with an axis above 1 needs
        (the same mesh); the model then runs on the mesh's device."""
        if cfg.seq_len > cfg.model.max_seq_len:
            raise ValueError(
                f"seq_len={cfg.seq_len} exceeds model.max_seq_len="
                f"{cfg.model.max_seq_len}; raise max_seq_len or lower seq_len"
            )
        cfg.mesh.check()
        if mesh is None:
            if max(cfg.mesh.dp, cfg.mesh.fsdp, cfg.mesh.tp, cfg.mesh.sp, cfg.mesh.pp) > 1:
                raise ValueError(f"mesh {cfg.mesh.shape} needs its process group: pass the Mesh "
                                 "of parallel.init_distributed (the CLI's --distributed)")
            want = MeshConfig(dp=1)
        else:
            want = cfg.mesh.resolve(mesh.world)
            if mesh.cfg != want:
                raise ValueError(f"cfg.mesh resolves to {want.shape} on {mesh.world} ranks, the "
                                 f"Mesh is {mesh.cfg.shape}: pass the Mesh init_distributed "
                                 "built for it")
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            device = mesh.device
            if cfg.optimizer == "adafactor_fused":
                # the JAX Trainer refuses it on any multi-device mesh, so the
                # optimizer state's structure never depends on the mesh
                raise ValueError(
                    "optimizer='adafactor_fused' runs on single-device meshes only (the fused "
                    "passes take whole leaves and their factored statistics would need "
                    "all-reduces); use optimizer='adafactor' on multi-device meshes")
        if want.sp > 1:
            if not cfg.model.sequence_parallel:
                raise ValueError("an sp mesh shards the tokens: set model.sequence_parallel=true")
            if cfg.seq_len % want.sp:
                raise ValueError(f"seq_len={cfg.seq_len} is not a multiple of sp={want.sp}")
        n_data = want.dp * want.fsdp
        if cfg.micro_batch % n_data:  # so the batch divides too
            raise ValueError(f"batch_size {cfg.batch_size} (micro-batch {cfg.micro_batch}) does "
                             f"not divide into dp * fsdp = {n_data} row blocks")
        if (want.fsdp > 1 or want.tp > 1) and (cfg.optimizer == "adafactor"
                                               or cfg.param_storage == "bfloat16_sr"):
            raise _not_ported(f"optimizer={cfg.optimizer!r} / param_storage="
                              f"{cfg.param_storage!r} under fsdp or tp (factored statistics and "
                              "the rounding counter take the whole leaf)",
                              "item 12 (parallelism), A12 step 9")
        if want.pp > 1 and (cfg.optimizer == "adafactor" or cfg.param_storage == "bfloat16_sr"):
            raise _not_ported(f"optimizer={cfg.optimizer!r} / param_storage="
                              f"{cfg.param_storage!r} under pp (the JAX Trainer's stacked leaves "
                              "change what it computes: the block-RMS clip over a stacked leaf, "
                              "the bf16 cast of a stacked norm scale, the rounding counter keyed "
                              "by the stacked tree)", "item 12 (parallelism), A12 step 9")
        if cfg.param_storage not in ("float32", "bfloat16_sr"):
            raise ValueError(f"param_storage={cfg.param_storage!r}; expected 'float32' "
                             "or 'bfloat16_sr'")
        if cfg.param_storage == "bfloat16_sr" and cfg.optimizer == "adafactor_fused":
            raise ValueError("param_storage='bfloat16_sr' composes with the plain optimizers "
                             "only; the fused Adafactor passes read and write fp32 params "
                             "(use optimizer='adafactor')")
        if cfg.nan_policy not in ("skip", "halt"):
            raise ValueError(f"unknown nan_policy {cfg.nan_policy!r}")
        cfg.micro_batch  # noqa: B018 -- raises unless accum_steps divides batch_size
        self.cfg = cfg
        self.device = resolve_device(device)
        model_cfg = cfg.model
        self.pp_n_micro, self.pp_full_manual = 1, False
        if want.pp > 1:
            model_cfg = self._pp_plan(cfg, want)
        root = rngs.root_key(cfg.seed)
        self.model = TransformerLM(
            model_cfg, device=self.device,
            generator=rngs.generator(rngs.stream(root, "init"), self.device), mesh=self.mesh,
        )
        if self.pp_full_manual and n_data > 1:
            # full-manual: a data rank's microbatches are its own rows, so a
            # MoE layer's statistics are its own too (the loss averages the
            # aux over the data ranks)
            for m in self.model.modules():
                if isinstance(m, MoEMLP):
                    m.stats_group = None
        storage_cast(self.model, cfg.param_storage)
        self.fsdp = self.model.fsdp
        self.tp = self.model.tp_params
        # phi_proj: whole on every tp rank, each rank's gradient its heads' share
        self.tp_whole = set(tp_whole_grads(cfg.model)) if self.tp is not None else set()
        self.params = dict(self.model.named_parameters())
        transposed = {key: t for key, _, t in expected_params(cfg.model).values()}
        self.opt = make_optimizer(cfg, self.params, transposed)
        self.sched = self.opt.sched
        self.rng = rngs.stream(root, "dropout")
        self.step_count = 0  # steps taken, good or not
        self.nonfinite = 0  # non-finite steps skipped
        self.nonfinite_steps = 0  # what train() has seen of it (nan_policy)
        self.preempted_at: Optional[int] = None  # the boundary a preemption stopped at

    def _pp_plan(self, cfg: TrainConfig, want: MeshConfig) -> ModelConfig:
        """Set ``pp_full_manual`` and ``pp_n_micro`` (the module docstring's
        rules); raise where pp does not divide the stage groups or n_micro
        does not divide a rank's rows of a micro-batch (sp dividing seq_len is
        checked with sp) -> the model's config, ``remat_skip`` 0."""
        from orion_tpu_torch.ops.dispatch import resolve

        stage_blocks(cfg.model, want.pp, 0)  # raises unless pp divides the groups
        fm = cfg.pp_full_manual
        if fm is None:
            fm = (resolve(cfg.model.backend, self.device) == "cuda" and want.tp == 1
                  and want.ep == 1 and want.fsdp == 1)
        local = cfg.micro_batch // (want.dp * want.fsdp)  # a rank's rows of a micro-batch
        base = local if fm else cfg.micro_batch
        if cfg.pp_microbatches:
            n = cfg.pp_microbatches
        else:  # the JAX Trainer's: the largest divisor of the base up to 4 pp
            cap = max(1, min(base, 4 * want.pp))
            n = max(d for d in range(1, cap + 1) if base % d == 0)
        if base % n:
            raise ValueError(f"pp_microbatches={n} must divide the "
                             f"{'per-rank ' if fm else ''}per-accumulation batch {base}")
        if local % n:
            # partial-manual: a rank takes whole rows of every microbatch
            raise ValueError(f"pp_microbatches={n} must divide this rank's {local} rows of a "
                             f"micro-batch (micro-batch {cfg.micro_batch} over dp * fsdp = "
                             f"{want.dp * want.fsdp}), as each rank takes whole rows of each "
                             f"microbatch: set pp_microbatches to a divisor of {local} or "
                             "raise the batch")
        self.pp_n_micro, self.pp_full_manual = n, bool(fm)
        # every block recomputed, as the JAX Trainer zeroes remat_skip under pp
        return dataclasses.replace(cfg.model, remat_skip=0)

    # -- the step -----------------------------------------------------------

    def row_index(self, n_rows: int) -> np.ndarray:
        """This rank's rows of a global batch of ``n_rows``, as the step
        takes them (``Mesh.row_index``; under partial-manual pp its share of
        each of the accum_steps x n_micro microbatches)."""
        accum = self.cfg.accum_steps
        if self.model.pp is not None and not self.pp_full_manual:
            accum *= self.pp_n_micro
        return self.mesh.row_index(n_rows, accum)

    def local_rows(self, batch: Tensor) -> Tensor:
        """This rank's rows of ``batch``: the global batch [B, T+1] (its
        row block of each micro-batch, ``Mesh.rows``) or already this rank's
        [B / (dp fsdp), T+1] (a loader that reads only them)."""
        n_data, rows = self.model.n_data, self.cfg.batch_size
        if n_data == 1 or batch.shape[0] == rows // n_data:
            return batch
        if batch.shape[0] != rows:
            raise ValueError(f"a batch of {batch.shape[0]} rows: want the global batch_size "
                             f"{rows} or this rank's {rows // n_data}")
        return batch[torch.from_numpy(self.row_index(rows)).to(batch.device)]

    def _loss_and_grads(self, batch: Tensor, step_seed: int) -> Tensor:
        cfg = self.cfg
        use_dropout = cfg.model.dropout > 0.0
        batch = self.local_rows(batch)
        for p in self.params.values():
            p.grad = None
        if self.model.pp is not None:
            return self._pp_loss_and_grads(batch, step_seed if use_dropout else None)
        if cfg.accum_steps == 1:
            loss = lm_loss(self.model, batch, step_seed if use_dropout else None)
            loss.backward()
            return self._reduce(loss.detach())
        total = torch.zeros((), device=self.device)
        for i, mb in enumerate(batch.view(cfg.accum_steps, batch.shape[0] // cfg.accum_steps, -1)):
            seed = rngs.fold(step_seed, i) if use_dropout else None
            loss = lm_loss(self.model, mb, seed)
            loss.backward()  # grads sum over the micro-batches
            total += loss.detach()
        for p in self.params.values():
            if p.grad is not None:  # none reaches the fixed favor_proj
                p.grad.div_(cfg.accum_steps)
        return self._reduce(total / cfg.accum_steps)

    def _pp_loss_and_grads(self, batch: Tensor, seed: Optional[int]) -> Tensor:
        """The pipeline's step: each accumulation micro-batch of this rank's
        rows through ``pp_lm_loss`` (its backward accumulating), the
        gradients averaged over them; a leaf every stage holds that this
        stage does not read gets zeros, so the sums over the stages line up."""
        accum = self.cfg.accum_steps
        total = torch.zeros((), device=self.device)
        for i, mb in enumerate(batch.view(accum, batch.shape[0] // accum, -1)):
            s = None if seed is None else (seed if accum == 1 else rngs.fold(seed, i))
            total += pp_lm_loss(self.model, mb, self.pp_n_micro, s)
        for n, p in self.params.items():
            if p.grad is not None:
                if accum > 1:
                    p.grad.div_(accum)
            elif not n.startswith("blocks."):
                p.grad = torch.zeros_like(p)
        return self._reduce(total / accum)

    def _reduce(self, loss: Tensor) -> Tensor:
        """On a mesh: the loss and every parameter gradient summed over the
        ranks, so each holds the global ones (a no-op otherwise). The loss
        and the leaves not cut by fsdp sum over the replica group (every
        rank without tp; under tp the ranks at this tp index, since the tp
        ranks already share the loss and the gradient of every leaf read
        outside the tp region); the fsdp shards', reduce-scattered over the
        fsdp group in the backward, over the ranks holding the same shard;
        then ``phi_proj``'s (held whole, read by the local heads) also over
        the tp group."""
        if self.mesh is None:
            return loss
        loss = loss.reshape(1).clone()
        dims = self.fsdp.dims if self.fsdp is not None else {}
        if self.model.pp is not None:
            self._reduce_stages(loss, dims)
        else:
            grads = [p.grad for n, p in self.params.items()
                     if p.grad is not None and n not in dims]
            if self.mesh.replica_group is not None:
                all_reduce_sum_([loss] + grads, self.mesh.replica_group)
            shards = [p.grad for n, p in self.params.items() if p.grad is not None and n in dims]
            if shards and self.mesh.shard_group is not None:
                all_reduce_sum_(shards, self.mesh.shard_group)
        heads = [p.grad for n, p in self.params.items() if p.grad is not None and n in self.tp_whole]
        if heads:
            all_reduce_sum_(heads, self.mesh.tp_group)
        return loss[0]

    def _reduce_stages(self, loss: Tensor, dims: Dict[str, int]) -> None:
        """``_reduce``'s sums under pp: a stage's blocks over its ranks (the
        replica group, or the shard group for an fsdp shard), the loss and
        the leaves every stage holds over every stage's (the trunk groups)."""
        mesh = self.mesh
        for stage, cut, group, extra in ((True, False, mesh.replica_group, []),
                                         (False, False, mesh.trunk_group, [loss]),
                                         (True, True, mesh.shard_group, []),
                                         (False, True, mesh.trunk_shard_group, [])):
            ts = extra + [p.grad for n, p in self.params.items() if p.grad is not None
                          and n.startswith("blocks.") == stage and (n in dims) == cut]
            if ts and group is not None:
                all_reduce_sum_(ts, group)

    @property
    def _sharded(self) -> bool:
        """Whether this rank holds any param in part (fsdp or tp) or holds
        some of the blocks only (pp)."""
        return bool(self.model.shard_axes) or self.model.pp is not None

    @property
    def is_main(self) -> bool:
        """The rank that logs and writes checkpoints (the only one without
        a mesh)."""
        return self.mesh is None or self.mesh.is_main

    def _save(self, ckpt, step: int, force: bool = False) -> None:
        """``ckpt.maybe_save`` on rank 0; on a mesh every rank then waits
        for it. Under fsdp or tp the ranks at d = s = 0 first gather the
        state with it (``state_dict``)."""
        if self._sharded:
            if ckpt.due(step, force):
                state = self.state_dict()
                if self.is_main:
                    ckpt.maybe_save(step, state, force=force)
        elif self.is_main:
            ckpt.maybe_save(step, self.state_dict(), force=force)
        if self.mesh is not None:
            self.mesh.barrier()

    def _loss_and_grads_or_remat(self, batch: Tensor, step_seed: int) -> Tensor:
        """``_loss_and_grads``, retried once with every block recomputed
        (``remat_skip=0``) after an out-of-memory error at ``remat_skip >
        0`` on one rank (the params are untouched until the update)."""
        try:
            return self._loss_and_grads(batch, step_seed)
        except torch.cuda.OutOfMemoryError as e:
            mcfg = self.model.cfg
            if not (mcfg.remat and mcfg.remat_skip > 0) or self.mesh is not None:
                raise
            warnings.warn(f"train step ran out of memory at remat_skip={mcfg.remat_skip} "
                          f"({str(e).splitlines()[0][:120]}); retrying fully rematted "
                          "(remat_skip=0)", stacklevel=3)
            for p in self.params.values():
                p.grad = None
            del e
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            self.model.cfg = dataclasses.replace(mcfg, remat_skip=0)
            return self._loss_and_grads(batch, step_seed)

    def step(self, batch: Tensor) -> Dict[str, float]:
        """One optimizer step on batch [B, T+1] -> host metrics: loss,
        grad_norm, lr (the one applied), nonfinite (0 or 1),
        nonfinite_total."""
        cfg = self.cfg
        lr = self.sched(self.step_count - self.nonfinite)
        step_seed = rngs.at_step(self.rng, self.step_count)
        keep = None
        # a NaN-poisoned step (resilience/inject.py): one leaf goes NaN, so
        # the loss and gradients do and the guard skips the update; the
        # pre-step params go back after it. Asked only while a plan is armed.
        if _inject.active() and _inject.nan_armed(self.step_count + 1):
            keep = {n: p.detach().clone() for n, p in self.params.items()}
            with torch.no_grad():
                next(iter(self.params.values())).fill_(float("nan"))
        loss = self._loss_and_grads_or_remat(batch.to(self.device), step_seed)
        grads = param_grads(self.params)
        gnorm = global_norm(grads, self.fsdp, self.tp,
                            self.mesh.pp_group if self.model.pp is not None else None)
        finite_t = torch.isfinite(loss) & torch.isfinite(gnorm)
        clip = (torch.clamp(cfg.clip_norm / gnorm, max=1.0)
                if cfg.clip_norm and cfg.clip_norm > 0 else 1.0)
        if self.opt.fused:
            # the kernels fold the scale and the skip policy, so the update is
            # queued before the host reads the flag (a NaN norm gives scale 0)
            scale = (torch.where(finite_t, clip, 0.0) if torch.is_tensor(clip)
                     else finite_t.float())
            self.opt.update(self.params, grads, scale=scale, finite=finite_t)
        finite = bool(finite_t)
        if finite and not self.opt.fused:
            if not isinstance(clip, float):
                for n, g in grads.items():
                    # a bf16-stored leaf's gradient is scaled in fp32
                    grads[n] = g.float().mul_(clip) if g.dtype != torch.float32 else g.mul_(clip)
            words = None
            if self.cfg.param_storage == "bfloat16_sr":
                words = dict(zip(self.params, leaf_words(step_seed, len(self.params))))
            self.opt.update(self.params, grads, sr_words=words)
        if not finite:  # skipped: params and optimizer state keep their values
            self.nonfinite += 1
        for p in self.params.values():
            p.grad = None
        if keep is not None:
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(keep[n])
        self.step_count += 1
        return {"loss": float(loss), "grad_norm": float(gnorm), "lr": lr,
                "nonfinite": float(not finite), "nonfinite_total": float(self.nonfinite)}

    # -- the loop -----------------------------------------------------------

    def train(self, data_iter, logger=None, ckpt=None, hook=None, eval_factory=None,
              preempt=None, watchdog=None) -> Dict[str, float]:
        """Run steps ``step_count + 1 .. cfg.steps``; returns the last
        logged metrics. ``eval_factory(step) -> iterator`` gives each eval
        (every ``cfg.eval_every`` steps) its batches as a pure function of
        the train step. ``preempt`` (a ``resilience.PreemptionGuard``): when
        its ``should_stop`` is set (on any rank of a mesh), stop at the step
        boundary, save an emergency checkpoint and return with
        ``preempted_at`` set. ``watchdog`` (``resilience.Watchdog``): one
        heartbeat a step."""
        cfg = self.cfg
        tokens_per_step = cfg.batch_size * cfg.seq_len
        last: Dict[str, float] = {}
        metrics: Dict[str, float] = {}
        self.preempted_at = None
        for step in range(self.step_count + 1, cfg.steps + 1):
            if watchdog is not None:
                watchdog.beat(f"train step {step}")
            metrics = self.step(next(data_iter))
            if step % cfg.log_every == 0 or step == cfg.steps:
                if metrics["nonfinite_total"] > self.nonfinite_steps:
                    self.nonfinite_steps = int(metrics["nonfinite_total"])
                    _flight.record("train_nonfinite", step=step, total=self.nonfinite_steps)
                    if cfg.nan_policy == "halt":
                        _flight.recorder().dump("train-nan-halt")
                        # the offending state, post-mortem restorable
                        if watchdog is not None:
                            watchdog.disarm()
                        if ckpt is not None:
                            self._save(ckpt, step, force=True)
                        raise FloatingPointError(
                            f"{self.nonfinite_steps} non-finite step(s) by step {step}"
                            + (f"; emergency checkpoint saved at step {step}"
                               if ckpt is not None else ""))
                last = dict(metrics)
                last["ppl"] = math.exp(min(last["loss"], 20.0))
                if logger:
                    logger.log(step, last, tokens_per_step)
            if eval_factory is not None and cfg.eval_every and (
                step % cfg.eval_every == 0 or step == cfg.steps
            ):
                if watchdog is not None:
                    # an eval pass may take longer than a step's budget; a
                    # hung eval read is the eval loader's stall_timeout's
                    watchdog.disarm()
                ev = self.evaluate(eval_factory(step))
                last.update(ev)
                if logger:
                    logger.log(step, ev)
                if watchdog is not None:
                    watchdog.arm(f"train step {step} (post-eval)")
            if ckpt is not None:
                self._save(ckpt, step)
            if hook is not None:
                hook(step, metrics)
            # a simulated preemption delivers a real signal here; the guard's
            # handler runs before the check below
            _inject.fire("train.step_boundary", step=step)
            if preempt is not None:
                stop = preempt.should_stop
                if self.mesh is not None:
                    stop = any_rank(stop, self.device)
                if stop:
                    if watchdog is not None:
                        watchdog.disarm()  # the save may outlast a step's budget
                    if ckpt is not None:
                        self._save(ckpt, step, force=True)
                    self.preempted_at = step
                    _flight.record("train_preempt", step=step,
                                   signum=getattr(preempt, "signum", None))
                    _flight.recorder().dump("train-preempt")
                    if not last:
                        last = dict(metrics)
                    break
        if not last and metrics:
            last = dict(metrics)
        return last

    @torch.no_grad()
    def evaluate(self, data_iter, n_batches: Optional[int] = None) -> Dict[str, float]:
        from orion_tpu_torch.evaluate import lm_eval_sums  # the one eval-loss definition

        total, count = 0.0, 0.0
        for _ in range(n_batches or self.cfg.eval_batches):
            batch = next(data_iter).to(self.device)
            if self.mesh is not None and batch.shape[0] == self.cfg.batch_size:
                batch = self.mesh.rows(batch)
            if self.model.pp is not None:  # the last stage's sums, zeros on the others
                s, c = pp_lm_eval_sums(self.model, batch, self.pp_n_micro)
            else:
                s, c = lm_eval_sums(self.model, batch)
            if self.mesh is not None and self.mesh.trunk_group is not None:
                # this rank's rows and tokens: sum over the replica group (the
                # tp ranks share theirs), every stage's under pp
                sums = torch.stack([s, c])
                all_reduce_sum_([sums], self.mesh.trunk_group)
                s, c = sums
            total += float(s)
            count += float(c)
        loss = total / max(count, 1.0)
        return {"eval_loss": loss, "eval_ppl": math.exp(min(loss, 20.0))}

    # -- checkpoint glue ----------------------------------------------------

    def _gather_axes(self, join_tp: bool = True):
        """The axes a whole leaf is gathered over, in turn: fsdp's, then
        tp's (``join_tp``: whether this rank takes part in the tp gather)."""
        return [a for a in (self.fsdp, self.tp if join_tp else None) if a is not None]

    def state_dict(self) -> Optional[Dict[str, object]]:
        """The whole training state as a nested dict of tensors: the file a
        dp=1 run writes. Under fsdp, tp or pp a collective: the ranks at d =
        s = 0 gather every sharded leaf (params and moments) into their
        stage's first rank's host memory, one leaf at a time (over each fsdp
        group, then over that rank's tp group), and under pp each stage's
        first rank sends its blocks' leaves to rank 0; rank 0 gets the
        state, every other rank None."""
        params = {n: p.detach() for n, p in self.params.items()}
        opt = self.opt.state_dict()
        if self._sharded:
            d, f, t, s = self.mesh.coords
            if d or s:  # holds no shard rank 0 lacks
                return None
            keep = f == 0 and t == 0  # the stage's first rank (rank 0 without pp)
            axes = self._gather_axes(join_tp=f == 0)
            params = gather_whole(params, axes, keep)
            opt = {k: gather_whole(v, axes, keep) if k in ("mu", "nu") else v
                   for k, v in opt.items()}
            if keep and self.model.pp is not None:
                params = self._merge_stages(params, to_main=True)
                opt = {k: self._merge_stages(v, to_main=True) if k in ("mu", "nu") else v
                       for k, v in opt.items()}
            if not self.mesh.is_main:
                return None
        return {
            "step": torch.tensor(self.step_count, dtype=torch.int64),
            "nonfinite": torch.tensor(self.nonfinite, dtype=torch.int64),
            "rng": _i64(self.rng),
            "params": params,
            "opt": opt,
        }

    @torch.no_grad()
    def load_state_dict(self, state) -> None:
        """Load a whole state (a checkpoint of any mesh: the dp=1 file);
        under fsdp or tp this rank keeps its shard of each sharded leaf."""
        if int(state["rng"]) != int(_i64(self.rng)):
            raise ValueError("checkpoint was written with another seed")
        opt = state["opt"]
        if self._sharded:
            opt = {k: self.model.shard_state(v) if k in ("mu", "nu") else v
                   for k, v in opt.items()}
        self.load_params(state["params"])
        self.opt.load_state_dict(opt)
        self.step_count = int(state["step"])
        self.nonfinite = self.nonfinite_steps = int(state["nonfinite"])

    @torch.no_grad()
    def load_params(self, params: Dict[str, Tensor]) -> None:
        """Load whole params (a dp=1 model's state dict); under fsdp or tp
        this rank keeps its shards."""
        self.model.load_state_dict(self.model.shard_state(params) if self._sharded
                                   else params, strict=True)

    def whole_params(self) -> Dict[str, Tensor]:
        """Every param whole, on the host (under fsdp, tp or pp a collective
        over each fsdp, tp and pp group: every rank calls)."""
        params = {n: p.detach() for n, p in self.params.items()}
        if self._sharded:
            params = gather_whole(params, self._gather_axes(), keep=True)
            if self.model.pp is not None:
                params = self._merge_stages(params, to_main=False)
            return params
        return {n: p.to("cpu", copy=True) for n, p in params.items()}

    def _merge_stages(self, local: Dict[str, Tensor], to_main: bool) -> Optional[Dict[str, Tensor]]:
        """Whole leaves on the host: this stage's (``local``: the leaves every
        stage holds and this stage's blocks) -> every stage's blocks besides,
        over the pp group of this (d, f, t, s) -> on its stage 0 only
        (``to_main``: the others None; each stage sends its blocks there) or on
        every stage (broadcast). Each leaf in the port's key order, its whole
        shape from the config, the dtype of ``local``'s leaves."""
        import torch.distributed as dist

        mesh, cfg = self.mesh, self.model.cfg
        me, group = mesh.pp_rank, mesh.pp_group
        dtype = next(iter(local.values())).dtype
        wire_dev = mesh.device if mesh.transport == "nccl" else torch.device("cpu")
        out = dict(local) if (me == 0 or not to_main) else None
        for p in range(mesh.pp):
            held = stage_blocks(cfg, mesh.pp, p)
            for key, shape, _ in expected_params(cfg).values():
                if not key.startswith("blocks.") or int(key.split(".", 2)[1]) not in held:
                    continue
                if to_main and p == 0:
                    continue
                mine = p == me
                t = (local[key] if mine else torch.empty(shape, dtype=dtype)).to(wire_dev)
                if to_main:
                    if mine:
                        dist.send(t.contiguous(), mesh.stage_rank(0), group)
                    elif me == 0:
                        dist.recv(t, mesh.stage_rank(p), group)
                else:
                    dist.broadcast(t, mesh.stage_rank(p), group)
                if out is not None:
                    out[key] = t.to("cpu")
        return out

    def restore(self, ckpt, step: Optional[int] = None) -> int:
        # under fsdp or tp the whole state stays on the host until it is cut
        self.load_state_dict(ckpt.restore(step, map_location=None if self._sharded
                                          else self.device))
        return self.step_count


__all__ = [
    "Trainer", "TrainConfig", "MeshConfig", "lm_loss", "make_optimizer", "make_schedule",
    "Optimizer", "sr_round_bf16", "sr_noise_bits", "storage_cast", "param_grads",
    "global_norm",
]
