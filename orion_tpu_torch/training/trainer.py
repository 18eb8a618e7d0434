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

Not ported yet (it raises ``NotImplementedError`` naming ROADMAP.md's
item): device meshes (any axis > 1). ``preempt_grace`` and ``step_timeout``
are kept for the config's shape and not wired (item 9).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops.fused_ce import fused_ce_ok, model_token_losses
from orion_tpu_torch.ops.kernels import adafactor as af
from orion_tpu_torch.utils import rng as rngs
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, {item})"
    )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX package's mesh sizes per axis (-1 on dp = every device).
    The port trains on one device: any axis above 1 raises."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def shape(self):
        return (self.dp, self.fsdp, self.tp, self.sp, self.pp, self.ep)

    def check(self) -> None:
        if any(n > 1 for n in self.shape):
            raise _not_ported(f"a device mesh {self.shape}", "item 12 (parallelism)")


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
    fp32 logits (``ops/fused_ce.py``)."""
    x, y = batch[:, :-1], batch[:, 1:]
    deterministic = dropout_seed is None
    if fused_ce is None:
        fused_ce = fused_ce_ok(model)
    if fused_ce:
        losses, aux = model_token_losses(model, x, y, deterministic, dropout_seed)
    else:
        logits, aux = model(x, deterministic, dropout_seed, return_aux=True)
        losses = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), y.long(), reduction="none")
    return losses.mean() + aux


def param_grads(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Each param's gradient; zeros for one that no gradient reaches (the
    fixed ``favor_proj``: the JAX package's stop_gradient gives it zeros)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def global_norm(grads: Dict[str, Tensor]) -> Tensor:
    """The gradients' global L2 norm, in fp32 (a bf16 leaf's too)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads.values()]))


def _i64(x: int) -> Tensor:
    """A 64-bit unsigned value as an int64 tensor (two's complement)."""
    return torch.tensor(x - (1 << 64) if x >= 1 << 63 else x, dtype=torch.int64)


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        """Builds the model (params drawn from the seed's "init" stream) and
        the optimizer on ``device`` (default ``"cuda"``, which raises
        without CUDA)."""
        if cfg.seq_len > cfg.model.max_seq_len:
            raise ValueError(
                f"seq_len={cfg.seq_len} exceeds model.max_seq_len="
                f"{cfg.model.max_seq_len}; raise max_seq_len or lower seq_len"
            )
        cfg.mesh.check()
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
        root = rngs.root_key(cfg.seed)
        self.model = TransformerLM(
            cfg.model, device=self.device,
            generator=rngs.generator(rngs.stream(root, "init"), self.device),
        )
        storage_cast(self.model, cfg.param_storage)
        self.params = dict(self.model.named_parameters())
        transposed = {key: t for key, _, t in expected_params(cfg.model).values()}
        self.opt = make_optimizer(cfg, self.params, transposed)
        self.sched = self.opt.sched
        self.rng = rngs.stream(root, "dropout")
        self.step_count = 0  # steps taken, good or not
        self.nonfinite = 0  # non-finite steps skipped
        self.nonfinite_steps = 0  # what train() has seen of it (nan_policy)

    # -- the step -----------------------------------------------------------

    def _loss_and_grads(self, batch: Tensor, step_seed: int) -> Tensor:
        cfg = self.cfg
        use_dropout = cfg.model.dropout > 0.0
        for p in self.params.values():
            p.grad = None
        if cfg.accum_steps == 1:
            loss = lm_loss(self.model, batch, step_seed if use_dropout else None)
            loss.backward()
            return loss.detach()
        total = torch.zeros((), device=self.device)
        for i, mb in enumerate(batch.view(cfg.accum_steps, cfg.micro_batch, -1)):
            seed = rngs.fold(step_seed, i) if use_dropout else None
            loss = lm_loss(self.model, mb, seed)
            loss.backward()  # grads sum over the micro-batches
            total += loss.detach()
        for p in self.params.values():
            if p.grad is not None:  # none reaches the fixed favor_proj
                p.grad.div_(cfg.accum_steps)
        return total / cfg.accum_steps

    def step(self, batch: Tensor) -> Dict[str, float]:
        """One optimizer step on batch [B, T+1] -> host metrics: loss,
        grad_norm, lr (the one applied), nonfinite (0 or 1),
        nonfinite_total."""
        cfg = self.cfg
        lr = self.sched(self.step_count - self.nonfinite)
        step_seed = rngs.at_step(self.rng, self.step_count)
        loss = self._loss_and_grads(batch.to(self.device), step_seed)
        grads = param_grads(self.params)
        gnorm = global_norm(grads)
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
        self.step_count += 1
        return {"loss": float(loss), "grad_norm": float(gnorm), "lr": lr,
                "nonfinite": float(not finite), "nonfinite_total": float(self.nonfinite)}

    # -- the loop -----------------------------------------------------------

    def train(self, data_iter, logger=None, ckpt=None, hook=None,
              eval_factory=None) -> Dict[str, float]:
        """Run steps ``step_count + 1 .. cfg.steps``; returns the last
        logged metrics. ``eval_factory(step) -> iterator`` gives each eval
        (every ``cfg.eval_every`` steps) its batches as a pure function of
        the train step."""
        cfg = self.cfg
        tokens_per_step = cfg.batch_size * cfg.seq_len
        last: Dict[str, float] = {}
        metrics: Dict[str, float] = {}
        for step in range(self.step_count + 1, cfg.steps + 1):
            metrics = self.step(next(data_iter))
            if step % cfg.log_every == 0 or step == cfg.steps:
                if metrics["nonfinite_total"] > self.nonfinite_steps:
                    self.nonfinite_steps = int(metrics["nonfinite_total"])
                    if cfg.nan_policy == "halt":
                        if ckpt is not None:
                            ckpt.maybe_save(step, self.state_dict(), force=True)
                        raise FloatingPointError(
                            f"{self.nonfinite_steps} non-finite step(s) by step {step}")
                last = dict(metrics)
                last["ppl"] = math.exp(min(last["loss"], 20.0))
                if logger:
                    logger.log(step, last, tokens_per_step)
            if eval_factory is not None and cfg.eval_every and (
                step % cfg.eval_every == 0 or step == cfg.steps
            ):
                ev = self.evaluate(eval_factory(step))
                last.update(ev)
                if logger:
                    logger.log(step, ev)
            if ckpt is not None:
                ckpt.maybe_save(step, self.state_dict())
            if hook is not None:
                hook(step, metrics)
        if not last and metrics:
            last = dict(metrics)
        return last

    @torch.no_grad()
    def evaluate(self, data_iter, n_batches: Optional[int] = None) -> Dict[str, float]:
        from orion_tpu_torch.evaluate import lm_eval_sums  # the one eval-loss definition

        total, count = 0.0, 0.0
        for _ in range(n_batches or self.cfg.eval_batches):
            s, c = lm_eval_sums(self.model, next(data_iter).to(self.device))
            total += float(s)
            count += float(c)
        loss = total / max(count, 1.0)
        return {"eval_loss": loss, "eval_ppl": math.exp(min(loss, 20.0))}

    # -- checkpoint glue ----------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """The whole training state as a nested dict of tensors."""
        return {
            "step": torch.tensor(self.step_count, dtype=torch.int64),
            "nonfinite": torch.tensor(self.nonfinite, dtype=torch.int64),
            "rng": _i64(self.rng),
            "params": {n: p.detach() for n, p in self.params.items()},
            "opt": self.opt.state_dict(),
        }

    @torch.no_grad()
    def load_state_dict(self, state) -> None:
        if int(state["rng"]) != int(_i64(self.rng)):
            raise ValueError("checkpoint was written with another seed")
        self.model.load_state_dict(state["params"], strict=True)
        self.opt.load_state_dict(state["opt"])
        self.step_count = int(state["step"])
        self.nonfinite = self.nonfinite_steps = int(state["nonfinite"])

    def restore(self, ckpt, step: Optional[int] = None) -> int:
        self.load_state_dict(ckpt.restore(step, map_location=self.device))
        return self.step_count


__all__ = [
    "Trainer", "TrainConfig", "MeshConfig", "lm_loss", "make_optimizer", "make_schedule",
    "Optimizer", "sr_round_bf16", "sr_noise_bits", "storage_cast", "param_grads",
    "global_norm",
]
