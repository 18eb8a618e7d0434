"""`python -m orion_tpu_torch.train_lra` -- LRA classification training.

The port's counterpart of ``orion_tpu/train_lra.py``: it trains
``LRAClassifier`` (``models/classifier.py``) on either

- real LRA TSV data (``--task dir`` with ``train.tsv`` / ``val.tsv``, rows
  ``"<label>\\t<seq>"``: space-separated token ids for ListOps, raw text
  for Text), or
- the built-in synthetic stand-ins, offline: ``listops`` (nested MAX / MIN
  reductions over digits) and ``text`` (byte sequences labelled by a
  long-range count).

The datasets are numpy, copied from the JAX package: the same Philox draws,
so the same batches bitwise. Library use:

    from orion_tpu_torch.train_lra import LRATrainConfig, train_lra
    params, metrics = train_lra(LRATrainConfig(steps=100), device="cpu")

CLI (on the card unless ``--device cpu``):

    python -m orion_tpu_torch.train_lra --config lra_listops_linear \\
        --task listops --steps 2000 --seq-len 2000 --set feature_map=favor

The step is the JAX package's: cross entropy plus the MoE layers' auxiliary
loss, accuracy, the gradients' global norm, a step that keeps the params
and the optimizer state when the loss or the norm is not finite, and the
optimizer chain ``clip_by_global_norm`` then the optimizer (``adamw`` /
``lion`` / ``adafactor``; ``adafactor_fused`` takes the plain Adafactor, as
the JAX package's optax twin does).

On a mesh (``LRATrainConfig.mesh`` with ``train_lra(..., mesh=)``, the
``parallel.mesh.Mesh`` of ``init_distributed``) the step computes the
one-device function, as the JAX package's does (its classifier takes no
mesh; ``param_shardings`` places the state and ``batch_sharding`` the rows
over (dp, fsdp)): every rank builds the same params from the seed and takes
its rows of the global batch (``Mesh.rows``); fsdp and tp cut the
classifier's leaves by the LM's rules (``models/classifier.py``). A rank's
loss is its rows' cross-entropy sum over the global batch (plus the aux
over the data ranks), so the sums over the data group give the global mean
and its gradient: the whole leaves' gradients are summed over the data
group, the fsdp shards' (reduce-scattered over the fsdp group by the
gather's backward) over the dp group, ``phi_proj``'s (whole on every tp
rank, read by its heads) also over the tp group; the global norm counts
each shard once, so every rank clips and skips alike. The train accuracy
and the eval accuracy are the data ranks' correct counts summed over the
global batch. The sp and pp axes replicate, as over the JAX classifier:
their ranks compute the same rows whole. The ep axis raises (A12 step 8),
and so do ``adafactor`` under fsdp or tp (A12 step 9, as the LM Trainer).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.models.classifier import LRAClassifier
from orion_tpu_torch.models.configs import ModelConfig, get_config
from orion_tpu_torch.parallel.collectives import all_reduce_sum_
from orion_tpu_torch.parallel.sharding import tp_whole_grads, whole_leaf
from orion_tpu_torch.training.metrics import MetricsLogger
from orion_tpu_torch.training.trainer import (MeshConfig, TrainConfig, global_norm,
                                              make_optimizer, make_schedule, param_grads)
from orion_tpu_torch.utils import rng as rngs
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Synthetic LRA stand-ins (deterministic, offline) and the TSV reader
# ---------------------------------------------------------------------------


class SyntheticListOps:
    """Nested two-level reduction with the structure of real ListOps:
    ``[MAX [MIN d d d d  [MIN d d d d ...``: each group reduces its four
    digits by MIN and the outer MAX at position 0 reduces the groups'
    values, so the label (spread over about 6 classes) needs every group.
    Tokens: 0-9 digits, 10 '[MAX', 11 '[MIN', 12 ']'. n_classes=10."""

    vocab_size = 16
    n_classes = 10
    group = 4  # digits per inner MIN group: keeps the label non-degenerate

    def __init__(self, seq_len: int):
        if seq_len < 3:  # pos 0 outer op + 1 inner op + >=1 digit
            raise ValueError(f"SyntheticListOps needs seq_len >= 3, got {seq_len}")
        self.seq_len = seq_len

    def batch(self, seed: int, step: int, b: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=[seed, step]))
        t = self.seq_len
        g = min(self.group, t - 2)
        toks = rng.integers(0, 10, size=(b, t))
        toks[:, 0] = 10  # outer [MAX scopes the whole sequence
        starts = np.arange(1, t - g, g + 1)
        if starts.size == 0:  # tiny sequences: one group filling the tail
            starts = np.array([1])
            g = t - 2
        toks[:, starts] = 11  # [MIN opens each inner group
        gidx = starts[:, None] + 1 + np.arange(g)[None, :]  # (m, g)
        digits = toks[:, gidx]  # (b, m, g)
        labels = digits.min(axis=-1).max(axis=-1).astype(np.int32)
        mask = np.ones((b, t), dtype=bool)
        return toks.astype(np.int32), labels, mask


class SyntheticText:
    """Byte-like sequences; the label is whether token 7 appears more often
    in the first half than in the second (a global count)."""

    vocab_size = 256
    n_classes = 2

    def __init__(self, seq_len: int):
        self.seq_len = seq_len

    def batch(self, seed: int, step: int, b: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=[seed, step]))
        t = self.seq_len
        toks = rng.integers(0, 32, size=(b, t)).astype(np.int32)
        half = t // 2
        c1 = (toks[:, :half] == 7).sum(axis=1)
        c2 = (toks[:, half:] == 7).sum(axis=1)
        labels = (c1 > c2).astype(np.int32)
        mask = np.ones((b, t), dtype=bool)
        return toks, labels, mask


class TSVDataset:
    """Real LRA data: ``"<label>\\t<sequence>"`` rows; ``mode="ids"``:
    space-separated ids (ListOps), ``"bytes"``: the text's UTF-8 bytes
    (Text). Sequences are cut at ``seq_len`` and right-padded with 0 under a
    False mask."""

    def __init__(self, path: str, seq_len: int, mode: str, n_classes: int, vocab_size: int):
        self.seq_len = seq_len
        self.n_classes = n_classes
        self.vocab_size = vocab_size
        self.samples = []
        with open(path) as f:
            for line in f:
                label, _, seq = line.rstrip("\n").partition("\t")
                if mode == "ids":
                    ids = [int(x) for x in seq.split()][:seq_len]
                else:
                    ids = list(seq.encode("utf-8"))[:seq_len]
                self.samples.append((int(label), ids))

    def batch(self, seed: int, step: int, b: int):
        rng = np.random.Generator(np.random.Philox(key=[seed, step]))
        idx = rng.integers(0, len(self.samples), size=b)
        toks = np.zeros((b, self.seq_len), dtype=np.int32)
        mask = np.zeros((b, self.seq_len), dtype=bool)
        labels = np.zeros((b,), dtype=np.int32)
        for i, j in enumerate(idx):
            label, ids = self.samples[j]
            labels[i] = label
            toks[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return toks, labels, mask


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LRATrainConfig:
    """The JAX package's ``LRATrainConfig``: the same fields and defaults."""

    model: ModelConfig = dataclasses.field(
        default_factory=lambda: get_config("lra_listops_linear"))
    task: str = "listops"  # "listops" | "text" | path to a data dir
    steps: int = 2000
    batch_size: int = 32
    seq_len: int = 512
    lr: float = 1e-3
    warmup_steps: int = 100
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    schedule: str = "cosine"
    min_lr_ratio: float = 0.1
    optimizer: str = "adamw"
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-8
    mu_dtype: Optional[str] = None
    accum_steps: int = 1
    mesh: MeshConfig = MeshConfig()
    seed: int = 0
    log_every: int = 50
    eval_every: int = 500
    eval_batches: int = 10
    nan_policy: str = "skip"


def make_lra_dataset(cfg: LRATrainConfig, split: str = "train"):
    if cfg.task == "listops":
        return SyntheticListOps(cfg.seq_len)
    if cfg.task == "text":
        return SyntheticText(cfg.seq_len)
    mode = "ids" if cfg.model.vocab_size < 256 else "bytes"
    return TSVDataset(os.path.join(cfg.task, f"{split}.tsv"), cfg.seq_len, mode,
                      cfg.model.n_classes, cfg.model.vocab_size)


def lra_shim(cfg: LRATrainConfig) -> TrainConfig:
    """The LM trainer's config carrying ``cfg``'s optimizer and schedule."""
    return TrainConfig(
        model=cfg.model, steps=cfg.steps, lr=cfg.lr, warmup_steps=cfg.warmup_steps,
        weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm, schedule=cfg.schedule,
        min_lr_ratio=cfg.min_lr_ratio,
        # the fused passes are the LM trainer's; here Adafactor takes its plain
        # formulas, as the JAX package's optax twin
        optimizer="adafactor" if cfg.optimizer == "adafactor_fused" else cfg.optimizer,
        b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, mu_dtype=cfg.mu_dtype,
    )


def lra_loss(model: LRAClassifier, toks: Tensor, labels: Tensor, mask: Tensor,
             dropout_seed: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """(mean cross entropy plus the MoE layers' auxiliary loss, accuracy).
    On a data mesh (``toks`` this rank's rows) this rank's share of each:
    its rows' sums over the global batch, the aux over the data ranks."""
    logits, aux = model(toks, mask, deterministic=dropout_seed is None,
                        dropout_seed=dropout_seed, return_aux=True)
    right = (logits.argmax(-1) == labels).float()
    n = model.n_data
    rows = toks.shape[0] * n
    loss = F.cross_entropy(logits, labels.long(), reduction="sum") / rows + aux / n
    return loss, right.sum() / rows


def make_lra_step(model: LRAClassifier, opt, sched, root: int, dropout: float = 0.0,
                  clip_norm: float = 1.0):
    """The LRA train and eval steps over ``model``'s params, which
    ``step_fn`` updates in place with ``opt`` (``make_optimizer`` of the
    shim). ``step_fn(step, toks, labels, mask) -> metrics`` (host floats:
    loss, acc, grad_norm, lr, nonfinite); ``eval_fn(toks, labels, mask) ->``
    accuracy."""
    params = dict(model.named_parameters())
    dropout_root = rngs.stream(root, "dropout")
    mesh = model.mesh
    tp_whole = set(tp_whole_grads(model.cfg)) if model.tp_params is not None else set()

    def reduce(loss: Tensor, acc: Tensor, grads: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """On a mesh: the loss, the accuracy and every gradient summed over
        the ranks that hold other rows (the module docstring's groups)."""
        if mesh is None:
            return loss, acc
        sums = torch.stack([loss.detach(), acc]).float()
        cut = model.fsdp.dims if model.fsdp is not None else {}
        if mesh.data_group is not None:
            all_reduce_sum_([sums] + [g for n, g in grads.items() if n not in cut],
                            mesh.data_group)
        shards = [g for n, g in grads.items() if n in cut]
        if shards and mesh.dp_group is not None:
            all_reduce_sum_(shards, mesh.dp_group)
        heads = [g for n, g in grads.items() if n in tp_whole]
        if heads:
            all_reduce_sum_(heads, mesh.tp_group)
        return sums[0], sums[1]

    def step_fn(step: int, toks: Tensor, labels: Tensor, mask: Tensor) -> Dict[str, float]:
        seed = rngs.at_step(dropout_root, step) if dropout > 0.0 else None
        for p in params.values():
            p.grad = None
        loss, acc = lra_loss(model, toks, labels, mask, seed)
        loss.backward()
        grads = param_grads(params)
        loss, acc = reduce(loss, acc, grads)
        gnorm = global_norm(grads, model.fsdp, model.tp_params)
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            # optax.clip_by_global_norm: (g / norm) * max_norm above the limit
            if clip_norm and clip_norm > 0 and float(gnorm) >= clip_norm:
                grads = {n: (g.float() / gnorm) * clip_norm for n, g in grads.items()}
            opt.update(params, grads)
        for p in params.values():
            p.grad = None
        return {"loss": float(loss.detach()), "acc": float(acc), "grad_norm": float(gnorm),
                "lr": sched(step), "nonfinite": float(not finite)}

    @torch.no_grad()
    def eval_fn(toks: Tensor, labels: Tensor, mask: Tensor) -> float:
        hits = (model(toks, mask).argmax(-1) == labels).float().sum().reshape(1)
        if mesh is not None and mesh.data_group is not None:
            all_reduce_sum_([hits], mesh.data_group)
        return float(hits[0]) / (toks.shape[0] * model.n_data)

    return step_fn, eval_fn


def _put(batch, device, mesh=None):
    """A host batch on ``device``: this rank's rows of it on a data mesh."""
    out = tuple(torch.from_numpy(a).to(device) for a in batch)
    toks, labels, mask = out if mesh is None else tuple(mesh.rows(a) for a in out)
    return toks.long(), labels.long(), mask


def train_lra(cfg: LRATrainConfig, logger: Optional[MetricsLogger] = None, device=None,
              mesh=None) -> Tuple[Dict[str, Tensor], Dict[str, float]]:
    """Train ``cfg`` -> (the params by name, whole, the last logged metrics
    with ``eval_acc``). ``device`` defaults to ``"cuda"``. ``mesh``: the
    ``parallel.mesh.Mesh`` of ``init_distributed`` that a ``cfg.mesh`` with
    an axis above 1 needs (the module docstring); the model then runs on
    the mesh's device and only rank 0 logs."""
    cfg.mesh.check()  # ep raises, naming A12 step 8
    if cfg.accum_steps != 1:
        raise ValueError("train_lra takes accum_steps=1, as the JAX package's step does")
    if mesh is None and any(n > 1 for n in cfg.mesh.shape):
        raise ValueError(f"mesh {cfg.mesh.shape} needs its process group: pass the Mesh of "
                         "parallel.init_distributed")
    if mesh is not None:
        want = cfg.mesh.resolve(mesh.world)
        if mesh.cfg != want:
            raise ValueError(f"cfg.mesh resolves to {want.shape} on {mesh.world} ranks, the "
                             f"Mesh is {mesh.cfg.shape}")
        if (want.fsdp > 1 or want.tp > 1) and cfg.optimizer in ("adafactor", "adafactor_fused"):
            raise NotImplementedError(
                f"optimizer={cfg.optimizer!r} under fsdp or tp (factored statistics take the "
                "whole leaf) is not ported to orion_tpu_torch yet (ROADMAP.md queue A, item 12 "
                "(parallelism), A12 step 9)")
        if cfg.batch_size % mesh.n_data:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide into dp * fsdp = "
                             f"{mesh.n_data} row blocks")
        device = mesh.device
        mesh = mesh if mesh.world > 1 else None
    dev = resolve_device(device)
    root = rngs.root_key(cfg.seed)
    model = LRAClassifier(cfg.model, device=dev,
                          generator=rngs.generator(rngs.stream(root, "init"), dev), mesh=mesh)
    logger = logger if mesh is None or mesh.is_main else None
    shim = lra_shim(cfg)
    params = dict(model.named_parameters())
    transposed = {key: t for key, _, t in
                  expected_params(cfg.model, classifier=True).values()}
    opt = make_optimizer(shim, params, transposed)
    sched = make_schedule(shim)
    ds = make_lra_dataset(cfg)
    if ds.vocab_size > cfg.model.vocab_size or ds.n_classes != cfg.model.n_classes:
        raise ValueError(f"dataset (vocab {ds.vocab_size}, {ds.n_classes} classes) does not "
                         f"fit the model {cfg.model}")
    step_fn, eval_fn = make_lra_step(model, opt, sched, root, cfg.model.dropout, cfg.clip_norm)

    last: Dict[str, float] = {}
    for step in range(1, cfg.steps + 1):
        metrics = step_fn(step - 1, *_put(ds.batch(cfg.seed, step - 1, cfg.batch_size), dev,
                                          mesh))
        if step % cfg.log_every == 0 or step == cfg.steps:
            last = dict(metrics)
            if logger:
                logger.log(step, last, cfg.batch_size * cfg.seq_len)
        if cfg.eval_every and (step % cfg.eval_every == 0 or step == cfg.steps):
            eval_ds = make_lra_dataset(cfg, "val") if os.path.isdir(cfg.task) else ds
            accs = [eval_fn(*_put(eval_ds.batch(cfg.seed + 99, 10_000_000 + i, cfg.batch_size),
                                  dev, mesh))
                    for i in range(cfg.eval_batches)]
            last["eval_acc"] = sum(accs) / len(accs)
            if logger:
                logger.log(step, {"eval_acc": last["eval_acc"]})
    axes = list(reversed(model.shard_axes))  # fsdp's cut first undone, then tp's
    return {n: whole_leaf(n, p.detach(), axes) for n, p in model.named_parameters()}, last


def main(argv=None) -> int:
    from orion_tpu_torch.utils.config import apply_overrides, parse_set_overrides

    p = argparse.ArgumentParser("orion_tpu_torch.train_lra")
    p.add_argument("--config", default="lra_listops_linear")
    p.add_argument("--task", default="listops")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-path", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="ModelConfig override, e.g. --set feature_map=favor (the generate CLI's "
        "syntax)",
    )
    args = p.parse_args(argv)

    model = get_config(args.config, max_seq_len=args.seq_len + 8)
    if args.set:
        model = apply_overrides(model, parse_set_overrides(args.set))
    cfg = LRATrainConfig(model=model, task=args.task, steps=args.steps,
                         batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
                         seed=args.seed)
    logger = MetricsLogger(args.log_path)
    t0 = time.time()
    _, last = train_lra(cfg, logger, device=args.device)
    print({k: round(v, 4) for k, v in last.items()}, f"({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
