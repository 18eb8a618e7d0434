"""`python -m orion_tpu_torch.train` -- the training entry point.

The port's counterpart of ``orion_tpu/train.py``. Library use:

    from orion_tpu_torch.train import train
    trainer, metrics = train(TrainConfig(model=get_config("tiny"), steps=100),
                             data="synthetic", device="cpu")

CLI (on the card unless ``--device cpu``):

    python -m orion_tpu_torch.train --config tiny --steps 1000 --data synthetic \\
        --set lr=1e-3 --set model.n_layers=4 --ckpt-dir /tmp/ckpt

Parallel training (one process a rank, e.g. four ranks on one host):

    torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed --sp 4 \
        --config hybrid_1b3 --seq-len 2048 --set model.sequence_parallel=true
    torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed --dp 2 --fsdp 2
    torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed --tp 2 --dp 2
    torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed --pp 2 --dp 2

``--distributed`` joins the process group from torchrun's environment
(``parallel.init_distributed``: NCCL when each rank has its own card, gloo
when they share one, printed to stderr) with the mesh of ``--dp``,
``--fsdp``, ``--tp``, ``--sp`` and ``--pp`` (``--dp -1``, the default,
takes the ranks the others leave). Each data rank (dp x fsdp) reads only its
rows of each global batch, each sp rank its shard of the tokens; fsdp
shards the params and the optimizer state; the tp ranks of a data rank read
the same rows and each holds its share of the heads and the MLPs' hidden
dimension; the pp ranks of a data rank read the same rows and each holds
one stage of the blocks, the batch running through them as a GPipe pipeline
of ``pp_microbatches`` microbatches (``--set pp_microbatches=N``; 0, the
default, picks it). Rank 0 logs, prints and writes the checkpoints, the
file a one-rank run writes.

Resilience, as the JAX package's CLI: ``--preempt-grace`` (default 10 s; 0
turns it off) installs a SIGTERM / SIGINT ``PreemptionGuard`` for the run:
the first signal stops the run at the next step boundary, an emergency
checkpoint is saved and the CLI exits 0 with ``preempted at step N:
emergency checkpoint saved; rerun with the same --ckpt-dir to resume`` (a
second signal kills). On a mesh every rank stops at the same boundary (the
stop flag is reduced over the ranks) and the save is the mesh's one file.
``--step-timeout`` arms a hang watchdog (no step in that many seconds:
thread stacks to stderr, then the guard's stop, then an abort) and gives the
train and eval loaders the same stall budget. ``--metrics-path`` writes the
training registry (Prometheus text + ``.json``) on every exit path. With
``--ckpt-dir`` the flight recorder dumps into ``<ckpt-dir>/flight``.
``--ep`` above 1 raises (item 12: A12 step 8), and so does any axis above
1 without ``--distributed``. Under ``--fsdp``, ``--tp`` or ``--pp``
``optimizer=adafactor`` and ``param_storage=bfloat16_sr`` (step 9) raise.
Dropout (``--set model.dropout=...``) and MoE configs run on every mesh;
under ``--sp`` a MoE layer's load-balance statistics are the global batch's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
from typing import Optional, Tuple

from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.obs import flight
from orion_tpu_torch.parallel.mesh import init_distributed
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.watchdog import Watchdog
from orion_tpu_torch.training.checkpoint import Checkpointer
from orion_tpu_torch.training.data import DataLoader, make_dataset
from orion_tpu_torch.training.metrics import MetricsLogger
from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer
from orion_tpu_torch.utils.config import (
    apply_overrides,
    load_json_overrides,
    parse_set_overrides,
)


def train(
    cfg: TrainConfig,
    data: str = "synthetic",
    eval_data: Optional[str] = None,
    log_path: Optional[str] = None,
    resume: bool = True,
    device=None,
    mesh=None,
    metrics_path: Optional[str] = None,
) -> Tuple[Trainer, dict]:
    """Build everything, optionally resume from ``cfg.ckpt_dir``, run to
    ``cfg.steps`` (or to a preemption: ``trainer.preempted_at``), save a
    final checkpoint. Returns (trainer, last metrics). ``mesh``:
    ``init_distributed``'s, for a ``cfg.mesh`` with an axis above 1 (each
    data rank then reads its rows, rank 0 logs and writes the checkpoints).
    ``cfg.preempt_grace > 0`` installs the preemption guard for the run,
    ``cfg.step_timeout > 0`` the watchdog and the loaders' stall budget;
    ``metrics_path``: the registry's dump, written on every exit path."""
    if eval_data and not cfg.eval_every:
        raise ValueError(
            "eval_data given but eval_every == 0: the held-out split would never be "
            "evaluated; set eval_every > 0 (CLI: --eval-every N)"
        )
    trainer = Trainer(cfg, device=device, mesh=mesh)
    ckpt = None
    if cfg.ckpt_dir:
        ckpt = Checkpointer(cfg.ckpt_dir, max_to_keep=cfg.ckpt_keep, save_every=cfg.ckpt_every)
        if resume and ckpt.latest_step is not None:
            print(f"resumed from step {trainer.restore(ckpt)}", file=sys.stderr)
        # a preemption or a nan halt leaves its flight dump beside the
        # checkpoint it saved
        flight.configure(dump_dir=os.path.join(cfg.ckpt_dir, "flight"))

    dataset = make_dataset(data, cfg.seq_len, cfg.model.vocab_size)
    if dataset.vocab_size > cfg.model.vocab_size:
        raise ValueError(f"data vocab {dataset.vocab_size} > model vocab {cfg.model.vocab_size}")
    if trainer.is_main:
        print(f"data: {data} through {type(dataset).__name__}", file=sys.stderr)
    stall = cfg.step_timeout if cfg.step_timeout > 0 else None
    rows = eval_rows = None
    if trainer.mesh is not None and trainer.mesh.n_data > 1:
        rows = trainer.row_index(cfg.batch_size)
        eval_rows = trainer.mesh.row_index(cfg.batch_size)
    loader = DataLoader(dataset, cfg.batch_size, seed=cfg.seed, start_step=trainer.step_count,
                        device=trainer.device, rows=rows, stall_timeout=stall)
    eval_factory = None
    if cfg.eval_every:
        eval_ds = (make_dataset(eval_data, cfg.seq_len, cfg.model.vocab_size)
                   if eval_data else dataset)

        def eval_factory(step, _ds=eval_ds):
            # batches a pure function of the train step: a resumed run
            # evaluates any step on the same batches. A short-lived loader
            # with the train reads' stall budget: a dead mount under
            # --eval-data raises StallError, not hangs the (watchdog-
            # disarmed) eval pass
            ev = DataLoader(_ds, cfg.batch_size, seed=cfg.seed + 1,
                            start_step=10_000_000 + step * cfg.eval_batches,
                            device=trainer.device, rows=eval_rows, stall_timeout=stall)

            def gen():
                try:
                    for _ in range(cfg.eval_batches):
                        yield next(ev)
                finally:
                    ev.close()

            return gen()

    logger = MetricsLogger(log_path) if trainer.is_main else None
    guard_cm = (PreemptionGuard(
        cfg.preempt_grace,
        # the black box records the signal the moment it lands (a lock-free
        # append: the handler runs between two arbitrary bytecodes)
        on_stop=lambda signum: flight.recorder().record_signal_safe("preempt_signal",
                                                                    signum=signum))
        if cfg.preempt_grace > 0 else contextlib.nullcontext())
    watchdog = Watchdog(cfg.step_timeout) if cfg.step_timeout > 0 else None
    try:
        with guard_cm as guard:
            last = trainer.train(iter(loader), logger=logger, ckpt=ckpt,
                                 eval_factory=eval_factory, preempt=guard, watchdog=watchdog)
        if trainer.preempted_at is not None:
            if trainer.is_main:
                note = ("emergency checkpoint saved; rerun with the same --ckpt-dir to resume"
                        if ckpt is not None else
                        "NO checkpointer configured: progress since the start is lost "
                        "(set --ckpt-dir)")
                print(f"preempted at step {trainer.preempted_at}: {note}", file=sys.stderr)
        elif ckpt is not None:
            if watchdog is not None:
                watchdog.disarm()  # the final save may outlast a step's budget
            trainer._save(ckpt, trainer.step_count, force=True)
    finally:
        if watchdog is not None:
            watchdog.close()
        loader.close()
        if logger is not None:
            if metrics_path:
                # the final scrape on every exit path
                try:
                    logger.dump(metrics_path)
                except OSError as e:
                    print(f"metrics dump failed: {e}", file=sys.stderr)
            logger.close()
    return trainer, last


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("orion_tpu_torch.train")
    p.add_argument("--config", default="tiny", help="named model config")
    p.add_argument("--data", default="synthetic", help="'synthetic' or token-bin path")
    p.add_argument("--eval-data", default=None,
                   help="held-out token-bin path for eval (default: train data)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval cadence in steps (0 = no interleaved eval)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log-path", default=None)
    p.add_argument("--metrics-path", default=None,
                   help="Prometheus-text metrics file (+ .json sibling), written on exit: the "
                   "registry format the serving and fleet CLIs expose")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preempt-grace", type=float, default=10.0,
                   help="seconds budgeted for the emergency checkpoint on SIGTERM / SIGINT (a "
                   "graceful stop at the next step boundary); 0 leaves the signals alone")
    p.add_argument("--step-timeout", type=float, default=0.0,
                   help="hang watchdog: no step completed (or no data batch arrived) for this "
                   "many seconds -> StallError; must exceed the kernels' build + one step; 0 "
                   "disables")
    for axis in ("dp", "fsdp", "tp", "sp", "pp", "ep"):
        p.add_argument(f"--{axis}", type=int, default=-1 if axis == "dp" else 1,
                       help="mesh axis size; dp, fsdp, tp, sp and pp > 1 take --distributed, "
                       "ep > 1 raises")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group from torchrun's environment (dp, fsdp, tp, sp, "
                   "pp)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted TrainConfig override, e.g. --set model.n_layers=4")
    p.add_argument("--config-json", default=None, help="JSON override file")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; --device cpu runs on the CPU)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = TrainConfig(
        model=get_config(args.config),
        steps=args.steps,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        lr=args.lr,
        seed=args.seed,
        eval_every=args.eval_every,
        ckpt_dir=args.ckpt_dir,
        preempt_grace=args.preempt_grace,
        step_timeout=args.step_timeout,
        mesh=MeshConfig(dp=args.dp, fsdp=args.fsdp, tp=args.tp, sp=args.sp,
                        pp=args.pp, ep=args.ep),
    )
    if args.config_json:
        cfg = apply_overrides(cfg, load_json_overrides(args.config_json))
    overrides = parse_set_overrides(args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if cfg.seq_len >= cfg.model.max_seq_len:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, max_seq_len=cfg.seq_len + 1))
    mesh = None
    if args.distributed:
        mesh = init_distributed(cfg.mesh, device=args.device)
    try:
        trainer, last = train(cfg, data=args.data, eval_data=args.eval_data,
                              log_path=args.log_path, device=args.device, mesh=mesh,
                              metrics_path=args.metrics_path)
        if trainer.is_main:
            print({k: round(v, 5) for k, v in last.items()})
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
