"""`python -m orion_tpu_torch.train` -- the training entry point.

The port's counterpart of ``orion_tpu/train.py``. Library use:

    from orion_tpu_torch.train import train
    trainer, metrics = train(TrainConfig(model=get_config("tiny"), steps=100),
                             data="synthetic", device="cpu")

CLI (on the card unless ``--device cpu``):

    python -m orion_tpu_torch.train --config tiny --steps 1000 --data synthetic \\
        --set lr=1e-3 --set model.n_layers=4 --ckpt-dir /tmp/ckpt

Not ported yet (ROADMAP.md queue A, item 9): ``--preempt-grace`` and
``--step-timeout`` (the resilience wiring), ``--metrics-path`` (the
Prometheus dump) and ``--distributed``. Mesh flags other than 1 raise
(item 12).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Tuple

from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.training.checkpoint import Checkpointer
from orion_tpu_torch.training.data import DataLoader, device_batch, make_dataset
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
) -> Tuple[Trainer, dict]:
    """Build everything, optionally resume from ``cfg.ckpt_dir``, run to
    ``cfg.steps``, save a final checkpoint. Returns (trainer, last
    metrics)."""
    if eval_data and not cfg.eval_every:
        raise ValueError(
            "eval_data given but eval_every == 0: the held-out split would never be "
            "evaluated; set eval_every > 0 (CLI: --eval-every N)"
        )
    trainer = Trainer(cfg, device=device)
    ckpt = None
    if cfg.ckpt_dir:
        ckpt = Checkpointer(cfg.ckpt_dir, max_to_keep=cfg.ckpt_keep, save_every=cfg.ckpt_every)
        if resume and ckpt.latest_step is not None:
            print(f"resumed from step {trainer.restore(ckpt)}", file=sys.stderr)

    dataset = make_dataset(data, cfg.seq_len, cfg.model.vocab_size)
    if dataset.vocab_size > cfg.model.vocab_size:
        raise ValueError(f"data vocab {dataset.vocab_size} > model vocab {cfg.model.vocab_size}")
    loader = DataLoader(dataset, cfg.batch_size, seed=cfg.seed,
                        start_step=trainer.step_count, device=trainer.device)
    eval_factory = None
    if cfg.eval_every:
        eval_ds = (make_dataset(eval_data, cfg.seq_len, cfg.model.vocab_size)
                   if eval_data else dataset)

        def eval_factory(step, _ds=eval_ds):
            # batches a pure function of the train step: a resumed run
            # evaluates any step on the same batches
            base = 10_000_000 + step * cfg.eval_batches
            return (
                device_batch(_ds, cfg.seed + 1, base + j, cfg.batch_size, trainer.device)
                for j in range(cfg.eval_batches)
            )

    logger = MetricsLogger(log_path)
    try:
        last = trainer.train(iter(loader), logger=logger, ckpt=ckpt, eval_factory=eval_factory)
        if ckpt is not None:
            ckpt.maybe_save(trainer.step_count, trainer.state_dict(), force=True)
    finally:
        loader.close()
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
    p.add_argument("--seed", type=int, default=0)
    for axis in ("dp", "fsdp", "tp", "sp", "pp", "ep"):
        p.add_argument(f"--{axis}", type=int, default=-1 if axis == "dp" else 1,
                       help="mesh axis size; the port trains on one device, so > 1 raises")
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
    _, last = train(cfg, data=args.data, eval_data=args.eval_data,
                    log_path=args.log_path, device=args.device)
    print({k: round(v, 5) for k, v in last.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
