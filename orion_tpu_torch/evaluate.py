"""`python -m orion_tpu_torch.evaluate` -- held-out loss and perplexity of a
checkpoint: the one eval-loss definition.

The port's counterpart of ``orion_tpu/evaluate.py``. ``lm_eval_sums`` and
``evaluate_lm`` are the library part; ``Trainer.evaluate`` uses the same
function, so the periodic in-training eval and a standalone one cannot
drift. The CLI loads a checkpoint's params as ``generate`` does
(``generate.load_model``: retried, manifest-verified, falling back to the
newest intact step unless ``--step`` pins one):

    python -m orion_tpu_torch.evaluate --config tiny --ckpt-dir ck --data val.bin
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Tuple

import torch

from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops.fused_ce import fused_ce_ok, model_token_losses

Tensor = torch.Tensor


@torch.no_grad()
def lm_eval_sums(model: TransformerLM, batch: Tensor) -> Tuple[Tensor, Tensor]:
    """batch [B, T+1] -> (sum of next-token cross entropy, token count),
    through the fused head + CE (no [B, T, V] fp32 logits) where it
    applies. The MoE layers' auxiliary loss is left out, as in the JAX
    package's eval. On a sequence-parallel model: this rank's shard's sums
    (the inputs and labels shifted before sharding)."""
    x, y = batch[:, :-1], batch[:, 1:]
    if model.sp is not None:
        x, y = model.sp.shard(x), model.sp.shard(y)
    if fused_ce_ok(model):
        losses, _ = model_token_losses(model, x, y)
    else:
        losses = torch.nn.functional.cross_entropy(
            model(x).transpose(1, 2), y.long(), reduction="none")
    return losses.sum(), torch.tensor(float(losses.numel()), device=losses.device)


def evaluate_lm(
    model: TransformerLM, dataset, batch_size: int = 8, n_batches: int = 16, seed: int = 123,
) -> dict:
    """Mean loss and perplexity over ``n_batches`` of ``dataset`` (batches
    ``dataset.batch(seed, i, batch_size)``)."""
    total, count = 0.0, 0.0
    for i in range(n_batches):
        batch = torch.from_numpy(dataset.batch(seed, i, batch_size)).to(model.device)
        s, c = lm_eval_sums(model, batch)
        total += float(s)
        count += float(c)
    loss = total / max(count, 1.0)
    return {"eval_loss": loss, "eval_ppl": math.exp(min(loss, 20.0)), "tokens": int(count)}


def main(argv=None) -> int:
    from orion_tpu_torch.generate import load_model, quantize_for_decode
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.quant import MODES
    from orion_tpu_torch.training.data import make_dataset
    from orion_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser("orion_tpu_torch.evaluate")
    p.add_argument("--config", default="tiny")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="the step to evaluate (default the newest intact one); a pinned step "
                        "never falls back")
    p.add_argument("--data", default="synthetic", help="'synthetic' or token-bin path")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--n-batches", type=int, default=16)
    p.add_argument("--quant", default="", choices=list(MODES),
                   help="evaluate the quantized model (the quant acceptance bar: eval-ppl "
                        "delta against full precision on the same held-out data)")
    p.add_argument("--ckpt-attempts", type=int, default=4,
                   help="total tries for each checkpoint read (transient I/O retried with "
                        "jittered backoff; 1 = no retry)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model, step = load_model(get_config(args.config), args.ckpt_dir, device, args.step,
                             args.ckpt_attempts)
    if args.seq_len >= model.cfg.max_seq_len:
        raise ValueError(f"--seq-len {args.seq_len} needs positions up to {args.seq_len}, but "
                         f"the checkpoint was trained with max_seq_len={model.cfg.max_seq_len}")
    if args.quant:
        model = quantize_for_decode(model, args.quant)
    dataset = make_dataset(args.data, args.seq_len, model.cfg.vocab_size)
    res = evaluate_lm(model, dataset, args.batch_size, args.n_batches)
    res["step"] = step
    if args.quant:
        res["quant"] = args.quant
    print(res)
    return 0


__all__ = ["lm_eval_sums", "evaluate_lm", "main"]


if __name__ == "__main__":
    sys.exit(main())
