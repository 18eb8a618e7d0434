"""Held-out loss and perplexity: the one eval-loss definition.

The port's counterpart of ``orion_tpu/evaluate.py``'s library part
(``lm_eval_sums``, ``evaluate_lm``); ``Trainer.evaluate`` uses the same
function, so the periodic in-training eval and a standalone one cannot
drift. Its CLI, which loads orbax checkpoints, is not ported (ROADMAP.md
queue A, item 5).
"""

from __future__ import annotations

import math
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
    package's eval."""
    x, y = batch[:, :-1], batch[:, 1:]
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


__all__ = ["lm_eval_sums", "evaluate_lm"]
