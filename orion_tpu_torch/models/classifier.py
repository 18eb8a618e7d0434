"""LRA classifier in PyTorch: a bidirectional encoder, CLS pooling and a
linear head. The port's counterpart of ``orion_tpu/models/classifier.py``.

The LRA eval configs (``lra_{listops,text}_{linear,softmax}``) compare
linear and softmax attention on ListOps and Text. The classifier stacks the
LM's blocks with ``causal=False``; a key padding mask rides through to both
attention families: masked keys drop out of the linear layers' kv-sum
(``linear_attention_noncausal``), and out of the softmax layers' scores
(the plain masked form, as the JAX package takes it). Neither runs a
kernel, in the JAX package or here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.transformer import (Block, Embed, _dtype, check_supported,
                                                init_blocks, lecun_normal, make_norm,
                                                run_blocks)
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class ClassifierHead(nn.Module):
    """flax ``nn.Dense(n_classes, dtype=float32)`` with a bias: ``weight``
    [n_classes, D] (the flax kernel transposed), fp32."""

    def __init__(self, d: int, n_classes: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_classes, d, device=device))
        self.bias = nn.Parameter(torch.zeros(n_classes, device=device))

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class LRAClassifier(nn.Module):
    """tokens [B, T] (+ optional mask [B, T], True = a real token) ->
    logits [B, n_classes], fp32.

    The token embedding plus the positions' embedding, the learned ``cls``
    vector [D] prepended (and True prepended to the mask), the blocks
    (bidirectional), ``final_norm`` on the CLS row, then ``head``.
    Parameters are fp32, drawn from ``generator`` (seeded 0 on ``device``
    by default) with the flax inits: normal(1/sqrt(D)) for the tables,
    normal(0.02) for ``cls``, lecun_normal and a zero bias for the head, and
    the blocks' as ``TransformerLM``'s. ``device`` defaults to ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.n_classes <= 0:
            raise ValueError("a classifier config needs n_classes > 0")
        check_supported(cfg)
        if cfg.param_dtype != "float32":
            raise ValueError(f"param_dtype must be float32, got {cfg.param_dtype!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.cdt = _dtype(cfg.dtype)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dev)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dev)
        self.cls = nn.Parameter(torch.empty(cfg.d_model, device=dev))
        self.blocks = nn.ModuleList(
            Block(cfg, lt, dev, use_moe=cfg.moe_at(i), causal=False)
            for i, lt in enumerate(cfg.resolved_layer_types)
        )
        self.final_norm = make_norm(cfg, dev)
        self.head = ClassifierHead(cfg.d_model, cfg.n_classes, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 1.0 / (self.cfg.d_model ** 0.5)
        for table in (self.embed, self.pos_embed):
            table.weight.normal_(0.0, std, generator=generator)
        self.cls.normal_(0.0, 0.02, generator=generator)
        init_blocks(self.blocks, generator)
        init_blocks(self.final_norm, generator)
        lecun_normal(self.head.weight, self.cfg.d_model, generator)
        self.head.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.pos_embed.weight.device

    def features(self, tokens: Tensor, mask: Optional[Tensor] = None,
                 deterministic: bool = True, dropout_seed: Optional[int] = None,
                 ) -> Tuple[Tensor, Tensor]:
        """-> (the final-normed CLS row [B, D], the MoE layers' summed
        auxiliary loss). Dropout and rematerialization as
        ``TransformerLM.features``."""
        b, t = tokens.shape
        x = self.embed(tokens) + self.pos_embed(torch.arange(t, device=tokens.device))
        cls = self.cls.expand(b, 1, -1)
        x = torch.cat([cls, x.to(cls.dtype)], dim=1).to(self.cdt)
        if mask is not None:
            mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=mask.device),
                              mask.bool()], dim=1)
        x, aux = run_blocks(self.blocks, self.cfg, x, deterministic, dropout_seed, mask)
        return self.final_norm(x[:, 0]), aux

    def forward(self, tokens: Tensor, mask: Optional[Tensor] = None,
                deterministic: bool = True, dropout_seed: Optional[int] = None,
                return_aux: bool = False):
        """tokens [B, T] -> logits [B, n_classes] (fp32); with ``return_aux``
        also the MoE layers' auxiliary loss."""
        pooled, aux = self.features(tokens, mask, deterministic, dropout_seed)
        logits = self.head(pooled)
        return (logits, aux) if return_aux else logits


__all__ = ["LRAClassifier", "ClassifierHead"]
