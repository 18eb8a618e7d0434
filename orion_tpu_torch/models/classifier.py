"""LRA classifier in PyTorch: a bidirectional encoder, CLS pooling and a
linear head. The port's counterpart of ``orion_tpu/models/classifier.py``.

The LRA eval configs (``lra_{listops,text}_{linear,softmax}``) compare
linear and softmax attention on ListOps and Text. The classifier stacks the
LM's blocks with ``causal=False``; a key padding mask rides through to both
attention families: masked keys drop out of the linear layers' kv-sum
(``linear_attention_noncausal``), and out of the softmax layers' scores
(the plain masked form, as the JAX package takes it). Neither runs a
kernel, in the JAX package or here.

On a mesh (``mesh``, a ``parallel.mesh.Mesh``) the classifier computes the
one-device function, as the JAX package's GSPMD does with its unmeshed
classifier: each data rank (dp x fsdp) takes its rows of the batch; fsdp
cuts the leaves its rules name (the tables and the head kernel along d,
``parallel/sharding.py``), gathered where they are read (a block's inside
its remat region); tp holds n_heads / tp heads and its share of each MLP's
hidden dimension, the LM's Megatron layout; the head, ``cls`` and the norms
stay whole on every tp rank. The sp and pp axes replicate: every rank of
them computes the same rows whole (JAX's classifier takes no mesh, so
GSPMD only replicates over them). A MoE layer's load-balance statistics
are averaged over the data group.
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
from orion_tpu_torch.parallel.mesh import Mesh
from orion_tpu_torch.parallel.sharding import AxisParams, FsdpParams, fsdp_dims, tp_dims
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class ClassifierHead(nn.Module):
    """The params of flax ``nn.Dense(n_classes, dtype=float32)`` with a bias:
    ``weight`` [n_classes, D] (the flax kernel transposed), fp32.
    ``LRAClassifier.forward`` applies them, the weight gathered whole."""

    def __init__(self, d: int, n_classes: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_classes, d, device=device))
        self.bias = nn.Parameter(torch.zeros(n_classes, device=device))


class LRAClassifier(nn.Module):
    """tokens [B, T] (+ optional mask [B, T], True = a real token) ->
    logits [B, n_classes], fp32.

    The token embedding plus the positions' embedding, the learned ``cls``
    vector [D] prepended (and True prepended to the mask), the blocks
    (bidirectional), ``final_norm`` on the CLS row, then ``head``.
    Parameters are fp32, drawn from ``generator`` (seeded 0 on ``device``
    by default) with the flax inits: normal(1/sqrt(D)) for the tables,
    normal(0.02) for ``cls``, lecun_normal and a zero bias for the head, and
    the blocks' as ``TransformerLM``'s. ``device`` defaults to ``"cuda"``.
    ``mesh``: see the module docstring; the params are drawn whole from
    ``generator``, then cut (tp first, then fsdp cuts the tp shard), and
    ``tokens`` / ``mask`` are this rank's rows."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None):
        super().__init__()
        if cfg.n_classes <= 0:
            raise ValueError("a classifier config needs n_classes > 0")
        if mesh is not None:
            mesh.cfg.check()  # ep raises, naming A12 step 8
        check_supported(cfg)
        if cfg.param_dtype != "float32":
            raise ValueError(f"param_dtype must be float32, got {cfg.param_dtype!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.cdt = _dtype(cfg.dtype)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dev)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dev)
        self.cls = nn.Parameter(torch.empty(cfg.d_model, device=dev))
        self.mesh = mesh
        self.n_data = mesh.n_data if mesh is not None else 1
        self.blocks = nn.ModuleList(
            Block(cfg, lt, dev, use_moe=cfg.moe_at(i), causal=False, mesh=mesh)
            for i, lt in enumerate(cfg.resolved_layer_types)
        )
        self.final_norm = make_norm(cfg, dev)
        self.head = ClassifierHead(cfg.d_model, cfg.n_classes, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)
        self.tp_params = self.fsdp = None
        if mesh is not None and mesh.tp > 1:
            self.tp_params = AxisParams(tp_dims(cfg, mesh.tp, classifier=True), mesh.tp_group,
                                        mesh.tp, mesh.tp_rank)
            self.tp_params.shard_module(self)
        if mesh is not None and mesh.fsdp > 1:
            self.fsdp = FsdpParams(fsdp_dims(cfg, mesh.fsdp, classifier=True), mesh.fsdp_group,
                                   mesh.fsdp, mesh.fsdp_rank)
            self.fsdp.shard_module(self)

    @property
    def shard_axes(self):
        """The axes this rank's params are cut over, in the order they were
        cut: tp's, then fsdp's (empty: every param whole)."""
        return [a for a in (self.tp_params, self.fsdp) if a is not None]

    def _whole(self, name: str) -> Tensor:
        """The parameter ``name``, gathered over the fsdp group if it is a
        shard."""
        owner, _, attr = name.rpartition(".")
        p = getattr(self.get_submodule(owner) if owner else self, attr)
        return p if self.fsdp is None else self.fsdp.full(name, p)

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
        x = (self._whole("embed.weight")[tokens]
             + self._whole("pos_embed.weight")[torch.arange(t, device=tokens.device)])
        cls = self.cls.expand(b, 1, -1)
        x = torch.cat([cls, x.to(cls.dtype)], dim=1).to(self.cdt)
        if mask is not None:
            mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=mask.device),
                              mask.bool()], dim=1)
        call = None
        if self.fsdp is not None:  # block i's leaves are named "blocks.{i}.*"
            def call(i, blk):
                return lambda *a: self.fsdp.call(blk, f"blocks.{i}.", *a)
        row = self.mesh.data_rank * b if self.mesh is not None else 0
        x, aux = run_blocks(self.blocks, self.cfg, x, deterministic, dropout_seed, mask,
                            call=call, origin=(row, 0))
        return self.final_norm(x[:, 0]), aux

    def forward(self, tokens: Tensor, mask: Optional[Tensor] = None,
                deterministic: bool = True, dropout_seed: Optional[int] = None,
                return_aux: bool = False):
        """tokens [B, T] -> logits [B, n_classes] (fp32); with ``return_aux``
        also the MoE layers' auxiliary loss."""
        pooled, aux = self.features(tokens, mask, deterministic, dropout_seed)
        logits = F.linear(pooled.float(), self._whole("head.weight").float(),
                          self.head.bias.float())
        return (logits, aux) if return_aux else logits


__all__ = ["LRAClassifier", "ClassifierHead"]
