"""TransformerLM in PyTorch: the linear, softmax and sliding-window layers
of ``orion_tpu/models/transformer.py``, and the blocks the LRA classifier
(``models/classifier.py``) stacks.

Decoder LM with per-layer attention of type ``"linear"`` (causal linear
attention, elu+1 phi by default), ``"softmax"`` (full causal softmax) or
``"swa"`` (sliding-window softmax over ``cfg.window`` keys) -- the hybrid
family mixes the last two kinds with linear layers -- plus SwiGLU or GELU
MLP (a routed-expert ``MoEMLP``, ``models/moe.py``, in the blocks
``cfg.moe_at`` names), RMSNorm or LayerNorm (``cfg.norm``), learned
positions and a tied or untied head (``cfg.tie_embeddings``). Softmax and
swa layers rotate q and k (RoPE, ``ops/rotary.py``). A linear layer's phi is
``cfg.feature_map``: an elementwise map, ``favor`` (random features over the
fixed projection ``favor_proj`` [Dh, Dh], drawn orthogonal-Gaussian and never
trained) or ``learnable`` (a bias-free dense ``phi_proj`` Dh -> Dh, then
elu+1). Three entry methods, as in the JAX package:

- ``forward(tokens)``            -- the parallel forward -> logits [B, T, V];
  ``features(tokens)`` is its input to the head, which the fused-CE training
  loss (``ops/fused_ce.py``) takes with ``head_weight()``; with grad enabled
  every layer's attention runs its kernels forward and backward (linear:
  ``ops.linear_attention`` -> ``LinearAttentionFn``; softmax / swa:
  ``ops.softmax_attention`` -> ``FlashAttentionFn``; a dropless MoE layer's
  expert products: ``ops/kernels/gmm.py`` -> ``GmmFn``), blocks before the
  last ``remat_skip`` are recomputed in the backward when ``cfg.remat``
  (``torch.utils.checkpoint``; ``remat_policy="dots"`` keeps the matrix
  products' outputs and recomputes the rest), and ``deterministic=False``
  applies block
  dropout drawn from generators seeded per layer from ``dropout_seed``;
- ``prefill(tokens)`` / ``prefill_last(tokens)`` -- the same forward, also
  returning each layer's decode state: (S, z) for a linear layer, a KV
  cache for a softmax layer (capacity ``max_seq_len``) and a ring of the
  last ``window`` keys and values for a swa layer, both in the compute
  dtype; on the card every attention runs its forward kernel;
- ``decode_step(token, states, t)`` -- one step: O(1) state for linear
  layers, one query over the cache for softmax / swa (plain torch, as the
  JAX package leaves it to XLA). ``t`` is a scalar position or one per
  sequence [B]. The caches and rings are written in place (a caller that
  keeps a state across a step copies it first: ``snapshot_decode_state``);
  a ``write`` mask [B] leaves the other rows' state bitwise as it was.
  Every row-wise product of the step (the dense layers, the norms, phi's
  projections, the head) runs on the rows padded with zeros to
  ``DECODE_ROWS`` (``decode_rows``), so a row's logits and state are
  bitwise the same in a batch of any size up to 64 as alone: the libraries
  choose their kernels and reduction orders by the row count, and one row
  count makes that choice once. A batch of more rows runs unpadded and is
  not covered;
- ``prefill_extend_step(tokens, states, offset, length)`` -- one piece of
  a chunked prefill, for the serving engine's in-scan admission.

Numerics follow the flax model (these are where parity breaks first):
dense layers run in the compute dtype on weights rounded to it (flax
``Dense(dtype=bf16, param_dtype=f32)`` rounds the fp32 kernel at each call,
so rounding once, ``generate.cast_params_for_inference``, is bitwise the
same; training keeps the fp32 params and rounds at each call, as flax
does); RMSNorm and LayerNorm take their statistics in fp32 (LayerNorm's
variance as E[x^2] - E[x]^2, as flax) and cast the result; the two
embeddings add in fp32 and then cast; the head multiplies bf16-rounded
operands with fp32 accumulation into fp32 logits; (S, z) stay fp32.

``features`` also returns the summed auxiliary loss of the MoE layers
(0 without them), which the training loss adds and the eval loss leaves out,
as the JAX package does with its ``"losses"`` collection.

``quant="int8"`` / ``"int4"`` builds the decode-only quantized model of the
JAX package's ``quant`` attribute (``orion_tpu_torch/quant.py``): every dense
layer ``Int8Dense`` (``"int8"``) or nibble-packed ``Int4Dense`` (``"int4"``,
whose decode rows run the hand-written ``q4_matmul`` kernel on the card),
and in both modes the embedding table ``Int8Embed``, serving the tied head
through ``attend`` (fp32 logits), an untied head as the int8
``lm_head_kernel_q`` [D, V] with its scales ``lm_head_kernel_s`` [V], and a
MoE layer's expert stacks int8. ``generate.quantize_for_decode`` fills one
from a full-precision model.

Not ported yet (it raises ``NotImplementedError`` naming ROADMAP.md's
item): meshes, and with them the expert-parallel MoE forms. The JAX
package's ``attn_block_q`` / ``attn_block_k`` size TPU tiles and are not
read.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.moe import MoEMLP
from orion_tpu_torch.ops.feature_maps import _orthogonal_gaussian, favor_phi, make_feature_map
from orion_tpu_torch.ops.linear_attention import (linear_attention, linear_attention_noncausal,
                                                  recurrent_step)
from orion_tpu_torch.ops.rotary import apply_rotary, apply_rotary_at, rotary_freqs
from orion_tpu_torch.ops.softmax_attention import (cached_attention, softmax_attention,
                                                   softmax_attention_xla)
from orion_tpu_torch.quant import Int4Dense, Int8Dense, Int8Embed, check_mode
from orion_tpu_torch.utils import rng as rngs
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
State = Dict[str, Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# flax lecun_normal: a normal truncated at two standard deviations, rescaled
# by this constant so the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# The row count of every product of a decode step (row 14's kernel takes at
# most 64 rows, so the quantized models keep it)
DECODE_ROWS = 64


def pad_rows(x: Tensor, rows: int) -> Tensor:
    """x [B, ...] with zero rows appended up to ``rows`` (x itself when it
    has as many already)."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros(rows - x.shape[0], *x.shape[1:])])


def decode_rows(x: Tensor) -> Tensor:
    """A decode step's hidden rows [B, D] padded to ``DECODE_ROWS``: the one
    place that fixes the row count of the step's products."""
    return pad_rows(x, DECODE_ROWS)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, {item})"
    )


# The aten products whose outputs remat_policy="dots" saves (the JAX
# package's ``checkpoint_dots``); everything else in a block is recomputed,
# the kernels' launches inside the autograd Functions included
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
                   torch.ops.aten._scaled_mm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for a ``remat_policy`` ("full": None,
    save the block's input only)."""
    if policy == "full":
        return None
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    raise ValueError(f"unknown remat_policy {policy!r}; expected 'full' or 'dots'")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for what no model of the package takes: an
    unknown layer type, norm or remat policy."""
    cfg.resolved_layer_types  # noqa: B018 -- raises on an unknown layer type
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {cfg.norm!r}; expected 'rmsnorm' or 'layernorm'")
    _remat_context(cfg.remat_policy)


class Dense(nn.Module):
    """Bias-free dense layer in the compute dtype: ``x @ W^T`` with
    ``weight`` [out, in] (the flax kernel [in, out], transposed)."""

    def __init__(self, d_in: int, d_out: int, cdt: torch.dtype, device=None):
        super().__init__()
        self.cdt = cdt
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.to(self.cdt), self.weight.to(self.cdt))


def _qdense_factory(quant: str, cdt: torch.dtype, backend: str):
    """The dense-layer constructor ``(d_in, d_out, device)`` of a quant mode:
    ``Dense`` for full precision, ``Int8Dense`` for ``"int8"``, ``Int4Dense``
    for ``"int4"`` (whose kernel gate reads the model's ``backend``)."""
    if quant == "int4":
        return lambda d_in, d_out, device: Int4Dense(d_in, d_out, cdt, backend, device)
    if quant == "int8":
        return lambda d_in, d_out, device: Int8Dense(d_in, d_out, cdt, device)
    return lambda d_in, d_out, device: Dense(d_in, d_out, cdt, device)


class Embed(nn.Module):
    """Lookup table ``weight`` [rows, D], fp32 (flax ``nn.Embed``)."""

    def __init__(self, rows: int, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, d, device=device))

    def forward(self, ids) -> Tensor:
        return self.weight[ids]


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: fp32 statistics, eps 1e-6, scale multiplied
    into the reciprocal root first, result cast to the compute dtype."""

    def __init__(self, d: int, cdt: torch.dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.cdt = cdt
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (xf * mul).to(self.cdt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics with the variance as
    E[x^2] - E[x]^2 (clamped at 0), eps 1e-6, ``weight`` (flax's scale)
    multiplied into the reciprocal root, then ``bias`` added; the result cast
    to the compute dtype. (``F.layer_norm`` takes the variance as E[(x -
    mean)^2], which differs in the last bits.)"""

    def __init__(self, d: int, cdt: torch.dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.cdt = cdt
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.cdt)


def make_norm(cfg: ModelConfig, device=None) -> nn.Module:
    """The norm ``cfg.norm`` names, over ``d_model``."""
    cls = LayerNorm if cfg.norm == "layernorm" else RMSNorm
    return cls(cfg.d_model, _dtype(cfg.dtype), device=device)


class Attention(nn.Module):
    """One attention layer of type ``"linear"``, ``"softmax"`` or ``"swa"``:
    causal (the LM), or bidirectional with a key padding mask
    (``causal=False``, the LRA classifier)."""

    def __init__(self, cfg: ModelConfig, layer_type: str = "linear", device=None,
                 quant: str = "", causal: bool = True):
        super().__init__()
        if layer_type not in ("linear", "softmax", "swa"):
            raise ValueError(f"unknown layer type {layer_type!r}")
        self.cfg = cfg
        self.layer_type = layer_type
        self.causal = causal
        h, dh = cfg.n_heads, cfg.resolved_head_dim
        dense = _qdense_factory(quant, _dtype(cfg.dtype), cfg.backend)
        self.wq = dense(cfg.d_model, h * dh, device)
        self.wk = dense(cfg.d_model, h * dh, device)
        self.wv = dense(cfg.d_model, h * dh, device)
        self.wo = dense(h * dh, cfg.d_model, device)
        if layer_type == "linear":
            if cfg.feature_map == "learnable":
                # full precision in every quant mode, as in the JAX package
                self.phi_proj = Dense(dh, dh, _dtype(cfg.dtype), device)
            elif cfg.feature_map == "favor":
                # fixed random features: a parameter of the tree that no
                # gradient reaches (the JAX package's stop_gradient)
                self.favor_proj = nn.Parameter(torch.empty(dh, dh, device=device),
                                               requires_grad=False)
            else:
                self._phi = make_feature_map(cfg.feature_map)
        else:
            # the rotary angle table: a buffer that is not saved, so the
            # state_dict (convert.py, checkpoints) holds parameters only
            self.register_buffer(
                "freqs", rotary_freqs(dh, cfg.max_seq_len, device=device), persistent=False
            )
            self.window = cfg.window if layer_type == "swa" else None

    def _heads(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """x [B, T, D] -> q, k, v [B, H, T, Dh]; x [B, D] -> [B, H, Dh]."""
        h, dh = self.cfg.n_heads, self.cfg.resolved_head_dim
        single = x.dim() == 2

        def split(y):
            y = y.reshape(*y.shape[:-1], h, dh)
            return y if single else y.transpose(-3, -2)

        return split(self.wq(x)), split(self.wk(x)), split(self.wv(x))

    def _phi_map(self, x: Tensor) -> Tensor:
        fm = self.cfg.feature_map
        if fm == "learnable":
            return F.elu(self.phi_proj(x)) + 1.0
        if fm == "favor":
            return favor_phi(x, self.favor_proj)
        return self._phi(x)

    def _merge(self, out: Tensor, single: bool) -> Tensor:
        if not single:
            out = out.transpose(-3, -2)  # [B, T, H, Dh]
        return self.wo(out.reshape(*out.shape[:-2], -1))

    def _softmax(self, q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """Softmax / sliding-window attention over rotated q, k: causal, or
        bidirectional with the key mask [B, T] (the plain form, as the JAX
        package takes it)."""
        return softmax_attention(q, k, v, causal=self.causal, window=self.window,
                                 mask=None if mask is None else mask[:, None, None, :],
                                 backend=self.cfg.backend)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """x [B, T, D] -> [B, T, D]. ``mask`` [B, T] (True = a real key)
        applies to a bidirectional layer only."""
        q, k, v = self._heads(x)
        if self.layer_type == "linear":
            qf, kf = self._phi_map(q), self._phi_map(k)
            if self.causal:
                out = linear_attention(qf, kf, v, backend=self.cfg.backend, chunk=self.cfg.chunk)
            else:
                out = linear_attention_noncausal(
                    qf, kf, v, mask=None if mask is None else mask[:, None, :])
        else:
            ang = self.freqs[: x.shape[-2]]
            out = self._softmax(apply_rotary(q, ang), apply_rotary(k, ang), v, mask)
        return self._merge(out, single=False)

    def prefill(
        self, x: Tensor, length: Optional[Union[int, Tensor]] = None
    ) -> Tuple[Tensor, State]:
        """Forward plus the decode state. ``length``: the real prompt length
        when ``x`` is right-padded. The state holds only the real rows:

        - linear: pad rows' phi(k) and v are zeroed before the kv-cumsum;
        - softmax: pad rows land at cache slots >= length, which decode
          never reads (step t writes slot t before it attends and masks the
          slots past t);
        - swa: the ring is built from the last ``window`` real positions.
        """
        q, k, v = self._heads(x)
        t = x.shape[-2]
        if self.layer_type != "linear":
            ang = self.freqs[:t]
            qr, kr = apply_rotary(q, ang), apply_rotary(k, ang)
            out = self._softmax(qr, kr, v)
            if self.layer_type == "softmax":
                pad = (0, 0, 0, self.cfg.max_seq_len - t)
                state = {"k": F.pad(kr, pad), "v": F.pad(v, pad)}
            elif length is None:
                state = _swa_cache_from_prefill(kr, v, t, self.window)
            else:
                state = _swa_cache_from_prefill_dynamic(kr, v, length, self.window)
            return self._merge(out, single=False), state
        qf, kf = self._phi_map(q), self._phi_map(k)
        if length is not None:
            real = (torch.arange(t, device=x.device) < length)[None, None, :, None]
            # where, not multiply: 0 * nan from a degenerate phi must not
            # poison the masked state
            kf = torch.where(real, kf, torch.zeros_like(kf))
            v = torch.where(real, v, torch.zeros_like(v))
        out, (s, z) = linear_attention(
            qf, kf, v, backend=self.cfg.backend, chunk=self.cfg.chunk,
            return_state=True,
        )
        return self._merge(out, single=False), {"s": s, "z": z}

    def decode_step(self, x: Tensor, state: State, t=None,
                    write: Optional[Tensor] = None) -> Tuple[Tensor, State]:
        """x [B, D], one token per row -> (out [B, D], the state advanced).
        ``t``: the absolute position, a scalar (the whole batch in lockstep)
        or one per sequence [B]; unused by linear layers. A softmax / swa
        layer writes its new key and value into ``state``'s own cache or
        ring in place (its tensors are the returned state's); a linear
        layer returns a new (S, z). ``write`` [B] bool: the rows whose step
        counts (None: all); any other row keeps its state bitwise (its cache
        slot is written back with the value it held, its S and z kept), so
        a free row or one mid-prefill can ride in the batch. ``x`` may hold
        more rows than the state (``decode_rows``' padding): the products
        run on all of them, the attention on the state's rows, and the
        output has x's rows."""
        q, k, v = self._heads(x)
        b, rows = next(iter(state.values())).shape[0], x.shape[0]
        if self.layer_type == "linear":
            out, (s, z) = recurrent_step(
                self._phi_map(q)[:b], self._phi_map(k)[:b], v[:b], (state["s"], state["z"])
            )
            if write is not None:
                s = torch.where(write[:, None, None, None], s, state["s"])
                z = torch.where(write[:, None, None], z, state["z"])
            return self._merge(pad_rows(out, rows), single=True), {"s": s, "z": z}
        q, k, v = q[:b], k[:b], v[:b]
        t = torch.as_tensor(t, device=x.device).long()
        if write is not None and t.dim() == 0:
            t = t.expand(b)
        per_seq = t.dim() == 1
        # per-sequence angles [B, 1, Dh/2] broadcast over the heads
        pos = t[:, None] if per_seq else t
        qr = apply_rotary_at(q, self.freqs, pos)
        kr = apply_rotary_at(k, self.freqs, pos)
        kc, vc = state["k"], state["v"]
        cap = kc.shape[-2]  # window W or max_seq_len
        slot = t % cap if self.layer_type == "swa" else t
        if per_seq:
            idx = torch.arange(b, device=x.device)
            knew, vnew = kr.to(kc.dtype), v.to(vc.dtype)
            if write is not None:
                keep = ~write[:, None, None]
                knew = torch.where(keep, kc[idx, :, slot], knew)
                vnew = torch.where(keep, vc[idx, :, slot], vnew)
            kc[idx, :, slot] = knew
            vc[idx, :, slot] = vnew
            valid = torch.arange(cap, device=x.device)[None, None, :] <= t[:, None, None]
        else:
            idx = slot.reshape(1)
            kc.index_copy_(2, idx, kr[:, :, None].to(kc.dtype))
            vc.index_copy_(2, idx, v[:, :, None].to(vc.dtype))
            # ring slots hold positions (t - W, t] once warm; before that the
            # slots past t are unwritten: either way exactly the slots <= t
            # are valid
            valid = (torch.arange(cap, device=x.device) <= t)[None, None, :]
        out = cached_attention(qr, kc, vc, valid)
        return self._merge(pad_rows(out, rows), single=True), {"k": kc, "v": vc}

    def prefill_extend(self, x: Tensor, state: State, offset, length) -> Tuple[Tensor, State]:
        """One chunked-prefill piece (the JAX package's ``prefill_extend``):
        ``x`` [B, P, D] holds rows [offset, offset + P) of the prompt's
        hidden stream, right-padded, ``length`` of them real; ``state`` is
        what the pieces before it left. -> (the piece rows' attention out,
        the state advanced):

        - linear: row 1's forward seeded with (S, z) (the kernel on the
          card), pad rows' phi(k) and v zeroed by ``where``;
        - softmax: the piece's real rows written into the cache in place
          (``_window_write``), its queries over the whole cache under the
          offset causal mask;
        - swa: the piece over the [W + P] context of the ring's positions
          before it plus its own rows, then the ring rebuilt in place
          (``_swa_extend``).

        Positions are clipped, never sliced: a piece computed for a row
        that is not prefilling, and then discarded, stays in range. The
        softmax and swa pieces are plain torch, as the JAX package computes
        them with its XLA form outside any kernel."""
        q, k, v = self._heads(x)
        p = x.shape[-2]
        real = (torch.arange(p, device=x.device) < length)[None, None, :, None]
        if self.layer_type == "linear":
            qf, kf = self._phi_map(q), self._phi_map(k)
            # where, not multiply: 0 * nan from a degenerate phi must not
            # poison the state
            kf = torch.where(real, kf, torch.zeros_like(kf))
            vm = torch.where(real, v, torch.zeros_like(v))
            out, (s, z) = linear_attention(
                qf, kf, vm, backend=self.cfg.backend, chunk=self.cfg.chunk,
                initial_state=(state["s"], state["z"]), return_state=True,
            )
            return self._merge(out, single=False), {"s": s, "z": z}
        pos = (offset + torch.arange(p, device=x.device)).clamp(0, self.freqs.shape[0] - 1)
        ang = self.freqs[pos]
        qr, kr = apply_rotary(q, ang), apply_rotary(k, ang)
        if self.layer_type == "swa":
            out, new_state = _swa_extend(qr, kr, v, state, offset, length, self.window)
        else:
            kc = _window_write(state["k"], kr, offset, real)
            vc = _window_write(state["v"], v, offset, real)
            row = torch.arange(p, device=x.device)[:, None] + offset
            col = torch.arange(kc.shape[-2], device=x.device)[None, :]
            out = softmax_attention_xla(qr, kc, vc, causal=False, mask=row >= col)
            new_state = {"k": kc, "v": vc}
        return self._merge(out, single=False), new_state


def _window_write(cache: Tensor, rows: Tensor, offset: Tensor, real: Tensor) -> Tensor:
    """Write a piece's rows [B, H, P, Dh] into the KV cache at ``offset``, in
    place, and return the cache. Pad rows (``real`` False) write back what
    the cache held, at positions clipped into range: a partial last piece
    never clobbers a slot, and clipped positions that collide all write the
    same value."""
    p = rows.shape[-2]
    pos = (offset + torch.arange(p, device=cache.device)).clamp(0, cache.shape[-2] - 1)
    cache[:, :, pos] = torch.where(real, rows.to(cache.dtype), cache[:, :, pos])
    return cache


def _swa_extend(qr: Tensor, kr: Tensor, v: Tensor, state: State, offset: Tensor,
                length: Tensor, window: int) -> Tuple[Tensor, State]:
    """A sliding-window piece's attention and the ring's advance (see
    ``Attention.prefill_extend``): the context is the W positions before the
    piece, gathered from the ring in position order, and the piece's own
    rows; negative positions are masked, never read. The ring is then the
    last W positions before offset + length, each row from the piece where
    it covers it and from the ring where not, written in place (W
    consecutive positions fill W distinct slots)."""
    p, w, dev = qr.shape[-2], window, qr.device
    kc, vc = state["k"], state["v"]
    pos_prev = offset - w + torch.arange(w, device=dev)  # may be < 0 (masked)
    slots_prev = pos_prev % w
    kctx = torch.cat([kc[:, :, slots_prev], kr.to(kc.dtype)], dim=2)
    vctx = torch.cat([vc[:, :, slots_prev], v.to(vc.dtype)], dim=2)
    row = torch.arange(p, device=dev)[:, None] + offset
    colpos = torch.cat([pos_prev, offset + torch.arange(p, device=dev)])[None, :]
    m = (row >= colpos) & (row - colpos < w) & (colpos >= 0)
    out = softmax_attention_xla(qr, kctx, vctx, causal=False, mask=m)
    pos_new = offset + length - w + torch.arange(w, device=dev)
    slots_new = pos_new % w
    take = (pos_new - offset).clamp(0, p - 1)
    fresh = (pos_new >= offset)[None, None, :, None]
    kc[:, :, slots_new] = torch.where(fresh, kr[:, :, take].to(kc.dtype), kc[:, :, slots_new])
    vc[:, :, slots_new] = torch.where(fresh, v[:, :, take].to(vc.dtype), vc[:, :, slots_new])
    return out, {"k": kc, "v": vc}


def _swa_cache_from_prefill(kr: Tensor, v: Tensor, t: int, window: int) -> State:
    """The ring cache from the last ``window`` prompt positions, each at slot
    (position % window); unwritten slots stay zero (decode's slot <= t rule
    masks them)."""
    b, h, _, dh = kr.shape
    start = max(0, t - window)
    slots = torch.arange(start, t, device=kr.device) % window
    kc = kr.new_zeros(b, h, window, dh)
    vc = v.new_zeros(b, h, window, v.shape[-1])
    kc[:, :, slots] = kr[:, :, start:t]
    vc[:, :, slots] = v[:, :, start:t]
    return {"k": kc, "v": vc}


def _swa_cache_from_prefill_dynamic(kr: Tensor, v: Tensor, length, window: int) -> State:
    """``_swa_cache_from_prefill`` for a right-padded prompt of real length
    ``length`` (an int or a 0-d tensor): the ring holds the ``window``
    positions before ``length``. Positions < 0 (a prompt shorter than the
    window) write a clipped row into their slot; decode never reads it
    before the step that overwrites it, so the readable entries equal those
    ``_swa_cache_from_prefill`` makes from the unpadded prompt."""
    b, h, t_pad, dh = kr.shape
    positions = torch.as_tensor(length, device=kr.device) - window + torch.arange(
        window, device=kr.device)
    slots = positions % window
    safe = positions.clamp(0, t_pad - 1)
    kc = kr.new_zeros(b, h, window, dh)
    vc = v.new_zeros(b, h, window, v.shape[-1])
    kc[:, :, slots] = kr[:, :, safe]
    vc[:, :, slots] = v[:, :, safe]
    return {"k": kc, "v": vc}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, quant: str = ""):
        super().__init__()
        self.cfg = cfg
        dense = _qdense_factory(quant, _dtype(cfg.dtype), cfg.backend)
        d, h = cfg.d_model, cfg.resolved_mlp_hidden
        if cfg.mlp == "swiglu":
            self.gate = dense(d, h, device)
        elif cfg.mlp != "gelu":
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        self.up = dense(d, h, device)
        self.down = dense(h, d, device)

    def forward(self, x: Tensor) -> Tensor:
        if self.cfg.mlp == "swiglu":
            y = F.silu(self.gate(x)) * self.up(x)
        else:
            y = F.gelu(self.up(x), approximate="tanh")  # jax.nn.gelu's default
        return self.down(y)


def _dropout(x: Tensor, rate: float, gen: torch.Generator) -> Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate); a select, so a dropped inf is 0."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    """Pre-norm residual block: x + drop(attn(norm(x))); x + drop(mlp(norm(x))),
    the MLP a ``MoEMLP`` when ``use_moe``; ``causal=False``: bidirectional
    attention over the keys a mask keeps (the LRA classifier).

    Dropout (``cfg.dropout``) applies when ``dropout_seed`` is given: both
    masks come from one generator seeded with it, so a recomputation under
    ``checkpoint`` redraws the same masks."""

    def __init__(self, cfg: ModelConfig, layer_type: str = "linear", device=None,
                 use_moe: bool = False, quant: str = "", causal: bool = True):
        super().__init__()
        cdt = _dtype(cfg.dtype)
        self.rate = cfg.dropout
        self.norm1 = make_norm(cfg, device)
        self.attn = Attention(cfg, layer_type, device, quant, causal)
        self.norm2 = make_norm(cfg, device)
        self.mlp = (MoEMLP(cfg, cdt, device, quant=quant) if use_moe
                    else MLP(cfg, device, quant))

    def _mlp_aux(self, x: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        if isinstance(self.mlp, MoEMLP):
            return self.mlp(x, with_aux=True)
        return self.mlp(x), None

    def forward(
        self, x: Tensor, dropout_seed: Optional[int] = None, mask: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Optional[Tensor]]:
        """-> (output, the MoE layer's auxiliary loss or None). The loss
        leaves as an output, so ``checkpoint`` carries it and a
        recomputation cannot add it twice. ``mask`` [B, T]: the keys a
        bidirectional block attends to."""
        if dropout_seed is None or self.rate == 0.0:
            x = x + self.attn(self.norm1(x), mask)
            h, aux = self._mlp_aux(self.norm2(x))
            return x + h, aux
        gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        x = x + _dropout(self.attn(self.norm1(x), mask), self.rate, gen)
        h, aux = self._mlp_aux(self.norm2(x))
        return x + _dropout(h, self.rate, gen), aux

    def prefill(self, x: Tensor, length=None) -> Tuple[Tensor, State]:
        h, state = self.attn.prefill(self.norm1(x), length)
        x = x + h
        return x + self.mlp(self.norm2(x)), state

    def prefill_extend(self, x: Tensor, state: State, offset, length) -> Tuple[Tensor, State]:
        h, state = self.attn.prefill_extend(self.norm1(x), state, offset, length)
        x = x + h
        return x + self.mlp(self.norm2(x)), state

    def decode_step(self, x: Tensor, state: State, t, write=None) -> Tuple[Tensor, State]:
        h, state = self.attn.decode_step(self.norm1(x), state, t, write)
        x = x + h
        return x + self.mlp(self.norm2(x)), state


class TransformerLM(nn.Module):
    """Decoder LM over token ids; see the module docstring.

    Parameters are fp32 (``param_dtype``) and drawn from ``generator`` (a
    fresh generator seeded 0 on ``device`` by default) with the flax model's
    default initializers: lecun_normal for dense kernels and the untied head
    ``lm_head_kernel`` [D, V], normal(1/sqrt(D)) for the embedding tables,
    ones for norm scales, zeros for LayerNorm biases, an orthogonal-Gaussian
    ``favor_proj``. ``device`` defaults to
    ``"cuda"`` and raises if CUDA is absent. ``quant`` (``""``, ``"int8"``,
    ``"int4"``): the quantized decode model (see the module docstring); its
    int8 / int4 tensors start at zero, with unit scales, until
    ``generate.quantize_for_decode`` or ``convert.load_jax_params`` fills
    them. ``mesh`` is the JAX model's, not ported yet: anything but None
    raises.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
        mesh=None,
        quant: str = "",
    ):
        super().__init__()
        if mesh is not None:
            raise _not_ported("a device mesh", "item 12 (parallelism)")
        self.quant = check_mode(quant)
        check_supported(cfg)
        if cfg.param_dtype != "float32":
            raise ValueError(f"param_dtype must be float32, got {cfg.param_dtype!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.cdt = _dtype(cfg.dtype)
        # an int8 table in both quant modes: the head's logits set greedy fidelity
        self.embed = (Int8Embed(cfg.vocab_size, cfg.d_model, dev) if quant
                      else Embed(cfg.vocab_size, cfg.d_model, dev))
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, lt, dev, use_moe=cfg.moe_at(i), quant=quant)
            for i, lt in enumerate(cfg.resolved_layer_types)
        )
        self.final_norm = make_norm(cfg, dev)
        if not cfg.tie_embeddings:
            if quant:  # int8 in both quant modes, like the tied table
                self.register_buffer("lm_head_kernel_q", torch.zeros(
                    cfg.d_model, cfg.vocab_size, dtype=torch.int8, device=dev))
                self.register_buffer("lm_head_kernel_s", torch.ones(cfg.vocab_size, device=dev))
            else:
                self.lm_head_kernel = nn.Parameter(
                    torch.empty(cfg.d_model, cfg.vocab_size, device=dev))
        self._head_cache = None
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (flax default inits; an
        expert stack [E, in, out] as the JAX package's ``_expert_init``:
        lecun_normal over (in, out) with the expert as the batch axis). A
        quantized model's int8 / int4 buffers are not drawn."""
        std = 1.0 / math.sqrt(self.cfg.d_model)
        for table in (self.embed, self.pos_embed):
            if isinstance(table, Embed):
                table.weight.normal_(0.0, std, generator=generator)
        init_blocks(self, generator)
        if hasattr(self, "lm_head_kernel"):
            lecun_normal(self.lm_head_kernel, self.cfg.d_model, generator)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.weight.device

    def _embed(self, tokens: Tensor, positions) -> Tensor:
        return (self.embed(tokens) + self.pos_embed(positions)).to(self.cdt)

    def _head_operand(self) -> Tensor:
        """The head's weight (the tied table [V, D] or the untied
        ``lm_head_kernel`` [D, V]) rounded to the compute dtype, held in fp32
        so the head runs bf16 operands with fp32 accumulation. Cached for
        inference; a change to the weight (load, in-place update, move)
        rebuilds it. When a gradient is wanted it is computed afresh, so the
        gradient reaches the weight."""
        w, _ = self.head_weight()
        if self.cdt == torch.float32:
            return w.float()
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(self.cdt).float()
        if w.is_inference():  # made under inference_mode: no version counter
            return w.to(self.cdt).float()
        key = (w.data_ptr(), w._version)
        if self._head_cache is None or self._head_cache[0] != key:
            self._head_cache = (key, w.detach().to(self.cdt).float())
        return self._head_cache[1]

    def _head_matmul(self, x: Tensor) -> Tensor:
        """fp32 logits from compute-dtype operands (a plain bf16 matmul would
        round the logits to bf16 and flip greedy tokens); a quantized model's
        through the int8 table's ``attend``, or the int8 untied head with its
        scales applied after the product."""
        if self.quant:
            if self.cfg.tie_embeddings:
                return self.embed.attend(x, self.cdt)
            return (x.to(self.cdt).float() @ self.lm_head_kernel_q.float()) * self.lm_head_kernel_s
        w = self._head_operand()
        return x.to(self.cdt).float() @ (w.t() if self.cfg.tie_embeddings else w)

    def _head(self, x: Tensor) -> Tensor:
        return self._head_matmul(self.final_norm(x))

    def features(
        self, tokens: Tensor, deterministic: bool = True, dropout_seed: Optional[int] = None
    ) -> Tuple[Tensor, Tensor]:
        """tokens [B, T] -> (final-normed hidden states [B, T, D], the head's
        input; the MoE layers' summed auxiliary loss, an fp32 scalar, 0
        without them). ``deterministic=False`` applies dropout (``cfg.dropout``),
        block i drawing from ``rng.fold(dropout_seed, i)``. With grad enabled
        and ``cfg.remat``, blocks ``i < n_layers - remat_skip`` are
        recomputed in the backward (the JAX model's ``nn.remat``):
        ``remat_policy="full"`` keeps only their input, ``"dots"`` also the
        outputs of their matrix products."""
        x = self._embed(tokens, torch.arange(tokens.shape[-1], device=tokens.device))
        x, aux_total = run_blocks(self.blocks, self.cfg, x, deterministic, dropout_seed)
        return self.final_norm(x), aux_total

    def head_weight(self) -> Tuple[Tensor, bool]:
        """(head weight, w_is_vd) for ``ops/fused_ce.py``: the tied
        embedding table [V, D] (w_is_vd True) or the untied
        ``lm_head_kernel`` [D, V] (False). A quantized model serves only."""
        if self.quant:
            raise ValueError(f"a quantized model (quant={self.quant!r}) is not trained")
        if self.cfg.tie_embeddings:
            return self.embed.weight, True
        return self.lm_head_kernel, False

    def forward(
        self, tokens: Tensor, deterministic: bool = True, dropout_seed: Optional[int] = None,
        return_aux: bool = False,
    ):
        """tokens [B, T] -> logits [B, T, V] (fp32); with ``return_aux`` also
        the MoE layers' auxiliary loss (``features``)."""
        feats, aux = self.features(tokens, deterministic, dropout_seed)
        logits = self._head_matmul(feats)
        return (logits, aux) if return_aux else logits

    def _prefill_trunk(self, tokens: Tensor, length=None) -> Tuple[Tensor, List[State]]:
        x = self._embed(tokens, torch.arange(tokens.shape[-1], device=tokens.device))
        states = []
        for blk in self.blocks:
            x, st = blk.prefill(x, length)
            states.append(st)
        return x, states

    def prefill(self, tokens: Tensor, length=None) -> Tuple[Tensor, List[State]]:
        """tokens [B, T] -> (logits [B, T, V], per-layer decode states)."""
        x, states = self._prefill_trunk(tokens, length)
        return self._head(x), states

    def prefill_last(self, tokens: Tensor, length=None) -> Tuple[Tensor, List[State]]:
        """prefill with the head on the last (real) position only ->
        (logits [B, V], states)."""
        x, states = self._prefill_trunk(tokens, length)
        last = tokens.shape[-1] if length is None else length
        return self._head(x[:, last - 1]), states

    def decode_step(
        self, token: Tensor, states: List[State], t, write: Optional[Tensor] = None
    ) -> Tuple[Tensor, List[State]]:
        """token [B] at position ``t`` -> (logits [B, V], the states
        advanced: the caches and rings in place, see ``Attention.decode_step``;
        ``write`` [B] bool masks the rows whose state may change). The
        hidden rows are padded to ``DECODE_ROWS`` (``decode_rows``), so a
        row's logits do not depend on the batch it sits in."""
        x = decode_rows(self._embed(token, t))
        new_states = []
        for blk, st in zip(self.blocks, states):
            x, st = blk.decode_step(x, st, t, write)
            new_states.append(st)
        return self._head(x)[:token.shape[0]], new_states

    def prefill_extend_step(
        self, tokens: Tensor, states: List[State], offset, length
    ) -> Tuple[Tensor, List[State]]:
        """One chunked-prefill piece at the model level (the JAX package's
        ``prefill_extend_step``): ``tokens`` [B, P] are prompt rows [offset,
        offset + P), right-padded, ``length`` of them real (ints or 0-d
        tensors); ``states`` what the pieces before left, advanced as
        ``Attention.prefill_extend`` says (caches and rings in place). ->
        (the logits of the last real row [B, V], the states). After the last
        piece they are what ``prefill_last`` hands the first sample.
        Positions are clipped, not sliced."""
        dev = tokens.device
        p = tokens.shape[-1]
        offset = torch.as_tensor(offset, device=dev).long()
        length = torch.as_tensor(length, device=dev).long()
        pos = (offset + torch.arange(p, device=dev)).clamp(0, self.cfg.max_seq_len - 1)
        x = self._embed(tokens, pos)
        new_states = []
        for blk, st in zip(self.blocks, states):
            x, st = blk.prefill_extend(x, st, offset, length)
            new_states.append(st)
        last = x.index_select(1, (length - 1).clamp(min=0).reshape(1))[:, 0]
        return self._head(last), new_states


def lecun_normal(w: Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun_normal in place: a normal truncated at two standard
    deviations, of variance 1 / fan_in."""
    s = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


@torch.no_grad()
def init_blocks(root: nn.Module, generator: torch.Generator) -> None:
    """Draw the parameters of ``root``'s dense layers, MoE layers, norms and
    FAVOR+ projections from ``generator``, in module order (flax's default
    initializers; an expert stack [E, in, out] as the JAX package's
    ``_expert_init``: lecun_normal over (in, out) with the expert as the
    batch axis)."""
    for m in root.modules():
        if isinstance(m, Dense):
            lecun_normal(m.weight, m.weight.shape[1], generator)
        elif isinstance(m, MoEMLP):  # the router [E, d]; the stacks [E, in, out]
            for w in m.parameters():
                lecun_normal(w, w.shape[-2] if w.dim() == 3 else w.shape[1], generator)
        elif isinstance(m, (RMSNorm, LayerNorm)):
            m.weight.fill_(1.0)
            if isinstance(m, LayerNorm):
                m.bias.zero_()
        elif isinstance(m, Attention) and hasattr(m, "favor_proj"):
            w = m.favor_proj
            w.copy_(_orthogonal_gaussian(w.shape[0], w.shape[1], generator, w.device))


def run_blocks(blocks, cfg: ModelConfig, x: Tensor, deterministic: bool = True,
               dropout_seed: Optional[int] = None, mask: Optional[Tensor] = None,
               ) -> Tuple[Tensor, Tensor]:
    """x through ``blocks`` -> (x, the MoE layers' summed auxiliary loss, an
    fp32 scalar). Dropout, block i drawing from ``rng.fold(dropout_seed,
    i)``, and rematerialization (``cfg.remat`` / ``remat_skip`` /
    ``remat_policy``) as ``TransformerLM.features`` describes."""
    use_dropout = not deterministic and cfg.dropout > 0.0
    if use_dropout and dropout_seed is None:
        raise ValueError("deterministic=False needs a dropout_seed")
    first_remat = cfg.n_layers - max(0, cfg.remat_skip) if cfg.remat else 0
    context_fn = _remat_context(cfg.remat_policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    aux_total = torch.zeros((), device=x.device)
    for i, blk in enumerate(blocks):
        seed = rngs.fold(dropout_seed, i) if use_dropout else None
        if i < first_remat and torch.is_grad_enabled():
            # the masks come from ``seed``, not the global RNG, so there
            # is no RNG state to preserve for the recomputation
            x, aux = checkpoint(blk, x, seed, mask, use_reentrant=False,
                                preserve_rng_state=False, **kwargs)
        else:
            x, aux = blk(x, seed, mask)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def init_decode_state(
    cfg: ModelConfig, batch_size: int, device=None
) -> List[State]:
    """Zero per-layer decode state, prefill's structure: fp32 (S, z) for a
    linear layer; KV caches [B, H, cap, Dh] in the compute dtype for the
    others, of capacity ``window`` (swa) or ``max_seq_len`` (softmax)."""
    check_supported(cfg)
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    dev = resolve_device(device)
    states: List[State] = []
    for lt in cfg.resolved_layer_types:
        if lt == "linear":
            states.append({
                "s": torch.zeros(batch_size, h, dh, dh, dtype=torch.float32, device=dev),
                "z": torch.zeros(batch_size, h, dh, dtype=torch.float32, device=dev),
            })
        else:
            cap = cfg.window if lt == "swa" else cfg.max_seq_len
            shape = (batch_size, h, cap, dh)
            states.append({
                "k": torch.zeros(shape, dtype=_dtype(cfg.dtype), device=dev),
                "v": torch.zeros(shape, dtype=_dtype(cfg.dtype), device=dev),
            })
    return states


def snapshot_decode_state(states: List[State]) -> List[State]:
    """A copy of every layer's decode state: the rewind target of the
    serving ladder. In the JAX package a snapshot is free (arrays are
    immutable); here the caches are written in place, so a snapshot that
    shared them would move with the walk. (A copy made under
    ``torch.inference_mode`` is an inference tensor; outside it, a normal
    one, as ``clone`` makes.)"""
    return [{k: v.clone() for k, v in st.items()} for st in states]


def _floating(states: List[State]):
    return [x for st in states for x in st.values() if x.is_floating_point()]


def decode_state_finite(states: List[State]) -> Tensor:
    """Whether every floating leaf of the decode state is finite: a 0-d bool
    on the state's device (the caller chooses where to read it)."""
    leaves = _floating(states)
    acc = torch.ones((), dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        acc = acc & torch.isfinite(x).all()
    return acc


def decode_state_finite_per_slot(states: List[State]) -> Tensor:
    """The per-row probe: [B] bool, row b True where every floating leaf's
    row b is finite (one poisoned slot walks its own ladder)."""
    leaves = _floating(states)
    acc = torch.ones(leaves[0].shape[0], dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        acc = acc & torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)
    return acc


@torch.inference_mode()
def insert_decode_slot(states: List[State], slot_states: List[State], i: int) -> List[State]:
    """Write one sequence's decode state (batch 1, a solo prefill's) into row
    ``i`` of the batched state, in place; returns ``states``. Everything of
    the slot's previous occupant is overwritten. Runs under
    ``torch.inference_mode``, as the serving programs, whose states are
    inference tensors."""
    for full, one in zip(states, slot_states):
        for key, x in full.items():
            x[i].copy_(one[key][0])
    return states


def extract_decode_slot(states: List[State], i: int) -> List[State]:
    """Row ``i`` of the batched state as a batch-1 state of its own (a copy):
    the inverse of ``insert_decode_slot``."""
    return [{k: v[i:i + 1].clone() for k, v in st.items()} for st in states]


__all__ = [
    "TransformerLM", "Attention", "Block", "MLP", "Dense", "Embed", "RMSNorm", "LayerNorm",
    "make_norm", "init_blocks", "run_blocks", "lecun_normal", "init_decode_state",
    "check_supported", "snapshot_decode_state", "decode_state_finite",
    "decode_state_finite_per_slot", "insert_decode_slot", "extract_decode_slot",
    "DECODE_ROWS", "decode_rows", "pad_rows",
]
