"""`python -m orion_tpu_torch.generate` -- recurrent O(1)-state decode.

The port's counterpart of ``orion_tpu/generate.py``:

1. **prefill** -- ``TransformerLM.prefill_last`` over the prompt: the
   parallel forward (each layer's attention through its forward CUDA kernel
   on the card) returning the last position's logits and each layer's
   decode state: (S, z) for a linear layer, a KV cache for a softmax layer,
   a ring of the last ``window`` keys and values for a swa layer;
2. **decode** -- a Python loop of ``decode_step``, one token at a time, with
   O(1) state per linear layer and one query over the cache per softmax /
   swa layer;
3. **sampling** -- greedy / temperature / top-k / top-p, each row drawn
   with its own counter key (``sample_rows``): request seed, row, then the
   emitted token's index, so a row's tokens do not depend on the batch it
   sits in. The port's counter hash and JAX's threefry draw different
   numbers, so sampled tokens match the JAX package's only in distribution;
   greedy tokens match exactly.

The serving walk's programs (the JAX package's ``prefill_carry``,
``decode_chunk``, ``generate_chunked``, ``decode_batched_chunk`` and
``decode_batched_prefill_chunk``) are here too: plain Python loops over
``decode_step`` and ``prefill_extend_step`` that advance the decode state in
place, with no host read-back.

A capacity-dispatch MoE model is served with its capacity factor raised to
E / k for the call (the JAX package's no-drop serving rule): decode never
drops a token, so the prompt's prefill must not either. The dropless form
has no capacity to raise.

Quantized serving (``quant="int8"`` / ``"int4"``, CLI ``--quant``):
``quantize_for_decode`` builds the int8 (or int4-packed) model from a
full-precision one (``orion_tpu_torch/quant.py``); in int4 every decode
step's dense products run the hand-written ``q4_matmul`` kernel on the card.

Weights: ``--ckpt-dir`` loads the params of a checkpoint that
``orion_tpu_torch.train`` wrote, or that ``export_jax_checkpoint.py`` made
from one of the JAX package's (``load_params``, from
``training/checkpoint.py``: memory-mapped, manifest-verified, retried, with
a fallback to the newest intact step unless a step is pinned), and
``adapt_config_to_params`` fits the named config to the stored tables.
Without a checkpoint the weights come from a seeded init.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from orion_tpu_torch.models.configs import ModelConfig, get_config
from orion_tpu_torch.models.moe import MoEMLP
from orion_tpu_torch.models.transformer import Dense, TransformerLM
from orion_tpu_torch.quant import MODES, check_mode, quantize_params_for_decode
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.training.checkpoint import load_params
from orion_tpu_torch.utils import rng as rngs
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1.0 = off
    eos_token: int = -1  # >= 0: stop sequences at EOS (pad with pad_token)
    pad_token: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _filtered_logits(logits: Tensor, cfg: SampleConfig) -> Tensor:
    """fp32 logits over the temperature, with what top-k / top-p filter out
    at -inf; every op is row-wise."""
    logits = logits.float() / cfg.temperature
    # top_k >= V means "no filtering", not an out-of-range index
    k = min(cfg.top_k, logits.shape[-1]) if cfg.top_k > 0 else 0
    if k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix with cumulative prob >= top_p; the argmax
        # always survives, so top_p <= 0 cannot mask every candidate
        keep = cum - probs < cfg.top_p
        keep[:, 0] = True
        cutoff = torch.where(
            keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _gumbel_argmax(logits: Tensor, u: Tensor, cfg: SampleConfig) -> Tensor:
    """The Gumbel-max draw over the filtered logits, uniforms ``u`` in (0, 1)
    of the logits' shape: a sample of softmax(filtered logits)."""
    return torch.argmax(_filtered_logits(logits, cfg) - torch.log(-torch.log(u)), dim=-1)


def sample_logits(
    logits: Tensor, generator: Optional[torch.Generator], cfg: SampleConfig
) -> Tensor:
    """logits [B, V] -> token ids [B] (int64), the noise of the whole batch
    drawn from one ``torch.Generator``. The programs below draw with
    ``sample_rows``."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return _gumbel_argmax(logits, u.clamp_min(2.0**-25), cfg)


def sample_rows(logits: Tensor, keys: Tensor, cfg: SampleConfig) -> Tensor:
    """logits [S, V] and counter keys [S, 2] (``utils/rng.py``) -> token ids
    [S] (int64): row b depends on ``logits[b]`` and ``keys[b]`` alone, so a
    request draws the same tokens in any batch (the JAX package's
    ``_sample_rows``). Greedy rows are the argmax; sampled rows the
    Gumbel-max draw over the filtered logits, its noise the counter hash of
    (key, vocabulary index) as a uniform in (0, 1), all on the logits'
    device."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    bits = rngs.counter_bits(keys, logits.shape[-1])
    return _gumbel_argmax(logits, ((bits >> 8).float() + 0.5) * 2.0**-24, cfg)


def request_keys(seed: int, rows: int, device=None) -> Tensor:
    """The counter keys [rows, 2] of a request's rows: row b of a request of
    seed ``seed`` folds ``b`` into the seed's key. A one-row request of seed
    s and row 0 of any request of seed s draw alike; the token a row emits
    at index i is drawn with ``fold_keys(key, i)`` (index 0: the prefill's
    token)."""
    key = torch.tensor(rngs.key_words(rngs.root_key(int(seed))), dtype=torch.int64,
                       device=device)
    return rngs.fold_keys(key, torch.arange(rows, device=device))


def _seed(generator: Union[None, int, torch.Generator]) -> int:
    """A request's seed: an int as it is, a ``torch.Generator``'s initial
    seed, 0 for None."""
    if isinstance(generator, torch.Generator):
        return generator.initial_seed()
    return 0 if generator is None else int(generator)


@torch.no_grad()
def cast_params_for_inference(model: TransformerLM) -> TransformerLM:
    """Round every dense weight and expert stack to the compute dtype once,
    in place (bf16 on the large configs). flax's ``Dense(dtype=bf16)`` and
    the MoE layer's ``w.astype(dt)`` round the fp32 weight at every call, so
    this is bitwise the same and halves the weights' bytes on the card.
    Embedding tables, norm scales and MoE routers stay fp32: the lookups,
    the norm and the router read them in fp32. A quantized model is left
    alone: its scales stay fp32, the exact per-channel dequantization."""
    if model.quant:
        return model
    for m in model.modules():
        if isinstance(m, Dense) and m.weight.dtype != m.cdt:
            m.weight = torch.nn.Parameter(m.weight.to(m.cdt), requires_grad=False)
        elif isinstance(m, MoEMLP):
            for name, w in list(m.named_parameters()):
                if name != "router" and w.dtype != m.cdt:
                    setattr(m, name, torch.nn.Parameter(w.to(m.cdt), requires_grad=False))
    return model


@torch.no_grad()
def quantize_for_decode(model: TransformerLM, mode: str = "int8") -> TransformerLM:
    """A full-precision model -> its quantized counterpart on the same
    device: every dense weight int8 (or nibble-packed int4 with
    ``mode="int4"``) with per-out-channel scales, the embedding table and
    the expert stacks int8 in both modes. Quantize once, serve many."""
    if check_mode(mode) == "" or model.quant:
        raise ValueError(f"quantize_for_decode takes a full-precision model and a mode "
                         f"'int8' / 'int4'; got quant={model.quant!r}, mode={mode!r}")
    qmodel = TransformerLM(model.cfg, device=model.device, quant=mode)
    qmodel.load_state_dict(quantize_params_for_decode(qmodel, model.state_dict()), strict=True)
    return qmodel


@contextlib.contextmanager
def no_drop_capacity(model: TransformerLM):
    """Raise each capacity-dispatch MoE layer's capacity factor to E / k
    (capacity = group size: the parallel forward then keeps every token)
    while the block runs, and restore it after."""
    cfg = model.cfg
    serving = float(cfg.n_experts) / max(cfg.moe_top_k, 1)
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    if cfg.moe_dropless or cfg.moe_capacity_factor >= serving:
        layers = []
    saved = [m.capacity_factor for m in layers]
    for m in layers:
        m.capacity_factor = serving
    try:
        yield model
    finally:
        for m, cf in zip(layers, saved):
            m.capacity_factor = cf


@torch.inference_mode()
def generate(
    model: TransformerLM,
    prompt: Tensor,
    max_new_tokens: int,
    sample: Optional[SampleConfig] = None,
    generator: Union[None, int, torch.Generator] = None,
    quant: str = "",
) -> Tensor:
    """prompt [B, T0] (or [T0]) -> generated tokens [B, max_new_tokens].

    ``generator``: the request's seed, an int or a ``torch.Generator``
    (its initial seed); None is seed 0. Row b samples with
    ``request_keys(seed, B)[b]``, so a one-row ``generate`` at seed s draws
    what a serving slot of a seed-s request draws.

    ``quant="int8"`` / ``"int4"``: quantize a full-precision model for this
    call (to serve many calls, ``quantize_for_decode`` once and pass its
    model); a model already quantized must carry the same mode, or this
    raises.

    The emitted sequence is the JAX package's ``_generate_jit``: the token
    sampled from the prefill, then one token per decode step; with an
    ``eos_token`` a row emits its EOS and pads after it. The JAX scan also
    runs one last decode step whose sample it drops; this loop skips it.
    A capacity-dispatch MoE model runs under ``no_drop_capacity``.
    """
    if check_mode(quant):
        if not model.quant:
            model = quantize_for_decode(model, quant)
        elif model.quant != quant:
            # serving another precision than the one asked for would corrupt
            # every latency and quality measurement
            raise ValueError(f"the model is already quantized as {model.quant!r}; "
                             f"requested quant={quant!r}")
    with no_drop_capacity(model):
        return _generate(model, prompt, max_new_tokens, sample, generator)


def generate_unconditional(model: TransformerLM, batch_size: int, max_new_tokens: int,
                           bos_token: int = 0, **kw) -> Tensor:
    """``generate`` from a one-token prompt of ``bos_token`` per row."""
    prompt = torch.full((batch_size, 1), bos_token, dtype=torch.long, device=model.device)
    return generate(model, prompt, max_new_tokens, **kw)


def adapt_config_to_params(cfg: ModelConfig, params) -> ModelConfig:
    """Fit a named config to a checkpoint's stored tables, as the JAX
    package's ``adapt_config_to_params``: ``max_seq_len`` from the rows of
    ``pos_embed.weight`` (the train CLI raises it when ``--seq-len`` reaches
    it) and ``vocab_size`` from those of ``embed.weight``. A layout without
    these keys passes through as it is."""
    try:
        pos_rows = params["pos_embed.weight"].shape[0]
        vocab = params["embed.weight"].shape[0]
    except (KeyError, TypeError):
        return cfg
    if pos_rows != cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=pos_rows)
    if vocab != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg


def load_model(cfg: ModelConfig, ckpt_dir: str, device, step: Optional[int] = None,
               attempts: int = 4):
    """The model of a checkpoint's params (``load_params`` with
    ``attempts`` tries of each read), its config fitted to them
    (``adapt_config_to_params``) -> (model, step). Its weights stay fp32,
    as trained."""
    params, step = load_params(ckpt_dir, step, retry=RetryPolicy(attempts=max(attempts, 1)))
    cfg = adapt_config_to_params(cfg, params)
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(params, strict=True)
    return model, step


def _generate(model, prompt, max_new_tokens, sample, generator) -> Tensor:
    sample = sample or SampleConfig()
    prompt = torch.as_tensor(prompt, device=model.device).long()
    if prompt.dim() == 1:
        prompt = prompt[None]
    t0 = prompt.shape[1]
    cap = model.cfg.max_seq_len
    if t0 + max_new_tokens > cap:
        raise ValueError(f"prompt {t0} + new {max_new_tokens} exceeds max_seq_len {cap}")
    keys = request_keys(_seed(generator), prompt.shape[0], model.device)
    carry = prefill_carry(model, prompt, sample, keys)
    out: List[Tensor] = []
    for i in range(max_new_tokens):
        carry, emitted = _decode_body(model, sample, keys, carry, i,
                                      advance=i + 1 < max_new_tokens)
        out.append(emitted)
    if not out:
        return prompt.new_zeros(prompt.shape[0], 0)
    return torch.stack(out, dim=1)


# -- chunked decode (serving) -------------------------------------------------
# The carry of one request's walk is (next token [B], states, t, done [B]):
# ``prefill_carry`` makes it, ``decode_chunk`` advances it by a bounded
# number of tokens, and ``generate`` is the same walk in one loop, so the two
# emit the same tokens bitwise (one step function, ``_decode_body``). A chunk
# boundary is where serving snapshots the state, probes it and checks
# deadlines (``serving/session.py``). t is a Python int: the host knows
# every position, and nothing is read back from the card.


def _decode_body(model, sample: SampleConfig, keys: Tensor, carry, i: int, advance=True):
    """Emit the carry's token (the request's emitted index ``i``) and, with
    ``advance``, run one decode step and draw token i + 1 at key fold i + 1.
    ``generate`` skips the step after its last token."""
    token, states, t, done = carry
    if sample.eos_token >= 0:
        # emit EOS itself, pad everything after it
        emitted = torch.where(done, torch.full_like(token, sample.pad_token), token)
        done = done | (emitted == sample.eos_token)
    else:
        emitted = token
    if advance:
        logits, states = model.decode_step(token, states, t)
        token = sample_rows(logits, rngs.fold_keys(keys, i + 1), sample)
        t = t + 1
    return (token, states, t, done), emitted


def bucket_for(length: int, buckets: Tuple[int, ...]) -> Optional[int]:
    """Smallest bucket >= length, or None (prefill at the exact length)."""
    for b in buckets:
        if b >= length:
            return b
    return None


@torch.inference_mode()
def prefill_carry(model: TransformerLM, tokens, sample: SampleConfig, keys: Tensor,
                  sample_index: int = 0, done: Optional[Tensor] = None,
                  buckets: Tuple[int, ...] = ()):
    """tokens [B, T] -> the decode carry (next token, states, t, done).
    ``keys`` [B, 2]: the rows' counter keys (``request_keys``); the first
    token is drawn at fold ``sample_index``: 0 for a fresh prompt, n when
    re-prefilling after n emitted tokens. ``buckets``: sorted pad-to
    lengths; the prompt is right-padded to the smallest bucket >= T and its
    real length passed to ``prefill_last`` (a prompt past every bucket
    prefills at its exact length). A capacity-dispatch MoE runs under
    ``no_drop_capacity``."""
    tokens = torch.as_tensor(tokens, device=model.device).long()
    if done is None:
        done = torch.zeros(tokens.shape[0], dtype=torch.bool, device=model.device)
    t = tokens.shape[1]
    pad_to = bucket_for(t, buckets) if buckets else None
    with no_drop_capacity(model):
        if pad_to is None:
            logits, states = model.prefill_last(tokens)
        else:
            logits, states = model.prefill_last(F.pad(tokens, (0, pad_to - t)), t)
    nxt = sample_rows(logits, rngs.fold_keys(keys, sample_index), sample)
    return nxt, states, t, done


def reprefill_carry(model: TransformerLM, prompt, emitted: List[Tensor], sample: SampleConfig,
                    keys: Tensor, buckets: Tuple[int, ...] = (),
                    sample_index: Optional[int] = None):
    """Rebuild a decode carry from the prompt and the tokens emitted so far
    (the serving ladder's re-prefill rung): the first token is drawn at fold
    ``sample_index``, by default n = the tokens emitted, so the walk goes on
    as the uninterrupted one (a serving slot whose walk started at another
    fold passes its own), and ``done`` is recomputed from the emitted tokens
    (a row that emitted EOS stays done; it is rebuilt from its PAD tail, so
    its dead state differs from an uninterrupted run's)."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    seq = torch.cat([prompt, *[torch.as_tensor(e, device=model.device).long()
                               for e in emitted]], dim=1)
    n = seq.shape[1] - prompt.shape[1]
    done = None
    if sample.eos_token >= 0:
        done = (seq[:, prompt.shape[1]:] == sample.eos_token).any(dim=1)
    return prefill_carry(model, seq, sample, keys, n if sample_index is None else sample_index,
                         done, buckets)


@torch.inference_mode()
def decode_chunk(model: TransformerLM, carry, keys: Tensor, start: int, n_steps: int,
                 sample: SampleConfig):
    """Advance the carry by ``n_steps`` tokens -> (carry, tokens [B,
    n_steps]). ``start``: the request's index of the first token this chunk
    emits. The caches and rings of the carry's states are advanced in place
    (a caller that keeps them copies first: ``snapshot_decode_state``)."""
    out = []
    with no_drop_capacity(model):
        for j in range(n_steps):
            carry, emitted = _decode_body(model, sample, keys, carry, start + j)
            out.append(emitted)
    return carry, torch.stack(out, dim=1)


def generate_chunked(model: TransformerLM, prompt, max_new_tokens: int, chunk: int = 16,
                     sample: Optional[SampleConfig] = None,
                     generator: Union[None, int, torch.Generator] = None) -> Tensor:
    """``generate`` decoded in ``chunk``-token pieces: the same tokens,
    bitwise, for the same seed. ``serving.DecodeSession`` adds the
    snapshots, the finite probe and the ladder around this walk."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    sample = sample or SampleConfig()
    prompt = torch.as_tensor(prompt, device=model.device).long()
    if prompt.dim() == 1:
        prompt = prompt[None]
    keys = request_keys(_seed(generator), prompt.shape[0], model.device)
    carry = prefill_carry(model, prompt, sample, keys)
    out, n = [], 0
    while n < max_new_tokens:
        c = min(chunk, max_new_tokens - n)
        carry, toks = decode_chunk(model, carry, keys, n, c, sample)
        out.append(toks)
        n += c
    return torch.cat(out, dim=1)


# -- slot-multiplexed decode (continuous batching) ----------------------------
# Independent requests ride the rows ("slots") of one batched carry (token
# [S], states, t [S], emit [S], done [S]), each row with its own position,
# emitted-token index (its key fold) and counter key. Every op is row-wise,
# so at a fixed slot count a request's tokens do not depend on what the
# other slots hold. A row that does not emit -- a free slot, or one still
# consuming its prompt -- holds its whole carry: its state bitwise (the
# ``write`` mask of ``decode_step``), its position, emit index and done
# flag, and it emits PAD.


def _batched_step(model, sample: SampleConfig, keys: Tensor, emitting: Tensor, carry):
    token, states, t, emit, done = carry
    # a held row may sit at max_seq_len; clip its lookups, it writes nothing
    tq = t.clamp(max=model.cfg.max_seq_len - 1)
    logits, states = model.decode_step(token, states, tq, write=emitting)
    nxt = sample_rows(logits, rngs.fold_keys(keys, emit + 1), sample)
    pad = torch.full_like(token, sample.pad_token)
    if sample.eos_token >= 0:
        emitted = torch.where(done, pad, token)
        done = done | (emitting & (emitted == sample.eos_token))
    else:
        emitted = token
    emitted = torch.where(emitting, emitted, pad)
    token = torch.where(emitting, nxt, token)
    t = torch.where(emitting, t + 1, t)
    emit = torch.where(emitting, emit + 1, emit)
    return (token, states, t, emit, done), emitted


def _batched_loop(model, sample, keys, emitting, carry, n_steps):
    out = []
    for _ in range(n_steps):
        carry, emitted = _batched_step(model, sample, keys, emitting, carry)
        out.append(emitted)
    return carry, torch.stack(out, dim=1)


@torch.inference_mode()
def decode_batched_chunk(model: TransformerLM, carry, keys: Tensor, active: Tensor,
                         n_steps: int, sample: SampleConfig):
    """Advance the slot-multiplexed carry by ``n_steps`` tokens -> (carry,
    tokens [S, n_steps]). ``keys`` [S, 2]: each slot's request key (row 0 of
    ``request_keys(seed, 1)`` for a one-row request: the tokens of a solo
    ``generate`` at that seed); ``active`` [S] bool: the busy slots, the
    others emit PAD and hold their carry. The states advance in place."""
    with no_drop_capacity(model):
        return _batched_loop(model, sample, keys, active, carry, n_steps)


def _prefill_extend_row(model, pbuf: Tensor, states, sel: Tensor, offset: Tensor,
                        length: Tensor, pchunk: int):
    """Slot ``sel`` ([1]) consumes ``length`` tokens of ``pbuf[sel]`` from
    ``offset`` as a batch-1 piece, on a copy of its state row -> (the last
    real row's logits [V], the advanced row's states, batch 1)."""
    idx = (offset + torch.arange(pchunk, device=pbuf.device)).clamp(0, pbuf.shape[1] - 1)
    piece = pbuf.index_select(0, sel)[:, idx]
    row = [{k: x.index_select(0, sel) for k, x in st.items()} for st in states]
    logits, row = model.prefill_extend_step(piece, row, offset, length)
    return logits[0], row


@torch.inference_mode()
def decode_batched_prefill_chunk(model: TransformerLM, carry, keys: Tensor, active: Tensor,
                                 pbuf: Tensor, plen: Tensor, pfold: Tensor, n_steps: int,
                                 pchunk: int, sample: SampleConfig):
    """One unified chunk: a prompt piece, then the decode steps.

    Stage 1: the chunk's ``pchunk``-token prompt budget goes to one slot
    with prompt left (``t < plen``), the one with the least left (ties to
    the lowest index), as a batch-1 piece of ``prefill_extend_step`` over
    its staged prompt ``pbuf[sel]`` [S, bucket]; the piece is computed even
    when no slot is prefilling and then discarded (no read-back decides
    it), so its row is written back under that guard. A slot whose prompt
    completes draws its first token from the piece's last real row at fold
    ``pfold[sel]``. Stage 2: ``n_steps`` decode steps with the rows still
    mid-prefill held (state, t, emit, done; PAD emitted). -> (carry, tokens
    [S, n_steps])."""
    token, states, t, emit, done = carry
    piece = min(pchunk, pbuf.shape[1])
    rem = (plen - t).clamp(min=0)
    prefilling = active & (rem > 0)
    has = prefilling.any()
    sel = torch.argmin(torch.where(prefilling, rem, torch.iinfo(torch.int64).max)).reshape(1)
    rem_sel = rem.index_select(0, sel)
    cons = torch.where(has, rem_sel.clamp(max=piece), 0)[0]
    t_sel = t.index_select(0, sel)
    with no_drop_capacity(model):
        logits1, fed = _prefill_extend_row(model, pbuf, states, sel, t_sel[0], cons, piece)
        for st, new in zip(states, fed):
            for key, x in st.items():
                x.index_copy_(0, sel, torch.where(has, new[key], x.index_select(0, sel)))
        completed = has & (rem_sel <= piece)
        first = sample_rows(logits1[None],
                            rngs.fold_keys(keys.index_select(0, sel), pfold.index_select(0, sel)),
                            sample)
        token = token.index_copy(0, sel, torch.where(completed, first, token.index_select(0, sel)))
        emit = emit.index_copy(0, sel, torch.where(completed, pfold.index_select(0, sel),
                                                   emit.index_select(0, sel)))
        t = t.index_copy(0, sel, t_sel + cons)
        emitting = active & (t >= plen)
        return _batched_loop(model, sample, keys, emitting, (token, states, t, emit, done),
                             n_steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("orion_tpu_torch.generate")
    p.add_argument("--config", default="tiny")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (orion_tpu_torch.train or export_jax_checkpoint.py); "
                        "default: random params")
    p.add_argument("--prompt", default="Hello")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--tokenizer", default=None,
                   help="BPE tokenizer JSON (prepare_data --train-tokenizer); default byte-level")
    p.add_argument("--eos", action="store_true", help="stop sequences at the tokenizer's <eos>")
    p.add_argument("--ckpt-attempts", type=int, default=4,
                   help="total tries for each checkpoint read (transient I/O retried with "
                        "jittered backoff; 1 = no retry)")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="ModelConfig override, e.g. --set n_layers=4",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--quant", default="", choices=list(MODES),
                   help="weight-streamed decode: int8 quarters the weight bytes of fp32, int4 "
                        "halves them again (orion_tpu_torch/quant.py)")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    if args.set:
        from orion_tpu_torch.utils.config import apply_overrides, parse_set_overrides

        cfg = apply_overrides(cfg, parse_set_overrides(args.set))
    eos_token = -1
    if args.tokenizer:
        from orion_tpu_torch.utils.bpe import BPETokenizer

        tok = BPETokenizer.load(args.tokenizer)
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {tok.vocab_size} > model vocab {cfg.vocab_size}")
        if args.eos:
            eos_token = tok.eos
    else:
        from orion_tpu_torch.utils.tokenizer import ByteTokenizer

        tok = ByteTokenizer()
    device = resolve_device(args.device)
    if args.ckpt_dir:
        model, step = load_model(cfg, args.ckpt_dir, device, attempts=args.ckpt_attempts)
        print(f"loaded step {step} from {args.ckpt_dir}", file=sys.stderr)
    else:
        # weights from a fixed init seed (as the JAX CLI's PRNGKey(0));
        # --seed seeds only the sampler
        model = TransformerLM(cfg, device=device)
        print("no --ckpt-dir: random params (smoke test)", file=sys.stderr)
    model = quantize_for_decode(model, args.quant) if args.quant else cast_params_for_inference(model)
    out = generate(
        model,
        torch.tensor([tok.encode(args.prompt)], device=device),
        args.max_new_tokens,
        SampleConfig(args.temperature, args.top_k, args.top_p, eos_token=eos_token),
        args.seed,
    )
    ids = [int(t) for t in out[0]]
    if eos_token >= 0 and eos_token in ids:
        ids = ids[: ids.index(eos_token)]
    print(args.prompt + tok.decode(ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
