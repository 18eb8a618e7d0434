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
3. **sampling** -- greedy / temperature / top-k / top-p, drawn from a
   ``torch.Generator``. torch's and JAX's generators draw different numbers,
   so sampled tokens match the JAX package's only in distribution; greedy
   tokens match exactly.

A capacity-dispatch MoE model is served with its capacity factor raised to
E / k for the call (the JAX package's no-drop serving rule): decode never
drops a token, so the prompt's prefill must not either. The dropless form
has no capacity to raise.

Quantized serving (``quant="int8"`` / ``"int4"``, CLI ``--quant``):
``quantize_for_decode`` builds the int8 (or int4-packed) model from a
full-precision one (``orion_tpu_torch/quant.py``); in int4 every decode
step's dense products run the hand-written ``q4_matmul`` kernel on the card.

Without a checkpoint the weights come from a seeded init. Loading one is
not ported yet (ROADMAP.md queue A, item 5: the JAX package's orbax
checkpoints, and the port's own from ``orion_tpu_torch.train``);
``convert.load_jax_params`` takes a flax parameter tree.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from typing import List, Optional

import torch

from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.models.moe import MoEMLP
from orion_tpu_torch.models.transformer import Dense, TransformerLM
from orion_tpu_torch.quant import MODES, check_mode, quantize_params_for_decode
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


def sample_logits(
    logits: Tensor, generator: Optional[torch.Generator], cfg: SampleConfig
) -> Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
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
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
    generator: Optional[torch.Generator] = None,
    quant: str = "",
) -> Tensor:
    """prompt [B, T0] (or [T0]) -> generated tokens [B, max_new_tokens].

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


def _generate(model, prompt, max_new_tokens, sample, generator) -> Tensor:
    sample = sample or SampleConfig()
    prompt = torch.as_tensor(prompt, device=model.device).long()
    if prompt.dim() == 1:
        prompt = prompt[None]
    t0 = prompt.shape[1]
    cap = model.cfg.max_seq_len
    if t0 + max_new_tokens > cap:
        raise ValueError(f"prompt {t0} + new {max_new_tokens} exceeds max_seq_len {cap}")
    logits, states = model.prefill_last(prompt)
    token = sample_logits(logits, generator, sample)
    done = torch.zeros_like(token, dtype=torch.bool)
    out: List[Tensor] = []
    for i in range(max_new_tokens):
        if sample.eos_token >= 0:
            emitted = torch.where(done, torch.full_like(token, sample.pad_token), token)
            done = done | (emitted == sample.eos_token)
        else:
            emitted = token
        out.append(emitted)
        if i + 1 < max_new_tokens:
            logits, states = model.decode_step(token, states, t0 + i)
            token = sample_logits(logits, generator, sample)
    if not out:
        return prompt.new_zeros(prompt.shape[0], 0)
    return torch.stack(out, dim=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("orion_tpu_torch.generate")
    p.add_argument("--config", default="tiny")
    p.add_argument("--prompt", default="Hello")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
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
    from orion_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    device = resolve_device(args.device)
    # weights from a fixed init seed (as the JAX CLI's PRNGKey(0)); --seed
    # seeds only the sampler
    model = TransformerLM(cfg, device=device)
    model = quantize_for_decode(model, args.quant) if args.quant else cast_params_for_inference(model)
    print("no checkpoint: random params (smoke test)", file=sys.stderr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = generate(
        model,
        torch.tensor([tok.encode(args.prompt)], device=device),
        args.max_new_tokens,
        SampleConfig(args.temperature, args.top_k, args.top_p),
        gen,
    )
    print(args.prompt + tok.decode([int(t) for t in out[0]]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
