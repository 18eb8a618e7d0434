"""Decode ms/token of the port's ``generate``, one generate at a time, for
comparing two checkouts of the port on one card by the same method.

    python3 time_decode.py [--root DIR] [--generates N]

On a machine with one CUDA card. Imports ``orion_tpu_torch`` from ``DIR``
(default: this file's directory), so the same script times another
checkout's package. For ``lm_1b3`` at int4 and bf16 and the dropless
``moe_1b3_4e`` at int4, each at full width from seeded random weights (as
``chip_smoke.py`` builds them: 4 prompts of 1024 byte tokens, greedy), it
warms up, times 3 prefills (``generate`` with one new token) and then N
generates of 32 tokens, one at a time, each read on its own: decode
ms/token = (that generate - the prefills' median) / 31. The card
machine's host is shared and sets the pace of decode, so one checkout's
runs spread; compare checkouts by running this script on each in turn
within one call. Prints a line per model, then the card's name and power
limit, then every run as one JSON line. Imports nothing of JAX.

``--what slots`` (or ``both``) times the slot programs instead (or too):
for ``lm_1b3`` and ``hybrid_1b3`` in bf16, 4 requests of 1024 tokens
prefilled solo into 4 slots, then ``decode_batched_chunk`` boundaries of 16
steps with every slot busy, each read on its own after one: decode
ms/token = that boundary / 16. The programs' names are those of every
checkout since they were ported, so a checkout before and after a change of
the decode step are timed alike.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MODELS = [("lm_1b3", "int4", {}), ("moe_1b3_4e", "int4", {"moe_dropless": True}),
          ("lm_1b3", None, {})]
PROMPT_LEN, NEW_TOKENS = 1024, 32


def _wall_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def time_model(dev, name, quant, overrides, generates):
    """-> {"prefill_ms": [...], "decode_ms_per_token": [...]} for one model."""
    from orion_tpu_torch.generate import (SampleConfig, cast_params_for_inference, generate,
                                          quantize_for_decode)
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = get_config(name, **overrides)
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model = quantize_for_decode(model, quant) if quant else cast_params_for_inference(model)
    torch.cuda.empty_cache()
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, PROMPT_LEN), dtype=np.int64)).to(dev)
    greedy = SampleConfig(temperature=0.0)
    kw = {"quant": quant} if quant else {}
    generate(model, prompts[:, :128], 2, greedy, **kw)  # warm-up: plans, allocator, checks
    prefill = [_wall_ms(lambda: generate(model, prompts, 1, greedy, **kw)) for _ in range(3)]
    base = float(np.median(prefill))
    decode = [(_wall_ms(lambda: generate(model, prompts, NEW_TOKENS, greedy, **kw)) - base)
              / (NEW_TOKENS - 1) for _ in range(generates)]
    del model
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill, "decode_ms_per_token": decode}


SLOT_MODELS = [("lm_1b3", {}), ("hybrid_1b3", {})]
SLOT_CHUNK = 16


def time_slots(dev, name, overrides, chunks):
    """-> {"decode_ms_per_token": [...]} at 4 busy slots for one model."""
    from orion_tpu_torch.generate import (SampleConfig, cast_params_for_inference,
                                          decode_batched_chunk, prefill_carry, request_keys)
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import (TransformerLM, init_decode_state,
                                                    insert_decode_slot)

    cfg = get_config(name, **overrides)
    model = cast_params_for_inference(
        TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.empty_cache()
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, PROMPT_LEN), dtype=np.int64)).to(dev)
    greedy = SampleConfig(temperature=0.0)
    keys = torch.cat([request_keys(900 + j, 1, dev) for j in range(4)])
    with torch.inference_mode():
        states = init_decode_state(cfg, 4, dev)
        token = torch.zeros(4, dtype=torch.long, device=dev)
        t = torch.zeros(4, dtype=torch.long, device=dev)
        for j in range(4):
            c = prefill_carry(model, prompts[j:j + 1], greedy, keys[j:j + 1])
            insert_decode_slot(states, c[1], j)
            token[j], t[j] = c[0][0], c[2]
        carry = [(token, states, t, torch.zeros_like(t), torch.zeros(4, dtype=torch.bool,
                                                                     device=dev))]
    active = torch.ones(4, dtype=torch.bool, device=dev)

    def boundary():
        carry[0], _ = decode_batched_chunk(model, carry[0], keys, active, SLOT_CHUNK, greedy)

    boundary()  # warm-up
    decode = [_wall_ms(boundary) / SLOT_CHUNK for _ in range(chunks)]
    del model, carry
    torch.cuda.empty_cache()
    return {"decode_ms_per_token": decode}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose orion_tpu_torch is timed")
    ap.add_argument("--generates", type=int, default=5)
    ap.add_argument("--what", choices=("generate", "slots", "both"), default="generate",
                    help="generate's decode, the slot programs' at 4 busy slots, or both")
    ap.add_argument("--chunks", type=int, default=5, help="boundaries timed a slot model")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode: needs a CUDA card", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import orion_tpu_torch

    if not Path(orion_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"orion_tpu_torch came from {orion_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    result = {"root": root}
    for name, quant, overrides in MODELS if args.what != "slots" else ():
        key = f"{name} {quant or 'bf16'}"
        r = result[key] = time_model(dev, name, quant, overrides, args.generates)
        print(f"{key}: prefill {[round(x, 2) for x in r['prefill_ms']]} ms; decode "
              f"{[round(x, 3) for x in r['decode_ms_per_token']]} ms/token at batch 4, one "
              "generate each", flush=True)
    for name, overrides in SLOT_MODELS if args.what != "generate" else ():
        key = f"{name} bf16 4 slots"
        r = result[key] = time_slots(dev, name, overrides, args.chunks)
        print(f"{key}: decode {[round(x, 3) for x in r['decode_ms_per_token']]} ms/token, one "
              f"boundary of {SLOT_CHUNK} steps each", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
