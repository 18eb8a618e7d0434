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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose orion_tpu_torch is timed")
    ap.add_argument("--generates", type=int, default=5)
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
    for name, quant, overrides in MODELS:
        key = f"{name} {quant or 'bf16'}"
        r = result[key] = time_model(dev, name, quant, overrides, args.generates)
        print(f"{key}: prefill {[round(x, 2) for x in r['prefill_ms']]} ms; decode "
              f"{[round(x, 3) for x in r['decode_ms_per_token']]} ms/token at batch 4, one "
              "generate each", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
