"""Rows 6-8's kernel times, for comparing two checkouts of the port on one
card by one method.

    python3 time_flash.py [--root DIR] [--runs N]

On a machine with one CUDA card. Imports ``orion_tpu_torch`` from ``DIR``
(default: this file's directory), so the same script times another
checkout's flash kernels (it passes ``shift`` / ``q_offset`` only where
the checkout's wrappers take them). Shapes: hybrid_1b3's training
attention (B 8, H 16, T 2048, D 128, bf16, causal, window 1024: the
main path's wgmma kernels with the plain mask) and, where the checkout
takes them, the striped ring's block at T 8192 / sp 4 with shift 1 and the
halo's block at q_offset 2048 (B 2, T 2048). Each reading is
``chip_smoke.py``'s ``cuda_ms`` (CUDA events over 10 calls after a warm-up
call, the mean) of the forward, the dq pass and the dk/dv pass, on the
plain forward's lse and delta; N readings each, their median. Prints the
card's name and power limit, then everything as one JSON line. Imports
nothing of JAX.
"""

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CASES = [
    ("training", 8, 2048, dict(causal=True, window=1024)),
    ("striped block, shift 1", 2, 2048, dict(causal=True, window=None, shift=1)),
    ("halo block, q_offset 2048", 2, 2048, dict(causal=True, window=1024, q_offset=2048)),
]


def cuda_ms(fn, iters=10):
    """``chip_smoke.cuda_ms``: mean device time of ``fn`` over ``iters``
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    p = argparse.ArgumentParser("time_flash")
    p.add_argument("--root", default=str(Path(__file__).resolve().parent))
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from orion_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    takes_offsets = "q_offset" in inspect.signature(fa.flash_fwd_cuda).parameters
    g = torch.Generator(device=dev).manual_seed(6)
    result = {"root": args.root, "package": fa.__file__, "cases": {}}
    for label, b, t, opts in CASES:
        if not takes_offsets and (opts.get("shift") or opts.get("q_offset")):
            continue
        q, k, v, gout = (torch.randn(b * 16, t, 128, device=dev, generator=g).bfloat16()
                         for _ in range(4))
        r_out, lse = fa.flash_fwd_plain(q, k, v, **opts)
        delta = (gout.float() * r_out.float()).sum(-1, keepdim=True)
        calls = {"fwd": lambda: fa.flash_fwd_cuda(q, k, v, **opts),
                 "dq": lambda: fa.flash_dq_cuda(q, k, v, gout, lse, delta, **opts),
                 "dkv": lambda: fa.flash_dkv_cuda(q, k, v, gout, lse, delta, **opts)}
        readings = {n: [cuda_ms(fn) for _ in range(args.runs)] for n, fn in calls.items()}
        result["cases"][label] = {n: {"median_ms": float(np.median(r)), "readings": r}
                                  for n, r in readings.items()}
        print(label, {n: round(float(np.median(r)), 4) for n, r in readings.items()}, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    result["card"] = card
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
