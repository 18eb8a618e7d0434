"""The public op's forward + backward time, for comparing two checkouts of
the port on one card by one method.

    python3 time_op.py [--root DIR] [--runs N]

On a machine with one CUDA card. Imports ``orion_tpu_torch`` from ``DIR``
(default: this file's directory), so the same script times another
checkout's package. At lm_1b3's per-layer shape [B 8, H 16, T 1024, D 128]
bf16, with an initial state and the returned state (inputs as
``chip_smoke.py``'s op phase makes them), one call is ``causal_dot_product``
forward and backward through autograd, as ``chip_smoke.py`` calls it. It
reads the op N times by ``chip_smoke.py``'s method (``cuda_ms``: CUDA
events over 5 calls after a warm-up call, the mean) and counts the garbage
collections, by generation, that fell inside each reading; then it traces
5 calls with ``torch.profiler`` for the kernels' time a call, by name, and
their sum (the card runs one stream, so kernels do not overlap). The idle
share is 1 - that sum / the readings' median (the traced wall time, which
the profiler's own host work inflates, is printed beside it). Prints the
readings, then the card's name and power limit, then everything as one
JSON line. Imports nothing of JAX.
"""

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

B, H, T, D = 8, 16, 1024, 128


def cuda_ms(fn, iters):
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


def op_call(dev):
    """-> one forward + backward of the public op, as ``chip_smoke.py``'s op
    phase runs it at D 128."""
    from orion_tpu_torch.ops import causal_dot_product

    g = torch.Generator(device=dev).manual_seed(22)
    bh = B * H

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    q0 = phi(torch.randn(bh, T, D, device=dev, generator=g)).bfloat16()
    k0 = phi(torch.randn(bh, T, D, device=dev, generator=g)).bfloat16()
    v0, gout = (torch.randn(bh, T, D, device=dev, generator=g).bfloat16() for _ in range(2))
    kp = phi(torch.randn(bh, 256, D, device=dev, generator=g)).bfloat16().float()
    vp = torch.randn(bh, 256, D, device=dev, generator=g).bfloat16().float()
    s00 = kp.transpose(1, 2) @ vp
    gsf = 8.0 * torch.randn(bh, D, D, device=dev, generator=g)
    q0, k0, v0, gout, s00, gsf = (x.reshape(B, H, *x.shape[1:])
                                  for x in (q0, k0, v0, gout, s00, gsf))

    def run():
        q, k, v, s0 = (x.clone().requires_grad_() for x in (q0, k0, v0, s00))
        out, sf = causal_dot_product(q, k, v, backend="cuda", return_state=True,
                                     initial_state=s0)
        ((out.float() * gout.float()).sum() + (sf * gsf).sum()).backward()

    return run


def time_op(dev, runs):
    run = op_call(dev)
    collections = [0, 0, 0]  # by generation

    def count(phase, info):
        if phase == "start":
            collections[info["generation"]] += 1

    gc.callbacks.append(count)
    readings, gcs = [], []
    try:
        for _ in range(runs):
            collections[:] = [0, 0, 0]
            readings.append(cuda_ms(run, 5))
            gcs.append(list(collections))
    finally:
        gc.callbacks.remove(count)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / 5
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = float(getattr(evt, "self_device_time_total", 0.0)
                       or getattr(evt, "self_cuda_time_total", 0.0))
            if us > 0:
                kernels[evt.key[:100]] = (us / 5e3, evt.count // 5)
    busy = sum(ms for ms, _ in kernels.values())
    return {"ms": readings, "gc_collections": gcs, "median_ms": float(np.median(readings)),
            "traced_wall_ms": wall_ms, "traced_device_busy_ms": busy,
            "idle_share": 1.0 - busy / float(np.median(readings)),
            "kernels": [{"name": n, "ms": ms, "per_call": c}
                        for n, (ms, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose orion_tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_op: needs a CUDA card", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import orion_tpu_torch

    if not Path(orion_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"orion_tpu_torch came from {orion_tpu_torch.__file__}, not {root}")
    r = time_op(torch.device("cuda", 0), args.runs)
    print(f"causal_dot_product fwd + bwd, [{B}, {H}, {T}, {D}] bf16, {root}: "
          f"{[round(x, 3) for x in r['ms']]} ms (mean of 5 calls each), median "
          f"{r['median_ms']:.3f}; collections (generations 0, 1, 2) inside each reading "
          f"{r['gc_collections']}; kernels {r['traced_device_busy_ms']:.3f} ms a call (traced "
          f"wall {r['traced_wall_ms']:.3f}), idle share {r['idle_share']:.3f}", flush=True)
    for k in r["kernels"]:
        print(f"  {k['ms']:8.4f} ms  x{k['per_call']:<3} {k['name']}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"root": root, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
