"""Where the port's generate and training paths spend the card's time.

    python3 profile_port.py

On a machine with one CUDA card. For ``lm_1b3`` (prompts of 1024 tokens,
training at 8 x 1024), ``hybrid_1b3`` (prompts of 1536, training at 8 x
2048) and the dropless ``moe_1b3_4e`` (prompts of 1024, training at 8 x
1024), each at full width from seeded random weights, it traces with
``torch.profiler`` (a) one prefill of 4 prompts, (b) 8 decode steps at batch
4 and (c) one training step (``Trainer.step``, AdamW, remat as the config
sets it) after a warm-up step; then, for ``lm_1b3``, (d) 8 decode steps of
the int4-quantized model and (e) one training step with
``optimizer="adafactor_fused"``. For each it prints the device time by
kernel (largest first, grouped into the six attention kernels, the two
grouped expert matmul kernels, the int4 dequant-matmul, the three fused
Adafactor passes, dense products, and everything else; a kernel's wgmma
variant, where it has one, is a group of its own: rows 1, 3, 4 and 6-10),
the linear-attention kernels' total (rows 1, 3 and 4, both variants), the
number of kernel launches, the window's wall time and
the device's idle share of it (1 - summed kernel time / wall time; the port
runs on one stream, so kernels do not overlap), then all of it as one JSON
line. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _group(name):
    low = name.lower()
    for kernel in ("causal_dot_norm", "causal_dot_dq_den", "causal_dot_rev_den",
                   "flash_fwd", "flash_dq", "flash_dkv", "gmm_fwd", "gmm_dw", "q4_matmul",
                   "af_sums", "af_rms", "af_apply"):
        if kernel in low:
            return f"{kernel} kernel" + (" (wgmma)" if "wgmma" in low else "")
    if any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "dense products (cuBLAS)"
    return "other (elementwise, norms, copies, sampling)"


def trace(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = _device_us(evt)
            if us > 0:
                kernels[evt.key] = (us, evt.count)
    busy = sum(us for us, _ in kernels.values())
    groups = {}
    for name, (us, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    linear = sum(us for g, us in groups.items() if g.startswith("causal_dot"))
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "kernel_launches": sum(c for _, c in kernels.values()),
        "idle_share": (1.0 - busy / wall_us) if busy else None,
        "groups_ms": {g: us / 1e3 for g, us in sorted(groups.items(), key=lambda kv: -kv[1])},
        "linear_kernels_ms": linear / 1e3,
        "top_kernels": [{"name": n[:120], "ms": us / 1e3, "count": c} for n, (us, c) in top],
    }


def profile_config(name, prompt_len, seq_len, dev, overrides=None):
    """Prefill, 8 decode steps and one training step of ``name`` (with
    ``overrides``)."""
    from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    mcfg = get_config(name, **(overrides or {}))
    model = cast_params_for_inference(TransformerLM(mcfg, device=dev))
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, prompt_len), dtype=np.int64)
    ).to(dev)
    generate(model, prompts[:, :128], 4, SampleConfig(temperature=0.0))  # warm-up
    result = {}
    with torch.inference_mode():
        result[f"{name}_prefill_B4_T{prompt_len}"] = trace(lambda: model.prefill_last(prompts))
        _, states = model.prefill_last(prompts)
        tok = torch.zeros(4, dtype=torch.long, device=dev)

        def decode():
            st = states
            for i in range(8):
                _, st = model.decode_step(tok, st, prompt_len + i)

        result[f"{name}_decode_8_steps_B4"] = trace(decode)
    del model, states
    cfg = TrainConfig(model=mcfg, batch_size=8, seq_len=seq_len)
    trainer = Trainer(cfg, device=dev)
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    trainer.step(device_batch(ds, 0, 0, cfg.batch_size, dev))  # warm-up
    batch = device_batch(ds, 0, 1, cfg.batch_size, dev)
    result[f"{name}_train_step_B8_T{seq_len}"] = trace(lambda: trainer.step(batch))
    del trainer
    torch.cuda.empty_cache()
    return result


def profile_int4_and_adafactor(dev):
    """lm_1b3: 8 int4 decode steps at batch 4 (after a 1024-token prefill)
    and one adafactor_fused training step (B 8 x 1024) after a warm-up."""
    from orion_tpu_torch.generate import SampleConfig, generate, quantize_for_decode
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    mcfg = get_config("lm_1b3")
    model = quantize_for_decode(TransformerLM(mcfg, device=dev), "int4")
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 1024), dtype=np.int64)).to(dev)
    generate(model, prompts[:, :128], 4, SampleConfig(temperature=0.0))  # warm-up
    result = {}
    with torch.inference_mode():
        _, states = model.prefill_last(prompts)
        tok = torch.zeros(4, dtype=torch.long, device=dev)

        def decode():
            st = states
            for i in range(8):
                _, st = model.decode_step(tok, st, 1024 + i)

        decode()  # warm-up at these positions
        result["lm_1b3_int4_decode_8_steps_B4"] = trace(decode)
    del model, states
    torch.cuda.empty_cache()
    trainer = Trainer(TrainConfig(model=mcfg, batch_size=8, seq_len=1024,
                                  optimizer="adafactor_fused"), device=dev)
    ds = SyntheticDataset(mcfg.vocab_size, 1024)
    trainer.step(device_batch(ds, 0, 0, 8, dev))  # warm-up
    batch = device_batch(ds, 0, 1, 8, dev)
    result["lm_1b3_adafactor_fused_train_step_B8_T1024"] = trace(lambda: trainer.step(batch))
    del trainer
    torch.cuda.empty_cache()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    result = profile_config("lm_1b3", 1024, 1024, dev)
    result.update(profile_config("hybrid_1b3", 1536, 2048, dev))
    result.update(profile_config("moe_1b3_4e", 1024, 1024, dev, {"moe_dropless": True}))
    result.update(profile_int4_and_adafactor(dev))
    for phase, r in result.items():
        print(f"{phase}: wall {r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms, "
              f"idle share {r['idle_share']}, {r['kernel_launches']} kernel launches, "
              f"linear-attention kernels {r['linear_kernels_ms']:.3f} ms")
        for g, ms in r["groups_ms"].items():
            print(f"  {g}: {ms:.3f} ms")
        for k in r["top_kernels"]:
            print(f"    {k['ms']:8.3f} ms  x{k['count']:<5} {k['name']}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
