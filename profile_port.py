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

    python3 profile_port.py --options

instead traces one ``lm_1b3`` training step (B 8 x 1024, AdamW, after a
warm-up step) in each of the model and training options: elu+1 (the
default), ``feature_map="favor"``, ``feature_map="learnable"`` with an
untied head, ``remat_policy="dots"`` and ``param_storage="bfloat16_sr"``,
and prints the same breakdown for each, then one JSON line.

    python3 profile_port.py --q4-probe

instead probes row 14's mma kernel at lm_1b3's three decode shapes and
prints what it finds, then one JSON line: what the unpack costs
(``q4_unpack_probe``), what the early start saves (``q4_early_probe``)
and where a launch's time goes (``q4_latency_probe``).
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
            # the caches are written in place: each traced call rewrites the
            # same 8 slots of ``states``, the same work every time
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


TRAIN_OPTIONS = {
    "elu1": ({}, "float32"),
    "favor": ({"feature_map": "favor"}, "float32"),
    "learnable_untied": ({"feature_map": "learnable", "tie_embeddings": False}, "float32"),
    "remat_dots": ({"remat_policy": "dots"}, "float32"),
    "bfloat16_sr": ({}, "bfloat16_sr"),
}


def profile_train_options(dev):
    """One lm_1b3 training step (B 8 x 1024, AdamW) after a warm-up, in each
    of ``TRAIN_OPTIONS``."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    result = {}
    for label, (over, storage) in TRAIN_OPTIONS.items():
        cfg = TrainConfig(model=get_config("lm_1b3", **over), batch_size=8, seq_len=1024,
                          param_storage=storage)
        trainer = Trainer(cfg, device=dev)
        ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
        trainer.step(device_batch(ds, 0, 0, cfg.batch_size, dev))  # warm-up
        batch = device_batch(ds, 0, 1, cfg.batch_size, dev)
        result[f"lm_1b3_{label}_train_step_B8_T1024"] = trace(lambda: trainer.step(batch))
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


# the unpack of row 14's two kernels, and what the probe puts in its place:
# the packed bits passed through as they are (wrong numbers; the same loads,
# products and sums)
_MMA_UNPACK = (
    '  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(t) : "r"(w), "r"(hi), "r"(SEL));\n'
    '  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(t), "r"(M_NIBBLES), "r"(M_MAGIC));\n'
    '  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(t) : "r"(r), "r"(M_ONE), "r"(M_OFFSET));\n'
    '  return t;\n')
_MMA_PASS = "  (void)t; (void)r;\n  return (C & 1) ? hi : w;\n"
_SIMT_UNPACK = ("const float lo = (float)((int)(w << (28 - 8 * c)) >> 28);\n"
                "            const float hi = (float)((int)(w << (24 - 8 * c)) >> 28);")
_SIMT_PASS = ("const float lo = __uint_as_float(w >> c);\n"
              "            const float hi = __uint_as_float(w << c);")
Q4_PROBE_SHAPES = {"wq..wo": (2048, 2048), "gate/up": (2048, 5504), "down": (5504, 2048)}


def q4_unpack_probe(dev):
    """Row 14's unpack on the card: both kernels at lm_1b3's three decode
    shapes (bf16 x [4, d] against p [d/2, out]), each called through its C
    entry point, device time alone over cold weights (``chip_smoke.graph_ms``
    over ``cold_copies``, each launch after the one before has ended), as
    built and from a copy of ``csrc/q4_matmul.cu`` whose unpack passes the
    packed bits through (the mma kernel's prmt, lop3 and fma; the simt
    kernel's shifts and int -> float conversions). The difference is what
    the unpack costs each kernel."""
    import ctypes

    from chip_smoke import cold_copies, graph_ms
    from orion_tpu_torch.ops.kernels import library
    from orion_tpu_torch.ops.kernels import q4_matmul as q4

    src = q4.SOURCES["q4"]
    text = src.read_text()
    assert text.count(_MMA_UNPACK) == 1 and text.count(_SIMT_UNPACK) == 1
    probe_dir = library.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    copy = probe_dir / src.name
    copy.write_text(text.replace(_MMA_UNPACK, _MMA_PASS).replace(_SIMT_UNPACK, _SIMT_PASS))
    libs = {"as built": library.load(src, q4._SIGNATURES["q4"]),
            "unpack passed through": library.load(copy, q4._SIGNATURES["q4"])}
    g = torch.Generator(device=dev).manual_seed(14)
    result = {}
    for label, (d, out) in Q4_PROBE_SHAPES.items():
        x = torch.randn(4, d, device=dev, generator=g).bfloat16()
        ps = cold_copies(torch.randint(-128, 128, (d // 2, out), device=dev, generator=g)
                         .to(torch.int8))
        s = torch.rand(out, device=dev, generator=g) + 0.5
        y = torch.empty(4, out, dtype=torch.bfloat16, device=dev)
        for name, lib in libs.items():
            plans = []
            for p in ps:
                plan = ctypes.create_string_buffer(lib.q4_plan_bytes())
                assert lib.q4_plan(plan, p.data_ptr(), d // 2, out) == 0
                plans.append(plan)

            def mma(i):
                assert lib.q4_matmul_mma(plans[i % len(ps)], x.data_ptr(), s.data_ptr(),
                                         y.data_ptr(), 4, 0,
                                         torch.cuda.current_stream().cuda_stream) == 0

            def simt(i):
                assert lib.q4_matmul(x.data_ptr(), ps[i % len(ps)].data_ptr(), s.data_ptr(),
                                     y.data_ptr(), 4, d, out, 1, 1,
                                     torch.cuda.current_stream().cuda_stream) == 0

            for variant, fn in (("mma", mma), ("simt", simt)):
                result[f"{label} {variant} {name}"] = graph_ms(fn, 200)
        for variant in ("mma", "simt"):
            built = result[f"{label} {variant} as built"]
            passed = result[f"{label} {variant} unpack passed through"]
            print(f"q4 unpack probe {label} (x [4, {d}] @ p [{d // 2}, {out}]), {variant}: "
                  f"{built:.4f} ms as built, {passed:.4f} ms with the unpack passed through "
                  f"(the unpack: {built - passed:.4f} ms)")
    return {"q4_unpack_probe_ms": result}


def _q4_problem(dev, g, lib, d, out):
    """x [4, d] bf16, cold copies of a random p [d/2, out] with their plans,
    s, y: one decode shape's operands for the C entry points of ``lib``."""
    import ctypes

    from chip_smoke import cold_copies

    x = torch.randn(4, d, device=dev, generator=g).bfloat16()
    ps = cold_copies(torch.randint(-128, 128, (d // 2, out), device=dev, generator=g)
                     .to(torch.int8))
    plans = []
    for p in ps:
        plan = ctypes.create_string_buffer(lib.q4_plan_bytes())
        assert lib.q4_plan(plan, p.data_ptr(), d // 2, out) == 0
        plans.append(plan)
    s = torch.rand(out, device=dev, generator=g) + 0.5
    y = torch.empty(4, out, dtype=torch.bfloat16, device=dev)
    return x, ps, plans, s, y


def q4_early_probe(dev):
    """What the early start (programmatic dependent launch) saves the mma
    kernel: device time alone a launch (``chip_smoke.graph_ms`` over cold
    weights, launches back to back as wq, wk, wv and gate, up run) with and
    without it, through the C entry point."""
    from chip_smoke import graph_ms
    from orion_tpu_torch.ops.kernels import q4_matmul as q4

    lib = q4._library()
    g = torch.Generator(device=dev).manual_seed(14)
    result = {}
    for label, (d, out) in Q4_PROBE_SHAPES.items():
        x, ps, plans, s, y = _q4_problem(dev, g, lib, d, out)
        for early in (0, 1):
            def mma(i):
                assert lib.q4_matmul_mma(plans[i % len(ps)], x.data_ptr(), s.data_ptr(),
                                         y.data_ptr(), 4, early,
                                         torch.cuda.current_stream().cuda_stream) == 0
            result[f"{label} early {early}"] = graph_ms(mma, 200)
        print(f"q4 early-start probe {label} (x [4, {d}] @ p [{d // 2}, {out}]): "
              f"{result[f'{label} early 0']:.4f} ms a launch after the one before has ended, "
              f"{result[f'{label} early 1']:.4f} ms with the early start")
    return {"q4_early_probe_ms": result}


# where the latency probe stamps the mma kernel: (after this text, stamp k
# of the block's thread 0, what it marks); each text once in the source
_Q4_STAMPS = [
    ("    const __grid_constant__ CUtensorMap pmap, const MmaArgs a) {\n", 0,
     "the block starts"),
    ("    stage_words(a, xs, box0 * M_BR, min(a.xk, rows), tid);\n", 1,
     "x's first chunk staged"),
    ("      mbar_wait(bars + 8 * s, (i / a.stages) & 1);\n", 2,
     "the first box of p arrived"),
    ("    cluster_wait();\n", 3, "its products done, the cluster's blocks arrived"),
    ("    mbar_wait(inbox_bar, 0);\n", 4, "the cluster's partial sums in"),
    ("__float2bfloat16_rn(sum * scale[ch]);\n  }\n", 5, "y written"),
]


def q4_latency_probe(dev):
    """Where a launch of the mma kernel spends its time: a copy of
    ``csrc/q4_matmul.cu`` whose blocks read the card's global timer (ns) at
    the points of ``_Q4_STAMPS``, one launch at each of lm_1b3's three
    decode shapes on cold weights after the card is idle (no early start).
    Prints, over the blocks, the spread of their starts and the median and
    largest time from the first block's start to each point."""
    import ctypes

    from orion_tpu_torch.ops.kernels import library
    from orion_tpu_torch.ops.kernels import q4_matmul as q4

    src = q4.SOURCES["q4"]
    text = src.read_text()
    for anchor, k, _ in _Q4_STAMPS:
        assert text.count(anchor) == 1, anchor
        guard = " && i == 0" if k == 2 else ""
        text = text.replace(anchor, anchor + f"  if (threadIdx.x == 0{guard}) "
                            f"q4_stamps[blockIdx.x][{k}] = global_ns();\n")
    decl = "struct MmaArgs {"
    text = text.replace(decl, "__device__ unsigned long long q4_stamps[2048][8];\n\n" + decl, 1)
    text += ('\nextern "C" int q4_stamps_read(void* out) {\n'
             "  return (int)cudaMemcpyFromSymbol(out, q4_stamps, sizeof(q4_stamps));\n}\n")
    probe_dir = library.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    copy = probe_dir / ("stamped_" + src.name)
    copy.write_text(text)
    lib = library.load(copy, {**q4._SIGNATURES["q4"], "q4_stamps_read": [ctypes.c_void_p]})
    g = torch.Generator(device=dev).manual_seed(14)
    result = {}
    for label, (d, out) in Q4_PROBE_SHAPES.items():
        x, ps, plans, s, y = _q4_problem(dev, g, lib, d, out)
        strips, cl, _ = q4.mma_geometry(d // 2, out,
                                        torch.cuda.get_device_properties(dev).multi_processor_count)
        for i in range(3):  # the last launch is read
            torch.cuda.synchronize()
            assert lib.q4_matmul_mma(plans[i], x.data_ptr(), s.data_ptr(), y.data_ptr(), 4, 0,
                                     torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (2048 * 8))()
        assert lib.q4_stamps_read(raw) == 0
        stamps = np.array(raw, dtype=np.int64).reshape(2048, 8)[:strips * cl, :len(_Q4_STAMPS)]
        since = stamps - stamps[:, 0].min()
        row = {"blocks": strips * cl, "cluster": cl,
               "start_spread_ns": int(since[:, 0].max())}
        for _, k, what in _Q4_STAMPS[1:]:
            row[what] = {"median_ns": float(np.median(since[:, k])), "max_ns": int(since[:, k].max())}
        result[label] = row
        print(f"q4 latency probe {label} (x [4, {d}] @ p [{d // 2}, {out}], {strips * cl} blocks "
              f"in clusters of {cl}): starts spread over {row['start_spread_ns']} ns; from the "
              "first start, median / last: " + "; ".join(
                  f"{what} {row[what]['median_ns']:.0f} / {row[what]['max_ns']}"
                  for _, _, what in _Q4_STAMPS[1:]) + " ns")
    return {"q4_latency_probe": result}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if "--q4-probe" in sys.argv[1:]:  # row 14's probes instead of the profile
        result = q4_unpack_probe(dev)
        result.update(q4_early_probe(dev))
        result.update(q4_latency_probe(dev))
        print(json.dumps(result))
        return 0
    if "--options" in sys.argv[1:]:
        result = profile_train_options(dev)
    else:
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
