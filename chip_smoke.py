"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and ``nvcc``
(``$CUDA_HOME/bin`` or on ``PATH``). It imports nothing of JAX or of the JAX
package. Phases, each of which raises on failure (the exit code is then
nonzero and no result line is printed):

1. the card's name and power limit (``nvidia-smi``);
2. build the kernel library from the source in the checkout, and time
   the build;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and at ragged and one-token lengths, and time both;
4. the main path: ``orion_tpu_torch.generate.generate`` on ``lm_1b3`` at
   full width (seeded random weights), 4 prompts of 1024 byte tokens, 32
   greedy new tokens, with every kernel's launch count reset just before and
   read just after; the prefill's logits against a ``backend="torch"`` run
   of the same weights on the card; and ``tiny`` on the card against the
   same model on the CPU, whose plain path the CPU tests hold against the
   JAX package;
5. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
ROOT = Path(__file__).resolve().parent

# causal_dot_norm against its plain version. ``out`` (bf16): both divide in
# fp32 and round once to bf16; their fp32 quotients differ only by the order
# of the sums, so they round to the same bf16 value or to neighbours, and a
# bf16 step is at most 2^-7 of the value. The absolute term covers elements
# near zero, where the order of the fp32 sums alone moves the quotient: at
# most about (terms summed) x 2^-24 x |v| ~ 1e-4 for 1280 terms of |v| < 2.
# S, z (fp32): sums of exact products in another order. ``kernel_mutants.py``
# shows which wrong kernels these limits reject.
OUT_RTOL, OUT_ATOL = 2**-7, 1e-4
STATE_RTOL = 1e-4  # of the state's largest magnitude
# lm_1b3's per-layer S after the kernel-backed prefill against the plain
# one: each layer's input differs by the bf16 roundings of the layers below
LAYER_S_RTOL = 5e-3


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def card_info():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(line)


def build(cd):
    t = time.perf_counter()
    path, out = cd.build()
    log(f"built {path.name} from {cd.SOURCE.relative_to(ROOT)} in {time.perf_counter() - t:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def compare_causal_dot(cd, dev):
    """The kernel against its plain version on the card, at the main path's
    width (B 4, H 16, D 128, bf16): T 1024, a ragged 1000 and 1, each with
    the state a 256-token prefix leaves, and T 1024 from a zero state (what
    prefill gives the kernel). Returns one reading per case and the last
    case's inputs. ``out_over_limit`` is the largest |out - ref| as a share
    of its limit ``OUT_ATOL + OUT_RTOL |ref|`` (above 1 fails);
    ``out_atol_needed`` the smallest absolute term that this case alone
    would need beside ``OUT_RTOL``."""
    g = torch.Generator(device=dev).manual_seed(0)

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    readings = []
    for b, h, t, with_state in [(4, 16, 1024, True), (4, 16, 1000, True), (4, 16, 1, True),
                                (4, 16, 1024, False)]:
        bh, d = b * h, 128
        q = phi(torch.randn(bh, t, d, device=dev, generator=g)).bfloat16()
        k = phi(torch.randn(bh, t, d, device=dev, generator=g)).bfloat16()
        v = torch.randn(bh, t, d, device=dev, generator=g).bfloat16()
        s0 = z0 = None
        if with_state:  # the state a 256-token prefix leaves
            kp = phi(torch.randn(bh, 256, d, device=dev, generator=g)).bfloat16().float()
            vp = torch.randn(bh, 256, d, device=dev, generator=g).bfloat16().float()
            s0, z0 = kp.transpose(1, 2) @ vp, kp.sum(1)
        out, sf, zf = cd.causal_dot_norm_cuda(q, k, v, s0, z0)
        torch.cuda.synchronize()
        r_out, r_s, r_z = cd.causal_dot_norm_plain(q, k, v, s0, z0)
        diff, ref = (out.float() - r_out.float()).abs(), r_out.float().abs()
        readings.append({
            "case": f"B{b} H{h} T{t} D{d} bf16 state={with_state}",
            "out_max_abs": float(diff.max()), "ref_max_abs": float(ref.max()),
            "out_over_limit": float((diff / (OUT_ATOL + OUT_RTOL * ref)).max()),
            "out_atol_needed": float((diff - OUT_RTOL * ref).clamp_min(0).max()),
            "s_rel": _rel(sf, r_s), "z_rel": _rel(zf, r_z),
            "well_formed": out.shape == v.shape and out.dtype == torch.bfloat16
            and bool(torch.isfinite(out.float()).all()),
        })
    return readings, (q, k, v)


def agrees(r):
    return (r["well_formed"] and r["out_over_limit"] <= 1.0
            and r["s_rel"] <= STATE_RTOL and r["z_rel"] <= STATE_RTOL)


def check_causal_dot(cd, dev):
    readings, (q, k, v) = compare_causal_dot(cd, dev)
    for r in readings:
        log(f"causal_dot_norm {r['case']}: out max abs {r['out_max_abs']:.3e} "
            f"(max |ref| {r['ref_max_abs']:.3f}), {r['out_over_limit']:.3f} of its limit "
            f"{OUT_ATOL:g} + 2^-7|ref|, needs atol {r['out_atol_needed']:.3e}; "
            f"S rel {r['s_rel']:.3e}, z rel {r['z_rel']:.3e} (limit {STATE_RTOL:g})")
        if not agrees(r):
            raise AssertionError(f"causal_dot_norm disagrees with its plain version: {r}")

    # timing at the main path's shape: B 4, H 16, T 1024, D 128, bf16, no
    # initial state (what prefill gives the kernel)
    ms = cuda_ms(lambda: cd.causal_dot_norm_cuda(q, k, v), 20)
    plain_ms = cuda_ms(lambda: cd.causal_dot_norm_plain(q, k, v), 5)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    moved = 3 * q.numel() * q.element_size() + v.numel() * 2 + bh * dk * dv * 4 + bh * dk * 4
    chunk = 64
    flops = 2 * bh * t * (chunk * dk + chunk * dv + 2 * dk * dv)
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    log(f"causal_dot_norm timing B4 H16 T1024 D128 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms ({moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        "library_ms: none (no single PyTorch call computes this function)")
    return {
        "name": "causal_dot_norm", "route": "cuda",
        "source": "orion_tpu_torch/csrc/causal_dot_norm.cu",
        "replaces": "orion_tpu/ops/pallas/causal_dot.py:537",
        "max_abs_err": max(r["out_max_abs"] for r in readings), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def main_path(dev, kernel_modules):
    from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate
    from orion_tpu_torch.models.configs import TINY, get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = get_config("lm_1b3")
    t0 = time.perf_counter()
    model = cast_params_for_inference(
        TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    )
    torch.cuda.synchronize()
    log(f"lm_1b3: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 1024), dtype=np.int64)
    ).to(dev)
    greedy = SampleConfig(temperature=0.0)

    generate(model, prompts[:, :128], 2, greedy)  # warm-up: cuBLAS plans, allocator
    prefill_runs = [wall_ms(lambda: generate(model, prompts, 1, greedy))[0] for _ in range(3)]

    for m in kernel_modules:
        m.launches = 0
    gen_ms, out = wall_ms(lambda: generate(model, prompts, 32, greedy))
    counts = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in kernel_modules}
    log(f"main path launches: {counts}")
    if counts["causal_dot"] != cfg.n_layers:
        raise AssertionError(f"causal_dot_norm launched {counts['causal_dot']} times "
                             f"in the prefill, want {cfg.n_layers} (one per layer)")
    if out.shape != (4, 32) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} / out-of-vocab tokens")
    prefill_ms = float(np.median(prefill_runs))
    decode_ms = (gen_ms - prefill_ms) / 31
    log(f"lm_1b3 B4 T1024: prefill (generate with 1 new token) {prefill_ms:.2f} ms "
        f"(runs {[round(x, 2) for x in prefill_runs]}); generate 32 tokens {gen_ms:.2f} ms; "
        f"decode {decode_ms:.3f} ms/token at batch 4")
    log(f"first tokens: {out[:, :8].tolist()}")

    # the kernel-backed prefill against the plain version, same weights
    ref_model = TransformerLM(dataclasses.replace(cfg, backend="torch"), device=dev)
    ref_model = cast_params_for_inference(ref_model)
    ref_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        logits, states = model.prefill_last(prompts)
        ref_logits, ref_states = ref_model.prefill_last(prompts)
    del ref_model
    if logits.shape != (4, cfg.vocab_size) or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits have the wrong shape, dtype or values")
    err = float((logits - ref_logits).abs().max())
    s_err = max(float((a["s"] - b["s"]).abs().max() / b["s"].abs().max()) for a, b in zip(states, ref_states))
    agree = int((logits.argmax(-1) == ref_logits.argmax(-1)).sum())
    # tolerance: the kernel and the plain version round each layer's
    # attention output to bf16 from fp32 sums taken in different orders; a
    # value near a rounding boundary flips by one bf16 step (2^-8 relative)
    # and the flips carry through 24 residual layers into logits of unit
    # scale
    log(f"lm_1b3 prefill logits, kernel vs backend='torch': max abs {err:.4e} (tol 0.125), "
        f"max |logit| {float(ref_logits.abs().max()):.3f}, greedy agree {agree}/4; "
        f"per-layer S max rel {s_err:.3e} (tol {LAYER_S_RTOL:g})")
    if err > 0.125 or s_err > LAYER_S_RTOL:
        raise AssertionError("kernel-backed prefill disagrees with the plain version")

    # a small model end to end: the card against the CPU's plain path
    tiny_cpu = TransformerLM(TINY, device="cpu", generator=torch.Generator().manual_seed(1))
    tiny_gpu = TransformerLM(TINY, device=dev)
    tiny_gpu.load_state_dict(tiny_cpu.state_dict())
    tp = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 100), dtype=np.int64))
    got = generate(tiny_gpu, tp.to(dev), 16, greedy)
    ref = generate(tiny_cpu, tp, 16, greedy)
    with torch.inference_mode():
        lg = tiny_gpu.prefill_last(tp.to(dev))[0].cpu()
        lc = tiny_cpu.prefill_last(tp)[0]
    tiny_err = float((lg - lc).abs().max())
    log(f"tiny fp32, card vs CPU: greedy tokens equal {bool(torch.equal(got.cpu(), ref))}, "
        f"logits max abs {tiny_err:.3e} (tol 1e-4)")
    if not torch.equal(got.cpu(), ref) or tiny_err > 1e-4:
        raise AssertionError("tiny on the card disagrees with the CPU path")
    return {
        "launches": counts, "prefill_ms": prefill_ms, "prefill_runs_ms": prefill_runs,
        "generate_32_ms": gen_ms, "decode_ms_per_token": decode_ms,
        "logits_max_abs_err": err, "state_max_rel_err": s_err, "greedy_agree": agree,
        "tiny_logits_max_abs_err": tiny_err,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 1
    from orion_tpu_torch.ops.kernels import causal_dot

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card_info()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernel_modules = [causal_dot]
    build(causal_dot)
    kernels = [check_causal_dot(causal_dot, dev)]
    path = main_path(dev, kernel_modules)
    for k in kernels:
        k["launches"] = path["launches"]["causal_dot"]
    line = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}
        for k in kernels
    ]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
