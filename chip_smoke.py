"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and ``nvcc``
(``$CUDA_HOME/bin`` or on ``PATH``). It imports nothing of JAX or of the JAX
package. Phases, each of which raises on failure (the exit code is then
nonzero and no result line is printed):

1. the card's name and power limit (``nvidia-smi``);
2. build the kernel libraries from the sources in the checkout, one nvcc
   for each of the seven sources, all started together; print ptxas'
   register, spill and shared-memory lines;
3. hold each kernel against its plain PyTorch version on the card:
   - linear attention (rows 1, 3, 4): the forward at the generate path's
     shape (B 4), then the forward with its training outputs and the two
     backward kernels at the training shape (B 8), each at T 1024, a ragged
     1000 and 1, with and without an initial state and final-state
     cotangents;
   - the public op ``causal_dot_product``'s kernels (rows 2, 5): the raw
     forward, its use as the dq pass on (g, v, k, S0^T), and the reverse
     pass, at lm_1b3's per-layer shape [B*H, T, D] = [128, 1024, 128] bf16,
     a ragged T 1000, T 1 and fp32 at D 32, with and without S0 and a
     cotangent on the final state, every output written over NaN;
   - flash attention (rows 6, 7, 8): forward, dq and dk/dv at hybrid_1b3's
     generate shape (B 4, H 16, T 1536, D 128, bf16, window 1024) and
     training shape (B 8, T 2048), a ragged T 2000, T 1, T 512 (below the
     window), causal without a window, bidirectional, and the tiny widths
     (D 32, fp32);
   - the grouped expert matmul (rows 9, 10): forward, dx (against w^T) and
     dw at moe_1b3_4e's training shape (8192 routed rows, d 2048, h 5504, 4
     experts) for the gate/up and the down products, the prefill shape (4096
     rows), top-2 routing, an expert without rows, N and K past the tiles
     (d 100, h 200), and fp32 at the tiny widths;
   - the int4 dequant-matmul (row 14): lm_1b3's decode shapes (x [4, 2048]
     against p [1024, 2048] and [1024, 5504], x [4, 5504] against p [2752,
     2048]), B 1, B 64, an out of 200 (no whole strip), a ragged d 100, and
     fp32;
   - the fused Adafactor passes (rows 11-13): sums, squared sum and apply at
     lm_1b3's factored shapes ([32000, 2048], [5504, 2048], [2048, 5504],
     [2048, 2048]) and ragged m and n, each gradient with an all-zero row and
     column, apply with the flag 0 (p bitwise untouched);
   time every kernel, its plain version and, where one PyTorch call computes
   the same function, that call (``scaled_dot_product_attention``,
   ``torch._grouped_mm``; none for rows 1-5 and 11-14), each by CUDA events over
   calls back to back (``cuda_ms``), and for rows 11-14 also the kernel's
   device time alone (``graph_ms``); print each kernel's bound beside its
   time;
4. the public op ``orion_tpu_torch.ops.causal_dot_product``, forward and
   backward through ``CausalDotProductFn`` at [B 8, H 16, T 1024, D 128]
   bf16 with an initial state and the returned state: exact launches (row 2
   twice, row 5 once, with every count set to 0 just before), out, S and
   every gradient against the plain form differentiated by autograd;
5. the generate path, for ``lm_1b3`` (4 prompts of 1024 byte tokens, 32
   greedy new tokens), for ``hybrid_1b3`` (4 prompts of 1536, longer than
   its window, 64 tokens) and for ``moe_1b3_4e`` with ``moe_dropless=True``
   (4 prompts of 1024, 32 tokens): ``orion_tpu_torch.generate.generate`` at full
   width (seeded random weights), with every kernel's launch count reset
   just before and read just after; the prefill's logits and every layer's
   decode state against a ``backend="torch"`` run of the same weights on the
   card; and a ``tiny`` model of the same layer kinds on the card against
   the same model on the CPU, whose plain path the CPU tests hold against
   the JAX package;
6. the training path, for ``lm_1b3`` (batch 8 x 1024), ``hybrid_1b3``
   (batch 8 x 2048) and the dropless ``moe_1b3_4e`` (batch 8 x 1024):
   ``Trainer`` at full width, synthetic data, AdamW, remat
   as the config sets it, 1 warm-up and 3 timed steps, with the counts reset
   just before and read after every step (exact counts per step, from the
   layer kinds and the rematerialized blocks); then one batch's loss and
   every parameter's gradient through the kernels against
   ``backend="torch"`` on the same weights (every parameter must get a
   gradient); then 3 ``tiny`` fp32 steps on the card against the CPU (for
   the MoE a tiny MoE in its capacity and its dropless form, the latter at
   1024 routed rows, so the card takes the gmm kernels in fp32 and the CPU
   the ragged form);
7. quantized serving: ``generate(..., quant=...)`` of ``lm_1b3`` at int4 and
   int8 and of the dropless ``moe_1b3_4e`` at int4 (4 prompts of 1024, 32
   greedy tokens; weights quantized once from seeded fp32 ones), exact launch
   counts (one q4 launch per int4 layer and decode step: 168 for lm_1b3, 150
   for the MoE, whose expert stacks stay int8; none in the prefill or at
   int8), the prefill's and 8 decode steps' logits against
   ``backend="torch"`` on the same quantized weights; ``tiny`` and a tiny
   hybrid at int4 in fp32, the card (the kernel) against the CPU (the split
   form);
8. Adafactor: ``lm_1b3`` training with ``optimizer="adafactor_fused"`` (batch
   8 x 1024, 1 warm-up and 3 timed steps; each pass once for each of the 170
   large matrices a step, the sums and the squared sum two launches a call:
   340, 340 and 170 launches), one update through the kernels against the
   plain formulas on the same params and gradients, and 3 ``tiny`` fp32
   steps on the card against the CPU with every factored leaf sent through
   the kernels;
9. train -> checkpoint -> generate: that trainer's whole state saved with
   the Trainer's ``Checkpointer`` into a temporary directory (free disk
   checked first; removed after), its params loaded with
   ``generate.load_model`` (memory-mapped, manifest-verified), and
   ``generate`` of 4 x 1024 prompts for 32 greedy tokens from the loaded
   model, in bf16 and at int4, against the same from the in-memory trained
   model: tokens and prefill logits bitwise, exact launches (row 14 at
   int4); save and load seconds;
10. a ``kernels`` JSON line (14 kernels), then the result line
   ``{"ok": true, "device": {...}}`` last.
"""

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM
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
# A layer's decode state after the kernel-backed prefill against the plain
# one, relative to its largest element: each layer's input differs by the
# bf16 roundings of the layers below. S sums k (x) v over the prompt, which
# averages those differences out; a K or V element is one bf16 projection
# of the layer's input and keeps them, as the logits at the top of the same
# stack do (0.125 of logits near 4: 3 %)
LAYER_S_RTOL, LAYER_KV_RTOL = 5e-3, 3e-2
# The backward kernels against their plain versions, on the same inputs.
# dq, dk, dv (bf16): both sum exact products in fp32 and round once, so a
# value lands on the plain version's bf16 neighbour at worst (2^-7 |ref|).
# Beside it an absolute term for elements near zero, where the numerator's
# and the denominator's parts cancel: the fp32 sums run over some 200 terms
# that may be 100x the result, so the order of summation moves them by
# about sqrt(200) x 2^-24 x 100 max|ref| ~ 1e-5 max|ref|; the limit allows
# 1e-4 max|ref|. num, den, dS0, dz0 (fp32): sums in another order, within
# 1e-4 of their largest magnitude. ``kernel_mutants.py`` shows which wrong
# kernels these limits reject.
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2**-7, 1e-4
# Flash attention (rows 6-8) against its plain version, on the same inputs.
# out, dq, dk, dv: in bf16 one bf16 step (2^-7 |ref|), as above: both sum
# exact products in fp32 and round once; in fp32 1e-4 |ref| (sums in
# another order). Beside it 1e-4 max|ref| for elements near zero (in dS =
# P (dP - delta) the two terms cancel), and for the gradients a floor of
# 1e-5: where a gradient vanishes in exact arithmetic (T 1: a row's only key
# gives dP = delta), the kernel's dP and torch's delta are two fp32 dot
# products of unit-scale inputs summed in other orders, about 1e-6 apart
# at D 128.
# lse (fp32): within 1e-5 of max(1, |lse|): a sum of up to 1024 exps in
# another order moves it by about 1e-6.
FLASH_RTOL = {torch.bfloat16: 2**-7, torch.float32: 1e-4}
FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR, LSE_RTOL = 1e-4, 1e-5, 1e-5
# The loss and parameter gradients through the kernels against
# backend="torch" (autograd through the plain forms) on one batch. The
# kernel path rounds each layer's attention output to bf16 from sums in
# another order (forward), and the linear layers round d out / d num to
# bf16 before the backward products, as the JAX package does (the plain
# path keeps it fp32): about 2^-9 relative per element, averaged over the
# tokens each weight gradient sums, and carried through 24 layers. Limits:
# the loss within 1e-2 absolute (a mean of token losses near 10.4), every
# parameter's gradient within 5e-2 of its norm (relative L2 error).
LM_LOSS_ATOL, LM_GRAD_REL_L2 = 1e-2, 5e-2
# The prefill's logits through the kernels against backend="torch": each
# layer's attention output is rounded to bf16 from fp32 sums taken in
# different orders; a value near a rounding boundary flips by one bf16 step
# (2^-8 relative) and the flips carry through 24 residual layers into
# logits of unit scale
LOGITS_ATOL = 0.125
# tiny fp32: the card's logits and 3 training losses against the CPU's
TINY_LOGITS_ATOL, TINY_LOSS_ATOL = 1e-4, 1e-4
# The grouped matmul (rows 9, 10) against its plain version, on the same
# inputs. y and dx (bf16): both sum exact products in fp32 and round once, so
# a value lands on the plain version's bf16 neighbour at worst (2^-7 |ref|;
# fp32 inputs: 1e-4 |ref|, sums in another order). Beside it an absolute term
# for elements near zero: a sum over K <= 5504 products in another order
# moves by about K x 2^-24 times a product's typical size, |y| / sqrt(K):
# 4.4e-6 of |y| at K 5504; the limit allows 1e-4 max|ref|. dw (fp32): sums
# of exact products over an expert's rows in another order, within 1e-4 of
# the expert's largest magnitude; an expert without rows exactly 0 (its
# output's memory held NaN before the call). ``kernel_mutants.py`` shows
# which wrong kernels these limits reject.
GMM_RTOL = {torch.bfloat16: 2**-7, torch.float32: 1e-4}
GMM_ATOL_OF_MAX, GMM_DW_RTOL_OF_MAX = 1e-4, 1e-4

# The int4 dequant-matmul (row 14) against its plain version, on the same
# inputs. Both sum exact products (an int4 value times a bf16 or fp32 x is
# exact in fp32) in fp32 and round once to x's dtype, so a bf16 output lands
# on the plain version's bf16 neighbour at worst (2^-7 |ref|; fp32 outputs:
# 1e-4 |ref|, sums in another order). Beside it 1e-4 max|ref| for outputs
# near zero: a sum of d <= 5504 products in another order moves by about
# sqrt(d) 2^-24 times a product's size, |y| / sqrt(d): 6e-8 of max|y|. Every
# output is written (its memory held NaN before the call).
Q4_RTOL = {torch.bfloat16: 2**-7, torch.float32: 1e-4}
Q4_ATOL_OF_MAX = 1e-4
# Fused Adafactor (rows 11-13) against the plain versions, on the same inputs.
# The sums of q = g g s2 + eps are positive fp32 sums of up to 32000 terms in
# another order: each within 1e-4 relative of the plain sum (the kernel's
# sequential runs of at most 122 rows and 263 partials bound the error by
# about 400 x 2^-24 = 2.4e-5); an all-zero row's or column's sum is eps x n
# alone, which a kernel dropping eps would make 0, a relative error of 1. The
# squared sum within 1e-4 relative, likewise. apply rounds as the plain
# version does ((g r) c, then p + u, no FMA): within 1e-6 relative of it (0
# expected); with the flag 0, p stays bitwise as it was.
AF_SUM_RTOL, AF_RMS_RTOL, AF_APPLY_RTOL = 1e-4, 1e-4, 1e-6
# A quantized model's logits through the kernels against backend="torch" on
# the same quantized weights, after the prefill and after each of 8 decode
# steps fed the kernel run's tokens: the int4 layers' kernel sums both halves
# in fp32 and rounds once, the split form rounds each half product and their
# sum to bf16 (about 2^-8 relative each), and the attention kernels differ as
# in the bf16 model: the same limit as its prefill logits.
QUANT_LOGITS_ATOL = LOGITS_ATOL
# One Adafactor update of lm_1b3's params through the kernels against the
# plain formulas (optimizer="adafactor") on the same params, gradients and
# state: the JAX package's own tolerance for its fused form against optax
# (sums in another order, rsqrt for ** -0.5): params within 2e-5 relative
# plus 1e-7. The statistics within 2e-5 relative plus 1e-6 of the leaf's
# largest value: a clipped gradient of lm_1b3's 1.3 G params has a mean
# square near 1e-9, so a fixed absolute term would be as large as the values
# it holds (and the params cannot stand in: update clipping cancels a
# uniform error in v wherever it binds).
AF_PARAM_RTOL, AF_PARAM_ATOL, AF_STAT_ATOL_OF_MAX = 2e-5, 1e-7, 1e-6
# The public op's kernels (rows 2, 5) against their plain versions, on the
# same inputs, and the op's forward + backward through them against the plain
# form differentiated by autograd. out and dq (the input dtype): both sum
# exact products in fp32 and round once, so a value lands on the plain
# version's neighbour at worst: one step of the dtype, 2^-7 |ref| in bf16
# (1e-4 |ref| in fp32, sums in another order). dk, dv (fp32, rows 5's
# outputs): 1e-4 |ref|. Beside each, 1e-4 max|ref| for elements near zero:
# an element sums up to 1024 terms of random sign that may be 30x the result,
# and the order of summation moves it by about sqrt(1024) x 2^-24 x 30
# max|ref| ~ 6e-6 max|ref|. S, dS0 (fp32): within STATE_RTOL of their
# largest magnitude. Every output is written (its memory held NaN before the
# call). ``kernel_mutants.py`` shows which wrong kernels these limits reject.
RAW_RTOL = {torch.bfloat16: 2**-7, torch.float32: 1e-4}
RAW_ATOL_OF_MAX = 1e-4

KERNELS = ("causal_dot_norm", "causal_dot", "causal_dot_dq_den", "causal_dot_rev_den",
           "causal_dot_rev", "flash_fwd", "flash_dq", "flash_dkv", "gmm_fwd", "gmm_dw", "q4_matmul",
           "adafactor_sums", "adafactor_rms", "adafactor_apply")


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


def graph_ms(fn, iters):
    """Mean device time of ``fn(i)`` over calls i = 0 .. iters - 1 captured
    in one CUDA graph and replayed: no host work between the launches. A
    field beside ``ms`` (``cuda_ms``, every row's time) for rows 11-14, whose
    wrappers' host time can exceed the kernel's. ``fn`` picks its inputs by
    ``i`` from ``cold_copies``, so each launch finds them in HBM, as the main
    path does. Warmed up on the capture stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


L2_BYTES = 50 * 2**20  # H100 SXM


def cold_copies(t):
    """``t`` and clones of it, together at least twice the L2 cache: calls
    that cycle through them read each from HBM."""
    k = max(1, -(-2 * L2_BYTES // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(k - 1)]


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
    return line


def build(modules):
    """Build the kernel libraries of ``modules`` (each with ``SOURCES``),
    one nvcc for each source, all started together; print each build's time
    and ptxas lines."""
    from orion_tpu_torch.ops.kernels import library

    sources = [src for m in modules for src in m.SOURCES.values()]

    def one(src):
        t = time.perf_counter()
        path, out = library.build(src)
        return src, path, out, time.perf_counter() - t

    with ThreadPoolExecutor(len(sources)) as pool:
        for src, path, out, sec in pool.map(one, sources):
            log(f"built {path.name} from {src.relative_to(ROOT)} in {sec:.1f} s")
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log("  ptxas:", line.strip())


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _bound(moved, flops, peak=BF16_FLOPS):
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# ---------------------------------------------------------------------------
# Linear attention: rows 1, 3, 4
# ---------------------------------------------------------------------------


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
    bound_ms, bound_by = _bound(moved, flops)
    log(f"causal_dot_norm timing B4 H16 T1024 D128 bf16 (generate): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP); library_ms: none (no single PyTorch call computes this "
        "function)")


def _grad_reading(got, ref, rtol=GRAD_RTOL, atol_of_max=GRAD_ATOL_OF_MAX, floor=0.0):
    """A gradient against its plain version: the largest |got - ref|, and as
    a share of the limit floor + atol_of_max max|ref| + rtol |ref| (above 1
    fails); ``atol_needed``: the smallest absolute term, as a share of
    max|ref|, that this tensor alone would need beside ``rtol``."""
    diff, r = (got.float() - ref.float()).abs(), ref.float().abs()
    rmax = float(r.max().clamp_min(1e-30))
    return {
        "max_abs": float(diff.max()), "ref_max_abs": rmax,
        "over_limit": float((diff / (floor + atol_of_max * rmax + rtol * r)).max()),
        "atol_needed": float((diff - rtol * r).clamp_min(0).max()) / rmax,
        "well_formed": got.shape == ref.shape and got.dtype == ref.dtype
        and bool(torch.isfinite(got.float()).all()),
    }


def _training_case(g, dev, b, h, t, with_state):
    """Inputs of one linear layer's training step at D 128, bf16: q, k
    phi-mapped, v, the output's cotangent; with ``with_state`` also an
    initial state (a 256-token prefix's) and cotangents of the final state
    at the scale of what the walk itself accumulates (about 0.05)."""
    bh, d = b * h, 128

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    q = phi(torch.randn(bh, t, d, device=dev, generator=g)).bfloat16()
    k = phi(torch.randn(bh, t, d, device=dev, generator=g)).bfloat16()
    v = torch.randn(bh, t, d, device=dev, generator=g).bfloat16()
    gout = torch.randn(bh, t, d, device=dev, generator=g).bfloat16()
    s0 = z0 = gsf = gzf = None
    if with_state:
        kp = phi(torch.randn(bh, 256, d, device=dev, generator=g)).bfloat16().float()
        vp = torch.randn(bh, 256, d, device=dev, generator=g).bfloat16().float()
        s0, z0 = kp.transpose(1, 2) @ vp, kp.sum(1)
        gsf = 0.05 * torch.randn(bh, d, d, device=dev, generator=g)
        gzf = 0.05 * torch.randn(bh, d, device=dev, generator=g)
    return q, k, v, gout, s0, z0, gsf, gzf


def compare_training_kernels(cd, dev):
    """Rows 1 (with its training outputs num, den), 3 and 4 against their
    plain versions on the card, at the lm_1b3 training shape (B 8, H 16, D
    128, bf16): T 1024, a ragged 1000 and 1, each without and with an
    initial state and final-state cotangents. The backward kernels and their
    plain versions take the same inputs: the plain forward's num and den
    through ``quotient_rule``. Returns one reading per case and the first
    case's backward inputs."""
    g = torch.Generator(device=dev).manual_seed(1)
    readings, first = [], None
    for t in (1024, 1000, 1):
        for with_state in (False, True):
            q, k, v, gout, s0, z0, gsf, gzf = _training_case(g, dev, 8, 16, t, with_state)
            out, sf, zf, num, den = cd.causal_dot_norm_cuda(q, k, v, s0, z0, with_parts=True)
            r_out, r_sf, r_zf, r_num, r_den = cd.causal_dot_norm_plain(
                q, k, v, s0, z0, with_parts=True)
            gnum, gden = cd.quotient_rule(gout, r_num, r_den, 1e-6, q.dtype)
            dq = cd.causal_dot_dq_den_cuda(gnum, v, k, gden, s0, z0)
            dk, dv, ds0, dz0 = cd.causal_dot_rev_den_cuda(q, k, v, gnum, gden, gsf, gzf)
            torch.cuda.synchronize()
            r_dq = cd.causal_dot_dq_den_plain(gnum, v, k, gden, s0, z0)
            r_dk, r_dv, r_ds0, r_dz0 = cd.causal_dot_rev_den_plain(q, k, v, gnum, gden, gsf, gzf)
            readings.append({
                "case": f"B8 H16 T{t} D128 bf16 state={with_state}",
                "out": _grad_reading(out, r_out),
                "num_rel": _rel(num, r_num), "den_rel": _rel(den, r_den),
                "dq": _grad_reading(dq, r_dq), "dk": _grad_reading(dk, r_dk),
                "dv": _grad_reading(dv, r_dv),
                "ds0_rel": _rel(ds0, r_ds0), "dz0_rel": _rel(dz0, r_dz0),
                "states_finite": all(bool(torch.isfinite(x).all()) for x in (num, den, ds0, dz0)),
            })
            if first is None:
                first = (q, k, v, gnum, gden)
    return readings, first


def agrees_training(r):
    return (r["states_finite"] and r["out"]["well_formed"]
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0 for n in ("dq", "dk", "dv"))
            and r["out"]["max_abs"] <= OUT_ATOL + OUT_RTOL * r["out"]["ref_max_abs"]
            and max(r["num_rel"], r["den_rel"], r["ds0_rel"], r["dz0_rel"]) <= STATE_RTOL)


def check_training_kernels(cd, dev):
    readings, (q, k, v, gnum, gden) = compare_training_kernels(cd, dev)
    for r in readings:
        log(f"training kernels {r['case']}: "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("dq", "dk", "dv"))
            + f"; out max abs {r['out']['max_abs']:.3e}; rel: num {r['num_rel']:.2e} "
            f"den {r['den_rel']:.2e} dS0 {r['ds0_rel']:.2e} dz0 {r['dz0_rel']:.2e} "
            f"(limit {STATE_RTOL:g})")
        if not agrees_training(r):
            raise AssertionError(f"a training kernel disagrees with its plain version: {r}")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    c, act, f32 = 64, q.numel() * q.element_size(), 4
    ops = 2 * bh * t * (c * dk + c * dv + 2 * dk * dv)  # one chunk walk's products
    lines = []
    with torch.no_grad():
        specs = [
            ("causal_dot_norm", "orion_tpu_torch/csrc/causal_dot_norm.cu",
             "orion_tpu/ops/pallas/causal_dot.py:537",
             lambda: cd.causal_dot_norm_cuda(q, k, v, with_parts=True),
             lambda: cd.causal_dot_norm_plain(q, k, v, with_parts=True),
             # q, k, v read; out, S, z, num, den written
             4 * act + bh * dk * dv * f32 + bh * dk * f32 + bh * t * dv * f32 + bh * t * f32,
             ops),
            ("causal_dot_dq_den", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
             "orion_tpu/ops/pallas/causal_dot.py:298",
             lambda: cd.causal_dot_dq_den_cuda(gnum, v, k, gden),
             lambda: cd.causal_dot_dq_den_plain(gnum, v, k, gden),
             # g, v, k, gden read; dq written
             4 * act + bh * t * f32, ops),
            ("causal_dot_rev_den", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
             "orion_tpu/ops/pallas/causal_dot.py:335",
             lambda: cd.causal_dot_rev_den_cuda(q, k, v, gnum, gden),
             lambda: cd.causal_dot_rev_den_plain(q, k, v, gnum, gden),
             # q, k, v, g, gden read; dk, dv, dS0, dz0 written
             6 * act + bh * t * f32 + bh * dk * dv * f32 + bh * dk * f32, 2 * ops),
        ]
        for name, source, replaces, kernel, plain, moved, flops in specs:
            ms = cuda_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 3)
            bound_ms, bound_by = _bound(moved, flops)
            log(f"{name} timing B8 H16 T1024 D128 bf16 (training): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
                "library_ms: none (no single PyTorch call computes this function)")
            lines.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": max(
                    r[n]["max_abs"] for r in readings
                    for n in ({"causal_dot_norm": ("out",), "causal_dot_dq_den": ("dq",)}
                              .get(name, ("dk", "dv")))),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
            })
    return lines


# ---------------------------------------------------------------------------
# The public op causal_dot_product: rows 2, 5
# ---------------------------------------------------------------------------

# (label, B, H, T, D, dtype, initial state S0, cotangent dSf of the final
# state): lm_1b3's per-layer shape [B*H, T, D] = [128, 1024, 128] and the
# edges of the kernels' loops
RAW_CASES = [
    ("B8 H16 T1024 D128 bf16", 8, 16, 1024, 128, torch.bfloat16, False, False),
    ("B8 H16 T1024 D128 bf16 S0 dSf", 8, 16, 1024, 128, torch.bfloat16, True, True),
    ("B8 H16 T1000 D128 bf16 S0 (ragged)", 8, 16, 1000, 128, torch.bfloat16, True, False),
    ("B8 H16 T1 D128 bf16 dSf", 8, 16, 1, 128, torch.bfloat16, False, True),
    ("B2 H4 T200 D32 fp32 S0 dSf", 2, 4, 200, 32, torch.float32, True, True),
    ("B2 H4 T70 D32 fp32", 2, 4, 70, 32, torch.float32, False, False),
]


def _raw_inputs(g, dev, b, h, t, d, dtype, with_s0, with_gsf):
    """q, k phi-mapped, v, the output's cotangent; S0 the state a 256-token
    prefix leaves; dSf at the scale of what the reverse walk itself sums
    (R grows as sqrt(T) per element)."""
    bh = b * h

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    q = phi(torch.randn(bh, t, d, device=dev, generator=g)).to(dtype)
    k = phi(torch.randn(bh, t, d, device=dev, generator=g)).to(dtype)
    v = torch.randn(bh, t, d, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, t, d, device=dev, generator=g).to(dtype)
    s0 = gsf = None
    if with_s0:
        kp = phi(torch.randn(bh, 256, d, device=dev, generator=g)).to(dtype).float()
        vp = torch.randn(bh, 256, d, device=dev, generator=g).to(dtype).float()
        s0 = kp.transpose(1, 2) @ vp
    if with_gsf:
        gsf = 8.0 * torch.randn(bh, d, d, device=dev, generator=g)
    return q, k, v, gout, s0, gsf


def _nan_junk(dev, *shapes_dtypes):
    """Empty the allocator's cache, then hand it NaN blocks of these shapes
    and dtypes, in the order a wrapper allocates its scratch and outputs:
    the wrapper's ``torch.empty`` calls then take exactly these blocks, so an
    element the kernel leaves unwritten reads NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full(s, float("nan"), dtype=dt, device=dev) for s, dt in shapes_dtypes]
    del junk


def compare_raw(cd, dev):
    """Rows 2 and 5 against their plain versions on the card, on
    ``RAW_CASES``: the forward (out, S), the dq pass (row 2 on (g, v, k)
    with S0^T carried in, as the op's backward runs it) and the reverse pass
    (dk, dv, dS0, seeded by dSf^T or zeros). Returns one reading per case
    and the first case's inputs."""
    g = torch.Generator(device=dev).manual_seed(21)
    readings, first = [], None
    for label, b, h, t, d, dtype, with_s0, with_gsf in RAW_CASES:
        q, k, v, gout, s0, gsf = _raw_inputs(g, dev, b, h, t, d, dtype, with_s0, with_gsf)
        bh, f32 = b * h, torch.float32
        s0t = s0.transpose(1, 2).contiguous() if s0 is not None else None
        _nan_junk(dev, ((bh, t, d), dtype), ((bh, d, d), f32))
        out, sf = cd.causal_dot_cuda(q, k, v, s0)
        _nan_junk(dev, ((bh, t, d), dtype), ((bh, d, d), f32))
        dq, _ = cd.causal_dot_cuda(gout, v, k, s0t)
        _nan_junk(dev, ((bh, t, d), f32), ((bh, t, d), f32), ((bh, d, d), f32))
        dk, dv, ds0 = cd.causal_dot_rev_cuda(q, k, v, gout, gsf)
        torch.cuda.synchronize()
        r_out, r_sf = cd.causal_dot_plain(q, k, v, s0)
        r_dq, _ = cd.causal_dot_plain(gout, v, k, s0t)
        r_dk, r_dv, r_ds0 = cd.causal_dot_rev_plain(q, k, v, gout, gsf)
        rt = RAW_RTOL[dtype]
        readings.append({
            "case": label,
            "out": _grad_reading(out, r_out, rt, RAW_ATOL_OF_MAX),
            "dq": _grad_reading(dq, r_dq, rt, RAW_ATOL_OF_MAX),
            "dk": _grad_reading(dk, r_dk, RAW_RTOL[f32], RAW_ATOL_OF_MAX),
            "dv": _grad_reading(dv, r_dv, RAW_RTOL[f32], RAW_ATOL_OF_MAX),
            "s_rel": _rel(sf, r_sf), "ds0_rel": _rel(ds0, r_ds0),
            "states_finite": bool(torch.isfinite(sf).all() and torch.isfinite(ds0).all()),
        })
        if first is None:
            first = (q, k, v, gout)
    return readings, first


def agrees_raw(r):
    return (r["states_finite"] and max(r["s_rel"], r["ds0_rel"]) <= STATE_RTOL
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0
                    for n in ("out", "dq", "dk", "dv")))


def check_raw(cd, dev):
    """Rows 2 and 5 against their plain versions, then each timed at the
    main path's shape [128, 1024, 128] bf16: row 2 as the op's forward (no
    initial state), row 5 seeded by dSf. Returns their ``kernels`` lines."""
    readings, (q, k, v, gout) = compare_raw(cd, dev)
    for r in readings:
        log(f"causal_dot / causal_dot_rev {r['case']}: "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("out", "dq", "dk", "dv"))
            + f"; rel: S {r['s_rel']:.2e} dS0 {r['ds0_rel']:.2e} (limit {STATE_RTOL:g})")
        if not agrees_raw(r):
            raise AssertionError(f"a raw causal_dot kernel disagrees with its plain version: {r}")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    act, f32 = q.numel() * q.element_size(), 4
    gsf = 8.0 * torch.randn(bh, dk, dv, device=dev)
    ops = 2 * bh * t * (64 * dk + 64 * dv + 2 * dk * dv)  # one chunk walk's products
    specs = [
        ("causal_dot", "orion_tpu_torch/csrc/causal_dot_norm.cu",
         "orion_tpu/ops/pallas/causal_dot.py:123",
         lambda: cd.causal_dot_cuda(q, k, v), lambda: cd.causal_dot_plain(q, k, v),
         # q, k, v read; out, S written
         4 * act + bh * dk * dv * f32, ops, ("out", "dq")),
        ("causal_dot_rev", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
         "orion_tpu/ops/pallas/causal_dot.py:377",
         lambda: cd.causal_dot_rev_cuda(q, k, v, gout, gsf),
         lambda: cd.causal_dot_rev_plain(q, k, v, gout, gsf),
         # q, k, v, g, dSf read; fp32 dk, dv, dS0 written
         4 * act + 2 * bh * dk * dv * f32 + bh * t * (dk + dv) * f32, 2 * ops, ("dk", "dv")),
    ]
    lines = []
    for name, source, replaces, kernel, plain, moved, flops, outs in specs:
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = _bound(moved, flops)
        log(f"{name} timing B8 H16 T1024 D128 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, {flops / 1e9:.2f} "
            "GFLOP); library_ms: none (no single PyTorch call computes this function)")
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max(r[n]["max_abs"] for r in readings for n in outs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    return lines


def op_phase(dev, mods):
    """The public op ``orion_tpu_torch.ops.causal_dot_product``, forward and
    backward, at lm_1b3's per-layer shape [B 8, H 16, T 1024, D 128] bf16
    with an initial state and the returned state: exact launches (row 2
    twice, row 5 once; the counts set to 0 just before), then the same
    through the plain form differentiated by autograd (backend="torch"):
    out, S and every gradient within the kernels' limits; both timed."""
    from orion_tpu_torch.ops import causal_dot_product

    g = torch.Generator(device=dev).manual_seed(22)
    b, h, t, d = 8, 16, 1024, 128
    q0, k0, v0, gout, s00, gsf = (
        x.reshape(b, h, *x.shape[1:])
        for x in _raw_inputs(g, dev, b, h, t, d, torch.bfloat16, True, True))

    def run(backend):
        q, k, v, s0 = (x.clone().requires_grad_() for x in (q0, k0, v0, s00))
        out, sf = causal_dot_product(q, k, v, backend=backend, return_state=True,
                                     initial_state=s0)
        ((out.float() * gout.float()).sum() + (sf * gsf).sum()).backward()
        return [x.detach() for x in (out, sf, q.grad, k.grad, v.grad, s0.grad)]

    _reset_counts(mods)
    got = run("cuda")
    torch.cuda.synchronize()
    counts = _counts(mods)
    want = dict.fromkeys(KERNELS, 0)
    want.update(causal_dot=2, causal_dot_rev=1)
    log(f"causal_dot_product forward + backward launches: {counts}")
    if counts != want:
        raise AssertionError(f"the public op launched {counts}, want {want}")
    ref = run("torch")
    errs = {}
    for name, x, r in zip(("out", "S", "dq", "dk", "dv", "dS0"), got, ref):
        if x.dtype == torch.bfloat16:
            errs[name] = _grad_reading(x, r, RAW_RTOL[torch.bfloat16], RAW_ATOL_OF_MAX)
        else:
            errs[name] = {"max_abs": float((x - r).abs().max()), "rel": _rel(x, r),
                          "well_formed": x.shape == r.shape and bool(torch.isfinite(x).all())}
    ms = cuda_ms(lambda: run("cuda"), 5)
    plain_ms = cuda_ms(lambda: run("torch"), 3)
    log("causal_dot_product fwd + bwd through the kernels vs backend='torch' (autograd of the "
        "plain form): " + "; ".join(
            f"{n} max abs {e['max_abs']:.3e} ("
            + (f"{e['over_limit']:.3f} of its limit" if "over_limit" in e
               else f"rel {e['rel']:.2e}, limit {STATE_RTOL:g}") + ")"
            for n, e in errs.items())
        + f"; {ms:.3f} ms against the plain form's {plain_ms:.3f} ms (fwd + bwd, B8 H16 T1024 "
        "D128 bf16)")
    if not all(e["well_formed"] and e.get("over_limit", 0.0) <= 1.0
               and e.get("rel", 0.0) <= STATE_RTOL for e in errs.values()):
        raise AssertionError(f"the public op disagrees with backend='torch': {errs}")
    return {"launches": counts, "errs": errs, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# Flash attention: rows 6, 7, 8
# ---------------------------------------------------------------------------

# (label, B, H, T, D, dtype, causal, window): hybrid_1b3's shapes and the
# edges of the kernels' loops
FLASH_CASES = [
    ("generate", 4, 16, 1536, 128, torch.bfloat16, True, 1024),
    ("training", 8, 16, 2048, 128, torch.bfloat16, True, 1024),
    ("ragged", 2, 16, 2000, 128, torch.bfloat16, True, 1024),
    ("T1", 8, 16, 1, 128, torch.bfloat16, True, 1024),
    ("below the window", 8, 16, 512, 128, torch.bfloat16, True, 1024),
    ("causal, no window", 4, 16, 2048, 128, torch.bfloat16, True, None),
    ("bidirectional", 4, 16, 1024, 128, torch.bfloat16, False, None),
    ("tiny widths", 2, 4, 300, 32, torch.float32, True, 16),
]


def _flash_inputs(g, dev, b, h, t, d, dtype):
    """q, k, v at unit scale and the output's cotangent, [B*H, T, D]."""
    return [torch.randn(b * h, t, d, device=dev, generator=g).to(dtype) for _ in range(4)]


def _pairs(t, causal, window):
    """The (q, k) pairs a [t, t] mask keeps: the work of each kernel."""
    rows = np.arange(t)
    lo = np.maximum(0, rows - window + 1) if window is not None else np.zeros(t, np.int64)
    hi = rows + 1 if causal else np.full(t, t)
    return int((hi - lo).sum())


def compare_flash(fa, dev):
    """Rows 6-8 against their plain versions on the card. The backward
    kernels and their plain versions take the same inputs: the plain
    forward's lse and delta = rowsum(g . out). Returns one reading per case
    and the inputs of each case by label."""
    g = torch.Generator(device=dev).manual_seed(6)
    readings, inputs = [], {}
    for label, b, h, t, d, dtype, causal, window in FLASH_CASES:
        q, k, v, gout = _flash_inputs(g, dev, b, h, t, d, dtype)
        opts = dict(causal=causal, window=window)
        out, lse = fa.flash_fwd_cuda(q, k, v, **opts)
        r_out, r_lse = fa.flash_fwd_plain(q, k, v, **opts)
        delta = (gout.float() * r_out.float()).sum(-1, keepdim=True)
        dq = fa.flash_dq_cuda(q, k, v, gout, r_lse, delta, **opts)
        dk, dv = fa.flash_dkv_cuda(q, k, v, gout, r_lse, delta, **opts)
        torch.cuda.synchronize()
        r_dq = fa.flash_dq_plain(q, k, v, gout, r_lse, delta, **opts)
        r_dk, r_dv = fa.flash_dkv_plain(q, k, v, gout, r_lse, delta, **opts)
        rtol = FLASH_RTOL[dtype]
        lse_diff = (lse - r_lse).abs()
        readings.append({
            "case": f"{label}: B{b} H{h} T{t} D{d} {str(dtype)[6:]} causal={causal} "
                    f"window={window}",
            "out": _grad_reading(out, r_out, rtol, FLASH_ATOL_OF_MAX),
            "dq": _grad_reading(dq, r_dq, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dk": _grad_reading(dk, r_dk, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dv": _grad_reading(dv, r_dv, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "lse_max_abs": float(lse_diff.max()),
            "lse_over_limit": float((lse_diff / (LSE_RTOL * r_lse.abs().clamp_min(1.0))).max()),
            "lse_well_formed": lse.shape == (b * h, t, 1) and lse.dtype == torch.float32
            and bool(torch.isfinite(lse).all()),
        })
        inputs[label] = (q, k, v, gout, r_lse, delta, opts)
        del out, lse, r_out, dq, dk, dv, r_dq, r_dk, r_dv
    return readings, inputs


def agrees_flash(r):
    return (r["lse_well_formed"] and r["lse_over_limit"] <= 1.0
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0
                    for n in ("out", "dq", "dk", "dv")))


def _sdpa_mask(t, causal, window, dev):
    """The boolean mask scaled_dot_product_attention takes for a band (True =
    attend), or None with ``is_causal`` for plain causal."""
    if window is None:
        return None
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(t, device=dev)[None, :]
    m = (rows - cols) < window
    return m & (rows >= cols) if causal else m


def check_flash(fa, dev):
    """Rows 6-8: agreement on every case, then timings at hybrid_1b3's
    generate shape (row 6) and training shape (rows 6-8), each beside its
    bound, its plain version and scaled_dot_product_attention under the same
    mask (the backward timed as one call, for rows 7 and 8 together)."""
    readings, inputs = compare_flash(fa, dev)
    for r in readings:
        log(f"flash {r['case']}: "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("out", "dq", "dk", "dv"))
            + f"; lse max abs {r['lse_max_abs']:.3e} ({r['lse_over_limit']:.3f} of its limit)")
    bad = [r for r in readings if not agrees_flash(r)]
    if bad:
        raise AssertionError(f"a flash kernel disagrees with its plain version: {bad}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    with torch.no_grad():
        for label in ("generate", "training", "causal, no window"):
            q, k, v, gout, lse, delta, opts = inputs[label]
            bh, t, d = q.shape
            b = bh // 16
            q4, k4, v4 = (x.view(b, bh // b, t, d) for x in (q, k, v))
            mask = _sdpa_mask(t, opts["causal"], opts["window"], dev)
            lib = (lambda: sdpa(q4, k4, v4, attn_mask=mask)) if mask is not None else (
                lambda: sdpa(q4, k4, v4, is_causal=True))
            act = q.numel() * q.element_size()
            pairs = bh * _pairs(t, opts["causal"], opts["window"])
            row = {"fwd": dict(
                ms=cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, **opts), 10),
                plain_ms=cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **opts), 2),
                library_ms=cuda_ms(lib, 10),
                # q, k, v read; out, lse written
                moved=4 * act + bh * t * 4, flops=4 * d * pairs)}
            if label == "training":
                row["dq"] = dict(
                    ms=cuda_ms(lambda: fa.flash_dq_cuda(q, k, v, gout, lse, delta, **opts), 5),
                    plain_ms=cuda_ms(lambda: fa.flash_dq_plain(q, k, v, gout, lse, delta, **opts), 2),
                    # q, k, v, g, lse, delta read; dq written
                    moved=5 * act + 2 * bh * t * 4, flops=6 * d * pairs)
                row["dkv"] = dict(
                    ms=cuda_ms(lambda: fa.flash_dkv_cuda(q, k, v, gout, lse, delta, **opts), 5),
                    plain_ms=cuda_ms(lambda: fa.flash_dkv_plain(q, k, v, gout, lse, delta, **opts), 2),
                    # q, k, v, g, lse, delta read; dk, dv written
                    moved=6 * act + 2 * bh * t * 4, flops=8 * d * pairs)
                with torch.enable_grad():
                    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
                    o = sdpa(qg, kg, vg, attn_mask=mask)
                    g4 = gout.view_as(o)
                    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                        o, (qg, kg, vg), g4, retain_graph=True), 5)
                row["dq"]["library_ms"] = row["dkv"]["library_ms"] = bwd_ms
            for part, x in row.items():
                x["bound_ms"], x["bound_by"] = _bound(x["moved"], x["flops"])
                log(f"flash {part} timing {label} B{b} H{bh // b} T{t} D{d} window "
                    f"{opts['window']}: kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, "
                    f"bound {x['bound_ms']:.4f} ms by {x['bound_by']} ({x['moved'] / 1e6:.1f} MB, "
                    f"{x['flops'] / 1e9:.2f} GFLOP, {pairs / 1e6:.1f} M pairs); "
                    f"scaled_dot_product_attention {x['library_ms']:.4f} ms"
                    + (" (its backward: dq, dk and dv in one call; kernels dq + dk/dv "
                       f"{row['dq']['ms'] + row['dkv']['ms']:.4f} ms)" if part != "fwd" else ""))
            timings[label] = row
    del inputs
    torch.cuda.empty_cache()
    tr = timings["training"]
    errs = {n: max(r[n]["max_abs"] for r in readings) for n in ("out", "dq", "dk", "dv")}
    spec = [("flash_fwd", "orion_tpu_torch/csrc/flash_attention.cu",
             "orion_tpu/ops/pallas/flash_attention.py:211", tr["fwd"], errs["out"]),
            ("flash_dq", "orion_tpu_torch/csrc/flash_attention_bwd.cu",
             "orion_tpu/ops/pallas/flash_attention.py:384", tr["dq"], errs["dq"]),
            ("flash_dkv", "orion_tpu_torch/csrc/flash_attention_bwd.cu",
             "orion_tpu/ops/pallas/flash_attention.py:418", tr["dkv"], max(errs["dk"], errs["dv"]))]
    lines = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
              "max_abs_err": err, **{key: x[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
             for name, source, replaces, x, err in spec]
    gen = timings["generate"]["fwd"]
    lines[0]["generate_shape"] = {key: gen[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    return lines


# ---------------------------------------------------------------------------
# The grouped expert matmul: rows 9, 10
# ---------------------------------------------------------------------------

# (label, routed rows per expert, d, h, dtype): moe_1b3_4e's shapes and the
# edges of the kernels' loops
GMM_CASES = [
    ("training", (3277, 2458, 1638, 819), 2048, 5504, torch.bfloat16),  # B 8 x 1024, top-1
    ("prefill", (1229, 1434, 819, 614), 2048, 5504, torch.bfloat16),  # B 4 x 1024
    ("top-2", (2150, 2048, 1990, 2004), 2048, 5504, torch.bfloat16),  # 4096 tokens x 2
    ("an expert without rows", (1700, 0, 900, 1496), 512, 1024, torch.bfloat16),
    ("N, K past the tiles", (300, 37, 0, 250), 100, 200, torch.bfloat16),
    ("tiny widths", (300, 0, 500, 224), 128, 384, torch.float32),
]


def gmm_problem(g, dev, counts, d, dtype):
    """Rows scattered into tile-aligned expert segments as the dropless
    layer scatters them (zero padding rows, M = ceil((m + E 128) / 128) 128)
    -> (x [M, d], the real rows' positions, the tile table, the segment
    sizes)."""
    from orion_tpu_torch.models.moe import GMM_TILE_ROWS as tm
    from orion_tpu_torch.ops.kernels import gmm as gm

    counts_t = torch.tensor(counts, dtype=torch.int32, device=dev)
    seg, starts = gm.pad_group_sizes(counts_t, tm)
    m = sum(counts)
    m2 = -(-(m + len(counts) * tm) // tm) * tm
    real = torch.cat([torch.arange(c, device=dev) + int(s) for c, s in zip(counts, starts)])
    x = torch.zeros(m2, d, device=dev, dtype=dtype)
    x[real] = torch.randn(m, d, device=dev, generator=g).to(dtype)
    return x, real, gm.tile_expert_table(seg, m2 // tm, tm), seg


def _dw_reading(got, ref, te):
    """dw against its plain version: the largest |got - ref| of each expert
    as a share of its limit GMM_DW_RTOL_OF_MAX max|ref_e| (above 1 fails);
    an expert without tiles must be exactly 0."""
    over, absent_zero = [], True
    for e in range(ref.shape[0]):
        if int((te == e).sum()) == 0:
            absent_zero = absent_zero and bool((got[e] == 0).all())
            continue
        rmax = float(ref[e].abs().max().clamp_min(1e-30))
        over.append(float((got[e] - ref[e]).abs().max()) / (GMM_DW_RTOL_OF_MAX * rmax))
    return {"max_abs": float((got - ref).abs().max()), "over_limit": max(over),
            "absent_zero": absent_zero, "well_formed": got.shape == ref.shape
            and got.dtype == torch.float32 and bool(torch.isfinite(got).all())}


def compare_gmm(gm, dev):
    """Rows 9 and 10 against their plain versions on the card, on every case
    of GMM_CASES: the gate/up product (x [M, d] @ w [E, d, h]), its dx
    against w^T and its dw; at d 2048 also the down product (mid [M, h] @ w
    [E, h, d]), its dx and dw. Returns one reading per case and product, and
    the training case's inputs."""
    g = torch.Generator(device=dev).manual_seed(9)
    readings, inputs = [], None
    for label, counts, d, h, dtype in GMM_CASES:
        x, real, te, seg = gmm_problem(g, dev, counts, d, dtype)
        e = len(counts)
        for kind, (k_in, n_out) in (("gate/up", (d, h)), ("down", (h, d))):
            if kind == "down" and d < 2048:
                continue
            a = x if kind == "gate/up" else gmm_problem(g, dev, counts, h, dtype)[0]
            w = (torch.randn(e, k_in, n_out, device=dev, generator=g) / k_in**0.5).to(dtype)
            gy = torch.zeros(a.shape[0], n_out, device=dev, dtype=dtype)
            gy[real] = torch.randn(len(real), n_out, device=dev, generator=g).to(dtype)
            y = gm.gmm_cuda(a, w, te)
            dx = gm.gmm_cuda(gy, w, te, transpose_w=True)
            junk = torch.full((e * k_in * n_out,), float("nan"), device=dev)
            del junk  # the allocator hands this block to dw: an unwritten element shows
            dw = gm.gmm_dw_cuda(a, gy, te, e)
            torch.cuda.synchronize()
            rtol = GMM_RTOL[dtype]
            readings.append({
                "case": f"{label} {kind}: rows {counts} (M {a.shape[0]}), K {k_in}, N {n_out}, "
                        f"{str(dtype)[6:]}",
                "y": _grad_reading(y, gm.gmm_torch(a, w, te), rtol, GMM_ATOL_OF_MAX),
                "dx": _grad_reading(dx, gm.gmm_torch(gy, w, te, transpose_w=True), rtol,
                                    GMM_ATOL_OF_MAX),
                "dw": _dw_reading(dw, gm.gmm_dw_torch(a, gy, te, e), te),
            })
            if label == "training" and kind == "gate/up":
                inputs = (a, w, gy, te, seg, sum(counts))
            del y, dx, dw
        torch.cuda.empty_cache()
    return readings, inputs


def agrees_gmm(r):
    return (all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0 for n in ("y", "dx", "dw"))
            and r["dw"]["absent_zero"])


def _library_ms(candidates):
    """The first of ``candidates`` ((label, fn)) that runs, timed: (ms,
    label); (None, the errors) when none does."""
    errors = []
    for label, fn in candidates:
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, AttributeError, NotImplementedError) as exc:
            errors.append(f"{label}: {str(exc).splitlines()[0][:160]}")
            continue
        return cuda_ms(fn, 10), label
    return None, "; ".join(errors)


def check_gmm(gm, dev):
    """Rows 9, 10: agreement on every case, then timings at the training
    shape (gate/up: x [8704, 2048] @ w [4, 2048, 5504]; its dx against w^T
    and the down product timed beside it), each beside its bound, its plain
    version and ``torch._grouped_mm`` (its dw with an fp32 output where the
    card's torch takes one, else bf16)."""
    readings, (x, w, gy, te, seg, m) = compare_gmm(gm, dev)
    for r in readings:
        log(f"gmm {r['case']}: "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        "limit)" for n in ("y", "dx", "dw"))
            + f"; absent expert's dw exactly 0: {r['dw']['absent_zero']}")
    bad = [r for r in readings if not agrees_gmm(r)]
    if bad:
        raise AssertionError(f"a gmm kernel disagrees with its plain version: {bad}")
    e, d, h = w.shape
    offs = torch.cumsum(seg, 0).int()  # each segment's end, tile-aligned
    with torch.no_grad():
        fwd = dict(
            ms=cuda_ms(lambda: gm.gmm_cuda(x, w, te), 10),
            plain_ms=cuda_ms(lambda: gm.gmm_torch(x, w, te), 2),
            # x's real rows and w read, y's real rows written; 2 m d h operations
            moved=m * d * 2 + e * d * h * 2 + m * h * 2, flops=2 * m * d * h)
        fwd["dx_ms"] = cuda_ms(lambda: gm.gmm_cuda(gy, w, te, transpose_w=True), 10)
        fwd["library_ms"], fwd["library"] = _library_ms([
            ("torch._grouped_mm", lambda: torch._grouped_mm(x, w, offs=offs))])
        dw = dict(
            ms=cuda_ms(lambda: gm.gmm_dw_cuda(x, gy, te, e), 10),
            plain_ms=cuda_ms(lambda: gm.gmm_dw_torch(x, gy, te, e), 2),
            # x's and g's real rows read, dw [E, d, h] fp32 written
            moved=m * d * 2 + m * h * 2 + e * d * h * 4, flops=2 * m * d * h)
        xt = x.t()
        dw["library_ms"], dw["library"] = _library_ms([
            ("torch._grouped_mm (fp32 out)",
             lambda: torch._grouped_mm(xt, gy, offs=offs, out_dtype=torch.float32)),
            ("torch._grouped_mm (bf16 out)", lambda: torch._grouped_mm(xt, gy, offs=offs))])
    for part, t in (("fwd", fwd), ("dw", dw)):
        t["bound_ms"], t["bound_by"] = _bound(t["moved"], t["flops"])
        lib = (f"{t['library']} {t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else f"library_ms none ({t['library']})")
        log(f"gmm {part} timing, training shape M {x.shape[0]} ({m} routed rows) d {d} h {h} "
            f"E {e} bf16: kernel {t['ms']:.4f} ms"
            + (f" (dx against w^T {t['dx_ms']:.4f} ms)" if part == "fwd" else "")
            + f", plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['moved'] / 1e6:.1f} MB, {t['flops'] / 1e9:.2f} GFLOP of the routed rows); "
            f"{lib}")
    errs = {n: max(r[n]["max_abs"] for r in readings) for n in ("y", "dx", "dw")}
    lines = []
    for name, replaces, t, err in (
            ("gmm_fwd", "orion_tpu/ops/pallas/gmm.py:104", fwd, max(errs["y"], errs["dx"])),
            ("gmm_dw", "orion_tpu/ops/pallas/gmm.py:157", dw, errs["dw"])):
        lines.append({"name": name, "route": "cuda", "source": "orion_tpu_torch/csrc/gmm.cu",
                      "replaces": replaces, "max_abs_err": err,
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "library")}})
    lines[0]["dx_ms"] = fwd["dx_ms"]
    return lines


# ---------------------------------------------------------------------------
# The int4 dequant-matmul: row 14
# ---------------------------------------------------------------------------

# (label, rows, d, out, dtype): lm_1b3's decode shapes (4 rows) and the edges
# of the kernel's loops
Q4_CASES = [
    ("wq..wo", 4, 2048, 2048, torch.bfloat16),
    ("gate/up", 4, 2048, 5504, torch.bfloat16),
    ("down", 4, 5504, 2048, torch.bfloat16),
    ("B 1", 1, 2048, 2048, torch.bfloat16),
    ("B 64", 64, 2048, 5504, torch.bfloat16),
    ("out 200 (no whole strip)", 4, 2048, 200, torch.bfloat16),
    ("ragged d 100", 4, 100, 384, torch.bfloat16),
    ("fp32 (tiny's widths)", 2, 128, 384, torch.float32),
    ("fp32, out % 4 != 0", 3, 64, 33, torch.float32),
]
Q4_PER_STEP = {"wq..wo": 4 * 24, "gate/up": 2 * 24, "down": 24}  # lm_1b3's calls a decode step


def compare_q4(q4, dev):
    """Row 14 against its plain version on the card, on every case of
    Q4_CASES: random packed bytes (every nibble -8..7 at both positions) and
    per-channel scales of a quantized weight's size. Returns one reading per
    case and the inputs by label."""
    g = torch.Generator(device=dev).manual_seed(14)
    readings, inputs = [], {}
    for label, b, d, out, dtype in Q4_CASES:
        x = torch.randn(b, d, device=dev, generator=g).to(dtype)
        p = torch.randint(-128, 128, (d // 2, out), device=dev, generator=g).to(torch.int8)
        s = (torch.rand(out, device=dev, generator=g) + 0.5) * 0.01
        junk = torch.full((b, out), float("nan"), device=dev, dtype=dtype)
        del junk  # the allocator hands this block to y: an unwritten element shows
        y = q4.q4_matmul_cuda(x, p, s)
        torch.cuda.synchronize()
        readings.append({"case": f"{label}: x [{b}, {d}] {str(dtype)[6:]}, p [{d // 2}, {out}]",
                         "y": _grad_reading(y, q4.q4_matmul_torch(x, p, s), Q4_RTOL[dtype],
                                            Q4_ATOL_OF_MAX)})
        inputs[label] = (x, p, s)
    return readings, inputs


def agrees_q4(r):
    return r["y"]["well_formed"] and r["y"]["over_limit"] <= 1.0


def check_q4(q4, dev):
    """Row 14: agreement on every case, then timings at lm_1b3's three decode
    shapes, each beside its bound (by bytes: the packed weight) and its plain
    version, by ``cuda_ms`` as every row; beside them the kernel's device
    time alone (``graph_ms``, over cold weights) and, as a yardstick that is
    not the same function, the bf16 dense product of the same shape
    (cuBLAS), timed so too."""
    readings, inputs = compare_q4(q4, dev)
    for r in readings:
        log(f"q4_matmul {r['case']}: y max abs {r['y']['max_abs']:.3e} ({r['y']['over_limit']:.3f} "
            f"of its limit, needs atol {r['y']['atol_needed']:.2e} max|ref|)")
    bad = [r for r in readings if not agrees_q4(r)]
    if bad:
        raise AssertionError(f"q4_matmul disagrees with its plain version: {bad}")
    per_shape = {}
    with torch.no_grad():
        for label in Q4_PER_STEP:
            x, p, s = inputs[label]
            (b, d), out = x.shape, p.shape[1]
            ps = cold_copies(p)
            ws = cold_copies(torch.randn(d, out, device=dev).to(torch.bfloat16))
            # ms, plain_ms: calls back to back, the wrapper's host time
            # included (as each decode step's calls pay it); graph_ms: the
            # kernel's device time alone
            t = dict(ms=cuda_ms(lambda: q4.q4_matmul_cuda(x, p, s), 200),
                     plain_ms=cuda_ms(lambda: q4.q4_matmul_torch(x, p, s), 20),
                     graph_ms=graph_ms(lambda i: q4.q4_matmul_cuda(x, ps[i % len(ps)], s), 200),
                     dense_bf16_graph_ms=graph_ms(lambda i: x @ ws[i % len(ws)], 200),
                     # x, p, s read; y written; 2 b d out operations
                     moved=b * d * 2 + p.numel() + out * 4 + b * out * 2, flops=2 * b * d * out)
            t["bound_ms"], t["bound_by"] = _bound(t["moved"], t["flops"])
            per_shape[label] = t
            log(f"q4_matmul timing {label}: x [{b}, {d}] bf16 @ p [{d // 2}, {out}]: kernel "
                f"{t['ms']:.4f} ms a call with the wrapper's host time ({t['graph_ms']:.4f} device "
                f"time alone), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
                f"{t['bound_by']} ({t['moved'] / 1e6:.2f} MB); library_ms: none (no PyTorch call "
                "takes this packed int4 layout: torch._weight_int4pack_mm wants its own tiled "
                "packing and group-wise zero points); yardstick, not the same function: bf16 "
                f"dense x @ W, device time alone, {t['dense_bf16_graph_ms']:.4f} ms "
                f"({d * out * 2 / 1e6:.2f} MB of weights)")
    fields = ("ms", "plain_ms", "graph_ms", "bound_ms", "dense_bf16_graph_ms")
    step = {k: sum(per_shape[s][k] * n for s, n in Q4_PER_STEP.items()) for k in fields}
    log(f"q4_matmul over one lm_1b3 decode step's 168 calls (each shape's time x its count): "
        f"kernel {step['ms']:.3f} ms with the wrapper's host time ({step['graph_ms']:.3f} device "
        f"time alone), plain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.4f} ms, bf16 "
        f"dense device time {step['dense_bf16_graph_ms']:.3f} ms")
    t = per_shape["gate/up"]
    return [{"name": "q4_matmul", "route": "cuda", "source": "orion_tpu_torch/csrc/q4_matmul.cu",
             "replaces": "orion_tpu/quant.py:183",
             "max_abs_err": max(r["y"]["max_abs"] for r in readings),
             **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
             "graph_ms": t["graph_ms"],
             "shape": "x [4, 2048] @ p [1024, 5504] (lm_1b3's gate / up at decode)",
             "per_shape": {k: {f: v[f] for f in fields} for k, v in per_shape.items()},
             "per_decode_step": step}]


# ---------------------------------------------------------------------------
# Fused Adafactor: rows 11, 12, 13
# ---------------------------------------------------------------------------

# (label, m, n): lm_1b3's factored matrices in the port's [out, in] layout,
# and ragged edges; every case's gradient has an all-zero row and column
AF_CASES = [("embed", 32000, 2048), ("gate/up", 5504, 2048), ("down", 2048, 5504),
            ("square", 2048, 2048), ("ragged m, n", 1000, 1001), ("ragged, n < 1024", 777, 300)]
# lm_1b3's 170 factored leaves by shape: the embedding; gate and up of 24
# blocks; down; wq, wk, wv, wo of 24 blocks and pos_embed
AF_PER_STEP = {"embed": 1, "gate/up": 48, "down": 24, "square": 97}


def compare_adafactor(af, dev):
    """Rows 11-13 against their plain versions on the card, on every case of
    AF_CASES: a gradient-sized g (an all-zero row and column: their sums are
    eps alone), the squared clip scale, row and column factors, params. The
    sums by each element's relative error, the squared sum, apply with the
    flag 1 against the plain version and with the flag 0 (p bitwise as it
    was). Returns one reading per case and the inputs by label."""
    g = torch.Generator(device=dev).manual_seed(11)
    readings, inputs = [], {}
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for label, m, n in AF_CASES:
        grad = torch.randn(m, n, device=dev, generator=g) * 1e-3
        grad[m // 2] = 0.0
        grad[:, n // 3] = 0.0
        s2 = torch.tensor([0.37 ** 2], device=dev)
        r = torch.rand(m, device=dev, generator=g) + 0.5
        c = torch.rand(n, device=dev, generator=g) + 0.5
        p0 = torch.randn(m, n, device=dev, generator=g) * 0.02
        n_ct, n_rc, _ = af.tiling(m, n)
        _nan_junk(dev, *(((k,), torch.float32) for k in (n_ct * m, n_rc * n, m + n)))
        s0, s1 = af.adafactor_sums_cuda(grad, s2, 1e-30)
        _nan_junk(dev, ((n_ct * n_rc,), torch.float32))
        rms = af.adafactor_rms_cuda(grad, r, c)
        r_apply = r * -1e-3  # the apply pass's row factor folds -lr
        p, p_off = p0.clone(), p0.clone()
        af.adafactor_apply_cuda(grad, p, r_apply, c, one)
        af.adafactor_apply_cuda(grad, p_off, r_apply, c, torch.zeros_like(one))
        torch.cuda.synchronize()
        r0, r1 = af.adafactor_sums_torch(grad, s2, 1e-30)
        r_rms = float(af.adafactor_rms_torch(grad, r, c))
        p_ref = af.adafactor_apply_torch(grad, p0.clone(), r_apply, c, one)
        sums_rel = max(float(((a - b).abs() / b).max()) for a, b in ((s0, r0), (s1, r1)))
        diff = (p - p_ref).abs()
        readings.append({
            "case": f"{label} [{m}, {n}]",
            "sums_rel": sums_rel, "rms_rel": abs(float(rms) - r_rms) / r_rms,
            "sums_max_abs": max(float((a - b).abs().max()) for a, b in ((s0, r0), (s1, r1))),
            "rms_max_abs": abs(float(rms) - r_rms),
            "apply_max_abs": float(diff.max()),
            "apply_over_limit": float((diff / (AF_APPLY_RTOL * p_ref.abs())).nan_to_num(
                posinf=1e30).max()),
            "flag_off_untouched": bool(torch.equal(p_off, p0)),
            "well_formed": s0.shape == (n,) and s1.shape == (m,) and rms.shape == ()
            and bool(torch.isfinite(s0).all() and torch.isfinite(s1).all()),
        })
        inputs[label] = (grad, s2, r, c, p0)
        del p, p_off, p_ref, s0, s1, r0, r1
    torch.cuda.empty_cache()
    return readings, inputs


def agrees_adafactor(r):
    return (r["well_formed"] and r["flag_off_untouched"] and r["sums_rel"] <= AF_SUM_RTOL
            and r["rms_rel"] <= AF_RMS_RTOL and r["apply_over_limit"] <= 1.0)


def check_adafactor(af, dev):
    """Rows 11-13: agreement on every case, then each pass timed at lm_1b3's
    four shapes beside its bound (by bytes) and its plain version, by
    ``cuda_ms`` as every row, and its device time alone (``graph_ms``, over
    cold inputs); no PyTorch call computes any of the three (each is several
    elementwise and reduction calls)."""
    readings, inputs = compare_adafactor(af, dev)
    for r in readings:
        log(f"adafactor {r['case']}: sums max rel {r['sums_rel']:.3e} (limit {AF_SUM_RTOL:g}), "
            f"squared sum rel {r['rms_rel']:.3e} (limit {AF_RMS_RTOL:g}), apply max abs "
            f"{r['apply_max_abs']:.3e} ({r['apply_over_limit']:.3f} of its limit), flag 0 leaves "
            f"p bitwise: {r['flag_off_untouched']}")
    bad = [r for r in readings if not agrees_adafactor(r)]
    if bad:
        raise AssertionError(f"a fused Adafactor kernel disagrees with its plain version: {bad}")
    one = torch.ones(1, dtype=torch.int32, device=dev)
    per_shape = {}
    with torch.no_grad():
        for label in AF_PER_STEP:
            grad, s2, r, c, p0 = inputs[label]
            m, n = grad.shape
            gs, ps = cold_copies(grad), cold_copies(p0.clone())  # each call's g, p from HBM
            k = len(gs)
            r_apply = r * -1e-9  # repeated applies move p by little
            vec = 4 * (m + n)
            rows = {
                "sums": (lambda i: af.adafactor_sums_cuda(gs[i % k], s2, 1e-30),
                         lambda i: af.adafactor_sums_torch(gs[i % k], s2, 1e-30),
                         4 * m * n + 4 + vec, 3 * m * n),  # g read; both sums written
                "rms": (lambda i: af.adafactor_rms_cuda(gs[i % k], r, c),
                        lambda i: af.adafactor_rms_torch(gs[i % k], r, c),
                        4 * m * n + vec + 4, 4 * m * n),  # g, r, c read; one sum written
                "apply": (lambda i: af.adafactor_apply_cuda(gs[i % k], ps[i % k], r_apply, c, one),
                          lambda i: af.adafactor_apply_torch(gs[i % k], ps[i % k], r_apply, c, one),
                          12 * m * n + vec + 4, 3 * m * n),  # g, p, r, c read; p written
            }
            per_shape[label] = {}
            for part, (kernel, plain, moved, flops) in rows.items():
                # ms, plain_ms: calls back to back, the wrapper's host time
                # included; graph_ms: the kernels' device time alone
                t = dict(ms=cuda_ms(lambda: kernel(0), 20), plain_ms=cuda_ms(lambda: plain(0), 5),
                         graph_ms=graph_ms(kernel, 20), moved=moved)
                t["bound_ms"], t["bound_by"] = _bound(moved, flops, FP32_FLOPS)
                per_shape[label][part] = t
                log(f"adafactor_{part} timing {label} [{m}, {n}] fp32: kernel {t['ms']:.4f} ms a "
                    f"call with the wrapper's host time ({t['graph_ms']:.4f} device time alone), "
                    f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
                    f"{t['bound_by']} ({moved / 1e6:.1f} MB); library_ms: none (no single "
                    "PyTorch call computes it)")
    lines = []
    for part, replaces in (("sums", "orion_tpu/ops/pallas/adafactor.py:156"),
                           ("rms", "orion_tpu/ops/pallas/adafactor.py:179"),
                           ("apply", "orion_tpu/ops/pallas/adafactor.py:198")):
        fields = ("ms", "plain_ms", "graph_ms", "bound_ms")
        step = {k: sum(per_shape[s][part][k] * n for s, n in AF_PER_STEP.items()) for k in fields}
        log(f"adafactor_{part} over one lm_1b3 step's 170 calls (each shape's time x its count): "
            f"kernel {step['ms']:.3f} ms with the wrapper's host time ({step['graph_ms']:.3f} "
            f"device time alone), plain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
        t = per_shape["embed"][part]
        err = max(r[{"sums": "sums_max_abs", "rms": "rms_max_abs", "apply": "apply_max_abs"}[part]]
                  for r in readings)
        lines.append({"name": f"adafactor_{part}", "route": "cuda",
                      "source": "orion_tpu_torch/csrc/adafactor.cu", "replaces": replaces,
                      "max_abs_err": err,
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                      "library_ms": None, "graph_ms": t["graph_ms"],
                      "launches_per_call": 1 if part == "apply" else 2,
                      "shape": "[32000, 2048] fp32 (lm_1b3's embedding)",
                      "per_shape": {s: {k: v[part][k] for k in fields}
                                    for s, v in per_shape.items()},
                      "per_step": step})
    del inputs
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# The main paths
# ---------------------------------------------------------------------------


def _counts(mods):
    cd, fa, gm, q4, af = mods
    return {"causal_dot_norm": cd.launches, "causal_dot": cd.launches_raw,
            "causal_dot_dq_den": cd.launches_dq, "causal_dot_rev_den": cd.launches_rev,
            "causal_dot_rev": cd.launches_raw_rev, "flash_fwd": fa.launches_fwd,
            "flash_dq": fa.launches_dq, "flash_dkv": fa.launches_dkv,
            "gmm_fwd": gm.launches_fwd, "gmm_dw": gm.launches_dw, "q4_matmul": q4.launches,
            "adafactor_sums": af.launches_sums, "adafactor_rms": af.launches_rms,
            "adafactor_apply": af.launches_apply}


def _reset_counts(mods):
    cd, fa, gm, q4, af = mods
    cd.launches = cd.launches_dq = cd.launches_rev = cd.launches_raw = cd.launches_raw_rev = 0
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    gm.launches_fwd = gm.launches_dw = 0
    q4.launches = 0
    af.launches_sums = af.launches_rms = af.launches_apply = 0


def _layer_counts(cfg):
    """(linear, softmax/swa) layers in all blocks and in the rematerialized
    ones (the first n_layers - remat_skip when cfg.remat)."""
    kinds = cfg.resolved_layer_types
    first_remat = cfg.n_layers - max(0, cfg.remat_skip) if cfg.remat else 0
    lin = sum(lt == "linear" for lt in kinds)
    lin_remat = sum(lt == "linear" for lt in kinds[:first_remat])
    return lin, len(kinds) - lin, lin_remat, first_remat - lin_remat


def _gmm_counts(cfg):
    """(gmm products of the dropless MoE layers in all blocks, in the
    rematerialized ones): 3 a layer for SwiGLU, 2 for GELU; 0 for the
    capacity form, which runs no kernel."""
    if not (cfg.n_experts and cfg.moe_dropless):
        return 0, 0
    first_remat = cfg.n_layers - max(0, cfg.remat_skip) if cfg.remat else 0
    per = 3 if cfg.mlp == "swiglu" else 2
    moe = [i for i in range(cfg.n_layers) if cfg.moe_at(i)]
    return per * len(moe), per * sum(i < first_remat for i in moe)


def _q4_per_step(cfg):
    """Int4 dense layers a decode step runs (each launches the q4 kernel once
    at decode's rows): wq, wk, wv, wo in every block, and gate, up, down (up,
    down for GELU) in every block whose MLP is not routed (expert stacks stay
    int8)."""
    mlp = 3 if cfg.mlp == "swiglu" else 2
    return sum(4 + (0 if cfg.moe_at(i) else mlp) for i in range(cfg.n_layers))


def _af_kernel_leaves(params):
    """The parameters whose update takes the three fused kernels: factored
    2-D fp32 matrices of at least _MIN_KERNEL_ELEMS elements."""
    from orion_tpu_torch.ops.kernels import adafactor as af

    return sum(1 for p in params.values()
               if af.factored_dims(p.shape) is not None and af.kernel_ok(p))


def _state_err(states, ref_states):
    """The largest relative error of a layer's decode state against its
    reference: (S of the linear layers, the K and V caches of the others);
    None where the model has no such layer."""
    errs = {"s": [], "kv": []}
    for a, b in zip(states, ref_states):
        for key in ("s",) if "s" in a else ("k", "v"):
            errs["s" if key == "s" else "kv"].append(float(
                (a[key].float() - b[key].float()).abs().max() / b[key].float().abs().max()))
    return tuple(max(e) if e else None for e in (errs["s"], errs["kv"]))


class PinnedRouting:
    """The kernel run's expert choices, replayed in the reference run.

    A MoE model's kernel path and its ``backend="torch"`` reference differ by
    bf16 roundings in every layer (about 1e-3 in a router logit); where a
    token's top two router logits lie closer than that, the two paths send
    it to different experts, and its whole contribution moves between
    experts: a discontinuity that no numeric limit bounds. So, within
    ``with pin:``, ``moe.top_k_choice`` records each MoE layer's choices the
    first time the layer routes (the kernel run) and replays them on every
    later call of that layer (the recomputation, the reference run), the
    gates taken from the calling run's own probabilities. ``flips`` counts
    the token choices the reference would have made otherwise."""

    def __init__(self):
        from orion_tpu_torch.models import moe

        self.moe, self.real = moe, moe.top_k_choice
        self.routes, self.current, self.flips, self.choices = {}, None, 0, 0

    def attach(self, model):
        """Name each MoE layer of ``model`` by its block while it runs."""
        for i, blk in enumerate(model.blocks):
            if isinstance(blk.mlp, self.moe.MoEMLP):
                blk.mlp.register_forward_pre_hook(lambda mod, args, i=i: setattr(
                    self, "current", i))
        return model

    def choice(self, probs, k):
        """``top_k_choice`` at the pinned experts. Every call takes the same
        ops, so a recomputation saves what its forward saved; the gates equal
        ``top_k_choice``'s (a gather for its product with a one-hot)."""
        ids, _ = self.real(probs, k)
        pinned = self.routes.setdefault(self.current, ids)
        if pinned is not ids:
            self.flips += int((pinned != ids).any(-1).sum())
            self.choices += ids.shape[0]
        g = probs.gather(-1, pinned)
        return pinned, g / g.sum(-1, keepdim=True).clamp_min(1e-9)

    def __enter__(self):
        self.moe.top_k_choice = self.choice
        return self

    def __exit__(self, *exc):
        self.moe.top_k_choice = self.real


def generate_phase(dev, mods, name, prompt_len, new_tokens, overrides=None):
    """``generate`` on ``name`` (with ``overrides``) at full width: prefill
    and decode times, exact launch counts, the prefill's logits and states
    against backend="torch" on the same weights."""
    from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = get_config(name, **(overrides or {}))
    t0 = time.perf_counter()
    model = cast_params_for_inference(
        TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    )
    torch.cuda.synchronize()
    log(f"{name}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, prompt_len), dtype=np.int64)
    ).to(dev)
    greedy = SampleConfig(temperature=0.0)

    generate(model, prompts[:, :128], 2, greedy)  # warm-up: cuBLAS plans, allocator
    prefill_runs = [wall_ms(lambda: generate(model, prompts, 1, greedy))[0] for _ in range(3)]

    _reset_counts(mods)
    gen_ms, out = wall_ms(lambda: generate(model, prompts, new_tokens, greedy))
    counts = _counts(mods)
    lin, attn, _, _ = _layer_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    # decode's few rows take the dense per-expert form: gmm in the prefill only
    want.update(causal_dot_norm=lin, flash_fwd=attn, gmm_fwd=_gmm_counts(cfg)[0])
    log(f"{name} generate launches: {counts}")
    if counts != want:
        raise AssertionError(f"{name} generate launched {counts}, want {want} (each layer's "
                             "forward kernels once, in the prefill)")
    if out.shape != (4, new_tokens) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} / out-of-vocab tokens")
    prefill_ms = float(np.median(prefill_runs))
    decode_ms = (gen_ms - prefill_ms) / (new_tokens - 1)
    log(f"{name} B4 T{prompt_len}: prefill (generate with 1 new token) {prefill_ms:.2f} ms "
        f"(runs {[round(x, 2) for x in prefill_runs]}); generate {new_tokens} tokens "
        f"{gen_ms:.2f} ms; decode {decode_ms:.3f} ms/token at batch 4")
    log(f"first tokens: {out[:, :8].tolist()}")

    # the kernel-backed prefill against the plain version, same weights and,
    # for a MoE model, the same expert choices (PinnedRouting)
    ref_model = TransformerLM(dataclasses.replace(cfg, backend="torch"), device=dev)
    ref_model = cast_params_for_inference(ref_model)
    ref_model.load_state_dict(model.state_dict())
    with torch.inference_mode(), PinnedRouting() as pin:
        logits, states = pin.attach(model).prefill_last(prompts)
        ref_logits, ref_states = pin.attach(ref_model).prefill_last(prompts)
    if pin.choices:
        log(f"{name} prefill routing: the reference would have sent {pin.flips} of "
            f"{pin.choices} tokens to other experts; it takes the kernel run's")
    del ref_model, model
    if logits.shape != (4, cfg.vocab_size) or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits have the wrong shape, dtype or values")
    err = float((logits - ref_logits).abs().max())
    s_err, kv_err = _state_err(states, ref_states)
    agree = int((logits.argmax(-1) == ref_logits.argmax(-1)).sum())
    log(f"{name} prefill logits, kernel vs backend='torch': max abs {err:.4e} (tol "
        f"{LOGITS_ATOL}), max |logit| {float(ref_logits.abs().max()):.3f}, greedy agree "
        f"{agree}/4; per-layer state max rel: S {s_err} (tol {LAYER_S_RTOL:g}), K/V {kv_err} "
        f"(tol {LAYER_KV_RTOL:g})")
    del states, ref_states
    torch.cuda.empty_cache()
    if (err > LOGITS_ATOL or (s_err or 0.0) > LAYER_S_RTOL
            or (kv_err or 0.0) > LAYER_KV_RTOL):
        raise AssertionError(f"{name}: kernel-backed prefill disagrees with the plain version")
    return {
        "launches": counts, "prefill_ms": prefill_ms, "prefill_runs_ms": prefill_runs,
        "generate_ms": gen_ms, "decode_ms_per_token": decode_ms,
        "logits_max_abs_err": err, "s_max_rel_err": s_err, "kv_max_rel_err": kv_err,
        "greedy_agree": agree,
    }


def quant_generate_phase(dev, mods, name, prompt_len, new_tokens, mode, overrides=None):
    """``generate(..., quant=mode)`` on ``name`` (with ``overrides``) at full
    width: the model quantized once from seeded fp32 weights
    (``quantize_for_decode``), prefill and decode times, exact launch counts
    (in int4 one q4 launch per int4 layer and decode step; the prefill's
    rows stay on the split form), then the prefill's logits and 8 decode
    steps' logits against backend="torch" on the same quantized weights, the
    decode steps fed the kernel run's tokens (a MoE's routing pinned to the
    kernel run's, step by step)."""
    from orion_tpu_torch.generate import SampleConfig, generate, quantize_for_decode
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = get_config(name, **(overrides or {}))
    t0 = time.perf_counter()
    fp = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model = quantize_for_decode(fp, mode)
    del fp
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"{name} {mode}: quantized in {time.perf_counter() - t0:.1f} s, "
        f"{sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 2**30:.2f} "
        f"GiB of weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, prompt_len), dtype=np.int64)
    ).to(dev)
    greedy = SampleConfig(temperature=0.0)
    generate(model, prompts[:, :128], 2, greedy, quant=mode)  # warm-up
    prefill_runs = [wall_ms(lambda: generate(model, prompts, 1, greedy, quant=mode))[0]
                    for _ in range(3)]
    _reset_counts(mods)
    gen_ms, out = wall_ms(lambda: generate(model, prompts, new_tokens, greedy, quant=mode))
    counts = _counts(mods)
    lin, attn, _, _ = _layer_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    # a quantized MoE never takes the gmm kernels
    want.update(causal_dot_norm=lin, flash_fwd=attn,
                q4_matmul=_q4_per_step(cfg) * (new_tokens - 1) if mode == "int4" else 0)
    log(f"{name} {mode} generate launches: {counts}")
    if counts != want:
        raise AssertionError(f"{name} {mode} generate launched {counts}, want {want}")
    if out.shape != (4, new_tokens) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generate returned the wrong shape / out-of-vocab tokens")
    prefill_ms = float(np.median(prefill_runs))
    decode_ms = (gen_ms - prefill_ms) / (new_tokens - 1)
    log(f"{name} {mode} B4 T{prompt_len}: prefill {prefill_ms:.2f} ms (runs "
        f"{[round(x, 2) for x in prefill_runs]}); generate {new_tokens} tokens {gen_ms:.2f} ms; "
        f"decode {decode_ms:.3f} ms/token at batch 4")

    ref = TransformerLM(dataclasses.replace(cfg, backend="torch"), device=dev, quant=mode)
    ref.load_state_dict(model.state_dict())
    pin = PinnedRouting()
    pin.attach(model)
    pin.attach(ref)
    errs = []
    with torch.inference_mode():
        with pin:
            lg, st = model.prefill_last(prompts)
            rlg, rst = ref.prefill_last(prompts)
        errs.append(float((lg - rlg).abs().max()))
        for i in range(8):
            pin.routes.clear()
            with pin:
                lg, st = model.decode_step(out[:, i], st, prompt_len + i)
                rlg, rst = ref.decode_step(out[:, i], rst, prompt_len + i)
            errs.append(float((lg - rlg).abs().max()))
        finite = bool(torch.isfinite(lg).all()) and lg.dtype == torch.float32
    del ref, model, st, rst
    torch.cuda.empty_cache()
    log(f"{name} {mode} logits, kernels vs backend='torch' on the same quantized weights: max abs "
        f"after the prefill {errs[0]:.4e}, after decode steps 1-8 "
        f"{[float(f'{e:.3e}') for e in errs[1:]]} (limit {QUANT_LOGITS_ATOL})"
        + (f"; routing pinned, the reference would have sent {pin.flips} of {pin.choices} "
           "token choices elsewhere" if pin.choices else ""))
    if not finite or max(errs) > QUANT_LOGITS_ATOL:
        raise AssertionError(f"{name} {mode}: the kernel path disagrees with backend='torch'")
    return {"launches": counts, "prefill_ms": prefill_ms, "prefill_runs_ms": prefill_runs,
            "generate_ms": gen_ms, "decode_ms_per_token": decode_ms, "logits_max_abs_err": errs,
            "q4_per_step": _q4_per_step(cfg)}


def tiny_generate(dev, cfg, label, quant=""):
    """A small model end to end: the card against the CPU's plain path
    (``quant``: both quantized from the same fp32 weights; the card's int4
    decode rows take the kernel, the CPU's the split form)."""
    from orion_tpu_torch.generate import SampleConfig, generate, quantize_for_decode
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.ops.kernels import q4_matmul

    greedy = SampleConfig(temperature=0.0)
    tiny_cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    if quant:
        tiny_cpu = quantize_for_decode(tiny_cpu, quant)
    tiny_gpu = TransformerLM(cfg, device=dev, quant=quant)
    tiny_gpu.load_state_dict(tiny_cpu.state_dict())
    tp = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 100), dtype=np.int64))
    before = q4_matmul.launches
    got = generate(tiny_gpu, tp.to(dev), 16, greedy, quant=quant)
    if quant == "int4" and q4_matmul.launches != before + 15 * _q4_per_step(cfg):
        raise AssertionError(f"{label}: {q4_matmul.launches - before} q4 launches, want "
                             f"{15 * _q4_per_step(cfg)}")
    ref = generate(tiny_cpu, tp, 16, greedy, quant=quant)
    with torch.inference_mode():
        lg = tiny_gpu.prefill_last(tp.to(dev))[0].cpu()
        lc = tiny_cpu.prefill_last(tp)[0]
    tiny_err = float((lg - lc).abs().max())
    log(f"{label} fp32, card vs CPU: greedy tokens equal {bool(torch.equal(got.cpu(), ref))}, "
        f"logits max abs {tiny_err:.3e} (tol {TINY_LOGITS_ATOL:g})")
    if not torch.equal(got.cpu(), ref) or tiny_err > TINY_LOGITS_ATOL:
        raise AssertionError(f"{label} on the card disagrees with the CPU path")
    return tiny_err


def train_phase(dev, mods, name, seq_len, overrides=None, optimizer="adamw", then=None):
    """``name`` (with ``overrides``) training at full width: 1 warm-up and 3
    timed steps, with exact launch counts per step; with
    ``optimizer="adafactor_fused"`` then one update through the kernels
    against the plain formulas (``adafactor_update_check``); then
    ``then(trainer)``, whose result the returned dict holds as "then"."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.training.data import DataLoader, SyntheticDataset
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=get_config(name, **(overrides or {})), steps=4, batch_size=8,
                      seq_len=seq_len, optimizer=optimizer)
    m = cfg.model
    lin, attn, lin_remat, attn_remat = _layer_counts(m)
    products, products_remat = _gmm_counts(m)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"causal_dot_norm": lin + lin_remat, "causal_dot_dq_den": lin,
                 "causal_dot_rev_den": lin, "flash_fwd": attn + attn_remat, "flash_dq": attn,
                 "flash_dkv": attn,
                 # forward, recomputation, and dx by the forward kernel against w^T
                 "gmm_fwd": 2 * products + products_remat, "gmm_dw": products})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    if optimizer == "adafactor_fused":  # each pass once for every kernel leaf; the sums
        n_af = _af_kernel_leaves(trainer.params)  # and the squared sum launch twice a call
        want.update(adafactor_sums=2 * n_af, adafactor_rms=2 * n_af, adafactor_apply=n_af)
    log(f"{name} trainer: {sum(p.numel() for p in trainer.params.values()) / 1e9:.3f} B fp32 "
        f"params + {optimizer} state, init {time.perf_counter() - t0:.1f} s")
    loader = DataLoader(SyntheticDataset(m.vocab_size, cfg.seq_len), cfg.batch_size,
                        seed=cfg.seed, device=dev)
    steps_ms, losses = [], []
    _reset_counts(mods)
    per_step, before = [], _counts(mods)
    try:
        for _ in range(4):
            batch = next(loader)
            ms, metrics = wall_ms(lambda: trainer.step(batch))
            after = _counts(mods)
            per_step.append({k: after[k] - before[k] for k in after})
            before = after
            steps_ms.append(ms)
            losses.append(metrics["loss"])
    finally:
        loader.close()
    counts = _counts(mods)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    timed = steps_ms[1:]
    step_ms = float(np.mean(timed))
    tokens_per_s = cfg.batch_size * cfg.seq_len / (step_ms / 1e3)
    log(f"{name} train B8 T{seq_len}, {optimizer}: step ms {[round(x, 2) for x in steps_ms]} (first is the "
        f"warm-up), mean of the timed {step_ms:.2f} ms, {tokens_per_s:.0f} tokens/s, "
        f"max memory allocated {peak_gib:.2f} GiB; losses {[round(x, 4) for x in losses]}")
    log(f"{name} train launches per step: {per_step} (want {want} each)")
    if any(s != want for s in per_step):
        raise AssertionError(f"launches per training step {per_step}, want {want}")
    if not all(np.isfinite(x) and 0.0 < x < 20.0 for x in losses):
        raise AssertionError(f"training losses not finite or out of range: {losses}")
    check = adafactor_update_check(trainer, batch) if optimizer == "adafactor_fused" else None
    after = then(trainer) if then is not None else None
    del trainer
    torch.cuda.empty_cache()
    return {"launches": counts, "per_step": per_step, "steps_ms": steps_ms, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "max_memory_gib": peak_gib, "losses": losses,
            "update_check": check, "then": after}


def load_phase(dev, mods, trainer, prompt_len=1024, new_tokens=32):
    """Train -> checkpoint -> generate at full width: the trainer's whole
    state saved with the Trainer's ``Checkpointer`` into a temporary
    directory (free space checked first), its params loaded back with
    ``generate.load_model`` (``load_params``: memory-mapped, verified against
    the manifest), and ``generate`` of 4 x ``prompt_len`` prompts for
    ``new_tokens`` greedy tokens from the loaded model against the same
    from the in-memory trained model: tokens and prefill logits bitwise
    (the same card, kernels and casts), in bf16 and at int4 (row 14
    launched, its count read; the counts set to 0 just before each)."""
    import os
    import shutil
    import tempfile

    from orion_tpu_torch.generate import (
        SampleConfig, cast_params_for_inference, generate, load_model, quantize_for_decode)
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.training.checkpoint import Checkpointer, step_path

    cfg = trainer.model.cfg
    state = trainer.state_dict()
    need = sum(t.numel() * t.element_size()
               for t in _tree_leaves(state))  # the file, and its manifest's bytes beside
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"load phase: checkpoint of {need / 1e9:.3f} GB into {tmp} ({free / 1e9:.1f} GB free)")
        if free < need + 2**30:
            raise RuntimeError(f"{tmp} has {free / 1e9:.1f} GB free; the checkpoint needs "
                               f"{need / 1e9:.1f} GB and 1 GiB to spare")
        t0 = time.perf_counter()
        Checkpointer(tmp, max_to_keep=1).maybe_save(trainer.step_count, state, force=True)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(step_path(tmp, trainer.step_count))
        del state
        t0 = time.perf_counter()
        loaded, step = load_model(cfg, tmp, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"load phase: saved step {step} ({size / 1e9:.3f} GB on disk, "
            f"{trainer.opt.__class__.__name__} state beside the params) in {save_s:.1f} s; "
            f"loaded its params in {load_s:.1f} s")
        memory = TransformerLM(cfg, device=dev)
        memory.load_state_dict({n: p.detach() for n, p in trainer.params.items()})
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, prompt_len), dtype=np.int64)).to(dev)
        greedy = SampleConfig(temperature=0.0)
        res = {"save_s": save_s, "load_s": load_s, "bytes": size, "step": step}
        # int4 first: quantize_for_decode takes the fp32 weights, as the CLI
        for mode in ("int4", ""):
            if mode:
                models = [quantize_for_decode(m, mode) for m in (loaded, memory)]
            else:
                models = [cast_params_for_inference(m) for m in (loaded, memory)]
            _reset_counts(mods)
            got = generate(models[0], prompts, new_tokens, greedy)
            counts = _counts(mods)
            ref = generate(models[1], prompts, new_tokens, greedy)
            with torch.inference_mode():
                lg, rlg = (m.prefill_last(prompts)[0] for m in models)
            want = dict.fromkeys(KERNELS, 0)
            want.update(causal_dot_norm=_layer_counts(cfg)[0],
                        q4_matmul=(new_tokens - 1) * _q4_per_step(cfg) if mode else 0)
            label = mode or "bf16"
            log(f"load phase {label}: generate from the loaded params launched {counts}; "
                f"tokens equal the in-memory model's: {bool(torch.equal(got, ref))}; prefill "
                f"logits bitwise equal: {bool(torch.equal(lg, rlg))}")
            if counts != want:
                raise AssertionError(f"loaded {label} generate launched {counts}, want {want}")
            if not (torch.equal(got, ref) and torch.equal(lg, rlg)
                    and bool(torch.isfinite(lg).all())):
                raise AssertionError(f"the loaded {label} model disagrees with the in-memory one")
            res[label] = {"launches": counts, "first_tokens": got[:, :8].tolist()}
            del models, lg, rlg
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def adafactor_update_reading(af, grads, params, state, dims, scale):
    """One Adafactor update of ``params`` on ``grads`` from ``state`` at lr
    1e-3, through the kernels (adafactor_fused) and through the plain
    formulas (optimizer="adafactor"), each on copies: the worst share of its
    limit of the params and of the statistics (v_row, v_col, v), and the
    apply launches of each."""
    out = {}
    for use_kernel in (True, False):
        ps = {n: p.detach().clone() for n, p in params.items()}
        st = af.FusedAdafactorState(state.count, *({n: t.clone() for n, t in d.items()}
                                                   for d in (state.v_row, state.v_col, state.v)))
        before = af.launches_apply
        st = af.apply_updates(grads, ps, st, lr=1e-3, scale=scale, finite=True, dims=dims,
                              use_kernel=use_kernel)
        torch.cuda.synchronize()
        out[use_kernel] = (ps, st, af.launches_apply - before)
    (pk, sk, nk), (pp, sp, npl) = out[True], out[False]

    def share(got, ref, atol):  # 0 where equal: a [1] placeholder holds 0 on both sides
        diff = (got - ref).abs()
        return float(torch.where(diff == 0, 0.0, diff / (AF_PARAM_RTOL * ref.abs() + atol)).max())

    stats = [(getattr(sk, key)[n], getattr(sp, key)[n]) for key in ("v_row", "v_col", "v")
             for n in pk]
    return {"params_over_limit": max(share(pk[n], pp[n], AF_PARAM_ATOL) for n in pk),
            "params_max_abs": max(float((pk[n] - pp[n]).abs().max()) for n in pk),
            "stats_over_limit": max(share(a, b, AF_STAT_ATOL_OF_MAX * float(b.abs().max()))
                                    for a, b in stats),
            "stats_max_rel": max(float(((a - b).abs() / b.abs().max().clamp_min(1e-30)).max())
                                 for a, b in stats),
            "stats_max_abs": max(float((a - b).abs().max()) for a, b in stats),
            "kernel_leaves": nk, "plain_launches": npl}


def agrees_adafactor_update(r, leaves):
    return (r["plain_launches"] == 0 and r["kernel_leaves"] == leaves
            and r["params_over_limit"] <= 1.0 and r["stats_over_limit"] <= 1.0)


def _log_update(label, r):
    log(f"{label}: kernels ({r['kernel_leaves']} leaves) vs plain formulas "
        f"({r['plain_launches']} kernel launches): params max abs {r['params_max_abs']:.3e}, "
        f"worst {r['params_over_limit']:.3f} of the limit {AF_PARAM_RTOL:g} |ref| + "
        f"{AF_PARAM_ATOL:g}; v_row / v_col / v max abs {r['stats_max_abs']:.3e} (of the leaf's "
        f"largest value {r['stats_max_rel']:.3e}), worst {r['stats_over_limit']:.3f} of the "
        f"limit {AF_PARAM_RTOL:g} |ref| + {AF_STAT_ATOL_OF_MAX:g} max|ref|")


def adafactor_update_check(trainer, batch):
    """One Adafactor update of the trainer's params on one batch's clipped
    gradients, through the kernels and through the plain formulas on the
    card, from the same params and state: within the stated limits."""
    from orion_tpu_torch.ops.kernels import adafactor as af

    trainer._loss_and_grads(batch.to(trainer.device), 0)
    grads = {n: p.grad for n, p in trainer.params.items()}
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = torch.clamp(trainer.cfg.clip_norm / gnorm, max=1.0)
    r = adafactor_update_reading(af, grads, trainer.params, trainer.opt.state, trainer.opt.dims,
                                 scale)
    for p in trainer.params.values():
        p.grad = None
    _log_update("adafactor update", r)
    if not agrees_adafactor_update(r, _af_kernel_leaves(trainer.params)):
        raise AssertionError("the fused Adafactor update disagrees with the plain formulas")
    return r


def compare_adafactor_update(af, dev):
    """One update of one leaf of each of lm_1b3's factored shapes and a norm
    scale, zero state, through the kernels and the plain formulas: gradients
    at the scale of lm_1b3's after its clip (norm 1 over 1.3 G params, rms
    2.8e-5), so the statistics are as small as the main path's."""
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = {label: (m, n) for label, m, n in AF_CASES if label in AF_PER_STEP}
    shapes["norm"] = (2048,)
    params = {k: torch.randn(s, device=dev, generator=g) * 0.02 for k, s in shapes.items()}
    grads = {k: torch.randn(s, device=dev, generator=g) * 2.8e-5 for k, s in shapes.items()}
    dims = {k: af.factored_dims(s, transposed=len(s) == 2) for k, s in shapes.items()}
    r = adafactor_update_reading(af, grads, params, af.init(params, dims), dims, 1.0)
    r["agrees"] = agrees_adafactor_update(r, len(AF_PER_STEP))
    return r


def grad_check(dev, name, seq_len, batch_size=8, overrides=None):
    """One batch's loss and every parameter's gradient through the kernels
    (backend="cuda") against backend="torch", same weights and, for a MoE
    model, the same expert choices (``PinnedRouting``), on the card."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import lm_loss

    cfg = get_config(name, **(overrides or {}))
    batch = device_batch(SyntheticDataset(cfg.vocab_size, seq_len), 0, 99, batch_size, dev)
    grads, losses = {}, {}
    weights = None
    pin = PinnedRouting()
    for backend in ("cuda", "torch"):
        model = TransformerLM(dataclasses.replace(cfg, backend=backend), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(3))
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        with pin:  # the backward's recomputation routes inside it too
            loss = lm_loss(pin.attach(model), batch)
            loss.backward()
        losses[backend] = float(loss.detach())
        if backend == "cuda":
            pin.flips = pin.choices = 0  # count the reference's choices only
        missing = [n for n, p in model.named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"backend={backend}: no gradient for {missing[:5]} "
                                 f"({len(missing)} params)")
        grads[backend] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
        torch.cuda.empty_cache()
    rel = {n: float((g - grads["torch"][n]).norm() / grads["torch"][n].norm().clamp_min(1e-30))
           for n, g in grads["cuda"].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads["cuda"].values())
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    loss_err = abs(losses["cuda"] - losses["torch"])
    by_kind = {}
    for n, r in rel.items():
        kind = n.split(".", 2)[-1] if n.startswith("blocks.") else n
        by_kind[kind] = max(by_kind.get(kind, 0.0), r)
    log(f"{name} grad check B{batch_size} T{seq_len}, kernels vs backend='torch': loss "
        f"{losses['cuda']:.6f} vs {losses['torch']:.6f} (diff {loss_err:.3e}, limit "
        f"{LM_LOSS_ATOL:g}); every one of {len(rel)} params has a gradient; relative L2 error, "
        f"largest per kind { {k: float(f'{v:.3e}') for k, v in by_kind.items()} } (limit "
        f"{LM_GRAD_REL_L2:g}); worst {[(n, float(f'{r:.3e}')) for n, r in worst]}")
    if pin.choices:
        log(f"{name} grad check routing: the reference would have sent {pin.flips} of "
            f"{pin.choices} token choices (forward and recomputation) to other experts; it "
            "takes the kernel run's")
    del grads, weights
    torch.cuda.empty_cache()
    if not finite or loss_err > LM_LOSS_ATOL or worst[0][1] > LM_GRAD_REL_L2:
        raise AssertionError(f"{name} gradients through the kernels disagree with backend='torch'")
    return {"loss_abs_err": loss_err, "grad_rel_l2_max": worst[0][1], "by_kind": by_kind,
            "routing_flips": pin.flips}


def tiny_train(dev, model_cfg, label, batch_size=4, optimizer="adamw"):
    """3 fp32 training steps of a small model on the card and on the CPU
    from the same weights and batches: the loss sequences must agree. With
    ``adafactor_fused`` the kernels' gate is lowered so that every factored
    leaf takes them on the card (on the CPU, their plain versions)."""
    from orion_tpu_torch.ops.kernels import adafactor as af
    from orion_tpu_torch.training.data import SyntheticDataset
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=model_cfg, steps=3, batch_size=batch_size, seq_len=128,
                      warmup_steps=1, lr=1e-3, optimizer=optimizer)
    cpu, gpu = Trainer(cfg, device="cpu"), Trainer(cfg, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    ds = SyntheticDataset(model_cfg.vocab_size, cfg.seq_len)
    got, ref = [], []
    gate, before = af._MIN_KERNEL_ELEMS, af.launches_apply
    if optimizer == "adafactor_fused":
        af._MIN_KERNEL_ELEMS = 0
    try:
        for step in range(3):
            b = torch.from_numpy(ds.batch(0, step, cfg.batch_size)).long()
            got.append(gpu.step(b.to(dev))["loss"])
            ref.append(cpu.step(b)["loss"])
    finally:
        af._MIN_KERNEL_ELEMS = gate
    if optimizer == "adafactor_fused":
        want = 3 * sum(p.dim() == 2 for p in gpu.params.values())
        if af.launches_apply - before != want:
            raise AssertionError(f"{label}: {af.launches_apply - before} apply launches, want {want}")
    err = max(abs(a - b) for a, b in zip(got, ref))
    log(f"{label} fp32 train, card vs CPU: losses {got} vs {ref}, max diff {err:.3e} "
        f"(limit {TINY_LOSS_ATOL:g})")
    if err > TINY_LOSS_ATOL:
        raise AssertionError(f"{label} training on the card disagrees with the CPU")
    return {"loss_max_abs_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 1
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, q4_matmul

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_info()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    mods = (causal_dot, flash_attention, gmm, q4_matmul, adafactor)
    build(mods)
    check_causal_dot(causal_dot, dev)
    kernels = check_training_kernels(causal_dot, dev)
    kernels += check_raw(causal_dot, dev)
    kernels += check_flash(flash_attention, dev)
    kernels += check_gmm(gmm, dev)
    kernels += check_q4(q4_matmul, dev)
    kernels += check_adafactor(adafactor, dev)
    log(f"kernel phases done in {time.perf_counter() - t0:.1f} s")
    op = op_phase(dev, mods)
    tiny_hybrid = dataclasses.replace(TINY, layer_types=("swa", "linear"), window=16)

    lm_gen = generate_phase(dev, mods, "lm_1b3", 1024, 32)
    tiny_generate(dev, TINY, "tiny")
    lm_train = train_phase(dev, mods, "lm_1b3", 1024)
    grad_check(dev, "lm_1b3", 1024)
    tiny_train(dev, TINY, "tiny")
    log(f"lm_1b3 phases done at {time.perf_counter() - t0:.1f} s")

    hy_gen = generate_phase(dev, mods, "hybrid_1b3", 1536, 64)
    tiny_generate(dev, tiny_hybrid, "tiny hybrid (swa, linear; window 16)")
    hy_train = train_phase(dev, mods, "hybrid_1b3", 2048)
    grad_check(dev, "hybrid_1b3", 2048)
    tiny_train(dev, tiny_hybrid, "tiny hybrid (swa, linear; window 16)")
    log(f"hybrid_1b3 phases done at {time.perf_counter() - t0:.1f} s")

    dropless = {"moe_dropless": True}
    moe_gen = generate_phase(dev, mods, "moe_1b3_4e", 1024, 32, dropless)
    moe_train = train_phase(dev, mods, "moe_1b3_4e", 1024, dropless)
    grad_check(dev, "moe_1b3_4e", 1024, overrides=dropless)
    tiny_moe = dataclasses.replace(TINY, n_experts=4, moe_period=2)
    for form, over in (("capacity", {}), ("dropless", dropless)):
        label = f"tiny MoE (4 experts in block 1, {form})"
        tiny_generate(dev, dataclasses.replace(tiny_moe, **over), label)
        before = gmm.launches_fwd
        # batch 8 x 128: 1024 routed rows, the card's tile-aligned form in fp32
        tiny_train(dev, dataclasses.replace(tiny_moe, **over), label, batch_size=8)
        if form == "dropless" and gmm.launches_fwd == before:
            raise AssertionError("the tiny dropless MoE trained on the card without the gmm "
                                 "kernels")
    log(f"moe_1b3_4e phases done at {time.perf_counter() - t0:.1f} s")

    lm_int4 = quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int4")
    quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int8")
    moe_int4 = quant_generate_phase(dev, mods, "moe_1b3_4e", 1024, 32, "int4", dropless)
    tiny_generate(dev, TINY, "tiny int4", quant="int4")
    tiny_generate(dev, tiny_hybrid, "tiny hybrid (swa, linear; window 16) int4", quant="int4")
    log(f"lm_1b3 int4 decode {lm_int4['decode_ms_per_token']:.3f} ms/token against bf16's "
        f"{lm_gen['decode_ms_per_token']:.3f} in this run")
    af_train = train_phase(dev, mods, "lm_1b3", 1024, optimizer="adafactor_fused",
                           then=lambda trainer: load_phase(dev, mods, trainer))
    loaded = af_train["then"]
    tiny_train(dev, TINY, "tiny adafactor_fused", optimizer="adafactor_fused")
    log(f"lm_1b3 adafactor_fused step {af_train['step_ms']:.2f} ms against AdamW's "
        f"{lm_train['step_ms']:.2f} in this run")
    log(f"quantized serving and Adafactor phases done at {time.perf_counter() - t0:.1f} s")

    for k in kernels:
        if k["name"] in ("causal_dot", "causal_dot_rev"):  # the public op, fwd + bwd
            k["launches"] = op["launches"][k["name"]]
            continue
        if k["name"].startswith("q4"):  # the main path: lm_1b3 int4 generate
            k["launches"] = lm_int4["launches"][k["name"]]
            k["launches_loaded_int4_generate"] = loaded["int4"]["launches"][k["name"]]
            k["launches_moe_1b3_4e_int4"] = moe_int4["launches"][k["name"]]
            k["launches_per_decode_step"] = lm_int4["q4_per_step"]
            continue
        if k["name"].startswith("adafactor"):  # the main path: lm_1b3 adafactor_fused training
            k["launches"] = af_train["launches"][k["name"]]
            k["launches_per_step"] = af_train["per_step"][0][k["name"]]
            continue
        main_train, main_gen = (moe_train, moe_gen) if k["name"].startswith("gmm") else (
            hy_train, hy_gen)
        k["launches"] = main_train["launches"][k["name"]]
        k["launches_generate"] = main_gen["launches"][k["name"]]
        k["launches_per_step"] = main_train["per_step"][0][k["name"]]
        if k["name"].startswith("causal_dot"):
            k["launches_lm_1b3"] = {"train": lm_train["launches"][k["name"]],
                                    "generate": lm_gen["launches"][k["name"]]}
            k["launches_moe_1b3_4e"] = {"train": moe_train["launches"][k["name"]],
                                        "generate": moe_gen["launches"][k["name"]]}
            k["launches_loaded_generate"] = loaded["bf16"]["launches"][k["name"]]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
