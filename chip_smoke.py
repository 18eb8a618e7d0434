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
     cotangents, and at Dv 96 and the tiny fp32 widths; each case logs the
     variant each kernel took (wgmma for bf16 at D 128, simt for the rest);
     the wgmma kernels are timed at the training shape (row 1 also at
     generate's), the simt kernels at the tiny fp32 widths;
   - the public op ``causal_dot_product``'s kernels (rows 2, 5): the raw
     forward, its use as the dq pass on (g, v, k, S0^T), and the reverse
     pass, at lm_1b3's per-layer shape [B*H, T, D] = [128, 1024, 128] bf16,
     a ragged T 1000, T 1, Dk 128 with Dv 64 and fp32 at D 32, with and
     without S0 and a cotangent on the final state, every output written
     over NaN; each case logs the variants rows 2 and 5 took (row 2: wgmma
     for bf16 at Dk 128 with Dv a multiple of 64: the forward everywhere in
     bf16 and the dq pass but at Dv 64, whose contracted width it is; row 5:
     wgmma for bf16 at Dk = Dv = 128; simt for the rest); row 2's wgmma
     kernel timed as the op's forward, its simt kernel as the dq pass of the
     op at Dv 64, row 5's wgmma kernel at [128, 1024, 128] and its simt
     kernel at the op's Dv 64, both seeded by dSf;
   - flash attention (rows 6, 7, 8): forward, dq and dk/dv at hybrid_1b3's
     generate shape (B 4, H 16, T 1536, D 128, bf16, window 1024) and
     training shape (B 8, T 2048), a ragged T 2000, T 1, T 512 (below the
     window), causal without a window, bidirectional, Tq 1000 against Tk
     1500, D 64 in bf16 and the tiny widths (D 32, fp32); each case logs the
     variant the backward took (wgmma for bf16 at D 128, simt for the
     rest); the wgmma backward is timed at the training shape, the simt
     backward at the tiny fp32 widths (its path);
   - the grouped expert matmul (rows 9, 10): forward, dx (against w^T) and
     dw at moe_1b3_4e's training shape (8192 routed rows, d 2048, h 5504, 4
     experts) for the gate/up and the down products, the prefill shape (4096
     rows), top-2 routing, an expert without rows, N and K past the tiles
     (d 100, h 200), fp32 at the tiny widths, and d 200, h 328 with an expert
     without rows (the wgmma route's zero-filled tails); each case logs the
     variant each product took (wgmma for bf16 at widths a multiple of 8,
     simt for the rest); the wgmma kernels are timed at the training shape,
     the simt kernels at the tiny widths in fp32 (their path);
   - the int4 dequant-matmul (row 14): lm_1b3's decode shapes (x [64, 2048]
     against p [1024, 2048] and [1024, 5504], x [64, 5504] against p [2752,
     2048]: a decode step's rows padded to 64), B 1, B 4, 1000 packed rows, a
     last strip of 16 channels (the
     mma variant's edges), an out of 200, a ragged d 100, d 2004 and fp32
     (the simt variant's); each case logs its variant (mma for bf16 x with
     d % 8 == 0 and out % 16 == 0); mma timed at the three decode shapes
     and over a decode step's 168 calls, simt at the tiny models' fp32
     widths;
   - the fused Adafactor passes (rows 11-13): sums, squared sum and apply at
     lm_1b3's factored shapes ([32000, 2048], [5504, 2048], [2048, 5504],
     [2048, 2048]) and ragged m and n, each gradient with an all-zero row and
     column, apply with the flag 0 (p bitwise untouched);
   time every kernel, its plain version and, where one PyTorch call computes
   the same function, that call (``scaled_dot_product_attention``,
   ``torch._grouped_mm``; none for rows 1-5 and 11-14), each by CUDA events over
   calls back to back (``cuda_ms``), and for rows 11-14 also the kernel's
   device time alone (``graph_ms``); print each kernel's bound beside its
   time; for rows 9-10 and 14 also the wrapper's host time a call
   (``host_us``: gmm's wgmma variant encodes its tensor maps at each call,
   q4's mma variant once a weight);
4. the public op ``orion_tpu_torch.ops.causal_dot_product``, forward and
   backward through ``CausalDotProductFn`` at [B 8, H 16, T 1024, D 128]
   bf16 with an initial state and the returned state, then at Dk 128, Dv
   64: exact launches (row 2 twice on its wgmma kernel and row 5 once on
   its wgmma kernel; at Dv 64 the dq pass on row 2's simt kernel and the
   reverse pass on row 5's), every count set to 0 just
   before each, out, S and every gradient against the plain form
   differentiated by autograd;
5. the generate path, for ``lm_1b3`` (4 prompts of 1024 byte tokens, 32
   greedy new tokens), for ``hybrid_1b3`` (4 prompts of 1536, longer than
   its window, 64 tokens) and for ``moe_1b3_4e`` with ``moe_dropless=True``
   (4 prompts of 1024, 32 tokens): ``orion_tpu_torch.generate.generate`` at full
   width (seeded random weights), with every kernel's launch count reset
   just before and read just after (then generated twice more: decode
   ms/token from the median of the three, as the card machine's shared host
   spreads it); the prefill's logits and every layer's
   decode state against a ``backend="torch"`` run of the same weights on the
   card; and a ``tiny`` model of the same layer kinds on the card against
   the same model on the CPU, whose plain path the CPU tests hold against
   the JAX package;
6. the training path, for ``lm_1b3`` (batch 8 x 1024), ``hybrid_1b3``
   (batch 8 x 2048) and the dropless ``moe_1b3_4e`` (batch 8 x 1024):
   ``Trainer`` at full width, synthetic data, AdamW, remat
   as the config sets it, 1 warm-up and 3 timed steps, with the counts reset
   just before and read after every step (exact counts per step, from the
   layer kinds and the rematerialized blocks; every linear-attention,
   flash and gmm launch of the wgmma variant, none of the simt); then one
   batch's loss and
   every parameter's gradient through the kernels against
   ``backend="torch"`` on the same weights (every parameter must get a
   gradient); then 3 ``tiny`` fp32 steps on the card against the CPU, which
   launch only simt kernels (for
   the hybrid a tiny hybrid, whose fp32 D 32 layers take the simt kernels of
   rows 1, 3, 4, 6, 7 and 8 and no wgmma one, their launches counted from 0; for
   the MoE a tiny MoE in its capacity and its dropless form, the latter at
   1024 routed rows, so the card takes the simt gmm kernels in fp32, their
   launches counted from 0, and the CPU the ragged form);
7. quantized serving: ``generate(..., quant=...)`` of ``lm_1b3`` at int4 and
   int8 and of the dropless ``moe_1b3_4e`` at int4 (4 prompts of 1024, 32
   greedy tokens; weights quantized once from seeded fp32 ones), exact launch
   counts (one q4 launch per int4 layer and decode step, all on the mma
   kernel: 168 for lm_1b3, 150 for the MoE, whose expert stacks stay int8;
   none in the prefill or at int8), the prefill's and 8 decode steps'
   logits against ``backend="torch"`` on the same quantized weights;
   ``tiny`` and a tiny hybrid at int4 in fp32, the card (the simt kernel,
   every decode launch) against the CPU (the split form);
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
10. the model and training options at ``lm_1b3``'s width: the ``favor``
   feature map, then ``learnable`` with the untied head, each through
   ``generate`` (4 x 1024, 32 greedy tokens), AdamW training (B 8 x 1024)
   and the gradient check against ``backend="torch"``, every launch of rows
   1, 3 and 4 on their wgmma kernels (exact counts) and held against its
   plain version on the same inputs at the kernel limits of phase 3
   (``LaunchAudit``, in the prefill and the gradient check); first the plain
   path against itself with its sums in another order (``plain_spread``):
   where that spread alone misses the model-level limits (``favor``: the
   exp of FAVOR+ amplifies each bf16 flip), those limits are read, not
   failed (``FAVOR_NOTE``); ``learnable`` with the
   untied head at int8 (the int8 ``lm_head_kernel_q``, all 24 blocks); ``remat_policy=
   "dots"`` training beside "full"'s step ms and peak memory in the same
   run, its first loss bitwise "full"'s and its gradients within the
   gradient check's limits of "full"'s; ``sr_round_bf16`` on the card
   bitwise the CPU's; 5 steps with ``param_storage="bfloat16_sr"`` (matrix
   params bf16, step ms and peak memory beside fp32 storage's);
11. LRA: ``train_lra`` on each of the four ``lra_*`` configs at full width
   and LRA's lengths (ListOps T 2000 at batch 32, Text T 4000 at batch 16),
   8 steps and an eval of 2 batches on the synthetic task (step ms, peak
   memory, final loss and accuracy; no kernel launches: the classifier's
   masked bidirectional attention is plain torch, as in the JAX package),
   3 steps on ``data/lra_sample``'s TSVs, and one batch of 2 at the full T
   on the card against the CPU (logits and loss within 1e-4 of their
   largest magnitude, every gradient within 1e-4 relative L2, fp32 without
   TF32: ``LRA_GRAD_REL_L2``);
12. serving through ``serving.SlotEngine`` at 4 slots, chunk 16, on
   ``lm_1b3`` (6 requests of 1024, 640, 300, 1000, 77 and 512 prompt
   tokens, 32 new tokens each, two arriving at later boundaries), in bf16
   and at int4, and on ``hybrid_1b3`` (prompts of 1536 and 1100, past the
   1024-key window, and one of 200 that in-scan arrives while the 1100 is
   mid-prefill): first the decode products' row invariance (C1,
   ``row_forms``: candidate forms of the products at 4 and 8 rows against
   one; ``row_invariance``: a 4-row ``decode_step`` against its row 2 alone,
   op by op, with the rows padded to ``DECODE_ROWS`` and without), then
   each plan served twice, admitted by host prefill (solo, at the prompt's
   length) and in-scan (pieces of 256), exact launches (row 1 on its wgmma
   kernel once for each linear layer of a solo prefill and of a unified
   boundary's piece, row 6 once for each swa layer of a solo prefill, row
   14 168 a decode step at int4 whatever the busy slots); the contracts of
   PERF.md: (b) a request alone bitwise its tokens in company, and with an
   EOS stopping another early, (c) at every boundary the free and held
   slots' rows, rings included, bitwise, (d) extract / insert round trip,
   (f) every request, greedy and sampled, bitwise a one-row ``generate``
   at its seed, (g) pieces against ``prefill_last``; in-scan admission
   bitwise host admission for lm_1b3 (the hybrid's within the logits
   limit); the engine's ladder with NaN in one slot's rows (the rewind
   bitwise, the re-prefill held as ``DecodeSession``'s rung, an exhausted
   ladder failing one request only), suspend and resume bitwise the
   uninterrupted request; ``DecodeSession`` on lm_1b3, its tokens bitwise
   ``generate``'s (a), with a NaN injected (rewind bitwise (e),
   re-prefill, ``LadderExhausted``); decode ms/token at 4 busy slots through
   the engine and a 256-token piece's boundary cost; each phase's time;
   then the same requests through ``serving.Server`` (all submitted, then
   ``serve()``), each bitwise the engine run's: lm_1b3 bf16 greedy and
   sampled by both admissions, lm_1b3 with ``qmode="int4"`` (the Server
   quantizes the fp32 weights) and hybrid_1b3 (host admission: row 6 in its
   solo prefills) greedy and sampled, exact launches from the Server's own
   admissions and pieces; on lm_1b3 also overload (``max_inflight=2``: 4 of
   6 shed and counted), a real SIGTERM at boundary 3 with the plan queued
   beyond the slots (``serve()`` returns 0, health SERVING -> DRAINING ->
   DEAD, every request bitwise, a later submit rejected), readings (decode
   ms/token at 4 busy slots through the Server and the bare engine in
   turns, the registry's chunk_ms p50 / p99 buckets, a late request's time
   to first token) and ``python -m orion_tpu_torch.serving`` in a
   subprocess on the card, SIGTERM after its first boundary: exit 0 and its
   stats line;
13. a ``kernels`` JSON line (25 entries: the 14 rows, rows 1-10 and 14
   once for each variant; rows 1, 3 and 4 also with their launches under
   the options of phase 10, rows 1, 6 and 14 on the serving path, through
   ``SlotEngine`` and through the Server), then the result line ``{"ok":
   true, "device": {...}}`` last.
"""

import contextlib
import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import threading
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
# fp32 outputs (the simt variant's tiny widths): quotients of fp32 sums in
# another order, about 1e-6 apart
OUT_RTOL_FP32 = 1e-4
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

KERNELS = ("causal_dot_norm_wgmma", "causal_dot_norm_simt", "causal_dot_wgmma", "causal_dot_simt",
           "causal_dot_dq_den_wgmma", "causal_dot_dq_den_simt", "causal_dot_rev_den_wgmma",
           "causal_dot_rev_den_simt", "causal_dot_rev_wgmma", "causal_dot_rev_simt",
           "flash_fwd_wgmma", "flash_fwd_simt",
           "flash_dq_wgmma", "flash_dkv_wgmma", "flash_dq_simt", "flash_dkv_simt", "gmm_fwd_wgmma", "gmm_dw_wgmma", "gmm_fwd_simt", "gmm_dw_simt",
           "q4_matmul_mma", "q4_matmul_simt", "adafactor_sums", "adafactor_rms", "adafactor_apply")


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
                if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                    log("  ptxas:", line.strip())


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _bound(moved, flops, peak=BF16_FLOPS):
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# ---------------------------------------------------------------------------
# Linear attention: rows 1, 3, 4
# ---------------------------------------------------------------------------


# (label, B, H, T, Dk, Dv, dtype, initial state): the generate path's width
# (B 4, H 16, D 128, bf16: the wgmma variant) at T 1024, a ragged 1000 and 1,
# from the state a 256-token prefix leaves and from a zero state (what
# prefill gives the kernel); then the simt variant's: bf16 at a Dv that is
# not a multiple of 64, and the tiny models' fp32 widths
NORM_CASES = [
    ("B4 H16 T1024 D128 bf16 state", 4, 16, 1024, 128, 128, torch.bfloat16, True),
    ("B4 H16 T1000 D128 bf16 state", 4, 16, 1000, 128, 128, torch.bfloat16, True),
    ("B4 H16 T1 D128 bf16 state", 4, 16, 1, 128, 128, torch.bfloat16, True),
    ("generate: B4 H16 T1024 D128 bf16", 4, 16, 1024, 128, 128, torch.bfloat16, False),
    ("B4 H16 T1024 Dk128 Dv96 bf16 state", 4, 16, 1024, 128, 96, torch.bfloat16, True),
    ("tiny widths: B2 H4 T300 D32 fp32 state", 2, 4, 300, 32, 32, torch.float32, True),
]


def _norm_inputs(g, dev, b, h, t, dk, dv, dtype, with_state, prefix=256):
    """q, k phi-mapped, v, [B*H, T, D] in ``dtype``; with ``with_state`` the
    fp32 state (S0, z0) a ``prefix``-token prefix of the same kind leaves."""
    bh = b * h

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    q = phi(torch.randn(bh, t, dk, device=dev, generator=g)).to(dtype)
    k = phi(torch.randn(bh, t, dk, device=dev, generator=g)).to(dtype)
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = z0 = None
    if with_state:
        kp = phi(torch.randn(bh, prefix, dk, device=dev, generator=g)).to(dtype).float()
        vp = torch.randn(bh, prefix, dv, device=dev, generator=g).to(dtype).float()
        s0, z0 = kp.transpose(1, 2) @ vp, kp.sum(1)
    return q, k, v, s0, z0


def compare_causal_dot(cd, dev):
    """Row 1 against its plain version on the card, on every case of
    ``NORM_CASES``, in the variant ``causal_dot_norm_variant`` names.
    Returns one reading per case (with its variant) and the inputs of each
    case by label. ``out_over_limit`` is the largest |out - ref| as a share
    of its limit ``OUT_ATOL + rtol |ref|`` (above 1 fails; rtol one bf16
    step, ``OUT_RTOL``, for bf16 outputs, ``OUT_RTOL_FP32`` for fp32 ones);
    ``out_atol_needed`` the smallest absolute term that this case alone
    would need beside rtol."""
    g = torch.Generator(device=dev).manual_seed(0)
    readings, inputs = [], {}
    for label, b, h, t, dk, dv, dtype, with_state in NORM_CASES:
        q, k, v, s0, z0 = _norm_inputs(g, dev, b, h, t, dk, dv, dtype, with_state)
        out, sf, zf = cd.causal_dot_norm_cuda(q, k, v, s0, z0)
        torch.cuda.synchronize()
        r_out, r_s, r_z = cd.causal_dot_norm_plain(q, k, v, s0, z0)
        rtol = OUT_RTOL if dtype == torch.bfloat16 else OUT_RTOL_FP32
        diff, ref = (out.float() - r_out.float()).abs(), r_out.float().abs()
        readings.append({
            "case": label, "variant": cd.causal_dot_norm_variant(q, k, v),
            "out_max_abs": float(diff.max()), "ref_max_abs": float(ref.max()),
            "out_over_limit": float((diff / (OUT_ATOL + rtol * ref)).max()),
            "out_atol_needed": float((diff - rtol * ref).clamp_min(0).max()),
            "s_rel": _rel(sf, r_s), "z_rel": _rel(zf, r_z),
            "well_formed": out.shape == v.shape and out.dtype == dtype
            and bool(torch.isfinite(out.float()).all()),
        })
        inputs[label] = (q, k, v)
    return readings, inputs


def agrees(r):
    return (r["well_formed"] and r["out_over_limit"] <= 1.0
            and r["s_rel"] <= STATE_RTOL and r["z_rel"] <= STATE_RTOL)


def _norm_bound(q, v, with_parts):
    """Row 1's bound on these inputs: q, k, v read; out, S, z written (with
    ``with_parts`` also the fp32 num and den); one chunk walk's products
    (A, A v, q S and the state update at chunk 64)."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    act = q.element_size()
    moved = bh * t * (2 * dk + 2 * dv) * act + bh * dk * dv * 4 + bh * dk * 4
    if with_parts:
        moved += bh * t * dv * 4 + bh * t * 4
    chunk = 64
    flops = 2 * bh * t * (chunk * dk + chunk * dv + 2 * dk * dv)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    return moved, flops, _bound(moved, flops, peak)


def check_causal_dot(cd, dev):
    """Row 1: agreement on every case, each case's variant logged (both must
    run), then timings where each variant's path takes it: the wgmma kernel
    at the generate path's shape (B 4, H 16, T 1024, D 128, bf16, no initial
    state), the simt kernel at the tiny fp32 widths. Returns the generate
    shape's timing (for the wgmma entry of the kernels line, which
    ``check_training_kernels`` writes) and the simt entry."""
    readings, inputs = compare_causal_dot(cd, dev)
    for r in readings:
        log(f"causal_dot_norm {r['case']} ({r['variant']}): out max abs {r['out_max_abs']:.3e} "
            f"(max |ref| {r['ref_max_abs']:.3f}), {r['out_over_limit']:.3f} of its limit, needs "
            f"atol {r['out_atol_needed']:.3e}; S rel {r['s_rel']:.3e}, z rel {r['z_rel']:.3e} "
            f"(limit {STATE_RTOL:g})")
        if not agrees(r):
            raise AssertionError(f"causal_dot_norm disagrees with its plain version: {r}")
    ran = {v: sum(r["variant"] == v for r in readings) for v in ("wgmma", "simt")}
    log(f"causal_dot_norm variants over the {len(readings)} cases: {ran}")
    if not all(ran.values()):
        raise AssertionError(f"a causal_dot_norm variant ran on no case: {ran}")
    timed = {}
    with torch.no_grad():
        for label, variant in (("generate: B4 H16 T1024 D128 bf16", "wgmma"),
                               ("tiny widths: B2 H4 T300 D32 fp32 state", "simt")):
            q, k, v = inputs[label]
            if cd.causal_dot_norm_variant(q, k, v) != variant:
                raise AssertionError(f"causal_dot_norm at {label} took the other variant")
            ms = cuda_ms(lambda: cd.causal_dot_norm_cuda(q, k, v), 20)
            plain_ms = cuda_ms(lambda: cd.causal_dot_norm_plain(q, k, v), 5)
            moved, flops, (bound_ms, bound_by) = _norm_bound(q, v, False)
            log(f"causal_dot_norm {variant} timing {label}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP); library_ms: none (no single PyTorch call computes "
                "this function)")
            timed[variant] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None, "shape": label}
    simt = {"name": "causal_dot_norm_simt", "route": "cuda",
            "source": "orion_tpu_torch/csrc/causal_dot_norm.cu",
            "replaces": "orion_tpu/ops/pallas/causal_dot.py:537",
            "max_abs_err": max(r["out_max_abs"] for r in readings if r["variant"] == "simt"),
            **timed["simt"]}
    return {"generate_shape": timed["wgmma"], "simt": simt}


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


# (label, B, H, T, Dk, Dv, dtype, initial state and final-state cotangents):
# lm_1b3's training width (B 8, H 16, D 128, bf16: the wgmma variants of
# rows 1, 3 and 4) at T 1024, a ragged 1000 and 1; then their simt variants,
# row 1 with its training outputs: bf16 at Dv 96, and the tiny models' fp32
# widths
TRAINING_CASES = [
    (f"B8 H16 T{t} D128 bf16 state={st}", 8, 16, t, 128, 128, torch.bfloat16, st)
    for t in (1024, 1000, 1) for st in (False, True)
] + [
    ("B2 H16 T1000 Dk128 Dv96 bf16 state=True", 2, 16, 1000, 128, 96, torch.bfloat16, True),
    ("B2 H4 T300 D32 fp32 state=True", 2, 4, 300, 32, 32, torch.float32, True),
]


def _training_case(g, dev, b, h, t, dk, dv, dtype, with_state):
    """Inputs of one linear layer's training step: q, k phi-mapped, v, the
    output's cotangent; with ``with_state`` also an initial state (a
    256-token prefix's) and cotangents of the final state at the scale of
    what the walk itself accumulates (about 0.05)."""
    bh = b * h
    q, k, v, s0, z0 = _norm_inputs(g, dev, b, h, t, dk, dv, dtype, with_state)
    gout = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    gsf = gzf = None
    if with_state:
        gsf = 0.05 * torch.randn(bh, dk, dv, device=dev, generator=g)
        gzf = 0.05 * torch.randn(bh, dk, device=dev, generator=g)
    return q, k, v, gout, s0, z0, gsf, gzf


def compare_training_kernels(cd, dev):
    """Rows 1 (with its training outputs num, den), 3 and 4 against their
    plain versions on the card, on every case of ``TRAINING_CASES``, each in
    the variant its chooser names. The backward kernels and their plain
    versions take the same inputs: the plain forward's num and den through
    ``quotient_rule``. Returns one reading per case (with the three
    variants) and each case's backward inputs (q, k, v, gnum, gden) by
    label."""
    g = torch.Generator(device=dev).manual_seed(1)
    readings, inputs = [], {}
    for label, b, h, t, dk, dv, dtype, with_state in TRAINING_CASES:
        q, k, v, gout, s0, z0, gsf, gzf = _training_case(g, dev, b, h, t, dk, dv, dtype,
                                                         with_state)
        out, sf, zf, num, den = cd.causal_dot_norm_cuda(q, k, v, s0, z0, with_parts=True)
        r_out, r_sf, r_zf, r_num, r_den = cd.causal_dot_norm_plain(
            q, k, v, s0, z0, with_parts=True)
        gnum, gden = cd.quotient_rule(gout, r_num, r_den, 1e-6, q.dtype)
        dq = cd.causal_dot_dq_den_cuda(gnum, v, k, gden, s0, z0)
        dk_, dv_, ds0, dz0 = cd.causal_dot_rev_den_cuda(q, k, v, gnum, gden, gsf, gzf)
        torch.cuda.synchronize()
        r_dq = cd.causal_dot_dq_den_plain(gnum, v, k, gden, s0, z0)
        r_dk, r_dv, r_ds0, r_dz0 = cd.causal_dot_rev_den_plain(q, k, v, gnum, gden, gsf, gzf)
        readings.append({
            "case": label, "variant": cd.causal_dot_norm_variant(q, k, v),
            "dq_variant": cd.causal_dot_dq_den_variant(gnum, v, k),
            "rev_variant": cd.causal_dot_rev_variant(q, k, v, gnum),
            "out": _grad_reading(out, r_out),
            "num_rel": _rel(num, r_num), "den_rel": _rel(den, r_den),
            "dq": _grad_reading(dq, r_dq), "dk": _grad_reading(dk_, r_dk),
            "dv": _grad_reading(dv_, r_dv),
            "ds0_rel": _rel(ds0, r_ds0), "dz0_rel": _rel(dz0, r_dz0),
            "states_finite": all(bool(torch.isfinite(x).all()) for x in (num, den, ds0, dz0)),
        })
        inputs[label] = (q, k, v, gnum, gden)
    return readings, inputs


def agrees_training(r):
    return (r["states_finite"] and r["out"]["well_formed"]
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0 for n in ("dq", "dk", "dv"))
            and r["out"]["max_abs"] <= OUT_ATOL + OUT_RTOL * r["out"]["ref_max_abs"]
            and max(r["num_rel"], r["den_rel"], r["ds0_rel"], r["dz0_rel"]) <= STATE_RTOL)


def _bwd_bound(q, v, rev):
    """Row 3's (``rev`` False) or row 4's bound on these inputs. Row 3: g, v,
    k, gden read, dq written; row 4: q, k, v, g, gden read, dk, dv, dS0, dz0
    written. Operations: one chunk walk's products (A, A w, x St and the
    state update at chunk 64), twice for row 4's two walks."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    act = q.element_size()
    if rev:
        moved = bh * t * (3 * dk + 3 * dv) * act + bh * t * 4 + bh * dk * dv * 4 + bh * dk * 4
    else:
        moved = bh * t * (2 * dv + 2 * dk) * act + bh * t * 4
    flops = 2 * bh * t * (64 * dk + 64 * dv + 2 * dk * dv) * (2 if rev else 1)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    return moved, flops, _bound(moved, flops, peak)


def check_training_kernels(cd, dev, norm):
    """Rows 1, 3 and 4 on the training cases, each case's variants logged
    (both variants of rows 3 and 4 must run), then timed where each
    variant's path takes it: the wgmma kernels at lm_1b3's training shape
    (B 8, H 16, T 1024, D 128, bf16; row 1 with its training outputs), the
    simt kernels of rows 3 and 4 at the tiny fp32 widths. ``norm``:
    ``check_causal_dot``'s result, whose generate-shape timing joins row 1's
    wgmma entry and whose simt entry joins the kernels line."""
    readings, inputs = compare_training_kernels(cd, dev)
    for r in readings:
        log(f"training kernels {r['case']} (row 1 {r['variant']}, row 3 {r['dq_variant']}, row 4 "
            f"{r['rev_variant']}): "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("dq", "dk", "dv"))
            + f"; out max abs {r['out']['max_abs']:.3e}; rel: num {r['num_rel']:.2e} "
            f"den {r['den_rel']:.2e} dS0 {r['ds0_rel']:.2e} dz0 {r['dz0_rel']:.2e} "
            f"(limit {STATE_RTOL:g})")
        if not agrees_training(r):
            raise AssertionError(f"a training kernel disagrees with its plain version: {r}")
    for key in ("dq_variant", "rev_variant"):
        ran = {v: sum(r[key] == v for r in readings) for v in ("wgmma", "simt")}
        log(f"training kernels' {key} over the {len(readings)} cases: {ran}")
        if not all(ran.values()):
            raise AssertionError(f"a {key} ran on no training case: {ran}")
    train_label, tiny_label = TRAINING_CASES[0][0], TRAINING_CASES[-1][0]
    q, k, v, gnum, gden = inputs[train_label]
    if (cd.causal_dot_norm_variant(q, k, v), cd.causal_dot_dq_den_variant(gnum, v, k),
            cd.causal_dot_rev_variant(q, k, v, gnum)) != ("wgmma",) * 3:
        raise AssertionError("rows 1, 3, 4 at the training shape did not all take wgmma")
    lines = []
    with torch.no_grad():
        specs = [
            ("causal_dot_norm_wgmma", "orion_tpu_torch/csrc/causal_dot_norm.cu",
             "orion_tpu/ops/pallas/causal_dot.py:537", train_label,
             lambda q, k, v, gnum, gden: cd.causal_dot_norm_cuda(q, k, v, with_parts=True),
             lambda q, k, v, gnum, gden: cd.causal_dot_norm_plain(q, k, v, with_parts=True),
             # q, k, v read; out, S, z, num, den written
             lambda q, v: _norm_bound(q, v, True), "variant", ("out",)),
        ]
        for variant, label in (("wgmma", train_label), ("simt", tiny_label)):
            specs += [
                (f"causal_dot_dq_den_{variant}", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
                 "orion_tpu/ops/pallas/causal_dot.py:298", label,
                 lambda q, k, v, gnum, gden: cd.causal_dot_dq_den_cuda(gnum, v, k, gden),
                 lambda q, k, v, gnum, gden: cd.causal_dot_dq_den_plain(gnum, v, k, gden),
                 lambda q, v: _bwd_bound(q, v, False), "dq_variant", ("dq",)),
                (f"causal_dot_rev_den_{variant}", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
                 "orion_tpu/ops/pallas/causal_dot.py:335", label,
                 lambda q, k, v, gnum, gden: cd.causal_dot_rev_den_cuda(q, k, v, gnum, gden),
                 lambda q, k, v, gnum, gden: cd.causal_dot_rev_den_plain(q, k, v, gnum, gden),
                 lambda q, v: _bwd_bound(q, v, True), "rev_variant", ("dk", "dv")),
            ]
        for name, source, replaces, label, kernel, plain, bound, key, outs in specs:
            args = inputs[label]
            variant = name.rsplit("_", 1)[1]
            if next(r[key] for r in readings if r["case"] == label) != variant:
                raise AssertionError(f"{name} at {label} took the other variant")
            ms = cuda_ms(lambda: kernel(*args), 20)
            plain_ms = cuda_ms(lambda: plain(*args), 3)
            moved, flops, (bound_ms, bound_by) = bound(args[0], args[2])
            log(f"{name} timing {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, {flops / 1e9:.2f} "
                "GFLOP); library_ms: none (no single PyTorch call computes this function)")
            lines.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                # the largest error of this kernel over the cases it ran
                "max_abs_err": max(r[n]["max_abs"] for r in readings for n in outs
                                   if r[key] == variant),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "shape": label,
            })
    lines[0]["generate_shape"] = norm["generate_shape"]
    return lines[:1] + [norm["simt"]] + lines[1:]


# ---------------------------------------------------------------------------
# The public op causal_dot_product: rows 2, 5
# ---------------------------------------------------------------------------

# (label, B, H, T, Dk, Dv, dtype, initial state S0, cotangent dSf of the
# final state): lm_1b3's per-layer shape [B*H, T, D] = [128, 1024, 128] and
# the edges of the kernels' loops. Row 2 takes its wgmma kernel for bf16 at
# Dk 128 with Dv a multiple of 64, its simt kernel for the rest: at Dk 128,
# Dv 64 the forward takes wgmma and the dq pass, on (g, v, k), simt. Row 5
# takes its wgmma kernel for bf16 at Dk = Dv = 128 (the first four cases),
# its simt kernel for the rest
RAW_CASES = [
    ("B8 H16 T1024 D128 bf16", 8, 16, 1024, 128, 128, torch.bfloat16, False, False),
    ("B8 H16 T1024 D128 bf16 S0 dSf", 8, 16, 1024, 128, 128, torch.bfloat16, True, True),
    ("B8 H16 T1000 D128 bf16 S0 (ragged)", 8, 16, 1000, 128, 128, torch.bfloat16, True, False),
    ("B8 H16 T1 D128 bf16 dSf", 8, 16, 1, 128, 128, torch.bfloat16, False, True),
    ("B8 H16 T1024 Dk128 Dv64 bf16 S0 dSf", 8, 16, 1024, 128, 64, torch.bfloat16, True, True),
    ("B2 H4 T200 D32 fp32 S0 dSf", 2, 4, 200, 32, 32, torch.float32, True, True),
    ("B2 H4 T70 D32 fp32", 2, 4, 70, 32, 32, torch.float32, False, False),
]


def _raw_inputs(g, dev, b, h, t, dk, dv, dtype, with_s0, with_gsf):
    """q, k phi-mapped [BH, T, Dk], v [BH, T, Dv], the output's cotangent;
    S0 [BH, Dk, Dv] the state a 256-token prefix leaves; dSf at the scale of
    what the reverse walk itself sums (R grows as sqrt(T) per element)."""
    bh = b * h

    def phi(x):
        return torch.nn.functional.elu(x) + 1.0

    q = phi(torch.randn(bh, t, dk, device=dev, generator=g)).to(dtype)
    k = phi(torch.randn(bh, t, dk, device=dev, generator=g)).to(dtype)
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = gsf = None
    if with_s0:
        kp = phi(torch.randn(bh, 256, dk, device=dev, generator=g)).to(dtype).float()
        vp = torch.randn(bh, 256, dv, device=dev, generator=g).to(dtype).float()
        s0 = kp.transpose(1, 2) @ vp
    if with_gsf:
        gsf = 8.0 * torch.randn(bh, dk, dv, device=dev, generator=g)
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
    with S0^T carried in and no final state asked for, as the op's backward
    runs it) and the reverse pass (dk, dv, dS0, seeded by dSf^T or zeros).
    Returns one reading per case (with the variants the forward, the dq pass
    and the reverse pass took) and every case's inputs by label."""
    g = torch.Generator(device=dev).manual_seed(21)
    readings, inputs = [], {}
    for label, b, h, t, dk, dv, dtype, with_s0, with_gsf in RAW_CASES:
        q, k, v, gout, s0, gsf = _raw_inputs(g, dev, b, h, t, dk, dv, dtype, with_s0, with_gsf)
        bh, f32 = b * h, torch.float32
        s0t = s0.transpose(1, 2).contiguous() if s0 is not None else None
        _nan_junk(dev, ((bh, t, dv), dtype), ((bh, dk, dv), f32))
        out, sf = cd.causal_dot_cuda(q, k, v, s0)
        _nan_junk(dev, ((bh, t, dk), dtype))
        dq, _ = cd.causal_dot_cuda(gout, v, k, s0t, with_state=False)
        _nan_junk(dev, ((bh, t, dk), f32), ((bh, t, dv), f32), ((bh, dk, dv), f32))
        dk_, dv_, ds0 = cd.causal_dot_rev_cuda(q, k, v, gout, gsf)
        torch.cuda.synchronize()
        r_out, r_sf = cd.causal_dot_plain(q, k, v, s0)
        r_dq, _ = cd.causal_dot_plain(gout, v, k, s0t)
        r_dk, r_dv, r_ds0 = cd.causal_dot_rev_plain(q, k, v, gout, gsf)
        rt = RAW_RTOL[dtype]
        readings.append({
            "case": label,
            "variants": {"out": cd.causal_dot_raw_variant(q, k, v),
                         "dq": cd.causal_dot_raw_variant(gout, v, k),
                         "rev": cd.causal_dot_rev_variant(q, k, v, gout)},
            "out": _grad_reading(out, r_out, rt, RAW_ATOL_OF_MAX),
            "dq": _grad_reading(dq, r_dq, rt, RAW_ATOL_OF_MAX),
            "dk": _grad_reading(dk_, r_dk, RAW_RTOL[f32], RAW_ATOL_OF_MAX),
            "dv": _grad_reading(dv_, r_dv, RAW_RTOL[f32], RAW_ATOL_OF_MAX),
            "s_rel": _rel(sf, r_sf), "ds0_rel": _rel(ds0, r_ds0),
            "states_finite": bool(torch.isfinite(sf).all() and torch.isfinite(ds0).all()),
        })
        inputs[label] = (q, k, v, gout)
    return readings, inputs


def agrees_raw(r):
    return (r["states_finite"] and max(r["s_rel"], r["ds0_rel"]) <= STATE_RTOL
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0
                    for n in ("out", "dq", "dk", "dv")))


def _raw_bound(q, k, v, with_state):
    """Row 2's bound on q, k [BH, T, Dk] and v [BH, T, Dv]: q, k, v read, out
    written (and the fp32 S with ``with_state``); one chunk walk's products
    (the full 64 x 64 score block a chunk)."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    moved = (q.numel() + k.numel() + 2 * v.numel()) * q.element_size()
    moved += bh * dk * dv * 4 if with_state else 0
    ops = 2 * bh * t * (64 * dk + 64 * dv + 2 * dk * dv)
    return moved, ops


def _raw_rev_bound(q, v):
    """Row 5's bound on q, k [BH, T, Dk] and v, g [BH, T, Dv]: q, k, v, g and
    dSf read, fp32 dk, dv and dS0 written; two chunk walks' products (the dk
    and the dv role, each with the full 64 x 64 score block a chunk)."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    moved = 2 * (q.numel() + v.numel()) * q.element_size() + 2 * bh * dk * dv * 4
    moved += bh * t * (dk + dv) * 4
    return moved, 2 * 2 * bh * t * (64 * dk + 64 * dv + 2 * dk * dv)


def check_raw(cd, dev):
    """Rows 2 and 5 against their plain versions, each case logging the
    variants they took (row 2 wgmma wherever ``causal_dot_raw_variant``
    names it: every bf16 case at Dk 128 but the Dv-64 case's dq pass; row 5
    wherever ``causal_dot_rev_variant`` does: bf16 at Dk = Dv = 128); then
    each timed where the public op's main path runs it: row 2's wgmma kernel
    as the op's forward at [128, 1024, 128] bf16 (no initial state), its
    simt kernel as the dq pass of the op at Dk 128, Dv 64 (g, v [128, 1024,
    64], k [128, 1024, 128]), row 5's wgmma kernel seeded by dSf at [128,
    1024, 128], its simt kernel seeded by dSf at the op's Dk 128, Dv 64 (its
    dk role contracts over Dv 64). Returns their ``kernels`` lines."""
    readings, inputs = compare_raw(cd, dev)
    for r in readings:
        log(f"causal_dot / causal_dot_rev {r['case']} (forward {r['variants']['out']}, dq pass "
            f"{r['variants']['dq']}, reverse pass {r['variants']['rev']}): "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("out", "dq", "dk", "dv"))
            + f"; rel: S {r['s_rel']:.2e} dS0 {r['ds0_rel']:.2e} (limit {STATE_RTOL:g})")
        if not agrees_raw(r):
            raise AssertionError(f"a raw causal_dot kernel disagrees with its plain version: {r}")
    errs = {v: max([r[n]["max_abs"] for r in readings for n in ("out", "dq")
                    if r["variants"][n] == v], default=0.0) for v in ("wgmma", "simt")}
    rev_errs = {v: max([r[n]["max_abs"] for r in readings for n in ("dk", "dv")
                        if r["variants"]["rev"] == v], default=0.0) for v in ("wgmma", "simt")}
    ran = {v: sum(r["variants"][n] == v for r in readings for n in ("out", "dq"))
           for v in ("wgmma", "simt")}
    rev_ran = {v: sum(r["variants"]["rev"] == v for r in readings) for v in ("wgmma", "simt")}
    log(f"causal_dot variants run over the {len(readings)} cases (forward, dq pass each): {ran}; "
        f"causal_dot_rev variants (reverse pass): {rev_ran}")
    if not all(ran.values()) or not all(rev_ran.values()):
        raise AssertionError(f"a causal_dot or causal_dot_rev variant ran on no case: {ran}, "
                             f"{rev_ran}")
    q, k, v, gout = inputs["B8 H16 T1024 D128 bf16"]
    q128, k128, v64, g64 = inputs["B8 H16 T1024 Dk128 Dv64 bf16 S0 dSf"]
    if (cd.causal_dot_raw_variant(q, k, v), cd.causal_dot_raw_variant(g64, v64, k128),
            cd.causal_dot_rev_variant(q, k, v, gout),
            cd.causal_dot_rev_variant(q128, k128, v64, g64)) != ("wgmma", "simt") * 2:
        raise AssertionError("the timed causal_dot calls take the wrong variants")
    gsf = 8.0 * torch.randn(q.shape[0], q.shape[-1], v.shape[-1], device=dev)
    gsf64 = 8.0 * torch.randn(q128.shape[0], q128.shape[-1], v64.shape[-1], device=dev)
    specs = [
        ("causal_dot_wgmma", "orion_tpu_torch/csrc/causal_dot_norm.cu",
         "the op's forward, B8 H16 T1024 D128 bf16",
         lambda: cd.causal_dot_cuda(q, k, v), lambda: cd.causal_dot_plain(q, k, v),
         *_raw_bound(q, k, v, True), errs["wgmma"]),
        ("causal_dot_simt", "orion_tpu_torch/csrc/causal_dot_norm.cu",
         "the dq pass of the op at Dk 128, Dv 64: g, v [128, 1024, 64], k [128, 1024, 128] bf16",
         lambda: cd.causal_dot_cuda(g64, v64, k128, with_state=False),
         lambda: cd.causal_dot_plain(g64, v64, k128)[0],
         *_raw_bound(g64, v64, k128, False), errs["simt"]),
        ("causal_dot_rev_wgmma", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
         "B8 H16 T1024 D128 bf16, seeded by dSf",
         lambda: cd.causal_dot_rev_cuda(q, k, v, gout, gsf),
         lambda: cd.causal_dot_rev_plain(q, k, v, gout, gsf),
         *_raw_rev_bound(q, v), rev_errs["wgmma"]),
        ("causal_dot_rev_simt", "orion_tpu_torch/csrc/causal_dot_bwd.cu",
         "the op's reverse pass at Dk 128, Dv 64: q, k [128, 1024, 128], v, g [128, 1024, 64] "
         "bf16, seeded by dSf",
         lambda: cd.causal_dot_rev_cuda(q128, k128, v64, g64, gsf64),
         lambda: cd.causal_dot_rev_plain(q128, k128, v64, g64, gsf64),
         *_raw_rev_bound(q128, v64), rev_errs["simt"]),
    ]
    lines = []
    for name, source, shape, kernel, plain, moved, flops, err in specs:
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = _bound(moved, flops)
        log(f"{name} timing, {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            "library_ms: none (no single PyTorch call computes this function)")
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": ("orion_tpu/ops/pallas/causal_dot.py:377"
                         if name.startswith("causal_dot_rev")
                         else "orion_tpu/ops/pallas/causal_dot.py:123"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape,
        })
    return lines


def op_phase(dev, mods):
    """The public op ``orion_tpu_torch.ops.causal_dot_product``, forward and
    backward, with an initial state and the returned state, at lm_1b3's
    per-layer shape [B 8, H 16, T 1024, D 128] bf16 and then at Dk 128, Dv
    64: exact launches, the counts set to 0 just before each (row 2 twice on
    its wgmma kernel and row 5 once on its wgmma kernel; at Dv 64 the
    forward on wgmma, the dq pass, whose contracted width is Dv, and the
    reverse pass on simt), then the same through the
    plain form differentiated by autograd (backend="torch"): out, S and
    every gradient within the kernels' limits; the D-128 op timed beside the
    plain form."""
    from orion_tpu_torch.ops import causal_dot_product

    g = torch.Generator(device=dev).manual_seed(22)
    b, h, t = 8, 16, 1024
    result = {}
    for label, dk, dv, moves in (("D128", 128, 128,
                                  {"causal_dot_wgmma": 2, "causal_dot_rev_wgmma": 1}),
                                 ("Dk128 Dv64", 128, 64,
                                  {"causal_dot_wgmma": 1, "causal_dot_simt": 1,
                                   "causal_dot_rev_simt": 1})):
        q0, k0, v0, gout, s00, gsf = (
            x.reshape(b, h, *x.shape[1:])
            for x in _raw_inputs(g, dev, b, h, t, dk, dv, torch.bfloat16, True, True))

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
        want.update(moves)
        log(f"causal_dot_product forward + backward launches, {label}: {counts}")
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
        res = {"launches": counts, "errs": errs}
        if label == "D128":
            res["ms"] = cuda_ms(lambda: run("cuda"), 5)
            res["plain_ms"] = cuda_ms(lambda: run("torch"), 3)
        log(f"causal_dot_product fwd + bwd through the kernels vs backend='torch' (autograd of "
            f"the plain form), {label}: " + "; ".join(
                f"{n} max abs {e['max_abs']:.3e} ("
                + (f"{e['over_limit']:.3f} of its limit" if "over_limit" in e
                   else f"rel {e['rel']:.2e}, limit {STATE_RTOL:g}") + ")"
                for n, e in errs.items())
            + (f"; {res['ms']:.3f} ms against the plain form's {res['plain_ms']:.3f} ms (fwd + "
               "bwd, B8 H16 T1024 D128 bf16)" if "ms" in res else ""))
        if not all(e["well_formed"] and e.get("over_limit", 0.0) <= 1.0
                   and e.get("rel", 0.0) <= STATE_RTOL for e in errs.values()):
            raise AssertionError(f"the public op disagrees with backend='torch': {errs}")
        result[label] = res
    return {"launches": result["D128"]["launches"], "errs": result["D128"]["errs"],
            "ms": result["D128"]["ms"], "plain_ms": result["D128"]["plain_ms"],
            "launches_dv64": result["Dk128 Dv64"]["launches"],
            "errs_dv64": result["Dk128 Dv64"]["errs"]}


# ---------------------------------------------------------------------------
# Flash attention: rows 6, 7, 8
# ---------------------------------------------------------------------------

# (label, B, H, T, D, dtype, causal, window): hybrid_1b3's shapes and the
# edges of the kernels' loops; T an int, or (Tq, Tk). Every pass takes its
# wgmma kernel for bf16 at D 128, its simt kernel for the rest (the last two)
FLASH_CASES = [
    ("generate", 4, 16, 1536, 128, torch.bfloat16, True, 1024),
    ("training", 8, 16, 2048, 128, torch.bfloat16, True, 1024),
    ("ragged", 2, 16, 2000, 128, torch.bfloat16, True, 1024),
    ("T1", 8, 16, 1, 128, torch.bfloat16, True, 1024),
    ("below the window", 8, 16, 512, 128, torch.bfloat16, True, 1024),
    ("causal, no window", 4, 16, 2048, 128, torch.bfloat16, True, None),
    ("bidirectional", 4, 16, 1024, 128, torch.bfloat16, False, None),
    ("more keys than queries", 2, 16, (1000, 1500), 128, torch.bfloat16, True, 512),
    ("D 64", 2, 8, 1000, 64, torch.bfloat16, True, 256),
    ("tiny widths", 2, 4, 300, 32, torch.float32, True, 16),
]


def _flash_inputs(g, dev, b, h, t, d, dtype):
    """q, k, v at unit scale and the output's cotangent, [B*H, T, D]; ``t``
    an int, or (Tq, Tk)."""
    t_q, t_k = t if isinstance(t, tuple) else (t, t)
    return [torch.randn(b * h, n, d, device=dev, generator=g).to(dtype)
            for n in (t_q, t_k, t_k, t_q)]


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
    (with the variants the forward and the backward took) and the inputs of
    each case by label."""
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
            "fwd_variant": fa.flash_fwd_variant(q, k, v),
            "variant": fa.flash_bwd_variant(q, k, v, gout),
            "out": _grad_reading(out, r_out, rtol, FLASH_ATOL_OF_MAX),
            "dq": _grad_reading(dq, r_dq, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dk": _grad_reading(dk, r_dk, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dv": _grad_reading(dv, r_dv, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "lse_max_abs": float(lse_diff.max()),
            "lse_over_limit": float((lse_diff / (LSE_RTOL * r_lse.abs().clamp_min(1.0))).max()),
            "lse_well_formed": lse.shape == (q.shape[0], q.shape[1], 1)
            and lse.dtype == torch.float32 and bool(torch.isfinite(lse).all()),
        })
        inputs[label] = (b, h, q, k, v, gout, r_lse, delta, opts)
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
    """Rows 6-8: agreement on every case, each case's variants logged, then
    timings where each variant's path takes it: the wgmma kernels at
    hybrid_1b3's training shape (row 6 also at its generate shape and
    causal without a window), the simt kernels at the tiny fp32 widths. Each
    beside its bound (at the bf16 or the fp32 peak), its plain version and
    scaled_dot_product_attention under the same mask (the backward timed as
    one call, for rows 7 and 8 together). The kernels line has one entry
    for each variant of rows 6, 7 and 8."""
    readings, inputs = compare_flash(fa, dev)
    for r in readings:
        log(f"flash {r['case']} (forward {r['fwd_variant']}, backward {r['variant']}): "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit, needs atol {r[n]['atol_needed']:.2e} max|ref|)"
                        for n in ("out", "dq", "dk", "dv"))
            + f"; lse max abs {r['lse_max_abs']:.3e} ({r['lse_over_limit']:.3f} of its limit)")
    bad = [r for r in readings if not agrees_flash(r)]
    if bad:
        raise AssertionError(f"a flash kernel disagrees with its plain version: {bad}")
    ran = {v: sum(r["variant"] == v for r in readings) for v in ("wgmma", "simt")}
    log(f"flash variants over the {len(readings)} cases: {ran}")
    if not all(ran.values()) or any(r["fwd_variant"] != r["variant"] for r in readings):
        raise AssertionError(f"a flash variant ran on no case, or the forward and the backward "
                             f"took different ones: {ran}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    with torch.no_grad():
        for label in ("generate", "training", "causal, no window", "tiny widths"):
            b, h, q, k, v, gout, lse, delta, opts = inputs[label]
            bh, t, d = q.shape
            peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
            q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
            mask = _sdpa_mask(t, opts["causal"], opts["window"], dev)
            lib = (lambda: sdpa(q4, k4, v4, attn_mask=mask)) if mask is not None else (
                lambda: sdpa(q4, k4, v4, is_causal=True))
            act = q.numel() * q.element_size()
            pairs = bh * _pairs(t, opts["causal"], opts["window"])
            row = {}
            variant = fa.flash_fwd_variant(q, k, v)
            if variant != ("simt" if label == "tiny widths" else "wgmma"):
                raise AssertionError(f"flash forward at {label} took {variant}")
            row["fwd"] = dict(
                ms=cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, **opts), 10),
                plain_ms=cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **opts), 2),
                library_ms=cuda_ms(lib, 10),
                # q, k, v read; out, lse written
                moved=4 * act + bh * t * 4, flops=4 * d * pairs, variant=variant)
            if label in ("training", "tiny widths"):
                variant = fa.flash_bwd_variant(q, k, v, gout)
                if variant != ("simt" if label == "tiny widths" else "wgmma"):
                    raise AssertionError(f"flash backward at {label} took {variant}")
                row["dq"] = dict(
                    ms=cuda_ms(lambda: fa.flash_dq_cuda(q, k, v, gout, lse, delta, **opts), 10),
                    plain_ms=cuda_ms(lambda: fa.flash_dq_plain(q, k, v, gout, lse, delta, **opts), 2),
                    # q, k, v, g, lse, delta read; dq written
                    moved=5 * act + 2 * bh * t * 4, flops=6 * d * pairs)
                row["dkv"] = dict(
                    ms=cuda_ms(lambda: fa.flash_dkv_cuda(q, k, v, gout, lse, delta, **opts), 10),
                    plain_ms=cuda_ms(lambda: fa.flash_dkv_plain(q, k, v, gout, lse, delta, **opts), 2),
                    # q, k, v, g, lse, delta read; dk, dv written
                    moved=6 * act + 2 * bh * t * 4, flops=8 * d * pairs)
                with torch.enable_grad():
                    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
                    o = sdpa(qg, kg, vg, attn_mask=mask)
                    g4 = gout.view_as(o)
                    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                        o, (qg, kg, vg), g4, retain_graph=True), 10)
                for part in ("dq", "dkv"):
                    row[part].update(library_ms=bwd_ms, variant=variant)
            for part, x in row.items():
                x["bound_ms"], x["bound_by"] = _bound(x["moved"], x["flops"], peak)
                x["shape"] = (f"B{b} H{h} T{t} D{d} {str(q.dtype)[6:]} causal={opts['causal']} "
                              f"window={opts['window']}")
                log(f"flash {part}{' ' + x['variant'] if 'variant' in x else ''} timing {label} "
                    f"{x['shape']}: kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, "
                    f"bound {x['bound_ms']:.4f} ms by {x['bound_by']} ({x['moved'] / 1e6:.1f} MB, "
                    f"{x['flops'] / 1e9:.2f} GFLOP, {pairs / 1e6:.1f} M pairs); "
                    f"scaled_dot_product_attention {x['library_ms']:.4f} ms"
                    + (" (its backward: dq, dk and dv in one call; kernels dq + dk/dv "
                       f"{row['dq']['ms'] + row['dkv']['ms']:.4f} ms)" if part != "fwd" else ""))
            timings[label] = row
    del inputs
    torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    tr = timings["training"]
    lines = []
    for v, row in (("wgmma", tr), ("simt", timings["tiny widths"])):
        lines.append({
            "name": f"flash_fwd_{v}", "route": "cuda",
            "source": "orion_tpu_torch/csrc/flash_attention.cu",
            "replaces": "orion_tpu/ops/pallas/flash_attention.py:211",
            "max_abs_err": max(r["out"]["max_abs"] for r in readings if r["fwd_variant"] == v),
            "over_limit": max(r["out"]["over_limit"] for r in readings if r["fwd_variant"] == v),
            **{key: row["fwd"][key] for key in keys}})
    lines[0]["generate_shape"] = {key: timings["generate"]["fwd"][key] for key in keys}
    lines[0]["causal_no_window"] = {key: timings["causal, no window"]["fwd"][key] for key in keys}
    for v, row in (("wgmma", tr), ("simt", timings["tiny widths"])):
        for part, replaces, names in (("dq", ":384", ("dq",)), ("dkv", ":418", ("dk", "dv"))):
            lines.append({
                "name": f"flash_{part}_{v}", "route": "cuda",
                "source": "orion_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": "orion_tpu/ops/pallas/flash_attention.py" + replaces,
                # the largest error of this kernel over the cases it ran
                "max_abs_err": max(r[n]["max_abs"] for r in readings if r["variant"] == v
                                   for n in names),
                "over_limit": max(r[n]["over_limit"] for r in readings if r["variant"] == v
                                  for n in names),
                **{key: row[part][key] for key in keys}})
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
    # the wgmma route's tails: K and N multiples of 8 but not of its 64 / 256
    # tiles (TMA's zero fill inside an expert), an expert without rows
    ("wgmma tails", (130, 0, 77, 300), 200, 328, torch.bfloat16),
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
    [E, h, d]), its dx and dw. Returns one reading per case and product (with
    the variant each of y, dx and dw took), and the inputs of the training
    and the tiny-widths cases by (label, product)."""
    g = torch.Generator(device=dev).manual_seed(9)
    readings, inputs = [], {}
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
                "variants": {"y": gm.gmm_variant(a, w), "dx": gm.gmm_variant(gy, w, True),
                             "dw": gm.gmm_dw_variant(a, gy)},
                "y": _grad_reading(y, gm.gmm_torch(a, w, te), rtol, GMM_ATOL_OF_MAX),
                "dx": _grad_reading(dx, gm.gmm_torch(gy, w, te, transpose_w=True), rtol,
                                    GMM_ATOL_OF_MAX),
                "dw": _dw_reading(dw, gm.gmm_dw_torch(a, gy, te, e), te),
            })
            if label in ("training", "tiny widths"):
                inputs[(label, kind)] = (a, w, gy, te, seg, sum(counts))
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


def host_us(fn, iters=20):
    """Host time of one call of ``fn`` (its enqueue; the card works behind),
    mean over ``iters`` calls after a warm-up, in microseconds."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _gmm_times(gm, inputs):
    """One product's timings: y, dx and dw ms of the kernels the wrappers
    choose for these inputs (and which they are), the forward wrapper's host
    microseconds, the plain versions, ``torch._grouped_mm`` (dw with an fp32
    output where the card's torch takes one, else bf16; none for fp32
    operands, which it refuses) and the bounds."""
    x, w, gy, te, seg, m = inputs
    e, k, n = w.shape
    offs = torch.cumsum(seg, 0).int()  # each segment's end, tile-aligned
    t = {"shape": f"x [{x.shape[0]}, {k}] ({m} routed rows) @ w [{e}, {k}, {n}] "
                  f"{str(x.dtype)[6:]}",
         "variants": {"y": gm.gmm_variant(x, w), "dx": gm.gmm_variant(gy, w, True),
                      "dw": gm.gmm_dw_variant(x, gy)}}
    with torch.no_grad():
        t["y_ms"] = cuda_ms(lambda: gm.gmm_cuda(x, w, te), 10)
        t["dx_ms"] = cuda_ms(lambda: gm.gmm_cuda(gy, w, te, transpose_w=True), 10)
        t["dw_ms"] = cuda_ms(lambda: gm.gmm_dw_cuda(x, gy, te, e), 10)
        t["host_us"] = host_us(lambda: gm.gmm_cuda(x, w, te))
        t["plain_y_ms"] = cuda_ms(lambda: gm.gmm_torch(x, w, te), 2)
        t["plain_dw_ms"] = cuda_ms(lambda: gm.gmm_dw_torch(x, gy, te, e), 2)
        t["library_y_ms"], t["library_y"] = _library_ms([
            ("torch._grouped_mm", lambda: torch._grouped_mm(x, w, offs=offs))])
        xt = x.t()
        t["library_dw_ms"], t["library_dw"] = _library_ms([
            ("torch._grouped_mm (fp32 out)",
             lambda: torch._grouped_mm(xt, gy, offs=offs, out_dtype=torch.float32)),
            ("torch._grouped_mm (bf16 out)", lambda: torch._grouped_mm(xt, gy, offs=offs))])
    # y: x's real rows and w read, y's real rows written; dw: x's and g's real
    # rows read, dw [E, k, n] fp32 written; each 2 m k n operations, on the
    # tensor cores in bf16, on the CUDA cores in fp32
    es, flops = x.element_size(), 2 * m * k * n
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else FP32_FLOPS
    t["bound_y_ms"], t["bound_y_by"] = _bound((m * k + e * k * n + m * n) * es, flops, peak)
    t["bound_dw_ms"], t["bound_dw_by"] = _bound((m * k + m * n) * es + e * k * n * 4, flops,
                                                peak)
    return t


def check_gmm(gm, dev):
    """Rows 9, 10: agreement on every case, each case's variants logged (the
    wgmma kernels where ``gmm_variant`` / ``gmm_dw_variant`` choose them, the
    simt kernels elsewhere), then ``_gmm_times`` where each variant's path
    takes it: the wgmma kernels at the training shape, the gate/up product
    (x [8704, 2048] @ w [4, 2048, 5504], its dx against w^T, its dw) with the
    down product beside it; the simt kernels at the tiny MoE's fp32 widths.
    The kernels line has one entry for each of the four kernels."""
    readings, inputs = compare_gmm(gm, dev)
    for r in readings:
        log(f"gmm {r['case']}: "
            + "; ".join(f"{n} ({r['variants'][n]}) max abs {r[n]['max_abs']:.3e} "
                        f"({r[n]['over_limit']:.3f} of its limit)" for n in ("y", "dx", "dw"))
            + f"; absent expert's dw exactly 0: {r['dw']['absent_zero']}")
    bad = [r for r in readings if not agrees_gmm(r)]
    if bad:
        raise AssertionError(f"a gmm kernel disagrees with its plain version: {bad}")
    # the largest error of each kernel over the cases it ran
    errs = {(v, part): 0.0 for v in ("wgmma", "simt") for part in ("fwd", "dw")}
    for r in readings:
        for n, part in (("y", "fwd"), ("dx", "fwd"), ("dw", "dw")):
            key = (r["variants"][n], part)
            errs[key] = max(errs[key], r[n]["max_abs"])
    ran = {v: sum(r["variants"][n] == v for r in readings for n in ("y", "dx", "dw"))
           for v in ("wgmma", "simt")}
    log(f"gmm variants run over the {len(readings)} cases (y, dx, dw each): {ran}")
    if not all(ran.values()):
        raise AssertionError(f"a gmm variant ran on no case: {ran}")
    times = {key: _gmm_times(gm, inputs[key]) for key in (
        ("training", "gate/up"), ("training", "down"), ("tiny widths", "gate/up"))}
    for (label, kind), t in times.items():
        want = "simt" if label == "tiny widths" else "wgmma"
        if set(t["variants"].values()) != {want}:
            raise AssertionError(f"gmm {label} {kind} took {t['variants']}, want {want}")
        lib = {p: (f"{t['library_' + p]} {t['library_' + p + '_ms']:.4f} ms"
                   if t["library_" + p + "_ms"] is not None else f"none ({t['library_' + p]})")
               for p in ("y", "dw")}
        log(f"gmm {label} {kind} timing, {t['shape']}, {want}: y {t['y_ms']:.4f} ms, dx against "
            f"w^T {t['dx_ms']:.4f} ms, dw {t['dw_ms']:.4f} ms; bound {t['bound_y_ms']:.4f} (y, "
            f"by {t['bound_y_by']}) / {t['bound_dw_ms']:.4f} ms (dw, by {t['bound_dw_by']}); "
            f"plain y {t['plain_y_ms']:.4f}, dw {t['plain_dw_ms']:.4f} ms; library y "
            f"{lib['y']}, dw {lib['dw']}; host {t['host_us']:.1f} us a forward call")
    lines = []
    for v, main, beside in (("wgmma", times[("training", "gate/up")], times[("training", "down")]),
                            ("simt", times[("tiny widths", "gate/up")], None)):
        for part, replaces in (("fwd", "orion_tpu/ops/pallas/gmm.py:104"),
                               ("dw", "orion_tpu/ops/pallas/gmm.py:157")):
            p = "y" if part == "fwd" else "dw"
            line = {"name": f"gmm_{part}_{v}", "route": "cuda",
                    "source": "orion_tpu_torch/csrc/gmm.cu", "replaces": replaces,
                    "max_abs_err": errs[(v, part)], "ms": main[p + "_ms"],
                    "plain_ms": main[f"plain_{p}_ms"], "bound_ms": main[f"bound_{p}_ms"],
                    "bound_by": main[f"bound_{p}_by"], "library_ms": main[f"library_{p}_ms"],
                    "library": main[f"library_{p}"], "shape": main["shape"]}
            if part == "fwd":
                line.update(dx_ms=main["dx_ms"], host_us=main["host_us"])
            if beside is not None:
                line["down"] = {key: beside[key] for key in (
                    f"{p}_ms", f"plain_{p}_ms", f"bound_{p}_ms", f"library_{p}_ms", "shape")}
                if part == "fwd":
                    line["down"].update(dx_ms=beside["dx_ms"], host_us=beside["host_us"])
            lines.append(line)
    return lines


# ---------------------------------------------------------------------------
# The int4 dequant-matmul: row 14
# ---------------------------------------------------------------------------

# (label, rows, d, out, dtype): lm_1b3's decode shapes (a decode step's rows
# padded to DECODE_ROWS, 64) and the edges of the kernels' loops. Row 14
# takes its mma kernel for bf16 x with d % 8 == 0 and out % 16 == 0
# (16-byte-aligned bases), its simt kernel for the rest
Q4_CASES = [
    ("wq..wo", 64, 2048, 2048, torch.bfloat16),
    ("gate/up", 64, 2048, 5504, torch.bfloat16),
    ("down", 64, 5504, 2048, torch.bfloat16),  # x staged a box at a time
    ("B 1", 1, 2048, 2048, torch.bfloat16),
    ("B 4", 4, 2048, 5504, torch.bfloat16),
    ("B 4 down", 4, 5504, 2048, torch.bfloat16),
    ("1000 packed rows (a last box of 40)", 4, 2000, 2048, torch.bfloat16),
    ("out 336 (a last strip of 16 channels)", 4, 2048, 336, torch.bfloat16),
    ("out 200 (no whole strip)", 4, 2048, 200, torch.bfloat16),
    ("ragged d 100", 4, 100, 384, torch.bfloat16),
    ("d 2004 (d % 8 != 0)", 4, 2004, 2048, torch.bfloat16),
    ("fp32 (tiny's widths)", 2, 128, 384, torch.float32),
    ("fp32, out % 4 != 0", 3, 64, 33, torch.float32),
    ("fp32 down (a K tail past 512 packed rows)", 4, 5504, 2048, torch.float32),
]
Q4_PER_STEP = {"wq..wo": 4 * 24, "gate/up": 2 * 24, "down": 24}  # lm_1b3's calls a decode step


def compare_q4(q4, dev):
    """Row 14 against its plain version on the card, on every case of
    Q4_CASES: random packed bytes (every nibble -8..7 at both positions) and
    per-channel scales of a quantized weight's size, called twice: once on a
    new weight (checked, launched after the kernel before has ended), once
    more on x as the kernel just before writes it (a kept weight: the mma
    launch starts early and must wait for that kernel before reading x).
    Returns one reading per case over both results (with the variant it
    took) and the inputs by label."""
    g = torch.Generator(device=dev).manual_seed(14)
    readings, inputs = [], {}
    for label, b, d, out, dtype in Q4_CASES:
        x = torch.randn(b, d, device=dev, generator=g).to(dtype)
        p = torch.randint(-128, 128, (d // 2, out), device=dev, generator=g).to(torch.int8)
        s = (torch.rand(out, device=dev, generator=g) + 0.5) * 0.01
        junk = torch.full((b, out), float("nan"), device=dev, dtype=dtype)
        del junk  # the allocator hands this block to y: an unwritten element shows
        y = q4.q4_matmul_cuda(x, p, s)
        junk = torch.full((b, d), float("nan"), device=dev, dtype=dtype)
        del junk  # x's copy below gets this block: x read too early shows
        y_early = q4.q4_matmul_cuda(x.mul(1.0), p, s)
        torch.cuda.synchronize()
        ref = q4.q4_matmul_torch(x, p, s)
        readings.append({"case": f"{label}: x [{b}, {d}] {str(dtype)[6:]}, p [{d // 2}, {out}]",
                         "variant": q4.q4_matmul_variant(x, p, s),
                         "y": _grad_reading(torch.cat([y, y_early]), torch.cat([ref, ref]),
                                            Q4_RTOL[dtype], Q4_ATOL_OF_MAX)})
        inputs[label] = (x, p, s)
    return readings, inputs


def agrees_q4(r):
    return r["y"]["well_formed"] and r["y"]["over_limit"] <= 1.0


def _q4_times(q4, dev, x, p, s):
    """One shape's timings: ``ms`` and ``plain_ms`` by ``cuda_ms`` (calls back
    to back, the wrapper's host time included, as each decode step's calls
    pay it), ``graph_ms`` the kernel's device time alone over cold weights,
    the bf16 dense product of the same shape as a yardstick (not the same
    function), the wrapper's host microseconds a call, and the bound by
    bytes (x, p, s read, y written) against 2 b d out operations. Each cold
    copy is called once first, as every weight of a decode step has been by
    the step before: the wrapper keeps its checks, and its mma launches may
    start while the launch before ends (a weight's first call waits)."""
    (b, d), out = x.shape, p.shape[1]
    ps = cold_copies(p)
    for pc in ps:
        q4.q4_matmul_cuda(x, pc, s)
    ws = cold_copies(torch.randn(d, out, device=dev).to(x.dtype))
    es = x.element_size()
    t = dict(ms=cuda_ms(lambda: q4.q4_matmul_cuda(x, p, s), 200),
             plain_ms=cuda_ms(lambda: q4.q4_matmul_torch(x, p, s), 20),
             graph_ms=graph_ms(lambda i: q4.q4_matmul_cuda(x, ps[i % len(ps)], s), 200),
             dense_graph_ms=graph_ms(lambda i: x @ ws[i % len(ws)], 200),
             host_us=host_us(lambda: q4.q4_matmul_cuda(x, p, s), 200),
             moved=b * d * es + p.numel() + out * 4 + b * out * es, flops=2 * b * d * out)
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else FP32_FLOPS
    t["bound_ms"], t["bound_by"] = _bound(t["moved"], t["flops"], peak)
    return t


def check_q4(q4, dev):
    """Row 14: agreement on every case, each case's variant logged (mma at
    lm_1b3's decode shapes, simt for fp32 and the other widths); then the
    mma kernel timed at lm_1b3's three decode shapes and over one decode
    step's 168 calls, the simt kernel at the tiny models' fp32 widths (its
    place on the main path), each beside its bound, its plain version, the
    kernel's device time alone (``graph_ms``) and the bf16 dense product of
    the same shape (cuBLAS; a yardstick, not the same function: no PyTorch
    call takes this packed int4 layout)."""
    readings, inputs = compare_q4(q4, dev)
    for r in readings:
        log(f"q4_matmul {r['case']} ({r['variant']}): y max abs {r['y']['max_abs']:.3e} "
            f"({r['y']['over_limit']:.3f} of its limit, needs atol {r['y']['atol_needed']:.2e} "
            "max|ref|)")
    bad = [r for r in readings if not agrees_q4(r)]
    if bad:
        raise AssertionError(f"q4_matmul disagrees with its plain version: {bad}")
    ran = {v: sum(r["variant"] == v for r in readings) for v in ("mma", "simt")}
    log(f"q4_matmul variants run over the {len(readings)} cases: {ran}")
    if not all(ran.values()) or any(r["variant"] != "mma" for r in readings[:3]):
        raise AssertionError(f"q4_matmul took the wrong variants: {ran}")
    per_shape = {}
    fields = ("ms", "plain_ms", "graph_ms", "bound_ms", "dense_graph_ms", "host_us")
    with torch.no_grad():
        for label in Q4_PER_STEP:
            t = per_shape[label] = _q4_times(q4, dev, *inputs[label])
            x, p, _ = inputs[label]
            log(f"q4_matmul (mma) timing {label}: x [{x.shape[0]}, {x.shape[1]}] bf16 @ p "
                f"[{p.shape[0]}, {p.shape[1]}]: kernel {t['ms']:.4f} ms a call with the wrapper's "
                f"host time ({t['host_us']:.1f} us of host a call; {t['graph_ms']:.4f} ms device "
                f"time alone), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
                f"{t['bound_by']} ({t['moved'] / 1e6:.2f} MB); library_ms: none (no PyTorch call "
                "takes this packed int4 layout: torch._weight_int4pack_mm wants its own tiled "
                "packing and group-wise zero points); yardstick, not the same function: bf16 "
                f"dense x @ W, device time alone, {t['dense_graph_ms']:.4f} ms")
        simt = _q4_times(q4, dev, *inputs["fp32 (tiny's widths)"])
        log(f"q4_matmul (simt) timing at the tiny models' fp32 widths, x [2, 128] @ p [64, 384]: "
            f"kernel {simt['ms']:.4f} ms ({simt['graph_ms']:.4f} device time alone), plain "
            f"{simt['plain_ms']:.4f} ms, bound {simt['bound_ms']:.6f} ms by {simt['bound_by']}")
    step = {k: sum(per_shape[s][k] * n for s, n in Q4_PER_STEP.items()) for k in fields}
    log(f"q4_matmul (mma) over one lm_1b3 decode step's 168 calls (each shape's time x its "
        f"count): kernel {step['ms']:.3f} ms with the wrapper's host time ({step['graph_ms']:.3f} "
        f"device time alone), plain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.4f} ms, "
        f"bf16 dense device time {step['dense_graph_ms']:.3f} ms")
    main, errs = per_shape["gate/up"], {
        v: max(r["y"]["max_abs"] for r in readings if r["variant"] == v) for v in ("mma", "simt")}
    return [{"name": "q4_matmul_mma", "route": "cuda", "source": "orion_tpu_torch/csrc/q4_matmul.cu",
             "replaces": "orion_tpu/quant.py:183", "max_abs_err": errs["mma"],
             **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             "library_ms": None, "graph_ms": main["graph_ms"], "host_us": main["host_us"],
             "shape": "x [64, 2048] @ p [1024, 5504] (lm_1b3's gate / up at decode, its rows "
                      "padded to 64)",
             "per_shape": {k: {f: v[f] for f in fields} for k, v in per_shape.items()},
             "per_decode_step": step},
            {"name": "q4_matmul_simt", "route": "cuda",
             "source": "orion_tpu_torch/csrc/q4_matmul.cu", "replaces": "orion_tpu/quant.py:183",
             "max_abs_err": errs["simt"],
             **{k: simt[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "graph_ms")},
             "library_ms": None, "shape": "x [2, 128] fp32 @ p [64, 384] (the tiny models)"}]


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
    return {"causal_dot_norm_wgmma": cd.launches_wgmma, "causal_dot_norm_simt": cd.launches_simt,
            "causal_dot_wgmma": cd.launches_raw_wgmma, "causal_dot_simt": cd.launches_raw_simt,
            "causal_dot_dq_den_wgmma": cd.launches_dq_wgmma,
            "causal_dot_dq_den_simt": cd.launches_dq_simt,
            "causal_dot_rev_den_wgmma": cd.launches_rev_wgmma,
            "causal_dot_rev_den_simt": cd.launches_rev_simt,
            "causal_dot_rev_wgmma": cd.launches_raw_rev_wgmma,
            "causal_dot_rev_simt": cd.launches_raw_rev_simt, "flash_fwd_wgmma": fa.launches_fwd_wgmma,
            "flash_fwd_simt": fa.launches_fwd_simt,
            "flash_dq_wgmma": fa.launches_dq_wgmma, "flash_dkv_wgmma": fa.launches_dkv_wgmma,
            "flash_dq_simt": fa.launches_dq_simt, "flash_dkv_simt": fa.launches_dkv_simt,
            "gmm_fwd_wgmma": gm.launches_fwd_wgmma, "gmm_dw_wgmma": gm.launches_dw_wgmma,
            "gmm_fwd_simt": gm.launches_fwd_simt, "gmm_dw_simt": gm.launches_dw_simt,
            "q4_matmul_mma": q4.launches_mma, "q4_matmul_simt": q4.launches_simt,
            "adafactor_sums": af.launches_sums, "adafactor_rms": af.launches_rms,
            "adafactor_apply": af.launches_apply}


def _reset_counts(mods):
    cd, fa, gm, q4, af = mods
    cd.launches = cd.launches_dq = cd.launches_rev = cd.launches_raw = cd.launches_raw_rev = 0
    cd.launches_wgmma = cd.launches_simt = cd.launches_raw_wgmma = cd.launches_raw_simt = 0
    cd.launches_dq_wgmma = cd.launches_dq_simt = cd.launches_rev_wgmma = cd.launches_rev_simt = 0
    cd.launches_raw_rev_wgmma = cd.launches_raw_rev_simt = 0
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_wgmma = fa.launches_fwd_simt = 0
    fa.launches_dq_wgmma = fa.launches_dq_simt = fa.launches_dkv_wgmma = fa.launches_dkv_simt = 0
    gm.launches_fwd = gm.launches_dw = 0
    gm.launches_fwd_wgmma = gm.launches_fwd_simt = gm.launches_dw_wgmma = gm.launches_dw_simt = 0
    q4.launches = q4.launches_mma = q4.launches_simt = 0
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


def generate_phase(dev, mods, name, prompt_len, new_tokens, overrides=None, audit=False,
                   model_limits=True):
    """``generate`` on ``name`` (with ``overrides``) at full width: prefill
    and decode times, exact launch counts, the prefill's logits and states
    against backend="torch" on the same weights. ``audit``: every launch of
    rows 1, 3, 4 in that prefill also held against its plain version on the
    same inputs (``LaunchAudit``). ``model_limits=False``: the logits and
    states are read against ``LOGITS_ATOL`` / ``LAYER_*_RTOL`` and printed,
    but do not fail the phase (a model whose plain path misses them against
    itself: ``FAVOR_NOTE``); the audit is then the phase's check of the
    kernels."""
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
    gc.collect()  # no collection of earlier phases' objects inside the timed runs
    prefill_runs = [wall_ms(lambda: generate(model, prompts, 1, greedy))[0] for _ in range(3)]

    _reset_counts(mods)
    gen_ms, out = wall_ms(lambda: generate(model, prompts, new_tokens, greedy))
    counts = _counts(mods)
    lin, attn, _, _ = _layer_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    # decode's few rows take the dense per-expert form: gmm in the prefill only
    # bf16 at the model's widths: the wgmma forward kernels, none of the simt
    want.update(causal_dot_norm_wgmma=lin, flash_fwd_wgmma=attn,
                gmm_fwd_wgmma=_gmm_counts(cfg)[0])
    log(f"{name} generate launches: {counts}")
    if counts != want:
        raise AssertionError(f"{name} generate launched {counts}, want {want} (each layer's "
                             "forward kernels once, in the prefill)")
    if out.shape != (4, new_tokens) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} / out-of-vocab tokens")
    # decode is host-bound and the host is shared: the median of 3 generates
    gen_runs = [gen_ms] + [wall_ms(lambda: generate(model, prompts, new_tokens, greedy))[0]
                           for _ in range(2)]
    gen_ms = float(np.median(gen_runs))
    prefill_ms = float(np.median(prefill_runs))
    decode_ms = (gen_ms - prefill_ms) / (new_tokens - 1)
    log(f"{name} B4 T{prompt_len}: prefill (generate with 1 new token) {prefill_ms:.2f} ms "
        f"(runs {[round(x, 2) for x in prefill_runs]}); generate {new_tokens} tokens "
        f"{gen_ms:.2f} ms (runs {[round(x, 2) for x in gen_runs]}); decode {decode_ms:.3f} "
        "ms/token at batch 4")
    log(f"first tokens: {out[:, :8].tolist()}")

    # the kernel-backed prefill against the plain version, same weights and,
    # for a MoE model, the same expert choices (PinnedRouting)
    ref_model = TransformerLM(dataclasses.replace(cfg, backend="torch"), device=dev)
    ref_model = cast_params_for_inference(ref_model)
    ref_model.load_state_dict(model.state_dict())
    launch_audit = LaunchAudit(mods[0]) if audit else contextlib.nullcontext()
    with torch.inference_mode(), PinnedRouting() as pin:
        with launch_audit:
            logits, states = pin.attach(model).prefill_last(prompts)
        ref_logits, ref_states = pin.attach(ref_model).prefill_last(prompts)
    audited = launch_audit.check(f"{name} {overrides or {}} prefill") if audit else None
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
    missed = err > LOGITS_ATOL or (s_err or 0.0) > LAYER_S_RTOL or (kv_err or 0.0) > LAYER_KV_RTOL
    if missed and model_limits:
        raise AssertionError(f"{name}: kernel-backed prefill disagrees with the plain version")
    if missed:
        log(f"{name} {overrides}: the prefill's logits / states miss the model-level limits; "
            f"{FAVOR_NOTE}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite logits")
    return {"audit": audited, "model_limits_missed": missed,
        "launches": counts, "prefill_ms": prefill_ms, "prefill_runs_ms": prefill_runs,
        "generate_ms": gen_ms, "generate_runs_ms": gen_runs, "decode_ms_per_token": decode_ms,
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
    gc.collect()  # no collection of earlier phases' objects inside the timed runs
    prefill_runs = [wall_ms(lambda: generate(model, prompts, 1, greedy, quant=mode))[0]
                    for _ in range(3)]
    _reset_counts(mods)
    gen_ms, out = wall_ms(lambda: generate(model, prompts, new_tokens, greedy, quant=mode))
    counts = _counts(mods)
    lin, attn, _, _ = _layer_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    # a quantized MoE never takes the gmm kernels; every q4 launch of a decode
    # step (bf16 x at the model's widths) takes the mma kernel, none the simt
    want.update(causal_dot_norm_wgmma=lin, flash_fwd_wgmma=attn,
                q4_matmul_mma=_q4_per_step(cfg) * (new_tokens - 1) if mode == "int4" else 0)
    log(f"{name} {mode} generate launches: {counts}")
    if counts != want:
        raise AssertionError(f"{name} {mode} generate launched {counts}, want {want}")
    if out.shape != (4, new_tokens) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generate returned the wrong shape / out-of-vocab tokens")
    # decode is host-bound and the host is shared: the median of 3 generates
    gen_runs = [gen_ms] + [
        wall_ms(lambda: generate(model, prompts, new_tokens, greedy, quant=mode))[0]
        for _ in range(2)]
    gen_ms = float(np.median(gen_runs))
    prefill_ms = float(np.median(prefill_runs))
    decode_ms = (gen_ms - prefill_ms) / (new_tokens - 1)
    log(f"{name} {mode} B4 T{prompt_len}: prefill {prefill_ms:.2f} ms (runs "
        f"{[round(x, 2) for x in prefill_runs]}); generate {new_tokens} tokens {gen_ms:.2f} ms "
        f"(runs {[round(x, 2) for x in gen_runs]}); decode {decode_ms:.3f} ms/token at batch 4")

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
            "generate_ms": gen_ms, "generate_runs_ms": gen_runs, "decode_ms_per_token": decode_ms,
            "logits_max_abs_err": errs,
            "q4_per_step": _q4_per_step(cfg)}


def _tiny_simt_only(label, before, cfg, trained):
    """A tiny fp32 run's launches of rows 1 and 6 and, with ``trained``, of
    rows 3 and 4 since ``before`` (``_variant_counts()``): only the simt
    variants, one or more of each for the layer kinds ``cfg`` has (rows 3
    and 4 none without ``trained``); none of a wgmma or mma variant of any
    row (2, 5, 14 included)."""
    moved = {k: v - before[k] for k, v in _variant_counts().items()}
    kinds = set(cfg.resolved_layer_types)
    want = {"causal_dot_norm_simt": "linear" in kinds,
            "causal_dot_dq_den_simt": trained and "linear" in kinds,
            "causal_dot_rev_den_simt": trained and "linear" in kinds,
            "flash_fwd_simt": bool(kinds & {"softmax", "swa"})}
    if any(v for k, v in moved.items() if k.endswith(("_wgmma", "_mma"))) or any(
            bool(moved[k]) != w for k, w in want.items()):
        raise AssertionError(f"{label}: launches {moved}, want only the simt variants")
    return moved


def _variant_counts():
    from orion_tpu_torch.ops.kernels import causal_dot, flash_attention, q4_matmul

    return {"causal_dot_norm_wgmma": causal_dot.launches_wgmma,
            "causal_dot_norm_simt": causal_dot.launches_simt,
            "causal_dot_wgmma": causal_dot.launches_raw_wgmma,
            "causal_dot_simt": causal_dot.launches_raw_simt,
            "causal_dot_rev_wgmma": causal_dot.launches_raw_rev_wgmma,
            "causal_dot_rev_simt": causal_dot.launches_raw_rev_simt,
            "q4_matmul_mma": q4_matmul.launches_mma,
            "q4_matmul_simt": q4_matmul.launches_simt,
            "causal_dot_dq_den_wgmma": causal_dot.launches_dq_wgmma,
            "causal_dot_dq_den_simt": causal_dot.launches_dq_simt,
            "causal_dot_rev_den_wgmma": causal_dot.launches_rev_wgmma,
            "causal_dot_rev_den_simt": causal_dot.launches_rev_simt,
            "flash_fwd_wgmma": flash_attention.launches_fwd_wgmma,
            "flash_fwd_simt": flash_attention.launches_fwd_simt}


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
    before, variants = q4_matmul.launches, _variant_counts()
    got = generate(tiny_gpu, tp.to(dev), 16, greedy, quant=quant)
    if quant == "int4" and q4_matmul.launches != before + 15 * _q4_per_step(cfg):
        raise AssertionError(f"{label}: {q4_matmul.launches - before} q4 launches, want "
                             f"{15 * _q4_per_step(cfg)}")
    # fp32: every q4 launch of the decode steps on the simt kernel
    moved = _tiny_simt_only(label, variants, cfg, trained=False)
    if quant == "int4" and moved["q4_matmul_simt"] != 15 * _q4_per_step(cfg):
        raise AssertionError(f"{label}: q4 launches by variant {moved}, want all simt")
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


def train_phase(dev, mods, name, seq_len, overrides=None, optimizer="adamw", then=None,
                steps=4, param_storage="float32"):
    """``name`` (with ``overrides``) training at full width: 1 warm-up and
    ``steps - 1`` timed steps, with exact launch counts per step; with
    ``optimizer="adafactor_fused"`` then one update through the kernels
    against the plain formulas (``adafactor_update_check``); then
    ``then(trainer)``, whose result the returned dict holds as "then"."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.training.data import DataLoader, SyntheticDataset
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=get_config(name, **(overrides or {})), steps=steps, batch_size=8,
                      seq_len=seq_len, optimizer=optimizer, param_storage=param_storage)
    m = cfg.model
    lin, attn, lin_remat, attn_remat = _layer_counts(m)
    products, products_remat = _gmm_counts(m)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"causal_dot_norm_wgmma": lin + lin_remat, "causal_dot_dq_den_wgmma": lin,
                 "causal_dot_rev_den_wgmma": lin, "flash_fwd_wgmma": attn + attn_remat,
                 # bf16 at D 128: the wgmma kernels, none of the simt
                 "flash_dq_wgmma": attn, "flash_dkv_wgmma": attn,
                 # forward, recomputation, and dx by the forward kernel against w^T;
                 # bf16 at the model's widths: the wgmma kernels, none of the simt
                 "gmm_fwd_wgmma": 2 * products + products_remat, "gmm_dw_wgmma": products})
    # a full collection of the Python objects earlier phases left would land
    # inside a timed step (one hybrid_1b3 step 100-250 ms slower); collect now
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    if optimizer == "adafactor_fused":  # each pass once for every kernel leaf; the sums
        n_af = _af_kernel_leaves(trainer.params)  # and the squared sum launch twice a call
        want.update(adafactor_sums=2 * n_af, adafactor_rms=2 * n_af, adafactor_apply=n_af)
    log(f"{name} trainer: {sum(p.numel() for p in trainer.params.values()) / 1e9:.3f} B "
        f"params ({param_storage} storage) + {optimizer} state, init "
        f"{time.perf_counter() - t0:.1f} s")
    loader = DataLoader(SyntheticDataset(m.vocab_size, cfg.seq_len), cfg.batch_size,
                        seed=cfg.seed, device=dev)
    steps_ms, losses = [], []
    _reset_counts(mods)
    per_step, before = [], _counts(mods)
    try:
        for _ in range(steps):
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
    log(f"{name} train B8 T{seq_len}, {optimizer}, {param_storage} storage, overrides "
        f"{overrides or {}}: step ms {[round(x, 2) for x in steps_ms]} (first is the "
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
            want.update(causal_dot_norm_wgmma=_layer_counts(cfg)[0],
                        q4_matmul_mma=(new_tokens - 1) * _q4_per_step(cfg) if mode else 0)
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


def grad_check(dev, name, seq_len, batch_size=8, overrides=None, ref_overrides=None,
               audit=False, model_limits=True):
    """One batch's loss and every parameter's gradient through the kernels
    (backend="cuda") against backend="torch" (or, with ``ref_overrides``,
    against the kernel path with those overrides: remat "dots" against
    "full"), same weights and, for a MoE model, the same expert choices
    (``PinnedRouting``), on the card. A parameter that no gradient reaches
    (the fixed ``favor_proj``) counts as a zero gradient on both sides.
    ``audit`` and ``model_limits`` as in ``generate_phase``: the kernel
    run's forward and backward launches held against their plain versions
    on the same inputs; the loss and gradient limits read but not failed."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.ops.kernels import causal_dot
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import lm_loss, param_grads

    cfg = get_config(name, **(overrides or {}))
    batch = device_batch(SyntheticDataset(cfg.vocab_size, seq_len), 0, 99, batch_size, dev)
    grads, losses = {}, {}
    weights = None
    pin = PinnedRouting()
    ref_cfg = (dataclasses.replace(cfg, **ref_overrides) if ref_overrides
               else dataclasses.replace(cfg, backend="torch"))
    launch_audit = LaunchAudit(causal_dot) if audit else contextlib.nullcontext()
    for backend, run_cfg in (("cuda", cfg), ("torch", ref_cfg)):
        model = TransformerLM(run_cfg, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(3))
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        with pin, (launch_audit if backend == "cuda" else contextlib.nullcontext()):
            loss = lm_loss(pin.attach(model), batch)  # the backward's recomputation
            loss.backward()  # routes inside ``pin`` too
        losses[backend] = float(loss.detach())
        if backend == "cuda":
            pin.flips = pin.choices = 0  # count the reference's choices only
        missing = [n for n, p in model.named_parameters() if p.requires_grad and p.grad is None]
        if missing:
            raise AssertionError(f"backend={backend}: no gradient for {missing[:5]} "
                                 f"({len(missing)} params)")
        grads[backend] = param_grads(dict(model.named_parameters()))
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
    against = f"overrides {ref_overrides}" if ref_overrides else "backend='torch'"
    log(f"{name} grad check B{batch_size} T{seq_len}, overrides {overrides or {}}, kernels vs "
        f"{against}: loss "
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
    audited = launch_audit.check(f"{name} {overrides or {}} grad check") if audit else None
    missed = loss_err > LM_LOSS_ATOL or worst[0][1] > LM_GRAD_REL_L2
    if not finite or (missed and model_limits):
        raise AssertionError(f"{name} gradients through the kernels disagree with {against}")
    if missed:
        log(f"{name} {overrides}: the loss / gradients miss the model-level limits; {FAVOR_NOTE}")
    return {"loss_abs_err": loss_err, "grad_rel_l2_max": worst[0][1], "by_kind": by_kind,
            "routing_flips": pin.flips, "losses": losses, "audit": audited,
            "model_limits_missed": missed}


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
    gate, before, variants = af._MIN_KERNEL_ELEMS, af.launches_apply, _variant_counts()
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
    _tiny_simt_only(label, variants, model_cfg, trained=True)
    err = max(abs(a - b) for a, b in zip(got, ref))
    log(f"{label} fp32 train, card vs CPU: losses {got} vs {ref}, max diff {err:.3e} "
        f"(limit {TINY_LOSS_ATOL:g})")
    if err > TINY_LOSS_ATOL:
        raise AssertionError(f"{label} training on the card disagrees with the CPU")
    return {"loss_max_abs_err": err}


# Why a model's logits, states and gradients may miss the model-level limits
# (LOGITS_ATOL, LAYER_S_RTOL, LM_LOSS_ATOL, LM_GRAD_REL_L2) against
# backend="torch" with sound kernels: those limits assume that a one-step
# bf16 flip in a layer's output moves the next layers a little (elu+1 is
# linear above 0). FAVOR+'s phi is exp(w . x' - |x'|^2 / 2), |w_i| near
# sqrt(Dh) = 11.3: a flip moves the next layer's phi by percents, and a few
# tokens' phi dominate S. ``plain_spread`` measures it: the plain path
# against itself with the sums in another order (chunk 128 against 64). Where
# that spread alone misses the limits, no path could meet them, so they are
# read and printed, not failed, and every kernel launch is held against its
# plain version on the same inputs instead (``LaunchAudit``).
FAVOR_NOTE = ("the plain path misses them against itself (plain_spread), so every launch of "
              "rows 1, 3, 4 is held against its plain version on the same inputs instead")


def plain_spread(dev, name, seq_len, overrides):
    """The plain path (backend="torch") against itself with its sums in
    another order (chunk 128 against the default 64): the prefill's logits
    and per-layer S at generate's shape (4 x ``seq_len``), then the grad
    check's loss and gradients (B 8). Returns whether that spread alone
    misses the model-level limits, with its readings."""
    from orion_tpu_torch.generate import cast_params_for_inference
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = get_config(name, **overrides, backend="torch")
    a = cast_params_for_inference(TransformerLM(dataclasses.replace(cfg, chunk=128), device=dev,
                                                generator=torch.Generator(device=dev).manual_seed(0)))
    b = cast_params_for_inference(TransformerLM(cfg, device=dev))
    b.load_state_dict(a.state_dict())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, seq_len), dtype=np.int64)).to(dev)
    with torch.inference_mode():
        la, sa = a.prefill_last(prompts)
        lb, sb = b.prefill_last(prompts)
    logits_err = float((la - lb).abs().max())
    s_err = _state_err(sa, sb)[0]
    del a, b, sa, sb
    torch.cuda.empty_cache()
    g = grad_check(dev, name, seq_len, overrides={**overrides, "backend": "torch", "chunk": 128},
                   ref_overrides={"backend": "torch", "chunk": None}, model_limits=False)
    missed = (logits_err > LOGITS_ATOL or (s_err or 0.0) > LAYER_S_RTOL
              or g["model_limits_missed"])
    log(f"{name} {overrides} plain path against itself (chunk 128 vs 64): prefill logits max abs "
        f"{logits_err:.4e} (limit {LOGITS_ATOL}), per-layer S max rel {s_err} (limit "
        f"{LAYER_S_RTOL:g}); gradients relative L2 up to {g['grad_rel_l2_max']:.4g} (limit "
        f"{LM_GRAD_REL_L2:g}): the model-level limits {'missed' if missed else 'met'}")
    return missed, {"logits_max_abs": logits_err, "s_max_rel": s_err,
                    "grad_rel_l2_max": g["grad_rel_l2_max"], "loss_abs_err": g["loss_abs_err"]}


class LaunchAudit:
    """Every launch of rows 1, 3 and 4 inside ``with LaunchAudit(cd):``
    held against its plain version on the same inputs, at the kernel
    limits of ``compare_causal_dot`` / ``compare_training_kernels``: row 1's
    out within ``OUT_ATOL + OUT_RTOL |ref|`` and its final state (and num,
    den) within ``STATE_RTOL`` of their largest magnitude; rows 3 and 4's
    dq, dk, dv by ``_grad_reading`` and dS0, dz0 within ``STATE_RTOL``. The
    wrappers call the kernel once (its count moves once) and the plain
    version beside it, uncounted. ``worst`` keeps each quantity's largest
    share of its limit (above 1 fails ``check``)."""

    def __init__(self, cd):
        self.cd, self.worst, self.launches = cd, {}, 0
        self.real = (cd.causal_dot_norm_cuda, cd.causal_dot_dq_den_cuda,
                     cd.causal_dot_rev_den_cuda)

    def _note(self, key, share):
        self.worst[key] = max(self.worst.get(key, 0.0), float(share))

    def _state(self, key, got, ref):
        if got is not None:
            self._note(key, _rel(got, ref) / STATE_RTOL)

    def norm(self, q, k, v, s0=None, z0=None, *, eps=1e-6, with_parts=False):
        res = self.real[0](q, k, v, s0, z0, eps=eps, with_parts=with_parts)
        ref = self.cd.causal_dot_norm_plain(q, k, v, s0, z0, eps=eps, with_parts=with_parts)
        out, r_out = res[0].float(), ref[0].float()
        self._note("row1 out", ((out - r_out).abs() / (OUT_ATOL + OUT_RTOL * r_out.abs())).max())
        for key, got, r in zip(("row1 S", "row1 z", "row1 num", "row1 den"), res[1:], ref[1:]):
            self._state(key, got, r)
        self.launches += 1
        return res

    def dq_den(self, g, v, k, gden, s0=None, z0=None):
        dq = self.real[1](g, v, k, gden, s0, z0)
        self._note("row3 dq", _grad_reading(dq, self.cd.causal_dot_dq_den_plain(
            g, v, k, gden, s0, z0))["over_limit"])
        self.launches += 1
        return dq

    def rev_den(self, q, k, v, g, gden, gsf=None, gzf=None):
        res = self.real[2](q, k, v, g, gden, gsf, gzf)
        ref = self.cd.causal_dot_rev_den_plain(q, k, v, g, gden, gsf, gzf)
        for key, got, r in zip(("row4 dk", "row4 dv"), res[:2], ref[:2]):
            self._note(key, _grad_reading(got, r)["over_limit"])
        for key, got, r in zip(("row4 dS0", "row4 dz0"), res[2:], ref[2:]):
            self._state(key, got, r)
        self.launches += 1
        return res

    def __enter__(self):
        cd = self.cd
        cd.causal_dot_norm_cuda, cd.causal_dot_dq_den_cuda, cd.causal_dot_rev_den_cuda = (
            self.norm, self.dq_den, self.rev_den)
        return self

    def __exit__(self, *exc):
        cd = self.cd
        cd.causal_dot_norm_cuda, cd.causal_dot_dq_den_cuda, cd.causal_dot_rev_den_cuda = self.real

    def check(self, label):
        log(f"{label}: {self.launches} launches of rows 1, 3, 4 each held against its plain "
            f"version on the same inputs; largest share of the kernel limit by quantity "
            f"{ {k: float(f'{v:.3g}') for k, v in self.worst.items()} }")
        if not self.launches or any(v > 1.0 or not np.isfinite(v) for v in self.worst.values()):
            raise AssertionError(f"{label}: a launch of rows 1, 3, 4 disagrees with its plain "
                                 f"version: {self.worst}")
        return dict(self.worst)


class StepClock:
    """A ``MetricsLogger`` stand-in for ``train_lra``: the host clock at
    each training step's log call (``log_every=1``; the step's metrics are
    host floats, so the call comes after the card finished the step)."""

    def __init__(self):
        self.times, self.metrics = [], []

    def log(self, step, metrics, tokens_per_step=0):
        if "loss" in metrics:
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            self.metrics.append(dict(metrics))


# LRA, the card against the CPU on the same params, one batch of 2 at the
# full T, fp32 with TF32 off: the same fp32 products and sums in another
# order. Logits and loss within 1e-4 of max(1, their largest magnitude);
# every gradient within 1e-4 relative L2 error. A gradient's single elements
# are not held to 1e-4 of its largest: a weight of a linear layer sums
# T x B = 4000 terms of either sign, many times the result, through the
# normalizer (the card read 1.03e-4 of the largest |g| on one wq element at
# T 2000, against about sqrt(4000) x 2^-24 x 30 = 1.1e-4 expected); the
# element measure is printed beside the limit.
LRA_ATOL_OF_MAX, LRA_GRAD_REL_L2 = 1e-4, 1e-4


def lra_phase(dev, mods, name, seq_len, batch_size, steps=8, tsv_steps=3):
    """``train_lra`` on ``name`` at full width and LRA's length: ``steps``
    steps on the synthetic task and an eval of 2 batches (step ms, the mean
    after the first; peak memory; final loss and accuracy), then
    ``tsv_steps`` steps and an eval of 1 batch on the repo's
    ``data/lra_sample`` TSVs at the same T (their rows are shorter: the key
    mask pads them). The classifier's attention is bidirectional and masked:
    no kernel runs, in the JAX package or here, and none may launch."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.train_lra import LRATrainConfig, train_lra

    task = "listops" if "listops" in name else "text"
    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock()
    _reset_counts(mods)
    t0 = time.perf_counter()
    params, last = train_lra(LRATrainConfig(
        model=cfg, task=task, steps=steps, batch_size=batch_size, seq_len=seq_len,
        log_every=1, eval_every=steps, eval_batches=2, seed=0), clock, device=dev)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [1e3 * (b - a) for a, b in zip(clock.times, clock.times[1:])]
    mean_ms = float(np.mean(step_ms[1:])) if len(step_ms) > 1 else float("nan")
    launched = {k: v for k, v in _counts(mods).items() if v}
    log(f"{name} train_lra {task} B{batch_size} T{seq_len}: {steps} steps + eval in {wall:.1f} s; "
        f"step ms {[round(x, 2) for x in step_ms]} (from the 2nd step's end), mean after the "
        f"first {mean_ms:.2f} ms; max memory allocated {peak_gib:.2f} GiB; final loss "
        f"{last['loss']:.4f}, acc {last['acc']:.4f}, eval acc {last['eval_acc']:.4f}; "
        f"kernel launches {launched}")
    if launched:
        raise AssertionError(f"{name}: the classifier launched kernels {launched}")
    if not all(np.isfinite(m["loss"]) and m["nonfinite"] == 0.0 for m in clock.metrics) or \
            not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError(f"{name}: a non-finite loss or parameter")
    del params
    data = ROOT / "data" / "lra_sample" / task
    _, tsv = train_lra(LRATrainConfig(
        model=cfg, task=str(data), steps=tsv_steps, batch_size=batch_size, seq_len=seq_len,
        log_every=1, eval_every=tsv_steps, eval_batches=1, seed=0), None, device=dev)
    log(f"{name} train_lra on {data.relative_to(ROOT)} B{batch_size} T{seq_len}: {tsv_steps} "
        f"steps, loss {tsv['loss']:.4f}, acc {tsv['acc']:.4f}, eval acc {tsv['eval_acc']:.4f}")
    if not np.isfinite(tsv["loss"]) or tsv["nonfinite"]:
        raise AssertionError(f"{name}: a non-finite loss on the TSV sample")
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_mean": mean_ms, "max_memory_gib": peak_gib,
            "wall_s": wall, "last": last, "tsv": tsv}


def lra_card_vs_cpu(dev, name, seq_len):
    """One batch of 2 at the full T (the second row's keys padded from
    T/2): the classifier's logits, loss and every gradient on the card
    against the CPU, same params (``LRA_ATOL_OF_MAX``, ``LRA_GRAD_REL_L2``)."""
    from orion_tpu_torch.models.classifier import LRAClassifier
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.train_lra import lra_loss, make_lra_dataset, LRATrainConfig
    from orion_tpu_torch.training.trainer import param_grads

    cfg = get_config(name)
    cpu = LRAClassifier(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = LRAClassifier(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ds = make_lra_dataset(LRATrainConfig(model=cfg, task="listops" if "listops" in name
                                         else "text", seq_len=seq_len))
    toks, labels, mask = (torch.from_numpy(a) for a in ds.batch(7, 0, 2))
    mask[1, seq_len // 2:] = False
    res = {}
    for label, model, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        t0 = time.perf_counter()
        args = (toks.long().to(d), labels.long().to(d), mask.to(d))
        loss, _ = lra_loss(model, *args)
        loss.backward()
        with torch.no_grad():
            logits = model(args[0], args[2])
        res[label] = {"logits": logits.cpu(), "loss": loss.detach().cpu(),
                      **{n: g.cpu() for n, g in param_grads(dict(model.named_parameters())).items()}}
        res[label + "_s"] = time.perf_counter() - t0
    cpu_res, card = res["cpu"], res["card"]
    out_err = max(float((card[k] - cpu_res[k]).abs().max()) / max(1.0, float(cpu_res[k].abs().max()))
                  for k in ("logits", "loss"))
    grads = [n for n in cpu_res if n not in ("logits", "loss")]
    rel_l2 = {n: float((card[n] - cpu_res[n]).norm() / cpu_res[n].norm().clamp_min(1e-30))
              for n in grads}
    of_max = {n: float((card[n] - cpu_res[n]).abs().max()) / max(float(cpu_res[n].abs().max()),
                                                                 1e-30) for n in grads}
    worst = max(rel_l2, key=rel_l2.get)
    worst_el = max(of_max, key=of_max.get)
    log(f"{name} B2 T{seq_len} card vs CPU (fp32, no TF32; CPU {res['cpu_s']:.1f} s, card "
        f"{res['card_s']:.1f} s): logits and loss within {out_err:.3e} of max(1, |ref|) (limit "
        f"{LRA_ATOL_OF_MAX:g}), loss {float(card['loss']):.6f} vs {float(cpu_res['loss']):.6f}; "
        f"{len(grads)} gradients, worst relative L2 {worst} {rel_l2[worst]:.3e} (limit "
        f"{LRA_GRAD_REL_L2:g}); worst element relative to its tensor's largest {worst_el} "
        f"{of_max[worst_el]:.3e}")
    if out_err > LRA_ATOL_OF_MAX or rel_l2[worst] > LRA_GRAD_REL_L2 or not all(
            bool(torch.isfinite(t).all()) for t in card.values()):
        raise AssertionError(f"{name}: the card disagrees with the CPU")
    return {"out_err": out_err, "grad_rel_l2": rel_l2[worst], "grad_of_max": of_max[worst_el]}


def sr_check(dev):
    """``sr_round_bf16`` on the card against the CPU, bitwise, for the same
    key words, on 2^24 values of many binades (inf, -inf and NaN among
    them)."""
    from orion_tpu_torch.training.trainer import sr_round_bf16

    g = torch.Generator().manual_seed(11)
    x = torch.randn(1 << 24, generator=g) * torch.exp2(torch.randint(-20, 20, (1 << 24,),
                                                                     generator=g).float())
    x[:3] = torch.tensor([float("inf"), -float("inf"), float("nan")])
    xd = x.to(dev)
    for words in ((0, 0), (0x9E3779B9, 0x85EBCA6B), (0xFFFFFFFF, 0x12345678)):
        same = torch.equal(sr_round_bf16(xd, words).cpu().view(torch.int16),
                           sr_round_bf16(x, words).view(torch.int16))
        if not same:
            raise AssertionError(f"sr_round_bf16 on the card differs from the CPU for {words}")
    ms = cuda_ms(lambda: sr_round_bf16(xd, (1, 2)), 5)
    log(f"sr_round_bf16 on the card bitwise the CPU's on 2^24 values for 3 key words; "
        f"{ms:.3f} ms for 2^24 values (plain torch)")
    return ms


def _storage(trainer):
    """Param dtypes by count: matrices bf16, 1-D fp32 under bfloat16_sr."""
    wrong = [n for n, p in trainer.params.items()
             if p.dtype != (torch.bfloat16 if p.dim() >= 2 else torch.float32)]
    if wrong:
        raise AssertionError(f"bfloat16_sr storage: wrong dtypes for {wrong[:5]}")
    return {"bf16": sum(p.dim() >= 2 for p in trainer.params.values()),
            "fp32": sum(p.dim() < 2 for p in trainer.params.values())}


# ---------------------------------------------------------------------------
# Serving: SlotEngine over the slot programs, the in-scan prefill pieces, the
# in-place caches and DecodeSession; C1's row invariance
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_CHUNK, SERVE_PIECE, SERVE_NEW = 4, 16, 256, 32
SERVE_BUCKETS = (256, 512, 1024, 2048)
# lm_1b3's requests: (prompt length, first boundary it may enter)
LM_PLAN = ((1024, 0), (640, 0), (300, 0), (1000, 2), (77, 1), (512, 2))
# hybrid_1b3's: two prompts past the 1024-key window, then a short one that
# in-scan arrives while the 1100-token one is still mid-prefill
HYBRID_PLAN = ((1536, 0), (1100, 0), (200, 2))
SAMPLED_SERVE = dict(temperature=0.8, top_k=50, top_p=0.95)


def _serve_prompts(plan, vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (1, n), dtype=np.int64) for n, _ in plan]


def serve_engine(model, mode, chunk=SERVE_CHUNK, **kw):
    """A 4-slot ``SlotEngine`` on the model's card: ``"host"`` prefills each
    prompt solo at its own length (no buckets: the prefill of a one-row
    ``generate``), ``"inscan"`` stages it and consumes pieces of 256."""
    from orion_tpu_torch.serving import SlotEngine

    if mode == "inscan":
        kw.update(prefill_buckets=SERVE_BUCKETS, prefill_chunk=SERVE_PIECE)
    return SlotEngine(model, slots=SERVE_SLOTS, chunk=chunk, device=model.device, **kw)


def _row_copy(eng, j):
    """A copy of slot ``j``'s carry row: its states, t, emit and done."""
    from orion_tpu_torch.models.transformer import extract_decode_slot

    c = eng._carry
    return extract_decode_slot(c[1], j), [x[j].clone() for x in (c[2], c[3], c[4])]


def _rows_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a[0], b[0]) for k in x) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def run_plan(model, plan, sample, mode, only=None, seed0=100, fault=None, watch=False):
    """Serve ``plan``'s requests through a fresh engine (``mode``): request i
    is admitted at its first boundary or later, when a slot is free
    (``only``: those requests alone). ``fault``: an ``inject.FaultPlan``
    armed for the run. ``watch``: at every boundary the rows it must leave
    as they are -- free slots, and slots mid-prefill the piece does not go
    to -- come out bitwise as they went in (contract (c)). -> (results by
    request, counts: solo prefills, unified and pure boundaries, rows held)."""
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest

    prompts = _serve_prompts(plan, model.cfg.vocab_size)
    eng = serve_engine(model, mode)
    pending = [i for i in range(len(plan)) if only is None or i in only]
    done = {}
    stats = {"host_prefills": 0, "unified": 0, "pure": 0, "boundaries": 0, "held": 0}
    with inject.inject(fault) if fault is not None else contextlib.nullcontext():
        while pending or eng.busy:
            for i in list(pending):
                if (only is not None or stats["boundaries"] >= plan[i][1]) and eng.has_free_slot:
                    eng.admit(DecodeRequest(prompts[i], SERVE_NEW, sample, seed=seed0 + i), tag=i)
                    pending.remove(i)
                    stats["host_prefills"] += mode == "host"
            held = {}
            if watch:
                active = np.array([s is not None for s in eng._slots])
                sel = eng._selected_prefill_slot(active)
                held = {j: _row_copy(eng, j) for j, s in enumerate(eng._slots)
                        if s is None or (s.prompt_remaining > 0 and j != sel)}
            stats["unified" if eng.prefilling_count else "pure"] += 1
            done.update(dict(eng.step()))
            for j, row in held.items():
                if not _rows_equal(row, _row_copy(eng, j)):
                    raise AssertionError(f"slot {j}'s row moved at boundary {stats['boundaries']} "
                                         "though it was free or held mid-prefill (c)")
            stats["held"] += len(held)
            stats["boundaries"] += 1
            if stats["boundaries"] > 64:
                raise AssertionError("the slot plan did not drain")
    return done, stats


def _tokens(results):
    return {i: r.tokens[0].tolist() for i, r in results.items()}


def serve_times(model, plan, label, card):
    """Through the engine: decode ms/token with 4 busy slots (a boundary of
    16 steps over 16, median of 3 after one), and the boundary cost of a
    256-token piece (a one-step unified boundary less a one-step pure one,
    medians of 5, in an in-scan engine of chunk 1 with 3 slots decoding)."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.serving import DecodeRequest

    greedy = SampleConfig(temperature=0.0)
    prompts = _serve_prompts(plan, model.cfg.vocab_size)
    eng = serve_engine(model, "host")
    for j in range(SERVE_SLOTS):
        p = prompts[j % len(prompts)]
        eng.admit(DecodeRequest(p, 256, greedy, seed=900 + j), tag=j)
    eng.step()  # warm-up
    gc.collect()
    runs = [wall_ms(eng.step)[0] / SERVE_CHUNK for _ in range(3)]
    del eng
    one = serve_engine(model, "inscan", chunk=1)
    for j in range(3):
        one.admit(DecodeRequest(prompts[-1][:, :200], 256, greedy, seed=910 + j), tag=j)
    while one.prefilling_count:
        one.step()
    long = np.random.default_rng(8).integers(0, model.cfg.vocab_size, (1, 1280), dtype=np.int64)
    one.admit(DecodeRequest(long, 16, greedy, seed=913), tag=3)
    unified = [wall_ms(one.step)[0] for _ in range(5)]
    pure = [wall_ms(one.step)[0] for _ in range(5)]
    res = {"decode_ms_per_token": float(np.median(runs)), "runs": runs,
           "unified_step_ms": unified, "pure_step_ms": pure,
           "piece_boundary_ms": float(np.median(unified) - np.median(pure))}
    log(f"{label} times ({card}): decode at 4 busy slots through SlotEngine "
        f"{res['decode_ms_per_token']:.3f} ms/token (runs {runs}); a 256-token piece's boundary "
        f"cost {res['piece_boundary_ms']:.2f} ms (a one-step unified boundary {unified}, a pure "
        f"one {pure})")
    return res


def _ladder_check(model, plan, label, clean_host, clean_inscan):
    """The engine's per-slot ladder at full width, NaN injected into one
    slot's rows: the rewind (in-scan, a neighbour mid-prefill) gives every
    request its unfaulted tokens; the re-prefill (host, request 0 at its
    chunk 1) rebuilds the state by a parallel prefill of prompt + 16
    tokens, not the 16 recurrent steps, so its tokens are held as
    ``DecodeSession``'s rung (C2): equal, or each unfaulted token within
    ``LOGITS_ATOL`` of the rebuilt walk's argmax, the others bitwise; an
    exhausted ladder (request 1) fails that request with its first 16
    tokens while the others stream on bitwise."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.resilience import inject

    greedy = SampleConfig(temperature=0.0)
    out = {}
    r, _ = run_plan(model, plan, greedy, "inscan",
                    fault=inject.FaultPlan().poison_decode_slot_at(0, chunk=1))
    out["rewind"] = {"equal": _tokens(r) == clean_inscan,
                     "rewinds": {i: x.rewinds for i, x in r.items() if x.rewinds}}
    r, _ = run_plan(model, plan, greedy, "host",
                    fault=inject.FaultPlan().poison_decode_slot_at(0, chunk=1, times=2))
    got = _tokens(r)
    others = all(got[i] == clean_host[i] for i in got if i != 0)
    gaps = [0.0]
    if got[0] != clean_host[0]:
        p = _serve_prompts(plan, model.cfg.vocab_size)[0]
        seq = np.concatenate([p, np.asarray([clean_host[0][:SERVE_CHUNK]])], axis=1)
        gaps = _forced_gaps(model, torch.from_numpy(seq).to(model.device),
                            clean_host[0][SERVE_CHUNK:])
    out["reprefill"] = {"status": r[0].status, "rungs": (r[0].rewinds, r[0].reprefills),
                        "equal": got[0] == clean_host[0], "others_equal": others,
                        "first_chunk_equal": got[0][:SERVE_CHUNK] == clean_host[0][:SERVE_CHUNK],
                        "forced_max_gap": max(gaps), "forced_off_argmax": sum(g > 0 for g in gaps)}
    # four deliveries: the attempt, the rewind's, the re-prefill's and the
    # replay with the slot masked out (unlimited ones would also poison the
    # request admitted into the freed slot later)
    r, _ = run_plan(model, plan, greedy, "host",
                    fault=inject.FaultPlan().poison_decode_slot_at(1, chunk=1, times=4))
    got = _tokens(r)
    out["exhausted"] = {"status": r[1].status, "tokens": r[1].new_tokens,
                        "prefix_equal": got[1] == clean_host[1][:SERVE_CHUNK],
                        "others_equal": all(got[i] == clean_host[i] for i in got if i != 1)}
    log(f"{label} ladder, NaN in one slot's rows: {out}")
    rp = out["reprefill"]
    if not (out["rewind"]["equal"] and len(out["rewind"]["rewinds"]) == 1
            and rp["status"] == "ok" and rp["rungs"] == (1, 1) and rp["others_equal"]
            and rp["first_chunk_equal"] and rp["forced_max_gap"] <= LOGITS_ATOL
            and out["exhausted"]["status"] == "failed" and out["exhausted"]["tokens"] == SERVE_CHUNK
            and out["exhausted"]["prefix_equal"] and out["exhausted"]["others_equal"]):
        raise AssertionError(f"{label}: the engine's ladder misbehaved: {out}")
    return out


def _session_check(model, plan, label, clean_host):
    """Suspend -> resume: request 0 served as two turns of 16 tokens (its
    slot suspended at the first's end, its state copied to the host and
    written back) equals its 32 uninterrupted tokens, bitwise."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.serving import DecodeRequest

    greedy = SampleConfig(temperature=0.0)
    p = _serve_prompts(plan, model.cfg.vocab_size)[0]
    eng = serve_engine(model, "host")
    eng.admit(DecodeRequest(p, SERVE_CHUNK, greedy, seed=100, session_id="s"), tag=1)
    (_, first), = eng.step()
    eng.resume(first.session, DecodeRequest(np.zeros((1, 0), np.int64), SERVE_NEW - SERVE_CHUNK,
                                            greedy, seed=100, session_id="s"), tag=2)
    (_, second), = eng.step()
    tokens = first.tokens[0].tolist() + second.tokens[0].tolist()
    ok = (first.status == "ok" and first.session is not None and second.status == "ok"
          and tokens == clean_host[0])
    log(f"{label} session: two turns of {SERVE_CHUNK} through suspend and resume equal the "
        f"uninterrupted request: {ok}")
    if not ok:
        raise AssertionError(f"{label}: suspend -> resume moved the tokens")
    return ok


def _server_config(mode, **kw):
    """The Server's counterpart of ``serve_engine``: 4 slots, chunk 16; host
    admission without buckets, or in-scan pieces of 256."""
    from orion_tpu_torch.serving import ServeConfig

    if mode == "inscan":
        kw.update(prefill_buckets=",".join(map(str, SERVE_BUCKETS)), prefill_chunk=SERVE_PIECE)
    else:
        kw.update(prefill_buckets="off", prefill_chunk=0)
    return ServeConfig(chunk=SERVE_CHUNK, slots=SERVE_SLOTS, **kw)


def server_plan(model, plan, sample, mode, qmode="off", fault=None, **kw):
    """Every request of ``plan`` submitted to a fresh ``Server`` up front (the
    engine's seeds), then ``serve()``: to idle, or, with a ``fault`` armed,
    until its SIGTERM drain ends. -> (server, pendings, serve() seconds)."""
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest, Server

    kw.setdefault("max_inflight", len(plan))
    srv = Server(model, _server_config(mode, qmode=qmode, **kw))
    ps = [srv.submit(DecodeRequest(p, SERVE_NEW, sample, seed=100 + i))
          for i, p in enumerate(_serve_prompts(plan, model.cfg.vocab_size))]
    t0 = time.perf_counter()
    with inject.inject(fault) if fault is not None else contextlib.nullcontext():
        rc = srv.serve(drain_when_idle=fault is None)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"Server.serve() returned {rc}")
    return srv, ps, time.perf_counter() - t0


def _server_want(srv, cfg, mode, quant):
    """A Server run's exact launches, from its flight ring's admissions and
    prefill pieces and its boundary count: row 1 once for each linear layer
    of a solo prefill or a piece, row 6 once for each softmax / swa layer of
    a solo prefill, row 14 once for each int4 layer and decode step."""
    lin, attn, _, _ = _layer_counts(cfg)
    admits = len(srv.flight.events("admit"))
    pieces = len(srv.flight.events("prefill_piece"))
    want = dict.fromkeys(KERNELS, 0)
    want.update(causal_dot_norm_wgmma=lin * (admits if mode == "host" else pieces),
                flash_fwd_wgmma=attn * admits if mode == "host" else 0,
                q4_matmul_mma=(_q4_per_step(cfg) * srv.stats["chunks"] * SERVE_CHUNK
                               if quant == "int4" else 0))
    return want


def _bucket_range(cell, buckets, q):
    """The (lo, hi] bucket of a histogram cell that holds its q-quantile."""
    k = max(1, -(-int(q * 1000) * cell["count"] // 1000))
    seen = 0
    for i, c in enumerate(cell["counts"]):
        seen += c
        if seen >= k:
            return (buckets[i - 1] if i else 0, buckets[i])
    return (buckets[-2], buckets[-1])


def server_times(model, plan, label, card, engine_tokens):
    """Readings, not claims: decode ms/token at 4 busy slots through the
    Server (its own boundary spans, each boundary of 16 steps, the first
    left out) and through a bare SlotEngine (``wall_ms`` of each step) in
    turns, server / engine / server / engine; the Server registry's
    chunk_ms p50 / p99 as the buckets that hold them; the time to first
    token of a late request, submitted from a thread after boundary 2 while
    three slots decode (from its request span's start to the end of its
    first decode chunk), its tokens bitwise the engine's."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.obs.trace import Tracer
    from orion_tpu_torch.serving import DecodeRequest, Server

    greedy = SampleConfig(temperature=0.0)
    prompts = _serve_prompts(plan, model.cfg.vocab_size)
    long_new = 8 * SERVE_CHUNK
    reqs = [DecodeRequest(prompts[j % len(prompts)], long_new, greedy, seed=900 + j)
            for j in range(SERVE_SLOTS)]
    turns = {"server": [], "engine": []}
    chunk_ms = None
    for _ in range(2):
        gc.collect()
        srv = Server(model, _server_config("host", max_inflight=SERVE_SLOTS),
                     tracer=Tracer(path=None, clock=time.monotonic))
        for r in reqs:
            srv.submit(r)
        srv.serve(drain_when_idle=True)
        by_ts = {}
        for ev in srv.trace.events():
            if ev["ph"] == "X" and ev["name"] == "decode_chunk":
                by_ts.setdefault(ev["ts"], []).append(ev["dur"])
        full = [d[0] / 1e3 / SERVE_CHUNK for _, d in sorted(by_ts.items()) if len(d) == 4]
        turns["server"].append(float(np.median(full[1:])))
        if chunk_ms is None:
            cell = srv._h_chunk_ms.cell()
            chunk_ms = {"count": cell["count"],
                        "p50_bucket_ms": _bucket_range(cell, srv._h_chunk_ms.buckets, 0.5),
                        "p99_bucket_ms": _bucket_range(cell, srv._h_chunk_ms.buckets, 0.99)}
        srv.close()
        del srv
        gc.collect()
        eng = serve_engine(model, "host")
        for j, r in enumerate(reqs):
            eng.admit(r, tag=j)
        steps = [wall_ms(eng.step)[0] / SERVE_CHUNK for _ in range(long_new // SERVE_CHUNK)]
        turns["engine"].append(float(np.median(steps[1:])))
        del eng
    # the late request
    srv = Server(model, _server_config("host", max_inflight=SERVE_SLOTS),
                 tracer=Tracer(path=None, clock=time.monotonic))
    for r in reqs[:3]:
        srv.submit(dataclasses.replace(r, max_new_tokens=4 * SERVE_CHUNK))
    late = {}

    def feed():
        deadline = time.monotonic() + 300
        while srv.stats["chunks"] < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        late["p"] = srv.submit(DecodeRequest(prompts[4], SERVE_NEW, greedy, seed=104))

    feeder = threading.Thread(target=feed)
    feeder.start()
    srv.serve(drain_when_idle=True)
    feeder.join(timeout=300)
    p = late["p"]
    if not p.done.is_set():  # submitted after the loop went idle: serve it
        srv.serve(drain_when_idle=True)
    events = srv.trace.events()
    begin, admitted = ([e["ts"] for e in events if e["ph"] == ph and e["name"] == name
                        and e["id"] == p.rid][0] for ph, name in (("b", "request"), ("e", "queue")))
    chunk = min((e["ts"], e["dur"]) for e in events if e["ph"] == "X"
                and e["args"]["req"] == p.rid and e["name"] == "decode_chunk")
    ttft_ms = (chunk[0] + chunk[1] - begin) / 1e3
    # submit -> admission (the boundary in flight), admission -> its first
    # boundary's start (its solo prefill), that boundary
    parts = [(admitted - begin) / 1e3, (chunk[0] - admitted) / 1e3, chunk[1] / 1e3]
    same = p.result.tokens[0].tolist() == engine_tokens[4]
    srv.close()
    res = {"decode_ms_per_token": turns, "chunk_ms": chunk_ms, "late_ttft_ms": ttft_ms,
           "late_ttft_parts_ms": parts, "late_tokens_equal": same}
    log(f"{label} Server readings ({card}): decode at 4 busy slots through the Server "
        f"{turns['server']} ms/token, through the bare SlotEngine {turns['engine']} ms/token "
        f"(turns server / engine / server / engine, medians of {long_new // SERVE_CHUNK - 1} "
        f"boundaries of {SERVE_CHUNK} steps); the registry's chunk_ms over "
        f"{chunk_ms['count']} boundaries: p50 in the bucket {chunk_ms['p50_bucket_ms']} ms, p99 "
        f"in {chunk_ms['p99_bucket_ms']} ms (lower bound exclusive); a late request (submitted after boundary 2, 3 slots "
        f"decoding) first token after {ttft_ms:.1f} ms (queued {parts[0]:.1f}, admission to its "
        f"first boundary {parts[1]:.1f}, that boundary {parts[2]:.1f}), tokens bitwise the "
        f"engine's: {same}")
    if not same:
        raise AssertionError(f"{label}: the late request's tokens differ from the engine's")
    return res


def server_cli(config, card, n_prompts=6, prompt_len=200, device_args=(), timeout=600):
    """``python -m orion_tpu_torch.serving --config <config> --slots 4 --chunk 16
    --max-new-tokens 32 --temperature 0`` in a subprocess, ``n_prompts``
    prompts of ``prompt_len`` bytes on stdin, no ``--device`` (the card by
    default); a SIGTERM once its metrics dump (one a second) shows a
    boundary: it must drain, exit 0 (not 143) and print its stats line with
    every prompt served. -> {"rc", "wall_s", "stats"}."""
    import tempfile

    rng = np.random.default_rng(11)
    text = "".join("".join(chr(c) for c in rng.integers(97, 123, prompt_len)) + "\n"
                   for _ in range(n_prompts))
    with tempfile.TemporaryDirectory() as tmp:
        metrics = Path(tmp) / "m.prom"
        cmd = [sys.executable, "-m", "orion_tpu_torch.serving", "--config", config, "--slots",
               str(SERVE_SLOTS), "--chunk", str(SERVE_CHUNK), "--max-new-tokens", str(SERVE_NEW),
               "--temperature", "0", "--metrics-path", str(metrics), "--metrics-interval-s", "1",
               *device_args]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
                                env=dict(os.environ, PYTHONPATH=str(ROOT)))
        try:
            proc.stdin.write(text)
            proc.stdin.close()
            proc.stdin = None
            chunks = 0
            while chunks < 1 and proc.poll() is None and time.perf_counter() - t0 < timeout:
                time.sleep(0.05)
                try:
                    snap = json.loads(Path(str(metrics) + ".json").read_text())
                except (OSError, ValueError):
                    continue
                chunks = sum(c["value"] for c in snap["counters"] if c["name"] == "chunks")
            if proc.poll() is not None or chunks < 1:
                raise AssertionError(f"the serving CLI ended or stalled before its first "
                                     f"boundary: rc {proc.poll()}")
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    stats = [line for line in err.splitlines() if line.startswith("stats:")]
    res = {"rc": proc.returncode, "wall_s": wall, "stats": stats[0] if stats else None,
           "signalled_at_chunks": chunks}
    log(f"serving CLI ({config}, {card}): SIGTERM after boundary {chunks}: exit "
        f"{proc.returncode} in {wall:.1f} s wall; {res['stats']}")
    if proc.returncode != 0 or not stats or f"'ok': {n_prompts}" not in stats[0] or \
            not out.startswith(text[:prompt_len]):
        raise AssertionError(f"the serving CLI did not drain to exit 0 on SIGTERM: rc "
                             f"{proc.returncode}; stderr tail {err[-2000:]}")
    return res


def server_check(dev, mods, model, plan, label, card, engine, runs, quant="", fp=None,
                 full=False):
    """The Server over the same requests as the engine runs (``engine``:
    tokens by (sampling, admission)): each of ``runs`` bitwise the engine's
    tokens, with exact launches (``_server_want``); with ``quant`` the Server
    gets the full-precision ``fp`` and quantizes it itself (``qmode``).
    ``full``: overload (max_inflight 2: the 4 submits past it shed and
    counted, the 2 admitted bitwise), a SIGTERM at engine boundary 3 with
    the plan queued beyond the slots (serve() returns 0, health ends DEAD
    after SERVING -> DRAINING -> DEAD, every request bitwise, a later
    submit rejected), ``server_times`` and ``server_cli``."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import (DecodeRequest, Health, OverloadError, RejectedError,
                                         Server)

    samples = {"greedy": SampleConfig(temperature=0.0), "sampled": SampleConfig(**SAMPLED_SERVE)}
    served, qmode = (fp, quant) if quant else (model, "off")
    out = {"launches": {}, "serve_s": {}}
    for sname, mode in runs:
        gc.collect()
        _reset_counts(mods)
        srv, ps, secs = server_plan(served, plan, samples[sname], mode, qmode=qmode)
        counts = _counts(mods)
        want = _server_want(srv, model.cfg, mode, quant)
        got = {i: p.result.tokens[0].tolist() for i, p in enumerate(ps)}
        run = f"{sname} {mode}"
        out["launches"][run] = counts
        out["serve_s"][run] = secs
        log(f"{label} Server, {run}: {len(plan)} requests in {secs:.2f} s, stats {srv.stats}; "
            f"launches {dict((k, v) for k, v in counts.items() if v)}; tokens bitwise the "
            f"engine's: {got == engine[(sname, mode)]}")
        if counts != want:
            raise AssertionError(f"{label} Server {run} launched {counts}, want {want}")
        if got != engine[(sname, mode)] or srv.stats["ok"] != len(plan):
            raise AssertionError(f"{label} Server {run}: tokens differ from the engine's")
        srv.close()
        del srv, ps
    if not full:
        return out
    greedy_host = engine[("greedy", "host")]
    srv = Server(model, _server_config("host", max_inflight=2))
    prompts = _serve_prompts(plan, model.cfg.vocab_size)
    shed = 0
    ps = []
    for i, p in enumerate(prompts):
        try:
            ps.append((i, srv.submit(DecodeRequest(p, SERVE_NEW, samples["greedy"],
                                                   seed=100 + i))))
        except OverloadError:
            shed += 1
    srv.serve(drain_when_idle=True)
    out["overload"] = {"shed": shed, "stats_shed": srv.stats["shed"],
                       "admitted_equal": all(p.result.tokens[0].tolist() == greedy_host[i]
                                             for i, p in ps)}
    srv.close()
    plan_sig = inject.FaultPlan().preempt_at_chunk(3)
    srv, ps, secs = server_plan(model, plan, samples["greedy"], "host", fault=plan_sig)
    edges = [(a.value if a else None, b.value) for a, b, _, _ in srv.health.history]
    try:
        srv.submit(DecodeRequest(prompts[0], SERVE_NEW, samples["greedy"], seed=100))
        rejected = False
    except RejectedError:
        rejected = True
    out["sigterm"] = {"delivered": plan_sig.delivered, "health": srv.health.state.value,
                      "edges": edges, "rejected_after": rejected,
                      "all_equal": all(p.result is not None and p.result.status == "ok"
                                       and p.result.tokens[0].tolist() == greedy_host[i]
                                       for i, p in enumerate(ps)),
                      "stats": srv.stats}
    log(f"{label} Server overload and SIGTERM: {out['overload']}; {out['sigterm']}")
    if not (out["overload"]["shed"] == out["overload"]["stats_shed"] == len(plan) - 2
            and out["overload"]["admitted_equal"]):
        raise AssertionError(f"{label} Server: overload shedding misbehaved: {out['overload']}")
    sig = out["sigterm"]
    if not (sig["delivered"] == ["serve.chunk@3"] and srv.health.state is Health.DEAD
            and ("serving", "draining") in edges and ("draining", "dead") in edges
            and sig["rejected_after"] and sig["all_equal"]):
        raise AssertionError(f"{label} Server: the SIGTERM drain misbehaved: {sig}")
    del srv, ps
    out["times"] = server_times(model, plan, label, card, greedy_host)
    out["cli"] = server_cli("lm_1b3", card)
    return out


def serving_phase(dev, mods, name, plan, card, quant="", checks=("b", "f", "g", "ladder",
                                                                 "session", "times"),
                  server_runs=()):
    """``SlotEngine`` at ``name``'s full width (``quant``: quantized from the
    seeded fp32 weights), chunk 16, pieces of 256. The main path: ``plan``
    served greedy twice, by host-prefill and by in-scan admission, every
    boundary's free and held rows bitwise (c), with exact launch counts; an
    extract / insert round trip (d); in-scan == host admission (bitwise for
    a linear model, whose pieces are bitwise its prefill (g); else every
    in-scan token within ``LOGITS_ATOL`` of the one-row walk's argmax).
    ``checks``: "b" -- a request alone bitwise its tokens in company, and
    the plan with an EOS that stops request 1 early, the others bitwise
    (b); "f" -- C1: every request, greedy and sampled, bitwise a one-row
    ``generate`` at its seed, and ``row_invariance``'s op by op reading
    with no op whose row depends on the batch (f); "g" -- pieces against
    ``prefill_last``; "ladder", "session" -- ``_ladder_check``,
    ``_session_check``; "times" -- ``serve_times``; "decode_session" --
    ``session_check`` (``DecodeSession``). ``server_runs``: (sampling,
    admission) pairs served again through ``serving.Server`` and held
    bitwise against these engine runs (``server_check``; "server_full" in
    ``checks`` adds overload, the SIGTERM drain, the readings and the
    CLI)."""
    from orion_tpu_torch.generate import (SampleConfig, cast_params_for_inference, generate,
                                          quantize_for_decode)
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import (TransformerLM, extract_decode_slot,
                                                    insert_decode_slot)
    from orion_tpu_torch.serving import DecodeRequest

    cfg = get_config(name)
    fp = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model = quantize_for_decode(fp, quant) if quant else cast_params_for_inference(fp)
    if not (quant and server_runs):  # the Server quantizes the fp32 weights itself
        fp = None
    torch.cuda.empty_cache()
    label = f"{name}{' ' + quant if quant else ''} serving"
    greedy, sampled = SampleConfig(temperature=0.0), SampleConfig(**SAMPLED_SERVE)
    linear = all(lt == "linear" for lt in cfg.resolved_layer_types)
    lin, attn, _, _ = _layer_counts(cfg)
    prompts = _serve_prompts(plan, cfg.vocab_size)
    t_phase = time.perf_counter()
    run_plan(model, plan, greedy, "inscan", only=[len(plan) - 1])  # warm-up: plans, allocator
    gc.collect()

    _reset_counts(mods)
    t0 = time.perf_counter()
    host, hs = run_plan(model, plan, greedy, "host", watch=True)
    inscan, ins = run_plan(model, plan, greedy, "inscan", watch=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _counts(mods)
    steps = (hs["boundaries"] + ins["boundaries"]) * SERVE_CHUNK
    want = dict.fromkeys(KERNELS, 0)
    # every linear layer of a solo prefill and of a unified boundary's piece;
    # every softmax / swa layer of a solo prefill (the pieces' are plain, as
    # in JAX); one q4 launch per int4 layer and decode step, busy slots or not
    want.update(causal_dot_norm_wgmma=lin * (hs["host_prefills"] + ins["unified"]),
                flash_fwd_wgmma=attn * hs["host_prefills"],
                q4_matmul_mma=_q4_per_step(cfg) * steps if quant == "int4" else 0)
    log(f"{label}: {len(plan)} requests served twice through SlotEngine in {serve_s:.2f} s: host "
        f"admission {hs}, in-scan {ins}; launches {counts}; every boundary's free and held rows "
        f"bitwise (c): {hs['held'] + ins['held']} rows")
    if counts != want:
        raise AssertionError(f"{label} launched {counts}, want {want}")
    clean_host, clean_inscan = _tokens(host), _tokens(inscan)
    engine_tokens = {("greedy", "host"): clean_host, ("greedy", "inscan"): clean_inscan}
    for got in (clean_host, clean_inscan):
        if sorted(got) != list(range(len(plan))) or any(
                len(v) != SERVE_NEW or min(v) < 0 or max(v) >= cfg.vocab_size
                for v in got.values()):
            raise AssertionError(f"{label}: requests came back incomplete or out of vocabulary")
    res = {"launches": counts, "serve_s": serve_s, "host": hs, "inscan": ins}

    # (d): a row out and back in, bitwise; its neighbour untouched
    eng = serve_engine(model, "host")
    for i in (0, 1):
        eng.admit(DecodeRequest(prompts[i], SERVE_NEW, greedy, seed=100 + i), tag=i)
    states = eng._carry[1]
    row, other = extract_decode_slot(states, 0), extract_decode_slot(states, 1)
    insert_decode_slot(states, row, 3)
    same = (lambda a, b: all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x))
    if not (same(extract_decode_slot(states, 3), row)
            and same(extract_decode_slot(states, 1), other)):
        raise AssertionError(f"{label}: extract_decode_slot(insert_decode_slot(...)) moved a value")
    del eng, row, other, states

    # in-scan admission against host-prefill admission
    res["inscan_equal"] = {i: clean_inscan[i] == clean_host[i] for i in clean_host}
    if not linear:  # the pieces' swa is plain, the prefill's row 6: held as (f) was
        res["inscan_gaps"] = {i: max(_forced_gaps(model, torch.from_numpy(prompts[i]).to(dev),
                                                  clean_inscan[i]))
                              for i, eq in res["inscan_equal"].items() if not eq}
    log(f"{label}: in-scan admission against host prefill, tokens equal by request "
        f"{res['inscan_equal']}" + ("" if linear else
                                    f"; the one-row walk fed the in-scan tokens, largest gap "
                                    f"to its maximum by request {res['inscan_gaps']} (limit "
                                    f"{LOGITS_ATOL})"))
    if (linear and not all(res["inscan_equal"].values())) or (
            not linear and any(g > LOGITS_ATOL for g in res["inscan_gaps"].values())):
        raise AssertionError(f"{label}: in-scan admission disagrees with host prefill")

    if "b" in checks:  # (b): alone in its slot, and an EOS that stops request 1 early
        k = len(plan) - 1
        alone = _tokens(run_plan(model, plan, greedy, "inscan", only=[k])[0])[k]
        eos_tok = clean_host[1][3]
        got_eos = _tokens(run_plan(model, plan, dataclasses.replace(greedy, eos_token=eos_tok),
                                   "host")[0])
        res["b"] = {"alone": alone == clean_inscan[k], "eos_token": eos_tok, "eos": all(
            _eos_cut(got_eos[i], eos_tok) == _eos_cut(clean_host[i], eos_tok) and
            set(got_eos[i][len(_eos_cut(clean_host[i], eos_tok)):]) <= {0} for i in got_eos)}
        log(f"{label} (b), bitwise: {res['b']}")
        if not (res["b"]["alone"] and res["b"]["eos"]):
            raise AssertionError(f"{label}: a request's tokens moved with its company (b)")

    if "f" in checks:  # (f), C1: against a one-row generate at its seed, bitwise
        f = {"row_invariance": row_invariance(model, label)}
        padded = f["row_invariance"]["padded"]
        host_s, _ = run_plan(model, plan, sampled, "host")
        runs = {"greedy": (greedy, clean_host), "sampled": (sampled, _tokens(host_s))}
        if linear:  # its pieces are bitwise its prefill (g)
            runs["greedy in-scan"] = (greedy, clean_inscan)
            if not quant:
                runs["sampled in-scan"] = (sampled, _tokens(run_plan(model, plan, sampled,
                                                                     "inscan")[0]))
        engine_tokens.update({(k.split()[0], "inscan" if "in-scan" in k else "host"): v[1]
                              for k, v in runs.items()})
        solo = {}
        for sname, (sample, got) in runs.items():
            key = sname.split()[0]
            if key not in solo:
                solo[key] = [generate(model, torch.from_numpy(p).to(dev), SERVE_NEW, sample,
                                      100 + i)[0].tolist() for i, p in enumerate(prompts)]
            f[sname] = [solo[key][i] == got[i] for i in range(len(plan))]
        log(f"{label} (f): every request against a one-row generate at its seed, bitwise, by "
            f"request: {f}")
        if padded["culprits"] or not (padded["logits_equal"] and padded["states_equal"]) or \
                not all(all(v) for k, v in f.items() if k != "row_invariance"):
            raise AssertionError(f"{label}: slot rows differ from a one-row generate (f)")
        res["f"] = f

    if "g" in checks:  # (g): pieces of 256 (4 x row 1's chunk) against prefill_last
        g = {}
        for i, (n, _) in enumerate(plan):
            p = torch.from_numpy(prompts[i]).to(dev)
            _reset_counts(mods)
            lg, st = _prefill_pieces(model, p)
            piece_counts = _counts(mods)
            with torch.inference_mode():
                rlg, rst = model.prefill_last(p)
            mono = {k: v - piece_counts[k] for k, v in _counts(mods).items()}
            pieces = -(-n // SERVE_PIECE)
            if (piece_counts["causal_dot_norm_wgmma"], mono["causal_dot_norm_wgmma"],
                    piece_counts["causal_dot_norm_simt"], mono["causal_dot_norm_simt"]) != (
                    lin * pieces, lin, 0, 0):
                raise AssertionError(f"{label} (g): row 1 launches {piece_counts} / {mono}, "
                                     f"want {lin} x {pieces} and {lin}, all wgmma")
            kinds = cfg.resolved_layer_types
            read = [[{k: _readable_rows(cfg, lt, v, n) for k, v in a.items()}
                     for lt, a in zip(kinds, sts)] for sts in (st, rst)]
            bit = bool(torch.equal(lg, rlg)) and all(
                torch.equal(a[k], b[k]) for a, b in zip(*read) for k in a)
            err = float((lg - rlg).abs().max())
            s_err, kv_err = _state_err(*read)
            g[n] = {"pieces": pieces, "bitwise": bit, "logits_max_abs": err, "s_max_rel": s_err,
                    "kv_max_rel": kv_err, "greedy_equal": int(lg.argmax()) == int(rlg.argmax())}
            if err > LOGITS_ATOL or (s_err or 0) > LAYER_S_RTOL or (
                    kv_err or 0) > LAYER_KV_RTOL or not g[n]["greedy_equal"] or (
                    linear and not bit):
                raise AssertionError(f"{label} (g): {n} tokens in pieces disagree with "
                                     f"prefill_last: {g[n]}")
        log(f"{label} (g): pieces of {SERVE_PIECE} against prefill_last, by prompt length: {g}")
        res["g"] = g
    if "ladder" in checks:
        res["ladder"] = _ladder_check(model, plan, label, clean_host, clean_inscan)
    if "session" in checks:
        res["session"] = _session_check(model, plan, label, clean_host)
    if "times" in checks:
        res["times"] = serve_times(model, plan, label, card)
    if "decode_session" in checks:
        res["decode_session"] = session_check(model, label)
    if server_runs:
        t_server = time.perf_counter()
        res["server"] = server_check(dev, mods, model, plan, label, card, engine_tokens,
                                     server_runs, quant=quant, fp=fp,
                                     full="server_full" in checks)
        res["server"]["phase_s"] = time.perf_counter() - t_server
        log(f"{label} Server phase took {res['server']['phase_s']:.1f} s")
    log(f"{label} phase took {time.perf_counter() - t_phase:.1f} s")
    del model, fp
    torch.cuda.empty_cache()
    return res


ROW_PROBE_ROW = 2  # the row of the 4-row batch held against its one-row run


@contextlib.contextmanager
def decode_rows_at(rows):
    """``TransformerLM.decode_step``'s products at ``rows`` rows (1: each at
    the batch's own row count, as before the padding) for the block."""
    from orion_tpu_torch.models import transformer

    saved = transformer.DECODE_ROWS
    transformer.DECODE_ROWS = rows
    try:
        yield
    finally:
        transformer.DECODE_ROWS = saved


def _probe_batch(model, slots=SERVE_SLOTS, prompt_len=300):
    """``slots`` requests of different lengths prefilled solo and inserted:
    (next tokens [S], states, positions [S])."""
    from orion_tpu_torch.generate import SampleConfig, prefill_carry, request_keys
    from orion_tpu_torch.models.transformer import init_decode_state, insert_decode_slot

    dev = model.device
    rng = np.random.default_rng(11)
    states = init_decode_state(model.cfg, slots, dev)
    toks, ts = [], []
    for j in range(slots):
        p = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, prompt_len - 37 * j)))
        c = prefill_carry(model, p.to(dev), SampleConfig(temperature=0.0),
                          request_keys(j, 1, dev))
        insert_decode_slot(states, c[1], j)
        toks.append(c[0])
        ts.append(c[2])
    return torch.cat(toks), states, torch.tensor(ts, device=dev)


def row_invariance(model, label):
    """C1, op by op: one ``decode_step`` of 4 rows against row 2 alone
    (``utils/row_probe.py``), with the products padded to ``DECODE_ROWS``
    (the tree) and at the batch's own rows (``decode_rows_at(1)``): the ops
    whose row differs though their row inputs agree, the first op whose row
    differs, and whether the logits and states are bitwise."""
    from orion_tpu_torch.models import transformer
    from orion_tpu_torch.utils.row_probe import row_variant_ops

    tok, states, t = _probe_batch(model)
    out = {}
    for name, rows in (("padded", transformer.DECODE_ROWS), ("unpadded", 1)):
        with decode_rows_at(rows):
            r = row_variant_ops(model, tok, states, t, ROW_PROBE_ROW)
        brief = (lambda o: None if o is None else
                 {k: o[k] for k in ("op", "index", "gap", "shapes") if k in o})
        out[name] = {"ops": r["ops"], "culprits": [brief(o) for o in r["culprits"]],
                     "first_differs": brief(r["first_differs"]),
                     "logits_equal": r["logits_equal"], "states_equal": r["states_equal"],
                     "misaligned": brief(r["misaligned"])}
    log(f"{label} row invariance (C1), a decode step's row {ROW_PROBE_ROW} of 4 against it alone, "
        f"op by op: {out}")
    return out


def row_forms(dev):
    """Candidate forms of the decode step's products at lm_1b3 / hybrid_1b3
    widths: the row of a 4-row and of an 8-row batch against it alone, each
    bitwise or its largest difference. Dense and head products at the
    batch's rows and padded to 64; the linear layer's q.S as a batched
    product (bmm) and as a product and a sum; the swa layer's q.K and p.V
    (1024 slots) likewise; the norm's mean; the sampler's filtered logits
    and tokens."""
    from orion_tpu_torch.generate import SampleConfig, _filtered_logits, request_keys, sample_rows
    from orion_tpu_torch.models.transformer import pad_rows

    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    w = rnd(5504, 2048, dtype=bf) * 0.02
    head = rnd(32000, 2048, dtype=bf).float() * 0.02
    samp = SampleConfig(**SAMPLED_SERVE)
    keys8 = torch.cat([request_keys(100 + j, 1, dev) for j in range(8)])
    forms = {
        "linear bf16": (lambda x: torch.nn.functional.linear(x, w), [(2048,), bf]),
        "linear bf16 padded 64": (
            lambda x: torch.nn.functional.linear(pad_rows(x, 64), w)[:x.shape[0]], [(2048,), bf]),
        "head fp32": (lambda x: x.float() @ head.t(), [(2048,), bf]),
        "head fp32 padded 64": (lambda x: (pad_rows(x, 64).float() @ head.t())[:x.shape[0]],
                                [(2048,), bf]),
        "norm mean": (lambda x: (x * x).mean(-1), [(2048,), torch.float32]),
        "norm mean padded 64": (lambda x: (pad_rows(x, 64) * pad_rows(x, 64)).mean(-1)[:x.shape[0]],
                                [(2048,), torch.float32]),
        "q.S bmm": (lambda q, s: (q[..., None, :] @ s)[..., 0, :],
                    [(16, 128), torch.float32], [(16, 128, 128), torch.float32]),
        "q.S product + sum": (lambda q, s: (q[..., :, None] * s).sum(-2),
                              [(16, 128), torch.float32], [(16, 128, 128), torch.float32]),
        "q.z sum": (lambda q, z: (q * z).sum(-1), [(16, 128), torch.float32],
                    [(16, 128), torch.float32]),
        "q.K bmm": (lambda q, k: (k.float() @ q[..., None])[..., 0],
                    [(16, 128), torch.float32], [(16, 1024, 128), bf]),
        "q.K product + sum": (lambda q, k: (k.float() * q[..., None, :]).sum(-1),
                              [(16, 128), torch.float32], [(16, 1024, 128), bf]),
        "softmax 1024": (lambda x: torch.softmax(x, -1), [(16, 1024), torch.float32]),
        "p.V bmm": (lambda p, v: (p[..., None, :] @ v.float())[..., 0, :],
                    [(16, 1024), torch.float32], [(16, 1024, 128), bf]),
        "p.V product + sum": (lambda p, v: (p[..., :, None] * v.float()).sum(-2),
                              [(16, 1024), torch.float32], [(16, 1024, 128), bf]),
        "sampler filtered logits": (lambda x: _filtered_logits(x, samp),
                                    [(32000,), torch.float32]),
        "sampler tokens": (lambda x, k: sample_rows(x, k.long(), samp),
                           [(32000,), torch.float32], "keys"),
    }
    out = {}
    for name, (fn, *specs) in forms.items():
        args8 = [keys8 if sp == "keys" else rnd(8, *sp[0], dtype=sp[1]) for sp in specs]
        one = fn(*[a[ROW_PROBE_ROW:ROW_PROBE_ROW + 1] for a in args8])[0]
        res = {}
        for b in (4, 8):
            row = fn(*[a[:b] for a in args8])[ROW_PROBE_ROW]
            res[b] = True if torch.equal(row, one) else float(
                (row.double() - one.double()).abs().max())
        out[name] = res
    log(f"decode product forms, a row of 4 and of 8 against it alone (True: bitwise, else the "
        f"largest difference): {out}")
    return out


def _eos_cut(tokens, eos):
    """Tokens as an EOS-stopped request emits them: through its first EOS."""
    return tokens[:tokens.index(eos) + 1] if eos in tokens else tokens


def _prefill_pieces(model, prompt, piece=SERVE_PIECE):
    """``prompt`` [1, T] consumed in ``piece``-token pieces from a zero state
    (the last one right-padded), as a staged slot consumes it."""
    from orion_tpu_torch.models.transformer import init_decode_state

    states = init_decode_state(model.cfg, 1, model.device)
    t = prompt.shape[1]
    with torch.inference_mode():
        for off in range(0, t, piece):
            cons = min(piece, t - off)
            chunk = torch.nn.functional.pad(prompt[:, off:off + cons], (0, piece - cons))
            logits, states = model.prefill_extend_step(chunk, states, off, cons)
    return logits, states


@torch.inference_mode()
def _forced_gaps(model, prompt, tokens):
    """A one-row walk fed ``tokens`` (a slot's greedy tokens for ``prompt``):
    at each step the gap between the walk's largest logit and the logit of
    the token the slot emitted there (0 where it is the walk's argmax)."""
    logits, states = model.prefill_last(prompt)
    gaps = []
    for i, tok in enumerate(tokens):
        gaps.append(float(logits[0].max() - logits[0, tok]))
        if i + 1 < len(tokens):
            logits, states = model.decode_step(torch.tensor([tok], device=prompt.device), states,
                                               prompt.shape[1] + i)
    return gaps


def _readable_rows(cfg, lt, x, n):
    """A state's entries that decode reads after a prompt of ``n``."""
    if lt == "softmax":
        return x[:, :, :n]
    if lt == "swa":
        return x[:, :, torch.arange(max(0, n - cfg.window), n, device=x.device) % cfg.window]
    return x


def session_check(model, label, prompt_len=512, new=48):
    """``DecodeSession`` (chunk 16): its tokens bitwise ``generate``'s (a);
    with a NaN injected after chunk 1's attempt, greedy (sampled: the
    rewind alone): once (the rewind: bitwise
    the uninterrupted tokens), twice (the
    snapshot poisoned too: the re-prefill of prompt + the 16 emitted
    tokens, a state the parallel prefill rebuilds and not the 16 recurrent
    steps, so not bitwise: in greedy, the uninterrupted tokens fed through
    the rebuilt state are each within ``LOGITS_ATOL`` of its argmax, as
    (f)), every attempt (``LadderExhausted``: status "failed", the tokens
    before it kept)."""
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest, DecodeSession

    session = DecodeSession(model, chunk=SERVE_CHUNK)
    p = np.random.default_rng(9).integers(0, model.cfg.vocab_size, (1, prompt_len))
    out = {}
    for sname, sample in (("greedy", SampleConfig(temperature=0.0)),
                          ("sampled", SampleConfig(**SAMPLED_SERVE))):
        req = DecodeRequest(p, new, sample, seed=5)
        ref = session.run(req)
        # (a): the chunked walk is generate's, bitwise
        runs = {"generate_equal": bool(np.array_equal(
            generate(model, torch.from_numpy(p).to(model.device), new, sample, 5).cpu().numpy(),
            ref.tokens))}
        rungs = (("rewind", 1), ("reprefill", 2), ("exhausted", -1))
        for rung, times in rungs if sname == "greedy" else rungs[:1]:
            with inject.inject(inject.FaultPlan().poison_decode_state_at(1, times)):
                r = session.run(req)
            runs[rung] = {"status": r.status, "rewinds": r.rewinds, "reprefills": r.reprefills,
                          "equal": bool(np.array_equal(r.tokens, ref.tokens[:, :r.new_tokens]))}
        if sname == "greedy":  # the rebuilt walk fed the uninterrupted tokens
            seq = torch.from_numpy(np.concatenate([p, ref.tokens[:, :SERVE_CHUNK]], 1))
            gaps = _forced_gaps(model, seq.to(model.device), ref.tokens[0, SERVE_CHUNK:].tolist())
            runs["reprefill"]["forced_max_gap"] = max(gaps)
            runs["reprefill"]["forced_off_argmax"] = sum(g > 0 for g in gaps)
        out[sname] = runs
        log(f"{label} DecodeSession {sname}: uninterrupted {ref.status}, {ref.new_tokens} tokens; "
            f"NaN after chunk 1: {runs}")
        ok = ref.status == "ok" and runs["generate_equal"] and runs["rewind"] == {
            "status": "ok", "rewinds": 1, "reprefills": 0, "equal": True}
        if sname == "greedy":
            ok = ok and (runs["reprefill"]["status"] == "ok"
                         and runs["reprefill"]["reprefills"] == 1
                         and runs["reprefill"]["forced_max_gap"] <= LOGITS_ATOL
                         and runs["exhausted"]["status"] == "failed"
                         and runs["exhausted"]["equal"])
        if not ok:
            raise AssertionError(f"{label}: DecodeSession's ladder misbehaved: {runs}")
    return out


def checkout_package():
    """The ``orion_tpu_torch`` beside this script, or None: a copy of the
    script alone in a directory finds none (or, through ``PYTHONPATH``,
    another checkout's, which it must not run)."""
    try:
        import orion_tpu_torch
    except ImportError:
        return None
    pkg = Path(orion_tpu_torch.__file__).resolve().parent
    return pkg if pkg == ROOT / "orion_tpu_torch" else None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 1
    if checkout_package() is None:
        print(f"chip_smoke: no orion_tpu_torch package beside {ROOT}; run it from the root of a "
              "checkout", file=sys.stderr)
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
    norm = check_causal_dot(causal_dot, dev)
    kernels = check_training_kernels(causal_dot, dev, norm)
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
    _reset_counts(mods)
    # fp32 at D 32: the simt kernels' path of rows 1, 3, 4, 6, 7 and 8, their
    # launches counted from 0
    tiny_train(dev, tiny_hybrid, "tiny hybrid (swa, linear; window 16)")
    tiny_simt = {k: v for k, v in _counts(mods).items()
                 if k.startswith(("flash", "causal_dot_norm", "causal_dot_dq_den",
                                  "causal_dot_rev_den"))}
    log(f"tiny hybrid fp32 train launches: {tiny_simt}")
    if not all(v for k, v in tiny_simt.items() if k.endswith("_simt")) or \
            any(v for k, v in tiny_simt.items() if k.endswith("_wgmma")):
        raise AssertionError(f"the tiny hybrid trained on the card in fp32 without the simt "
                             f"kernels of rows 1, 3, 4, 6, 7 and 8, or with a wgmma one: "
                             f"{tiny_simt}")
    log(f"hybrid_1b3 phases done at {time.perf_counter() - t0:.1f} s")

    dropless = {"moe_dropless": True}
    moe_gen = generate_phase(dev, mods, "moe_1b3_4e", 1024, 32, dropless)
    moe_train = train_phase(dev, mods, "moe_1b3_4e", 1024, dropless)
    grad_check(dev, "moe_1b3_4e", 1024, overrides=dropless)
    tiny_moe = dataclasses.replace(TINY, n_experts=4, moe_period=2)
    for form, over in (("capacity", {}), ("dropless", dropless)):
        label = f"tiny MoE (4 experts in block 1, {form})"
        tiny_generate(dev, dataclasses.replace(tiny_moe, **over), label)
        _reset_counts(mods)
        # batch 8 x 128: 1024 routed rows, the card's tile-aligned form in fp32
        tiny_train(dev, dataclasses.replace(tiny_moe, **over), label, batch_size=8)
        tiny_counts = _counts(mods)
        if form == "dropless":  # the simt kernels' path: fp32
            simt = {k: tiny_counts[k] for k in KERNELS if k.startswith("gmm")}
            log(f"{label} fp32 train launches: {simt}")
            if not (simt["gmm_fwd_simt"] and simt["gmm_dw_simt"]) or simt["gmm_fwd_wgmma"] or \
                    simt["gmm_dw_wgmma"]:
                raise AssertionError(f"the tiny dropless MoE trained on the card in fp32 without "
                                     f"the simt gmm kernels, or with the wgmma ones: {simt}")
    log(f"moe_1b3_4e phases done at {time.perf_counter() - t0:.1f} s")

    lm_int4 = quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int4")
    quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int8")
    moe_int4 = quant_generate_phase(dev, mods, "moe_1b3_4e", 1024, 32, "int4", dropless)
    _reset_counts(mods)
    # fp32: the simt q4 kernel's path, its launches counted from 0
    tiny_generate(dev, TINY, "tiny int4", quant="int4")
    tiny_int4 = _counts(mods)
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

    # the feature maps of rows 1, 3 and 4 at lm_1b3's width: every launch wgmma
    favor = {"feature_map": "favor"}
    learnable = {"feature_map": "learnable", "tie_embeddings": False}
    fm_runs = {}
    for label, over in (("favor", favor), ("learnable_untied", learnable)):
        spread_missed, spread = plain_spread(dev, "lm_1b3", 1024, over)
        fm_gen = generate_phase(dev, mods, "lm_1b3", 1024, 32, over, audit=True,
                                model_limits=not spread_missed)
        fm_train = train_phase(dev, mods, "lm_1b3", 1024, over)
        fm_grad = grad_check(dev, "lm_1b3", 1024, overrides=over, audit=True,
                             model_limits=not spread_missed)
        fm_runs[label] = {"generate": fm_gen["launches"], "train": fm_train["launches"]}
        log(f"lm_1b3 {label}: kernels vs plain, prefill logits {fm_gen['logits_max_abs_err']:.4e}, "
            f"gradients up to {fm_grad['grad_rel_l2_max']:.4g} relative L2; the plain path "
            f"against itself {spread['logits_max_abs']:.4e}, {spread['grad_rel_l2_max']:.4g}; "
            f"train step {fm_train['step_ms']:.2f} ms against elu+1's {lm_train['step_ms']:.2f}")
    # the int8 untied head (lm_head_kernel_q) at lm_1b3's width and depth
    quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int8", learnable)
    dots = train_phase(dev, mods, "lm_1b3", 1024, {"remat_policy": "dots"})
    log(f"lm_1b3 remat 'dots' step {dots['step_ms']:.2f} ms, max memory allocated "
        f"{dots['max_memory_gib']:.2f} GiB against 'full''s {lm_train['step_ms']:.2f} ms, "
        f"{lm_train['max_memory_gib']:.2f} GiB in this run; first losses {dots['losses'][0]!r} "
        f"vs {lm_train['losses'][0]!r}")
    if dots["losses"][0] != lm_train["losses"][0]:
        raise AssertionError("remat 'dots' changed the first step's loss")
    grad_check(dev, "lm_1b3", 1024, overrides={"remat_policy": "dots"},
               ref_overrides={"remat_policy": "full"})
    sr_ms = sr_check(dev)
    sr = train_phase(dev, mods, "lm_1b3", 1024, steps=5, param_storage="bfloat16_sr",
                     then=_storage)
    log(f"lm_1b3 bfloat16_sr storage ({sr['then']} params): step {sr['step_ms']:.2f} ms, max "
        f"memory allocated {sr['max_memory_gib']:.2f} GiB against fp32 storage's "
        f"{lm_train['step_ms']:.2f} ms, {lm_train['max_memory_gib']:.2f} GiB in this run")
    log(f"feature map, remat and storage phases done at {time.perf_counter() - t0:.1f} s")

    lra = {}
    for name, t, b in (("lra_listops_linear", 2000, 32), ("lra_listops_softmax", 2000, 32),
                       ("lra_text_linear", 4000, 16), ("lra_text_softmax", 4000, 16)):
        lra[name] = lra_phase(dev, mods, name, t, b)
        lra[name]["card_vs_cpu"] = lra_card_vs_cpu(dev, name, t)
    log(f"LRA phases done at {time.perf_counter() - t0:.1f} s")

    row_forms(dev)
    both = (("greedy", "host"), ("greedy", "inscan"), ("sampled", "host"), ("sampled", "inscan"))
    host = (("greedy", "host"), ("sampled", "host"))
    serving = {
        "lm_1b3": serving_phase(dev, mods, "lm_1b3", LM_PLAN, card,
                                checks=("b", "f", "g", "ladder", "session", "times",
                                        "decode_session", "server_full"), server_runs=both),
        "lm_1b3_int4": serving_phase(dev, mods, "lm_1b3", LM_PLAN, card, quant="int4",
                                     checks=("f",), server_runs=host),
        # the hybrid's in-scan pieces run its swa plain, as in JAX: row 6 only
        # in the host (solo) prefill
        "hybrid_1b3": serving_phase(dev, mods, "hybrid_1b3", HYBRID_PLAN, card,
                                    checks=("b", "f", "g", "ladder", "session", "times"),
                                    server_runs=host),
    }
    log(f"serving phases done at {time.perf_counter() - t0:.1f} s")

    for k in kernels:
        if k["name"] in ("causal_dot_wgmma", "causal_dot_rev_wgmma"):  # the public op at D 128
            k["launches"] = op["launches"][k["name"]]
            k["launches_op_dk128_dv64"] = op["launches_dv64"][k["name"]]
            continue
        if k["name"] in ("causal_dot_simt", "causal_dot_rev_simt"):
            # the main path: the op at Dk 128, Dv 64 (its dq and reverse passes)
            k["launches"] = op["launches_dv64"][k["name"]]
            k["launches_op_d128"] = op["launches"][k["name"]]
            continue
        if k["name"] == "q4_matmul_simt":  # the main path: the tiny fp32 int4 model's generate
            k["launches"] = tiny_int4[k["name"]]
            k["launches_lm_1b3_int4"] = lm_int4["launches"][k["name"]]
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
        if k["name"] in tiny_simt and k["name"].endswith("_simt"):
            # the main path: the tiny hybrid's fp32 training
            k["launches"] = tiny_simt[k["name"]]
            k["launches_hybrid_1b3"] = {"train": hy_train["launches"][k["name"]],
                                        "generate": hy_gen["launches"][k["name"]]}
            continue
        if k["name"].endswith("_simt"):  # the main path: the tiny dropless MoE's fp32 training
            k["launches"] = simt[k["name"]]
            k["launches_moe_1b3_4e"] = {"train": moe_train["launches"][k["name"]],
                                        "generate": moe_gen["launches"][k["name"]]}
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
            for label, runs in fm_runs.items():
                k[f"launches_lm_1b3_{label}"] = {"train": runs["train"][k["name"]],
                                                 "generate": runs["generate"][k["name"]]}
            k["launches_lm_1b3_dots_train"] = dots["launches"][k["name"]]
            k["launches_lm_1b3_bf16_sr_train"] = sr["launches"][k["name"]]
    for k in kernels:  # rows 1, 6 and 14 on the serving path (the slot programs' runs)
        if k["name"] in ("causal_dot_norm_wgmma", "flash_fwd_wgmma", "q4_matmul_mma"):
            k["launches_serving"] = {label: r["launches"][k["name"]] for label, r in serving.items()}
            # the same requests through serving.Server, by (sampling, admission)
            k["launches_server"] = {label: {run: c[k["name"]]
                                            for run, c in r["server"]["launches"].items()}
                                    for label, r in serving.items()}
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
